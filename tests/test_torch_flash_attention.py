"""The port's flash attention against the JAX package's Pallas kernels.

The same numpy inputs go through ``repro``'s ``make_flash_attention`` and
``make_flash_decode`` (interpret mode, as ``tests/test_kernels.py`` runs
them) and its entry point ``flash_attention`` (with a pinned config: its
ranking needs the tracer, broken on jax 0.9), and through ``repro_torch``'s
``flash_attention``, with the reference tests' tolerances (fp32 atol 2e-3,
bf16 3e-2).  On the CPU the wrappers run the plain version; the CUDA
kernels are compared with it by the ``gpu``-marked tests, which skip
without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.kernels import TPU_REASON, get_generator, tpu_skipped
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.generator import (
    DEFAULT,
    TILES,
    decode_bk,
    tpu_space,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, row_rel_err


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


def _port(*arrays):
    return [convert.from_numpy(np.asarray(a), "cpu") for a in arrays]


@pytest.mark.parametrize("gqa", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_kernel(gqa, causal):
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import make_flash_attention

    Hq, Hkv = gqa
    B, S, D = 2, 256, 64
    q, k, v = _qkv(0, B, Hq, Hkv, S, S, D)
    want = np.asarray(make_flash_attention(B, Hq, Hkv, S, S, D, 128, 128, causal)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    for config in (None, *TILES):
        got = flash_attention(*_port(q, k, v), causal=causal, config=config)
        assert got.shape == (B, Hq, S, D) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


@pytest.mark.parametrize("bk", [128, 256])
def test_flash_decode_matches_pallas_kernel(bk):
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import make_flash_decode

    B, Hq, Hkv, S, D = 2, 8, 2, 512, 64
    q, k, v = _qkv(1, B, Hq, Hkv, 1, S, D)
    want = np.asarray(make_flash_decode(B, Hq, Hkv, S, D, bk)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = K.flash_decode(*_port(q, k, v), bk)
    assert got.shape == (B, Hq, 1, D)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    np.testing.assert_allclose(flash_attention(*_port(q, k, v)).numpy(), want, atol=2e-3)


def test_flash_bf16_matches_pallas_kernel():
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import make_flash_attention

    B, Hq, Hkv, S, D = 1, 2, 2, 128, 64
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in _qkv(2, B, Hq, Hkv, S, S, D))
    want = np.asarray(make_flash_attention(B, Hq, Hkv, S, S, D, 128, 128, True,
                                           jnp.bfloat16)(q, k, v), np.float32)
    got = flash_attention(*_port(q, k, v), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_causal_offset_when_the_cache_is_longer():
    """Sq < Skv: query i attends keys [0, Skv - Sq + i]."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import make_flash_attention
    from repro.kernels.flash_attention.ops import flash_attention as jflash

    B, Hq, Hkv, Sq, Skv, D = 1, 4, 2, 128, 384, 64
    q, k, v = _qkv(3, B, Hq, Hkv, Sq, Skv, D)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = np.asarray(make_flash_attention(B, Hq, Hkv, Sq, Skv, D, 128, 128, True)(jq, jk, jv))
    np.testing.assert_allclose(
        np.asarray(jflash(jq, jk, jv, True, {"bq": 128, "bk": 128})), want, atol=2e-3)
    got = flash_attention(*_port(q, k, v), causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    # the offset matters: without it query 0 would see key 0 only
    plain = attention_ref(*_port(q, k[:, :, :Sq], v[:, :, :Sq]), True).numpy()
    assert np.abs(got - plain).max() > 0.1


@pytest.mark.parametrize("Sq,Skv", [(1, 200), (1, 100), (96, 96), (128, 200), (200, 256)])
def test_dispatch_to_the_plain_version_matches_reference(monkeypatch, Sq, Skv):
    """Sq == 1 with Skv % 128 != 0, and S not 128-divisible: the reference
    runs ``attention_ref`` (before any config is needed), the port its
    plain version, no kernel."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import flash_attention as jflash

    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    monkeypatch.setattr(ops, "flash_attention_fwd", no_kernel)
    monkeypatch.setattr(ops, "flash_decode", no_kernel)
    q, k, v = _qkv(4, 2, 4, 2, Sq, Skv, 32)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True))
    got = flash_attention(*_port(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_dispatch_routes_and_caches_configs(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "flash_attention_fwd",
                        lambda q, k, v, bq, bk, causal: calls.append(("fwd", bq, bk, causal)))
    monkeypatch.setattr(ops, "flash_decode", lambda q, k, v, bk: calls.append(("dec", bk)))
    ops._CONFIG_CACHE.clear()
    z = torch.zeros
    flash_attention(z(1, 4, 1, 64), z(1, 2, 1024, 64), z(1, 2, 1024, 64))
    flash_attention(z(1, 4, 1, 64), z(1, 2, 384, 64), z(1, 2, 384, 64))
    flash_attention(z(1, 4, 256, 64), z(1, 2, 256, 64), z(1, 2, 256, 64), causal=False)
    flash_attention(z(1, 4, 256, 64), z(1, 2, 256, 64), z(1, 2, 256, 64),
                    config={"bq": 64, "bk": 64})
    assert calls == [("dec", 512), ("dec", 128), ("fwd", 128, 128, False), ("fwd", 64, 64, True)]
    assert ops._CONFIG_CACHE == {(1, 4, 2, 256, 256, 64, False, 4): DEFAULT}
    assert (decode_bk(32768), decode_bk(384)) == (512, 128)


def test_generator_skips_the_tpu_space():
    from repro.kernels.flash_attention.generator import _space

    skipped = tpu_skipped(tpu_space(4096, 4096))
    assert [s.config for s in skipped] == list(_space(4096, 4096))
    assert all(s.reason == TPU_REASON for s in skipped)
    assert "VMEM" in TPU_REASON and "tensor-core" in TPU_REASON
    for S in [(128, 128), (256, 1024), (4096, 32768), (100, 256)]:
        assert list(tpu_space(*S)) == list(_space(*S))
    assert DEFAULT == {"bq": 128, "bk": 128} and DEFAULT in TILES and len(TILES) >= 2
    assert get_generator("flash_attention").tpu_space is tpu_space


def test_attention_ref_masks_and_repeats_heads():
    q, k, v = _port(*_qkv(5, 1, 4, 2, 3, 5, 8))
    got = attention_ref(q, k, v, causal=True)
    # query 0 of 3 against 5 keys attends keys 0..2; query 2 all five
    s = torch.einsum("qd,kd->qk", q[0, 3], k[0, 1]) * 8 ** -0.5
    for i, n in ((0, 3), (2, 5)):
        p = torch.softmax(s[i, :n], -1)
        torch.testing.assert_close(got[0, 3, i], p @ v[0, 1, :n])


def test_row_bound_rejects_an_output_missing_a_kv_block():
    """Against a long cache the outputs are small, so leaving the last block
    of 512 keys out stays inside the absolute bf16 bound; the row bound the
    card checks add rejects it, and passes the bf16 rounding of the fp32
    result with room to spare."""
    q, k, v = _port(*_qkv(6, 2, 4, 1, 1, 16384, 64))
    want32 = attention_ref(q, k, v, causal=False)
    want = want32.bfloat16()
    wrong = attention_ref(q, k[:, :, :-512], v[:, :, :-512], causal=False).bfloat16()
    torch.testing.assert_close(wrong.float(), want.float(), rtol=0, atol=3e-2)
    assert row_rel_err(wrong, want) > 2 * ROW_REL[torch.bfloat16]
    assert row_rel_err(want, want32) < ROW_REL[torch.bfloat16] / 4


@pytest.mark.parametrize("args,exc,match", [
    ((np.zeros((1, 1, 128, 64)),) * 3, TypeError, "torch tensors"),
    ((torch.zeros(1, 1, 128, 64, dtype=torch.float64),) * 3, TypeError, "bfloat16"),
    ((torch.zeros(1, 1, 128, 64), torch.zeros(1, 1, 128, 64, dtype=torch.bfloat16),
      torch.zeros(1, 1, 128, 64)), TypeError, "bfloat16"),
    ((torch.zeros(1, 3, 128, 64), torch.zeros(1, 2, 128, 64), torch.zeros(1, 2, 128, 64)),
     ValueError, "Hkv dividing Hq"),
    ((torch.zeros(1, 2, 128, 64), torch.zeros(1, 2, 128, 32), torch.zeros(1, 2, 128, 32)),
     ValueError, "same B and D"),
    ((torch.zeros(1, 2, 64, 128).transpose(2, 3), torch.zeros(1, 2, 128, 64),
      torch.zeros(1, 2, 128, 64)), ValueError, "contiguous"),
    ((torch.zeros(1, 2, 192, 64), torch.zeros(1, 2, 192, 64), torch.zeros(1, 2, 192, 64)),
     ValueError, "must divide"),
    ((torch.zeros(1, 2, 128, 48), torch.zeros(1, 2, 128, 48), torch.zeros(1, 2, 128, 48)),
     ValueError, "head dim 48"),
    ((torch.zeros(1, 2, 128, 128), torch.zeros(1, 2, 128, 128), torch.zeros(1, 2, 128, 128)),
     ValueError, "head dim 128"),  # fp32 has no D = 128 forward
])
def test_forward_wrapper_validates_its_operands(args, exc, match):
    with pytest.raises(exc, match=match):
        K.flash_attention_fwd(*args, 128, 128, True)


def test_wrappers_validate_tiles_and_decode_blocks():
    q, k = torch.zeros(1, 2, 256, 64), torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError, match="not instantiated"):
        K.flash_attention_fwd(q, k, k, 128, 256, True)
    with pytest.raises(ValueError, match="not instantiated"):
        flash_attention(q, k, k, config={"bq": 256, "bk": 128})
    q1 = torch.zeros(1, 2, 1, 64)
    with pytest.raises(ValueError, match="one query token"):
        K.flash_decode(q, k, k, 128)
    for bk in (96, 100, 512, 4096):
        with pytest.raises(ValueError, match="multiple of 64"):
            K.flash_decode(q1, k, k, bk)
    with pytest.raises(ValueError, match="head dim"):
        K.flash_decode(torch.zeros(1, 2, 1, 16), *(torch.zeros(1, 2, 256, 16),) * 2, 128)


ROUTES = [(torch.bfloat16, 32, (128, 128), "mma_sync"), (torch.bfloat16, 32, (64, 64), "mma_sync"),
          (torch.bfloat16, 64, (128, 128), "wgmma"), (torch.bfloat16, 64, (64, 64), "mma_sync"),
          (torch.bfloat16, 128, (128, 128), "wgmma"), (torch.bfloat16, 128, (64, 64), "mma_sync"),
          (torch.float32, 32, (128, 128), "cuda_cores"), (torch.float32, 32, (64, 64), "cuda_cores"),
          (torch.float32, 64, (128, 128), "cuda_cores"), (torch.float32, 64, (64, 64), "cuda_cores")]


@pytest.mark.parametrize("dtype,D,tile,route", ROUTES)
def test_fwd_route_names_the_kernel_of_every_instantiation(dtype, D, tile, route):
    """bf16 at (128, 128) with D 64 or 128 runs the wgmma kernel; every other
    bf16 call mma.sync, fp32 the CUDA cores."""
    assert K.fwd_route(dtype, D, *tile) == route
    assert route in K.FWD_ROUTES


def test_fwd_route_covers_exactly_the_instantiated_kernels():
    assert {(dt, D, tile) for dt, D, tile, _ in ROUTES} == {
        (dt, D, tile) for dt, dims in K.FWD_HEAD_DIMS.items() for D in dims
        for tile in K.FWD_TILES}


@pytest.mark.parametrize("dtype,D,tile", [
    (torch.bfloat16, 48, (128, 128)), (torch.bfloat16, 256, (128, 128)),
    (torch.float32, 128, (128, 128)), (torch.float16, 64, (128, 128)),
    (torch.bfloat16, 64, (128, 64)), (torch.bfloat16, 64, (64, 128)),
    (torch.bfloat16, 64, (256, 256)), (torch.float32, 64, (32, 32)),
])
def test_fwd_route_rejects_what_is_not_instantiated(dtype, D, tile):
    with pytest.raises(ValueError, match="not instantiated"):
        K.fwd_route(dtype, D, *tile)


@pytest.mark.parametrize("tile", [(128, 64), (64, 128), (256, 256), (32, 32)])
def test_forward_wrapper_rejects_tiles_not_instantiated(tile):
    q = torch.zeros(1, 2, 256, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not instantiated"):
        K.flash_attention_fwd(q, q, q, *tile, True)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_forward_wrapper_rejects_non_contiguous_operands(which):
    ops_ = [torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16) for _ in range(3)]
    ops_[which] = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_attention_fwd(*ops_, 128, 128, True)


def test_alignment_check_rejects_an_offset_operand():
    """The card path checks 16-byte alignment (TMA needs it) before it
    launches; an operand one element into its storage fails it."""
    buf = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16)
    aligned, shifted = buf[:-1].view(1, 2, 128, 64), buf[1:].view(1, 2, 128, 64)
    K._aligned(aligned, aligned, aligned)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K._aligned(aligned, shifted, aligned)


def test_pv_probe_runs_only_on_the_card():
    with pytest.raises(ValueError, match="only on the card"):
        K.wgmma_pv_probe(torch.zeros(64, 128), torch.zeros(128, 64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="expected p fp32"):
        K.wgmma_pv_probe(torch.zeros(64, 128), torch.zeros(128, 32, dtype=torch.bfloat16))


def _ablation_cases():
    from repro_torch.kernels.flash_attention import ablate

    return [*ablate.VARIANTS.items(), *ablate.PROBES.items()]


@pytest.mark.parametrize("name,edits", _ablation_cases())
def test_ablation_edits_find_their_text_once(name, edits):
    """Each variant of ``flash_attention/ablate.py`` edits text that occurs
    exactly once in the kernel source, so it changes what it names."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    for old, new in edits:
        assert src.count(old) == 1, (name, old)
        assert old != new


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


ATOL = {torch.bfloat16: 3e-2, torch.float32: 2e-3}
# relative L2 bound on each output row: the absolute bound alone passes an
# output that misses a block of keys (``ref.row_rel_err``)
ROW_REL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _card_qkv(cuda, dtype, *shape, seed=0):
    return [torch.from_numpy(a).to(cuda).to(dtype) for a in _qkv(seed, *shape)]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", ["permutation", "random"])
def test_card_wgmma_pv_fragment_layout(cuda, D, case):
    """One consumer's P·V of the wgmma kernel, alone: P goes into the S
    accumulator's registers and leaves as register-A fragments.  With P a
    permutation (row i picks key 37 i + 5 mod 128) and V small integers
    (exact in bf16), O must be V's rows in that order exactly; an element
    taken from the wrong fragment names the key it came from."""
    keys = torch.arange(128, device=cuda)
    V = ((keys[:, None] + 3 * torch.arange(D, device=cuda)[None, :]) % 251).float()
    if case == "permutation":
        pick = (37 * torch.arange(64, device=cuda) + 5) % 128
        P = (keys[None, :] == pick[:, None]).float()
        got = K.wgmma_pv_probe(P, V.bfloat16())
        torch.cuda.synchronize()
        want = V[pick]
        bad = (got != want).nonzero()
        if len(bad):
            i, d = bad[0].tolist()
            src = ((V[:, d] == got[i, d]).nonzero().flatten().tolist())
            pytest.fail(f"{len(bad)} wrong elements; O[{i}, {d}] = {got[i, d].item()} (keys "
                        f"{src} hold it in column {d}), want key {pick[i].item()}'s "
                        f"{want[i, d].item()}")
    else:
        gen = torch.Generator(device=cuda).manual_seed(7)
        P = torch.rand((64, 128), device=cuda, generator=gen)
        Vr = torch.randn((128, D), device=cuda, generator=gen).bfloat16()
        got = K.wgmma_pv_probe(P, Vr)
        torch.cuda.synchronize()
        # the kernel rounds P to bf16, as the forward does, and sums in fp32
        want = P.bfloat16().float() @ Vr.float()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 32), (torch.bfloat16, 64),
                                     (torch.bfloat16, 128), (torch.float32, 32),
                                     (torch.float32, 64)])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv", [(3, 5, 5, 128, 128), (1, 6, 2, 256, 384),
                                             (3, 3, 1, 384, 384), (1, 2, 2, 128, 128),
                                             (1, 4, 2, 128, 512), (2, 32, 8, 2048, 2048)])
@pytest.mark.parametrize("causal", [True, False])
def test_card_forward_matches_plain_on_odd_heads(cuda, dtype, D, B, Hq, Hkv, Sq, Skv, causal):
    """Odd B·Hq, GQA groups of 1, 3, 4 and 5, Sq < Skv (the causal offset,
    up to three blocks), a single diagonal block, and more tiles than two
    waves of 132 SMs (each persistent CTA of the wgmma kernel walks
    several); bf16 (128, 128) at D 64 and 128 runs the wgmma kernel, and
    the library's route table agrees with ``fwd_route``."""
    q, k, v = _card_qkv(cuda, dtype, B, Hq, Hkv, Sq, Skv, D)
    want = attention_ref(q, k, v, causal).float()
    for bq, bk in K.FWD_TILES:
        route = K.fwd_route(dtype, D, bq, bk)
        if dtype == torch.bfloat16 and (bq, bk) == (128, 128) and D in (64, 128):
            assert route == "wgmma"
        assert K._lib().flash_fwd_route(q.element_size(), D, bq, bk) == K.FWD_ROUTES[route]
        before = K.LAUNCHES["flash_attention_fwd"]
        got = K.flash_attention_fwd(q, k, v, bq, bk, causal)
        torch.cuda.synchronize()
        assert K.LAUNCHES["flash_attention_fwd"] == before + 1
        assert K.LAST_LAUNCH["flash_attention_fwd"] == (bq, bk, causal)
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want, rtol=0, atol=ATOL[dtype],
                                   msg=f"bq={bq} bk={bk} ({route})")
        assert row_rel_err(got, want) <= ROW_REL[dtype], f"bq={bq} bk={bk} ({route})"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("B,Hq,Hkv", [(3, 5, 1), (1, 32, 8), (2, 12, 1), (5, 3, 3)])
def test_card_decode_matches_plain_on_odd_heads(cuda, dtype, D, B, Hq, Hkv):
    """Groups of 1, 3, 4, 5 and 12 (two CTAs of query heads per KV head)."""
    q, k, v = _card_qkv(cuda, dtype, B, Hq, Hkv, 1, 1024, D, seed=1)
    want = attention_ref(q, k, v, causal=False).float()
    for bk in (128, 512, 1024):
        before = K.LAUNCHES["flash_decode"]
        got = K.flash_decode(q, k, v, bk)
        torch.cuda.synchronize()
        assert K.LAUNCHES["flash_decode"] == before + 1 and K.LAST_LAUNCH["flash_decode"] == bk
        torch.testing.assert_close(got.float(), want, rtol=0, atol=ATOL[dtype], msg=f"bk={bk}")
        assert row_rel_err(got, want) <= ROW_REL[dtype], f"bk={bk}"


@pytest.mark.gpu
def test_card_decode_with_64_bit_offsets(cuda):
    """K and V of 2^31 + 2^16 elements each: offsets past 2^31 must not wrap."""
    B, Hq, Hkv, Skv, D = 2, 2, 1, 2 ** 24 + 512, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, Hq, 1, D), device=cuda, generator=gen).bfloat16()
    k = torch.randn((B, Hkv, Skv, D), device=cuda, generator=gen, dtype=torch.bfloat16)
    v = torch.randn((B, Hkv, Skv, D), device=cuda, generator=gen, dtype=torch.bfloat16)
    assert k.numel() > 2 ** 31
    # make the far end of batch 1 decide the answer: its last keys align with q
    k[1, :, -512:] = q[1, :1, 0] * 4
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert K.LAST_LAUNCH["flash_decode"] == 512
    want = attention_ref(q[1:], k[1:], v[1:], causal=False)
    torch.testing.assert_close(got[1:].float(), want.float(), rtol=0, atol=3e-2)
    assert row_rel_err(got[1:], want) <= ROW_REL[torch.bfloat16]
    del k, v


@pytest.mark.gpu
def test_card_entry_point_dispatch(cuda):
    q, k, v = _card_qkv(cuda, torch.bfloat16, 2, 4, 2, 256, 256, 64, seed=2)
    K.reset_launch_counts()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"flash_attention_fwd": 1, "flash_decode": 0}
    assert K.LAST_LAUNCH["flash_attention_fwd"] == (128, 128, True)
    torch.testing.assert_close(got.float(), attention_ref(q, k, v).float(), rtol=0, atol=3e-2)
    assert row_rel_err(got, attention_ref(q, k, v)) <= ROW_REL[torch.bfloat16]
    flash_attention(q[:, :, :1], k, v)
    flash_attention(q[:, :, :100], k[:, :, :100], v[:, :, :100])  # plain version
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"flash_attention_fwd": 1, "flash_decode": 1}
