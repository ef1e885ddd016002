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
from repro_torch.kernels.flash_attention.ref import (
    attention_blocks_ref,
    attention_fp64_ref,
    attention_ref,
    attention_split_tf32_ref,
    combine_partials_ref,
    decode_combine_ref,
    decode_partials_ref,
    decode_split_bounds,
    row_rel_err,
    split_tf32_mma,
)


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


HEAD_DIMS_REPAIRED = [80, 96, 128]  # refused before for fp32 at 128, bf16 at 80 and 96


@pytest.mark.parametrize("D", HEAD_DIMS_REPAIRED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_every_config_head_dim_matches_pallas_kernel(dtype, D):
    """Head dims 80 (zamba2-2.7b), 96 (phi3-mini-3.8b) and 128 (mixtral-8x7b
    and others) through the entry point, GQA and causal with Sq < Skv, in
    both dtypes, against ``make_flash_attention`` in interpret mode: the
    port refused fp32 at 128 and bf16 at 80 and 96 before
    ("not instantiated"), on the CPU too."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import make_flash_attention

    B, Hq, Hkv, Sq, Skv = 1, 4, 2, 128, 256
    jdt = getattr(jnp, dtype)
    q, k, v = (jnp.asarray(a).astype(jdt) for a in _qkv(20 + D, B, Hq, Hkv, Sq, Skv, D))
    want = np.asarray(make_flash_attention(B, Hq, Hkv, Sq, Skv, D, 128, 128, True, jdt)(q, k, v),
                      np.float32)
    atol = 2e-3 if dtype == "float32" else 3e-2
    for config in (None, *TILES):
        got = flash_attention(*_port(q, k, v), causal=True, config=config)
        assert got.shape == (B, Hq, Sq, D) and got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol)
    for tile in K.FWD_TILES:
        assert K.fwd_route(getattr(torch, dtype), D, *tile) in K.FWD_ROUTES


REFERENCE_SPACE = [(Sq, Skv, cfg) for Sq, Skv in ((256, 256), (128, 256))
                   for cfg in tpu_space(Sq, Skv)]


@pytest.mark.parametrize("Sq,Skv,config", REFERENCE_SPACE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_space_configs_match_the_jax_entry_point(dtype, Sq, Skv, config):
    """Every config of the reference's space at the test shapes runs
    through the entry point (at the kernel's own tile: a VMEM block decides
    nothing on the card) and matches the JAX entry point with the same
    config in interpret mode; the port refused them all before ("not
    instantiated")."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import flash_attention as jflash

    B, Hq, Hkv, D = 1, 4, 2, 64
    jdt = getattr(jnp, dtype)
    q, k, v = (jnp.asarray(a).astype(jdt) for a in _qkv(30, B, Hq, Hkv, Sq, Skv, D))
    want = np.asarray(jflash(q, k, v, True, dict(config)), np.float32)
    got = flash_attention(*_port(q, k, v), causal=True, config=dict(config))
    assert got.shape == (B, Hq, Sq, D) and got.dtype == getattr(torch, dtype)
    assert ops.LAST_CONFIG == {"config": config, "tile": (DEFAULT["bq"], DEFAULT["bk"])}
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-3 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("config", [{"bq": 128, "bk": 128}, {"bq": 256, "bk": 128}])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_that_see_no_key_match_the_jax_kernel(dtype, config):
    """Causal with Sq > Skv: rows i < Sq - Skv see no key.  The reference's
    kernel gives them 0 at (128, 128) (it computes no KV block for their q
    block) and the mean of V over keys 0-127 at (256, 128); the port's entry
    point matches it there, with no NaN (``attention_ref`` gives NaN), and
    to the pinned tolerance on the rows that see keys.  The zero rows match
    exactly.  So do the bf16 mean rows; the fp32 mean rows are held to the
    rounding bound of a 128-term fp32 sum taken in two orders (each within
    127·2^-24·sum|v| of the exact sum, over 128): the reference's sum is its
    host's dot (XLA's on the CPU in interpret mode) and the port's a torch
    matmul, and their orders differ between hosts."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import make_flash_attention

    B, Hq, Hkv, Sq, Skv, D = 1, 2, 1, 256, 128, 64
    jdt = getattr(jnp, dtype)
    q, k, v = (jnp.asarray(a).astype(jdt) for a in _qkv(0, B, Hq, Hkv, Sq, Skv, D))
    want = np.asarray(make_flash_attention(B, Hq, Hkv, Sq, Skv, D, config["bq"], config["bk"],
                                           True, jdt)(q, k, v), np.float32)
    got = flash_attention(*_port(q, k, v), causal=True, config=config).float().numpy()
    n = Sq - Skv
    assert not np.isnan(got).any()
    if dtype == "float32" and config["bq"] != 128:
        keys = np.abs(np.asarray(v, np.float32)[:, :, None, :128]).repeat(Hq // Hkv, axis=1)
        bound = 2 * 127 * 2.0 ** -24 / (1 - 127 * 2.0 ** -24) * keys.mean(axis=3)
        assert (np.abs(got[:, :, :n] - want[:, :, :n]) <= bound).all()
    else:
        np.testing.assert_array_equal(got[:, :, :n], want[:, :, :n])
    np.testing.assert_allclose(got[:, :, n:], want[:, :, n:], atol=2e-3 if dtype == "float32" else 3e-2)
    mean = np.asarray(v, np.float32)[:, :, None, :128].mean(axis=3).repeat(Hq // Hkv, axis=1)
    np.testing.assert_allclose(want[:, :, :n], np.broadcast_to(
        0.0 if config["bq"] == 128 else mean, want[:, :, :n].shape),
        rtol=1e-6 if dtype == "float32" else 2 ** -8, atol=1e-7)
    assert torch.isnan(attention_ref(*_port(q, k, v), True)[:, :, :n]).all()


@pytest.mark.parametrize("Sq,Skv,bq,bk", [(256, 128, 128, 128), (256, 128, 256, 128),
                                          (512, 128, 512, 128), (512, 256, 128, 256),
                                          (1024, 256, 512, 128), (320, 192, 64, 64),
                                          (256, 256, 128, 128), (128, 384, 128, 128)])
def test_attention_blocks_ref_follows_the_reference_block_rule(Sq, Skv, bq, bk):
    """``attention_blocks_ref`` against a direct loop over the reference's
    rule: q block qb reads KV blocks kb with kb·bk <= qb·bq + bq - 1 + (Skv -
    Sq); a row that sees no key averages V over their keys (0 where there
    are none), every other row is ``attention_ref``'s."""
    q, k, v = _port(*_qkv(7, 1, 4, 2, Sq, Skv, 32))
    got = attention_blocks_ref(q, k, v, True, bq, bk)
    want = attention_ref(q, k, v, True)
    off = Skv - Sq
    for i in range(Sq):
        if i + off >= 0:
            continue
        qb = i // bq
        keys = [j for kb in range(Skv // bk) if kb * bk <= qb * bq + bq - 1 + off
                for j in range(kb * bk, (kb + 1) * bk)]
        want[:, :, i] = (v[:, :, keys].float().mean(dim=2) if keys else
                         torch.zeros_like(v[:, :, 0])).repeat_interleave(2, dim=1)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(attention_blocks_ref(q, k, v, False, bq, bk), attention_ref(q, k, v, False))


def test_the_layer_never_passes_a_row_without_a_key(monkeypatch):
    """``attention_apply`` sends self-attention (Sq == Skv) to the forward
    and ``chunked_attention`` never reaches it, so the no-key rule leaves
    the layer as it was: on its call ``attention_blocks_ref`` is
    ``attention_ref`` bit for bit."""
    from repro_torch.layers.attention import attention_apply, attention_init

    seen = []
    real = ops.flash_attention_fwd

    def spy(q, k, v, bq, bk, causal, blocks):
        seen.append((q.shape[2], k.shape[2], causal))
        assert torch.equal(attention_blocks_ref(q, k, v, causal, *blocks),
                           attention_ref(q, k, v, causal))
        return real(q, k, v, bq, bk, causal, blocks=blocks)

    monkeypatch.setattr(ops, "flash_attention_fwd", spy)
    gen = torch.Generator().manual_seed(0)
    params = attention_init(128, 4, 2, 32, dtype=torch.float32, generator=gen, device="cpu")
    x = torch.randn((2, 256, 128), generator=gen)
    for causal in (True, False):
        attention_apply(params, x, n_heads=4, n_kv=2, head_dim=32, causal=causal, use_pallas=True)
        attention_apply(params, x, n_heads=4, n_kv=2, head_dim=32, causal=causal)
    assert seen == [(256, 256, True), (256, 256, False)]


@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_at_new_head_dims_matches_pallas_kernel(dtype, D):
    """Decode at head dims 80 and 96 (refused before in either dtype), with
    a group of 4, against ``make_flash_decode`` in interpret mode; both run
    the CUDA-core decode on the card."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import make_flash_decode

    B, Hq, Hkv, Skv = 2, 8, 2, 512
    jdt = getattr(jnp, dtype)
    q, k, v = (jnp.asarray(a).astype(jdt) for a in _qkv(30 + D, B, Hq, Hkv, 1, Skv, D))
    want = np.asarray(make_flash_decode(B, Hq, Hkv, Skv, D, 128, jdt)(q, k, v), np.float32)
    got = flash_attention(*_port(q, k, v))
    assert got.shape == (B, Hq, 1, D) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-3 if dtype == "float32" else 3e-2)
    assert K.decode_route(getattr(torch, dtype), D) == "cuda_cores"


@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_split_tf32_ref_matches_pallas_kernel(D, causal):
    """The fp32 kernel's three TF32 passes, emulated in its order, against
    ``make_flash_attention`` in interpret mode (fp32 atol 2e-3 and each
    row within a relative L2 error of 1e-4), with a group of 3 and Sq <
    Skv; one pass (every operand rounded to TF32 once) misses the row
    bound by far more than the three do."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import make_flash_attention
    from repro_torch.kernels.matmul.ref import tf32_round

    B, Hq, Hkv, Sq, Skv = 1, 3, 1, 128, 256
    q, k, v = _qkv(40 + D, B, Hq, Hkv, Sq, Skv, D)
    want = np.asarray(make_flash_attention(B, Hq, Hkv, Sq, Skv, D, 128, 128, causal)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = _port(q, k, v)
    got = attention_split_tf32_ref(tq, tk, tv, causal)
    assert got.shape == (B, Hq, Sq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    want = torch.tensor(want)
    rel = row_rel_err(got, want)
    one = row_rel_err(attention_ref(tf32_round(tq), tf32_round(tk), tf32_round(tv), causal), want)
    assert rel <= ROW_REL[torch.float32] and one > 10 * rel


def test_split_tf32_mma_is_what_the_tensor_cores_read():
    """hi is the nearest TF32 value (``tf32_round``, the bits of
    ``cvt.rna.tf32.f32``) and lo = x - hi cut to its TF32 bits towards
    zero, as the MMA reads it: both carry no low mantissa bits, and hi + lo
    is x to 2^-21 of |x|."""
    from repro_torch.kernels.matmul.ref import tf32_round

    x = torch.from_numpy(np.random.default_rng(16).standard_normal(8192).astype(np.float32) * 7)
    hi, lo = split_tf32_mma(x)
    assert torch.equal(hi, tf32_round(x))
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool((lo.abs() <= (x - hi).abs()).all())
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert 0 < rel <= 2.0 ** -21


@pytest.mark.parametrize("causal", [True, False])
def test_attention_fp64_ref_is_attention_ref_in_fp64(causal):
    """The exact answer of the fp32 error gates: the plain version's
    function (GQA, the decode-convention mask) in fp64."""
    q, k, v = _port(*_qkv(17, 2, 6, 2, 48, 80, 16))
    got = attention_fp64_ref(q, k, v, causal)
    assert got.dtype == torch.float64 and got.shape == q.shape
    torch.testing.assert_close(got, attention_ref(q.double(), k.double(), v.double(), causal).double(),
                               rtol=0, atol=2e-6)
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, causal), rtol=0, atol=2e-6)


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
                        lambda q, k, v, bq, bk, causal, blocks: calls.append(
                            ("fwd", bq, bk, causal, blocks)))
    monkeypatch.setattr(ops, "flash_decode", lambda q, k, v, bk: calls.append(("dec", bk)))
    ops._CONFIG_CACHE.clear()
    z = torch.zeros
    flash_attention(z(1, 4, 1, 64), z(1, 2, 1024, 64), z(1, 2, 1024, 64))
    flash_attention(z(1, 4, 1, 64), z(1, 2, 384, 64), z(1, 2, 384, 64))
    flash_attention(z(1, 4, 256, 64), z(1, 2, 256, 64), z(1, 2, 256, 64), causal=False)
    flash_attention(z(1, 4, 256, 64), z(1, 2, 256, 64), z(1, 2, 256, 64),
                    config={"bq": 64, "bk": 64})
    flash_attention(z(1, 4, 256, 64), z(1, 2, 256, 64), z(1, 2, 256, 64),
                    config={"bq": 256, "bk": 128})
    assert calls == [("dec", 512), ("dec", 128), ("fwd", 128, 128, False, (128, 128)),
                     ("fwd", 64, 64, True, (64, 64)), ("fwd", 128, 128, True, (256, 128))]
    assert ops.LAST_CONFIG == {"config": {"bq": 256, "bk": 128}, "tile": (128, 128)}
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
    ((torch.zeros(1, 2, 128, 256), torch.zeros(1, 2, 128, 256), torch.zeros(1, 2, 128, 256)),
     ValueError, "head dim 256"),  # no config has D = 256
])
def test_forward_wrapper_validates_its_operands(args, exc, match):
    with pytest.raises(exc, match=match):
        K.flash_attention_fwd(*args, 128, 128, True)


def test_wrappers_validate_tiles_and_decode_blocks():
    q, k = torch.zeros(1, 2, 256, 64), torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError, match="not instantiated"):
        K.flash_attention_fwd(q, k, k, 128, 256, True)
    # in neither the kernel's tiles nor the reference's space (a reference
    # config such as {"bq": 256, "bk": 128} runs: test_reference_space_*)
    for config in ({"bq": 96, "bk": 128}, {"bq": 512, "bk": 128}, {"bq": 128, "bk": 64}):
        with pytest.raises(ValueError, match="not instantiated"):
            flash_attention(q, k, k, config=config)
    q1 = torch.zeros(1, 2, 1, 64)
    with pytest.raises(ValueError, match="one query token"):
        K.flash_decode(q, k, k, 128)
    for bk in (96, 100, 512, 4096):
        with pytest.raises(ValueError, match="multiple of 64"):
            K.flash_decode(q1, k, k, bk)
    with pytest.raises(ValueError, match="head dim"):
        K.flash_decode(torch.zeros(1, 2, 1, 16), *(torch.zeros(1, 2, 256, 16),) * 2, 128)


@pytest.mark.parametrize("tile,blocks", [((128, 128), (64, 64)), ((128, 128), (128, 64)),
                                         ((128, 128), (192, 128)), ((64, 64), (32, 64)),
                                         ((64, 64), (64, 96)), ((64, 64), (512, 64))])
def test_forward_refuses_blocks_off_the_tile(tile, blocks):
    """``blocks`` must be a multiple of the tile that runs, with rbq | Sq
    and rbk | Skv: the kernels' block counts for the rows that see no key
    are whole blocks of the tile (every config of the reference's space is
    a multiple of (128, 128)); the CPU path keeps the card's rule."""
    q, k = torch.zeros(1, 2, 384, 64), torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError, match="blocks"):
        K.flash_attention_fwd(q, k, k, *tile, True, blocks=blocks)


ROUTES = [(torch.bfloat16, 32, (128, 128), "wgmma"), (torch.bfloat16, 32, (64, 64), "wgmma"),
          (torch.bfloat16, 64, (128, 128), "wgmma"), (torch.bfloat16, 64, (64, 64), "wgmma"),
          (torch.bfloat16, 128, (128, 128), "wgmma"), (torch.bfloat16, 128, (64, 64), "wgmma"),
          (torch.float32, 32, (128, 128), "split_tf32"), (torch.float32, 32, (64, 64), "split_tf32"),
          (torch.float32, 64, (128, 128), "split_tf32"), (torch.float32, 64, (64, 64), "split_tf32"),
          (torch.bfloat16, 80, (128, 128), "wgmma"), (torch.bfloat16, 80, (64, 64), "wgmma"),
          (torch.bfloat16, 96, (128, 128), "wgmma"), (torch.bfloat16, 96, (64, 64), "wgmma"),
          (torch.float32, 80, (128, 128), "split_tf32"), (torch.float32, 80, (64, 64), "split_tf32"),
          (torch.float32, 96, (128, 128), "split_tf32"), (torch.float32, 96, (64, 64), "split_tf32"),
          (torch.float32, 128, (128, 128), "split_tf32"), (torch.float32, 128, (64, 64), "split_tf32")]


@pytest.mark.parametrize("dtype,D,tile,route", ROUTES)
def test_fwd_route_names_the_kernel_of_every_instantiation(dtype, D, tile, route):
    """bf16 at (128, 128) and (64, 64) runs the wgmma kernel at every head
    dim (32, 80 and 96 padded to whole 64-column boxes in shared memory),
    fp32 three TF32 passes at every head dim."""
    assert K.fwd_route(dtype, D, *tile) == route
    assert route in K.FWD_ROUTES


def test_fwd_route_covers_exactly_the_instantiated_kernels():
    assert {(dt, D, tile) for dt, D, tile, _ in ROUTES} == {
        (dt, D, tile) for dt, dims in K.FWD_HEAD_DIMS.items() for D in dims
        for tile in K.FWD_TILES}


@pytest.mark.parametrize("dtype,D,tile", [
    (torch.bfloat16, 48, (128, 128)), (torch.bfloat16, 256, (128, 128)),
    (torch.float32, 256, (128, 128)), (torch.float16, 64, (128, 128)),
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
        K.wgmma_pv_probe(torch.zeros(64, 128), torch.zeros(128, 48, dtype=torch.bfloat16))


DECODE_ROUTES = [(torch.bfloat16, 32, "cuda_cores"), (torch.bfloat16, 64, "tma_mma"),
                 (torch.bfloat16, 128, "tma_mma"), (torch.float32, 32, "cuda_cores"),
                 (torch.float32, 64, "cuda_cores"), (torch.float32, 128, "cuda_cores"),
                 (torch.bfloat16, 80, "cuda_cores"), (torch.bfloat16, 96, "cuda_cores"),
                 (torch.float32, 80, "cuda_cores"), (torch.float32, 96, "cuda_cores")]


@pytest.mark.parametrize("dtype,D,route", DECODE_ROUTES)
def test_decode_route_names_the_kernel_of_every_instantiation(dtype, D, route):
    """bf16 at D 64 and 128 runs the TMA-fed tensor-core decode; bf16 at D
    32, 80 and 96 and fp32 the CUDA-core kernel (fp32 stays off TF32)."""
    assert K.decode_route(dtype, D) == route
    assert route in K.DECODE_ROUTES


def test_decode_route_covers_exactly_the_instantiated_kernels():
    assert {(dt, D) for dt, D, _ in DECODE_ROUTES} == {
        (dt, D) for dt in K.FWD_HEAD_DIMS for D in K.DECODE_HEAD_DIMS}


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 48), (torch.bfloat16, 256),
                                     (torch.float32, 16), (torch.float16, 64),
                                     (torch.float64, 64)])
def test_decode_route_rejects_what_is_not_instantiated(dtype, D):
    with pytest.raises(ValueError, match="not instantiated"):
        K.decode_route(dtype, D)


@pytest.mark.parametrize("B,Hkv,chunks,Skv,sms,want", [
    (128, 8, 1, 32768, 132, 1),   # granite-3-2b's decode_32k: 1024 units fill the card
    (32, 8, 1, 32768, 132, 1),    # 256 units
    (16, 8, 1, 32768, 132, 1),    # 128 units busy 97 % of the SMs; a split would add a wave
    (8, 8, 1, 32768, 132, 2),     # one user at low concurrency: 64 units, 128 once split
    (1, 1, 1, 1024, 132, 8),      # the cache's eight blocks are the limit
    (2, 1, 1, 2 ** 24 + 512, 132, 66),
    (3, 2, 2, 1088, 132, 9),
])
def test_decode_splits_fills_the_card_and_no_more(B, Hkv, chunks, Skv, sms, want):
    assert K.decode_splits(B, Hkv, chunks, Skv, sms) == want


@pytest.mark.parametrize("B,Hkv,chunks,Skv", [(8, 8, 1, 32768), (1, 1, 1, 1152), (3, 2, 2, 1088),
                                              (1, 4, 1, 64), (5, 1, 1, 100_000)])
def test_decode_splits_cover_every_key_once_in_whole_blocks(B, Hkv, chunks, Skv):
    """The chosen split count, and every count the kernel takes, partition
    the keys into whole 128-key blocks (only the cache's end may cut one)."""
    nb = -(-Skv // 128)
    chosen = K.decode_splits(B, Hkv, chunks, Skv, 132)
    assert 1 <= chosen <= nb
    if B * Hkv * chunks <= 66:  # half the card idle unsplit
        assert chosen > 1 or nb == 1
    for splits in sorted({1, 2, 7, chosen, nb} & set(range(1, nb + 1))):
        bounds = decode_split_bounds(Skv, splits)
        assert len(bounds) == splits
        assert [k for k0, k1 in bounds for k in range(k0, k1)] == list(range(Skv))
        assert all(k1 > k0 and k0 % 128 == 0 and (k1 % 128 == 0 or k1 == Skv)
                   for k0, k1 in bounds)
        sizes = {k1 - k0 for k0, k1 in bounds[:-1]}
        assert max(sizes, default=0) - min(sizes, default=0) <= 128  # blocks spread evenly
    for bad in (0, nb + 1):
        with pytest.raises(ValueError, match="splits"):
            decode_split_bounds(Skv, bad)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("gqa", [(8, 2), (4, 4), (5, 1)])
def test_decode_combine_ref_matches_pallas_kernel(splits, gqa):
    """The split decode's plain version (partials of each split from the
    plain softmax, then combined) against ``attention_ref`` and against the
    reference's ``make_flash_decode`` in interpret mode (fp32 2e-3)."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import make_flash_decode

    Hq, Hkv = gqa
    B, S, D = 2, 512, 64
    q, k, v = _qkv(7, B, Hq, Hkv, 1, S, D)
    want = np.asarray(make_flash_decode(B, Hq, Hkv, S, D, 128)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = _port(q, k, v)
    got = decode_combine_ref(tq, tk, tv, splits)
    assert got.shape == (B, Hq, 1, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    torch.testing.assert_close(got, attention_ref(tq, tk, tv, causal=False), rtol=0, atol=2e-5)
    part = decode_partials_ref(tq, tk, tv, splits)
    assert part.shape == (B, Hq, splits, D + 2) and part.dtype == torch.float32
    torch.testing.assert_close(K.decode_combine(part, torch.float32), got, rtol=0, atol=0)


def test_decode_partials_hold_each_splits_softmax():
    """m is the split's largest scaled score, l its exponentials' sum and O
    their unnormalised average of V; a split's own o is O / l."""
    q, k, v = _port(*_qkv(8, 1, 2, 1, 1, 384, 32))
    part = decode_partials_ref(q, k, v, 3)
    for s, (k0, k1) in enumerate(decode_split_bounds(384, 3)):
        scores = torch.einsum("d,kd->k", q[0, 1, 0], k[0, 0, k0:k1]) * 32 ** -0.5
        assert torch.isclose(part[0, 1, s, 32], scores.max())
        torch.testing.assert_close(part[0, 1, s, 33], torch.exp(scores - scores.max()).sum())
        torch.testing.assert_close(part[0, 1, s, :32] / part[0, 1, s, 33],
                                   attention_ref(q, k[:, :, k0:k1], v[:, :, k0:k1], False)[0, 1, 0])


def test_combine_of_a_single_split_is_the_plain_division():
    part = torch.cat([torch.full((1, 1, 1, 4), 3.0), torch.tensor([[[[-2.0, 1.5]]]])], dim=-1)
    torch.testing.assert_close(combine_partials_ref(part, torch.float32),
                               torch.full((1, 1, 1, 4), 2.0))
    zero = torch.zeros(1, 1, 1, 6)  # l = 0: o = O / max(l, 1e-30), as the reference divides
    assert combine_partials_ref(zero, torch.float32).abs().max() == 0


def test_decode_wrapper_validates_splits():
    """Both routes take 1 up to the cache's 128-key blocks of splits (the
    CUDA-core route as well as the tensor-core one), and nothing else."""
    q1, k = torch.zeros(1, 2, 1, 64, dtype=torch.bfloat16), torch.zeros(1, 2, 256, 64,
                                                                         dtype=torch.bfloat16)
    q32, k32 = q1.float(), k.float()
    assert K.decode_route(q32.dtype, 64) == "cuda_cores"
    for q, kv in ((q1, k), (q32, k32)):
        for bad in (0, 3):  # 256 keys are two blocks
            with pytest.raises(ValueError, match="splits"):
                K.flash_decode(q, kv, kv, 128, splits=bad)
        for splits in (1, 2):  # the plain version
            assert K.flash_decode(q, kv, kv, 128, splits=splits).shape == (1, 2, 1, 64)
    with pytest.raises(ValueError, match="partials"):
        K.decode_combine(torch.zeros(1, 2, 2, 18))  # D 16 is not instantiated
    with pytest.raises(ValueError, match="float32"):
        K.decode_combine(torch.zeros(1, 2, 2, 34), torch.float16)
    part = decode_partials_ref(*_port(*_qkv(9, 1, 2, 1, 1, 256, 32)), 2)  # D 32 combines too
    assert K.decode_combine(part, torch.float32).shape == (1, 2, 1, 32)


@pytest.mark.parametrize("route,group,want", [
    ("cuda_cores", 1, 1), ("cuda_cores", 4, 1), ("cuda_cores", 5, 1), ("cuda_cores", 8, 1),
    ("cuda_cores", 12, 2), ("cuda_cores", 17, 3), ("tma_mma", 4, 1), ("tma_mma", 16, 1),
    ("tma_mma", 17, 2)])
def test_decode_chunks_follow_each_routes_unit(route, group, want):
    """The CUDA-core unit holds 4 query heads where the group has at most 4
    (granite-3-2b's), else 8; the tensor-core unit 16."""
    assert K.decode_chunks(route, group) == want


@pytest.mark.parametrize("B,Hq,Hkv,Skv", [(8, 32, 8, 32768), (1, 4, 1, 1024), (2, 12, 1, 4096 + 64),
                                          (3, 5, 1, 192), (32, 32, 8, 32768)])
def test_core_decode_splits_fill_the_card_and_cover_every_key_once(B, Hq, Hkv, Skv):
    """On the CUDA-core route the split count fills the card where the units
    leave half of it idle (granite-3-2b's decode at B 8: 64 units, 128 once
    split), and its splits cover every key once in whole 64-key blocks, the
    kernel's own (``Skv`` is a multiple of 64 there)."""
    sms, nb = 132, -(-Skv // 128)
    units = B * Hkv * K.decode_chunks("cuda_cores", Hq // Hkv)
    chosen = K.decode_splits(B, Hkv, K.decode_chunks("cuda_cores", Hq // Hkv), Skv, sms)
    assert 1 <= chosen <= nb
    if units <= sms // 2:
        assert chosen > 1 or nb == 1
        assert units * chosen >= min(sms // 2, units * nb)
    else:
        assert chosen == 1 or units * chosen <= 4 * sms
    if (B, Hq, Hkv, Skv) == (8, 32, 8, 32768):
        assert (units, chosen) == (64, 2)
    for splits in sorted({1, 2, chosen, nb}):
        bounds = decode_split_bounds(Skv, splits)
        assert [k for k0, k1 in bounds for k in range(k0, k1)] == list(range(Skv))
        assert all(k0 % 64 == 0 and k1 % 64 == 0 and k1 > k0 for k0, k1 in bounds)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("gqa", [(8, 2), (12, 1)])
def test_core_decode_combine_ref_matches_pallas_kernel_at_d32(splits, gqa):
    """The CUDA-core route's split decode in fp32 at D 32, plainly (each
    split's partials, then combined, also by ``decode_combine`` with an
    fp32 output), against the reference's ``make_flash_decode`` in
    interpret mode (fp32 2e-3)."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import make_flash_decode

    Hq, Hkv = gqa
    B, S, D = 2, 384, 32
    q, k, v = _qkv(10, B, Hq, Hkv, 1, S, D)
    want = np.asarray(make_flash_decode(B, Hq, Hkv, S, D, 128)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = _port(q, k, v)
    got = decode_combine_ref(tq, tk, tv, splits)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    combined = K.decode_combine(decode_partials_ref(tq, tk, tv, splits), torch.float32)
    np.testing.assert_allclose(combined.numpy(), want, atol=2e-3)
    np.testing.assert_allclose(K.flash_decode(tq, tk, tv, 128, splits=splits).numpy(), want,
                               atol=2e-3)


def _ablation_cases():
    from repro_torch.kernels.flash_attention import ablate

    return [*ablate.VARIANTS.items(), *ablate.PROBES.items(), *ablate.HEAD_DIM_VARIANTS.items(),
            *ablate.DECODE_VARIANTS.items(),
            *ablate.DECODE_PROBES.items(), *ablate.CORE_VARIANTS.items(),
            *ablate.FWD32_VARIANTS.items(), *ablate.FWD32_PROBES.items(),
            *ablate.FWD64_VARIANTS.items()]


@pytest.mark.parametrize("part,want", [
    ("fwd", {"as built", "no ping-pong", "probe: no Q K^T", "fwd: P V over the padded width"}),
    ("fwd64", {"as built", "no ping-pong", "fwd64: 2 stages", "fwd64: 4 stages",
               "fwd64: one q block a CTA"}),
    ("decode", {"as built", "decode: one consumer warp", "decode probe: loads only"}),
    ("all", {"no ping-pong", "decode: CUDA-core kernel", "fwd32: one TF32 pass"}),
    ("fwd32", {"as built", "fwd32: one TF32 pass", "fwd32: 4 consumer warps", "fwd32: 4 stages",
               "fwd32: hi by cvt.rna"}),
])
def test_ablation_builds_the_variants_of_each_part(part, want):
    from repro_torch.kernels.flash_attention import ablate

    edits = ablate.variant_edits(part)
    assert want <= set(edits) and edits["as built"] == []
    for prefix in ("decode", "fwd32"):
        assert all(name.startswith(prefix) for name in edits if name != "as built") == (part == prefix)


def test_ablation_base_must_hold_the_parts_old_kernel(tmp_path):
    """``--base`` names a checkout whose ``flash_attention.cu`` holds the old
    kernel of the part asked for: this tree's source holds neither."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ablate

    csrc = tmp_path / "src" / "repro_torch" / "csrc"
    csrc.mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        ablate.old_source(tmp_path, "fwd32")
    (csrc / "flash_attention.cu").write_text((_build.CSRC / "flash_attention.cu").read_text())
    for part in ("fwd32", "decode", "fwd", "fwd64", "all"):
        with pytest.raises(ValueError, match="old kernel"):
            ablate.old_source(tmp_path, part)
    (csrc / "flash_attention.cu").write_text(ablate.OLD_MARKERS["fwd32"])
    assert ablate.old_source(tmp_path, "fwd32") == csrc / "flash_attention.cu"
    with pytest.raises(ValueError, match="decode"):
        ablate.old_source(tmp_path, "all")


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
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("case", ["permutation", "random"])
def test_card_wgmma_pv_fragment_layout(cuda, D, case):
    """One consumer's P·V of the wgmma kernel, alone: P goes into the S
    accumulator's registers and leaves as register-A fragments.  With P a
    permutation (row i picks key 37 i + 5 mod 128) and V small integers
    (exact in bf16), O must be V's rows in that order exactly; an element
    taken from the wrong fragment names the key it came from.  At D 32, 80
    and 96 V is zero-padded to whole 64-column boxes, as in the kernel."""
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
                                     (torch.float32, 64), (torch.bfloat16, 80),
                                     (torch.bfloat16, 96), (torch.float32, 80),
                                     (torch.float32, 96), (torch.float32, 128)])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv", [(3, 5, 5, 128, 128), (1, 6, 2, 256, 384),
                                             (3, 3, 1, 384, 384), (1, 2, 2, 128, 128),
                                             (1, 4, 2, 128, 512), (2, 32, 8, 2048, 2048),
                                             (3, 5, 1, 128, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_card_forward_matches_plain_on_odd_heads(cuda, dtype, D, B, Hq, Hkv, Sq, Skv, causal):
    """Odd B·Hq, GQA groups of 1 to 5, Sq < Skv (the causal offset, up to
    three blocks), a single diagonal block, and more tiles than two
    waves of 132 SMs (each persistent wgmma CTA walks several); bf16 at both
    tiles runs the wgmma kernel at every head dim, and the library's route table
    agrees with ``fwd_route``.  fp32 (three TF32 passes) is also held to
    the plain emulation of its passes, ``attention_split_tf32_ref``."""
    q, k, v = _card_qkv(cuda, dtype, B, Hq, Hkv, Sq, Skv, D)
    want = attention_ref(q, k, v, causal).float()
    split = attention_split_tf32_ref(q, k, v, causal) if dtype == torch.float32 else None
    for bq, bk in K.FWD_TILES:
        route = K.fwd_route(dtype, D, bq, bk)
        if dtype == torch.bfloat16:
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
        if split is not None:
            torch.testing.assert_close(got, split, rtol=0, atol=ATOL[dtype])
            assert row_rel_err(got, split) <= ROW_REL[dtype], f"bq={bq} bk={bk} split"


@pytest.mark.gpu
def test_card_stream_handle_is_the_current_stream(cuda):
    """The wrappers launch on the stream ``torch.cuda.current_stream``
    names, inside a stream context too."""
    from repro_torch.kernels import raw_stream

    index = torch.cuda.current_device()
    assert raw_stream(index) == torch.cuda.current_stream(index).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert raw_stream(index) == side.cuda_stream


@pytest.mark.gpu
@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_card_wgmma_padded_columns_do_not_leak(cuda, D, causal):
    """The wgmma forward pads D 80 and 96 to 128 columns in shared memory
    only.  V's last D % 64 columns (16 at D 80, 32 at 96: those of the
    second, zero-padded box) hold values 1024 times the others, and Q's
    and K's are doubled there, so that a missed k step moves every score.
    Each output column must match the plain version at its own scale, and
    the kernel writes nothing past the output: a padded column, a column
    shifted into a neighbouring row or a box landing in the wrong place
    shows as a wrong value or a changed guard."""
    B, Hq, Hkv, S = 2, 4, 2, 256
    wide, big = D % 64, 1024.0
    q, k, v = _card_qkv(cuda, torch.float32, B, Hq, Hkv, S, S, D, seed=4)
    q[..., D - wide:] *= 2
    k[..., D - wide:] *= 2
    v[..., D - wide:] *= big
    q, k, v = (t.bfloat16() for t in (q, k, v))
    assert K.fwd_route(torch.bfloat16, D, 128, 128) == "wgmma"
    want = attention_ref(q.float(), k.float(), v.float(), causal)
    got = K.flash_attention_fwd(q, k, v, 128, 128, causal)
    n = got.numel()
    guarded = torch.full((n + 4096,), float("nan"), device=cuda, dtype=torch.bfloat16)
    rc = K._lib().flash_fwd_launch(2, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   guarded.data_ptr(), B, Hq, Hkv, S, S, D, 128, 128, 128, 128,
                                   D ** -0.5, int(causal), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert bool(torch.isnan(guarded[n:]).all()), "the kernel wrote past its output"
    assert torch.equal(guarded[:n].view_as(got), got)
    scale = torch.ones(D, device=cuda)
    scale[D - wide:] = big
    err = ((got.float() - want).abs() / scale).amax(dim=(0, 1, 2))
    bad = (err > ATOL[torch.bfloat16]).nonzero().flatten().tolist()
    assert not bad, f"columns {bad} off by up to {float(err.max()):.3e} of their scale"
    assert row_rel_err(got, want) <= ROW_REL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv", [(2, 4, 2, 256, 256), (1, 4, 1, 128, 384),
                                             (1, 4, 2, 512, 256), (1, 3, 1, 192, 192),
                                             (2, 2, 2, 320, 448), (1, 4, 2, 320, 192)])
@pytest.mark.parametrize("causal", [True, False])
def test_card_fwd64_matches_plain(cuda, D, B, Hq, Hkv, Sq, Skv, causal):
    """bf16 at (64, 64) runs the wgmma kernel, its two consumers on two
    adjacent 64-row q blocks sharing one ring of 64-key blocks: GQA, Sq =
    Skv, Sq < Skv, Sq > Skv (rows that see no key), and Sq an odd number of
    64-row blocks (the last tile's second consumer has no rows), against
    ``attention_blocks_ref`` at (64, 64); the rows that see no key exactly
    (p = 1 is exact in bf16 and each block's sum of bf16 values is exact in
    fp32 at these sizes)."""
    q, k, v = _card_qkv(cuda, torch.bfloat16, B, Hq, Hkv, Sq, Skv, D, seed=9)
    assert K.fwd_route(torch.bfloat16, D, 64, 64) == "wgmma"
    assert K._lib().flash_fwd_route(2, D, 64, 64) == K.FWD_ROUTES["wgmma"]
    want = attention_blocks_ref(q, k, v, causal, 64, 64)
    got = K.flash_attention_fwd(q, k, v, 64, 64, causal)
    torch.cuda.synchronize()
    assert K.LAST_LAUNCH["flash_attention_fwd"] == (64, 64, causal)
    assert bool(torch.isfinite(got).all())
    n = max(0, Sq - Skv) if causal else 0
    assert torch.equal(got[:, :, :n], want[:, :, :n]), "rows that see no key"
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[torch.bfloat16])
    assert row_rel_err(got[:, :, n:], want[:, :, n:]) <= ROW_REL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 80, 96])
@pytest.mark.parametrize("Sq,Skv", [(320, 320), (320, 192)])
def test_card_fwd64_writes_nothing_past_its_output(cuda, D, Sq, Skv):
    """The (64, 64) kernel loads Q in 128-row boxes: with Sq an odd number of
    64-row blocks the last tile's box runs into the next head (or past the
    tensor) and its second consumer must store nothing.  The output sits in
    a buffer with a guard band of NaN behind it, which must stay NaN, and
    the output equals the wrapper's."""
    B, Hq, Hkv = 2, 4, 2
    q, k, v = _card_qkv(cuda, torch.bfloat16, B, Hq, Hkv, Sq, Skv, D, seed=12)
    got = K.flash_attention_fwd(q, k, v, 64, 64, True)
    n = got.numel()
    guarded = torch.full((n + 8192,), float("nan"), device=cuda, dtype=torch.bfloat16)
    rc = K._lib().flash_fwd_launch(2, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   guarded.data_ptr(), B, Hq, Hkv, Sq, Skv, D, 64, 64, 64, 64,
                                   D ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert bool(torch.isnan(guarded[n:]).all()), "the kernel wrote past its output"
    assert torch.equal(guarded[:n].view_as(got), got)
    want = attention_blocks_ref(q, k, v, True, 64, 64)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("config", [{"bq": 128, "bk": 128}, {"bq": 256, "bk": 128},
                                    {"bq": 512, "bk": 256}, {"bq": 128, "bk": 512},
                                    {"bq": 1024, "bk": 256}, {"bq": 64, "bk": 64}])
def test_card_reference_configs_and_rows_without_a_key(cuda, dtype, config):
    """A causal call with Sq > Skv through the entry point at a pinned
    config: a config of the reference's space runs the kernel at (128, 128)
    (``LAST_LAUNCH``), and the rows that see no key take the config's own
    blocks (``LAST_CONFIG`` keeps what was asked).  Against
    ``attention_blocks_ref`` at the config: the rows that see no key
    exactly in bf16, to 1e-6 in fp32 (three TF32 passes sum V on the tensor
    cores, in their own order), every other row to the tolerances."""
    B, Hq, Hkv, Sq, Skv, D = 1, 32, 8, 1024, 512, 64
    q, k, v = _card_qkv(cuda, dtype, B, Hq, Hkv, Sq, Skv, D, seed=13)
    got = ops.flash_attention(q, k, v, causal=True, config=config)
    torch.cuda.synchronize()
    tile = (config["bq"], config["bk"]) if config in TILES else (128, 128)
    assert K.LAST_LAUNCH["flash_attention_fwd"] == (*tile, True)
    assert ops.LAST_CONFIG == {"config": config, "tile": tile}
    want = attention_blocks_ref(q, k, v, True, config["bq"], config["bk"])
    n = Sq - Skv
    assert bool(torch.isfinite(got).all())
    if dtype == torch.bfloat16:
        assert torch.equal(got[:, :, :n], want[:, :, :n]), "rows that see no key"
    else:
        torch.testing.assert_close(got[:, :, :n], want[:, :, :n], rtol=0, atol=1e-6)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[dtype])
    assert row_rel_err(got[:, :, n:], want[:, :, n:]) <= ROW_REL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tile,blocks", [((128, 128), (384, 256)), ((128, 128), (384, 128)),
                                         ((64, 64), (192, 64)), ((64, 64), (384, 128)),
                                         ((64, 64), (128, 256))])
def test_card_rows_without_a_key_at_multiples_of_the_tile(cuda, dtype, tile, blocks):
    """The kernel-level forward at Sq 384 > Skv 256 with blocks that are
    multiples of the tile but no config of the entry point: the rows that
    see no key (0-127) average all 256 keys, the first 128, the first 64,
    all 256, or none.  Against ``attention_blocks_ref``: those rows exactly
    in bf16, to 1e-6 in fp32, every other row to the tolerances."""
    B, Hq, Hkv, Sq, Skv, D = 1, 4, 2, 384, 256, 64
    q, k, v = _card_qkv(cuda, dtype, B, Hq, Hkv, Sq, Skv, D, seed=17)
    got = K.flash_attention_fwd(q, k, v, *tile, True, blocks=blocks)
    torch.cuda.synchronize()
    want = attention_blocks_ref(q, k, v, True, *blocks)
    n = Sq - Skv
    assert bool(torch.isfinite(got).all())
    if dtype == torch.bfloat16:
        assert torch.equal(got[:, :, :n], want[:, :, :n]), "rows that see no key"
    else:
        torch.testing.assert_close(got[:, :, :n], want[:, :, :n], rtol=0, atol=1e-6)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[dtype])
    assert row_rel_err(got[:, :, n:], want[:, :, n:]) <= ROW_REL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_card_tf32_forward_picks_exactly(cuda, D, causal):
    """The fp32 forward with one-hot scores: q row i of head h is one-hot at
    column d = (i + 3h) % D, and for each KV head and column one key holds
    2048 there (visible to every row that reads the column), the other K
    and V entries small integers, all exact in TF32.  The winning score
    outweighs the rest by more than 2^200 after the scale, so p is exactly
    one-hot and every output row must be its key's V row exactly: a
    misplaced Q, K, V or P fragment, a swizzle read from the wrong chunk,
    or a block taken twice shows as a wrong value."""
    B, Hq, Hkv, Sq, Skv = 2, 6, 2, 128, 384
    group, off = Hq // Hkv, Skv - Sq
    rng = np.random.default_rng(15)
    k = rng.integers(-4, 5, (B, Hkv, Skv, D)).astype(np.float32)
    v = rng.integers(-8, 9, (B, Hkv, Skv, D)).astype(np.float32)
    q = np.zeros((B, Hq, Sq, D), np.float32)
    pick = (np.arange(D)[None, None, :] * 37 + 11 * np.arange(Hkv)[None, :, None]
            + 5 * np.arange(B)[:, None, None]) % (off + 1)  # keys every row sees
    for b in range(B):
        for kvh in range(Hkv):
            k[b, kvh, pick[b, kvh], np.arange(D)] = 2048.0
    want = np.zeros_like(q)
    for b in range(B):
        for h in range(Hq):
            d = (np.arange(Sq) + 3 * h) % D
            q[b, h, np.arange(Sq), d] = 1.0
            want[b, h] = v[b, h // group, pick[b, h // group, d]]
    tq, tk, tv = (torch.from_numpy(a).to(cuda) for a in (q, k, v))
    for tile in K.FWD_TILES:
        got = K.flash_attention_fwd(tq, tk, tv, *tile, causal).cpu().numpy()
        bad = np.argwhere(got != want)
        if len(bad):
            b, h, i, d = bad[0]
            pytest.fail(f"{tile}: {len(bad)} wrong elements; o[{b}, {h}, {i}, {d}] = "
                        f"{got[b, h, i, d]}, want {want[b, h, i, d]}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
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
    assert K.LAUNCHES == {"flash_attention_fwd": 1, "flash_decode": 0, "flash_decode_combine": 0}
    assert K.LAST_LAUNCH["flash_attention_fwd"] == (128, 128, True)
    torch.testing.assert_close(got.float(), attention_ref(q, k, v).float(), rtol=0, atol=3e-2)
    assert row_rel_err(got, attention_ref(q, k, v)) <= ROW_REL[torch.bfloat16]
    flash_attention(q[:, :, :1], k, v)
    flash_attention(q[:, :, :100], k[:, :, :100], v[:, :, :100])  # plain version
    torch.cuda.synchronize()
    # four (b, KV head) units leave the card idle: the cache is split and combined
    assert K.LAST_DECODE == {"route": "tma_mma", "splits": 2}
    assert K.LAUNCHES == {"flash_attention_fwd": 1, "flash_decode": 1, "flash_decode_combine": 1}


def _check_decode(got, q, k, v, what):
    want = attention_ref(q, k, v, causal=False)
    assert got.shape == q.shape and got.dtype == q.dtype and bool(torch.isfinite(got).all()), what
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[q.dtype], msg=what)
    assert row_rel_err(got, want) <= ROW_REL[q.dtype], what


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Skv", [1024 + 128, 1024 + 64])
@pytest.mark.parametrize("B,Hq,Hkv", [(3, 8, 2), (1, 5, 1), (2, 32, 8)])
def test_card_tma_decode_masks_the_end_of_a_unit(cuda, D, Skv, B, Hq, Hkv):
    """Nine 128-key blocks, or eight and a half (bk 64): the last unit's box
    runs into the next KV head's rows or past the tensor, and those keys
    must add nothing; every split count, the default's too, leaves an
    uneven last split."""
    q, k, v = _card_qkv(cuda, torch.bfloat16, B, Hq, Hkv, 1, Skv, D, seed=3)
    assert K.decode_route(torch.bfloat16, D) == "tma_mma"
    assert K._lib().flash_decode_route(2, D) == K.DECODE_ROUTES["tma_mma"]
    for splits in (None, 1, 2, 4):
        K.reset_launch_counts()
        got = K.flash_decode(q, k, v, 64, splits=splits)
        torch.cuda.synchronize()
        n = K.LAST_DECODE["splits"]
        assert K.LAST_DECODE["route"] == "tma_mma" and (splits is None or n == splits)
        assert K.LAUNCHES["flash_decode"] == 1 and K.LAST_LAUNCH["flash_decode"] == 64
        assert K.LAUNCHES["flash_decode_combine"] == (n > 1)
        _check_decode(got, q, k, v, f"splits={splits} ({n})")


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("group", [12, 16, 17])
def test_card_tma_decode_groups_over_eight_heads(cuda, D, group):
    """All 16 rows of the A tile, and a group of 17 that takes two chunks
    (16 query heads and 1) of one KV head."""
    q, k, v = _card_qkv(cuda, torch.bfloat16, 2, 2 * group, 2, 1, 1024, D, seed=4)
    for splits in (1, 3):
        _check_decode(K.flash_decode(q, k, v, 128, splits=splits), q, k, v, f"splits={splits}")
    assert K.LAST_DECODE == {"route": "tma_mma", "splits": 3}


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_card_tma_decode_split_counts_agree(cuda, D):
    """Splits 1, 2, 7 and the most allowed (one 128-key block each) give the
    same output within the row bound."""
    B, Hq, Hkv, Skv = 2, 8, 2, 4096 + 128
    q, k, v = _card_qkv(cuda, torch.bfloat16, B, Hq, Hkv, 1, Skv, D, seed=5)
    outs = {}
    for splits in (1, 2, 7, Skv // 128):
        outs[splits] = K.flash_decode(q, k, v, 128, splits=splits)
        torch.cuda.synchronize()
        assert K.LAST_DECODE["splits"] == splits
        _check_decode(outs[splits], q, k, v, f"splits={splits}")
    for splits, got in outs.items():
        assert row_rel_err(got, outs[1]) <= ROW_REL[torch.bfloat16], splits


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("splits", [1, 3])
def test_card_tma_decode_fragments_exactly(cuda, D, splits):
    """Each query head's one-hot q picks column d_h; K holds small integers
    but for one key a head, whose column d_h holds 2048, so its score
    outweighs every other by more than e^88 and p is exactly one-hot in
    fp32; V holds small integers.  The output must then be that key's V
    row exactly: a misplaced Q, K or V fragment, or a masked key that
    leaks, shows as a wrong value, not as a tolerance miss."""
    B, Hq, Hkv, Skv = 3, 16, 4, 1024 + 64
    group = Hq // Hkv
    rng = np.random.default_rng(6)
    k = rng.integers(-4, 5, (B, Hkv, Skv, D)).astype(np.float32)
    v = rng.integers(-8, 9, (B, Hkv, Skv, D)).astype(np.float32)
    q = np.zeros((B, Hq, 1, D), np.float32)
    picks = {}
    for b in range(B):
        for h in range(Hq):
            kvh, g = divmod(h, group)
            d = (7 * h + 5 * b + 3) % D
            key = (389 * h + 127 * b + 61) % Skv if (b, h) != (0, 0) else Skv - 1
            q[b, h, 0, d] = 1.0
            k[b, kvh, key, d] = 2048.0
            picks[b, h] = (kvh, key)
    # a KV head's last box runs 64 rows into the next KV head's keys 0-63:
    # make those the best match for this KV head's query heads (in columns
    # that the next KV head's own query heads do not read), so a leak shows
    for b in range(B):
        for kvh in range(Hkv - 1):
            for h in range(kvh * group, (kvh + 1) * group):
                k[b, kvh + 1, :64, (7 * h + 5 * b + 3) % D] = 4096.0
    want = np.stack([np.stack([v[b, picks[b, h][0], picks[b, h][1]] for h in range(Hq)])
                     for b in range(B)])[:, :, None]
    tq, tk, tv = (torch.from_numpy(a).to(cuda).bfloat16() for a in (q, k, v))
    got = K.flash_decode(tq, tk, tv, 64, splits=splits).float().cpu().numpy()
    assert K.LAST_DECODE == {"route": "tma_mma", "splits": splits}
    bad = np.argwhere(got != want)
    if len(bad):
        b, h, _, d = bad[0]
        pytest.fail(f"{len(bad)} wrong elements; o[{b}, {h}, {d}] = {got[b, h, 0, d]}, want "
                    f"{want[b, h, 0, d]} (key {picks[b, h][1]} of KV head {picks[b, h][0]})")


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("splits", [2, 5, 40])
def test_card_decode_combine_matches_plain(cuda, D, splits):
    """The combine kernel alone, on the plain version's partials."""
    q, k, v = _card_qkv(cuda, torch.bfloat16, 3, 12, 3, 1, 40 * 128, D, seed=7)
    part = decode_partials_ref(q, k, v, splits)
    before = K.LAUNCHES["flash_decode_combine"]
    got = K.decode_combine(part)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_decode_combine"] == before + 1
    want = combine_partials_ref(part, torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=1e-2)
    assert row_rel_err(got, combine_partials_ref(part, torch.float32)) <= 4e-3


CORE_ROUTES = [(torch.float32, 32), (torch.float32, 64), (torch.float32, 128), (torch.bfloat16, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D", CORE_ROUTES)
@pytest.mark.parametrize("B,Hq,Hkv,Skv", [(2, 8, 2, 1024 + 64), (1, 5, 1, 2048), (3, 24, 2, 512)])
def test_card_core_decode_split_counts(cuda, dtype, D, B, Hq, Hkv, Skv):
    """The CUDA-core decode at split counts 1, 2, the chosen count and one
    128-key block a split (the last one cut to 64 keys where Skv is 1088),
    groups of 4 (one unit of 4), 5 (of 8) and 12 (8 and 4), against the
    plain version; more than one split runs the combine in the output's
    dtype."""
    q, k, v = _card_qkv(cuda, dtype, B, Hq, Hkv, 1, Skv, D, seed=12)
    assert K.decode_route(dtype, D) == "cuda_cores"
    assert K._lib().flash_decode_route(q.element_size(), D) == K.DECODE_ROUTES["cuda_cores"]
    nb = -(-Skv // 128)
    for splits in (1, 2, None, nb):
        K.reset_launch_counts()
        got = K.flash_decode(q, k, v, 64, splits=splits)
        torch.cuda.synchronize()
        n = K.LAST_DECODE["splits"]
        assert K.LAST_DECODE["route"] == "cuda_cores" and (splits is None or n == splits)
        assert K.LAUNCHES["flash_decode"] == 1 and K.LAUNCHES["flash_decode_combine"] == (n > 1)
        _check_decode(got, q, k, v, f"splits={splits} ({n})")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D", CORE_ROUTES)
@pytest.mark.parametrize("splits", [1, 3])
def test_card_core_decode_picks_exactly(cuda, dtype, D, splits):
    """As ``test_card_tma_decode_fragments_exactly`` on the CUDA-core route:
    one key a query head outweighs every other by more than e^100, so p is
    exactly one-hot in fp32 and the output is that key's V row exactly; a
    lane reading the wrong key, chunk or column, or a block taken twice,
    shows as a wrong value."""
    B, Hq, Hkv, Skv = 3, 12, 2, 1024 + 64
    group = Hq // Hkv
    rng = np.random.default_rng(13)
    k = rng.integers(-4, 5, (B, Hkv, Skv, D)).astype(np.float32)
    v = rng.integers(-8, 9, (B, Hkv, Skv, D)).astype(np.float32)
    q = np.zeros((B, Hq, 1, D), np.float32)
    picks = {}
    for b in range(B):
        for h in range(Hq):
            kvh = h // group
            d = (7 * h + 5 * b + 3) % D
            key = (389 * h + 127 * b + 61) % Skv if (b, h) != (0, 0) else Skv - 1
            q[b, h, 0, d] = 1.0
            k[b, kvh, key, d] = 2048.0
            picks[b, h] = (kvh, key)
    want = np.stack([np.stack([v[b, picks[b, h][0], picks[b, h][1]] for h in range(Hq)])
                     for b in range(B)])[:, :, None]
    tq, tk, tv = (torch.from_numpy(a).to(cuda).to(dtype) for a in (q, k, v))
    got = K.flash_decode(tq, tk, tv, 64, splits=splits).float().cpu().numpy()
    assert K.LAST_DECODE == {"route": "cuda_cores", "splits": splits}
    bad = np.argwhere(got != want)
    if len(bad):
        b, h, _, d = bad[0]
        pytest.fail(f"{len(bad)} wrong elements; o[{b}, {h}, {d}] = {got[b, h, 0, d]}, want "
                    f"{want[b, h, 0, d]} (key {picks[b, h][1]} of KV head {picks[b, h][0]})")


@pytest.mark.gpu
@pytest.mark.parametrize("D", [32, 64, 128])
def test_card_decode_combine_writes_fp32(cuda, D):
    """The combine kernel with an fp32 output, on the plain version's
    partials, at every decode head dim."""
    q, k, v = _card_qkv(cuda, torch.float32, 3, 12, 3, 1, 40 * 128, D, seed=14)
    part = decode_partials_ref(q, k, v, 5)
    got = K.decode_combine(part, torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, combine_partials_ref(part, torch.float32), rtol=0, atol=1e-5)
