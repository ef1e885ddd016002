"""The port's attention layer against the JAX package's.

Weights come from the reference's ``attention_init`` and are carried across
by ``convert.attention_params_from_numpy`` (bf16 included); inputs are made
with numpy.  ``attention_apply`` runs with ``use_pallas`` on and off, in
fp32 and bf16, at the reduced config's widths (d_model 128, 4 heads, 2 KV
heads, head_dim 32, S = 128).  The reference's ``flash_attention(config=None)``
needs its tracer, broken on jax 0.9, so the tests that reach it seed its
config cache with the reference's own fallback tile first.  Tolerances:
fp32 2e-5 (the two frameworks sum in different orders); bf16 3e-2, as the
reference's bf16 flash test, since the projections round to bf16 at
slightly different places.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.configs import SHAPES, ArchConfig
from repro_torch.configs.granite3_2b import CONFIG as GRANITE
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ref import row_rel_err
from repro_torch.layers import shapes
from repro_torch.layers.attention import attention_apply, attention_init, chunked_attention
from repro_torch.layers.rope import apply_rope, rope_freqs

E, H, KV, D, S = 128, 4, 2, 32, 128
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _jax_params(dtype, bias=False, seed=0):
    import jax

    from repro.layers.attention import attention_init as jinit

    return jinit(jax.random.PRNGKey(seed), E, H, KV, D, bias, dtype)


@pytest.fixture
def seeded_reference_flash():
    """The reference's flash config cache seeded with its own fallback
    ``{"bq": 128, "bk": 128}`` (what it picks when its ranking is empty),
    removed again afterwards."""
    from repro.kernels.flash_attention import ops as jops

    keys = []

    def seed(B, itemsize, causal=True):
        key = (B, H, KV, S, S, D, causal, itemsize)
        jops._CONFIG_CACHE[key] = {"bq": 128, "bk": 128}
        keys.append(key)

    yield seed
    for key in keys:
        jops._CONFIG_CACHE.pop(key, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_apply_matches_reference(seeded_reference_flash, dtype, use_pallas, causal):
    import jax.numpy as jnp

    from repro.layers.attention import attention_apply as japply

    B = 2
    p = _jax_params(dtype)
    x = jnp.asarray(np.random.default_rng(1).standard_normal((B, S, E)).astype(np.float32)
                    ).astype(dtype)
    if use_pallas:
        seeded_reference_flash(B, jnp.dtype(dtype).itemsize, causal)
    want, cache = japply(p, x, n_heads=H, n_kv=KV, head_dim=D, causal=causal,
                         use_pallas=use_pallas)
    assert cache is None
    params = convert.attention_params_from_numpy({k: np.asarray(v) for k, v in p.items()}, "cpu")
    got, none = attention_apply(params, convert.from_numpy(np.asarray(x), "cpu"),
                                n_heads=H, n_kv=KV, head_dim=D, causal=causal,
                                use_pallas=use_pallas)
    assert none is None and got.dtype == params["wq"].dtype and got.shape == (B, S, E)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype])


@pytest.mark.parametrize("kwargs", [
    dict(window=48), dict(rope_theta=0.0), dict(positions="shifted"), dict(context=True)])
def test_attention_apply_options_match_reference(kwargs):
    """Bias, sliding window, no RoPE, explicit positions and cross-attention
    (which never takes the flash path), S = 96 so the flash path is off."""
    import jax.numpy as jnp

    from repro.layers.attention import attention_apply as japply

    B, Sx = 2, 96
    p = _jax_params("float32", bias=True, seed=3)
    p = {k: (v + 0.1 if k.startswith("b") else v) for k, v in p.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, Sx, E)).astype(np.float32)
    jk, tk = dict(kwargs), dict(kwargs)
    if kwargs.get("positions") == "shifted":
        pos = (np.arange(Sx)[None, :] + np.array([[0], [5]])).astype(np.int32)
        jk["positions"], tk["positions"] = jnp.asarray(pos), torch.from_numpy(pos)
    if kwargs.get("context"):
        ctx = rng.standard_normal((B, 40, E)).astype(np.float32)
        jk["context"], tk["context"] = jnp.asarray(ctx), torch.from_numpy(ctx)
    want, _ = japply(p, jnp.asarray(x), n_heads=H, n_kv=KV, head_dim=D, use_pallas=True,
                     chunk=32, **jk)
    params = convert.attention_params_from_numpy({k: np.asarray(v) for k, v in p.items()}, "cpu")
    got, _ = attention_apply(params, torch.from_numpy(x), n_heads=H, n_kv=KV, head_dim=D,
                             use_pallas=True, chunk=32, **tk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("Sq,Skv,chunk", [(1, 200, 1024), (4, 77, 1024), (130, 300, 64),
                                          (96, 96, 1024)])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_reference(Sq, Skv, chunk, causal):
    """Both branches (Sq <= 4 in one pass, else the chunk loop with a padded
    tail), with invalid cache slots (position -1) and a window."""
    import jax.numpy as jnp

    from repro.layers.attention import chunked_attention as jchunked

    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((2, 4, Sq, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, Skv, 32)).astype(np.float32)
    v = rng.standard_normal((2, 2, Skv, 32)).astype(np.float32)
    kpos = np.tile(np.arange(Skv, dtype=np.int32), (2, 1))
    kpos[1, -7:] = -1
    qpos = (np.arange(Sq) + Skv - Sq).astype(np.int32)
    for window, kp, qp in ((None, None, None), (50, kpos, qpos)):
        jkw = dict(causal=causal, window=window, chunk=chunk,
                   q_positions=None if qp is None else jnp.asarray(qp),
                   k_positions=None if kp is None else jnp.asarray(kp))
        tkw = dict(causal=causal, window=window, chunk=chunk,
                   q_positions=None if qp is None else torch.from_numpy(qp),
                   k_positions=None if kp is None else torch.from_numpy(kp))
        want = np.asarray(jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw))
        got = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), **tkw)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    import jax.numpy as jnp

    from repro.layers.rope import apply_rope as japply_rope
    from repro.layers.rope import rope_freqs as jfreqs

    np.testing.assert_allclose(rope_freqs(64).numpy(), np.asarray(jfreqs(64)), rtol=1e-6)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((2, 3, 40, 64))).astype(dtype)
    pos = np.tile(np.arange(40, dtype=np.int32) * 7, (2, 1))[:, None, :]
    want = np.asarray(japply_rope(x, jnp.asarray(pos), 500.0), np.float32)
    got = apply_rope(convert.from_numpy(np.asarray(x), "cpu"), torch.from_numpy(pos), 500.0)
    assert got.dtype == convert.from_numpy(np.asarray(x), "cpu").dtype
    # angles up to 273 rad: fp32 sin/cos of the two libraries differ by ulps
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-4 if dtype == "float32" else
                               2e-2)


@pytest.mark.parametrize("bias", [False, True])
def test_attention_init_shapes_and_scales(bias):
    gen = torch.Generator().manual_seed(0)
    p = attention_init(2048, 32, 8, 64, bias, torch.bfloat16, generator=gen, device="cpu")
    ref = {k: np.asarray(v) for k, v in _jax_params("bfloat16", bias).items()}
    assert set(p) == set(ref)
    want = shapes.attention_proj_shapes(2048, 32, 8, 64)
    assert p["wq"].shape == want["q"] and p["wo"].shape == want["out"]
    assert p["wk"].shape[1] + p["wv"].shape[1] == want["kv"][1]
    assert all(t.dtype == torch.bfloat16 for t in p.values())
    for name, scale in (("wq", 2048 ** -0.5), ("wk", 2048 ** -0.5), ("wo", 2048 ** -0.5)):
        assert abs(float(p[name].float().std()) / scale - 1) < 0.02
    if bias:
        assert all(not p[b].any() for b in ("bq", "bk", "bv"))
    again = attention_init(2048, 32, 8, 64, bias, torch.bfloat16,
                           generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_attention_init_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attention_init(64, 2, 1, 32, generator=torch.Generator().manual_seed(0))
    p = attention_init(64, 2, 1, 32, generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(t.device.type == "cpu" for t in p.values())


def test_attention_params_from_numpy_carries_bf16_bits():
    p = {k: np.asarray(v) for k, v in _jax_params("bfloat16", bias=True).items()}
    got = convert.attention_params_from_numpy(p, "cpu")
    for k, v in p.items():
        assert got[k].dtype == torch.bfloat16 and tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy().view(np.uint16),
                                      v.view(np.uint16))
    with pytest.raises(KeyError, match="unknown"):
        convert.attention_params_from_numpy({**p, "w_gate": p["wq"]}, "cpu")
    with pytest.raises(KeyError, match="missing"):
        convert.attention_params_from_numpy({"wq": p["wq"]}, "cpu")


def test_configs_and_shapes_equal_reference():
    import dataclasses

    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs.base import ArchConfig as RefArch
    from repro.configs.granite3_2b import CONFIG as REF_GRANITE
    from repro.layers import shapes as ref_shapes

    assert dataclasses.asdict(GRANITE) == dataclasses.asdict(REF_GRANITE)
    assert dataclasses.asdict(GRANITE.reduced()) == dataclasses.asdict(REF_GRANITE.reduced())
    assert [f.name for f in dataclasses.fields(ArchConfig)] == [
        f.name for f in dataclasses.fields(RefArch)]
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    assert (GRANITE.resolved_head_dim, GRANITE.padded_vocab) == (64, 49408)
    for args in [(2048, 32, 8, 64), (128, 4, 2, 32)]:
        assert shapes.attention_proj_shapes(*args) == ref_shapes.attention_proj_shapes(*args)
    for kind in ("swiglu", "gelu"):
        assert shapes.mlp_shapes(2048, 8192, kind) == ref_shapes.mlp_shapes(2048, 8192, kind)


# ---------------------------------------------------------------------------
# On the card: the layer through the flash kernel against the chunked path
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol,row_rel", [(torch.bfloat16, 3e-2, 2e-2),
                                               (torch.float32, 2e-3, 1e-4)])
def test_card_attention_apply_runs_the_flash_kernel_once(cuda, dtype, tol, row_rel):
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = attention_init(512, 8, 2, 64, True, dtype, generator=gen, device=cuda)
    x = torch.randn((2, 384, 512), generator=gen, device=cuda).to(dtype)
    FK.reset_launch_counts()
    got, _ = attention_apply(params, x, n_heads=8, n_kv=2, head_dim=64, use_pallas=True)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == {"flash_attention_fwd": 1, "flash_decode": 0, "flash_decode_combine": 0}
    want, _ = attention_apply(params, x, n_heads=8, n_kv=2, head_dim=64, use_pallas=False)
    assert FK.LAUNCHES["flash_attention_fwd"] == 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert row_rel_err(got, want) <= row_rel  # each token's d_model outputs
