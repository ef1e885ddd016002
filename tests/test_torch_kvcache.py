"""The port's KV cache and the cache branch of ``attention_apply`` against the
JAX package's.

``KVCache.init`` / ``append`` / ``dequant`` run on both sides over the same
appends (a prefill, then decode steps), full and ring, bf16 and int8: the
stored codes, scales, positions and cursor must be equal, bit for bit.  The
cache branch of ``attention_apply`` runs a prefill and decode steps with
weights from the reference's ``attention_init`` (carried across by
``convert.attention_params_from_numpy``), inputs made with numpy from a
seed, at d_model 128, 4 heads, 2 KV heads, head_dim 32.  Tolerances: fp32
2e-5, as ``tests/test_torch_attention.py``; bf16 3e-2.  The reference's own
checks (``tests/test_attention_and_moe.py``: decode through the cache equals
full attention, the ring cache's wraparound equals the window) run on the
port at their tolerance, 2e-3.  Appends keep Sq <= C: with more, one
scatter writes a slot twice, in an order neither side specifies.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.layers.attention import KVCache, attention_apply, chunked_attention

E, H, KV, D = 128, 4, 2, 32
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# appends of (prefill, decode, decode, ...) tokens; the ring (capacity 16)
# wraps on the third and later
STEPS = (12, 1, 1, 3, 1, 5)


def _jnp(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def _cache_np(cache) -> dict:
    return {k: None if v is None else np.asarray(v) for k, v in cache._asdict().items()}


def _assert_same_cache(got: KVCache, want):
    """Every field equal, bit for bit (bf16 by its bits)."""
    w = _cache_np(want)
    assert got.quantized == (w["k_scale"] is not None)
    for name, t in got._asdict().items():
        if t is None:
            assert w[name] is None
            continue
        arr = w[name]
        if arr.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          arr.view(np.uint16), err_msg=name)
        else:
            assert str(t.dtype).split(".")[1] == arr.dtype.name, name
            np.testing.assert_array_equal(t.numpy(), arr, err_msg=name)


def _kv(B, S, dtype, seed):
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((B, KV, S, D)).astype(np.float32) * 2 for _ in range(2))
    import jax.numpy as jnp

    jk, jv = jnp.asarray(k).astype(dtype), jnp.asarray(v).astype(dtype)
    return jk, jv, convert.from_numpy(np.asarray(jk), "cpu"), convert.from_numpy(
        np.asarray(jv), "cpu")


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("capacity", [40, 16], ids=["full", "ring"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_appends_match_reference(dtype, capacity, quantized):
    from repro.layers.attention import KVCache as JCache

    B = 2
    import jax.numpy as jnp

    want = JCache.init(B, KV, capacity, D, jnp.dtype(dtype), quantized=quantized)
    got = KVCache.init(B, KV, capacity, D, getattr(torch, dtype), quantized=quantized,
                       device="cpu")
    _assert_same_cache(got, want)
    start = np.array([[0], [7]])  # the two rows' positions differ
    t = 0
    for i, n in enumerate(STEPS):
        jk, jv, tk, tv = _kv(B, n, dtype, seed=i)
        pos = (start + t + np.arange(n)[None]).astype(np.int32)
        want = want.append(jk, jv, _jnp(pos))
        got = got.append(tk, tv, torch.from_numpy(pos))
        _assert_same_cache(got, want)
        t += n
    jk, jv = want.dequant()
    k, v = got.dequant()
    assert k.dtype == (torch.bfloat16 if quantized else getattr(torch, dtype))
    for a, b in ((k, jk), (v, jv)):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_cache_init_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVCache.init(1, 2, 8, 16)
    c = KVCache.init(1, 2, 8, 16, quantized=True, device="cpu")
    assert all(t.device.type == "cpu" for t in c if t is not None)
    assert c.k.dtype == torch.int8 and c.k_scale.dtype == torch.float32
    assert c.positions.dtype == torch.int32 and int(c.positions.max()) == -1
    assert c.cursor.dtype == torch.int32 and not c.cursor.any()


@pytest.mark.parametrize("quantized", [False, True])
def test_append_writes_in_place_and_aliases(quantized):
    """``append`` consumes the cache: the returned tuple holds the very
    tensors of the old one, written in place, and equals the reference's
    functional result."""
    from repro.layers.attention import KVCache as JCache

    old = KVCache.init(1, KV, 8, D, torch.float32, quantized=quantized, device="cpu")
    ptrs = [None if t is None else t.data_ptr() for t in old]
    _, _, tk, tv = _kv(1, 3, "float32", seed=3)
    pos = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    new = old.append(tk, tv, pos)
    for a, b, ptr in zip(old, new, ptrs):
        assert a is b
        assert ptr is None or a.data_ptr() == ptr
    assert int(new.cursor[0]) == 3 and new.positions[0, :3].tolist() == [0, 1, 2]
    import jax.numpy as jnp

    want = JCache.init(1, KV, 8, D, jnp.float32, quantized=quantized).append(
        _jnp(tk.numpy()), _jnp(tv.numpy()), _jnp(pos.numpy()))
    _assert_same_cache(new, want)


def test_kv_cache_from_numpy_carries_the_reference_cache():
    import jax.numpy as jnp

    from repro.layers.attention import KVCache as JCache

    for quantized in (False, True):
        want = JCache.init(2, KV, 8, D, jnp.bfloat16, quantized=quantized)
        jk, jv, _, _ = _kv(2, 5, "bfloat16", seed=4)
        want = want.append(jk, jv, _jnp(np.tile(np.arange(5, dtype=np.int32), (2, 1))))
        got = convert.kv_cache_from_numpy(_cache_np(want), "cpu")
        assert isinstance(got, KVCache)
        _assert_same_cache(got, want)
    with pytest.raises(KeyError, match="missing"):
        convert.kv_cache_from_numpy({"k": np.zeros(1)}, "cpu")
    with pytest.raises(KeyError, match="unknown"):
        convert.kv_cache_from_numpy({**_cache_np(want), "scale": None}, "cpu")


# ---------------------------------------------------------------- the cache branch
def _jax_params(dtype, seed=0):
    import jax

    from repro.layers.attention import attention_init as jinit

    return jinit(jax.random.PRNGKey(seed), E, H, KV, D, False, dtype)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window,capacity", [(None, 24), (16, 16)], ids=["full", "ring"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_apply_cache_branch_matches_reference(dtype, window, capacity, quantized,
                                                        use_pallas):
    """A prefill of 16 tokens, then single-token decode steps (the ring
    wraps), through ``attention_apply(cache=...)`` on both sides; the cache
    branch takes precedence over ``use_pallas`` on both."""
    import jax.numpy as jnp

    from repro.layers.attention import KVCache as JCache
    from repro.layers.attention import attention_apply as japply

    B, P, steps = 2, 16, 5
    p = _jax_params(dtype)
    params = convert.attention_params_from_numpy({k: np.asarray(v) for k, v in p.items()},
                                                 "cpu")
    x = jnp.asarray(np.random.default_rng(1).standard_normal((B, P + steps, E))
                    .astype(np.float32)).astype(dtype)
    tx = convert.from_numpy(np.asarray(x), "cpu")
    jcache = JCache.init(B, KV, capacity, D, jnp.dtype(dtype), quantized=quantized)
    cache = KVCache.init(B, KV, capacity, D, getattr(torch, dtype), quantized=quantized,
                         device="cpu")
    kw = dict(n_heads=H, n_kv=KV, head_dim=D, window=window, use_pallas=use_pallas, chunk=8)
    tol = TOL[dtype] if not quantized else 3e-2
    for lo, hi in [(0, P)] + [(P + i, P + i + 1) for i in range(steps)]:
        pos = np.tile(np.arange(lo, hi, dtype=np.int32), (B, 1))
        want, jcache = japply(p, x[:, lo:hi], positions=_jnp(pos), cache=jcache, **kw)
        got, cache = attention_apply(params, tx[:, lo:hi], positions=torch.from_numpy(pos),
                                     cache=cache, **kw)
        assert got.dtype == tx.dtype and got.shape == (B, hi - lo, E)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, err_msg=f"tokens {lo}:{hi}")
        np.testing.assert_array_equal(cache.positions.numpy(), np.asarray(jcache.positions))
        np.testing.assert_array_equal(cache.cursor.numpy(), np.asarray(jcache.cursor))


def test_kv_cache_decode_equals_full_attention():
    """``tests/test_attention_and_moe.py``'s check on the port: a prefill into
    the cache and one decode token equal full causal attention."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, Hh, S, Dd = 1, 2, 17, 16
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((B, Hh, S, Dd), generator=gen) for _ in range(3))
    full = attention_ref(q, k, v, True)
    cache = KVCache.init(B, Hh, 32, Dd, torch.float32, device="cpu")
    cache = cache.append(k[:, :, :S - 1], v[:, :, :S - 1], torch.arange(S - 1)[None])
    cache = cache.append(k[:, :, S - 1:], v[:, :, S - 1:],
                         torch.tensor([[S - 1]], dtype=torch.int32))
    out = chunked_attention(q[:, :, -1:], cache.k, cache.v, causal=True,
                            q_positions=torch.tensor([[S - 1]]), k_positions=cache.positions,
                            chunk=16)
    np.testing.assert_allclose(out[0, :, 0].numpy(), full[0, :, -1].numpy(), atol=2e-3)


def test_ring_cache_wraparound_matches_window():
    """``tests/test_attention_and_moe.py``'s check on the port: a ring cache
    of size W behaves as exact sliding-window attention once it wraps."""
    B, Hh, Dd, W, S = 1, 1, 8, 8, 20
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((B, Hh, S, Dd), generator=gen) for _ in range(3))
    cache = KVCache.init(B, Hh, W, Dd, torch.float32, device="cpu")
    outs = []
    for t in range(S):
        cache = cache.append(k[:, :, t:t + 1], v[:, :, t:t + 1],
                             torch.tensor([[t]], dtype=torch.int32))
        outs.append(chunked_attention(q[:, :, t:t + 1], cache.k, cache.v, causal=True,
                                      window=W, q_positions=torch.tensor([[t]]),
                                      k_positions=cache.positions, chunk=8))
    ref = chunked_attention(q, k, v, causal=True, window=W, chunk=8)
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(), ref.numpy(), atol=2e-3)


def test_quantized_cache_stays_within_its_row_bound():
    """The int8 cache's prefill and decode against the bf16 cache's, within
    the bound the smoke holds them to on the card
    (``chip_smoke.int8_row_rel_bound``: the bf16 row bound plus twice the
    worst relative RMS of int8 rounding, sqrt(D) / (127 sqrt(12)))."""
    import chip_smoke
    from repro_torch.kernels.flash_attention.ref import row_rel_err

    assert chip_smoke.int8_row_rel_bound(64) == pytest.approx(
        2e-2 + 2 * 8 / (127 * math.sqrt(12)))
    gen = torch.Generator().manual_seed(8)
    from repro_torch.layers.attention import attention_init

    params = attention_init(E, H, KV, D, generator=gen, device="cpu")
    x = torch.randn((2, 40, E), generator=gen).to(torch.bfloat16)
    outs = {}
    for quantized in (False, True):
        cache = KVCache.init(2, KV, 40, D, quantized=quantized, device="cpu")
        o1, cache = attention_apply(params, x[:, :32], n_heads=H, n_kv=KV, head_dim=D,
                                    cache=cache)
        steps = [o1]
        for t in range(32, 40):
            pos = torch.full((2, 1), t, dtype=torch.int32)
            o, cache = attention_apply(params, x[:, t:t + 1], n_heads=H, n_kv=KV, head_dim=D,
                                       positions=pos, cache=cache)
            steps.append(o)
        outs[quantized] = torch.cat(steps, dim=1)
    rel = row_rel_err(outs[True], outs[False])
    assert 0 < rel < chip_smoke.int8_row_rel_bound(D)


def test_cache_branch_takes_precedence_over_the_flash_path(monkeypatch):
    """With a cache, a 128-token prefill and ``use_pallas=True`` still run
    ``chunked_attention`` over the cache, as in the reference."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.layers.attention import attention_init

    def refuse(*args, **kwargs):
        raise AssertionError("the flash path ran with a cache")

    monkeypatch.setattr(ops, "flash_attention", refuse)
    gen = torch.Generator().manual_seed(4)
    params = attention_init(E, H, KV, D, generator=gen, device="cpu")
    x = torch.randn((1, 128, E), generator=gen).to(torch.bfloat16)
    want, _ = attention_apply(params, x, n_heads=H, n_kv=KV, head_dim=D)
    cache = KVCache.init(1, KV, 128, D, device="cpu")
    got, new = attention_apply(params, x, n_heads=H, n_kv=KV, head_dim=D, use_pallas=True,
                               cache=cache)
    assert new is cache and int(cache.cursor[0]) == 128
    torch.testing.assert_close(got, want, rtol=0, atol=0)
