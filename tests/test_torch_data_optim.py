"""The port's data pipeline (``repro_torch.data.pipeline``) and AdamW
(``repro_torch.optim.adamw``) against the JAX package's, and the
reference's own checks of them (``tests/test_data_optim_sharding.py:13-64``)
run on the port.

Batches are equal array for array (both seed numpy's generator with
``SeedSequence([seed, step, host])``).  ``apply_updates`` runs on the same
numpy parameters (fp32 and bf16 leaves), gradients and moments on both
sides, three steps in a row: the fp32 results (moments, fp32 parameters,
the gradient norm, the learning rate) within 1e-6 relative of the
reference's, of each value or of its leaf's largest where a value nears
zero (the two frameworks evaluate ``pow``, ``cos`` and the norm's sum in
their own ways); the error feedback within two ulps of g + e (XLA fuses
g + e - q·scale into one FMA); the bf16 parameters within one bf16 step
(2^-7 of the value: an fp32 update a few ulps apart may round to the
neighbouring bf16 value); ``compress_int8``'s int8 levels equal, rounding
half to even on both sides.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch.data.pipeline import DataConfig, ShardedBatchIterator, batch_for_step  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    OptConfig,
    OptState,
    apply_updates,
    compress_int8,
    init_opt_state,
    lr_at,
)

FP32_REL = 1e-6
BF16_STEP = 2.0 ** -7


@pytest.mark.parametrize("step,host,n_hosts", [(0, 0, 1), (3, 0, 2), (3, 1, 2), (17, 3, 4)])
@pytest.mark.parametrize("frontend", [False, True])
def test_batches_equal_reference(step, host, n_hosts, frontend):
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import batch_for_step as jbatch_for_step

    kw = dict(vocab=1000, seq_len=16, global_batch=8, seed=5,
              frontend_tokens=6 if frontend else 0, frontend_dim=4 if frontend else 0)
    got = batch_for_step(DataConfig(**kw), step, host, n_hosts)
    want = jbatch_for_step(JDataConfig(**kw), step, host, n_hosts)
    assert sorted(got) == sorted(want) == sorted(["tokens", "labels"]
                                                + (["frontend"] if frontend else []))
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="divide"):
        batch_for_step(DataConfig(**kw), step, 0, 3)


def test_prefetch_iterator_yields_the_reference_batches_from_its_start_and_stops():
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import batch_for_step as jbatch_for_step

    kw = dict(vocab=100, seq_len=8, global_batch=4, frontend_tokens=2, frontend_dim=3)
    before = threading.active_count()
    it = ShardedBatchIterator(DataConfig(**kw), host=1, n_hosts=2, start_step=5, prefetch=2)
    try:
        for want_step in range(5, 9):
            step, batch = next(it)
            assert step == want_step and it.step == step + 1
            want = jbatch_for_step(JDataConfig(**kw), step, 1, 2)
            for k in want:
                np.testing.assert_array_equal(batch[k], want[k])
    finally:
        it.close()
    assert not it._thread.is_alive()
    assert threading.active_count() == before


# the reference's own checks (tests/test_data_optim_sharding.py:13-64) on the port
def test_data_determinism_and_host_sharding():
    dc = DataConfig(vocab=1000, seq_len=16, global_batch=8)
    a = batch_for_step(dc, 3, host=0, n_hosts=2)
    b = batch_for_step(dc, 3, host=0, n_hosts=2)
    c = batch_for_step(dc, 3, host=1, n_hosts=2)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (4, 16)
    assert (a["tokens"] < 1000).all()
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_prefetch_iterator():
    dc = DataConfig(vocab=100, seq_len=8, global_batch=2)
    it = ShardedBatchIterator(dc, prefetch=2)
    s0, b0 = next(it)
    s1, b1 = next(it)
    assert (s0, s1) == (0, 1)
    ref = batch_for_step(dc, 0)
    np.testing.assert_array_equal(b0["tokens"], ref["tokens"])
    it.close()


def test_adamw_reduces_quadratic():
    cfg = OptConfig(lr=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_opt_state(cfg, params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, info = apply_updates(cfg, state, params, grads)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_compression_error_feedback():
    cfg = OptConfig(lr=0.05, warmup_steps=1, total_steps=200,
                    weight_decay=0.0, compress_grads=True)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = init_opt_state(cfg, params)
    for _ in range(120):
        grads = {"w": 2 * params["w"]}
        params, state, _ = apply_updates(cfg, state, params, grads)
    assert float(params["w"].abs().max()) < 0.5


def test_lr_schedule():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(lr_at(cfg, 0)) == 0.0
    assert float(lr_at(cfg, 10)) == pytest.approx(1.0)
    assert float(lr_at(cfg, 100)) == pytest.approx(0.1, rel=0.01)


@pytest.mark.parametrize("cfg", [dict(lr=3e-4, warmup_steps=100, total_steps=10000),
                                 dict(lr=1e-3, warmup_steps=20, total_steps=50),
                                 dict(lr=1.0, warmup_steps=0, total_steps=1)])
def test_lr_at_matches_reference(cfg):
    """At steps 0-120 and at ``total_steps``, as ints and as the int32
    tensors ``apply_updates`` passes."""
    import jax.numpy as jnp

    from repro.optim.adamw import OptConfig as JOptConfig
    from repro.optim.adamw import lr_at as jlr_at

    steps = list(range(121)) + [cfg["total_steps"]]
    want = np.array([float(jlr_at(JOptConfig(**cfg), jnp.asarray(s, jnp.int32)))
                     for s in steps])
    got = np.array([float(lr_at(OptConfig(**cfg), torch.tensor(s, dtype=torch.int32)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=FP32_REL, atol=0)
    np.testing.assert_allclose([float(lr_at(OptConfig(**cfg), s)) for s in steps], want,
                               rtol=FP32_REL, atol=0)
    assert lr_at(OptConfig(**cfg), torch.tensor(3, dtype=torch.int32)).dtype == torch.float32


def _tree(rng):
    """Parameters (fp32 and bf16 leaves, nested as a model's) as numpy
    float32 values, and which leaves are bf16."""
    shapes = {"embed": (12, 8), "layers": {"w": (2, 8, 16), "scale": (2, 8)}, "lm_head": (8, 12)}
    bf16 = {"embed", "w"}

    def make(d):
        return {k: make(v) if isinstance(v, dict) else
                rng.normal(0, 0.05, v).astype(np.float32) for k, v in d.items()}

    return make(shapes), bf16


def _map(fn, tree, *rest, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (k,)) for k, v in tree.items()}
    return fn(path, tree, *rest)


@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_matches_reference(compress):
    """Three steps on the same numpy gradients, from nonzero moments at step
    5: parameters, moments, error feedback, gradient norm and learning rate
    after each; the parameters and moments written in place."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from repro.optim.adamw import OptConfig as JOptConfig
    from repro.optim.adamw import OptState as JOptState
    from repro.optim.adamw import apply_updates as japply

    rng = np.random.default_rng(11)
    vals, bf16 = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=0.5,
              compress_grads=compress)
    jparams = _map(lambda p, a: jnp.asarray(a, jnp.bfloat16 if p[-1] in bf16 else jnp.float32),
                   vals)
    tparams = _map(lambda p, a: torch.from_numpy(np.array(_at(jparams, p), np.float32))
                   .to(torch.bfloat16 if p[-1] in bf16 else torch.float32), vals)
    m = _map(lambda p, a: rng.normal(0, 1e-2, a.shape).astype(np.float32), vals)
    v = _map(lambda p, a: np.square(1e-2 + np.abs(rng.normal(0, 1e-2, a.shape)))
             .astype(np.float32), vals)
    e = _map(lambda p, a: rng.normal(0, 1e-3, a.shape).astype(np.float32), vals)
    jstate = JOptState(jnp.asarray(5, jnp.int32), jax.tree.map(jnp.asarray, m),
                       jax.tree.map(jnp.asarray, v),
                       jax.tree.map(jnp.asarray, e) if compress else None)
    tstate = OptState(torch.tensor(5, dtype=torch.int32),
                      _map(lambda p, a: torch.from_numpy(a.copy()), m),
                      _map(lambda p, a: torch.from_numpy(a.copy()), v),
                      _map(lambda p, a: torch.from_numpy(a.copy()), e) if compress else None)
    ptrs = [t.data_ptr() for t in _leaves(tparams) + _leaves(tstate.m) + _leaves(tstate.v)]
    jstep = jax.jit(lambda s, p, g: japply(JOptConfig(**kw), s, p, g))
    for k in range(3):
        g = _map(lambda p, a: rng.normal(0, 1.0 + k, a.shape).astype(np.float32), vals)
        jgrads = _map(lambda p, a: jnp.asarray(a, jnp.bfloat16 if p[-1] in bf16 else jnp.float32),
                      g)
        tgrads = _map(lambda p, a: torch.from_numpy(np.array(_at(jgrads, p), np.float32))
                      .to(torch.bfloat16 if p[-1] in bf16 else torch.float32), g)
        grads_before = [t.clone() for t in _leaves(tgrads)]
        # the error feedback g + e - q·scale: XLA fuses it into one FMA where
        # torch rounds the product first, so it is held to two ulps of g + e
        err_atol = {}
        for path, t in _items(tgrads):
            top = float(t.float().abs().max())
            if compress:
                top += float(_at(tstate.error, path).abs().max())
            err_atol[path] = 2 * float(np.spacing(np.float32(top)))
        jparams, jstate, jinfo = jstep(jstate, jparams, jgrads)
        out, tstate, info = apply_updates(OptConfig(**kw), tstate, tparams, tgrads)
        assert out is tparams
        assert all(torch.equal(a, b) for a, b in zip(grads_before, _leaves(tgrads)))
        assert int(tstate.step) == int(jstate.step) == 6 + k
        assert float(info["grad_norm"]) == pytest.approx(float(jinfo["grad_norm"]), rel=FP32_REL)
        assert float(info["lr"]) == pytest.approx(float(jinfo["lr"]), rel=FP32_REL)
        for path, t in _items(tparams):
            want = np.asarray(_at(jparams, path), np.float32)
            if path[-1] in bf16:
                assert t.dtype == torch.bfloat16
                assert _at(jparams, path).dtype == ml_dtypes.bfloat16
                np.testing.assert_allclose(t.float().numpy(), want, rtol=BF16_STEP, atol=0)
            else:
                _close(t.numpy(), want)
        trees = [(tstate.m, jstate.m), (tstate.v, jstate.v)]
        if compress:
            trees.append((tstate.error, jstate.error))
        else:
            assert tstate.error is None and jstate.error is None
        for n, (tt, jt) in enumerate(trees):
            for path, t in _items(tt):
                want = np.asarray(_at(jt, path))
                if n == 2:
                    np.testing.assert_allclose(t.numpy(), want, rtol=FP32_REL, atol=err_atol[path])
                else:
                    _close(t.numpy(), want)
    assert ptrs == [t.data_ptr() for t in
                    _leaves(tparams) + _leaves(tstate.m) + _leaves(tstate.v)]


def _close(got, want):
    """Within ``FP32_REL`` of each value, or of the leaf's largest where a
    value is near zero (a parameter after an update cancelling most of it,
    a moment changing sign)."""
    np.testing.assert_allclose(got, want, rtol=FP32_REL,
                               atol=FP32_REL * float(np.abs(want).max()))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _items(tree, path=()):
    if isinstance(tree, dict):
        return [it for k in sorted(tree) for it in _items(tree[k], path + (k,))]
    return [(path, tree)]


def _leaves(tree):
    return [t for _, t in _items(tree)]


def test_compress_int8_matches_reference_and_rounds_half_to_even():
    """The int8 levels, the dequantized gradient and the carried error
    equal the reference's; levels at exactly half a step round to the even
    one (scale 1: the largest magnitude is 127)."""
    import jax.numpy as jnp

    from repro.optim.adamw import compress_int8 as jcompress

    rng = np.random.default_rng(3)
    cases = [
        (np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5], np.float32),
         np.zeros(7, np.float32)),
        (rng.normal(0, 1, (64, 33)).astype(np.float32),
         rng.normal(0, 0.01, (64, 33)).astype(np.float32)),
    ]
    for g, e in cases:
        jdeq, jerr = jcompress(jnp.asarray(g), jnp.asarray(e))
        deq, err = compress_int8(torch.from_numpy(g), torch.from_numpy(e))
        _, q, scale, _ = adamw._compress(torch.from_numpy(g), torch.from_numpy(e))
        assert q.dtype == torch.int8
        jscale = float(np.abs(g + e).max()) / 127.0
        jlevels = np.rint(np.asarray(jdeq, np.float64) / np.float32(jscale))
        np.testing.assert_array_equal(q.numpy(), jlevels)
        np.testing.assert_allclose(deq.numpy(), np.asarray(jdeq), rtol=FP32_REL, atol=0)
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=FP32_REL, atol=1e-7)
    q0 = adamw._compress(torch.from_numpy(cases[0][0]), torch.from_numpy(cases[0][1]))[1]
    assert q0.tolist() == [127, 0, 2, 2, 0, -4, 126]


def test_init_opt_state_fields():
    params = {"a": torch.zeros(3, 2, dtype=torch.bfloat16), "b": {"c": torch.zeros(4)}}
    st = init_opt_state(OptConfig(), params)
    assert st._fields == ("step", "m", "v", "error")
    assert st.step.dtype == torch.int32 and st.step.dim() == 0 and int(st.step) == 0
    assert st.error is None
    for tree in (st.m, st.v):
        assert tree["a"].dtype == torch.float32 and tree["a"].shape == (3, 2)
        assert tree["b"]["c"].dtype == torch.float32 and not tree["b"]["c"].any()
    st = init_opt_state(OptConfig(compress_grads=True), params)
    assert st.error["a"].dtype == torch.float32 and st.error["a"].shape == (3, 2)
