"""The port's Mamba2 and RWKV6 blocks against the JAX package's.

Weights come from the reference's ``*_init`` and are carried across by
``convert.layer_params_from_numpy`` (bf16 included), states by
``convert.mamba2_state_from_numpy`` / ``rwkv6_state_from_numpy``; inputs are
made with numpy from a seed.  Sizes are small (d_model 32 or 64, head_dim
16, d_state 8), and the chunk is small too so that several chunks and a
padded tail run.  Tolerances: fp32 2e-5 on the outputs and states (the two
frameworks sum in different orders), bf16 3e-2.  The reference's own checks
(``tests/test_ssm_numerics.py``: each chunked form against its exact
recurrence, the state carried across calls) run on the port at their
tolerances, 2e-4 (RWKV6) and 3e-4 (Mamba2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.layers import shapes
from repro_torch.layers.ssm import (
    LOG_DECAY_FLOOR,
    Mamba2State,
    RWKV6State,
    mamba2_apply,
    mamba2_init,
    rwkv6_apply,
    rwkv6_channel_mix,
    rwkv6_channel_mix_init,
    rwkv6_init,
)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
M_E, M_N, M_P = 32, 8, 16       # Mamba2: d_model, d_state, head_dim
R_E, R_P, R_F = 64, 16, 96      # RWKV6: d_model, head_dim, channel-mix d_ff


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _x(shape, dtype, seed, scale=0.3):
    import jax.numpy as jnp

    x = jnp.asarray((np.random.default_rng(seed).standard_normal(shape) * scale)
                    .astype(np.float32)).astype(dtype)
    return x, convert.from_numpy(np.asarray(x), "cpu")


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _state_np(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


# (S, with a state): chunked from nothing with a padded tail; chunked from a
# carried state; one token from a state (the exact recurrence)
CASES = [(21, False), (16, True), (1, True)]


@pytest.mark.parametrize("S,stateful", CASES, ids=["chunked", "chunked-state", "step"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_matches_reference(dtype, S, stateful):
    import jax

    from repro.layers import ssm as jssm

    p = jssm.mamba2_init(jax.random.PRNGKey(0), M_E, d_state=M_N, head_dim=M_P, dtype=dtype)
    params = convert.layer_params_from_numpy("mamba2", _np(p), "cpu")
    kw = dict(d_state=M_N, head_dim=M_P, chunk=8)
    jstate = state = None
    if stateful:  # a state from a first call on both sides, carried across
        jx0, _ = _x((2, 11, M_E), dtype, seed=5)
        _, jstate = jssm.mamba2_apply(p, jx0, None, **kw)
        state = convert.mamba2_state_from_numpy(_state_np(jstate), "cpu")
    jx, tx = _x((2, S, M_E), dtype, seed=S)
    want, jnew = jssm.mamba2_apply(p, jx, jstate, **kw)
    got, new = mamba2_apply(params, tx, state, **kw)
    assert isinstance(new, Mamba2State) and got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, TOL[dtype], "y")
    _close(new.ssm, jnew.ssm, TOL[dtype], "ssm state")
    _close(new.conv, jnew.conv, TOL[dtype], "conv state")
    assert new.ssm.dtype == torch.float32


@pytest.mark.parametrize("S,stateful", CASES, ids=["chunked", "chunked-state", "step"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_matches_reference(dtype, S, stateful):
    import jax

    from repro.layers import ssm as jssm

    p = jssm.rwkv6_init(jax.random.PRNGKey(1), R_E, head_dim=R_P, dtype=dtype)
    params = convert.layer_params_from_numpy("rwkv6", _np(p), "cpu")
    kw = dict(head_dim=R_P, chunk=8)
    jstate = state = None
    if stateful:
        jx0, _ = _x((2, 13, R_E), dtype, seed=6)
        _, jstate = jssm.rwkv6_apply(p, jx0, None, **kw)
        state = convert.rwkv6_state_from_numpy(_state_np(jstate), "cpu")
    jx, tx = _x((2, S, R_E), dtype, seed=S + 1)
    want, jnew = jssm.rwkv6_apply(p, jx, jstate, **kw)
    got, new = rwkv6_apply(params, tx, state, **kw)
    assert isinstance(new, RWKV6State) and got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, TOL[dtype], "y")
    _close(new.wkv, jnew.wkv, TOL[dtype], "wkv state")
    _close(new.prev, jnew.prev, 0.0, "token shift")


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_channel_mix_matches_reference(dtype, with_prev):
    import jax

    from repro.layers import ssm as jssm

    p = jssm.rwkv6_channel_mix_init(jax.random.PRNGKey(2), R_E, R_F, dtype)
    params = convert.layer_params_from_numpy("rwkv6_channel_mix", _np(p), "cpu")
    jx, tx = _x((2, 9, R_E), dtype, seed=3, scale=1.0)
    jprev, tprev = _x((2, R_E), dtype, seed=4, scale=1.0) if with_prev else (None, None)
    want, jlast = jssm.rwkv6_channel_mix(p, jx, jprev)
    got, last = rwkv6_channel_mix(params, tx, tprev)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, TOL[dtype])
    _close(last, jlast, 0.0)


def test_rwkv6_chunked_matches_recurrence():
    """``tests/test_ssm_numerics.py``'s check on the port: the chunked form
    equals the exact per-token recurrence, outputs and final state."""
    B, S, E, hd = 1, 70, 64, 16
    gen = torch.Generator().manual_seed(0)
    p = rwkv6_init(E, head_dim=hd, dtype=torch.float32, generator=gen, device="cpu")
    x = torch.randn((B, S, E), generator=gen) * 0.3
    y_chunked, st = rwkv6_apply(p, x, None, head_dim=hd, chunk=16)
    state = RWKV6State(torch.zeros((B, E // hd, hd, hd)), torch.zeros((B, E)))
    outs = []
    for t in range(S):
        yt, state = rwkv6_apply(p, x[:, t:t + 1], state, head_dim=hd)
        outs.append(yt)
    np.testing.assert_allclose(y_chunked.numpy(), torch.cat(outs, 1).numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(st.wkv.numpy(), state.wkv.numpy(), rtol=2e-4, atol=2e-4)


def test_mamba2_chunked_matches_recurrence():
    """``tests/test_ssm_numerics.py``'s check on the port."""
    B, S, E = 1, 40, 32
    gen = torch.Generator().manual_seed(0)
    p = mamba2_init(E, d_state=8, head_dim=16, dtype=torch.float32, generator=gen,
                    device="cpu")
    x = torch.randn((B, S, E), generator=gen) * 0.3
    y_chunked, st = mamba2_apply(p, x, None, d_state=8, head_dim=16, chunk=8)
    state = Mamba2State(torch.zeros((B, 2 * E // 16, 16, 8)), torch.zeros((B, 3, 2 * E)))
    outs = []
    for t in range(S):
        yt, state = mamba2_apply(p, x[:, t:t + 1], state, d_state=8, head_dim=16)
        outs.append(yt)
    np.testing.assert_allclose(y_chunked.numpy(), torch.cat(outs, 1).numpy(), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(st.ssm.numpy(), state.ssm.numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("block", ["mamba2", "rwkv6"])
def test_state_carries_across_calls(block):
    """``tests/test_ssm_numerics.py::test_mamba2_state_carry_across_calls``
    on the port, and the same for RWKV6: [x1; x2] in one call equals x1 then
    x2 with the carried state."""
    B, E = 2, 32
    gen = torch.Generator().manual_seed(3)
    if block == "mamba2":
        p = mamba2_init(E, d_state=8, head_dim=16, dtype=torch.float32, generator=gen,
                        device="cpu")

        def apply(x, s):
            return mamba2_apply(p, x, s, d_state=8, head_dim=16, chunk=8)
    else:
        p = rwkv6_init(E, head_dim=16, dtype=torch.float32, generator=gen, device="cpu")

        def apply(x, s):
            return rwkv6_apply(p, x, s, head_dim=16, chunk=8)
    x = torch.randn((B, 24, E), generator=gen)
    y_full, _ = apply(x, None)
    y1, st = apply(x[:, :8], None)
    y2, _ = apply(x[:, 8:], st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), rtol=3e-4,
                               atol=3e-4)


def test_rwkv6_log_decay_floor_bounds_the_factorisation():
    """Every step's log decay is at least the floor, so exp(-lc) over a
    chunk of ``RWKV_CHUNK`` stays below exp(11.2) in fp32 (DESIGN §7)."""
    from repro.layers.ssm import LOG_DECAY_FLOOR as JFLOOR

    assert LOG_DECAY_FLOOR == JFLOOR == -0.35
    assert np.exp(-LOG_DECAY_FLOOR * shapes.RWKV_CHUNK) < np.finfo(np.float32).max ** 0.25
    gen = torch.Generator().manual_seed(1)
    p = rwkv6_init(R_E, head_dim=R_P, dtype=torch.float32, generator=gen, device="cpu")
    p["decay_base"] = torch.full_like(p["decay_base"], 3.0)  # decays far below the floor
    x = torch.randn((1, 2 * shapes.RWKV_CHUNK, R_E), generator=gen)
    y, st = rwkv6_apply(p, x, None, head_dim=R_P)
    assert torch.isfinite(y).all() and torch.isfinite(st.wkv).all()


INITS = {
    "mamba2": (lambda g: mamba2_init(M_E, M_N, M_P, generator=g, device="cpu"),
               lambda k, m: m.mamba2_init(k, M_E, M_N, M_P)),
    "rwkv6": (lambda g: rwkv6_init(R_E, R_P, generator=g, device="cpu"),
              lambda k, m: m.rwkv6_init(k, R_E, R_P)),
    "rwkv6_channel_mix": (lambda g: rwkv6_channel_mix_init(R_E, R_F, generator=g, device="cpu"),
                          lambda k, m: m.rwkv6_channel_mix_init(k, R_E, R_F)),
}


@pytest.mark.parametrize("kind", sorted(INITS))
def test_inits_match_reference_shapes_and_dtypes(kind):
    import jax

    from repro.layers import ssm as jssm

    port, ref = INITS[kind]
    p = port(torch.Generator().manual_seed(0))
    want = _np(ref(jax.random.PRNGKey(0), jssm))
    assert set(p) == set(want) == set(convert.LAYER_PARAMS[kind])
    for k, v in want.items():
        assert tuple(p[k].shape) == v.shape and str(p[k].dtype).split(".")[1] == str(v.dtype), k
        if v.std() == 0:
            assert torch.equal(p[k].float(), torch.from_numpy(v.astype(np.float32))), k
    again = port(torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_init_dims_follow_the_shapes_helpers():
    p = mamba2_init(M_E, M_N, M_P, generator=torch.Generator().manual_seed(0), device="cpu")
    dims = shapes.mamba2_dims(M_E, M_N, M_P)
    assert tuple(p["w_in"].shape) == (M_E, dims["d_in_proj"])
    assert tuple(p["A_log"].shape) == (dims["n_heads"],)
    r = rwkv6_init(R_E, R_P, generator=torch.Generator().manual_seed(0), device="cpu")
    assert tuple(r["bonus_u"].shape) == (shapes.rwkv6_dims(R_E, R_P)["n_heads"], R_P)


@pytest.mark.parametrize("convert_state,fields", [
    (convert.mamba2_state_from_numpy, ("ssm", "conv")),
    (convert.rwkv6_state_from_numpy, ("wkv", "prev"))])
def test_state_from_numpy_carries_bf16_and_refuses_bad_keys(convert_state, fields):
    import jax.numpy as jnp

    a = np.asarray(jnp.asarray(np.linspace(-2, 2, 12, dtype=np.float32)).astype(jnp.bfloat16))
    st = convert_state({fields[0]: np.zeros((2, 3), np.float32), fields[1]: a}, "cpu")
    assert getattr(st, fields[0]).dtype == torch.float32
    got = getattr(st, fields[1])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  a.view(np.uint16))
    with pytest.raises(KeyError, match="missing"):
        convert_state({fields[0]: a}, "cpu")
    with pytest.raises(KeyError, match="unknown"):
        convert_state({fields[0]: a, fields[1]: a, "h": a}, "cpu")


@pytest.mark.parametrize("init", [
    lambda **kw: mamba2_init(16, 8, 16, generator=torch.Generator().manual_seed(0), **kw),
    lambda **kw: rwkv6_init(32, 16, generator=torch.Generator().manual_seed(0), **kw),
    lambda **kw: rwkv6_channel_mix_init(32, 48, generator=torch.Generator().manual_seed(0),
                                        **kw)])
def test_inits_run_on_the_card_unless_asked_for_the_cpu(monkeypatch, init):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init()
    assert all(t.device.type == "cpu" for t in init(device="cpu").values())
