"""The port's norms, MLPs and MoE against the JAX package's.

Weights come from the reference's ``*_init`` and are carried across by
``convert.layer_params_from_numpy`` (bf16 included); inputs are made with
numpy from a seed.  Sizes are small (d_model 64, d_ff 96, 4 experts).
Tolerances: fp32 2e-5, as ``tests/test_torch_attention.py`` (the two
frameworks sum in different orders); bf16 3e-2 (the products round to bf16
at slightly different places).  MoE's routing (each pair's expert, slot and
whether it is kept) must be identical before outputs are compared, so that
a mismatch reads as routing, not arithmetic.  The reference's own checks
(``tests/test_layers_misc.py``, ``tests/test_attention_and_moe.py``) run on
the port with their tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.layers import shapes
from repro_torch.layers.mlp import gelu_mlp, gelu_mlp_init, swiglu, swiglu_init
from repro_torch.layers.moe import moe_apply, moe_init, moe_route
from repro_torch.layers.norms import layernorm, layernorm_init, rmsnorm, rmsnorm_init

E, F, X = 64, 96, 4
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _x(shape, dtype, seed=1, scale=1.0):
    """(numpy input in ``dtype`` for the reference, the same values as a
    port tensor)."""
    import jax.numpy as jnp

    x = jnp.asarray((np.random.default_rng(seed).standard_normal(shape) * scale)
                    .astype(np.float32)).astype(dtype)
    return x, convert.from_numpy(np.asarray(x), "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------- norms
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind, dtype):
    import jax.numpy as jnp

    from repro.layers import norms as jnorms

    rng = np.random.default_rng(7)
    p = {"scale": (1 + 0.3 * rng.standard_normal(E)).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = (0.2 * rng.standard_normal(E)).astype(np.float32)
    jx, tx = _x((2, 5, E), dtype, scale=3.0)
    want = getattr(jnorms, kind)({k: jnp.asarray(v) for k, v in p.items()}, jx)
    got = {"rmsnorm": rmsnorm, "layernorm": layernorm}[kind](
        convert.layer_params_from_numpy(kind, p, "cpu"), tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, TOL[dtype])


def test_norms_reference_check():
    """``tests/test_layers_misc.py::test_norms_match_reference`` on the port."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, E)).astype(np.float32))
    got = rmsnorm(rmsnorm_init(E, device="cpu"), x).numpy()
    xn = x.numpy()
    ref = xn / np.sqrt(np.mean(np.square(xn), -1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    got2 = layernorm(layernorm_init(E, device="cpu"), x).numpy()
    assert abs(got2.mean()) < 1e-5
    np.testing.assert_allclose(got2.std(axis=-1), 1.0, atol=1e-2)


def test_layernorm_takes_the_population_variance():
    """jnp.var divides by n: a row of n = 4 values -1, -1, 1, 1 has variance
    1, not 4/3."""
    x = torch.tensor([[-1.0, -1.0, 1.0, 1.0]])
    got = layernorm(layernorm_init(4, device="cpu"), x, eps=0.0)
    assert torch.equal(got, x)


# ---------------------------------------------------------------- MLPs
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu_mlp"])
def test_mlp_matches_reference(kind, dtype):
    import jax

    from repro.layers import mlp as jmlp

    p = getattr(jmlp, f"{kind}_init")(jax.random.PRNGKey(3), E, F, dtype)
    if kind == "gelu_mlp":  # give the biases values, so that they count
        p = {k: (v + 0.05 if k.startswith("b") else v) for k, v in p.items()}
    jx, tx = _x((2, 7, E), dtype)
    want = getattr(jmlp, kind)(p, jx)
    got = {"swiglu": swiglu, "gelu_mlp": gelu_mlp}[kind](
        convert.layer_params_from_numpy(kind, _np(p), "cpu"), tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, TOL[dtype])


def test_gelu_mlp_uses_the_tanh_approximation():
    """At h = 1 the tanh form and the exact GELU differ by 1.6e-4, eight
    times the fp32 tolerance: the port takes jax.nn.gelu's default."""
    import jax

    p = {"w_up": torch.eye(4), "b_up": torch.zeros(4), "w_down": torch.eye(4),
         "b_down": torch.zeros(4)}
    x = torch.ones((1, 1, 4))
    want = np.asarray(jax.nn.gelu(np.ones(4, np.float32)))
    np.testing.assert_allclose(gelu_mlp(p, x)[0, 0].numpy(), want, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.ones(4))
    assert abs(float(exact[0]) - float(want[0])) > 1e-4


# ---------------------------------------------------------------- MoE
def _jax_routing(p, x, top_k, capacity_factor, groups):
    """The reference's routing, by the lines of ``repro.layers.moe.moe_apply``
    that compute it (it returns only the output)."""
    import jax
    import jax.numpy as jnp

    from repro.layers.moe import _pick_groups

    B, S, Ed = x.shape
    n_exp = p["router"].shape[1]
    G = _pick_groups(B * S, groups)
    ng = B * S // G
    logits = jnp.einsum("gne,ex->gnx", x.reshape(G, ng, Ed).astype(jnp.float32), p["router"])
    gate_vals, exp_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    capacity = max(1, int(ng * top_k * capacity_factor / n_exp))
    flat_exp = exp_idx.transpose(0, 2, 1).reshape(G, top_k * ng)
    pos = jnp.cumsum(jax.nn.one_hot(flat_exp, n_exp, dtype=jnp.int32), axis=1) - 1
    slot = jnp.take_along_axis(pos, flat_exp[..., None], axis=2)[..., 0]
    return G, capacity, np.asarray(exp_idx), np.asarray(slot), np.asarray(slot < capacity)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_matches_reference(top_k, capacity_factor, dtype):
    import jax

    from repro.layers.moe import moe_apply as japply
    from repro.layers.moe import moe_init as jinit

    p = jinit(jax.random.PRNGKey(top_k), E, F, X, dtype)
    jx, tx = _x((2, 16, E), dtype, seed=int(capacity_factor * 4))
    params = convert.layer_params_from_numpy("moe", _np(p), "cpu")
    kw = dict(top_k=top_k, capacity_factor=capacity_factor)
    G, C, exp_idx, slot, keep = _jax_routing(p, jx, top_k, capacity_factor, None)
    r = moe_route(params, tx, **kw)
    assert (r.groups, r.capacity) == (G, C)
    np.testing.assert_array_equal(r.exp_idx.numpy(), exp_idx)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if capacity_factor < 1:
        assert not keep.all()
    want = japply(p, jx, **kw)
    got = moe_apply(params, tx, **kw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("groups", [2, 3])
def test_moe_groups_match_reference(groups):
    """Group-local routing and dispatch: 2 groups of 16 tokens; 3 does not
    divide the 32 tokens and halves to 1, as in the reference."""
    import jax

    from repro.layers.moe import moe_apply as japply
    from repro.layers.moe import moe_init as jinit

    p = jinit(jax.random.PRNGKey(9), E, F, X, "float32")
    jx, tx = _x((2, 16, E), "float32", seed=11)
    params = convert.layer_params_from_numpy("moe", _np(p), "cpu")
    G, C, exp_idx, slot, keep = _jax_routing(p, jx, 2, 1.0, groups)
    r = moe_route(params, tx, top_k=2, capacity_factor=1.0, groups=groups)
    assert (r.groups, r.capacity) == (G, C) and G == {2: 2, 3: 1}[groups]
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    _close(moe_apply(params, tx, top_k=2, capacity_factor=1.0, groups=groups),
           japply(p, jx, top_k=2, capacity_factor=1.0, groups=groups), TOL["float32"])


def _dense_moe(params, x, weights):
    """sum over experts e of weights[..., e] * SwiGLU_e(x), in fp32."""
    out = torch.zeros_like(x, dtype=torch.float32)
    for e in range(params["router"].shape[1]):
        g = torch.nn.functional.silu(x @ params["w_gate"][e])
        o = (g * (x @ params["w_up"][e])) @ params["w_down"][e]
        out += weights[..., e:e + 1] * o
    return out


def test_moe_top1_huge_capacity_equals_dense_oracle():
    """``tests/test_attention_and_moe.py``'s check on the port: top-1 with no
    capacity pressure picks each token's argmax expert."""
    B, S = 2, 8
    gen = torch.Generator().manual_seed(0)
    p = moe_init(16, 32, 4, torch.float32, generator=gen, device="cpu")
    x = torch.randn((B, S, 16), generator=gen)
    out = moe_apply(p, x, top_k=1, capacity_factor=8.0)
    best = torch.einsum("bse,ex->bsx", x, p["router"]).argmax(-1)
    ref = _dense_moe(p, x, torch.nn.functional.one_hot(best, 4).float())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)


def test_moe_capacity_drops_tokens():
    """``tests/test_attention_and_moe.py``'s check on the port: with a
    capacity factor well under 1 some tokens are dropped and come out zero."""
    gen = torch.Generator().manual_seed(2)
    p = moe_init(8, 16, 2, torch.float32, generator=gen, device="cpu")
    x = torch.randn((1, 32, 8), generator=gen)
    out = moe_apply(p, x, top_k=1, capacity_factor=0.25)
    assert int((out == 0).all(dim=-1).sum()) > 0


def test_moe_dropped_pairs_add_nothing():
    """top-2 under capacity pressure equals the dense mixture whose weights
    are each kept pair's gate and 0 for a dropped pair."""
    gen = torch.Generator().manual_seed(5)
    p = moe_init(E, F, X, torch.float32, generator=gen, device="cpu")
    x = torch.randn((2, 16, E), generator=gen)
    r = moe_route(p, x, top_k=2, capacity_factor=0.75)
    assert not r.keep.all()
    w = torch.zeros((1, 32, X))
    kept = r.keep.reshape(1, 2, 32).transpose(1, 2)                   # (G, ng, k)
    w.scatter_add_(2, r.exp_idx, r.gates * kept)
    ref = _dense_moe(p, x, w.reshape(2, 16, X))
    np.testing.assert_allclose(moe_apply(p, x, top_k=2, capacity_factor=0.75).numpy(),
                               ref.numpy(),
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------- inits and carrying
INITS = {
    "swiglu": (lambda g: swiglu_init(E, F, generator=g, device="cpu"), "mlp", "swiglu_init",
               (E, F)),
    "gelu_mlp": (lambda g: gelu_mlp_init(E, F, generator=g, device="cpu"), "mlp",
                 "gelu_mlp_init", (E, F)),
    "moe": (lambda g: moe_init(E, F, X, generator=g, device="cpu"), "moe", "moe_init",
            (E, F, X)),
}


@pytest.mark.parametrize("kind", sorted(INITS))
def test_inits_match_reference_shapes_and_scales(kind):
    import jax

    from repro.layers import mlp as jmlp
    from repro.layers import moe as jmoe

    port, mod, name, args = INITS[kind]
    p = port(torch.Generator().manual_seed(0))
    ref = _np(getattr({"mlp": jmlp, "moe": jmoe}[mod], name)(jax.random.PRNGKey(0), *args))
    assert set(p) == set(ref) == set(convert.LAYER_PARAMS[kind])
    for k, v in ref.items():
        assert tuple(p[k].shape) == v.shape and str(p[k].dtype).split(".")[1] == str(v.dtype)
        if v.std() > 0:
            assert abs(float(p[k].float().std()) / float(v.astype(np.float32).std()) - 1) < 0.3
        else:
            assert torch.equal(p[k], torch.zeros_like(p[k]))
    again = port(torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_moe_shapes_follow_the_init():
    p = moe_init(E, F, X, generator=torch.Generator().manual_seed(0), device="cpu")
    want = shapes.moe_shapes(E, F, X)
    assert tuple(p["router"].shape) == want["router"][0]
    assert tuple(p["w_gate"].shape[1:]) == want["expert_in"][0]
    assert tuple(p["w_down"].shape[1:]) == want["expert_out"][0]


@pytest.mark.parametrize("kind", sorted(convert.LAYER_PARAMS))
def test_layer_params_from_numpy_refuses_unknown_and_missing_keys(kind):
    keys = convert.LAYER_PARAMS[kind]
    p = {k: np.zeros(2, np.float32) for k in keys}
    assert set(convert.layer_params_from_numpy(kind, p, "cpu")) == set(keys)
    with pytest.raises(KeyError, match="unknown"):
        convert.layer_params_from_numpy(kind, {**p, "w_extra": p[keys[0]]}, "cpu")
    with pytest.raises(KeyError, match="missing"):
        convert.layer_params_from_numpy(kind, {k: p[k] for k in keys[1:]}, "cpu")
    with pytest.raises(KeyError, match="unknown layer"):
        convert.layer_params_from_numpy("conv", p, "cpu")


def test_layer_params_from_numpy_carries_bf16_bits():
    import jax

    from repro.layers.moe import moe_init as jinit

    p = _np(jinit(jax.random.PRNGKey(0), E, F, X))
    got = convert.layer_params_from_numpy("moe", p, "cpu")
    assert got["router"].dtype == torch.float32
    for k in ("w_gate", "w_up", "w_down"):
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy().view(np.uint16),
                                      p[k].view(np.uint16))


@pytest.mark.parametrize("init", [
    lambda **kw: rmsnorm_init(8, **kw), lambda **kw: layernorm_init(8, **kw),
    lambda **kw: swiglu_init(8, 16, generator=torch.Generator().manual_seed(0), **kw),
    lambda **kw: gelu_mlp_init(8, 16, generator=torch.Generator().manual_seed(0), **kw),
    lambda **kw: moe_init(8, 16, 2, generator=torch.Generator().manual_seed(0), **kw)])
def test_inits_run_on_the_card_unless_asked_for_the_cpu(monkeypatch, init):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init()
    assert all(t.device.type == "cpu" for t in init(device="cpu").values())
