"""The port's LM (``repro_torch.models.lm``) and its prefill and decode steps
(``repro_torch.train.step``) against the JAX package's.

Weights come from the reference's ``init_params(cfg, PRNGKey(0))`` at the
reduced config of every arch in sorted ``ARCHS`` (as
``tests/test_models_smoke.py:17-19``), carried across by
``convert.lm_params_from_numpy`` (bf16 bit for bit); tokens and frontend
embeddings are made with numpy from a seed.  Logits are held by their rows'
relative L2 error (``row_rel``): fp32 2e-5 (the two frameworks sum in
different orders; a CPU run reads up to 1.7e-6), bf16 4e-2 (the
two sides round their bf16 sums in different places, a step of 2^-8 here
and there through two layers and the bf16 logits; a CPU run reads up to
1.7e-2).
The MoE archs are compared in fp32 only: in bf16 a near-tie in the router
can send a token to another expert on one side (their routing is held
equal at layer level by ``tests/test_torch_layers.py``).

The prefill and decode steps run teacher-forced on both sides (the same
tokens fed, not each side's argmax), with fp32 parameters and the default
bf16 caches: each step's logits within 5e-4 (``CACHED_ROW_REL``: the
attention reads K and V rounded to bf16 on each side), and the caches after
the prefill and after the decode steps carried back: positions and cursors
equal, bit for bit; K and V within one bf16 step (at most 2^-7 of the
value: the two sides' fp32 projections round to bf16 apart where they
straddle a step) plus 5e-4 (an earlier layer's such step, carried on to
values of order 1);
SSM states within 2e-5 (their conv and token-shift inputs at the bf16
step).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import lm
from repro_torch.train import sharding
from repro_torch.train.step import make_decode_step, make_prefill_step

ROW_REL = {"float32": 2e-5, "bfloat16": 4e-2}
# fp32 parameters over bf16 caches: an element of K or V that the two sides
# round to bf16 a step apart (2^-7 of it) moves its logits rows by up to
# about 1e-4 (on the CPU whisper's prefill reads 9.4e-5, the others 1.8e-5)
CACHED_ROW_REL = 5e-4
BF16_STEP = 2.0 ** -7  # one bf16 step, relative to the value: 2^-8 to 2^-7
MOE_ARCHS = {"arctic-480b", "mixtral-8x7b"}
B, S = 2, 16


def row_rel(got, want) -> float:
    """The largest relative L2 error over the rows (last axis), in fp32."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float((np.linalg.norm(g - w, axis=-1)
                  / np.maximum(np.linalg.norm(w, axis=-1), 1e-30)).max())


def assert_rows(got, want, bound, what=""):
    assert np.shape(got) == np.shape(want), what
    assert np.isfinite(np.asarray(got, np.float32)).all(), what
    rel = row_rel(got, want)
    assert rel <= bound, f"{what}: row relative error {rel} > {bound}"


def _np(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the numpy array JAX would hold (bf16 as float32)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).detach().numpy()


@functools.lru_cache(maxsize=None)
def _setup(arch: str, dtype: str = "float32", **changes):
    """(reference cfg, port cfg, reference params, port params)."""
    import jax

    from repro.configs import get_config as jget
    from repro.models.lm import init_params

    jcfg = dataclasses.replace(jget(arch).reduced(), param_dtype=dtype, **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype, **changes)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, p


def _inputs(cfg, seed: int, n: int = S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    frontend = (rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim))
                .astype(np.float32) if cfg.frontend else None)
    return tokens, frontend


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    import jax.numpy as jnp

    return None if a is None else jnp.asarray(a)


FORWARD_CASES = [(a, d) for a in sorted(ARCHS) for d in ("float32", "bfloat16")
                 if d == "float32" or a not in MOE_ARCHS]


@pytest.mark.parametrize("arch,dtype", FORWARD_CASES)
def test_forward_matches_reference(arch, dtype):
    """``forward`` without caches, all positions' logits, and with
    ``last_only``; the encoder's output for whisper."""
    from repro.models.lm import forward as jforward

    jcfg, cfg, jp, p = _setup(arch, dtype)
    tokens, frontend = _inputs(cfg, 1)
    want, _, jenc = jforward(jcfg, jp, _j(tokens), frontend_embeds=_j(frontend))
    got, caches, enc = lm.forward(cfg, p, _t(tokens), frontend_embeds=_t(frontend))
    n = S + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, n, cfg.padded_vocab)
    assert caches is None
    assert_rows(got.numpy(), want, ROW_REL[dtype], "logits")
    last, _, _ = lm.forward(cfg, p, _t(tokens), frontend_embeds=_t(frontend), last_only=True)
    assert tuple(last.shape) == (B, 1, cfg.padded_vocab)
    np.testing.assert_array_equal(last[:, 0].numpy(), got[:, -1].numpy())
    if cfg.enc_layers:
        assert_rows(_np(enc), jenc, ROW_REL[dtype], "encoder_out")
    else:
        assert enc is None and jenc is None


def _kv_np(cache) -> dict:
    return {k: None if v is None else np.asarray(v) for k, v in cache._asdict().items()}


def _assert_caches_match(cfg, got: dict, want: dict, what: str):
    """The port's stacked caches against the reference's: positions and
    cursors equal bit for bit, K and V within one bf16 step, SSM states
    within the fp32 bound."""
    assert set(got) == set(want), what
    for name in got:
        if name in ("kv", "shared_kv"):
            w = _kv_np(want[name])
            for field, t in got[name]._asdict().items():
                if t is None:
                    assert w[field] is None, (what, name, field)
                    continue
                assert str(t.dtype).split(".")[1] == w[field].dtype.name, (what, name, field)
                if field in ("positions", "cursor"):
                    np.testing.assert_array_equal(t.numpy(), w[field], err_msg=f"{what} {field}")
                else:
                    np.testing.assert_allclose(_np(t), np.asarray(w[field], np.float32),
                                               rtol=BF16_STEP, atol=CACHED_ROW_REL,
                                               err_msg=f"{what} {name}.{field}")
        else:
            leaves = (got[name].ssm, got[name].conv) if name == "mamba" else (
                got[name][0].wkv, got[name][0].prev, got[name][1])
            wl = (want[name].ssm, want[name].conv) if name == "mamba" else (
                want[name][0].wkv, want[name][0].prev, want[name][1])
            for t, w in zip(leaves, wl, strict=True):
                assert str(t.dtype).split(".")[1] == np.asarray(w).dtype.name, (what, name)
                np.testing.assert_allclose(_np(t), np.asarray(w, np.float32), rtol=2e-5,
                                           atol=2e-5, err_msg=f"{what} {name}")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_steps_match_reference(arch):
    """``make_prefill_step`` of 12 tokens into caches of 24 slots, then 3
    decode steps teacher-forced on both sides (positions after a vision
    arch's patches), fp32 parameters: logits at every step, and the caches
    carried back after the prefill and after the last step."""
    import jax

    from repro.train.step import make_decode_step as jdecode_step
    from repro.train.step import make_prefill_step as jprefill_step

    jcfg, cfg, jp, p = _setup(arch)
    P, steps, cap = 12, 3, 24
    tokens, frontend = _inputs(cfg, 2, P + steps)
    jprefill, jdecode = jax.jit(jprefill_step(jcfg, cap)), jax.jit(jdecode_step(jcfg))
    prefill, decode = make_prefill_step(cfg, cap), make_decode_step(cfg)

    want, jcaches, jenc = jprefill(jp, _j(tokens[:, :P]), _j(frontend))
    with torch.inference_mode():
        got, caches, enc = prefill(p, _t(tokens[:, :P]), _t(frontend))
    assert tuple(got.shape) == (B, cfg.padded_vocab) and got.dtype == torch.float32
    assert_rows(got.numpy(), want, CACHED_ROW_REL, "prefill logits")
    _assert_caches_match(cfg, caches, jcaches, "after prefill")
    pos0 = P + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    for i in range(steps):
        tok = tokens[:, P + i:P + i + 1]
        pos = np.full((B, 1), pos0 + i, np.int32)
        want, jcaches = jdecode(jp, _j(tok), jcaches, _j(pos), jenc)
        with torch.inference_mode():
            got, caches = decode(p, _t(tok), caches, _t(pos), enc)
        assert tuple(got.shape) == (B, cfg.padded_vocab)
        assert_rows(got.numpy(), want, CACHED_ROW_REL, f"decode step {i}")
    _assert_caches_match(cfg, caches, jcaches, f"after {steps} decode steps")


CACHE_VARIANTS = {"plain": {}, "kv_int8": {"kv_int8": True}, "window": {"swa_window": 16}}


@pytest.mark.parametrize("variant", sorted(CACHE_VARIANTS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_caches_match_reference(arch, variant):
    """``init_caches``' tree against the reference's leaf for leaf: the same
    keys, shapes, dtypes and values (zeros, -1 positions), with the
    sliding-window cap (a window of 16 under a capacity of 40) and the
    int8 cache."""
    import jax

    from repro.configs import get_config as jget
    from repro.models.lm import init_caches as jinit_caches

    changes = CACHE_VARIANTS[variant]
    jcfg = dataclasses.replace(jget(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    want = jinit_caches(jcfg, 3, 40)
    got = lm.init_caches(cfg, 3, 40, device="cpu")
    wl, gl = jax.tree.leaves(want), _leaves(got)
    assert len(gl) == len(wl)
    for t, w in zip(gl, wl, strict=True):
        w = np.asarray(w)
        assert tuple(t.shape) == w.shape and str(t.dtype).split(".")[1] == w.dtype.name
        np.testing.assert_array_equal(_np(t), np.asarray(w, np.float32 if w.dtype.name ==
                                                         "bfloat16" else w.dtype))
    if cfg.block_pattern != "rwkv":
        kv = got["kv" if cfg.block_pattern == "attn" else "shared_kv"]
        assert kv.k.shape[3] == (16 if variant == "window" else 40)
        assert kv.quantized == (variant == "kv_int8")
        assert kv.k.dtype == (torch.int8 if variant == "kv_int8" else torch.bfloat16)


def _leaves(tree) -> list:
    """The tensor leaves of a cache tree in JAX's flattening order (dict
    keys sorted, tuple fields in order, None dropped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def test_init_caches_and_params_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg, generator=torch.Generator())
    p = lm.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(t.device.type == "cpu" for t in _leaves(p))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_tree_matches_reference(arch):
    """The port's own ``init_params`` (a torch generator) gives the
    reference's tree: the same keys, stacked shapes and dtypes, and the
    reference's scales (the draws' RMS within 10 % of it where a leaf has
    4096 draws or more, within 50 % on the smaller ones)."""
    import jax

    from repro.configs import get_config as jget
    from repro.models.lm import init_params as jinit

    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    want = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0)))
    got = lm.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert convert.lm_params_from_numpy(cfg, want, "cpu").keys() == got.keys()
    wl, gl = _leaves(want), _leaves(got)
    assert len(wl) == len(gl)
    for t, w in zip(gl, wl, strict=True):
        assert tuple(t.shape) == w.shape and str(t.dtype).split(".")[1] == w.dtype.name
        ws, gs = float(np.sqrt(np.mean(np.square(w.astype(np.float32))))), float(
            t.float().square().mean().sqrt())
        assert gs == pytest.approx(ws, rel=0.1 if w.size >= 4096 else 0.5, abs=1e-6)


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-1.6b", "zamba2-2.7b", "whisper-base"])
def test_remat_gives_the_same_logits_and_gradients(arch, monkeypatch):
    """``cfg.remat`` under autograd wraps each block (each hybrid group) in
    ``torch.utils.checkpoint``: the logits and the gradients equal those
    without it; without autograd it checkpoints nothing, and with caches
    only the encoder's blocks, which touch no cache."""
    _, cfg, _, p = _setup(arch)
    tokens, frontend = _inputs(cfg, 3, 8)
    calls = []
    real = lm.checkpoint

    def counted(*args, **kwargs):
        calls.append(kwargs.get("use_reentrant"))
        return real(*args, **kwargs)

    monkeypatch.setattr(lm, "checkpoint", counted)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = {"lm_head": p["lm_head"].clone().requires_grad_(True)}
        params = {**p, **leaves}
        logits, _, _ = lm.forward(c, params, _t(tokens), frontend_embeds=_t(frontend))
        logits.square().mean().backward()
        out[remat] = (logits.detach(), leaves["lm_head"].grad)
    groups = cfg.n_layers // cfg.hybrid_attn_every if cfg.block_pattern == "mamba_hybrid" \
        else cfg.n_layers
    assert calls == [False] * (groups + cfg.enc_layers)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    torch.testing.assert_close(out[True][1], out[False][1], rtol=1e-6, atol=1e-7)
    calls.clear()
    with torch.no_grad():
        lm.forward(dataclasses.replace(cfg, remat=True), p, _t(tokens),
                   frontend_embeds=_t(frontend))
    caches = lm.init_caches(cfg, B, 16, device="cpu")
    lm.forward(dataclasses.replace(cfg, remat=True), p, _t(tokens), caches=caches,
               frontend_embeds=_t(frontend))
    assert calls == [False] * cfg.enc_layers


def test_kv_caches_are_written_in_place_and_ssm_states_come_back_new():
    """What a caller may assume: the stacked KV cache passed in is the one
    returned, written through the per-layer views; the SSM states passed in
    are left as they were, and new ones come back."""
    _, cfg, _, p = _setup("zamba2-2.7b")
    tokens, _ = _inputs(cfg, 4, 6)
    caches = lm.init_caches(cfg, B, 16, device="cpu")
    kv_ptr, ssm_before = caches["shared_kv"].k.data_ptr(), caches["mamba"].ssm.clone()
    with torch.inference_mode():
        _, new, _ = lm.forward(cfg, p, _t(tokens), caches=caches)
    assert new["shared_kv"] is caches["shared_kv"]
    assert new["shared_kv"].k.data_ptr() == kv_ptr
    assert caches["shared_kv"].cursor.tolist() == [[6, 6]] and caches["shared_kv"].k.any()
    assert torch.equal(caches["mamba"].ssm, ssm_before) and not ssm_before.any()
    assert new["mamba"].ssm.data_ptr() != caches["mamba"].ssm.data_ptr()
    assert new["mamba"].ssm.any()


class _Mesh:
    axis_names = ("data", "model")

    def __init__(self, *shape):
        self.devices = np.empty(shape, dtype=object)


def test_sharding_is_the_identity_on_one_device_and_refuses_more():
    """``constrain`` returns a plain tensor itself, with no axes set, with a
    one-device mesh's and with a larger mesh's, whose sizes it reads:
    nothing is placed, so nothing is redistributed.  What refuses a record
    of more than one device is the dry run's counted half, which needs a
    ``DeviceMesh`` to place its stand-ins on (``ValueError``)."""
    from repro_torch.launch import calibrate
    from repro_torch.configs.base import ShapeSpec

    x = torch.ones(2, 3)
    sharding.set_activation_axes(None)
    assert sharding.constrain(x, ("dp", None)) is x
    sharding.set_activation_axes(_Mesh(1, 1))
    assert sharding.constrain(x, ("dp", "tp")) is x
    try:
        for shape in ((2, 1), (1, 4)):
            sharding.set_activation_axes(_Mesh(*shape))
            assert (sharding.dp_size(), sharding.tp_size()) == shape
            assert sharding.constrain(x, ("dp", "tp")) is x
            with pytest.raises(ValueError, match="DeviceMesh"):
                calibrate.calibrated_cost(get_config("granite-3-2b").reduced(),
                                          ShapeSpec("x", 64, 4, "train"), _Mesh(*shape))
    finally:
        sharding.set_activation_axes(None)
    assert sharding.constrain(x, ("dp", "tp")) is x
