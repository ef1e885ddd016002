"""The port's Jacobi sweep against the JAX package's Pallas kernels.

The same numpy inputs go through ``repro``'s Pallas kernels (interpret mode,
pinned variants, padded as ``repro.kernels.jacobi2d.ops`` pads them) and
through ``repro_torch`` (``convert.from_numpy``).  On the CPU the port's
wrappers run their plain versions; the CUDA kernels themselves are compared
with those plain versions by the ``gpu``-marked tests, which skip without a
card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.core.access import LaunchConfig
from repro_torch.core.machines import H100
from repro_torch.core.selector import enumerate_gpu_configs, rank_gpu_configs
from repro_torch.core.specs import stencil_2d5pt
from repro_torch.kernels import DEPTH_REASON, SCRATCH_REASON, dtype_for, fills_depth, get_generator
from repro_torch.kernels.jacobi2d import kernel as K
from repro_torch.kernels.jacobi2d.generator import generate, rank_configs, ytile_space
from repro_torch.kernels.jacobi2d.ops import jacobi_step
from repro_torch.kernels.jacobi2d.ref import jacobi_padded_ref, jacobi_ref, pad_input

DOMAINS = [(16, 32), (24, 40)]  # (Y, X), Y != X so that an axis swap shows
TOL = {np.float32: 1e-6, np.float64: 1e-12}
WEIGHTS = (0.5, 0.125)


def _src(seed, dtype, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _jax_kernel(src_np, variant, ty=None, weights=WEIGHTS):
    """The JAX package's Pallas kernel, in interpret mode, at a pinned variant,
    on the input padded as ``repro.kernels.jacobi2d.ops._apply`` pads it."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.jacobi2d.kernel import make_kernel

    with jax.enable_x64(src_np.dtype == np.float64):
        src = jnp.asarray(src_np)
        Y, X = src.shape
        padded = jnp.pad(src, 1)
        if variant == "ytile":
            extra = (Y // ty + 1) * ty - (Y + 2)
            padded = jnp.pad(padded, ((0, extra), (0, 0)))
        return np.asarray(make_kernel(variant, (Y, X), weights, src.dtype, ty)(padded))


def _jax_jacobi_step(src_np, config, weights=WEIGHTS):
    """The JAX package's entry point at a pinned config (``config=None``
    would reach the reference's tracer, which is broken on this jax)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.jacobi2d.ops import jacobi_step as jjacobi_step

    with jax.enable_x64(src_np.dtype == np.float64):
        return np.asarray(jjacobi_step(jnp.asarray(src_np), weights, config=config))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("variant,ty", [("rowstream", None), ("ytile", 8)])
@pytest.mark.parametrize("dom", DOMAINS)
def test_plain_version_matches_pallas_kernel(dom, variant, ty, dtype):
    src_np = _src(0, dtype, dom)
    want = _jax_kernel(src_np, variant, ty)
    src = convert.from_numpy(src_np, "cpu")
    got = jacobi_padded_ref(pad_input(src))
    assert got.dtype == src.dtype and got.shape == dom
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jacobi_ref_matches_reference_oracle(dtype):
    import jax
    import jax.numpy as jnp

    from repro.kernels.jacobi2d.ops import jacobi_ref as jjacobi_ref

    src_np = _src(1, dtype, DOMAINS[1])
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jjacobi_ref(jnp.asarray(src_np), (0.6, 0.1)))
    got = jacobi_ref(convert.from_numpy(src_np, "cpu"), (0.6, 0.1))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("config", [
    None, {"variant": "rowstream"}, {"block": (8, 4, 2), "folding": (1, 2, 1)},
    {"block": (16, 1, 4), "folding": (1, 1, 2)}, {"variant": "ytile", "ty": 8},
    {"variant": "ytile"}])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jacobi_step_end_to_end_matches_reference(config, dtype):
    dom = DOMAINS[1]
    src_np = _src(7, dtype, dom)
    ref_config = config if config and "variant" in config else {"variant": "rowstream"}
    want = _jax_jacobi_step(src_np, ref_config, (0.4, 0.15))
    got = jacobi_step(convert.from_numpy(src_np, "cpu"), (0.4, 0.15), config=config)
    assert got.shape == dom and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])


def test_weights_reach_the_sweep():
    src = convert.from_numpy(_src(5, np.float64, DOMAINS[0]), "cpu")
    got = jacobi_step(src, (0.3, 0.2), config={"variant": "ytile", "ty": 8})
    torch.testing.assert_close(got, jacobi_ref(src, (0.3, 0.2)), rtol=0, atol=0)
    assert not torch.equal(got, jacobi_step(src))


def test_generator_ranks_every_launch_and_skips_the_ytile_variants():
    from repro.kernels.jacobi2d.generator import _space

    dom = (32, 24)
    ranked = rank_configs(dom, 8, H100)
    # 22 of the 168 launches fill the (1, Y, X) domain's depth; 146 are skipped
    deep = [s for s in ranked.skipped if s.reason == DEPTH_REASON]
    assert len(ranked) == 22 and len(deep) == 146
    want = [cfg for cfg in _space(dom) if cfg["variant"] == "ytile"]
    tiles = ranked.skipped[:len(want)]
    assert [s.config for s in tiles] == want == [
        {"variant": "ytile", "ty": 8}, {"variant": "ytile", "ty": 16}]
    assert all(s.reason == SCRATCH_REASON for s in tiles)
    assert ranked.skipped == tiles + deep
    assert list(ytile_space((12, 8))) == [] and list(ytile_space((24, 8))) == [
        {"variant": "ytile", "ty": 8}]
    ranked.clear()  # callers get a copy; the memoized ranking is untouched
    assert len(rank_configs(dom, 8, H100)) == 22
    assert get_generator("jacobi2d").rank_configs is rank_configs


@pytest.mark.parametrize("domain,elem_bytes", [((32, 24), 8), ((24, 40), 4), ((4096, 4096), 8)])
def test_ranking_is_the_core_ranking_filtered_to_flat_launches(domain, elem_bytes):
    """Kept: the core's ranking (pinned to the reference's in
    test_torch_core.py), bitwise and in order, less the launches with
    bz·fz > 1, which are skipped with DEPTH_REASON in that same order."""
    core = rank_gpu_configs(stencil_2d5pt(domain, elem_bytes), H100)
    assert len(core) == 168
    ranked = rank_configs(domain, elem_bytes, H100)
    flat = [rc for rc in core if rc.launch.block[2] * rc.launch.folding[2] == 1]
    assert [(rc.launch, rc.perf) for rc in ranked] == [(rc.launch, rc.perf) for rc in flat]
    assert all(fills_depth(rc.launch) for rc in ranked)
    deep = [s.config for s in ranked.skipped if s.reason == DEPTH_REASON]
    assert deep == [{"block": rc.launch.block, "folding": rc.launch.folding}
                    for rc in core if not fills_depth(rc.launch)]
    kern, best = generate(domain, dtype=dtype_for(elem_bytes), device="cpu")
    assert best.launch == ranked[0].launch == flat[0].launch
    if domain == (4096, 4096):  # the paper size: the top launch already has z extent 1
        assert core[0].launch == ranked[0].launch == LaunchConfig(block=(1024, 1, 1),
                                                                   folding=(1, 2, 1))


def test_generate_returns_the_best_launch():
    dom = DOMAINS[1]
    kern, best = generate(dom, (0.4, 0.15), dtype=torch.float64, device="cpu")
    assert best.launch == rank_configs(dom, 8, H100)[0].launch
    padded = pad_input(convert.from_numpy(_src(3, np.float64, dom), "cpu"))
    torch.testing.assert_close(kern(padded), jacobi_padded_ref(padded, (0.4, 0.15)),
                               rtol=0, atol=0)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(DOMAINS[0], device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_numpy(_src(0, np.float32, DOMAINS[0]), "cuda")


@pytest.mark.parametrize("config,match", [
    ({"variant": "ytile", "ty": 5}, "ty must divide Y"),
    ({"variant": "ytile", "ty": 1}, "ty must divide Y"),
    ({"variant": "bogus"}, "unknown variant"),
])
def test_jacobi_step_rejects_bad_configs(config, match):
    with pytest.raises(ValueError, match=match):
        jacobi_step(torch.zeros(DOMAINS[1]), config=config)


def test_jacobi_step_rejects_a_field_that_is_not_2d():
    with pytest.raises(ValueError, match=r"\(Y, X\)"):
        jacobi_step(torch.zeros((2, 16, 32)))


def test_wrappers_validate_their_operands():
    padded = pad_input(torch.zeros(DOMAINS[1], dtype=torch.float64))
    launch = LaunchConfig((8, 4, 2))
    with pytest.raises(TypeError):
        K.jacobi_pointwise(padded.to(torch.int32), launch)
    with pytest.raises(TypeError):
        K.jacobi_pointwise(padded.numpy(), launch)
    with pytest.raises(ValueError, match=r"\(Y\+2, X\+2\)"):
        K.jacobi_pointwise(padded[None], launch)
    with pytest.raises(ValueError, match="contiguous"):
        K.jacobi_pointwise(padded.T, launch)
    with pytest.raises(ValueError, match="halo"):
        K.jacobi_pointwise(padded[:2].contiguous(), launch)
    with pytest.raises(ValueError, match="weights"):
        K.jacobi_pointwise(padded, launch, (0.5, 0.125, 0.1))
    with pytest.raises(ValueError, match="valid CUDA block"):
        K.jacobi_pointwise(padded, LaunchConfig((64, 32, 1)))
    with pytest.raises(ValueError, match="valid CUDA block"):
        K.jacobi_pointwise(padded, LaunchConfig((1, 1, 128)))
    with pytest.raises(ValueError, match="grid limit"):
        K.jacobi_pointwise(torch.zeros((70_000, 3), dtype=torch.float64),
                           LaunchConfig((1024, 1, 1)))
    with pytest.raises(ValueError, match="empty"):
        K.jacobi_ytile(padded, 0, 32)
    with pytest.raises(ValueError, match="shared memory"):
        K.jacobi_ytile(padded, 256, 256)


def test_ytile_tiles_respect_shared_memory():
    assert K.ytile_tile(8, 8) == (8, 256)
    assert K.ytile_smem_bytes(8, 256, 8) == 20_640
    assert K.ytile_tile(16, 4) == (16, 256)
    assert K.ytile_tile(128, 8) == (128, 128)
    assert K.ytile_smem_bytes(128, 128, 8) == 135_200
    for ty in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048):
        for eb in (4, 8):
            _, tx = K.ytile_tile(ty, eb)
            assert K.ytile_smem_bytes(ty, tx, eb) <= K.SMEM_PER_BLOCK == 232_448
            assert tx == K.YTILE_TX[0] or K.ytile_smem_bytes(ty, 2 * tx, eb) > K.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        K.ytile_tile(20_000, 8)


# ---------------------------------------------------------------------------
# On the card: every CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


GPU_TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12), torch.float32: dict(rtol=1e-5, atol=1e-5)}


def _card_case(cuda, dtype, shape, seed=0):
    src = torch.from_numpy(_src(seed, np.float64, shape)).to(cuda, dtype)
    padded = pad_input(src)
    return src, padded, jacobi_padded_ref(padded, (0.4, 0.15))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(37, 70), (64, 48)])
def test_card_pointwise_matches_plain_at_every_launch(cuda, dtype, shape):
    _, padded, want = _card_case(cuda, dtype, shape)
    for launch in enumerate_gpu_configs():
        before = K.LAUNCHES["jacobi_pointwise"]
        got = K.jacobi_pointwise(padded, launch, (0.4, 0.15))
        torch.cuda.synchronize()
        assert K.LAUNCHES["jacobi_pointwise"] == before + 1
        assert K.LAST_LAUNCH["jacobi_pointwise"] == launch
        torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=str(launch))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(37, 70), (48, 300), (16, 1000)])
def test_card_ytile_matches_plain(cuda, dtype, shape):
    _, padded, want = _card_case(cuda, dtype, shape)
    eb = torch.empty((), dtype=dtype).element_size()
    for tile in {K.ytile_tile(8, eb), K.ytile_tile(16, eb), K.ytile_tile(128, eb), (3, 5)}:
        before = K.LAUNCHES["jacobi_ytile"]
        got = K.jacobi_ytile(padded, *tile, (0.4, 0.15))
        torch.cuda.synchronize()
        assert K.LAUNCHES["jacobi_ytile"] == before + 1
        assert K.LAST_LAUNCH["jacobi_ytile"] == tile
        torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=str(tile))


@pytest.mark.gpu
def test_card_entry_point_runs_the_ranked_launch(cuda):
    src, padded, want = _card_case(cuda, torch.float64, (48, 80))
    K.reset_launch_counts()
    got = jacobi_step(src, (0.4, 0.15))
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"jacobi_pointwise": 1, "jacobi_ytile": 0}
    best = rank_configs((48, 80), 8, H100)[0]
    assert K.LAST_LAUNCH["jacobi_pointwise"] == best.launch
    torch.testing.assert_close(got, want, **GPU_TOL[torch.float64])
    kern, best = generate((48, 80), (0.4, 0.15), device=cuda)
    torch.testing.assert_close(kern(padded), want, **GPU_TOL[torch.float64])
    with pytest.raises(ValueError):
        kern(padded.cpu())
