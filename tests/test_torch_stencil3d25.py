"""The port's star stencil against the JAX package's Pallas kernels.

The same numpy inputs go through ``repro``'s Pallas kernels (interpret mode,
pinned variants, as tests/test_kernels.py runs them) and through
``repro_torch`` (``convert.from_numpy``).  On the CPU the port's wrappers run
their plain versions; the CUDA kernels themselves are compared with those
plain versions by the ``gpu``-marked tests, which skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.core.access import LaunchConfig
from repro_torch.core.machines import H100
from repro_torch.core.selector import enumerate_gpu_configs
from repro_torch.kernels import GENERATOR_MODULES, _build, dtype_for, get_generator
from repro_torch.kernels.stencil3d25 import kernel as K
from repro_torch.kernels.stencil3d25.generator import SCRATCH_REASON, generate, rank_configs
from repro_torch.kernels.stencil3d25.ops import star_stencil
from repro_torch.kernels.stencil3d25.ref import pad_input, star_stencil_ref, star_weights

DOMAIN = (5, 16, 24)
TOL = {np.float32: 2e-5, np.float64: 1e-12}  # the reference's own fp32 tolerance


def _jax_stencil(src_np, r, variant, ty):
    """The JAX package's Pallas kernel, in interpret mode, at a pinned variant."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.stencil3d25.kernel import make_kernel
    from repro.kernels.stencil3d25.ref import pad_input as jpad
    from repro.kernels.stencil3d25.ref import star_weights as jweights

    with jax.enable_x64(src_np.dtype == np.float64):
        src = jnp.asarray(src_np)
        w = jweights(r, src.dtype)
        padded = jpad(src, r)
        if variant == "ytile_ring":
            Y = src.shape[1]
            extra = (Y // ty + 1) * ty - (Y + 2 * r)
            padded = jnp.pad(padded, ((0, 0), (0, extra), (0, 0)))
        kern = make_kernel(variant, r, src.shape, tuple(float(x) for x in w), src.dtype, ty)
        return np.asarray(kern(padded))


def _source(seed, dtype, shape=DOMAIN):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _jax_reference(src_np, r):
    """The JAX package's pure-jnp oracle, ``repro...ref.star_stencil_ref``."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.stencil3d25.ref import pad_input as jpad
    from repro.kernels.stencil3d25.ref import star_stencil_ref as jref
    from repro.kernels.stencil3d25.ref import star_weights as jweights

    with jax.enable_x64(src_np.dtype == np.float64):
        src = jnp.asarray(src_np)
        return np.asarray(jref(jpad(src, r), jweights(r, src.dtype), r))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("variant,ty", [("replane", None), ("ring", None), ("ytile_ring", 8)])
@pytest.mark.parametrize("r", [1, 2, 4])
def test_plain_version_matches_pallas_kernel(r, variant, ty, dtype):
    src_np = _source(r, dtype)
    want = _jax_stencil(src_np, r, variant, ty)
    src = convert.from_numpy(src_np, "cpu")
    got = star_stencil_ref(pad_input(src, r), star_weights(r, src.dtype), r)
    assert got.dtype == dtype_for(src_np.itemsize)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("config", [
    None, {"variant": "replane"}, {"block": (16, 2, 32), "folding": (1, 2, 1)},
    {"block": (8, 4, 32), "folding": (1, 1, 2)}, {"variant": "ring"},
    {"variant": "ytile_ring", "ty": 8}])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_star_stencil_end_to_end_matches_reference(config, dtype):
    r = 2
    src_np = _source(7, dtype)
    want = _jax_reference(src_np, r)
    got = star_stencil(convert.from_numpy(src_np, "cpu"), r=r, config=config)
    assert got.shape == DOMAIN and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])


def test_explicit_weights_are_used():
    rng = np.random.default_rng(11)
    src_np, w_np = rng.standard_normal(DOMAIN), rng.standard_normal(6 * 2 + 1)
    tree = convert.from_numpy({"src": src_np, "w": w_np}, "cpu")
    got = star_stencil(tree["src"], tree["w"], r=2, config={"variant": "ring"})
    want = star_stencil_ref(pad_input(tree["src"], 2), tree["w"], 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_generator_ranks_every_launch_and_skips_the_zmarch_variants():
    ranked = rank_configs(2, DOMAIN, 8, H100)
    assert len(ranked) == 168
    assert [s.config for s in ranked.skipped] == [{"variant": "ring"},
                                                   {"variant": "ytile_ring", "ty": 8}]
    assert all(s.reason == SCRATCH_REASON for s in ranked.skipped)
    ranked.clear()  # callers get a copy; the memoized ranking is untouched
    assert len(rank_configs(2, DOMAIN, 8, H100)) == 168


def test_generate_returns_the_best_launch():
    w = star_weights(2, torch.float64)
    kern, best = generate(2, DOMAIN, w, dtype=torch.float64, device="cpu")
    assert best.launch == rank_configs(2, DOMAIN, 8, H100)[0].launch
    src = convert.from_numpy(_source(3, np.float64), "cpu")
    torch.testing.assert_close(kern(pad_input(src, 2)),
                               star_stencil_ref(pad_input(src, 2), w, 2), rtol=0, atol=0)


def test_registry_and_dtypes_mirror_the_reference():
    from repro.kernels import GENERATOR_MODULES as REF_MODULES

    assert set(GENERATOR_MODULES) <= set(REF_MODULES)
    assert get_generator("stencil3d25").rank_configs is rank_configs
    assert [dtype_for(n) for n in (1, 2, 4, 8)] == [
        torch.int8, torch.bfloat16, torch.float32, torch.float64]
    with pytest.raises(ValueError):
        dtype_for(3)
    with pytest.raises(KeyError):
        get_generator("lbm_d3q15_unknown")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(2, DOMAIN, star_weights(2), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_numpy(np.zeros(3))


@pytest.mark.parametrize("config,match", [
    ({"variant": "ytile_ring", "ty": 5}, "ty must divide Y"),
    ({"variant": "ytile_ring", "ty": 2}, "ty must divide Y"),
    ({"variant": "bogus"}, "unknown variant"),
])
def test_star_stencil_rejects_bad_configs(config, match):
    with pytest.raises(ValueError, match=match):
        star_stencil(torch.zeros(DOMAIN), r=2, config=config)


def test_wrappers_validate_their_operands():
    src = pad_input(torch.zeros(DOMAIN, dtype=torch.float64), 2)
    w = star_weights(2, torch.float64)
    launch = LaunchConfig((32, 4, 8))
    with pytest.raises(TypeError):
        K.star_pointwise(src.to(torch.int32), w, 2, launch)
    with pytest.raises(ValueError):
        K.star_pointwise(src, w.float(), 2, launch)
    with pytest.raises(ValueError):
        K.star_pointwise(src, w[:-1], 2, launch)
    with pytest.raises(ValueError):
        K.star_pointwise(src.transpose(1, 2), w, 2, launch)
    with pytest.raises(ValueError):
        K.star_pointwise(src, w, 2, LaunchConfig((64, 32, 1)))
    with pytest.raises(ValueError):
        K.star_zmarch(src, w, 2, 0, 32)


def test_zmarch_tiles_respect_shared_memory():
    assert K.ring_tile(4, 8) == (16, 32)
    assert K.zmarch_smem_bytes(4, 16, 32, 8) == 69_120 + 25 * 8
    assert K.ytile_tile(4, 8, 8) == (8, 128)
    assert K.ytile_tile(4, 16, 8) == (16, 64)
    for r, ty, eb in [(4, 8, 8), (4, 16, 8), (4, 16, 4), (2, 8, 4)]:
        _, tx = K.ytile_tile(r, ty, eb)
        assert K.zmarch_smem_bytes(r, ty, tx, eb) <= K.SMEM_PER_BLOCK
        assert (ty + 2 * r) * (tx + 2 * r) <= K.ZMARCH_PREFETCH * K.zmarch_threads(r, ty, tx)
        assert K.zmarch_threads(r, ty, tx) <= 1024
        assert tx == K.YTILE_TX[0] or K.zmarch_smem_bytes(r, ty, 2 * tx, eb) > K.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        K.ring_tile(12, 8)
    with pytest.raises(ValueError, match="shared memory"):
        K.ytile_tile(40, 80, 8)


def _fake_nvcc(tmp_path, body):
    exe = tmp_path / "nvcc"
    exe.write_text("#!/bin/sh\n" + body)
    exe.chmod(0o755)
    return str(exe)


def test_build_reports_nvcc_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    nvcc = _fake_nvcc(tmp_path, "echo 'error: something broke' >&2\nexit 2\n")
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="something broke"):
        _build.build(["stencil3d25"])


def test_build_compiles_each_source_once_keyed_by_its_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = tmp_path / "calls"
    # the fake compiler writes its -o target and logs each call
    nvcc = _fake_nvcc(tmp_path, f'''echo "$@" >> {calls}
while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then touch "$2"; fi; shift; done
echo "ptxas info: Used 40 registers" >&2
''')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    assert _build.sources() == ["flash_attention", "jacobi2d", "lbm_d3q15", "matmul",
                                "stencil3d25", "transpose_pad"]
    libs = _build.build()
    lib = libs["stencil3d25"]
    assert lib.is_file() and lib.parent == tmp_path / "build"
    assert "registers" in lib.with_name(lib.name + ".log").read_text()
    assert "arch=compute_90a,code=sm_90a" in calls.read_text()
    assert _build.build() == libs
    assert len(calls.read_text().splitlines()) == 6


# ---------------------------------------------------------------------------
# On the card: every CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_case(cuda, dtype, shape, r, seed=0):
    src = torch.from_numpy(_source(seed, np.float64, shape)).to(cuda, dtype)
    padded = pad_input(src, r)
    w = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(6 * r + 1)).to(
        cuda, dtype)
    return src, padded, w, star_stencil_ref(padded, w, r)


GPU_TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12), torch.float32: dict(rtol=1e-5, atol=1e-5)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(13, 37, 70), (16, 32, 64)])
def test_card_pointwise_matches_plain_at_every_launch(cuda, dtype, shape):
    for r in (1, 4):
        _, padded, w, want = _card_case(cuda, dtype, shape, r)
        for launch in enumerate_gpu_configs():
            before = K.LAUNCHES["star_pointwise"]
            got = K.star_pointwise(padded, w, r, launch)
            torch.cuda.synchronize()
            assert K.LAUNCHES["star_pointwise"] == before + 1
            torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=str(launch))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(13, 37, 70), (9, 48, 40)])
@pytest.mark.parametrize("r", [1, 2, 4])
def test_card_zmarch_matches_plain(cuda, dtype, shape, r):
    _, padded, w, want = _card_case(cuda, dtype, shape, r)
    eb = torch.empty((), dtype=dtype).element_size()
    for tile in {K.ring_tile(r, eb), K.ytile_tile(r, 8, eb), K.ytile_tile(r, 16, eb), (3, 5)}:
        before = K.LAUNCHES["star_zmarch"]
        got = K.star_zmarch(padded, w, r, *tile)
        torch.cuda.synchronize()
        assert K.LAUNCHES["star_zmarch"] == before + 1
        torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=str(tile))


@pytest.mark.gpu
def test_card_entry_point_runs_the_ranked_launch(cuda):
    src, _, _, _ = _card_case(cuda, torch.float64, (16, 32, 64), 2)
    K.reset_launch_counts()
    got = star_stencil(src, r=2)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"star_pointwise": 1, "star_zmarch": 0}
    want = star_stencil_ref(pad_input(src, 2), star_weights(2, torch.float64, cuda), 2)
    torch.testing.assert_close(got, want, **GPU_TOL[torch.float64])
    kern, best = generate(2, (16, 32, 64), star_weights(2, torch.float64), device=cuda)
    torch.testing.assert_close(kern(pad_input(src, 2)), want, **GPU_TOL[torch.float64])
    with pytest.raises(ValueError):
        K.star_pointwise(pad_input(src, 2), star_weights(2, torch.float64), 2, best.launch)
