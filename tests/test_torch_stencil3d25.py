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
from repro_torch.kernels.stencil3d25 import ablate
from repro_torch.kernels.stencil3d25.ref import (
    one_hot_points,
    one_hot_stencil,
    pad_input,
    star_stencil_ref,
    star_stencil_zsum_ref,
    star_weights,
)

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
    # 4 slots of 24 x 40 doubles, 8 mbarriers and room to align the ring
    assert K.zmarch_smem_bytes(4, 16, 32, 8) == 4 * 24 * 40 * 8 + 4 * 16 + 128
    assert K.ytile_tile(4, 8, 8) == (8, 128)
    assert K.ytile_tile(4, 16, 8) == (16, 64)
    assert K.ytile_tile(4, 16, 4) == (16, 128)
    for r, ty, eb in [(4, 8, 8), (4, 16, 8), (4, 16, 4), (2, 8, 4)]:
        _, tx = K.ytile_tile(r, ty, eb)
        assert K.zmarch_smem_bytes(r, ty, tx, eb) <= K.SMEM_PER_BLOCK
        assert K.zmarch_threads(r, ty, tx) <= 1024
        assert tx == K.YTILE_TX[0] or K.layer_ring_bytes(r, ty, 2 * tx, eb) > K.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        K.ring_tile(12, 8)
    with pytest.raises(ValueError, match="shared memory"):
        K.ytile_tile(40, 80, 8)


def _offered_tiles():
    """(r, dtype, tile) of every z-march tile the tests and chip_smoke.py run."""
    out = set()
    for r in (1, 2, 4):
        for eb in (4, 8):
            out |= {(r, eb, K.ring_tile(r, eb)), (r, eb, K.ytile_tile(r, 8, eb)),
                    (r, eb, K.ytile_tile(r, 16, eb)), (r, eb, (3, 5))}
    return sorted(out)


@pytest.mark.parametrize("r,eb,tile", _offered_tiles())
def test_zmarch_layout_fits_a_block(r, eb, tile):
    ty, tx = tile
    lay = K.zmarch_layout(r, ty, tx, eb)
    assert K.zmarch_smem_bytes(r, ty, tx, eb) <= K.SMEM_PER_BLOCK
    assert K.zmarch_threads(r, ty, tx) == lay["threads"] <= 288
    assert lay["threads"] % 32 == 0 and lay["threads"] - 32 >= -(-ty // lay["cy"]) * tx
    skew = 16 // eb - 1 if (tx * eb) % 16 else 0  # a tile may start that far past a slot row's start
    assert lay["rows"] >= ty + 2 * r and lay["bw"] >= tx + 2 * r + skew
    assert (lay["bw"] * eb) % 16 == 0 and (lay["slot_elems"] * eb) % 128 == 0
    for stages in (2, 3, 4):
        assert K.zmarch_smem_bytes(r, ty, tx, eb, stages) <= K.SMEM_PER_BLOCK


@pytest.mark.parametrize("shape", [(13, 37, 70), (9, 48, 40), (16, 32, 64), DOMAIN,
                                   (512, 512, 640)])
def test_zmarch_route_takes_tma_exactly_on_16_byte_rows(shape):
    for r, eb, (ty, tx) in _offered_tiles():
        xp = shape[2] + 2 * r
        route = K.zmarch_route(r, ty, tx, xp, eb)
        assert route in K.ZMARCH_ROUTES
        assert (route == "cp_async") == ((xp * eb) % 16 != 0), (shape, r, eb, ty, tx)
        assert K.zmarch_route(r, ty, tx, xp, eb, data_ptr=8) == "cp_async"
    # the paper's field takes TMA in both dtypes
    assert K.zmarch_route(4, 16, 32, 648, 4) == K.zmarch_route(4, 16, 32, 648, 8) == "tma"


def test_zmarch_rows_and_segments_follow_their_rules():
    assert [K.zmarch_rows(ty, tx) for ty, tx in [(16, 32), (8, 128), (16, 64), (16, 128)]] == [
        2, 4, 4, 8]
    with pytest.raises(ValueError, match="consumer threads"):
        K.zmarch_rows(16, 512)
    # ring tiles of the paper's field at 2 CTAs a SM: 3 waves of 520 planes
    # against 5 of 264
    assert K.zmarch_segments(640, 512, 4, 264) == 2
    assert K.zmarch_segments(160, 512, 4, 132) == 4
    assert K.zmarch_segments(4, 13, 4, 132) == 7      # 4 tiles leave the card idle: split
    assert K.zmarch_segments(4, 1000, 4, 132) == K.ZMARCH_MAX_SEGMENTS
    assert K.zmarch_segments(1000, 3, 4, 132) <= 3    # never more segments than planes


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_zsum_order_matches_plain_version_and_pallas_ring(r, dtype):
    """The z-march kernel's sum order (``ref.star_stencil_zsum_ref``) gives
    the plain version's and the Pallas ring's result."""
    src_np = _source(20 + r, dtype)
    want = _jax_stencil(src_np, r, "ring", None)
    src = convert.from_numpy(src_np, "cpu")
    w = star_weights(r, src.dtype)
    padded = pad_input(src, r)
    got = star_stencil_zsum_ref(padded, w, r)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(got.numpy(), star_stencil_ref(padded, w, r).numpy(), rtol=0,
                               atol=TOL[dtype])


def test_card_range_is_the_constant_bank_and_the_cpu_takes_any_r():
    """The constant bank holds only the weights of the unrolled kernels
    (r <= UNROLLED_R, the source's kBankRange); any other r runs the
    generic kernels, which read the weights tensor, so the card refuses no
    r that the reference takes, and neither does the CPU."""
    src_cu = (_build.CSRC / "stencil3d25.cu").read_text()
    assert f"constexpr int kBankRange = {K.UNROLLED_R};" in src_cu
    assert "kMaxRange" not in src_cu and not hasattr(K, "MAX_CARD_R")
    assert K.weights_in_bank(4) and K.weights_in_bank(1)
    assert not K.weights_in_bank(5) and not K.weights_in_bank(9) and not K.weights_in_bank(12)
    # the generic z-march reads every tap from the ring: 2r+1 planes and one more
    assert [K.zmarch_stages(r) for r in (1, 4, 5, 9, 12)] == [K.ZMARCH_STAGES] * 2 + [12, 20, 26]
    for r in (9, 12):
        src = pad_input(torch.zeros((2, 3, 4), dtype=torch.float64), r)
        w = star_weights(r, torch.float64)
        assert K.star_pointwise(src, w, r, LaunchConfig((32, 4, 8))).shape == (2, 3, 4)
        assert K.star_zmarch(src, w, r, 3, 5).shape == (2, 3, 4)
        with pytest.raises(ValueError, match="stages"):
            K.star_zmarch(src, w, r, 3, 5, stages=2 * r + 1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("r", [9, 12])
def test_plain_version_above_the_bank_matches_pallas_replane(r, dtype):
    """Ranges past the constant bank: the wrappers' plain path (what the
    generic card kernels are held to) against the reference's
    ``make_replane`` in interpret mode."""
    src_np = _source(r, dtype)
    want = _jax_stencil(src_np, r, "replane", None)
    padded = pad_input(convert.from_numpy(src_np, "cpu"), r)
    w = star_weights(r, padded.dtype)
    for got in (K.star_pointwise(padded, w, r, LaunchConfig((16, 4, 2), (1, 2, 1))),
                K.star_zmarch(padded, w, r, 3, 5)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])


def test_pointwise_rules_pick_cap_and_offsets():
    """star_pointwise has one register cap, ``__launch_bounds__(1024)``:
    every priced launch has 1024 threads, so no launch the ranking can
    name would run under another.  Its offsets are 32-bit below 2^31
    padded elements."""
    assert "__launch_bounds__(1024)\nstar_pointwise_kernel" in (
        _build.CSRC / "stencil3d25.cu").read_text()
    assert {launch.threads for launch in enumerate_gpu_configs()} == {1024}
    assert K.pointwise_offset_bits(520 * 520 * 648) == 32   # the paper's padded field
    assert K.pointwise_offset_bits(2**31 - 1) == 32 and K.pointwise_offset_bits(2**31) == 64
    assert K.pointwise_offset_bits(100, wide_at=100) == 64


def test_zmarch_wrapper_rejects_what_no_route_takes():
    src = pad_input(torch.zeros((13, 37, 70), dtype=torch.float32), 2)  # 74 x 4 B rows
    w = star_weights(2, torch.float32)
    K.star_zmarch(src, w, 2, 16, 32, route="cp_async", stages=2, segments=3)
    with pytest.raises(ValueError, match="route"):
        K.star_zmarch(src, w, 2, 16, 32, route="tma")
    with pytest.raises(ValueError, match="route"):
        K.star_zmarch(src, w, 2, 16, 32, route="bulk")
    with pytest.raises(ValueError, match="stages"):
        K.star_zmarch(src, w, 2, 16, 32, stages=1)
    with pytest.raises(ValueError, match="consumer threads"):
        K.star_zmarch(src, w, 2, 16, 512)
    with pytest.raises(ValueError, match="segments"):
        K.star_zmarch(src, w, 2, 16, 32, segments=14)


@pytest.mark.parametrize("name", sorted(ablate.VARIANTS))
def test_ablation_edits_find_their_text_once(name):
    """Each variant of ``stencil3d25/ablate.py`` edits text that occurs
    exactly once in ``stencil3d25.cu``, so it changes what it names."""
    src = (_build.CSRC / "stencil3d25.cu").read_text()
    for old, new in ablate.VARIANTS[name]:
        assert src.count(old) == 1 and old != new


def test_ablation_old_kernel_is_the_first_version_outside_the_build(tmp_path):
    """The old kernel comes from a checkout of the commit before the
    redesign (``--base``), not from a copy in the package."""
    csrc = tmp_path / "src" / "repro_torch" / "csrc"
    with pytest.raises(FileNotFoundError, match="checkout"):
        ablate.old_source(tmp_path)
    csrc.mkdir(parents=True)
    (csrc / "stencil3d25.cu").write_text((_build.CSRC / "stencil3d25.cu").read_text())
    with pytest.raises(ValueError, match="first version"):
        ablate.old_source(tmp_path)  # the redesigned source is not the old kernel
    (csrc / "stencil3d25.cu").write_text("constexpr int kPrefetch = 8;\n")
    assert ablate.old_source(tmp_path) == csrc / "stencil3d25.cu"
    assert not any("kPrefetch" in cu.read_text() for cu in _build.CSRC.rglob("*.cu"))
    # its tiles and threads, as the first version's wrapper computed them
    assert [ablate.old_ytile_tx(4, ty, eb) for ty, eb in [(8, 8), (16, 8), (16, 4)]] == [
        128, 64, 128]
    assert ablate.old_zmarch_threads(4, 16, 32) == 256


@pytest.mark.parametrize("fn", sorted(K._SIGNATURES))
def test_ctypes_signatures_match_the_c_launchers(fn):
    """ctypes passes what ``_SIGNATURES`` declares whatever the C function
    takes: each declaration has the C prototype's parameters, pointers
    where it takes pointers."""
    import re

    src = (_build.CSRC / "stencil3d25.cu").read_text()
    params = re.search(rf"\nint {fn}\(([^)]*)\)", src).group(1).split(",")
    want = [_ctypes_of(p) for p in params]
    assert K._SIGNATURES[fn] == want, (fn, params)


def _ctypes_of(param: str):
    """The ctypes type a C launcher parameter is passed as."""
    import ctypes

    return ctypes.c_void_p if "*" in param else ctypes.c_int


def test_one_hot_stencil_is_the_plain_version_of_a_one_hot_field():
    r, domain = 2, (9, 11, 13)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(6 * r + 1))
    pts = one_hot_points(domain, r)
    assert len(pts) == 7
    for p in pts:
        padded = torch.zeros(tuple(n + 2 * r for n in domain), dtype=torch.float64)
        padded[p] = 1
        want = one_hot_stencil(domain, r, w, [p])
        assert int((want != 0).sum()) == 6 * r + 1
        assert torch.equal(star_stencil_ref(padded, w, r), want)
        assert torch.equal(star_stencil_zsum_ref(padded, w, r), want)


def test_smoke_names_each_stencil_instantiation_by_its_template_arguments():
    """chip_smoke.py reports ptxas's registers per instantiation: the names
    keep the scalar type, r, the rows and the offset type."""
    import runpy
    from pathlib import Path

    smoke = runpy.run_path(str(Path(__file__).resolve().parents[1] / "chip_smoke.py"),
                           run_name="chip_smoke_imported")
    ns = "_ZN47_GLOBAL__N__ab9f3be0_14_stencil3d25_cu_e19bd859"
    line = "ptxas info    : Compiling entry function '{}' for 'sm_90a'"
    assert smoke["ptxas_kernel_name"](line.format(
        ns + "21star_pointwise_kernelIdLi4EiEEvPKT_PS1_S3_iiiiiii")) == (
        "star_pointwise_kernel<double, 4, int>")
    assert smoke["ptxas_kernel_name"](line.format(
        ns + "18star_zmarch_kernelIfLi4ELi8EEEv14CUtensorMap_stPKT_PS2_NS_10ZmarchArgsE")) == (
        "star_zmarch_kernel<float, 4, 8>")


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


def test_build_times_each_source_and_keeps_no_log_of_a_failure(tmp_path, monkeypatch):
    """``BUILD_SECONDS`` holds each source's nvcc time in a parallel build;
    a failed source leaves neither library nor log behind."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    nvcc = _fake_nvcc(tmp_path, '''case "$*" in *jacobi2d*) sleep 0.4;; esac
case "$*" in *matmul*) echo 'error: matmul broke'; exit 1;; esac
while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then touch "$2"; fi; shift; done
''')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    libs = _build.build(["jacobi2d", "lbm_d3q15"])
    assert set(_build.BUILD_SECONDS) == {"jacobi2d", "lbm_d3q15"}
    assert _build.BUILD_SECONDS["jacobi2d"] >= 0.4 > _build.BUILD_SECONDS["lbm_d3q15"]
    assert all(lib.is_file() for lib in libs.values())
    with pytest.raises(RuntimeError, match="matmul broke"):
        _build.build(["matmul"])
    left = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert not any("matmul" in name for name in left), left


def test_build_compiles_each_source_once_keyed_by_its_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = tmp_path / "calls"
    # the fake compiler writes its -o target and logs each call
    nvcc = _fake_nvcc(tmp_path, f'''echo "$@" >> {calls}
while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then touch "$2"; fi; shift; done
echo "ptxas info: Used 40 registers" >&2
''')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    assert _build.sources() == ["flash_attention", "halo_pad", "jacobi2d", "lbm_d3q15",
                                "matmul", "stencil3d25", "transpose_pad"]
    libs = _build.build()
    lib = libs["stencil3d25"]
    assert lib.is_file() and lib.parent == tmp_path / "build"
    assert "registers" in lib.with_name(lib.name + ".log").read_text()
    assert "arch=compute_90a,code=sm_90a" in calls.read_text()
    assert _build.build() == libs
    assert len(calls.read_text().splitlines()) == 7


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_card_pointwise_offsets_of_both_widths(cuda, dtype):
    """The 64-bit offsets, reached on a small field by moving the threshold,
    give what the 32-bit ones give, at the ranked block and smaller ones."""
    r = 4
    _, padded, w, want = _card_case(cuda, dtype, (13, 37, 70), r)
    for launch in (LaunchConfig((16, 2, 32)), LaunchConfig((32, 8, 2), (1, 2, 1)),
                   LaunchConfig((8, 4, 8), (2, 1, 1))):
        got = {}
        for bits, wide_at in ((32, K.WIDE_AT), (64, padded.numel())):
            got[bits] = K.star_pointwise(padded, w, r, launch, wide_at=wide_at)
            torch.cuda.synchronize()
            assert K.LAST_POINTWISE == {"offset_bits": bits, "weights": "constant bank"}
            torch.testing.assert_close(got[bits], want, **GPU_TOL[dtype], msg=str(launch))
        assert torch.equal(got[32], got[64])
    assert K.pointwise_offset_bits(520 * 520 * 648) == 32  # the paper's padded field


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 2, 4])
def test_card_one_hot_gives_the_weights_bit_for_bit(cuda, dtype, r):
    """A single 1 in the padded input, at the centre and r inside each face,
    gives exactly the weights on its star's outputs and 0 elsewhere, for
    both routes, every z-march variant, 2-4 stages wrapping many times (21
    planes) and z segments; this pins the ring's slots, the mbarrier phases
    and the partial sums' rotation."""
    domain = (13, 37, 72 - 2 * r)  # padded rows of 72 elements: TMA takes both dtypes
    eb = torch.empty((), dtype=dtype).element_size()
    w = torch.from_numpy(np.random.default_rng(r).standard_normal(6 * r + 1)).to(cuda, dtype)
    tiles = {K.ring_tile(r, eb), K.ytile_tile(r, 8, eb), K.ytile_tile(r, 16, eb), (3, 5)}
    plans = [("tma", 2, 2), ("tma", 4, None), ("cp_async", 3, 1), ("cp_async", 2, None)]
    for p in one_hot_points(domain, r):
        padded = torch.zeros(tuple(n + 2 * r for n in domain), dtype=dtype, device=cuda)
        padded[p] = 1
        want = one_hot_stencil(domain, r, w, [p])
        for tile in tiles:
            for route, stages, segments in plans:
                got = K.star_zmarch(padded, w, r, *tile, route=route, stages=stages,
                                    segments=segments)
                assert K.LAST_ZMARCH["route"] == route and K.LAST_ZMARCH["stages"] == stages
                assert torch.equal(got, want), (p, tile, route, stages, segments)
        got = K.star_pointwise(padded, w, r, LaunchConfig((16, 2, 32)))
        assert torch.equal(got, want), (p, "star_pointwise")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_card_two_streams_with_different_weights(cuda, dtype):
    """Stencils with different weights on two streams at once, launched in
    turns on both: each output is its own weights' stencil, since every
    fill of the constant bank waits for the bank's last launch on the other
    stream (``bank_counts`` shows the fills and the waits)."""
    r = 4
    _, padded, _, _ = _card_case(cuda, dtype, (64, 96, 128), r)
    rng = np.random.default_rng(11)
    ws = [torch.from_numpy(rng.standard_normal(6 * r + 1)).to(cuda, dtype) for _ in range(2)]
    wants = [star_stencil_ref(padded, w, r) for w in ws]
    eb = padded.element_size()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    runs = [lambda w: K.star_pointwise(padded, w, r, LaunchConfig((64, 2, 8), (1, 1, 2))),
            lambda w: K.star_zmarch(padded, w, r, *K.ring_tile(r, eb))]
    before = K.bank_counts()
    outs = []
    for _ in range(6):
        for run in runs:
            for j, st in enumerate(streams):
                with torch.cuda.stream(st):
                    outs.append((j, run(ws[j])))
    torch.cuda.synchronize()
    after = K.bank_counts()
    assert after["fills"] - before["fills"] == len(outs)  # r = 4 fills the bank every launch
    assert after["waits"] - before["waits"] >= len(outs) - 1
    for i, (j, got) in enumerate(outs):
        torch.testing.assert_close(got, wants[j], **GPU_TOL[dtype], msg=f"launch {i}, stream {j}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [9, 12])
def test_card_ranges_above_the_bank_match_plain(cuda, dtype, r):
    """r = 9 and 12 run the generic kernels, weights from the tensor and
    never the bank: the per-point kernel at launches of every folding, and
    the z-march on every tile that fits, on both routes."""
    _, padded, w, want = _card_case(cuda, dtype, (13, 37, 70), r)
    eb = padded.element_size()
    fills = K.bank_counts()["fills"]
    for launch in (LaunchConfig((16, 2, 32)), LaunchConfig((32, 8, 2), (1, 2, 1)),
                   LaunchConfig((8, 4, 8), (1, 1, 2)), LaunchConfig((1024, 1, 1))):
        got = K.star_pointwise(padded, w, r, launch)
        torch.cuda.synchronize()
        assert K.LAST_POINTWISE["weights"] == "tensor"
        torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=str(launch))
    tiles = {(3, 5)}
    for ty in (8, 16):
        try:
            tiles.add(K.ytile_tile(r, ty, eb))
        except ValueError:
            pass  # no tile of ty rows fits this range's ring
    for tile in tiles:
        for route in K.ZMARCH_ROUTES:
            if route == "tma" and K.zmarch_route(r, *tile, 70 + 2 * r, eb, padded.data_ptr()) != "tma":
                continue
            got = K.star_zmarch(padded, w, r, *tile, route=route)
            torch.cuda.synchronize()
            assert K.LAST_ZMARCH["weights"] == "tensor"
            assert K.LAST_ZMARCH["stages"] == 2 * r + 2
            torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=f"{tile} {route}")
    assert K.bank_counts()["fills"] == fills
