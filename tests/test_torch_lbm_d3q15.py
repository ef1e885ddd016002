"""The port's D3Q15 LBM step against the JAX package's Pallas kernels.

The same numpy inputs (the phase field ``sigmoid(randn)`` and PDFs
``w_q * phase``, the state of tests/test_kernels.py) go through ``repro``'s
Pallas kernels (interpret mode, pinned variants, as tests/test_kernels.py
runs them) and through ``repro_torch`` (``convert.from_numpy``).  On the CPU
the port's wrappers run their plain versions; the CUDA kernels themselves are
compared with those plain versions by the ``gpu``-marked tests, which skip
without a card.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.core.access import LaunchConfig
from repro_torch.core.machines import H100
from repro_torch.core.selector import enumerate_gpu_configs
from repro_torch.kernels import SCRATCH_REASON, get_generator
from repro_torch.kernels.lbm_d3q15 import kernel as K
from repro_torch.kernels.lbm_d3q15.generator import generate, rank_configs, ytile_space
from repro_torch.kernels.lbm_d3q15.ops import lbm_step
from repro_torch.kernels.lbm_d3q15.ref import VELOCITIES, WEIGHTS, lbm_step_ref, pad_inputs

DOMAINS = [(3, 8, 16), (4, 16, 8)]
TOL = {np.float32: 2e-5, np.float64: 1e-12}  # the reference's own fp32 tolerance


def _state(seed, dtype, shape):
    """(pdf (15, Z, Y, X), phase (Z, Y, X)) as numpy: phase = sigmoid(randn),
    pdf[q] = w_q * phase."""
    phase = 1.0 / (1.0 + np.exp(-np.random.default_rng(seed).standard_normal(shape)))
    pdf = np.stack([w * phase for w in WEIGHTS])
    return pdf.astype(dtype), phase.astype(dtype)


def _jax_kernel(pdf_np, phase_np, variant, ty):
    """The JAX package's Pallas kernel, in interpret mode, at a pinned variant
    (padded as ``repro.kernels.lbm_d3q15.ops`` pads it)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.lbm_d3q15.kernel import make_kernel
    from repro.kernels.lbm_d3q15.ref import pad_inputs as jpad

    with jax.enable_x64(pdf_np.dtype == np.float64):
        pdf_p, ph_p = jpad(jnp.asarray(pdf_np), jnp.asarray(phase_np))
        _q, Z, Y, X = pdf_np.shape
        if variant == "ytile":
            extra = (Y // ty + 1) * ty - (Y + 2)
            pdf_p = jnp.pad(pdf_p, ((0, 0), (0, 0), (0, extra), (0, 0)))
            ph_p = jnp.pad(ph_p, ((0, 0), (0, extra), (0, 0)))
        return np.asarray(make_kernel(variant, (Z, Y, X), ty, dtype=pdf_p.dtype)(pdf_p, ph_p))


def _jax_lbm_step(pdf_np, phase_np):
    """The JAX package's entry point at its per-plane kernel (``config=None``
    would reach the reference's tracer, which is broken on this jax)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.lbm_d3q15.ops import lbm_step as jlbm_step

    with jax.enable_x64(pdf_np.dtype == np.float64):
        new_pdf, phase = jlbm_step(jnp.asarray(pdf_np), jnp.asarray(phase_np),
                                   config={"variant": "replane"})
        return np.asarray(new_pdf), np.asarray(phase)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("variant,ty", [("replane", None), ("ytile", 4)])
@pytest.mark.parametrize("dom", DOMAINS)
def test_plain_version_matches_pallas_kernel(dom, variant, ty, dtype):
    pdf_np, phase_np = _state(0, dtype, dom)
    want = _jax_kernel(pdf_np, phase_np, variant, ty)
    pdf, phase = convert.from_numpy((pdf_np, phase_np), "cpu")
    got, got_phase = lbm_step_ref(*pad_inputs(pdf, phase))
    assert got.dtype == pdf.dtype and got.shape == (15, *dom)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(got_phase.numpy(), want.sum(0), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("config", [
    None, {"variant": "replane"}, {"block": (8, 4, 2), "folding": (1, 2, 1)},
    {"block": (16, 1, 4), "folding": (1, 1, 2)}, {"variant": "ytile", "ty": 4},
    {"variant": "ytile"}])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lbm_step_end_to_end_matches_reference(config, dtype):
    dom = DOMAINS[1]
    pdf_np, phase_np = _state(7, dtype, dom)
    want_pdf, want_phase = _jax_lbm_step(pdf_np, phase_np)
    pdf, phase = convert.from_numpy((pdf_np, phase_np), "cpu")
    got_pdf, got_phase = lbm_step(pdf, phase, config=config)
    assert got_pdf.shape == (15, *dom) and got_phase.shape == dom
    assert got_pdf.device.type == "cpu"
    np.testing.assert_allclose(got_pdf.numpy(), want_pdf, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(got_phase.numpy(), want_phase, rtol=0, atol=TOL[dtype])


def test_tau_and_kappa_reach_the_step():
    pdf_np, phase_np = _state(5, np.float64, DOMAINS[0])
    pdf, phase = convert.from_numpy((pdf_np, phase_np), "cpu")
    got, _ = lbm_step(pdf, phase, tau=0.6, kappa=0.3, config={"variant": "ytile", "ty": 4})
    want, _ = lbm_step_ref(*pad_inputs(pdf, phase), tau=0.6, kappa=0.3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, lbm_step(pdf, phase)[0])


def test_velocities_and_weights_equal_reference():
    from repro.kernels.lbm_d3q15 import ref

    from repro_torch.core.specs import D3Q15_VELOCITIES

    assert VELOCITIES is D3Q15_VELOCITIES
    assert VELOCITIES == ref.VELOCITIES
    assert WEIGHTS == ref.WEIGHTS
    assert abs(sum(WEIGHTS) - 1.0) < 1e-15


def test_generator_ranks_every_launch_and_skips_the_ytile_variants():
    from repro.kernels.lbm_d3q15.generator import _space

    dom = (4, 32, 8)
    ranked = rank_configs(dom, 8, H100)
    assert len(ranked) == 168
    want = [cfg for cfg in _space(dom) if cfg["variant"] == "ytile"]
    assert [s.config for s in ranked.skipped] == want == [
        {"variant": "ytile", "ty": 8}, {"variant": "ytile", "ty": 16}]
    assert all(s.reason == SCRATCH_REASON for s in ranked.skipped)
    assert list(ytile_space((4, 12, 8))) == [] and list(ytile_space((4, 24, 8))) == [
        {"variant": "ytile", "ty": 8}]
    ranked.clear()  # callers get a copy; the memoized ranking is untouched
    assert len(rank_configs(dom, 8, H100)) == 168
    assert get_generator("lbm_d3q15").rank_configs is rank_configs


def test_generate_returns_the_best_launch():
    dom = DOMAINS[1]
    kern, best = generate(dom, dtype=torch.float64, device="cpu")
    assert best.launch == rank_configs(dom, 8, H100)[0].launch
    pdf, phase = convert.from_numpy(_state(3, np.float64, dom), "cpu")
    padded = pad_inputs(pdf, phase)
    torch.testing.assert_close(kern(*padded), lbm_step_ref(*padded)[0], rtol=0, atol=0)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(DOMAINS[0], device="cuda")


@pytest.mark.parametrize("config,match", [
    ({"variant": "ytile", "ty": 5}, "ty must divide Y"),
    ({"variant": "ytile", "ty": 1}, "ty must divide Y"),
    ({"variant": "bogus"}, "unknown variant"),
])
def test_lbm_step_rejects_bad_configs(config, match):
    pdf, phase = torch.zeros((15, *DOMAINS[1])), torch.zeros(DOMAINS[1])
    with pytest.raises(ValueError, match=match):
        lbm_step(pdf, phase, config=config)


def test_lbm_step_rejects_mismatched_fields():
    with pytest.raises(ValueError, match="expected pdf"):
        lbm_step(torch.zeros((14, 4, 16, 8)), torch.zeros((4, 16, 8)))
    with pytest.raises(ValueError, match="expected pdf"):
        lbm_step(torch.zeros((15, 4, 16, 8)), torch.zeros((4, 16, 9)))


def test_wrappers_validate_their_operands():
    pdf_p, ph_p = pad_inputs(torch.zeros((15, *DOMAINS[1]), dtype=torch.float64),
                             torch.zeros(DOMAINS[1], dtype=torch.float64))
    launch = LaunchConfig((8, 4, 2))
    with pytest.raises(TypeError):
        K.lbm_pointwise(pdf_p.to(torch.int32), ph_p.to(torch.int32), launch)
    with pytest.raises(TypeError):
        K.lbm_pointwise(pdf_p.numpy(), ph_p, launch)
    with pytest.raises(ValueError, match="dtype and device"):
        K.lbm_pointwise(pdf_p, ph_p.float(), launch)
    with pytest.raises(ValueError, match="expected PDFs"):
        K.lbm_pointwise(pdf_p[:14], ph_p, launch)
    with pytest.raises(ValueError, match="expected PDFs"):
        K.lbm_pointwise(pdf_p, ph_p[:, :-1], launch)
    with pytest.raises(ValueError, match="contiguous"):
        K.lbm_pointwise(pdf_p.transpose(2, 3), ph_p.transpose(1, 2), launch)
    with pytest.raises(ValueError, match="halo"):
        K.lbm_pointwise(pdf_p[:, :2].contiguous(), ph_p[:2], launch)
    with pytest.raises(ValueError, match="valid CUDA block"):
        K.lbm_pointwise(pdf_p, ph_p, LaunchConfig((64, 32, 1)))
    with pytest.raises(ValueError, match="valid CUDA block"):
        K.lbm_pointwise(pdf_p, ph_p, LaunchConfig((1, 1, 128)))
    with pytest.raises(ValueError, match="empty"):
        K.lbm_ytile(pdf_p, ph_p, 0, 32)
    with pytest.raises(ValueError, match="shared memory"):
        K.lbm_ytile(pdf_p, ph_p, 64, 256)


def test_ytile_tiles_respect_shared_memory():
    assert K.ytile_tile(8, 8) == (8, 256)
    assert K.ytile_smem_bytes(8, 256, 8) == 61_920
    assert K.ytile_tile(16, 8) == (16, 256)
    assert K.ytile_smem_bytes(16, 256, 8) == 111_456
    assert K.ytile_tile(64, 8) == (64, 128)
    assert K.ytile_tile(128, 8) == (128, 64)
    assert K.ytile_tile(64, 4) == (64, 256)
    # the rings as they run: fp64 by TMA at 3 slots, fp32 by cp.async at 4
    assert K.ytile_smem_bytes(8, 256, 8, 3, "tma") == 63_152
    assert K.ytile_smem_bytes(8, 256, 8, 4, "tma") == 84_160
    assert K.ytile_smem_bytes(8, 256, 4, 4) == 41_280
    for ty in (2, 4, 8, 16, 32, 64, 128, 256, 512):
        for eb in (4, 8):
            _, tx = K.ytile_tile(ty, eb)
            assert K.ytile_smem_bytes(ty, tx, eb) <= K.SMEM_PER_BLOCK == 232_448
            assert tx == K.YTILE_TX[0] or K.ytile_smem_bytes(ty, 2 * tx, eb) > K.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        K.ytile_tile(10_000, 8)


@pytest.mark.parametrize("domain,ty,tx,slots,grid,planes", [
    ((256, 256, 256), 8, 256, 132, 128, 64), ((256, 256, 256), 16, 256, 264, 256, 16),
    ((61, 120, 251), 8, 256, 132, 120, 8), ((3, 8, 16), 4, 256, 264, 6, 1),
    ((256, 2048, 2048), 8, 256, 132, 132, 3972)])
def test_ytile_slabs_fill_the_card(domain, ty, tx, slots, grid, planes):
    # the persistent grid: one CTA a resident slot, rounded down to a multiple
    # of the tiles where there are fewer tiles than slots; the (tile, plane)
    # steps cut into equal contiguous ranges, no CTA more than one plane
    # beyond the mean
    steps = K.ytile_steps(domain, ty, tx)
    tiles = -(-domain[1] // ty) * -(-domain[2] // tx)
    assert steps == tiles * domain[0]
    assert K.ytile_ctas(domain, ty, tx, slots) == grid <= min(slots, steps)
    assert grid % tiles == 0 or tiles > slots
    assert K.ytile_slab(domain, ty, tx, grid) == planes
    assert (planes - 1) * grid < steps <= planes * grid


def test_ytile_slabs_follow_the_sm_count():
    # fewer resident CTAs march deeper ranges; never more CTAs than steps
    assert K.ytile_ctas((256, 256, 256), 8, 256, 66) == 64
    assert K.ytile_slab((256, 256, 256), 8, 256, 64) == 128
    assert K.ytile_ctas((256, 256, 256), 8, 256, 264) == 256
    assert K.ytile_slab((256, 256, 256), 8, 256, 256) == 32
    assert K.ytile_ctas((256, 256, 256), 8, 256, 20) == 20  # fewer slots than tiles
    assert K.ytile_ctas((3, 8, 16), 4, 256, 10_000) == 6
    assert K.ytile_slab((3, 8, 16), 4, 256, 10_000) == 1


LAYOUT_TILES = [(8, 256), (16, 256), (3, 5), (2, 512), (4, 300), (64, 64), (255, 2), (1, 1)]


@pytest.mark.parametrize("eb", [4, 8])
@pytest.mark.parametrize("ty,tx", LAYOUT_TILES)
def test_ytile_layout_fits_tma_boxes(ty, tx, eb):
    lay = K.ytile_layout(ty, tx, eb, "tma")
    assert lay["rows"] == ty + 2
    assert lay["nb"] * lay["w"] >= tx > (lay["nb"] - 1) * lay["w"]
    assert lay["w"] + 2 <= lay["bw"] <= 256 and (lay["bw"] * eb) % 16 == 0
    assert lay["bw"] < lay["w"] + 2 + 16 // eb  # rounded up to 16 bytes, no further
    assert lay["sub_elems"] >= lay["rows"] * lay["bw"] and (lay["sub_elems"] * eb) % 128 == 0
    assert lay["slot_elems"] == lay["nb"] * lay["sub_elems"]
    assert K.ytile_smem_bytes(ty, tx, eb, 3, "tma") == 3 * (lay["slot_elems"] * eb + 16) + 128
    # a sub-tile is one box as wide as it can be: one fewer would not hold the tile
    assert lay["nb"] == 1 or -(-tx // (lay["nb"] - 1)) + 2 > 256


@pytest.mark.parametrize("eb", [4, 8])
@pytest.mark.parametrize("ty,tx", LAYOUT_TILES)
def test_ytile_cp_async_slot_is_one_plane(ty, tx, eb):
    # no sub-tiles, no rounding and no barriers in shared memory: the
    # previous kernel's (ty+2) x (tx+2) plane a slot
    lay = K.ytile_layout(ty, tx, eb, "cp_async")
    plane = (ty + 2) * (tx + 2)
    assert lay == {"nb": 1, "w": tx, "bw": tx + 2, "rows": ty + 2, "sub_elems": plane,
                   "slot_elems": plane}
    for stages in (3, 4, 7):
        assert K.ytile_smem_bytes(ty, tx, eb, stages, "cp_async") == stages * plane * eb
    assert K.ytile_smem_bytes(ty, tx, eb) == 3 * plane * eb


def test_ytile_layout_of_the_ranked_tiles():
    # 256 columns need 258 with the halo: two boxes of 128 output columns
    assert K.ytile_layout(8, 256, 8, "tma") == {"nb": 2, "w": 128, "bw": 130, "rows": 10,
                                                "sub_elems": 1312, "slot_elems": 2624}
    assert K.ytile_layout(16, 256, 4, "tma") == {"nb": 2, "w": 128, "bw": 132, "rows": 18,
                                                 "sub_elems": 2400, "slot_elems": 4800}
    assert K.ytile_layout(16, 256, 4, "cp_async") == {"nb": 1, "w": 256, "bw": 258,
                                                      "rows": 18, "sub_elems": 4644,
                                                      "slot_elems": 4644}


@pytest.mark.parametrize("ty,tx,xp,eb,ptr,route", [
    (8, 256, 258, 8, 0, "tma"),           # fp64 at the paper size: 2064-byte rows
    (8, 256, 258, 4, 0, "cp_async"),      # fp32 at the paper size: 1032-byte rows
    (16, 256, 252, 4, 0, "tma"),          # fp32 rows of 1008 bytes
    (8, 256, 253, 8, 0, "cp_async"),      # X = 251: 2024-byte rows
    (8, 256, 258, 8, 8, "cp_async"),      # a field not 16-byte aligned
    (254, 4, 258, 8, 512, "tma"),         # a box of 256 rows
    (255, 4, 258, 8, 512, "cp_async"),    # 257 rows: more than a box holds
    (3, 8, 12, 4, 0, "tma"),              # tiles 32 bytes apart
    (3, 5, 8, 4, 0, "cp_async"),          # tiles 20 bytes apart: boxes off 16-byte columns
    (8, 300, 304, 4, 0, "cp_async"),      # fp32 sub-tiles of 150 columns, 600 bytes apart
    (64, 128, 258, 8, 0, "tma"),          # fp64 ty 64 at the paper size: 206,384 B
    (72, 256, 258, 4, 0, "cp_async"),     # three TMA slots need 235,184 B, three planes 229,104
    (8, 960, 962, 8, 0, "cp_async")])     # 233,648 B against 230,880
def test_ytile_route_follows_row_bytes_and_alignment(ty, tx, xp, eb, ptr, route):
    assert K.ytile_route(ty, tx, xp, eb, ptr) == route


def test_ytile_route_takes_tma_only_where_its_ring_fits():
    # the TMA layout's rounding, halos and barriers cost more than the plane:
    # where three of its slots do not fit, the tile goes by cp.async
    for ty, tx, eb in ((72, 256, 4), (145, 128, 4), (6, 1196, 8), (8, 960, 8)):
        assert K.ytile_smem_bytes(ty, tx, eb, 3, "tma") > K.SMEM_PER_BLOCK
        assert K.ytile_smem_bytes(ty, tx, eb) <= K.SMEM_PER_BLOCK
        xp = tx + 32 // eb  # rows of a 16-byte multiple
        assert K.ytile_route(ty, tx, xp, eb) == "cp_async"
        assert K.ytile_route(ty // 2, tx, xp, eb) == "tma"  # half the rows do fit
        assert K.ytile_stages(ty, tx, eb, "cp_async") == 3


@pytest.mark.parametrize("eb", [4, 8])
def test_ytile_ring_fits_at_every_ranked_ty(eb):
    from repro_torch.kernels.lbm_d3q15.generator import ytile_space

    assert [c["ty"] for c in ytile_space((256, 256, 256))] == [8, 16, 32, 64, 128]
    for cfg in ytile_space((256, 256, 256)):
        ty, tx = K.ytile_tile(cfg["ty"], eb)
        route = K.ytile_route(ty, tx, 258, eb)
        stages = K.ytile_stages(ty, tx, eb, route)
        assert K.YTILE_MIN_STAGES <= stages <= K.YTILE_STAGES[eb]
        assert stages == K.YTILE_STAGES[eb] or ty >= 64  # the smoke's ty 8 and 16 at full depth
        assert K.ytile_smem_bytes(ty, tx, eb, stages, route) <= 232_448


def _parent_takes(ty, tx, eb):
    """Whether the previous ``lbm_ytile`` took the tile: its three
    (ty+2) x (tx+2) planes fit one block."""
    return 3 * (ty + 2) * (tx + 2) * eb <= 232_448


@pytest.mark.parametrize("eb", [4, 8])
def test_ytile_stages_take_every_tile_the_previous_ring_took(eb):
    # every tile the previous kernel ran, the widest of each ty and those
    # within a few bytes of the block's limit, has a route and a ring here,
    # whatever the field's row bytes and alignment; the next wider does not
    tiles = [(ty, tx) for ty in range(1, 130) for tx in (*K.YTILE_TX, 3, 5, 251, 259, 267, 300)]
    tiles += [(34, 267), (70, 267), (119, 158), (35, 259)]
    taken = 0
    for ty, tx in tiles:
        for xp, ptr in ((258, 0), (253, 0), (258, 8)):
            route = K.ytile_route(ty, tx, xp, eb, ptr)
            if _parent_takes(ty, tx, eb):
                assert K.YTILE_MIN_STAGES <= K.ytile_stages(ty, tx, eb, route) <= K.YTILE_STAGES[eb]
                taken += 1
            else:
                with pytest.raises(ValueError, match="shared memory"):
                    K.ytile_stages(ty, tx, eb, route)
    assert taken > 1000
    assert K.ytile_stages(3, 5, eb, "cp_async") == K.YTILE_STAGES[eb] == {4: 4, 8: 3}[eb]
    # fp32's four slots do not fit: three do
    assert K.ytile_stages(64, 256, 4, "cp_async") == 3
    with pytest.raises(ValueError, match="shared memory"):
        K.ytile_stages(64, 256, 8, "cp_async")


@pytest.mark.parametrize("dtype,tile", [(torch.float64, (34, 267)), (torch.float32, (70, 267)),
                                        (torch.float64, (35, 259))])
def test_ytile_wrapper_takes_the_previous_rings_largest_tiles(dtype, tile):
    # 232,416 B and 231,768 B of planes: the previous ring's edge
    eb = torch.empty((), dtype=dtype).element_size()
    assert _parent_takes(*tile, eb) and not _parent_takes(tile[0], tile[1] + 1, eb)
    pdf_p, ph_p = pad_inputs(torch.rand((15, 2, 3, 9), dtype=dtype),
                             torch.rand((2, 3, 9), dtype=dtype))
    torch.testing.assert_close(K.lbm_ytile(pdf_p, ph_p, *tile), lbm_step_ref(pdf_p, ph_p)[0],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="shared memory"):
        K.lbm_ytile(pdf_p, ph_p, tile[0], tile[1] + 1)


def test_ytile_wrapper_validates_its_pins():
    pdf_p, ph_p = pad_inputs(torch.zeros((15, 3, 8, 16), dtype=torch.float32),
                             torch.zeros((3, 8, 16), dtype=torch.float32))
    want = lbm_step_ref(pdf_p, ph_p)[0]
    # X + 2 = 18 fp32 columns: 72-byte rows, so TMA does not take the field
    with pytest.raises(ValueError, match="route 'tma'"):
        K._ytile(pdf_p, ph_p, 4, 8, route="tma")
    with pytest.raises(ValueError, match="route 'bogus'"):
        K._ytile(pdf_p, ph_p, 4, 8, route="bogus")
    for stages in (2, 8, 600):  # 3 to 7 (the named barriers), where they fit
        with pytest.raises(ValueError, match="ring slots"):
            K._ytile(pdf_p, ph_p, 4, 8, stages=stages)
    with pytest.raises(ValueError, match="ring slots"):
        K._ytile(pdf_p, ph_p, 64, 256, stages=4)  # 272,448 B
    for ctas in (0, 13):  # 2 x 2 tiles x 3 planes = 12 steps
        with pytest.raises(ValueError, match="CTAs"):
            K._ytile(pdf_p, ph_p, 4, 8, ctas=ctas)
    got = K._ytile(pdf_p, ph_p, 4, 8, route="cp_async", stages=7, ctas=12)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a pin may go past the default ring depth where it fits
    pdf64, ph64 = pdf_p.double(), ph_p.double()
    assert K.ytile_stages(8, 256, 8, "cp_async") == 3
    torch.testing.assert_close(K._ytile(pdf64, ph64, 8, 256, stages=4),
                               lbm_step_ref(pdf64, ph64)[0], rtol=0, atol=0)
    # the entry point takes no pins
    assert list(inspect.signature(K.lbm_ytile).parameters) == [
        "pdf_p", "phase_p", "ty", "tx", "tau", "kappa"]


# ---------------------------------------------------------------------------
# On the card: every CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_case(cuda, dtype, shape, seed=0):
    """Padded fields with independent random PDFs (so that a pull from the
    wrong cell shows) and the plain version's new PDFs."""
    rng = np.random.default_rng(seed)
    phase = torch.from_numpy(1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).to(cuda, dtype)
    pdf = torch.from_numpy(rng.random((15, *shape))).to(cuda, dtype)
    pdf_p, phase_p = pad_inputs(pdf, phase)
    return pdf, phase, pdf_p, phase_p, lbm_step_ref(pdf_p, phase_p)[0]


GPU_TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12), torch.float32: dict(rtol=1e-5, atol=1e-5)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(13, 37, 70), (16, 32, 64)])
def test_card_pointwise_matches_plain_at_every_launch(cuda, dtype, shape):
    _, _, pdf_p, phase_p, want = _card_case(cuda, dtype, shape)
    for launch in enumerate_gpu_configs():
        before = K.LAUNCHES["lbm_pointwise"]
        got = K.lbm_pointwise(pdf_p, phase_p, launch)
        torch.cuda.synchronize()
        assert K.LAUNCHES["lbm_pointwise"] == before + 1
        assert K.LAST_LAUNCH["lbm_pointwise"] == launch
        torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=str(launch))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(13, 37, 70), (9, 48, 40), (40, 16, 300)])
def test_card_ytile_matches_plain(cuda, dtype, shape):
    _, _, pdf_p, phase_p, want = _card_case(cuda, dtype, shape)
    eb = torch.empty((), dtype=dtype).element_size()
    for tile in {K.ytile_tile(8, eb), K.ytile_tile(16, eb), K.ytile_tile(64, eb), (3, 5)}:
        before = K.LAUNCHES["lbm_ytile"]
        got = K.lbm_ytile(pdf_p, phase_p, *tile, tau=0.7, kappa=0.2)
        torch.cuda.synchronize()
        assert K.LAUNCHES["lbm_ytile"] == before + 1
        want_t = lbm_step_ref(pdf_p, phase_p, 0.7, 0.2)[0]
        torch.testing.assert_close(got, want_t, **GPU_TOL[dtype], msg=str(tile))


# (Z, Y, X): X = 251 is no tile width's multiple and takes cp.async only
# (2024-byte fp64 rows); X = 250 takes TMA in both dtypes (1008- and
# 2016-byte rows); Y = 120 leaves the last 16-row tile half full; Z = 61
YTILE_EDGE_SHAPES = [(61, 120, 251), (61, 120, 250), (16, 32, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", YTILE_EDGE_SHAPES)
def test_card_ytile_routes_and_tiles(cuda, dtype, shape):
    # both routes wherever TMA takes the field, at the ranked tiles and others
    _, _, pdf_p, phase_p, want = _card_case(cuda, dtype, shape, seed=1)
    eb = torch.empty((), dtype=dtype).element_size()
    ran = set()
    for ty, tx in ((8, 256), (16, 256), (8, 128), (3, 5)):
        rule = K.ytile_route(ty, tx, shape[2] + 2, eb, phase_p.data_ptr())
        for route in ("tma", "cp_async") if rule == "tma" else ("cp_async",):
            got = K._ytile(pdf_p, phase_p, ty, tx, route=route)
            torch.cuda.synchronize()
            last = dict(K.LAST_YTILE)
            assert last["route"] == route and last["tile"] == (ty, tx)
            assert last["stages"] == K.ytile_stages(ty, tx, eb, route)
            torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=f"{(ty, tx)} {route}")
            ran.add(route)
    assert ran == ({"tma", "cp_async"} if (shape[2] + 2) * eb % 16 == 0 else {"cp_async"})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_card_ytile_grid_and_stages(cuda, dtype):
    # one CTA for the whole domain, ranges that cross tile boundaries, and one
    # output plane a CTA (a one-plane slab), at 3 and 4 ring slots
    shape = (61, 120, 250)
    _, _, pdf_p, phase_p, want = _card_case(cuda, dtype, shape, seed=2)
    eb = torch.empty((), dtype=dtype).element_size()
    for ty, tx in ((8, 256), (16, 256), (3, 5)):
        steps = K.ytile_steps(shape, ty, tx)
        rule = K.ytile_route(ty, tx, shape[2] + 2, eb, phase_p.data_ptr())
        for ctas in (1, 7, steps):
            for stages in (3, 4):
                for route in ("tma", "cp_async") if rule == "tma" else ("cp_async",):
                    got = K._ytile(pdf_p, phase_p, ty, tx, route=route, stages=stages, ctas=ctas)
                    torch.cuda.synchronize()
                    assert K.LAST_YTILE["ctas"] == ctas and K.LAST_YTILE["stages"] == stages
                    torch.testing.assert_close(got, want, **GPU_TOL[dtype],
                                               msg=f"{(ty, tx)} {route} {ctas} CTAs {stages}")
        K.lbm_ytile(pdf_p, phase_p, ty, tx)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        smem = K.ytile_smem_bytes(ty, tx, eb, K.ytile_stages(ty, tx, eb, rule), rule)
        slots = K._ytile_slots(cuda.index or 0, eb, smem)
        assert slots >= sms and K.LAST_YTILE["ctas"] == K.ytile_ctas(shape, ty, tx, slots)
    # a wide tile at three slots (fp32's four do not fit)
    _, _, pdf_p, phase_p, want = _card_case(cuda, dtype, (5, 64, 130), seed=3)
    tile = K.ytile_tile(64, eb)
    assert tile == ((64, 128) if eb == 8 else (64, 256))
    got = K.lbm_ytile(pdf_p, phase_p, *tile)
    torch.cuda.synchronize()
    assert K.LAST_YTILE["stages"] == 3
    torch.testing.assert_close(got, want, **GPU_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tile,shape", [
    (torch.float64, (34, 267), (4, 40, 270)),    # 232,416 B of planes: the previous limit
    (torch.float32, (70, 267), (3, 75, 270)),    # the same bytes in fp32
    (torch.float32, (72, 256), (3, 80, 258))])   # TMA takes the rows, its ring does not fit
def test_card_ytile_runs_the_previous_rings_largest_tiles(cuda, dtype, tile, shape):
    _, _, pdf_p, phase_p, want = _card_case(cuda, dtype, shape, seed=4)
    got = K.lbm_ytile(pdf_p, phase_p, *tile)
    torch.cuda.synchronize()
    assert K.LAST_YTILE["route"] == "cp_async" and K.LAST_YTILE["stages"] == 3
    torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=str(tile))


@pytest.mark.gpu
def test_card_ytile_launcher_refuses_what_the_route_cannot_take(cuda):
    # the C launcher holds the layout to its route before it launches; the
    # occupancy query holds one CTA an SM or more at the ranked tiles
    _, _, pdf_p, phase_p, _ = _card_case(cuda, torch.float64, (4, 16, 256))
    out = torch.empty((15, 4, 16, 256), dtype=torch.float64, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    lib = K._lib()
    tma, cp = K.ytile_layout(8, 256, 8, "tma"), K.ytile_layout(8, 256, 8, "cp_async")
    for lay, route, stages, ok in ((tma, 0, 3, True), (cp, 1, 3, True), (cp, 1, 7, True),
                                   (tma, 1, 3, False), (cp, 0, 3, False), (cp, 1, 8, False),
                                   (cp, 1, 2, False)):
        rc = lib.lbm_ytile_launch(8, pdf_p.data_ptr(), phase_p.data_ptr(), out.data_ptr(),
                                  4, 16, 256, 8, 256, lay["nb"], lay["w"], lay["bw"],
                                  lay["sub_elems"], stages, route, 1, 0.8, 0.15, stream)
        torch.cuda.synchronize()
        assert (rc == 0) == ok, (lay, route, stages, rc)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for eb in (4, 8):
        for ty in (8, 16):
            ty, tx = K.ytile_tile(ty, eb)
            route = K.ytile_route(ty, tx, 258, eb)
            smem = K.ytile_smem_bytes(ty, tx, eb, K.ytile_stages(ty, tx, eb, route), route)
            assert K._ytile_slots(cuda.index or 0, eb, smem) >= sms


@pytest.mark.gpu
def test_card_entry_point_runs_the_ranked_launch(cuda):
    pdf, phase, pdf_p, phase_p, want = _card_case(cuda, torch.float64, (16, 32, 64))
    K.reset_launch_counts()
    got, got_phase = lbm_step(pdf, phase)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"lbm_pointwise": 1, "lbm_ytile": 0}
    best = rank_configs((16, 32, 64), 8, H100)[0]
    assert K.LAST_LAUNCH["lbm_pointwise"] == best.launch
    torch.testing.assert_close(got, want, **GPU_TOL[torch.float64])
    torch.testing.assert_close(got_phase, want.sum(0), **GPU_TOL[torch.float64])
    kern, best = generate((16, 32, 64), device=cuda)
    torch.testing.assert_close(kern(pdf_p, phase_p), want, **GPU_TOL[torch.float64])
    with pytest.raises(ValueError):
        kern(pdf_p.cpu(), phase_p.cpu())
