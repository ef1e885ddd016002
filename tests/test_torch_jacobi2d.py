"""The port's Jacobi sweep against the JAX package's Pallas kernels.

The same numpy inputs go through ``repro``'s Pallas kernels (interpret mode,
pinned variants, padded as ``repro.kernels.jacobi2d.ops`` pads them) and
through ``repro_torch`` (``convert.from_numpy``).  On the CPU the port's
wrappers run their plain versions; the CUDA kernels themselves are compared
with those plain versions by the ``gpu``-marked tests, which skip without a
card.
"""
import ctypes

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


@pytest.mark.parametrize("dtype,X,tx,data_ptr,route", [
    (torch.float32, 4096, 256, 0, "cp_async"),   # 16,392-byte rows: 8 bytes off 16
    (torch.float64, 4096, 256, 0, "tma"),        # 32,784-byte rows
    (torch.float64, 4096, 256, 8, "cp_async"),   # the field's address off 16 bytes
    (torch.float64, 4096, 5, 0, "cp_async"),     # strips start 40 bytes apart
    (torch.float64, 2043, 256, 0, "cp_async"),   # odd X: 16,360-byte rows
    (torch.float32, 2043, 256, 0, "cp_async"),   # 8,180-byte rows
    (torch.float32, 4094, 256, 0, "tma"),        # 16,384-byte rows
    (torch.float32, 4094, 5, 0, "cp_async"),     # strips start 20 bytes apart
])
def test_ytile_route_sends_unaligned_rows_and_strips_to_cp_async(dtype, X, tx, data_ptr, route):
    eb = torch.empty((), dtype=dtype).element_size()
    assert K.ytile_route(tx, X + 2, eb, data_ptr) == route
    # a slot row keeps its field row's alignment modulo 16, with room for the
    # 16-byte pieces around the strip's tx + 2 columns
    pitch = K.ytile_row_bytes(tx, eb, X + 2)
    assert (pitch - (X + 2) * eb) % 16 == 0 and pitch % eb == 0
    assert (tx + 2) * eb + 16 <= pitch < (tx + 2) * eb + 48


@pytest.mark.parametrize("domain,ty,tx,ctas", [
    ((4096, 4096), 8, 256, 264), ((4096, 4096), 16, 256, 132), ((37, 70), 8, 256, 2),
    ((37, 70), 8, 256, 5), ((1008, 2043), 16, 256, 7), ((48, 300), 3, 5, 13),
    ((16, 1000), 128, 128, 1)])
def test_ytile_ranges_cover_every_tile_once(domain, ty, tx, ctas):
    Y, X = domain
    steps = K.ytile_steps(domain, ty, tx)
    assert steps == -(-Y // ty) * -(-X // tx)
    ranges = K.ytile_ranges(steps, ctas)
    assert len(ranges) == ctas and ranges[0][0] == 0 and ranges[-1][1] == steps
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # contiguous
    sizes = [e - b for b, e in ranges]
    assert max(sizes) - min(sizes) <= 1  # equal, to a step
    seen = []
    for b, e in ranges:
        segs = K.ytile_segments(domain, ty, tx, b, e)
        assert sum(-(-n // ty) for _, _, n in segs) == e - b
        assert len(segs) <= 1 + (e - b) // -(-Y // ty) + 1
        for x0, y0, n in segs:
            assert x0 % tx == 0 and y0 % ty == 0 and 1 <= n and y0 + n <= Y
            seen += [(x0, y) for y in range(y0, y0 + n)]
    assert sorted(seen) == [(x0, y) for x0 in range(0, X, tx) for y in range(Y)]


def test_ytile_strips_are_at_most_256_columns():
    assert [K.ytile_strip(tx) for tx in (1, 5, 256, 257, 300, 512, 513, 1000)] == [
        1, 5, 256, 129, 150, 256, 171, 250]


def test_ytile_ctas_and_threads():
    # a multiple of the strips, so that the CTAs of a y-range run side by side
    assert K.ytile_ctas(8192, 264, 16) == 256 and K.ytile_ctas(4096, 264, 16) == 256
    assert K.ytile_ctas(5, 264, 1) == 5 and K.ytile_ctas(1, 0, 1) == 1
    assert K.ytile_ctas(100, 264, 20) == 100 and K.ytile_ctas(9000, 264, 300) == 264
    # then CTA j of each strip starts at the same row: the strips' CTAs go side by side
    starts = [K.ytile_segments((4096, 4096), 8, 256, b, e) for b, e in K.ytile_ranges(8192, 256)]
    assert all(len(seg) == 1 for seg in starts)
    assert [[seg[0][:2] for seg in starts[j::16]] for j in range(16)] == [
        [(x0, 256 * j) for x0 in range(0, 4096, 256)] for j in range(16)]
    assert [K.ytile_threads(tx) for tx in (1, 5, 32, 33, 128, 256)] == [64, 64, 64, 96, 160, 288]
    assert [K.ytile_threads(tx, 2) for tx in (2, 64, 66, 256)] == [64, 64, 96, 160]


@pytest.mark.parametrize("tx,X,eb,data_ptr,columns", [
    (256, 4096, 4, 0, 2), (256, 4096, 8, 0, 2),  # the paper size: pairs of 8 and 16 bytes
    (256, 2043, 4, 0, 1),                         # odd X: a row's last column has no pair
    (5, 4096, 8, 0, 1),                           # odd strips
    (256, 4096, 4, 4, 1), (256, 4096, 8, 8, 1),   # the field one element off a pair
    (150, 300, 8, 16, 2)])
def test_ytile_columns_pairs_only_aligned_fields(tx, X, eb, data_ptr, columns):
    assert K.ytile_columns(tx, X, eb, data_ptr) == columns


def test_ytile_plan_keeps_ty_rows_a_slot_where_the_ring_fits():
    two_ctas = K.SMEM_PER_SM // K.YTILE_CTAS_PER_SM - K.SMEM_RESERVED
    # the paper size's tiles: ty rows a slot, two CTAs an SM
    assert K.ytile_plan(8, 256, 4, 4098) == (8, 4) and K.ytile_plan(16, 256, 4, 4098) == (16, 4)
    assert K.ytile_plan(8, 256, 8, 4098) == (8, 4) and K.ytile_plan(16, 256, 8, 4098) == (16, 3)
    assert K.ytile_row_bytes(256, 8, 4098) == 2080 and K.ytile_row_bytes(256, 4, 4098) == 1064
    assert K.ytile_ring_bytes(16, 256, 8, 3, 4098) == 3 * (16 * 2080 + 32 + 16) <= two_ctas
    # (128, 128) in fp64 fits one staged tile but not two ring slots of 128 rows
    rows, stages = K.ytile_plan(*K.ytile_tile(128, 8), 8, 130)
    assert (rows, stages) == (27, K.YTILE_STAGES)
    for ty in (1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 512):
        for eb in (4, 8):
            for xp in (130, 2045, 4096, 4098):
                ty_, tx = K.ytile_tile(ty, eb)
                rows, stages = K.ytile_plan(ty, tx, eb, xp)
                assert 2 <= rows <= max(2, ty)  # a slot holds a centre row and the row above
                assert K.YTILE_MIN_STAGES <= stages <= K.YTILE_MAX_STAGES
                assert K.ytile_ring_bytes(rows, tx, eb, stages, xp) <= two_ctas
                assert rows == max(2, ty) or K.ytile_ring_bytes(
                    ty, tx, eb, K.YTILE_MIN_STAGES, xp) > two_ctas


def test_pointwise_offset_width_and_fold_instances():
    # one offset width, 64 bits, in every instantiation; the ablation's edits
    # (32-bit offsets among them) each find their text once in the source
    from repro_torch.kernels import _build
    from repro_torch.kernels.jacobi2d import ablate

    text = (_build.CSRC / "jacobi2d.cu").read_text()
    assert text.count("using PointOffset = int64_t;") == 1
    assert K._SIGNATURES["jacobi_pointwise_launch"][5:13] == [ctypes.c_int] * 8
    for name, (edits, _) in ablate.source_variants().items():
        assert all(text.count(old) == 1 for old, _ in edits), name
    rows = {f: K.pointwise_fold_rows(LaunchConfig((32, 4, 1), f))
            for f in [(1, 1, 1), (1, 2, 1), (1, 1, 2), (2, 1, 1), (1, 3, 1), (2, 2, 2), (1, 2, 2)]}
    assert rows == {(1, 1, 1): 1, (1, 2, 1): 2, (1, 1, 2): 1, (2, 1, 1): 0, (1, 3, 1): 0,
                    (2, 2, 2): 0, (1, 2, 2): 2}
    # every priced launch runs a compile-time fold
    assert all(K.pointwise_fold_rows(launch) for launch in enumerate_gpu_configs())


def test_wrappers_validate_the_new_arguments():
    padded = pad_input(torch.zeros((37, 70), dtype=torch.float64))
    launch = LaunchConfig((1024, 1, 1), (1, 2, 1))
    with pytest.raises(ValueError, match="route"):
        K._ytile(padded, 8, 256, route="bogus")
    odd = pad_input(torch.zeros((37, 69), dtype=torch.float32))  # 284-byte rows: not TMA
    with pytest.raises(ValueError, match="does not take this field"):
        K._ytile(odd, 8, 256, route="tma")
    for stages in (1, K.YTILE_MAX_STAGES + 1):
        with pytest.raises(ValueError, match="ring slots"):
            K._ytile(padded, 8, 256, stages=stages)
    with pytest.raises(ValueError, match="ring slots"):  # 8 slots of 16 fp64 rows: 264,320 B
        K._ytile(padded, 16, 256, stages=K.YTILE_MAX_STAGES)
    for ctas in (0, K.ytile_steps((37, 70), 8, 256) + 1):
        with pytest.raises(ValueError, match="CTAs"):
            K._ytile(padded, 8, 256, ctas=ctas)
    for columns in (0, 3):
        with pytest.raises(ValueError, match="columns"):
            K._ytile(padded, 8, 256, columns=columns)
    with pytest.raises(ValueError, match="columns"):  # odd X: no pairs
        K._ytile(pad_input(torch.zeros((37, 69), dtype=torch.float64)), 8, 256, columns=2)
    # pinned choices that the field takes run (the plain version on the CPU)
    want = jacobi_padded_ref(padded)
    for kw in ({"route": "cp_async"}, {"stages": 2}, {"ctas": 5}, {"route": None, "ctas": 1},
               {"columns": 1}, {"columns": 2}):
        torch.testing.assert_close(K._ytile(padded, 8, 256, **kw), want, rtol=0, atol=0)
    torch.testing.assert_close(K.jacobi_pointwise(padded, launch), want, rtol=0, atol=0)


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


# launches of every jacobi_pointwise instantiation: the compile-time folds
# (fy 1 and 2, fz 1 and 2) and the generic one
FOLD_LAUNCHES = [LaunchConfig((1024, 1, 1), (1, 2, 1)), LaunchConfig((32, 32, 1), (1, 1, 1)),
                 LaunchConfig((16, 8, 8), (1, 1, 2)), LaunchConfig((8, 16, 8), (1, 2, 2)),
                 LaunchConfig((64, 16, 1), (2, 1, 1)), LaunchConfig((32, 4, 2), (1, 3, 1)),
                 LaunchConfig((128, 2, 2), (2, 2, 2))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(37, 70), (1, 2043), (100, 1)])
def test_card_pointwise_fold_instances_and_offsets(cuda, dtype, shape):
    _, padded, want = _card_case(cuda, dtype, shape, seed=3)
    for launch in FOLD_LAUNCHES:
        got = K.jacobi_pointwise(padded, launch, (0.4, 0.15))
        torch.cuda.synchronize()
        assert K.LAST_POINTWISE == {"fold_rows": K.pointwise_fold_rows(launch)}
        torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=str(launch))


@pytest.mark.gpu
def test_card_past_2_31_elements(cuda):
    """A field of more than 2^31 padded elements: both kernels agree with the
    plain version on the first and the last rows (the last lie past a 32-bit
    offset)."""
    Y = X = 46_341  # padded 46,343^2 = 2,147,673,649 elements
    torch.manual_seed(0)
    padded = torch.randn((Y + 2, X + 2), dtype=torch.float32, device=cuda)
    assert padded.numel() > 2**31
    launch = rank_configs((4096, 4096), 4, H100)[0].launch
    for run in (lambda: K.jacobi_pointwise(padded, launch, (0.4, 0.15)),
                lambda: K.jacobi_ytile(padded, *K.ytile_tile(8, 4), (0.4, 0.15))):
        got = run()
        torch.cuda.synchronize()
        for rows in (slice(0, 66), slice(Y - 64, Y + 2)):
            want = jacobi_padded_ref(padded[rows], (0.4, 0.15))
            band = got[rows.start:rows.start + want.shape[0]]
            torch.testing.assert_close(band, want, **GPU_TOL[torch.float32])
        del got
    assert K.LAST_POINTWISE == {"fold_rows": K.pointwise_fold_rows(launch)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,ty,pins", [
    ((37, 70), 8, {"ctas": 2}),        # 5 tiles on 2 CTAs; a strip narrower than tx
    ((37, 70), 8, {"ctas": 5}),        # a range of one tile each
    ((1008, 2043), 16, {}),            # odd X; the field's own CTA count
    ((1008, 2043), 8, {"ctas": 7}),    # ranges that cross strips
    ((64, 512), 8, {"stages": 2}),
    ((64, 512), 16, {"stages": 6, "ctas": 3}),
    ((64, 512), 8, {"route": "cp_async"}),
    ((300, 96), 128, {}),              # the generic ring: slots of fewer rows than ty
    ((37, 69), 8, {"offset": 1}),      # a field one element off 16 bytes, its end too
    ((37, 700), (4, 300), {}),         # a tile wider than a CTA's 256 consumers: two strips
    ((64, 512), 8, {"columns": 1}),    # one column a consumer on a field that takes pairs
    ((1, 2), 8, {}),                   # one pair, one row
])
def test_card_ytile_march_matches_plain(cuda, dtype, shape, ty, pins):
    _, padded, want = _card_case(cuda, dtype, shape, seed=5)
    if pins.get("offset"):  # the same field at an address one element further on
        pins = {k: v for k, v in pins.items() if k != "offset"}
        buf = torch.empty(padded.numel() + 1, dtype=dtype, device=cuda)
        buf[1:].copy_(padded.flatten())
        padded = buf[1:].view(padded.shape)
        assert padded.data_ptr() % 16 and padded.is_contiguous()
    eb = torch.empty((), dtype=dtype).element_size()
    tile = ty if isinstance(ty, tuple) else K.ytile_tile(ty, eb)
    got = K._ytile(padded, *tile, (0.4, 0.15), **pins)
    torch.cuda.synchronize()
    ring = dict(K.LAST_YTILE)
    strip = K.ytile_strip(tile[1])
    assert ring["tile"] == tile and ring["strip"] == strip and ring["route"] == pins.get(
        "route", K.ytile_route(strip, shape[1] + 2, eb, padded.data_ptr()))
    assert ring["ctas"] == pins.get("ctas", ring["ctas"]) and ring["stages"] == pins.get(
        "stages", K.ytile_plan(tile[0], strip, eb, shape[1] + 2)[1])
    assert ring["columns"] == pins.get(
        "columns", K.ytile_columns(strip, shape[1], eb, padded.data_ptr()))
    torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=str((tile, ring)))
