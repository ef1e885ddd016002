"""The port's TPU ranking stack (``core.tpu_adapt.select_pallas_config``,
``Explorer._rank_pallas``, ``fetch_count_oracle``), ``run_tasks``, the
names ``repro_torch.core`` exports and the estimator helpers the port once
trimmed, each held to the reference's.

The reference's generators trace their Pallas kernels with a tracer that
patches ``pl.load`` and ``pl.store``, which jax 0.9.0 no longer has: the
``ref_tracer`` fixture gives it a test-only shim to patch (as
``tests/test_torch_frontend.py`` does) and clears the caches it fills.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from hypothesis_compat import given, settings, st  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import repro.core as ref_core  # noqa: E402
from repro.core import access as ref_access  # noqa: E402
from repro.core import footprint as ref_footprint  # noqa: E402
from repro.core import isets as ref_isets  # noqa: E402
from repro.core import machines as ref_machines  # noqa: E402
from repro.core import tpu_adapt as ref_tpu  # noqa: E402
from repro.core.engine import Explorer as RefExplorer  # noqa: E402
from repro.serve import schema as ref_schema  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch.core import access, footprint, isets, machines, tpu_adapt  # noqa: E402
from repro_torch.core.engine import Explorer, TaskPool, run_tasks  # noqa: E402
from repro_torch.core.wave import linear_block_range_boxes  # noqa: E402
from repro_torch.serve import schema  # noqa: E402

#: what a sweep measures of itself, which two sweeps need not agree on
MEASURED = ("wall_time_s", "cache_stats", "metrics")


@pytest.fixture
def ref_tracer(monkeypatch):
    """The reference's tracer, runnable on jax 0.9.0 (a test-only shim for
    the ``pl.load`` / ``pl.store`` it patches); its caches cleared after."""
    from repro.kernels.lbm_d3q15 import generator as ref_lbm
    from repro.kernels.jacobi2d import generator as ref_jacobi
    from repro.kernels.matmul import generator as ref_mm
    from repro.kernels.stencil3d25 import generator as ref_st
    from repro.kernels.transpose_pad import generator as ref_tr

    def load(ref, idx):
        return ref[idx]

    def store(ref, idx, val):
        ref[idx] = val

    monkeypatch.setattr(pl, "load", load, raising=False)
    monkeypatch.setattr(pl, "store", store, raising=False)
    yield
    for module in (ref_st, ref_mm, ref_lbm, ref_jacobi, ref_tr):
        module._candidates.cache_clear()


def _answer(obj, codec):
    """``codec.encode(obj)`` without the sweep's measurements of itself."""
    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items() if k not in MEASURED}
        if isinstance(node, list):
            return [strip(x) for x in node]
        return node
    return strip(codec.encode(obj))


def _ranked_equal(mine, ref):
    """Two ``select_pallas_config`` results equal: configs in order, specs on
    the wire, estimates field by field and through the codec."""
    assert [r.config for r in mine] == [r.config for r in ref]
    for a, b in zip(mine, ref):
        assert isinstance(a, tpu_adapt.RankedPallasConfig)
        assert schema.encode(a.spec) == ref_schema.encode(b.spec)
        assert dataclasses.astuple(a.estimate) == dataclasses.astuple(b.estimate)
        assert schema.encode(a.estimate) == ref_schema.encode(b.estimate)


# ==========================================================================
# revisit analysis: the closed form against both packages' grid walks
# ==========================================================================
@given(st.lists(st.integers(1, 5), min_size=1, max_size=4), st.data(), st.booleans())
@settings(max_examples=120, deadline=None)
def test_fetch_count_matches_both_grid_walks(grid, data, revisit):
    grid = tuple(grid)
    nd = len(grid)
    deps = tuple(sorted(data.draw(st.sets(st.integers(0, nd - 1), max_size=nd))))
    fn = lambda *idx: tuple(idx[d] for d in deps)  # noqa: E731
    want = ref_tpu.fetch_count_oracle(grid, fn, revisit)
    assert tpu_adapt.fetch_count_oracle(grid, fn, revisit) == want
    assert tpu_adapt.fetch_count(grid, deps, revisit) == want


def test_fetch_count_oracle_on_an_empty_grid():
    assert tpu_adapt.fetch_count_oracle((0, 3), lambda i, j: (i,)) == 0
    assert ref_tpu.fetch_count_oracle((0, 3), lambda i, j: (i,)) == 0


# ==========================================================================
# select_pallas_config and Explorer._rank_pallas
# ==========================================================================
def _candidates(pkg):
    """A small hand-built space with a VMEM-infeasible candidate and two
    candidates of equal time (the tie broken by VMEM footprint)."""
    t = pkg.tpu_adapt if hasattr(pkg, "tpu_adapt") else pkg
    out = []
    for rows in (128, 256, 512, 8192):
        out.append(({"rows": rows}, t.PallasKernelSpec(
            name="copy", grid=(8192 // rows,),
            operands=(t.OperandSpec("x", (rows, 8192), 4, grid_deps=(0,)),
                      t.OperandSpec("y", (rows, 8192), 4, grid_deps=(0,), is_output=True)),
            work_per_step=float(rows * 8192))))
    out.append(({"rows": 256, "scratch": 1}, t.PallasKernelSpec(
        name="copy", grid=(32,),
        operands=(t.OperandSpec("x", (256, 8192), 4, grid_deps=(0,)),
                  t.OperandSpec("y", (256, 8192), 4, grid_deps=(0,), is_output=True)),
        scratch_bytes=4096, work_per_step=float(256 * 8192))))
    return out


@pytest.mark.parametrize("top_k", [None, 1, 2])
def test_select_pallas_config_equals_reference(top_k):
    mine = tpu_adapt.select_pallas_config(_candidates(tpu_adapt), machines.TPU_V5E, top_k=top_k)
    ref = ref_tpu.select_pallas_config(_candidates(ref_tpu), ref_machines.TPU_V5E, top_k=top_k)
    _ranked_equal(mine, ref)
    assert {"rows": 8192} not in [r.config for r in mine]
    assert len(mine) == (top_k or 4)


def test_rank_pallas_report_equals_reference_and_shares_the_engine():
    engine = Explorer()
    mine = engine._rank_pallas(_candidates(tpu_adapt), machines.TPU_V5E)
    ref = RefExplorer()._rank_pallas(_candidates(ref_tpu), ref_machines.TPU_V5E)
    assert _answer(mine, schema) == _answer(ref, ref_schema)
    assert [(s.config, s.reason) for s in mine.skipped] == [
        (s.config, s.reason) for s in ref.skipped]
    assert [s.config for s in mine.skipped] == [{"rows": 8192}]
    assert "VMEM" in mine.skipped[0].reason
    # a shared engine prices the same specs from its cache
    again = tpu_adapt.select_pallas_config(_candidates(tpu_adapt), engine=engine)
    assert [r.config for r in again] == [e.config for e in mine.entries]
    named = engine._rank_pallas(_candidates(tpu_adapt), workload="mine")
    assert {e.workload for e in named.entries} == {"mine"}
    empty = engine._rank_pallas([])
    assert empty.entries == [] and tpu_adapt.select_pallas_config([]) == []


def test_select_pallas_config_through_a_pooled_engine_equals_serial():
    serial = tpu_adapt.select_pallas_config(_candidates(tpu_adapt))
    pooled = tpu_adapt.select_pallas_config(_candidates(tpu_adapt),
                                            engine=Explorer(parallel=True, max_workers=2))
    assert [(r.config, dataclasses.astuple(r.estimate)) for r in pooled] == [
        (r.config, dataclasses.astuple(r.estimate)) for r in serial]


@pytest.mark.parametrize("r,domain", [(4, (128, 512, 512)), (4, (128, 4096, 4096))])
def test_stencil_selector_prefers_ring_until_lc_breaks(r, domain, ref_tracer):
    """The reference's selector case (``tests/test_tpu_adapt.py``) on the
    port's declared space, equal to the reference's traced ranking."""
    from repro.kernels.stencil3d25.generator import rank_configs
    from repro_torch.kernels.stencil3d25.generator import tpu_rank_configs

    mine = tpu_rank_configs(r, domain, elem_bytes=8)
    _ranked_equal(mine, rank_configs(r, domain, elem_bytes=8))
    if domain[1] == 512:
        assert mine[0].config["variant"] == "ring"
    else:
        assert mine[0].config["variant"] == "ytile_ring"
        assert all(rc.config["variant"] != "ring" for rc in mine)


def test_matmul_selector_prefers_bigger_blocks(ref_tracer):
    from repro.kernels.matmul.generator import rank_configs
    from repro_torch.kernels.matmul.generator import tpu_rank_configs

    mine = tpu_rank_configs(4096, 4096, 4096, elem_bytes=2)
    _ranked_equal(mine, rank_configs(4096, 4096, 4096, elem_bytes=2))
    best, worst = mine[0], mine[-1]
    assert best.estimate.total_time < worst.estimate.total_time
    assert best.config["bm"] * best.config["bn"] > worst.config["bm"] * worst.config["bn"]


def test_estimate_hbm_volume_ring_vs_replane(ref_tracer):
    from repro.kernels.stencil3d25.generator import candidate_specs
    from repro_torch.kernels.stencil3d25.generator import tpu_candidate_specs

    def volumes(cands, estimate):
        specs = {c["variant"]: s for c, s in cands if c.get("ty") in (None, 16)}
        return estimate(specs["ring"]).hbm_bytes, estimate(specs["replane"]).hbm_bytes

    ring, replane = volumes(tpu_candidate_specs(4, (64, 256, 256), 8), tpu_adapt.estimate_pallas)
    assert (ring, replane) == volumes(candidate_specs(4, (64, 256, 256), 8),
                                      ref_tpu.estimate_pallas)
    assert replane > 4 * ring


# ==========================================================================
# run_tasks
# ==========================================================================
def _square(x):
    return x * x


def _fail(x):
    raise ValueError(f"no {x}")


def test_run_tasks_serial_equals_parallel():
    calls = [(_square, (i,)) for i in range(40)] + [(_fail, (3,))]
    serial = run_tasks(calls)
    assert serial[:40] == [("ok", i * i) for i in range(40)]
    assert serial[40][0] == "err" and str(serial[40][1]) == "no 3"
    parallel = run_tasks(calls, parallel=True, max_workers=2)
    assert [o if o[0] == "ok" else (o[0], str(o[1])) for o in parallel] == [
        o if o[0] == "ok" else (o[0], str(o[1])) for o in serial]
    with TaskPool() as pool:
        assert pool.run(calls[:5]) == run_tasks(calls[:5])
    assert run_tasks([]) == []


# ==========================================================================
# the names repro_torch.core exports
# ==========================================================================
def test_core_exports_every_reference_name_but_the_jax_one():
    assert set(ref_core.__all__) - {"analyze_compiled"} <= set(core.__all__)
    assert "analyze_cost" in core.__all__
    for name in core.__all__:
        assert getattr(core, name) is not None, name
    assert core.select_pallas_config is tpu_adapt.select_pallas_config
    assert core.TPU_V5E is machines.TPU_V5E and core.TPU_V5E.name == ref_core.TPU_V5E.name


# ==========================================================================
# the estimator helpers the port once trimmed
# ==========================================================================
def _ap(mod):
    return st.builds(mod.APRange, start=st.integers(-10, 10), step=st.integers(1, 3),
                     n=st.integers(0, 8))


def _to_ref(b):
    return tuple(ref_isets.APRange(r.start, r.step, r.n) for r in b)


@given(st.lists(st.tuples(_ap(isets), _ap(isets)), min_size=1, max_size=5))
@settings(max_examples=60, deadline=None)
def test_box_helpers_equal_reference(boxes):
    """``tests/test_isets.py``'s brute-force check, on both packages: the
    points of each box, their count, and the union's count."""
    want = set()
    for b in boxes:
        pts = list(isets.box_points(b))
        assert pts == list(ref_isets.box_points(_to_ref(b)))
        assert isets.box_count(b) == ref_isets.box_count(_to_ref(b)) == len(pts)
        assert isets.box(*b) == b
        want |= set(pts)
    assert isets.count_union(boxes) == len(want)
    assert access.domain_points_of_boxes(boxes) == ref_access.domain_points_of_boxes(
        [_to_ref(b) for b in boxes])


def test_box_interval_equals_reference():
    bounds = ((0, 3), (-2, 5), (7, 6))
    mine, ref = isets.box_interval(*bounds), ref_isets.box_interval(*bounds)
    assert [(r.start, r.step, r.n) for r in mine] == [(r.start, r.step, r.n) for r in ref]
    assert isets.box_is_empty(mine) and list(isets.box_points(mine)) == []
    assert isets.box_count(isets.box_interval((0, 3), (1, 2))) == 8


@given(st.tuples(st.integers(1, 7), st.integers(1, 7), st.integers(1, 7)),
       st.integers(0, 400), st.integers(0, 120))
@settings(max_examples=80, deadline=None)
def test_linear_range_decomposition_through_box_points(grid, start, count):
    """``tests/test_wave.py``'s case on the port's wave and ``box_points``."""
    gx, gy, gz = grid
    boxes = linear_block_range_boxes(grid, start, count)
    got = set()
    for b in boxes:
        for z, y, x in isets.box_points(b):
            got.add((z * gy + y) * gx + x)
    total = gx * gy * gz
    assert got == set(range(max(0, min(start, total)), min(start + count, total)))
    assert sum(isets.count_union([b]) for b in boxes) == len(got)


@pytest.mark.parametrize("block,line", [((32, 4, 8), 32), ((64, 4, 4), 128), ((16, 8, 8), 32)])
def test_block_volumes_and_overlap_equal_reference(block, line):
    from repro.core.specs import star_stencil_3d as ref_star
    from repro_torch.core.specs import star_stencil_3d

    spec, rspec = star_stencil_3d(2, (16, 32, 64), 8), ref_star(2, (16, 32, 64), 8)
    lc = access.LaunchConfig(block=block)
    rlc = ref_access.LaunchConfig(block=block)
    # two blocks side by side in y: the star's halo rows are read by both
    a, b = lc.block_domain_boxes((0, 0, 0), spec.domain), lc.block_domain_boxes((0, 1, 0),
                                                                               spec.domain)
    ra, rb = rlc.block_domain_boxes((0, 0, 0), rspec.domain), rlc.block_domain_boxes(
        (0, 1, 0), rspec.domain)
    mine = footprint.kernel_block_volumes(spec, a, 32, line)
    assert mine == ref_footprint.kernel_block_volumes(rspec, ra, 32, line)
    assert mine["load_sectors"] == footprint.footprint_bytes(spec.loads, a, 32)
    shared = footprint.overlap_bytes(spec.loads, a, b, line)
    assert shared == ref_footprint.overlap_bytes(rspec.loads, ra, rb, line)
    assert 0 < shared < footprint.footprint_bytes(spec.loads, a, line)
    # the per-point views the oracles use
    acc, racc = spec.loads[1], rspec.loads[1]
    for p in ((0, 0, 0), (3, 5, 7)):
        assert acc.element_coord(p) == racc.element_coord(p)
        assert acc.linear_address(p) == racc.linear_address(p)
        assert acc.line_tuple(p, line) == racc.line_tuple(p, line)
    assert spec.scale_domain((8, 32, 64)).domain == rspec.scale_domain((8, 32, 64)).domain
