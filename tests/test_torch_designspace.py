"""The port's design-space sweeps (``repro_torch.core.designspace``) against
``repro.core.designspace``.

Every test of ``tests/test_designspace.py`` is mirrored on the port's
modules: geometry factoring (a rate variant re-priced through the same
cache evaluates no structural task), the machine-axis path bitwise equal to
the per-machine scalar path, skips included, the bounded invariant cache.
Each machine grid is held to the reference's field for field, and a sweep's
entries, its ``cache_stats``, its Pareto frontier and its table to the
reference's on the same grid.  The port of ``examples/design_space.py``
(``examples/torch_design_space.py``) runs its full grid on the CPU when
asked, equal to the reference's sweep, and fails without a card otherwise;
its pooled engine, started as after CUDA, equals the serial one.
"""
import dataclasses
import io
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro.core import access as ref_access  # noqa: E402
from repro.core import designspace as ref_ds  # noqa: E402
from repro.core import machines as ref_machines  # noqa: E402
from repro.core import specs as ref_specs  # noqa: E402
from repro.core import tpu_adapt as ref_tpu  # noqa: E402
from repro.core.engine import Explorer as RefExplorer  # noqa: E402
from repro.core.engine import Workload as RefWorkload  # noqa: E402
from repro.core.selector import enumerate_gpu_configs as ref_enumerate  # noqa: E402
from repro_torch.core import designspace, machines, specs, tpu_adapt  # noqa: E402
from repro_torch.core.access import LaunchConfig  # noqa: E402
from repro_torch.core.designspace import (  # noqa: E402
    gpu_rate_grid,
    h100_class_grid,
    paper_design_grid,
    pareto_frontier,
    tpu_rate_grid,
)
from repro_torch.core.engine import Explorer, InvariantCache, Workload  # noqa: E402
from repro_torch.core.engine.invariants import _MAGIC, ENGINE_CACHE_VERSION  # noqa: E402
from repro_torch.core.machines import TPU_V5E, GPUMachine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

SMALL = GPUMachine(
    name="A100/8",
    n_sms=13,
    clock_hz=1.41e9,
    l1_bytes=192 * 1024,
    l2_bytes=20 * 1024 * 1024 // 8,
    dram_bw=1400e9 / 8,
    l2_bw=5000e9 / 8,
    peak_flops_dp=9.7e12 / 8,
)

SPEC = specs.star_stencil_3d(r=2, domain=(24, 32, 64))

CONFIGS = [
    LaunchConfig(block=b, folding=f)
    for b in [(32, 4, 8), (64, 4, 4), (16, 8, 8), (128, 2, 4), (4, 16, 16),
              (2, 64, 8), (256, 2, 2), (8, 8, 16), (1, 32, 32), (512, 2, 1)]
    for f in [(1, 1, 1), (1, 1, 2)]
]


def _ref_copy(obj):
    """The reference's instance of a port dataclass with the same fields."""
    if dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        mod = ref_machines if name.endswith("Machine") else ref_access
        return getattr(mod, name)(**{f.name: _ref_copy(getattr(obj, f.name))
                                     for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_ref_copy(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _ref_copy(v) for k, v in obj.items()}
    return obj


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _estimate_key(est):
    """Every float the GPU model emits, for bitwise comparison."""
    return (
        est.perf_lups, est.limiter, tuple(sorted(est.limiter_rates.items())),
        est.l1_cycles_per_lup, est.l2_l1_load_per_lup, est.l2_l1_store_per_lup,
        est.dram_load_per_lup, est.dram_store_per_lup,
    )


def _cell_key(report, machine_name):
    return [(e.config, _estimate_key(e.estimate))
            for e in report.ranking(machine=machine_name)]


def _plain_cell_key(report, machine_name):
    """``_cell_key`` with the launch as plain tuples, comparable across the
    two packages."""
    return [((e.config.block, e.config.folding), _estimate_key(e.estimate))
            for e in report.ranking(machine=machine_name)]


def _skip_key(report, machine_name):
    return sorted((repr(s.config), s.reason)
                  for s in report.skipped_for(machine=machine_name))


def _entries_key(report):
    """Every entry of a report, in order, as plain values."""
    out = []
    for e in report.entries:
        cfg = e.config
        cfg = (cfg.block, cfg.folding) if hasattr(cfg, "block") else cfg
        est = (_estimate_key(e.estimate) if hasattr(e.estimate, "perf_lups")
               else _fields(e.estimate))
        out.append((e.workload, e.machine, e.backend, e.index, cfg, e.perf, e.limiter, est))
    return out


def _random_spec(pkg_access, draw_offsets, n_fields, elem_bytes, domain):
    dz = max(max(abs(o[0]) for o in draw_offsets), 1)
    dy = max(max(abs(o[1]) for o in draw_offsets), 1)
    dx = max(max(abs(o[2]) for o in draw_offsets), 1)
    shape = (domain[0] + 2 * dz, domain[1] + 2 * dy, domain[2] + 2 * dx)
    fields = [
        pkg_access.Field(f"f{i}", shape, elem_bytes) for i in range(n_fields)
    ]
    accesses = [
        pkg_access.Access(fields[i % n_fields], (o[0] + dz, o[1] + dy, o[2] + dx))
        for i, o in enumerate(draw_offsets)
    ]
    dst = pkg_access.Field("dst", shape, elem_bytes)
    accesses.append(pkg_access.Access(dst, (dz, dy, dx), is_store=True))
    return pkg_access.KernelSpec("rand", domain, tuple(accesses),
                                 flops_per_point=float(len(draw_offsets)))


offsets_st = st.lists(
    st.tuples(st.integers(-2, 2), st.integers(-2, 2), st.integers(-3, 3)),
    min_size=1, max_size=5, unique=True,
)
machine_st = st.builds(
    GPUMachine,
    name=st.just("rand-gpu"),
    n_sms=st.integers(2, 24),
    clock_hz=st.sampled_from([1.0e9, 1.41e9]),
    l1_bytes=st.sampled_from([64 * 1024, 192 * 1024]),
    l2_bytes=st.sampled_from([256 * 1024, 2 * 1024 * 1024]),
    dram_bw=st.sampled_from([100e9, 800e9]),
    l2_bw=st.sampled_from([400e9, 2500e9]),
    peak_flops_dp=st.sampled_from([1e12, 9.7e12]),
    max_threads_per_sm=st.sampled_from([1024, 2048]),
)
rate_scales_st = st.tuples(
    st.sampled_from([0.25, 0.5, 2.0, 4.0]),     # l2 capacity
    st.sampled_from([0.5, 1.0, 2.0]),           # dram bw
    st.sampled_from([0.5, 1.0, 2.0]),           # l2 bw
)


# --------------------------------------------------------------------------
# geometry factoring + batched-path exactness
# --------------------------------------------------------------------------
@given(
    offsets=offsets_st,
    n_fields=st.integers(1, 2),
    elem_bytes=st.sampled_from([4, 8]),
    domain=st.tuples(st.integers(4, 12), st.integers(4, 16),
                     st.integers(8, 32)),
    machine=machine_st,
    scales=rate_scales_st,
)
@settings(max_examples=15, deadline=None)
def test_geometry_sharing_and_batched_parity_on_random_specs(
        offsets, n_fields, elem_bytes, domain, machine, scales):
    from repro_torch.core import access

    spec = _random_spec(access, offsets, n_fields, elem_bytes, domain)
    l2s, drams, l2bws = scales
    variant = dataclasses.replace(
        machine, name="rand-gpu-variant",
        l2_bytes=max(1, int(machine.l2_bytes * l2s)),
        dram_bw=machine.dram_bw * drams, l2_bw=machine.l2_bw * l2bws)
    assert machine.geometry == variant.geometry
    assert machine.rate_key != variant.rate_key

    # structural sharing: the variant re-priced through the same cache
    # evaluates zero new structural tasks
    ex = Explorer()
    ex._rank_gpu(spec, machine, CONFIGS[:10])
    r2 = ex._rank_gpu(spec, variant, CONFIGS[:10])
    assert r2.cache_stats["pool_tasks"] == 0

    # batched machine-axis sweep vs the unfactored scalar path: every
    # estimate field and every skip reason bitwise equal
    wl = Workload(name="rand", gpu_spec=spec)
    scalar = Explorer()._explore([wl], [machine, variant], CONFIGS[:10])
    batched = Explorer()._explore([wl], [machine, variant], CONFIGS[:10],
                                  machine_axis=True)
    assert batched.cache_stats["geometry_groups"] == 1
    assert batched.cache_stats["machines_batched"] == 2
    ref = RefExplorer()._explore(
        [RefWorkload(name="rand", gpu_spec=_random_spec(ref_access, offsets, n_fields,
                                                        elem_bytes, domain))],
        [_ref_copy(machine), _ref_copy(variant)], _ref_copy(CONFIGS[:10]),
        machine_axis=True)
    for m in (machine, variant):
        assert _cell_key(batched, m.name) == _cell_key(scalar, m.name)
        assert _skip_key(batched, m.name) == _skip_key(scalar, m.name)
        assert _plain_cell_key(batched, m.name) == _plain_cell_key(ref, m.name)
        assert _skip_key(batched, m.name) == _skip_key(ref, m.name)


def test_machine_axis_topk_matches_scalar_on_paper_machines():
    variants = gpu_rate_grid(SMALL, l2_scales=(0.5, 1.0, 2.0),
                             dram_bw_scales=(0.5, 2.0))
    wl = Workload(name="stencil", gpu_spec=SPEC)
    scalar = Explorer()._explore([wl], variants, CONFIGS, top_k=5)
    batched = Explorer()._explore([wl], variants, CONFIGS, top_k=5,
                                  machine_axis=True)
    assert batched.cache_stats["geometry_groups"] == 1
    assert batched.cache_stats["machines_batched"] == len(variants)
    ref = RefExplorer()._explore(
        [RefWorkload(name="stencil", gpu_spec=_ref_copy(SPEC))], _ref_copy(variants),
        _ref_copy(CONFIGS), top_k=5, machine_axis=True)
    for m in variants:
        assert _cell_key(batched, m.name) == _cell_key(scalar, m.name)
        assert _plain_cell_key(batched, m.name) == _plain_cell_key(ref, m.name)


def _pallas_candidates(pkg, elem_bytes=4):
    """(config, PallasKernelSpec) pairs of replane-style stencils at r = 2 on
    (64, 128, 256), built by hand in ``pkg`` (the port's or the reference's
    ``tpu_adapt``): the reference's test takes them from its tracer, which
    is broken on jax 0.9.0.  The large tiles need more VMEM than the small
    variants have."""
    Op, Spec = pkg.OperandSpec, pkg.PallasKernelSpec
    out = []
    for ty in (8, 16, 32, 64, 128):
        out.append(({"variant": "replane", "ty": ty}, Spec(
            name="star_replane", grid=(64, 128 // ty),
            operands=(Op("src", (5, ty + 4, 260), elem_bytes, grid_deps=(0, 1)),
                      Op("out", (1, ty, 256), elem_bytes, grid_deps=(0, 1),
                         is_output=True)),
            vpu_elems_per_step=13.0 * ty * 256, vpu_shape=(ty, 256),
            work_per_step=ty * 256.0, elem_bytes=elem_bytes)))
    return out


def test_machine_axis_pallas_parity_including_infeasible_skips():
    cands = _pallas_candidates(tpu_adapt)
    # small-VMEM variants force infeasible candidates through the batched
    # skip path; the reasons must match the scalar path verbatim
    machines_ = [TPU_V5E] + tpu_rate_grid(
        TPU_V5E, hbm_bw_scales=(0.5, 1.0),
        vmem_scales=(0.004, 0.02, 1.0), flops_scales=(1.0,))
    wl = Workload(name="st25", tpu_candidates=cands)
    scalar = Explorer()._explore([wl], machines_, top_k=3)
    batched = Explorer()._explore([wl], machines_, top_k=3, machine_axis=True)
    ref_machines_ = [ref_machines.TPU_V5E] + ref_ds.tpu_rate_grid(
        ref_machines.TPU_V5E, hbm_bw_scales=(0.5, 1.0),
        vmem_scales=(0.004, 0.02, 1.0), flops_scales=(1.0,))
    ref = RefExplorer()._explore(
        [RefWorkload(name="st25", tpu_candidates=_pallas_candidates(ref_tpu))],
        ref_machines_, top_k=3, machine_axis=True)
    skips_seen = 0
    for m in machines_:
        mine = [(e.config, e.estimate, e.limiter) for e in batched.ranking(machine=m.name)]
        assert mine == [(e.config, e.estimate, e.limiter)
                        for e in scalar.ranking(machine=m.name)]
        assert [(c, _fields(e), lim) for c, e, lim in mine] == [
            (e.config, _fields(e.estimate), e.limiter) for e in ref.ranking(machine=m.name)]
        assert _skip_key(batched, m.name) == _skip_key(scalar, m.name)
        assert _skip_key(batched, m.name) == _skip_key(ref, m.name)
        skips_seen += len(batched.skipped_for(machine=m.name))
    assert skips_seen > 0, "small-VMEM variants must exercise skip parity"


def test_mixed_geometry_grid_groups_by_class():
    machines_ = h100_class_grid(dram_bw_scales=(1.0,))
    geoms = {m.geometry for m in machines_}
    assert len(geoms) == 2        # sector 32 vs TMA-style 128
    wl = Workload(name="stencil", gpu_spec=SPEC)
    batched = Explorer()._explore([wl], machines_, CONFIGS[:6], top_k=2,
                                  machine_axis=True)
    assert batched.cache_stats["geometry_groups"] == 2
    share = batched.cache_stats["geometry_share"]
    assert sorted(share.values()) == [2, 2]
    scalar = Explorer()._explore([wl], machines_, CONFIGS[:6])
    for m in machines_:
        assert _cell_key(batched, m.name) == _cell_key(scalar, m.name)[:2]


# --------------------------------------------------------------------------
# machine grids + Pareto report
# --------------------------------------------------------------------------
def test_paper_design_grid_shape():
    machines_ = paper_design_grid()
    assert len(machines_) >= 1000
    assert len({m.name for m in machines_}) == len(machines_)
    assert len({m.geometry for m in machines_}) == 3


GRIDS = {
    "gpu_rate_grid(SMALL)": (lambda ds, m: ds.gpu_rate_grid(m.SMALL)),
    "gpu_rate_grid(A100, all knobs)": (lambda ds, m: ds.gpu_rate_grid(
        m.A100, l2_scales=(0.25, 1.0), dram_bw_scales=(0.75, 1.5),
        l2_bw_scales=(0.5, 2.0), clock_scales=(0.9, 1.1), l1_scales=(0.5, 1.0))),
    "h100_class_grid()": (lambda ds, m: ds.h100_class_grid()),
    "h100_class_grid(unified)": (lambda ds, m: ds.h100_class_grid(
        partitioned_l2=(False,), bulk_copy=(True,), dram_bw_scales=(0.5, 1.0))),
    "tpu_rate_grid()": (lambda ds, m: ds.tpu_rate_grid()),
    "tpu_rate_grid(flops)": (lambda ds, m: ds.tpu_rate_grid(
        m.TPU_V5E, hbm_bw_scales=(1.0,), vmem_scales=(0.5,), flops_scales=(0.5, 2.0))),
    "paper_design_grid()": (lambda ds, m: ds.paper_design_grid()),
}


class _Machines:
    """The machines a grid builder reads, from one package."""

    def __init__(self, mod, small):
        self.A100, self.H100, self.TPU_V5E, self.SMALL = (
            mod.A100, mod.H100, mod.TPU_V5E, small)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_machine_grids_equal_reference_field_for_field(grid):
    build = GRIDS[grid]
    mine = build(designspace, _Machines(machines, SMALL))
    ref = build(ref_ds, _Machines(ref_machines, _ref_copy(SMALL)))
    assert len(mine) == len(ref) > 0
    for a, b in zip(mine, ref):
        assert type(a).__name__ == type(b).__name__
        assert _fields(a) == _fields(b)
        assert a.geometry == _ref_copy_geometry(b)
        assert a.rate_key == b.rate_key


def _ref_copy_geometry(ref_machine):
    """The reference machine's geometry as the port's class."""
    g = ref_machine.geometry
    return getattr(machines, type(g).__name__)(**_fields(g))


def test_pareto_frontier_excludes_dominated_and_collapses_ties():
    variants = gpu_rate_grid(SMALL, l2_scales=(0.5, 1.0),
                             dram_bw_scales=(0.5, 1.0),
                             l2_bw_scales=(1.0, 2.0))
    wl = Workload(name="stencil", gpu_spec=SPEC)
    report = Explorer()._explore([wl], variants, CONFIGS, top_k=1,
                                 machine_axis=True)
    frontiers = pareto_frontier(report, variants)
    frontier = frontiers["stencil"]
    assert frontier
    by_name = {m.name: m for m in variants}
    best = {e.machine: e.perf for e in report.entries}
    for p in frontier:
        # no other machine dominates a frontier point
        for name, perf in best.items():
            q = by_name[name]
            if (q.dram_bw <= p.bandwidth and q.l2_bytes <= p.capacity
                    and perf >= p.perf
                    and (q.dram_bw < p.bandwidth or q.l2_bytes < p.capacity
                         or perf > p.perf)):
                pytest.fail(f"{p.machine} dominated by {name}")
    # ties collapsed: budgets+perf unique along the frontier
    keys = [(p.bandwidth, p.capacity, p.perf) for p in frontier]
    assert len(keys) == len(set(keys))
    # the full-budget machine is never dominated, so some point must match
    # its best perf
    top = max(best.values())
    assert any(p.perf == top for p in frontier)


def _frontier_key(frontiers):
    return {w: [(p.machine, p.bandwidth, p.capacity, p.perf,
                 (p.config.block, p.config.folding) if hasattr(p.config, "block")
                 else p.config, p.limiter) for p in pts]
            for w, pts in frontiers.items()}


@pytest.mark.parametrize("top_k", [1, 3])
def test_sweep_frontier_and_table_equal_reference_on_a_mixed_grid(top_k):
    variants = (gpu_rate_grid(SMALL, l2_scales=(0.5, 2.0), dram_bw_scales=(0.5, 1.0))
                + [SMALL] + h100_class_grid(dram_bw_scales=(1.0,)))
    ref_variants = (ref_ds.gpu_rate_grid(_ref_copy(SMALL), l2_scales=(0.5, 2.0),
                                         dram_bw_scales=(0.5, 1.0))
                    + [_ref_copy(SMALL)] + ref_ds.h100_class_grid(dram_bw_scales=(1.0,)))
    spec2 = specs.lbm_d3q15((6, 12, 20))
    mine = designspace.design_space_sweep(
        [Workload(name="stencil", gpu_spec=SPEC), Workload(name="lbm", gpu_spec=spec2)],
        variants, top_k=top_k, explorer=Explorer(), configs=CONFIGS)
    ref = ref_ds.design_space_sweep(
        [RefWorkload(name="stencil", gpu_spec=_ref_copy(SPEC)),
         RefWorkload(name="lbm", gpu_spec=ref_specs.lbm_d3q15((6, 12, 20)))],
        ref_variants, top_k=top_k, explorer=RefExplorer(), configs=_ref_copy(CONFIGS))
    assert _entries_key(mine) == _entries_key(ref)
    assert len(mine.entries) == 2 * len(variants) * top_k
    assert mine.cache_stats == ref.cache_stats
    assert mine.cache_stats["geometry_groups"] == 2 * 3   # (workload, geometry) pairs
    assert [(s.workload, s.machine, repr(s.config), s.reason) for s in mine.skipped] == \
        [(s.workload, s.machine, repr(s.config), s.reason) for s in ref.skipped]
    for workload in (None, "lbm"):
        fm = pareto_frontier(mine, variants, workload)
        fr = ref_ds.pareto_frontier(ref, ref_variants, workload)
        assert _frontier_key(fm) == _frontier_key(fr)
        assert designspace.pareto_table(fm) == ref_ds.pareto_table(fr)
        assert [type(p).__name__ for pts in fm.values() for p in pts] == \
            ["ParetoPoint"] * sum(len(p) for p in fm.values())


def test_pareto_frontier_over_tpu_budgets_and_unknown_machines():
    cands = _pallas_candidates(tpu_adapt)
    grid = tpu_rate_grid(TPU_V5E, hbm_bw_scales=(0.5, 1.0, 2.0), vmem_scales=(0.02, 1.0))
    report = designspace.design_space_sweep(
        [Workload(name="st25", tpu_candidates=cands)], grid, top_k=2, explorer=Explorer())
    ref_grid = ref_ds.tpu_rate_grid(ref_machines.TPU_V5E, hbm_bw_scales=(0.5, 1.0, 2.0),
                                    vmem_scales=(0.02, 1.0))
    ref = ref_ds.design_space_sweep(
        [RefWorkload(name="st25", tpu_candidates=_pallas_candidates(ref_tpu))], ref_grid,
        top_k=2, explorer=RefExplorer())
    # a machine the frontier is not told about is left out, in both
    fm = pareto_frontier(report, grid[1:])
    fr = ref_ds.pareto_frontier(ref, ref_grid[1:])
    assert _frontier_key(fm) == _frontier_key(fr) and fm["st25"]
    assert designspace.pareto_table(fm) == ref_ds.pareto_table(fr)
    with pytest.raises(TypeError, match="no budget axes"):
        designspace._budget_axes("not a machine")


# --------------------------------------------------------------------------
# bounded invariant cache (LRU eviction)
# --------------------------------------------------------------------------
def test_lru_max_entries_bounds_cache_and_preserves_answers():
    unbounded = Explorer()._rank_gpu(SPEC, SMALL, CONFIGS)
    ex = Explorer(cache_max_entries=16)
    bounded = ex._rank_gpu(SPEC, SMALL, CONFIGS)
    assert len(ex.cache) <= 16
    assert ex.cache.evictions > 0
    assert ex.cache.stats()["evictions"] == ex.cache.evictions
    assert bounded.cache_stats["evictions"] > 0
    assert [(e.config, _estimate_key(e.estimate)) for e in bounded.entries] \
        == [(e.config, _estimate_key(e.estimate)) for e in unbounded.entries]


def test_lru_max_bytes_bounds_cache_and_counts_evicted_bytes():
    ex = Explorer(cache_max_bytes=64 * 1024)
    report = ex._rank_gpu(SPEC, SMALL, CONFIGS)
    assert ex.cache._bytes <= 64 * 1024
    assert ex.cache.evictions > 0
    assert ex.cache.evicted_bytes > 0
    assert report.entries


def test_lru_recency_keeps_hot_entries():
    cache = InvariantCache(max_entries=2)
    cache.store("a", ("ok", 1))
    cache.store("b", ("ok", 2))
    assert cache.lookup("a") == ("ok", 1)   # touch: "b" is now LRU
    cache.store("c", ("ok", 3))
    assert cache.evictions == 1
    assert cache.peek("a") is not None
    assert cache.peek("b") is None


def test_explorer_rejects_budget_with_explicit_cache():
    with pytest.raises(ValueError):
        Explorer(cache=InvariantCache(), cache_max_entries=4)


def test_bounded_persistent_cache_evicts_loaded_entries_first(tmp_path):
    path = tmp_path / "inv.cache"
    Explorer(cache_path=str(path))._rank_gpu(SPEC, SMALL, CONFIGS)
    n_saved = len(InvariantCache(path=str(path)))
    assert n_saved > 8
    bounded = InvariantCache(path=str(path), max_entries=8)
    assert len(bounded) <= 8
    assert bounded.evictions == n_saved - len(bounded)


def test_version_mismatched_cache_degrades_to_cold(tmp_path):
    path = tmp_path / "inv.cache"
    ex = Explorer(cache_path=str(path))
    ex._rank_gpu(SPEC, SMALL, CONFIGS[:4])
    # rewrite the header with a future engine version, keeping the payload
    with open(path, "rb") as f:
        pickle.load(f)
        pickle.load(f)
        payload = f.read()
    buf = io.BytesIO()
    pickle.dump({"magic": _MAGIC, "version": ENGINE_CACHE_VERSION + 1}, buf)
    pickle.dump(b"\x00" * 32, buf)
    buf.write(payload)
    path.write_bytes(buf.getvalue())

    warm_ex = Explorer(cache_path=str(path))
    assert warm_ex.cache.loaded_entries == 0      # graceful: cold, no raise
    warm = warm_ex._rank_gpu(SPEC, SMALL, CONFIGS[:4])
    assert warm.cache_stats["pool_tasks"] > 0
    assert warm.entries


# --------------------------------------------------------------------------
# examples/torch_design_space.py, and the pooled sweep after CUDA
# --------------------------------------------------------------------------
def _example():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_design_space
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return torch_design_space


def test_design_space_example_equals_the_reference_sweep(capsys):
    ex = _example()
    out = ex.main(device="cpu", explorer=Explorer())
    machines_ = out["machines"]
    assert len(machines_) == 73
    assert len({m.geometry for m in machines_}) == 3
    assert sum(m.sector_bytes == 128 for m in machines_) == 6
    # the reference example's grid, workload, configs and top_k
    ref_grid = ref_ds.gpu_rate_grid(
        ref_machines.A100, l2_scales=(0.25, 0.5, 1.0, 2.0),
        dram_bw_scales=(0.5, 0.75, 1.0, 1.5, 2.0), l2_bw_scales=(0.5, 1.0, 2.0),
        clock_scales=(1.0,)) + [ref_machines.A100] + ref_ds.h100_class_grid()
    assert [_fields(m) for m in machines_] == [_fields(m) for m in ref_grid]
    ref = ref_ds.design_space_sweep(
        [RefWorkload(name="stencil3d_r4",
                     gpu_spec=ref_specs.star_stencil_3d(r=4, domain=(48, 96, 128)))],
        ref_grid, configs=ref_enumerate(512), top_k=3, explorer=RefExplorer())
    report = out["report"]
    assert _entries_key(report) == _entries_key(ref)
    assert report.cache_stats == ref.cache_stats
    assert report.cache_stats["machines_batched"] == 73
    ref_frontiers = ref_ds.pareto_frontier(ref, ref_grid)
    assert _frontier_key(out["frontiers"]) == _frontier_key(ref_frontiers)
    assert out["table"] == ref_ds.pareto_table(ref_frontiers)
    best = max(ref.entries, key=lambda e: e.perf)
    assert (out["winner"].machine, out["winner"].perf) == (best.machine, best.perf)
    text = capsys.readouterr().out
    assert "machine grid: 73 variants, 3 geometry classes" in text
    assert out["table"] in text and "overall winner: " + best.machine in text


def test_design_space_example_never_falls_back_to_the_cpu(monkeypatch):
    ex = _example()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main(machines=[SMALL], configs=CONFIGS[:2], explorer=Explorer())


_POOLED_SWEEP = r'''
import json, os, sys


def main():
    import torch
    from repro_torch.core.engine import Explorer, pool

    torch.cuda.is_initialized = lambda: True     # as after CUDA started
    sys.path.insert(0, sys.argv[1])
    import torch_design_space as ex

    pooled = ex.main(device="cpu")               # the default: Explorer(parallel=True)
    serial = ex.main(device="cpu", explorer=Explorer())
    def key(report):
        return [[e.machine, e.index, list(e.config.block), list(e.config.folding),
                 e.perf.hex(), e.limiter] for e in report.entries]
    stats = {k: v for k, v in pooled["report"].cache_stats.items()}
    pool.stop_helpers()
    children = sorted(
        int(p.split("/")[2]) for p in (f"/proc/{d}/stat" for d in os.listdir("/proc")
                                        if d.isdigit())
        if os.path.exists(p)
        and int(open(p).read().rsplit(")", 1)[1].split()[1]) == os.getpid())
    print(json.dumps({"method": pool._context().get_start_method(),
                      "equal": key(pooled["report"]) == key(serial["report"]),
                      "entries": len(pooled["report"].entries),
                      "table_equal": pooled["table"] == serial["table"],
                      "groups": stats["geometry_groups"], "children": children}))


if __name__ == "__main__":
    main()
'''


def test_pooled_design_space_sweep_after_cuda_equals_serial(tmp_path):
    """The example's default engine is pooled: in a fresh interpreter that
    believes CUDA has started, it takes ``forkserver``, equals the serial
    sweep entry for entry, and leaves no child once its helpers stop."""
    script = tmp_path / "pooled_sweep.py"
    script.write_text(_POOLED_SWEEP)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_FAULT_PLAN", None)
    env.pop("REPRO_TRACE_OUT", None)
    proc = subprocess.run([sys.executable, str(script), str(ROOT / "examples")],
                          capture_output=True, text=True, timeout=300, env=env,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"method": "forkserver", "equal": True, "entries": 73 * 3,
                   "table_equal": True, "groups": 3, "children": []}


def test_examples_import_no_jax_and_nothing_of_repro():
    """The port's examples, imported in a fresh interpreter, load neither jax
    nor any module of the JAX package; their sources hold no such import."""
    import ast

    files = sorted((ROOT / "examples").glob("torch_*.py"))
    assert {f.name for f in files} >= {"torch_quickstart.py", "torch_design_space.py",
                                       "torch_stencil_codegen.py"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (f.name, name)
    code = ("import json, sys; sys.path.insert(0, 'examples')\n"
            "import torch_quickstart, torch_design_space, torch_stencil_codegen\n"
            "print(json.dumps(sorted(sys.modules)))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.cachesim" in loaded and "repro_torch.core.designspace" in loaded
    assert not [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "repro")]
