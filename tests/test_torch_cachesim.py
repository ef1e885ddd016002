"""The port's LRU sector-cache simulator (``repro_torch.core.cachesim``) and
the grid walk it reads (``core.gridwalk``) against ``repro.core``'s.

Every test of ``tests/test_cachesim.py`` and ``tests/test_cachesim_core.py``
is mirrored here on the port's modules, and each simulator result is held
equal (``==``, integers and floats alike) to the reference's on the same
inputs: random event traces and random spec x launch pairs (hypothesis),
the repo's kernel specs on the three scaled machines of the reference's
tests, both modes (vectorized and the OrderedDict oracle), the H100 winners
of both paths at reduced domains, and the paper's three volume checks on
the full H100 model (the numbers ``chip_smoke.py``'s ``sim`` phase holds).
The grid walk's oracle half (visitors, the per-warp loops, line tuples,
block footprints) is held to the reference's too.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis_compat import given, settings, st

pytest.importorskip("torch")

from repro.core import access as ref_access  # noqa: E402
from repro.core import cachesim as ref_cachesim  # noqa: E402
from repro.core import gridwalk as ref_gridwalk  # noqa: E402
from repro.core import machines as ref_machines  # noqa: E402
from repro.core import perfmodel as ref_perfmodel  # noqa: E402
from repro.core import specs as ref_specs  # noqa: E402
from repro_torch.core import access, cachesim, gridwalk, machines, specs  # noqa: E402
from repro_torch.core.access import (  # noqa: E402
    Access,
    Field,
    KernelSpec,
    LaunchConfig,
    domain_zyx,
)
from repro_torch.core.cachesim import (  # noqa: E402
    SectorCache,
    _block_warp_streams,
    _block_warp_streams_ref,
    _lru_volumes,
    simulate_l1_block,
    simulate_l2_waves,
)
from repro_torch.core.footprint import footprint_bytes  # noqa: E402
from repro_torch.core.perfmodel import estimate_gpu  # noqa: E402


def _ref_copy(obj):
    """The reference's instance of a port dataclass with the same fields."""
    if dataclasses.is_dataclass(obj):
        mod = ref_machines if isinstance(obj, machines.GPUMachine) else ref_access
        cls = getattr(mod, type(obj).__name__)
        return cls(**{f.name: _ref_copy(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_ref_copy(x) for x in obj)
    return obj


SMALL = machines.GPUMachine(
    name="A100/8", n_sms=13, clock_hz=1.41e9, l1_bytes=192 * 1024,
    l2_bytes=20 * 1024 * 1024 // 8, dram_bw=175e9, l2_bw=625e9,
    peak_flops_dp=1.2e12,
)
SMALL_V100 = machines.GPUMachine(
    name="V100/8", n_sms=10, clock_hz=1.38e9, l1_bytes=128 * 1024,
    l2_bytes=6 * 1024 * 1024 // 8, dram_bw=900e9 / 8, l2_bw=2155e9 / 8,
    peak_flops_dp=7.8e12 / 8,
)
SMALL_A100 = machines.GPUMachine(
    name="A100/8", n_sms=13, clock_hz=1.41e9, l1_bytes=192 * 1024,
    l2_bytes=20 * 1024 * 1024 // 8, dram_bw=1400e9 / 8, l2_bw=5000e9 / 8,
    peak_flops_dp=9.7e12 / 8,
)
SMALL_A100_2XL2 = machines.GPUMachine(
    name="A100/8-2xL2", n_sms=13, clock_hz=1.41e9, l1_bytes=192 * 1024,
    l2_bytes=2 * 20 * 1024 * 1024 // 8, dram_bw=1400e9 / 8, l2_bw=5000e9 / 8,
    peak_flops_dp=9.7e12 / 8,
)
GEOMETRIES = [SMALL_V100, SMALL_A100, SMALL_A100_2XL2]


def _both_l2(spec, lc, machine, **kw):
    """The port's and the reference's ``simulate_l2_waves`` on one input."""
    return (simulate_l2_waves(spec, lc, machine, **kw),
            ref_cachesim.simulate_l2_waves(_ref_copy(spec), _ref_copy(lc),
                                           _ref_copy(machine), **kw))


def _both_l1(spec, lc, machine, **kw):
    return (simulate_l1_block(spec, lc, machine, **kw),
            ref_cachesim.simulate_l1_block(_ref_copy(spec), _ref_copy(lc),
                                           _ref_copy(machine), **kw))


def _cache_state(c):
    return (list(c.lines.items()), c.load_bytes, c.store_bytes,
            c.completion_read_bytes, c.max_lines)


# --------------------------------------------------------------------------
# tests/test_cachesim.py
# --------------------------------------------------------------------------
def test_sector_cache_basics():
    caches = (SectorCache(capacity_bytes=256), ref_cachesim.SectorCache(capacity_bytes=256))
    for c in caches:
        c.measuring = True
    for step, (line, want) in enumerate([(0, 32), (0, 32), (1, None), (2, None),
                                         (0, 32 * 4)]):
        for c in caches:
            c.access(line, 1, False, False)
        assert _cache_state(caches[0]) == _cache_state(caches[1]), step
        if want is not None:
            assert caches[0].load_bytes == want


def test_store_writeback_and_completion_read():
    caches = (SectorCache(capacity_bytes=128), ref_cachesim.SectorCache(capacity_bytes=128))
    for c in caches:
        c.measuring = True
        c.access(0, 1, False, True)   # partial store, sector never read
        c.access(1, 1, False, False)  # evicts line 0
    assert _cache_state(caches[0]) == _cache_state(caches[1])
    assert caches[0].store_bytes == 32
    assert caches[0].completion_read_bytes == 32  # partial sector re-read


def test_streaming_simulated_volumes():
    spec = specs.streaming_scale(1 << 14)
    assert _ref_copy(spec) == ref_specs.streaming_scale(1 << 14)
    assert _ref_copy(specs.streaming_load(1 << 10)) == ref_specs.streaming_load(1 << 10)
    m, ref = _both_l2(spec, LaunchConfig(block=(256, 1, 1)), SMALL)
    assert m == ref
    assert m["dram_load_bytes_per_lup"] == pytest.approx(8.0, rel=0.05)
    assert m["dram_store_bytes_per_lup"] == pytest.approx(8.0, rel=0.05)


@pytest.mark.parametrize("blk,fold", [((64, 4, 4), (1, 1, 1)), ((32, 8, 4), (1, 1, 1))])
def test_estimator_tracks_simulator_dram(blk, fold):
    spec = specs.star_stencil_3d(r=2, domain=(48, 96, 128))
    lc = LaunchConfig(block=blk, folding=fold)
    sim, ref = _both_l2(spec, lc, SMALL)
    assert sim == ref
    est = estimate_gpu(spec, lc, SMALL)
    total_sim = sim["dram_load_bytes_per_lup"] + sim["dram_store_bytes_per_lup"]
    total_est = est.dram_load_per_lup + est.dram_store_per_lup
    assert total_est == pytest.approx(total_sim, rel=0.35)


def test_estimator_tracks_simulator_l1():
    spec = specs.star_stencil_3d(r=2, domain=(48, 96, 128))
    lc = LaunchConfig(block=(64, 4, 4))
    sim, ref = _both_l1(spec, lc, SMALL)
    assert sim == ref
    est = estimate_gpu(spec, lc, SMALL)
    assert est.l2_l1_load_per_lup == pytest.approx(
        sim["l2_to_l1_load_bytes_per_lup"], rel=0.25
    )


# --------------------------------------------------------------------------
# tests/test_cachesim_core.py: the LRU core
# --------------------------------------------------------------------------
def replay_sector_cache(cls, lines, bits, fulls, stores, measuring, cap_lines, flush):
    """Ground-truth replay of a raw event trace through ``cls`` (a
    ``SectorCache``, the port's or the reference's)."""
    c = cls(cap_lines * 128)
    for ln, b, f, s, m in zip(lines, bits, fulls, stores, measuring):
        c.measuring = bool(m)
        c.access(int(ln), 1 << int(b), bool(f), bool(s))
    if flush:
        c.measuring = True
        c.flush()
    return c.load_bytes, c.store_bytes, c.completion_read_bytes


def run_both(lines, bits, fulls, stores, measuring, cap, flush):
    """The port's offline replay equals its ``SectorCache`` loop, and both
    equal the reference's."""
    want = replay_sector_cache(SectorCache, lines, bits, fulls, stores, measuring,
                               cap, flush)
    arrays = (np.asarray(lines, dtype=np.int64), np.asarray(bits, dtype=np.int64),
              np.asarray(fulls, dtype=bool), np.asarray(stores, dtype=bool),
              np.asarray(measuring, dtype=bool))
    got = _lru_volumes(*arrays, cap, flush)
    assert got == want, (got, want)
    assert got == ref_cachesim._lru_volumes(*arrays, cap, flush)
    assert want == replay_sector_cache(ref_cachesim.SectorCache, lines, bits, fulls,
                                       stores, measuring, cap, flush)


event = st.tuples(
    st.integers(0, 6),        # line id
    st.integers(0, 3),        # sector in line
    st.booleans(),            # fully written
    st.booleans(),            # is store
    st.booleans(),            # measuring
)


@given(st.lists(event, min_size=1, max_size=120), st.integers(1, 5),
       st.booleans())
@settings(max_examples=120, deadline=None)
def test_lru_core_matches_sector_cache_property(events, cap, flush):
    lines, bits, fulls, stores, meas = map(list, zip(*events))
    run_both(lines, bits, fulls, stores, meas, cap, flush)


def test_lru_core_capacity_and_completion_directed():
    # partial store, evicted -> write-back + completion read
    run_both([0, 4], [0, 0], [False, False], [True, False], [True, True],
             cap=1, flush=False)
    # full store, evicted -> write-back, no completion read
    run_both([0, 4], [0, 0], [True, False], [True, False], [True, True],
             cap=1, flush=False)
    # store completed by a later load in the same generation
    run_both([0, 0, 4], [0, 0, 0], [False, False, False],
             [True, False, False], [True, True, True], cap=1, flush=False)
    # unflushed, never evicted -> store volume not counted
    run_both([0], [0], [False], [True], [True], cap=4, flush=False)
    # flushed -> counted
    run_both([0], [0], [False], [True], [True], cap=4, flush=True)


def test_rank_before_equals_reference_on_a_long_trace():
    vals = np.random.default_rng(0).permutation(5000).astype(np.int64)
    got = cachesim._rank_before(vals)
    assert np.array_equal(got, ref_cachesim._rank_before(vals))
    assert got.dtype == np.int64
    small = np.array([3, 0, 4, 1, 2])
    assert got[:1].tolist() == [0]
    assert cachesim._rank_before(small).tolist() == [
        sum(small[j] <= small[i] for j in range(i)) for i in range(len(small))]


def test_flush_attribution_unmeasured_dirty_not_counted():
    """Dirty sectors written *before* measuring flips on must not appear in
    the measured store volume, no matter when eviction happens."""
    caches = (SectorCache(capacity_bytes=128), ref_cachesim.SectorCache(capacity_bytes=128))
    for c in caches:
        c.access(0, 1, False, True)     # dirty store while NOT measuring
        c.measuring = True
        c.access(1, 1, False, False)    # evicts line 0 while measuring
        c.flush()
        assert c.store_bytes == 0
        assert c.completion_read_bytes == 0
    # and the same trace through the vectorized core
    run_both([0, 1], [0, 0], [False, False], [True, False], [False, True],
             cap=1, flush=True)
    # control: the same store while measuring IS attributed
    run_both([0, 1], [0, 0], [False, False], [True, False], [True, True],
             cap=1, flush=True)


# --------------------------------------------------------------------------
# tests/test_cachesim_core.py: simulator level, random specs x launches
# --------------------------------------------------------------------------
def _random_spec(draw):
    ndim = draw(st.integers(1, 3))
    domain = tuple(draw(st.integers(4, 14)) for _ in range(ndim))
    halo = draw(st.integers(0, 1))
    eb = draw(st.sampled_from([4, 8]))
    src = Field("src", tuple(d + 2 * halo for d in domain), eb,
                alignment=draw(st.integers(0, 3)))
    dst = Field("dst", domain, eb)
    accs = [Access(src, tuple(halo for _ in range(ndim)))]
    for _ in range(draw(st.integers(0, 2))):
        off = tuple(draw(st.integers(0, 2 * halo)) for _ in range(ndim))
        accs.append(Access(src, off))
    accs.append(Access(dst, tuple(0 for _ in range(ndim)), is_store=True))
    return KernelSpec("rand", domain, tuple(accs), flops_per_point=1.0)


@given(st.data())
@settings(max_examples=25, deadline=None)
def test_simulators_match_oracle_property(data):
    spec = _random_spec(data.draw)
    block = data.draw(st.sampled_from(
        [(8, 2, 2), (4, 4, 2), (16, 2, 1), (2, 8, 2), (3, 5, 1)]))
    folding = data.draw(st.sampled_from([(1, 1, 1), (2, 1, 1), (1, 2, 1)]))
    lc = LaunchConfig(block=block, folding=folding)
    machine = machines.GPUMachine(
        name="tiny", n_sms=2, clock_hz=1e9, l1_bytes=8 * 1024,
        l2_bytes=data.draw(st.sampled_from([2048, 8192, 32768])),
        dram_bw=1e11, l2_bw=4e11, peak_flops_dp=1e12,
    )
    vec1, ref1 = _both_l1(spec, lc, machine, oracle=False)
    assert vec1 == simulate_l1_block(spec, lc, machine, oracle=True) == ref1
    vec, ref = _both_l2(spec, lc, machine, oracle=False)
    assert vec == simulate_l2_waves(spec, lc, machine, oracle=True) == ref


def _gpu_kernel_specs():
    """GPU address-expression specs of the repo's kernels (small domains):
    the reference's tests' list, with the port's hand-written transpose
    spec where the reference needs its tracer (and ``stencil_2d5pt`` is
    the Jacobi sweep's spec)."""
    return [
        specs.star_stencil_3d(r=2, domain=(12, 16, 24), name="stencil3d25"),
        specs.lbm_d3q15(domain=(8, 12, 16)),
        specs.matmul_naive(32, 16, 32),
        specs.stencil_2d5pt(domain=(48, 64)),
        specs.stencil_2d5pt(domain=(24, 32)),
        specs.transpose_pad((40, 48)),
    ]


@pytest.mark.parametrize("machine", GEOMETRIES, ids=lambda m: m.name)
def test_all_kernels_match_oracle_across_geometries(machine):
    for spec in _gpu_kernel_specs():
        for lc in (LaunchConfig(block=(32, 4, 2)),
                   LaunchConfig(block=(16, 4, 4), folding=(1, 2, 1))):
            vec, ref = _both_l2(spec, lc, machine, oracle=False)
            orc, ref_orc = _both_l2(spec, lc, machine, oracle=True)
            assert vec == orc == ref == ref_orc, (spec.name, machine.name, lc)
            vec1, ref1 = _both_l1(spec, lc, machine, oracle=False)
            orc1, ref_orc1 = _both_l1(spec, lc, machine, oracle=True)
            assert vec1 == orc1 == ref1 == ref_orc1, (spec.name, machine.name, lc)


def test_reference_specs_equal_the_ports():
    pairs = [
        (specs.star_stencil_3d(r=2, domain=(12, 16, 24), name="stencil3d25"),
         ref_specs.star_stencil_3d(r=2, domain=(12, 16, 24), name="stencil3d25")),
        (specs.lbm_d3q15(domain=(8, 12, 16)), ref_specs.lbm_d3q15(domain=(8, 12, 16))),
        (specs.matmul_naive(32, 16, 32), ref_specs.matmul_naive(32, 16, 32)),
        (specs.stencil_2d5pt(domain=(48, 64)), ref_specs.stencil_2d5pt(domain=(48, 64))),
        (specs.streaming_load(96, 4), ref_specs.streaming_load(96, 4)),
        (specs.streaming_scale(96), ref_specs.streaming_scale(96)),
    ]
    for mine, ref in pairs:
        assert _ref_copy(mine) == ref


# --------------------------------------------------------------------------
# the H100 winners of both paths, at reduced domains and at the paper's
# --------------------------------------------------------------------------
# (spec builder, domain, block, folding): the launches the H100 ranking puts
# first at the paper's domains (PERF.md §6 rows 1 and 4; the quickstart's)
STENCIL_WINNER = ((16, 2, 32), (1, 1, 1))
LBM_WINNER = ((256, 4, 1), (1, 2, 1))
QUICKSTART_WINNER = ((16, 1, 64), (1, 1, 2))


@pytest.mark.parametrize("oracle", [False, True])
@pytest.mark.parametrize("case", ["stencil", "lbm"])
def test_h100_winners_equal_reference_at_reduced_domains(case, oracle):
    if case == "stencil":
        spec, (block, fold) = specs.star_stencil_3d(4, (40, 48, 64), 8), STENCIL_WINNER
    else:
        spec, (block, fold) = specs.lbm_d3q15((6, 8, 256), 8), LBM_WINNER
    lc = LaunchConfig(block=block, folding=fold)
    vec, ref = _both_l2(spec, lc, machines.H100, oracle=oracle)
    assert vec == ref
    vec1, ref1 = _both_l1(spec, lc, machines.H100, oracle=oracle)
    assert vec1 == ref1


# the paper's check (PERF.md §6): (load, store) B/LUP of the simulator
# and of the estimator, to the two decimals chip_smoke.py's sim phase prints
PAPER_CHECKS = {
    "stencil": (lambda: specs.star_stencil_3d(4, (512, 512, 640), 8), STENCIL_WINNER,
                (9.29, 8.00), (10.50, 8.00)),
    "lbm": (lambda: specs.lbm_d3q15((256, 256, 256), 8), LBM_WINNER,
            (130.04, 120.00), (129.48, 120.00)),
    "quickstart": (lambda: specs.star_stencil_3d(4, (192, 192, 256), 8), QUICKSTART_WINNER,
                   (13.63, 16.00), (9.57, 8.00)),
}


@pytest.mark.parametrize("case", list(PAPER_CHECKS))
def test_paper_volume_check_on_full_h100_equals_reference(case):
    build, (block, fold), sim_want, est_want = PAPER_CHECKS[case]
    spec, lc = build(), LaunchConfig(block=block, folding=fold)
    sim, ref = _both_l2(spec, lc, machines.H100)
    assert sim == ref
    assert (round(sim["dram_load_bytes_per_lup"], 2),
            round(sim["dram_store_bytes_per_lup"], 2)) == sim_want
    est = estimate_gpu(spec, lc, machines.H100)
    assert (round(est.dram_load_per_lup, 2), round(est.dram_store_per_lup, 2)) == est_want
    ref_est = ref_perfmodel.estimate_gpu(_ref_copy(spec), _ref_copy(lc), ref_machines.H100)
    assert (est.dram_load_per_lup, est.dram_store_per_lup) == (
        ref_est.dram_load_per_lup, ref_est.dram_store_per_lup)


@pytest.mark.parametrize("oracle", [False, True])
def test_sector_ids_stay_int64_past_four_gib(monkeypatch, oracle):
    """Byte addresses past 2**32 (the paper's LBM fields together span 4.2
    GB) keep every sector id in int64, and the port still equals the
    reference: the fields moved 2**40 bytes apart (``chip_smoke.py``)."""
    spec = _smoke(monkeypatch).fields_apart(specs.star_stencil_3d(2, (12, 16, 24), 8))
    lc = LaunchConfig(block=(8, 4, 2))
    vec, ref = _both_l2(spec, lc, SMALL_A100, oracle=oracle)
    assert vec == ref
    table = gridwalk.stream_table(spec, lc, spec.domain)
    it = table.sector_instr_table(32)
    grid = lc.grid_for(spec.domain)
    sec, _, _ = cachesim._wave_events(table, it, list(range(grid[0] * grid[1])), grid,
                                      it.sector_deltas(grid))
    assert sec.dtype == np.int64 and int(sec.max()) * 32 > 2**40
    assert int(sec.max()) < int(gridwalk._SENTINEL)


# --------------------------------------------------------------------------
# wave folding: translation detection, fold counters, fallback
# --------------------------------------------------------------------------
def _counted(fn):
    before = gridwalk.core_stats_snapshot()
    out = fn()
    return out, {k: v - before[k] for k, v in gridwalk.core_stats_snapshot().items()}


def test_wave_folding_counts_translated_waves():
    spec = specs.star_stencil_3d(r=1, domain=(12, 16, 32))
    lc = LaunchConfig(block=(16, 4, 2))  # 16 * 8B = 128B x-step: folds
    vec, delta = _counted(lambda: simulate_l2_waves(spec, lc, SMALL_A100, oracle=False))
    assert delta["waves_folded"] > 0
    assert delta["wave_fallbacks"] == 0
    assert vec == _both_l2(spec, lc, SMALL_A100, oracle=False)[1]


def test_wave_folding_fallback_when_translation_not_sector_aligned():
    # 2-wide x extent with 8B elements -> 16B x-step: sector translation
    # fails, the simulator must rebuild per block and still match
    spec = specs.star_stencil_3d(r=1, domain=(8, 12, 16))
    lc = LaunchConfig(block=(2, 4, 4))
    vec, delta = _counted(lambda: simulate_l2_waves(spec, lc, SMALL_A100, oracle=False))
    assert delta["wave_fallbacks"] > 0
    assert vec == simulate_l2_waves(spec, lc, SMALL_A100, oracle=True)
    assert vec == _both_l2(spec, lc, SMALL_A100, oracle=False)[1]


def test_wave_counters_are_named_in_the_metrics_registry():
    from repro_torch.obs import metrics

    spec = specs.star_stencil_3d(r=1, domain=(12, 16, 32))
    before = metrics.snapshot()
    simulate_l2_waves(spec, LaunchConfig(block=(16, 4, 2)), SMALL_A100, oracle=False)
    after = metrics.snapshot()
    assert after["core.waves_folded"] > before["core.waves_folded"]
    assert after["core.wave_fallbacks"] == before["core.wave_fallbacks"]


def test_oracle_env_flag_selects_ordered_dict_path(monkeypatch):
    spec = specs.streaming_scale(1 << 10)
    lc = LaunchConfig(block=(128, 1, 1))
    calls = []
    real = cachesim._simulate_l2_waves_oracle
    monkeypatch.setattr(cachesim, "_simulate_l2_waves_oracle",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("REPRO_CACHESIM_ORACLE", "1")
    flagged = simulate_l2_waves(spec, lc, SMALL_A100)
    assert calls == [1]
    monkeypatch.delenv("REPRO_CACHESIM_ORACLE")
    assert flagged == simulate_l2_waves(spec, lc, SMALL_A100)
    assert calls == [1]
    monkeypatch.setenv("REPRO_CACHESIM_ORACLE", "0")
    simulate_l2_waves(spec, lc, SMALL_A100)
    assert calls == [1]


def test_replay_spans_carry_the_reference_names():
    from repro_torch import obs

    spec = specs.streaming_scale(1 << 10)
    lc = LaunchConfig(block=(128, 1, 1))
    obs.reset()
    obs.enable()
    try:
        simulate_l2_waves(spec, lc, SMALL_A100)
        simulate_l1_block(spec, lc, SMALL_A100)
    finally:
        obs.disable()
    replays = [r for r in obs.spans() if r.name == "cachesim.replay"]
    obs.reset()
    assert [(r.cat, r.args.get("level")) for r in replays] == [
        ("cachesim", "l2"), ("cachesim", "l1")]


# --------------------------------------------------------------------------
# stream table serving layer
# --------------------------------------------------------------------------
def _streams_equal(a, b):
    assert len(a) == len(b)
    for (l1, s1, f1, st1), (l2, s2, f2, st2) in zip(a, b):
        assert st1 == st2
        assert np.array_equal(l1, l2)
        assert np.array_equal(s1, s2)
        assert [bool(x) for x in f1] == [bool(x) for x in f2]


def test_block_warp_streams_served_from_table_match_reference():
    cases = [
        (specs.star_stencil_3d(r=1, domain=(9, 13, 17)),
         LaunchConfig(block=(4, 4, 2), folding=(1, 2, 1))),
        (specs.matmul_naive(24, 8, 16), LaunchConfig(block=(8, 4, 2))),
        (specs.stencil_2d5pt(domain=(20, 36)), LaunchConfig(block=(2, 16, 1))),
    ]
    for spec, lc in cases:
        grid = lc.grid_for(spec.domain)
        for bidx in [(0, 0, 0),
                     (grid[0] // 2, grid[1] // 2, grid[2] // 2),
                     (grid[0] - 1, grid[1] - 1, grid[2] - 1)]:
            mine = _block_warp_streams(spec, lc, spec.domain, bidx)
            _streams_equal(mine, _block_warp_streams_ref(spec, lc, spec.domain, bidx))
            _streams_equal(mine, ref_cachesim._block_warp_streams(
                _ref_copy(spec), _ref_copy(lc), spec.domain, bidx))


def test_stream_table_shared_across_consumers():
    spec = specs.star_stencil_3d(r=1, domain=(8, 12, 16), name="share-probe")
    lc = LaunchConfig(block=(8, 4, 2))
    _, delta = _counted(lambda: (
        gridwalk.walk_block_l1_fast(spec, lc),
        gridwalk.warp_sector_requests_fast(spec, lc, 32),
        simulate_l1_block(spec, lc, SMALL_A100, oracle=False)))
    assert delta["streams_built"] == 1
    assert delta["streams_shared"] >= 2


def test_stream_table_translation_equals_reference():
    spec = specs.lbm_d3q15((6, 8, 40))
    lc = LaunchConfig(block=(8, 2, 2), folding=(1, 2, 1))
    mine = gridwalk.StreamTable(spec, lc, spec.domain)
    ref = ref_gridwalk.StreamTable(_ref_copy(spec), _ref_copy(lc), spec.domain)
    assert np.array_equal(mine.step_bytes, ref.step_bytes)
    assert mine.step_bytes.dtype == np.int64
    assert np.array_equal(mine.block_delta_bytes((2, 1, 3)), ref.block_delta_bytes((2, 1, 3)))
    a, b = mine.sector_instr_table(32), ref.sector_instr_table(32)
    for name in ("sec", "full", "acc_id", "instr", "instr_len", "ev_is_store",
                 "instr_off", "rank"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert (a.n_instr, a.n_store_events) == (b.n_instr, b.n_store_events)
    grid = lc.grid_for(spec.domain)
    assert np.array_equal(a.sector_deltas(grid), b.sector_deltas(grid))
    deltas = np.array([[0] * len(spec.accesses), [40] * len(spec.accesses)], dtype=np.int64)
    for x, y in zip(gridwalk.batched_instr_events(mine, deltas, 32),
                    ref_gridwalk.batched_instr_events(ref, deltas, 32)):
        assert np.array_equal(x, y)


# --------------------------------------------------------------------------
# shared domain normalization helper, block point counts
# --------------------------------------------------------------------------
def test_domain_zyx_normalization():
    assert domain_zyx((5, 6, 7)) == (5, 6, 7)
    assert domain_zyx((6, 7)) == (1, 6, 7)
    assert domain_zyx((7,)) == (1, 1, 7)
    with pytest.raises(ValueError):
        domain_zyx((1, 2, 3, 4))
    with pytest.raises(ValueError):
        domain_zyx(())


def test_block_points_count_matches_enumeration():
    for domain in [(9, 13, 17), (13, 17), (33,)]:
        lc = LaunchConfig(block=(4, 4, 2), folding=(1, 2, 1))
        grid = lc.grid_for(domain)
        for bidx in [(0, 0, 0), (grid[0] - 1, grid[1] - 1, grid[2] - 1)]:
            n = gridwalk.block_points_count(lc, domain, bidx)
            assert n == len(gridwalk.block_points(lc, domain, bidx))
            assert n == ref_gridwalk.block_points_count(_ref_copy(lc), domain, bidx)


# --------------------------------------------------------------------------
# the grid walk's oracle half against the reference's
# --------------------------------------------------------------------------
ORACLE_CASES = [
    (specs.star_stencil_3d(r=2, domain=(10, 12, 20)), LaunchConfig(block=(8, 4, 2))),
    (specs.star_stencil_3d(r=1, domain=(9, 13, 17)),
     LaunchConfig(block=(4, 4, 2), folding=(1, 2, 1))),
    (specs.lbm_d3q15((6, 8, 12), 4), LaunchConfig(block=(16, 2, 1), folding=(1, 1, 2))),
    (specs.transpose_pad((24, 40)), LaunchConfig(block=(32, 2, 1))),
]


@pytest.mark.parametrize("case", range(len(ORACLE_CASES)))
def test_l1_walk_and_sector_requests_equal_their_loops_and_reference(case):
    spec, lc = ORACLE_CASES[case]
    ref_spec, ref_lc = _ref_copy(spec), _ref_copy(lc)
    cycles = gridwalk.walk_block_l1(spec, lc)
    assert cycles == gridwalk.walk_block_l1_fast(spec, lc)
    assert cycles == ref_gridwalk.walk_block_l1(ref_spec, ref_lc)
    req = gridwalk.warp_sector_requests(spec, lc, 32)
    assert req == gridwalk.warp_sector_requests_fast(spec, lc, 32)
    assert req == ref_gridwalk.warp_sector_requests(ref_spec, ref_lc, 32)


@pytest.mark.parametrize("case", range(len(ORACLE_CASES)))
@pytest.mark.parametrize("which,line", [("loads", 32), ("all", 128), ("stores", 32)])
def test_block_footprint_equals_reference_and_implicit_sets(case, which, line):
    spec, lc = ORACLE_CASES[case]
    grid = lc.grid_for(spec.domain)
    for bidx in [(0, 0, 0), (grid[0] - 1, grid[1] - 1, grid[2] - 1)]:
        got = gridwalk.block_footprint_bytes(spec, lc, line, which, None, bidx)
        assert got == ref_gridwalk.block_footprint_bytes(
            _ref_copy(spec), _ref_copy(lc), line, which, None, bidx)
        accs = {"loads": spec.loads, "stores": spec.stores, "all": spec.accesses}[which]
        assert got == footprint_bytes(accs, lc.block_domain_boxes(bidx, spec.domain), line)


def test_line_tuples_and_visitors_equal_reference():
    spec, lc = ORACLE_CASES[2]
    pts = gridwalk.block_points(lc, spec.domain, (0, 1, 1))
    assert len(pts)
    for acc in spec.accesses:
        ref_acc = _ref_copy(acc)
        for line in (32, 128):
            got = gridwalk.access_line_tuples(acc, pts, 3, line)
            assert got == ref_gridwalk.access_line_tuples(ref_acc, pts, 3, line)
            assert len(got) == len(np.unique(
                gridwalk._access_line_rows(acc, pts, 3, line), axis=0))
        addrs = gridwalk.access_addresses(acc, pts, 3)
        assert np.array_equal(addrs, ref_gridwalk.access_addresses(ref_acc, pts, 3))
        cl, ref_cl = gridwalk.CLVisitor(128), ref_gridwalk.CLVisitor(128)
        bank, ref_bank = gridwalk.BankConflictVisitor(), ref_gridwalk.BankConflictVisitor()
        for w0 in range(0, len(addrs), 16):
            for v in (cl, ref_cl, bank, ref_bank):
                v.count(acc.field.name, addrs[w0:w0 + 16])
        assert (cl.lines, cl.n_lines, cl.volume()) == (
            ref_cl.lines, ref_cl.n_lines, ref_cl.volume())
        assert bank.cycles == ref_bank.cycles > 0


def test_port_access_module_keeps_what_the_simulator_reaches():
    lc = LaunchConfig(block=(4, 4, 2), folding=(1, 2, 1))
    assert access.domain_zyx((6, 7)) == ref_access.domain_zyx((6, 7))
    assert lc.grid_for((9, 13, 17)) == _ref_copy(lc).grid_for((9, 13, 17))
    assert lc.block_extent() == _ref_copy(lc).block_extent()


# --------------------------------------------------------------------------
# examples/torch_quickstart.py
# --------------------------------------------------------------------------
def _quickstart():
    import sys
    from pathlib import Path

    examples = str(Path(__file__).resolve().parents[1] / "examples")
    sys.path.insert(0, examples)
    try:
        import torch_quickstart
    finally:
        sys.path.remove(examples)
    return torch_quickstart


def test_quickstart_scaled_machine_is_the_h100_over_eight():
    small = _quickstart().scaled(machines.H100)
    assert (small.name, small.n_sms, small.l2_bytes) == ("H100/8", 16, 25 * 1024 * 1024 // 8)
    assert (small.dram_bw, small.l2_bw, small.peak_flops_dp) == (
        machines.H100.dram_bw / 8, machines.H100.l2_bw / 8, machines.H100.peak_flops_dp / 8)
    assert (small.clock_hz, small.l1_bytes, small.max_threads_per_sm, small.sector_bytes) == (
        machines.H100.clock_hz, machines.H100.l1_bytes, machines.H100.max_threads_per_sm,
        machines.H100.sector_bytes)
    a100 = _quickstart().scaled(machines.A100)
    assert (a100.name, a100.n_sms, a100.l2_bytes) == ("A100/8", 13, SMALL.l2_bytes)


def test_quickstart_example_ranks_simulates_and_runs_as_the_reference(capsys, monkeypatch):
    from jax.experimental import pallas

    from repro.core.selector import rank_gpu_configs as ref_rank
    from repro.kernels.stencil3d25 import generator as ref_stencil_gen

    # the reference's step 4 traces its Pallas builders, which patch pl.load
    # and pl.store: jax 0.9.0 has neither, so a test-only shim gives the
    # tracer something to patch (as tests/test_torch_suite.py does)
    def load(ref, idx):
        return ref[idx]

    def store(ref, idx, val):
        ref[idx] = val

    monkeypatch.setattr(pallas, "load", load, raising=False)
    monkeypatch.setattr(pallas, "store", store, raising=False)
    ex = _quickstart()
    domain, small_domain = (16, 24, 64), (12, 16, 32)
    out = ex.main(device="cpu", domain=domain, small_domain=small_domain, show=3)
    ref_ranked = ref_rank(ref_specs.star_stencil_3d(r=4, domain=domain), ref_machines.H100,
                          total_threads=1024)
    assert len(out["ranked"]) == len(ref_ranked) == 168
    assert [(rc.launch.block, rc.launch.folding, rc.perf) for rc in out["ranked"]] == \
        [(rc.launch.block, rc.launch.folding, rc.perf) for rc in ref_ranked]
    assert out["launch"] == out["winner"].launch == out["ranked"][0].launch
    assert out["worst"].launch == out["ranked"][-1].launch
    small = out["small"]
    ref_small = _ref_copy(small["machine"])
    ref_best = ref_rank(ref_specs.star_stencil_3d(r=4, domain=small_domain), ref_small)[0]
    assert (small["winner"].launch.block, small["winner"].launch.folding,
            small["winner"].perf) == (ref_best.launch.block, ref_best.launch.folding,
                                      ref_best.perf)
    assert small["sim"] == ref_cachesim.simulate_l2_waves(
        ref_specs.star_stencil_3d(r=4, domain=small_domain), ref_best.launch, ref_small)
    assert out["max_abs_err"] <= ex.TOL["atol"]
    text = capsys.readouterr().out
    assert "validation vs LRU simulator on H100/8" in text
    assert "TPU (Pallas) config selection for the same stencil:" in text
    try:
        ref_tpu = ref_stencil_gen.rank_configs(4, ex.TPU_DOMAIN, elem_bytes=8)[:3]
    finally:
        ref_stencil_gen._candidates.cache_clear()  # no traced spec outlives the shim
    assert len(out["tpu"]) == len(ref_tpu) == 3
    for mine, ref in zip(out["tpu"], ref_tpu):
        assert mine.config == ref.config
        for f in ("bytes_per_work", "limiter", "total_time", "vmem_alloc_bytes"):
            assert getattr(mine.estimate, f) == getattr(ref.estimate, f), f
        assert f"  {ref.config}: {ref.estimate.bytes_per_work:5.1f} B/pt" in text


def test_quickstart_example_never_falls_back_to_the_cpu(monkeypatch):
    import torch

    ex = _quickstart()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main(domain=(16, 24, 64), small_domain=(12, 16, 32))


# --------------------------------------------------------------------------
# chip_smoke.py's helpers for the sim phase and the ranking against the card
# --------------------------------------------------------------------------
def _smoke(monkeypatch):
    import importlib
    import sys
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    sys.modules.pop("chip_smoke", None)
    return importlib.import_module("chip_smoke")


def test_smoke_fields_apart_moves_bases_by_whole_lines(monkeypatch):
    smoke = _smoke(monkeypatch)
    spec = specs.lbm_d3q15((6, 8, 40))
    apart = smoke.fields_apart(spec)
    bases = sorted({a.field.alignment * a.field.elem_bytes for a in apart.accesses})
    assert bases == [k * smoke.FIELDS_APART_BYTES for k in range(3)]
    assert all(b % 128 == 0 for b in bases)
    lc = LaunchConfig(block=(16, 2, 2))
    assert estimate_gpu(apart, lc, SMALL_A100) == estimate_gpu(spec, lc, SMALL_A100)
    vec, ref = _both_l2(apart, lc, SMALL_A100)
    assert vec == ref


def test_smoke_sim_checks_are_the_paper_checks(monkeypatch):
    smoke = _smoke(monkeypatch)
    got = {name: (launch, sim, est) for name, _, _, launch, sim, est in smoke.SIM_CHECKS}
    want = {name: (block_fold, sim, est)
            for name, (_, block_fold, sim, est) in PAPER_CHECKS.items()}
    assert got == want
    domains = {name: domain for name, _, domain, *_ in smoke.SIM_CHECKS}
    assert domains == {"stencil": (512, 512, 640), "lbm": (256, 256, 256),
                       "quickstart": (192, 192, 256)}


@pytest.mark.parametrize("again,place", [
    # the predicted best re-timed slower than the 10 fastest: 11th
    ({0: 3.0}, 11),
    # re-timed faster than all: first
    ({0: 0.5}, 1),
    # among the re-timed ten, three of them faster
    ({0: 1.25}, 4),
])
def test_smoke_retime_place_reads_the_twenty_run_times(monkeypatch, again, place):
    smoke = _smoke(monkeypatch)
    ranked = [SimpleNamespace(launch=SimpleNamespace(block=(i, 1, 1), folding=(1, 1, 1)))
              for i in range(30)]
    # 5-run times: the predicted best (index 0) 2.5 ms, launches 1-10 1.0-1.9 ms
    ms = [2.5] + [1.0 + 0.1 * i for i in range(10)] + [5.0 + i for i in range(19)]
    timed = []

    def cuda_ms(torch, fn, warmup=3, reps=20):
        assert (warmup, reps) == (3, 20)
        i = fn()
        timed.append(i)
        return again.get(i, ms[i])

    monkeypatch.setattr(smoke, "cuda_ms", cuda_ms)
    monkeypatch.setattr(smoke, "say", lambda *a: None)
    got = smoke.retime_place(None, "probe", ranked, lambda launch: launch.block[0], ms)
    assert got == place
    assert sorted(timed) == list(range(11))


def test_quickstart_winner_without_overhang_equals_reference(monkeypatch):
    """The quickstart's winner where its z extent divides Z: the volumes the
    smoke's sim phase holds as constants (it does not run this simulation)."""
    smoke = _smoke(monkeypatch)
    assert smoke.QUICK_DIVIDED_DOMAIN == (256, 192, 256)
    spec = specs.star_stencil_3d(4, smoke.QUICK_DIVIDED_DOMAIN, 8)
    lc = LaunchConfig(block=QUICKSTART_WINNER[0], folding=QUICKSTART_WINNER[1])
    assert smoke.QUICK_DIVIDED_DOMAIN[0] % lc.block_extent()[2] == 0
    sim, ref = _both_l2(spec, lc, machines.H100)
    assert sim == ref
    got = (round(sim["dram_load_bytes_per_lup"], 2), round(sim["dram_store_bytes_per_lup"], 2))
    assert got == smoke.QUICK_DIVIDED_SIM == (6.82, 8.00)
    est = estimate_gpu(spec, lc, machines.H100)
    assert (round(est.dram_load_per_lup, 2), round(est.dram_store_per_lup, 2)) == \
        smoke.QUICK_DIVIDED_EST == (9.07, 8.00)
