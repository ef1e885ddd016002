"""The port's exploration engine (``repro_torch.core.engine``).

Its staged, memoized sum is ``estimate_gpu`` bit for bit; a pooled sweep
(started with ``forkserver`` from a parent that looks as if it had started
CUDA, and with ``spawn``) returns the serial ranking and carries the
workers' spans home, and its forkserver does not outlive the parent; the
start method is never ``fork`` once CUDA has started; a top-k is the
exhaustive head; the persistent cache makes a warm run skip all structural
work and ignores damaged, foreign and other-version files; the selector and the generators rank through the engine.  The
reference's rankings are held to the port's in ``test_torch_api.py``.
"""
import dataclasses
import io
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import machines as ref_machines  # noqa: E402
from repro.core import specs as ref_specs  # noqa: E402
from repro.core.engine import Explorer as RefExplorer  # noqa: E402
from repro.core.selector import enumerate_gpu_configs as ref_enumerate  # noqa: E402
from repro_torch.core import machines, specs  # noqa: E402
from repro_torch.core.access import LaunchConfig  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    ENGINE_CACHE_VERSION,
    Explorer,
    InvariantCache,
    TaskPool,
    pool,
)
from repro_torch.core.engine.explorer import SweepCheckpoint  # noqa: E402
from repro_torch.core.engine.invariants import _MAGIC  # noqa: E402
from repro_torch.core.perfmodel import estimate_gpu  # noqa: E402
from repro_torch.core.selector import (  # noqa: E402
    enumerate_gpu_configs,
    paper_block_sizes,
    paper_foldings,
    rank_gpu_configs,
)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
SMALL = machines.GPUMachine(name="A100/8", n_sms=13, clock_hz=1.41e9, l1_bytes=192 * 1024,
                            l2_bytes=20 * 1024 * 1024 // 8, dram_bw=1400e9 / 8,
                            l2_bw=5000e9 / 8, peak_flops_dp=9.7e12 / 8)
SPEC = specs.star_stencil_3d(2, (24, 32, 64))
CONFIGS = enumerate_gpu_configs()


def _estimate_key(est):
    """Every float the model emits, for bitwise comparison."""
    return (est.perf_lups, est.limiter, tuple(sorted(est.limiter_rates.items())),
            est.l1_cycles_per_lup, est.l2_l1_load_per_lup, est.l2_l1_store_per_lup,
            est.dram_load_per_lup, est.dram_store_per_lup,
            dataclasses.astuple(est.dram_breakdown), dataclasses.astuple(est.l2_breakdown))


def _ranking_key(report):
    return [(e.workload, e.machine, e.index, e.config, _estimate_key(e.estimate))
            for e in report.entries]


def test_staged_sum_bitwise_equals_estimate_gpu_full_paper_grid():
    configs = [LaunchConfig(block=b, folding=f)
               for b in paper_block_sizes() for f in paper_foldings()]
    direct = sorted(((c, estimate_gpu(SPEC, c, SMALL)) for c in configs),
                    key=lambda t: -t[1].perf_lups)   # stable: ties keep enumeration order
    report = Explorer()._rank_gpu(SPEC, SMALL, configs)
    assert len(report.entries) == len(direct) == 168 and not report.skipped
    for entry, (cfg, est) in zip(report.entries, direct):
        assert entry.config == cfg
        assert _estimate_key(entry.estimate) == _estimate_key(est)


@pytest.mark.parametrize("k", [1, 5, 40])
@pytest.mark.parametrize("spec", [SPEC, specs.lbm_d3q15((6, 12, 20)),
                                  specs.stencil_2d5pt((64, 128))], ids=lambda s: s.name)
def test_top_k_is_the_exhaustive_head(spec, k):
    full = Explorer()._rank_gpu(spec, machines.H100, CONFIGS)
    top = Explorer()._rank_gpu(spec, machines.H100, CONFIGS, top_k=k)
    assert _ranking_key(top) == _ranking_key(full)[:k]
    assert len(top.entries) + len(top.pruned) <= len(CONFIGS)
    assert all(p.bound > p.threshold for p in top.pruned)


def test_cache_shares_structure_across_one_geometry():
    ex = Explorer()
    ex._rank_gpu(SPEC, machines.A100, CONFIGS[:12])
    misses = ex.cache.misses
    # A100-80G: the same geometry, another L2 and DRAM: every walk, block
    # footprint and wave count is shared, no structural work is new
    again = ex._rank_gpu(SPEC, machines.A100_80G, CONFIGS[:12])
    assert machines.A100.geometry == machines.A100_80G.geometry
    assert ex.cache.misses == misses and again.cache_stats["pool_tasks"] == 0
    assert _ranking_key(again) == _ranking_key(Explorer()._rank_gpu(
        SPEC, machines.A100_80G, CONFIGS[:12]))


def test_estimation_errors_are_skips_and_strict_raises():
    # an empty domain has an empty wave (ValueError), a zero block extent
    # divides by zero (an ArithmeticError, a skip in the port)
    empty = dataclasses.replace(SPEC, domain=(0, 8, 8))
    cfg, zero = LaunchConfig(block=(32, 4, 8)), LaunchConfig(block=(0, 1, 1))
    report = Explorer()._rank_gpu(empty, SMALL, [cfg])
    assert not report.entries and len(report.skipped) == 1
    assert report.skipped[0].config == cfg and "empty wave" in report.skipped[0].reason
    with pytest.raises(ValueError, match="empty wave"):
        Explorer()._rank_gpu(empty, SMALL, [cfg], strict=True)
    for top_k in (None, 1):
        report = Explorer()._rank_gpu(SPEC, SMALL, [zero, cfg], top_k=top_k)
        assert [s.config for s in report.skipped] == [zero]
        assert report.skipped[0].reason.startswith("ZeroDivisionError")
        with pytest.raises(ZeroDivisionError):
            Explorer()._rank_gpu(SPEC, SMALL, [zero], top_k=top_k, strict=True)


# ---- the pool's start method ------------------------------------------------
def test_pool_never_forks_once_cuda_has_started(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(pool, "_main_reimportable", lambda: True)
    assert pool._context().get_start_method() == "forkserver"
    monkeypatch.setattr(pool, "_main_reimportable", lambda: False)
    assert pool._context() is None      # no safe pool: the serial path
    with TaskPool(parallel=True, max_workers=2) as p:
        assert p.run([(divmod, (7, 2)), (divmod, (9, 4))]) == [("ok", (3, 1)), ("ok", (2, 1))]
        assert p._executor is None


def test_pool_forks_a_clean_parent_and_asks_torch_only_if_loaded(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    if "fork" in multiprocessing.get_all_start_methods():
        assert pool._context().get_start_method() == "fork"
    monkeypatch.setitem(sys.modules, "jax", object())   # a thread-starting runtime, by name
    assert not pool._fork_safe()
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.delitem(sys.modules, "torch")
    assert not pool._cuda_started() and "torch" not in sys.modules


_POOLED = r'''
import json, os, sys


def main(method):
    import multiprocessing
    import torch
    from repro_torch import obs
    from repro_torch.api import PriceRequest, price
    from repro_torch.core import machines, specs
    from repro_torch.core.engine import Explorer, Workload, pool
    from repro_torch.core.selector import enumerate_gpu_configs

    if method == "forkserver":
        torch.cuda.is_initialized = lambda: True     # as after CUDA started
    else:
        pool._context = lambda: multiprocessing.get_context(method)
    small = machines.GPUMachine(name="A100/8", n_sms=13, clock_hz=1.41e9,
                                l1_bytes=192 * 1024, l2_bytes=20 * 1024 * 1024 // 8,
                                dram_bw=1400e9 / 8, l2_bw=5000e9 / 8,
                                peak_flops_dp=9.7e12 / 8)
    configs = tuple(enumerate_gpu_configs())
    work = [specs.star_stencil_3d(2, (24, 32, 64)), specs.lbm_d3q15((6, 12, 20)),
            specs.stencil_2d5pt((64, 128)), specs.transpose_pad((96, 160)),
            specs.matmul_naive(64, 48, 80, 4)]

    def request(top_k):
        return PriceRequest(workloads=[Workload(s.name, gpu_spec=s, gpu_configs=configs)
                                       for s in work],
                            machines=[machines.H100, small], top_k=top_k)

    def key(result):
        return [[e.workload, e.machine, e.index, list(e.config.block),
                 list(e.config.folding), e.perf.hex(), e.limiter,
                 repr(sorted(e.estimate.limiter_rates.items())),
                 repr(e.estimate.dram_breakdown), repr(e.estimate.l2_breakdown)]
                for e in result.entries]

    out = {"method": pool._context().get_start_method(), "pid": os.getpid()}
    for top_k in (None, 7):
        serial = price(request(top_k))
        obs.reset()
        obs.enable()
        pooled = price(request(top_k), engine=Explorer(parallel=True, max_workers=2))
        obs.disable()
        recs = obs.spans()
        by_id = {r.span_id: r for r in recs}
        chunks = [r for r in recs if r.name == "pool.chunk"]
        tasks = [r for r in recs if r.cat == "task"]
        metrics = {k: v for k, v in pooled.report.metrics.items()
                   if not k.startswith("core.")}
        want = {k: v for k, v in serial.report.metrics.items()
                if not k.startswith("core.")}
        out[str(top_k)] = {
            "identical": key(pooled) == key(serial),
            "key": key(pooled),
            "metrics_equal": metrics == want,
            "pool_health": {k: v for k, v in metrics.items() if k.startswith("pool.")},
            "chunks": len(chunks),
            "chunk_pids": sorted({r.pid for r in chunks}),
            "chunks_under_pool_run": all(
                by_id[c.parent_id].name == "pool.run" and by_id[c.parent_id].pid == os.getpid()
                for c in chunks),
            "task_spans_in_workers": bool(tasks) and all(r.pid != os.getpid() for r in tasks),
            "sweep_spans": sorted({r.name for r in recs if r.pid == os.getpid()}),
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
'''


@pytest.mark.parametrize("method", ["forkserver", "spawn"])
def test_pooled_sweep_equals_serial_and_carries_worker_spans(tmp_path, method):
    """In a fresh interpreter (its ``__main__`` a file, so a non-fork pool
    can start), the five specs on two machines, exhaustive and top-k."""
    script = tmp_path / "pooled.py"
    script.write_text(_POOLED)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_FAULT_PLAN", None)
    env.pop("REPRO_TRACE_OUT", None)
    proc = subprocess.run([sys.executable, str(script), method], capture_output=True,
                          text=True, timeout=180, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["method"] == method
    for top_k in ("None", "7"):
        run = out[top_k]
        assert run["identical"] and run["metrics_equal"], top_k
        assert set(run["pool_health"].values()) == {0}
        assert run["chunks"] > 0 and out["pid"] not in run["chunk_pids"]
        assert len(run["chunk_pids"]) <= 2
        assert run["chunks_under_pool_run"] and run["task_spans_in_workers"]
        assert {"engine.sweep", "engine.rank", "pool.run"} <= set(run["sweep_spans"])
    assert {"engine.bounds", "engine.refine"} <= set(out["7"]["sweep_spans"])
    # the pooled top-k is the reference's, bitwise
    ref_small = ref_machines.GPUMachine(**{f.name: getattr(SMALL, f.name)
                                           for f in dataclasses.fields(SMALL)})
    ref = RefExplorer()._rank_gpu(ref_specs.lbm_d3q15((6, 12, 20)), ref_small,
                                  ref_enumerate(), top_k=7)
    mine = [k for k in out["7"]["key"] if k[:2] == ["lbm_d3q15", "A100/8"]]
    assert [(k[2], tuple(k[3]), tuple(k[4]), float.fromhex(k[5]), k[6]) for k in mine] == \
        [(e.index, e.config.block, e.config.folding, e.perf, e.limiter) for e in ref.entries]


_HELPERS = r"""
import json, os, sys
from pathlib import Path


def children():
    return sorted(int(p.parent.name) for p in Path("/proc").glob("[0-9]*/stat")
                  if int(p.read_text().rsplit(")", 1)[1].split()[1]) == os.getpid())


def main(stop):
    import torch
    from multiprocessing import forkserver
    from repro_torch.api import gpu_request, price
    from repro_torch.core import machines, specs
    from repro_torch.core.engine import Explorer, pool

    torch.cuda.is_initialized = lambda: True     # as after CUDA started
    result = price(gpu_request(specs.star_stencil_3d(2, (24, 32, 64)), machines.H100),
                   engine=Explorer(parallel=True, max_workers=2))
    out = {"method": pool._context().get_start_method(), "entries": len(result.entries),
           "forkserver": forkserver._forkserver._forkserver_pid}
    if stop == "explicit":
        pool.stop_helpers()
        out["children"] = children()
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
"""


@pytest.mark.parametrize("stop", ["explicit", "at_exit"])
def test_pooled_sweep_leaves_no_process_behind(tmp_path, stop):
    """The forkserver a pooled sweep starts after CUDA is stopped and reaped,
    by ``pool.stop_helpers`` or at the parent's exit, not left to outlive it."""
    script = tmp_path / "helpers.py"
    script.write_text(_HELPERS)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_FAULT_PLAN", None)
    proc = subprocess.run([sys.executable, str(script), stop], capture_output=True,
                          text=True, timeout=120, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["method"] == "forkserver" and out["entries"] == len(CONFIGS)
    assert out["forkserver"] is not None
    assert out.get("children", []) == []
    assert not Path(f"/proc/{out['forkserver']}").exists()


# ---- the persistent invariant cache -----------------------------------------
def test_warm_persistent_cache_skips_all_structural_work(tmp_path):
    path = tmp_path / "inv.cache"
    cold = Explorer(cache_path=str(path))._rank_gpu(SPEC, SMALL, CONFIGS[:8])
    assert cold.cache_stats["misses"] > 0 and path.exists()
    # a second sweep appends a journal segment
    Explorer(cache_path=str(path))._rank_gpu(SPEC, machines.H100, CONFIGS[:4])
    assert Path(str(path) + ".journal").exists()
    warm_explorer = Explorer(cache_path=str(path))
    assert warm_explorer.cache.loaded_entries > 0
    assert warm_explorer.cache.stats()["journal_segments"] == 1
    for machine, n in ((SMALL, 8), (machines.H100, 4)):
        warm = warm_explorer._rank_gpu(SPEC, machine, CONFIGS[:n])
        assert warm.cache_stats["misses"] == 0 and warm.cache_stats["pool_tasks"] == 0
        assert _ranking_key(warm) == _ranking_key(Explorer()._rank_gpu(SPEC, machine,
                                                                       CONFIGS[:n]))


def test_damaged_and_other_version_cache_files_are_ignored(tmp_path):
    path = tmp_path / "inv.cache"
    path.write_bytes(b"\x00garbage not a pickle at all\xff" * 64)
    cache = InvariantCache(path=str(path))
    assert cache.loaded_entries == 0 and cache.health["corrupt_quarantined"] == 1
    assert Path(str(path) + ".corrupt").exists() and not path.exists()

    Explorer(cache_path=str(path))._rank_gpu(SPEC, SMALL, CONFIGS[:2])
    with open(path, "rb") as f:
        pickle.load(f)          # header
        pickle.load(f)          # digest
        payload = f.read()
    with open(path, "wb") as f:
        pickle.dump({"magic": _MAGIC, "version": ENGINE_CACHE_VERSION + 1}, f)
        pickle.dump(b"", f)
        f.write(payload)
    cache = InvariantCache(path=str(path))
    assert cache.loaded_entries == 0 and cache.health["version_skew"] == 1
    assert path.exists()        # another version's file is left in place

    blob = bytearray(path.read_bytes())
    blob[-40:] = b"\xff" * 40   # bit rot in the payload: the digest rejects it
    with open(path, "wb") as f:
        pickle.dump({"magic": _MAGIC, "version": ENGINE_CACHE_VERSION}, f)
        pickle.dump(b"0" * 32, f)
        f.write(bytes(blob))
    cache = InvariantCache(path=str(path))
    assert cache.loaded_entries == 0 and cache.health["corrupt_quarantined"] == 1
    warm = Explorer(cache=cache)._rank_gpu(SPEC, SMALL, CONFIGS[:2])
    assert _ranking_key(warm) == _ranking_key(Explorer()._rank_gpu(SPEC, SMALL, CONFIGS[:2]))


class _RefusingPickle:
    """``pickle`` as the engine modules see it, except that unpickling a
    class of the reference package fails and is noted."""

    def __init__(self):
        self.tried = []

    def _unpickler(self, f):
        tried = self.tried

        class Unpickler(pickle.Unpickler):
            def find_class(self, module, name):
                if module == "repro" or module.startswith("repro."):
                    tried.append(f"{module}.{name}")
                    raise pickle.UnpicklingError(module)
                return super().find_class(module, name)

        return Unpickler(f)

    def load(self, f):
        return self._unpickler(f).load()

    def loads(self, data):
        return self._unpickler(io.BytesIO(data)).load()

    def __getattr__(self, name):
        return getattr(pickle, name)


def test_reference_files_are_foreign_and_never_unpickled(tmp_path, monkeypatch):
    from repro_torch.core.engine import explorer, invariants

    ref_spec = ref_specs.star_stencil_3d(2, (24, 32, 64))
    path, ckpt = tmp_path / "inv.cache", tmp_path / "sweep.ckpt"
    RefExplorer(cache_path=str(path), resume=str(ckpt))._rank_gpu(
        ref_spec, ref_machines.H100, ref_enumerate()[:3])
    RefExplorer(cache_path=str(path))._rank_gpu(ref_spec, ref_machines.A100,
                                                ref_enumerate()[:3])
    assert Path(str(path) + ".journal").exists()
    spy = _RefusingPickle()
    monkeypatch.setattr(invariants, "pickle", spy)
    monkeypatch.setattr(explorer, "pickle", spy)
    cache = InvariantCache(path=str(path))
    # the base blob and the journal's segment: foreign, left in place
    assert cache.loaded_entries == 0
    assert cache.health["version_skew"] == 2
    assert cache.health["corrupt_quarantined"] == cache.health["load_errors"] == 0
    assert path.exists()
    assert len(SweepCheckpoint(str(ckpt))) == 0
    assert spy.tried == []
    # and the port's own files load through the same refusing unpickler
    Explorer(cache_path=str(tmp_path / "own.cache"), resume=str(tmp_path / "own.ckpt"))._rank_gpu(
        SPEC, SMALL, CONFIGS[:3])
    own = InvariantCache(path=str(tmp_path / "own.cache"))
    assert own.loaded_entries > 0 and len(SweepCheckpoint(str(tmp_path / "own.ckpt"))) == 1
    assert spy.tried == []


def test_sweep_checkpoint_resumes_completed_cells(tmp_path):
    ckpt = tmp_path / "sweep.ckpt"
    first = Explorer(resume=str(ckpt))._rank_gpu(SPEC, SMALL, CONFIGS[:6], top_k=3)
    again = Explorer(resume=str(ckpt))._rank_gpu(SPEC, SMALL, CONFIGS[:6], top_k=3)
    assert again.metrics["engine.sweep.resumed_cells"] == 1
    assert again.metrics["engine.sweep.pool_tasks"] == 0
    assert _ranking_key(again) == _ranking_key(first)


# ---- the selector and the generators ----------------------------------------
def test_rank_gpu_configs_ranks_through_the_explorer(monkeypatch):
    calls = []
    real = Explorer._rank_gpu

    def spy(self, *a, **kw):
        calls.append(kw)
        return real(self, *a, **kw)

    monkeypatch.setattr(Explorer, "_rank_gpu", spy)
    engine = Explorer()
    ranked = rank_gpu_configs(SPEC, SMALL, engine=engine, top_k=4)
    assert len(calls) == 1 and calls[0]["top_k"] == 4
    assert len(ranked) == 4 and ranked.report.entries[0].estimate is ranked[0].estimate
    assert len(engine.cache) > 0 and ranked.cache_stats["pruned"] == len(ranked.pruned) > 0
    full = rank_gpu_configs(SPEC, SMALL, engine=engine)
    assert [(r.launch, r.perf) for r in full[:4]] == [(r.launch, r.perf) for r in ranked]
    assert full.skipped == [] and full.report.skipped == []


def test_generator_ranking_is_the_engine_ranking_and_keeps_its_memo():
    from repro_torch.kernels import SCRATCH_REASON
    from repro_torch.kernels.stencil3d25.generator import rank_configs, zmarch_space

    ranked = rank_configs(2, (24, 32, 64), 8, machines.H100)
    report = ranked.report
    assert [(rc.launch, rc.perf) for rc in ranked] == [(e.config, e.perf) for e in report.entries]
    # the variants the generator does not rank are its own records
    variants = list(zmarch_space(2, (24, 32, 64)))
    assert report.skipped == [] and [s.config for s in ranked.skipped] == variants
    assert [s.reason for s in ranked.skipped] == [SCRATCH_REASON] * len(variants) == [
        SCRATCH_REASON] * 3
    assert {(s.workload, s.machine) for s in ranked.skipped} == {(SPEC.name, machines.H100.name)}
    ranked.skipped.clear()
    assert len(rank_configs(2, (24, 32, 64), 8, machines.H100).skipped) == 3
