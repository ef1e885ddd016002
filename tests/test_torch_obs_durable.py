"""The port's copies of the engine's support modules: telemetry
(``repro_torch.obs``), durability (``repro_torch.durable``) and fault
injection (``repro_torch.faults``), held to the reference's formats and
behaviour on the same inputs.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro import durable as ref_durable  # noqa: E402
from repro import faults as ref_faults  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402
from repro_torch import durable, faults, obs  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs.metrics import CounterGroup, cache_stats_view  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _clean_obs():
    """Telemetry state is process-global: every test starts and ends
    disabled and empty."""
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


# ---- durable -----------------------------------------------------------------
def test_frames_are_the_reference_format():
    for payload in (b"", b"x", bytes(range(256)) * 5):
        assert durable.frame(payload) == ref_durable.frame(payload)
    assert (durable.FRAME_MAGIC, durable.FRAME_OVERHEAD) == (
        ref_durable.FRAME_MAGIC, ref_durable.FRAME_OVERHEAD)


def test_journal_recovers_a_torn_tail(tmp_path):
    path = tmp_path / "j.log"
    journal = durable.Journal(path)
    for i in range(3):
        assert journal.append(f"record {i}".encode()) == i
    whole = path.read_bytes()
    with open(path, "ab") as f:         # a kill mid-append: half a frame
        f.write(durable.frame(b"lost record")[:20])
    payloads, valid, torn = durable.scan(path)
    assert torn and valid == len(whole) and len(payloads) == 3
    payloads, torn = durable.Journal(path).recover()
    assert torn and payloads == [b"record 0", b"record 1", b"record 2"]
    assert path.read_bytes() == whole
    assert Path(str(path) + ".tail").read_bytes() == durable.frame(b"lost record")[:20]
    durable.Journal(path).append(b"record 3")
    assert durable.scan(path) == ([b"record %d" % i for i in range(4)],
                                  path.stat().st_size, False)
    # the reference replays the port's journal frame for frame
    assert ref_durable.scan(path)[0] == durable.scan(path)[0]


def test_bit_rot_ends_the_committed_prefix(tmp_path):
    path = tmp_path / "j.log"
    for i in range(3):
        durable.Journal(path).append(b"payload %d" % i)
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0xFF                      # last frame's payload: its digest fails
    path.write_bytes(bytes(raw))
    payloads, torn = durable.Journal(path).recover()
    assert torn and payloads == [b"payload 0", b"payload 1"]


def test_torn_write_fault_site_loses_only_that_record(tmp_path):
    path = tmp_path / "j.log"
    plan = faults.FaultPlan(faults={"io.torn_write": faults.FaultSpec(at=(1,))})
    with faults.injected(plan) as inj:
        for i in range(3):
            durable.Journal(path).append(b"r%d" % i)
        assert inj.stats()["io.torn_write"] == {"calls": 3, "fired": 1}
    payloads, torn = durable.Journal(path).recover()
    assert torn and payloads == [b"r0"]


def test_atomic_write_replaces_whole_files_and_leaves_no_temp(tmp_path):
    path = tmp_path / "nested" / "out.json"
    durable.atomic_write(path, "first")
    durable.atomic_write(path, b"second")
    assert path.read_bytes() == b"second"
    assert [p.name for p in path.parent.iterdir()] == ["out.json"]


# ---- faults ------------------------------------------------------------------
def test_fault_plans_match_the_reference():
    spec = dict(rate=0.25, at=(0, 3), max_fires=2, arg=1.5)
    mine = faults.FaultPlan(seed=7, faults={"pool.worker_hang": faults.FaultSpec(**spec)})
    ref = ref_faults.FaultPlan(seed=7, faults={"pool.worker_hang": ref_faults.FaultSpec(**spec)})
    assert mine.to_json() == ref.to_json()
    assert faults.plan_from_env(mine.to_json()) == mine
    assert faults.SITES == ref_faults.SITES and faults.ENV_VAR == ref_faults.ENV_VAR
    fired = []
    for inj in (faults.FaultInjector(mine), ref_faults.FaultInjector(ref)):
        fired.append([inj.fires("pool.worker_hang") is not None for _ in range(64)])
    assert fired[0] == fired[1] and sum(fired[0]) == 2
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultPlan(faults={"pool.worker_crsh": faults.FaultSpec()})
    with pytest.raises(ValueError, match="not valid JSON"):
        faults.plan_from_env("{")


def test_corrupt_bytes_site_flips_the_reference_byte():
    data = bytes(range(200))
    plan = dict(seed=5, faults={"invcache.load": (0,)})
    with faults.injected(faults.FaultPlan(
            seed=5, faults={"invcache.load": faults.FaultSpec(at=(0,))})):
        mine = faults.corrupt_bytes("invcache.load", data)
    with ref_faults.injected(ref_faults.FaultPlan(
            seed=plan["seed"], faults={"invcache.load": ref_faults.FaultSpec(at=(0,))})):
        ref = ref_faults.corrupt_bytes("invcache.load", data)
    assert mine == ref != data
    assert faults.corrupt_bytes("invcache.load", data) == data   # no plan: untouched


# ---- obs ---------------------------------------------------------------------
def test_counter_groups_are_closed_and_documented():
    from repro_torch.core.engine import TaskPool
    from repro_torch.core.gridwalk import CORE_STATS

    group = CounterGroup("test_torch.group", {"hits": "a documented counter"},
                         register=False)
    group["hits"] += 2
    assert dict(group) == {"hits": 2}
    with pytest.raises(KeyError, match="no declared counter"):
        group["misses"] = 1
    TaskPool()
    described = metrics.describe()
    for name in ("core.streams_built", "pool.health.rebuilds", "engine.cache.hits"):
        assert name in described
    assert set(CORE_STATS) == {"streams_built", "streams_shared", "waves_folded",
                               "wave_fallbacks"}


@pytest.mark.parametrize("canon", [
    {"engine.cache.hits": 3, "engine.cache.misses": 4, "engine.sweep.pruned": 0},
    {"engine.sweep.degraded": 1, "engine.sweep.bound_evals": 9},
    {"pool.health.rebuilds": 1, "pool.health.retries": 0, "core.streams_built": 2,
     "engine.axis.geometry_groups": 1, "serve.coalesced": 1},
])
def test_cache_stats_view_equals_reference(canon):
    assert cache_stats_view(canon) == ref_metrics.cache_stats_view(canon)
    assert metrics.CACHE_STATS_KEYS == ref_metrics.CACHE_STATS_KEYS


def test_spans_nest_and_cross_a_worker_boundary():
    assert obs.span("off") is obs.span("also off")      # the shared no-op
    assert obs.current_context() is None
    obs.enable()
    with obs.span("engine.sweep", kind="exhaustive") as sweep:
        with obs.span("pool.run", "pool") as run:
            ctx = obs.current_context()
            assert ctx == (sweep.trace_id, run.span_id)
    shipped = []

    def worker():                         # the pool's side, in a thread here
        obs.adopt(ctx)
        with obs.span("pool.chunk", "pool", tasks=3):
            pass
        shipped.extend(obs.drain())

    before = obs.spans()
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    obs.reset()
    obs.ingest(before + [tuple(r) for r in shipped])
    recs = {r.name: r for r in obs.spans()}
    assert recs["pool.run"].parent_id == recs["engine.sweep"].span_id
    assert recs["pool.chunk"].parent_id == recs["pool.run"].span_id
    assert recs["pool.chunk"].args == {"tasks": 3}
    assert "engine.sweep" in obs.summary()


def test_chrome_trace_is_written_atomically(tmp_path):
    obs.enable()
    with obs.span("engine.sweep", kind="pruned"):
        pass
    out = obs.write_trace(str(tmp_path / "trace.json"))
    events = json.loads(Path(out).read_text())["traceEvents"]
    assert [e["name"] for e in events if e["ph"] == "X"] == ["engine.sweep"]
    assert any(e["ph"] == "M" and e["args"]["name"] == "repro_torch" for e in events)


def test_trace_env_var_dumps_a_sweep_at_exit(tmp_path):
    out = tmp_path / "env-trace.json"
    code = (
        "from repro_torch import obs\n"
        "from repro_torch.api import gpu_request, price\n"
        "from repro_torch.core.specs import stencil_2d5pt\n"
        "assert obs.enabled()\n"
        "price(gpu_request(stencil_2d5pt((32, 64)), 'H100', top_k=3))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_TRACE_OUT=str(out))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = {e.get("name") for e in json.loads(out.read_text())["traceEvents"]}
    assert {"engine.sweep", "engine.bounds", "engine.refine", "engine.rank",
            "gridwalk.stream_table"} <= names
