"""The port's pricing service against the reference's (``repro.serve``).

Both packages speak one wire protocol: the codec's bytes, the request
digests and the memo journal's frames are the same.  So a request the port
serves gets the answer ``repro.api.price`` gives in-process, equal on the
wire once the sweep's measurements of itself are set aside (a GPU request
and a ``plan_request``); the port's client
against the reference's daemon and the reference's client against the
port's daemon give those answers too; and a memo journal one package's
``Scheduler`` wrote restores warm in the other's.  Each request is built
once, in the port, and reaches the reference through its own codec.  The
reference prices a plan's TPU half from specs its tracer cannot build on
the installed jax, so plan tests take ``test_torch_suite.ref_declared``.
"""
import os

import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.core.engine import Explorer as RefExplorer  # noqa: E402
from repro.serve import PriceClient as RefClient  # noqa: E402
from repro.serve import PricingDaemon as RefDaemon  # noqa: E402
from repro.serve import Scheduler as RefScheduler  # noqa: E402
from repro.serve import schema as ref_schema  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core.access import LaunchConfig  # noqa: E402
from repro_torch.core.engine import Explorer  # noqa: E402
from repro_torch.core.machines import GPUMachine  # noqa: E402
from repro_torch.core.specs import lbm_d3q15, star_stencil_3d  # noqa: E402
from repro_torch.serve import PriceClient, PricingDaemon, Scheduler, schema  # noqa: E402
from repro_torch.serve.daemon import can_bind_unix_sockets  # noqa: E402
from test_torch_suite import ref_declared  # noqa: E402,F401

SMALL = GPUMachine(
    name="A100/8", n_sms=13, clock_hz=1.41e9, l1_bytes=192 * 1024,
    l2_bytes=20 * 1024 * 1024 // 8, dram_bw=1400e9 / 8, l2_bw=5000e9 / 8,
    peak_flops_dp=9.7e12 / 8,
)
CONFIGS = [LaunchConfig(block=b) for b in [(64, 4, 2), (32, 4, 4), (8, 8, 8)]]

needs_sockets = pytest.mark.skipif(
    not can_bind_unix_sockets(os.environ.get("TMPDIR", "/tmp")),
    reason="environment cannot bind Unix sockets")


def _gpu_request():
    """Two kernels on the 1/8-scaled A100 and the H100, one request."""
    from repro_torch.core.engine import Workload

    return api.PriceRequest(
        workloads=[Workload("star", gpu_spec=star_stencil_3d(2, (24, 32, 64)),
                            gpu_configs=tuple(CONFIGS)),
                   Workload("lbm", gpu_spec=lbm_d3q15((6, 12, 20)),
                            gpu_configs=tuple(CONFIGS))],
        machines=[SMALL, "H100"], top_k=2)


def _plan_request():
    return api.plan_request({"g": api.PlanRef("granite-3-2b", "decode_32k")},
                            ["H100", "TPUv5e"], top_k=2)


REQUESTS = {"gpu": _gpu_request, "plan": _plan_request}
#: what a sweep measures of itself: its host time and its counters, which
#: follow the process's memo tables as well (streams built or shared)
MEASURED = ("wall_time_s", "cache_stats", "metrics")


def _answer(obj, codec):
    """``codec.encode(obj)`` with the sweep's own measurements
    (``MEASURED``) dropped: the answer, which two sweeps must agree on."""
    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items() if k not in MEASURED}
        if isinstance(node, list):
            return [strip(x) for x in node]
        return node

    return strip(codec.encode(obj))


def _ref(request):
    """The reference's instance of a port request, through its codec."""
    ref = ref_schema.loads(schema.dumps(request))
    assert ref_schema.request_digest(ref) == schema.request_digest(request)
    return ref


@pytest.fixture
def requests_for(request):
    """The port request named by the test's ``kind``, and its reference
    twin; plan requests price the reference's TPU half declared."""
    kind = request.node.callspec.params["kind"]
    if kind == "plan":
        request.getfixturevalue("ref_declared")
    mine = REQUESTS[kind]()
    return mine, _ref(mine)


@needs_sockets
@pytest.mark.parametrize("kind", list(REQUESTS))
def test_served_answer_equals_reference_price_on_the_wire(tmp_path, kind, requests_for):
    mine, ref = requests_for
    want = ref_api.price(ref, engine=RefExplorer())
    sock = str(tmp_path / "serve.sock")
    with PricingDaemon(sock, engine=Explorer(parallel=False)):
        with PriceClient(sock, timeout=120) as c:
            served = c.price(mine)
    assert served.entries
    assert _answer(served, schema) == _answer(want, ref_schema)
    if kind == "plan":
        assert served.suite.table() == want.suite.table()


@needs_sockets
@pytest.mark.parametrize("kind", list(REQUESTS))
def test_port_client_against_reference_daemon(tmp_path, kind, requests_for):
    mine, ref = requests_for
    local = api.price(mine, engine=Explorer())
    sock = str(tmp_path / "ref.sock")
    with RefDaemon(sock, engine=RefExplorer()):
        with PriceClient(sock, timeout=120) as c:
            assert c.ping()
            first, again = c.price_many([mine, mine])
            stats = c.stats()
    assert type(first) is api.PriceResult
    assert _answer(first, schema) == _answer(local, schema)
    assert _answer(again, schema) == _answer(local, schema)
    assert stats["requests"] == 2 and stats["keys_priced"] == 1


@needs_sockets
@pytest.mark.parametrize("kind", list(REQUESTS))
def test_reference_client_against_port_daemon(tmp_path, kind, requests_for):
    mine, ref = requests_for
    want = ref_api.price(ref, engine=RefExplorer())
    sock = str(tmp_path / "port.sock")
    with PricingDaemon(sock, engine=Explorer(parallel=False)):
        with RefClient(sock, timeout=120) as c:
            assert c.ping()
            first, again = c.price_many([ref, ref])
            stats = c.stats()
    assert type(first) is ref_api.PriceResult
    assert _answer(first, ref_schema) == _answer(want, ref_schema)
    assert _answer(again, ref_schema) == _answer(want, ref_schema)
    assert stats["requests"] == 2 and stats["keys_priced"] == 1


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_memo_journal_restores_warm_across_packages(tmp_path, writer):
    """A memo journal the reference's ``Scheduler`` wrote restores warm in
    the port's, and the other way round: same header, digests and wire."""
    memo = str(tmp_path / "memo.journal")
    mine = _gpu_request()
    ref = _ref(mine)
    digest = schema.request_digest(mine)
    first, second = ((RefScheduler, ref), (Scheduler, mine))
    if writer == "port":
        first, second = second, first
    sched = first[0](memo_path=memo)
    wire = sched.encoded(digest, sched.submit(first[1], digest).result(120))
    assert sched.shutdown(wait=True)

    warm = second[0](memo_path=memo, restore_memo=True)
    try:
        assert warm.memo_restored == 1
        result = warm.submit(second[1], digest).result(120)
        assert warm.counters["memo_hits"] == 1
        assert warm.counters["keys_priced"] == 0
        assert warm.encoded(digest, result) == wire
    finally:
        assert warm.shutdown(wait=True)
