"""The port's cost source against the reference's: ``repro_torch.core.hlo``
(a copy of ``repro.core.hlo``, and ``collective_bytes_of`` for the
collectives a torch program issues), ``repro_torch.core.cost.count_cost``
(the counterpart of XLA's ``cost_analysis()`` and ``memory_analysis()``)
and ``core.roofline.analyze_cost`` (of ``analyze_compiled``), and the
blocks that ``repro_torch.launch.calibrate.calibrated_cost`` counts.

Tolerances (the reduced configs, as these comparisons read when the bounds were set):

* every block's product FLOPs equal the reference's ``dot_general`` FLOPs
  from its jaxpr exactly, but for one product the port does not make: the
  reference's ``xent`` takes the label's logit by a one-hot einsum
  (2·B·S·V), where the port's gathers it (``train/step.py``);
* a block's FLOPs against the reference's ``cost_analysis()`` on a 1 x 1
  mesh: XLA's CPU backend casts each bf16 weight matrix to fp32 before its
  product and counts the cast, one flop an element, where the port casts
  nothing and counts casts as none.  With those casts added, the port's
  count read 0.895-1.101 of XLA's (decode and head blocks, whose products
  are small beside their elementwise work, at the ends): ``BLOCK_FLOPS_REL``
  0.12.  One granite-3-2b block at full width (B 1, S 4096) read 0.9972 of
  XLA's 6.405e11 without the casts: ``FULL_BLOCK_FLOPS_REL`` 0.01.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

import jax  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import hlo  # noqa: E402
from repro_torch.core.cost import count_cost  # noqa: E402
from repro_torch.core.roofline import analyze_cost  # noqa: E402
from repro_torch.launch import calibrate  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402

BLOCK_FLOPS_REL = 0.12
FULL_BLOCK_FLOPS_REL = 0.01
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the HLO texts of tests/test_data_optim_sharding.py:test_hlo_wire_factors and
# tests/test_layers_misc.py:test_hlo_parser_edge_cases, and an empty one
HLO_TEXTS = {
    "wire_factors": """
      %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
      %ag = bf16[64,128]{1,0} all-gather(bf16[8,128]{1,0} %p), dimensions={0}, replica_groups=[4,8]<=[32]
    """,
    "edge_cases": """
      %ag1 = bf16[32,64]{1,0} all-gather-start(bf16[2,64]{1,0} %x), replica_groups=[4,16]<=[64], dimensions={0}
      %ag2 = bf16[32,64]{1,0} all-gather-done(bf16[32,64]{1,0} %ag1)
      %rs = f32[8,8]{1,0} reduce-scatter(f32[64,8]{1,0} %y), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add
    """,
    "empty": "",
}


def _plain(d: dict) -> dict:
    return json.loads(json.dumps(d))


@pytest.mark.parametrize("text", sorted(HLO_TEXTS))
def test_collective_bytes_equals_reference(text):
    from repro.core import hlo as ref

    assert _plain(hlo.collective_bytes(HLO_TEXTS[text])) == _plain(
        ref.collective_bytes(HLO_TEXTS[text]))
    for kind in ref.COLLECTIVE_KINDS:
        for g in (1, 2, 4, 8, 16, 256):
            assert hlo.wire_factor(kind, g) == ref.wire_factor(kind, g)
    assert hlo.DTYPE_BYTES == ref.DTYPE_BYTES and hlo.COLLECTIVE_KINDS == ref.COLLECTIVE_KINDS


# each collective as _c10d_functional issues it on a group of 4, and the HLO
# line of the same collective
COLLECTIVE_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    from repro_torch.core.cost import count_cost
    ops, name = torch.ops._c10d_functional, dist.group.WORLD.group_name
    calls = {
        "all_reduce": lambda x, y: ops.all_reduce(x, "sum", name),
        "all_gather_into_tensor": lambda x, y: ops.all_gather_into_tensor(y, 4, name),
        "reduce_scatter_tensor": lambda x, y: ops.reduce_scatter_tensor(x, "sum", 4, name),
        "all_to_all_single": lambda x, y: ops.all_to_all_single(x, [2] * 4, [2] * 4, name),
    }
    x, y = torch.randn(8, 16), torch.randn(2, 128, dtype=torch.bfloat16)
    out = {}
    for op, call in calls.items():
        res, cost = count_cost(lambda a, b: ops.wait_tensor(call(a, b)), x, y)
        out[op] = [cost.collectives, list(res.shape)]
    dist.destroy_process_group()
    print(json.dumps(out))
""")
HLO_LINES = {
    "all_reduce": "%ar = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %x), "
                  "replica_groups={{0,1,2,3}}, to_apply=%add",
    "all_gather_into_tensor": "%ag = bf16[8,128]{1,0} all-gather(bf16[2,128]{1,0} %y), "
                              "replica_groups={{0,1,2,3}}, dimensions={0}",
    "reduce_scatter_tensor": "%rs = f32[2,16]{1,0} reduce-scatter(f32[8,16]{1,0} %x), "
                             "replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add",
    "all_to_all_single": "%a2a = f32[8,16]{1,0} all-to-all(f32[8,16]{1,0} %x), "
                         "replica_groups={{0,1,2,3}}, dimensions={0}",
}


def test_collective_bytes_of_equals_the_hlo_line():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    res = subprocess.run([sys.executable, "-c", COLLECTIVE_SCRIPT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert sorted(got) == sorted(HLO_LINES)
    for op, (coll, shape) in got.items():
        assert coll == _plain(hlo.collective_bytes(HLO_LINES[op])), op
        assert coll["total"]["count"] == 1 and coll["total"]["wire_bytes"] > 0, op
    assert got["all_gather_into_tensor"][1] == [8, 128]
    assert got["reduce_scatter_tensor"][1] == [2, 16]


def test_count_cost_conventions():
    a, b = torch.randn(4, 8), torch.randn(8, 16)

    def f(a, b):
        c = torch.einsum("ij,jk->ik", a, b)          # 2·4·8·16 product flops
        d = torch.exp(c)                             # 64 transcendentals
        e = (d * 2.0 + 1.0).sum()                    # 64 + 64 flops, a sum of 64
        return e + torch.einsum("i,j->ij", a[0], b[0]).float().sum()  # outer: 2·8·16

    out, cost = count_cost(f, a, b)
    assert torch.isfinite(out)
    assert cost.dot_flops == 2 * 4 * 8 * 16 + 2 * 8 * 16
    assert cost.transcendentals == 64
    assert cost.flops == cost.dot_flops + 64 * 3 + 128 + 1
    assert cost.argument_bytes == (32 + 128) * 4
    assert cost.collectives["total"] == {"count": 0, "payload_bytes": 0, "wire_bytes": 0}
    # the same program on meta: the same counts, nothing allocated
    _, meta = count_cost(f, a.to("meta"), b.to("meta"))
    assert (meta.flops, meta.dot_flops, meta.transcendentals, meta.bytes, meta.peak_bytes) == (
        cost.flops, cost.dot_flops, cost.transcendentals, cost.bytes, cost.peak_bytes)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="inference_mode"):
        count_cost(f, a, b)


def test_count_cost_memory_and_recompute():
    """temp_bytes is the peak of what lives beside the arguments; tensors
    autograd saves count until the backward frees them; a remat recompute
    is counted."""
    from torch.utils.checkpoint import checkpoint

    n, rows, width = 8, 1024, 64
    x = torch.randn(rows, width)
    w = torch.randn(width, width, requires_grad=True)

    def block(x):
        return torch.tanh(x @ w) @ w

    def plain(x):
        for _ in range(n):
            x = block(x)
        return torch.autograd.grad(x.sum(), w)[0]

    def remat(x):
        for _ in range(n):
            x = checkpoint(block, x, use_reentrant=False)
        return torch.autograd.grad(x.sum(), w)[0]

    _, c0 = count_cost(plain, x)
    _, c1 = count_cost(remat, x)
    gemm = 2 * rows * width * width
    # forward 2n; backward 2n for w and 2n - 1 for x (the input needs none)
    assert c0.dot_flops == gemm * (2 * n + 2 * n + 2 * n - 1)
    # each block's recompute stops after its tanh (the last product's
    # output is saved by nothing): one product a block more
    assert c1.dot_flops == c0.dot_flops + n * gemm
    act = rows * width * 4
    assert c0.argument_bytes == act                   # the weight is not an argument
    assert c0.temp_bytes >= 2 * n * act               # two saved activations a block
    assert c1.temp_bytes < c0.temp_bytes - (n - 2) * act  # remat saves one a block, not two
    assert c0.peak_bytes == c0.argument_bytes + c0.temp_bytes
    assert c0.output_bytes == width * width * 4


def test_analyze_cost_builds_analyze_compiled_report():
    """The report of ``analyze_cost`` from a Cost holding a compiled JAX
    object's numbers equals the reference's ``analyze_compiled``."""
    import jax.numpy as jnp

    from repro.core.roofline import analyze_compiled
    from repro_torch.core.cost import Cost

    compiled = jax.jit(lambda a, b: jnp.tanh(a @ b).sum()).lower(
        jax.ShapeDtypeStruct((64, 128), jnp.float32),
        jax.ShapeDtypeStruct((128, 32), jnp.float32)).compile()
    want = analyze_compiled("cell", compiled, 4, model_flops_total=1e6)
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    mem = want.detail["memory_analysis"]
    cost = Cost(flops=ca["flops"], bytes=ca["bytes accessed"],
                argument_bytes=mem["argument_bytes"], output_bytes=mem["output_bytes"],
                temp_bytes=mem["temp_bytes"], peak_bytes=mem["peak_bytes"],
                collectives=hlo.collective_bytes(compiled.as_text()))
    got = analyze_cost("cell", cost, 4, model_flops_total=1e6)
    assert got.row() == want.row()
    assert _plain(got.detail) == _plain(want.detail)
    assert (got.coll_payload_bytes, got.t_bound, got.roofline_fraction) == (
        want.coll_payload_bytes, want.t_bound, want.roofline_fraction)


# ---------------------------------------------------------------------------
# calibrate's blocks against the reference's
# ---------------------------------------------------------------------------
def _jaxpr_dot_flops(jaxpr) -> int:
    """2 x result elements x contracted size of every dot_general, a scan
    body's times its length, through every sub-jaxpr."""
    from jax.extend import core as jcore

    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(lhs[i] for i in lc)
        times = eqn.params.get("length", 1) if eqn.primitive.name == "scan" else 1
        for sub in eqn.params.values():
            for s in sub if isinstance(sub, (list, tuple)) else (sub,):
                j = s.jaxpr if isinstance(s, jcore.ClosedJaxpr) else s
                if isinstance(j, jcore.Jaxpr):
                    total += times * _jaxpr_dot_flops(j)
    return total


# (kind, S, B, microbatches) of the reduced cells
CELLS = {"train": ("train", 64, 4, 2), "decode": ("decode", 128, 2, 1),
         "prefill": ("prefill", 64, 2, 1)}


def _reference_blocks(monkeypatch, arch, cell, measure):
    """The reference's calibrated_cost on a 1 x 1 mesh with each block
    handed to ``measure(fn, arg_structs, in_shardings, mesh, chunk_hint)``;
    the blocks in the port's order (the layer parts, then the head)."""
    import repro.launch.calibrate as rc
    from repro.configs import get_config as ref_config
    from repro.configs.base import ShapeSpec as RefShape

    seen = []

    def cost_of(*args, **kw):
        seen.append(measure(*args, **kw))
        return 0.0, 0.0, 0.0

    monkeypatch.setattr(rc, "_cost_of", cost_of)
    kind, S, B, mb = CELLS[cell]
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    rc.calibrated_cost(ref_config(arch).reduced(), RefShape("x", S, B, kind), mesh,
                       microbatches=mb)
    return [seen[0]] + seen[2:] + [seen[1]]


def _port_blocks(arch, cell):
    kind, S, B, mb = CELLS[cell]
    cc = calibrate.calibrated_cost(get_config(arch).reduced(), ShapeSpec("x", S, B, kind),
                                   make_local_mesh("meta"), microbatches=mb)
    return cc, [block for _, block in cc.detail["blocks"]]


@pytest.mark.parametrize("cell", ["train", "decode"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_block_products_equal_reference_jaxpr(monkeypatch, arch, cell):
    import repro.layers.attention as ra
    import repro.layers.ssm as rs

    def dots(fn, arg_structs, in_shardings, mesh, chunk_hint=None):
        ra.CHUNK_OVERRIDE[0] = rs.CHUNK_OVERRIDE[0] = chunk_hint
        try:
            return _jaxpr_dot_flops(jax.make_jaxpr(fn)(*arg_structs).jaxpr)
        finally:
            ra.CHUNK_OVERRIDE[0] = rs.CHUNK_OVERRIDE[0] = None

    want = _reference_blocks(monkeypatch, arch, cell, dots)
    cc, got = _port_blocks(arch, cell)
    cfg = get_config(arch).reduced()
    kind, S, B, mb = CELLS[cell]
    if kind == "train":  # the reference's one-hot label product (its xent)
        want[-1] -= 2 * (B // mb) * S * cfg.padded_vocab
    assert [b.dot_flops for b in got] == want
    assert all(b.coll_wire == 0 for b in got)


def _bf16_matrices(tree) -> int:
    return sum(math.prod(x.shape) for x in jax.tree.leaves(tree)
               if x.ndim >= 2 and x.dtype == jax.numpy.bfloat16)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_block_flops_near_reference_cost_analysis(monkeypatch, arch):
    import repro.launch.calibrate as rc

    real = rc._cost_of

    def xla(fn, arg_structs, in_shardings, mesh, chunk_hint=None):
        flops = real(fn, arg_structs, in_shardings, mesh, chunk_hint)[0]
        return flops, _bf16_matrices(arg_structs[0])

    for cell in ("train", "decode"):
        want = _reference_blocks(monkeypatch, arch, cell, xla)
        _, got = _port_blocks(arch, cell)
        for block, (flops, casts) in zip(got, want, strict=True):
            assert block.flops + casts == pytest.approx(flops, rel=BLOCK_FLOPS_REL), (cell, block)


def test_full_width_block_flops_near_reference():
    """One granite-3-2b attention block at full width, B 1 x 4096: the
    port's count within FULL_BLOCK_FLOPS_REL of XLA's (6.405e11), and its
    products equal the reference's dot_generals."""
    import repro.launch.calibrate as rc
    from repro.configs import get_config as ref_config

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    flops, _, coll = rc._layer_fwd_cost(ref_config("granite-3-2b"), mesh, 1, 4096)
    got = calibrate._layer_fwd_cost(get_config("granite-3-2b"), make_local_mesh("meta"), 1, 4096)
    assert got.flops == pytest.approx(flops, rel=FULL_BLOCK_FLOPS_REL)
    assert got.dot_flops < got.flops and coll == got.coll_wire == 0
    cfg = get_config("granite-3-2b")
    E, F, H, K, D = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim
    # projections, SwiGLU and the whole 4096 x 4096 square of scores (chunked)
    gemms = 2 * 4096 * (E * (H + 2 * K) * D + H * D * E + 3 * E * F)
    assert got.dot_flops == gemms + 2 * 2 * H * 4096 * 4096 * D


def test_calibrated_cost_refuses_a_larger_mesh():
    """A record of a (16, 16) mesh (axis names and a device array) cannot
    place the blocks' arguments: counting on it raises ``ValueError``
    naming the ``DeviceMesh`` it needs, and never counts one device."""
    class Mesh:
        axis_names = ("data", "model")
        devices = np.empty((16, 16), dtype=object)

    with pytest.raises(ValueError, match="DeviceMesh"):
        calibrate.calibrated_cost(get_config("granite-3-2b").reduced(),
                                  ShapeSpec("x", 64, 4, "train"), Mesh(), microbatches=2)
