"""The dry run's counted half on a mesh: ``repro_torch.core.cost.count_cost``
on DTensor programs (one rank's local ops and the collectives DTensor
issues), ``launch.calibrate``'s blocks placed on a (2, 2) mesh against the
reference's per-device ``cost_analysis()`` and HLO collectives, and
``launch.dryrun.lower_cell`` on the production meshes.

Each mesh is a ``DeviceMesh`` over torch's ``fake`` process group (this
process rank 0 of 4, 256 or 512, which runs no collective), its shards on
``meta``.  The reference runs in a subprocess with four host devices and
``Auto`` axes (``REFERENCE_SCRIPT``).  Bounds, from the reduced configs as
the comparisons read when they were set:

* (2, 2) identity: granite-3-2b's reduced attention block, train forward
  and decode, has every product divide the mesh, so a device's product
  FLOPs times 4 are one device's, exactly;
* a block's FLOPs a device, with XLA's per-device weight casts added (one
  flop a bf16 matrix element of the device's shard), within
  ``BLOCK_FLOPS_REL`` 0.12 of the reference's per-device
  ``cost_analysis()`` (``tests/test_torch_hlo_cost.py``'s bound on one
  device): 0.9150-1.1178 for the train-forward blocks.  Not where XLA's
  partitioner repeats a block's work on every device (``XLA_REPLICATES``):
  there its four devices' count read 1.685-2.645 times its own one-device
  count (the decode blocks: the weights gathered whole, and the products
  of the one new token taken against them on each device; zamba2-2.7b's
  Mamba block in training 1.938), where the port's read 1.000-1.707 (its
  products exactly a quarter but for the MoE's and the recurrent blocks'
  small replicated parts).  There XLA's count must exceed the port's;
* collectives: the port's wire bytes over the reference's, each config's
  train and decode blocks summed, read 0.6461 (mixtral-8x7b) to 1.7075
  (rwkv6-1.6b); ``COLL_WIRE_BAND`` is that span widened 1.25 times each
  way.  DTensor picks other collectives than XLA's SPMD partitioner (each
  kind's count and bytes printed beside the reference's): all-gathers and
  reduce-scatters where XLA all-reduces a partial sum, no permutes, and on
  a CPU mesh an all-gather and a chunk for each all-to-all
  (``torch.distributed.tensor``'s fallback where the group's device is the
  CPU).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import hlo  # noqa: E402
from repro_torch.core.cost import count_cost  # noqa: E402
from repro_torch.launch import calibrate, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_mesh  # noqa: E402
from repro_torch.train import sharding  # noqa: E402
from test_torch_sharding import fake_group  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_FLOPS_REL = 0.12
COLL_WIRE_BAND = (0.6461 / 1.25, 1.7075 * 1.25)
STEP_REL = 1e-2
# (kind, S, B, microbatches) of the reduced cells, as tests/test_torch_hlo_cost.py's
CELLS = {"train": ("train", 64, 4, 2), "decode": ("decode", 128, 2, 1)}
# (arch, cell, block index) where XLA's partitioned program repeats the
# block's work on each device: every decode block, and zamba2-2.7b's Mamba
# block in training
XLA_REPLICATES = {(a, "decode", i) for a in ARCHS for i in range(3)} | {
    ("zamba2-2.7b", "train", 0)}

# the reference's calibrated blocks on a (2, 2) mesh: each block's
# per-device flops, its per-device bf16 weight elements (the casts XLA's
# CPU backend counts) and the collectives of its HLO, in the port's order
REFERENCE_SCRIPT = textwrap.dedent("""
    import json, math
    import jax
    import repro.launch.calibrate as rc
    from repro.configs import ARCHS, get_config
    from repro.configs.base import ShapeSpec
    from repro.train.sharding import set_activation_axes

    CELLS = json.loads(%r)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    set_activation_axes(mesh)
    real, real_bytes = rc._cost_of, rc.collective_bytes
    out = {}
    for arch in sorted(ARCHS):
        for cell, (kind, S, B, mb) in CELLS.items():
            seen = []

            def measure(fn, arg_structs, in_shardings, mesh, chunk_hint=None):
                coll = {}

                def keep(text):
                    coll.update(real_bytes(text))
                    return coll

                rc.collective_bytes = keep
                try:
                    flops = real(fn, arg_structs, in_shardings, mesh, chunk_hint)[0]
                finally:
                    rc.collective_bytes = real_bytes
                casts = sum(math.prod(s.shard_shape(x.shape)) for x, s in zip(
                    jax.tree.leaves(arg_structs[0]), jax.tree.leaves(in_shardings[0]))
                    if x.ndim >= 2 and x.dtype == jax.numpy.bfloat16)
                seen.append({"flops": flops, "casts": casts, "coll": coll})
                return 0.0, 0.0, 0.0

            rc._cost_of = measure
            try:
                rc.calibrated_cost(get_config(arch).reduced(), ShapeSpec("x", S, B, kind), mesh,
                                   microbatches=mb)
            finally:
                rc._cost_of = real
            out[arch + "/" + cell] = [seen[0]] + seen[2:] + [seen[1]]
    print(json.dumps(out))
""") % json.dumps(CELLS)


@pytest.fixture(scope="module")
def blocks():
    """{"arch/cell": (the port's blocks on a (2, 2) mesh, the reference's)}:
    the reference's subprocess runs while the port counts."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {}
    try:
        with fake_group(4):
            mesh = make_mesh((2, 2), ("data", "model"), "cpu")
            for arch in sorted(ARCHS):
                for cell, (kind, S, B, mb) in CELLS.items():
                    cc = calibrate.calibrated_cost(get_config(arch).reduced(),
                                                   ShapeSpec("x", S, B, kind), mesh,
                                                   microbatches=mb)
                    port[f"{arch}/{cell}"] = [b for _, b in cc.detail["blocks"]]
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    return {k: (port[k], want[k]) for k in port}


def test_count_cost_counts_one_rank_of_a_dtensor_program():
    """(x @ w) @ w2 on a (16, 16) mesh of 256 fake ranks, x's rows over
    'data' and the product's inner dim over 'model': rank 0's two local
    products, the all-reduce of the partial sum over a group of 16 with its
    wire bytes by ``wire_factor``, rank 0's shards as the arguments; the
    same counts again once DTensor's propagation cache is warm."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def f(x, w, w2):
        y = (x @ w) @ w2
        return y.redistribute(y.device_mesh, [Shard(0), Replicate()])

    with fake_group(256):
        mesh = make_mesh((16, 16), ("data", "model"), "cpu")

        def placed(shape, placements):
            return DTensor.from_local(torch.empty(shape, device="meta"), mesh, placements,
                                      run_check=False)

        x = placed((512, 512), [Shard(0), Replicate()])   # (8192, 512) whole
        w = placed((512, 128), [Replicate(), Shard(1)])   # (512, 2048)
        w2 = placed((128, 512), [Replicate(), Shard(0)])  # (2048, 512)
        assert x.shape == (8192, 512) and w.shape == (512, 2048)
        costs = []
        for _ in range(2):
            out, cost = count_cost(f, x, w, w2)
            costs.append(cost)
        assert out.to_local().shape == (512, 512)
    payload = 512 * 512 * 4
    for cost in costs:
        assert cost.dot_flops == 2 * 512 * 512 * 128 + 2 * 512 * 128 * 512
        assert cost.collectives["all-reduce"] == {
            "count": 1, "payload_bytes": payload,
            "wire_bytes": payload * hlo.wire_factor("all-reduce", 16)}
        assert cost.collectives["total"]["count"] == 1
        assert cost.argument_bytes == (512 * 512 + 2 * 512 * 128) * 4
        assert cost.output_bytes == payload
    assert costs[0] == costs[1]


@pytest.mark.parametrize("cell", ["train", "decode"])
def test_two_by_two_products_are_a_quarter_of_one_device(cell):
    """granite-3-2b's reduced attention block on a (2, 2) mesh: the batch
    over 'data', the heads, KV heads and MLP over 'model' all divide, so
    a device's products times 4 are one device's, exactly; the block's
    collectives are counted."""
    cfg = get_config("granite-3-2b").reduced()
    kind, S, B, _ = CELLS[cell]
    args = (B, S) if kind == "train" else (B, 1, S)
    one = calibrate._layer_fwd_cost(cfg, make_local_mesh("meta"), *args)
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        four = calibrate._layer_fwd_cost(cfg, mesh, *args)
    assert four.dot_flops * 4 == one.dot_flops > 0
    assert one.coll_wire == 0 < four.coll_wire
    assert four.cost.argument_bytes < one.cost.argument_bytes


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_block_flops_near_reference_at_two_by_two(blocks, arch):
    for cell in CELLS:
        got, want = blocks[f"{arch}/{cell}"]
        assert len(got) == len(want)
        for i, (block, ref) in enumerate(zip(got, want, strict=True)):
            mine = block.flops + ref["casts"]
            if (arch, cell, i) in XLA_REPLICATES:
                assert mine * (1 + BLOCK_FLOPS_REL) < ref["flops"], (cell, i, mine / ref["flops"])
            else:
                assert mine == pytest.approx(ref["flops"], rel=BLOCK_FLOPS_REL), (cell, i, block)


def test_block_collectives_against_reference_hlo(blocks, capsys):
    """Each kind's count and wire bytes beside the reference's HLO parse,
    printed; each config's total wire over the reference's inside
    ``COLL_WIRE_BAND``."""
    ratios = {}
    with capsys.disabled():
        print()
        for arch in sorted(ARCHS):
            mine, theirs = {}, {}
            for cell in CELLS:
                got, want = blocks[f"{arch}/{cell}"]
                for block, ref in zip(got, want, strict=True):
                    for into, coll in ((mine, block.cost.collectives), (theirs, ref["coll"])):
                        for kind, v in coll.items():
                            n, wire = into.get(kind, (0, 0.0))
                            into[kind] = (n + v["count"], wire + v["wire_bytes"])
            ratios[arch] = mine["total"][1] / theirs["total"][1]
            print(f"{arch}: wire {ratios[arch]:.4f}x the reference's; port " + ", ".join(
                f"{k} {n} {w:.0f} B" for k, (n, w) in sorted(mine.items())) + "; reference "
                + ", ".join(f"{k} {n} {w:.0f} B" for k, (n, w) in sorted(theirs.items())))
    for arch, r in ratios.items():
        assert COLL_WIRE_BAND[0] <= r <= COLL_WIRE_BAND[1], (arch, r)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_lower_cell_on_the_production_meshes(multi_pod):
    """granite-3-2b's decode_32k at full width through ``lower_cell`` on
    (16, 16) and (2, 16, 16), in this process: the reference's keys, the
    mesh's name, collectives counted, the products a device times the
    devices equal to one device's count, the raw products within
    ``STEP_REL`` of the calibrated ones; no process group left open."""
    import torch.distributed as dist

    row = dryrun.lower_cell("granite-3-2b", "decode_32k", multi_pod)
    local = dryrun.lower_cell("granite-3-2b", "decode_32k", False, local=True)
    assert not dist.is_initialized()
    assert set(row) == set(local)
    n, name = (512, "2x16x16") if multi_pod else (256, "16x16")
    assert row["mesh"] == name and row["collectives"]
    raw = row["raw_cost_analysis"]
    assert raw["coll_wire_bytes"] > 0 and row["coll_wire_GB"] * 1e9 > raw["coll_wire_bytes"]
    assert raw["dot_flops"] * n == local["raw_cost_analysis"]["dot_flops"]
    assert row["memory"]["peak_bytes"] < local["memory"]["peak_bytes"] / 100
    assert row["analytic_bytes"]["total"] < local["analytic_bytes"]["total"]
    cfg = get_config("granite-3-2b")
    with dryrun.counting_mesh(multi_pod) as mesh:
        cal = calibrate.calibrated_cost(cfg, SHAPES["decode_32k"], mesh)
    assert not dist.is_initialized()
    assert raw["dot_flops"] == pytest.approx(cal.detail["dot_flops"], rel=STEP_REL)


def test_counting_mesh_closes_its_group_and_refuses_another():
    import torch.distributed as dist

    with pytest.raises(ZeroDivisionError):
        with dryrun.counting_mesh(False) as mesh:
            assert sharding.mesh_shape(mesh) == (16, 16) and sharding.tp_size() == 16
            1 / 0
    assert not dist.is_initialized() and sharding.activation_mesh() is None
    with fake_group(4):
        with pytest.raises(RuntimeError, match="needs a process group of 256 ranks; this "
                                               "process has a process group of 4 ranks"):
            with dryrun.counting_mesh(False):
                pass
        assert dist.is_initialized()


def test_attention_repeats_kv_heads_where_only_query_heads_divide():
    """8 query heads over a 'model' axis of 4 with 2 KV heads: each rank
    holds its query heads and the KV head of their group, and its shard
    equals those heads of one device's attention (a fake group sends
    nothing: replicated to sharded is a local slice)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.layers import attention

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, h, 16, 8, generator=g) for h in (8, 2, 2))
    one = attention.chunked_attention(q, k, v, chunk=8)
    with fake_group(4):
        mesh = make_mesh((1, 4), ("data", "model"), "cpu")
        sharding.set_activation_axes(mesh)
        rep = [Replicate(), Replicate()]
        out = attention.chunked_attention(
            *(DTensor.from_local(x, mesh, rep, run_check=False) for x in (q, k, v)), chunk=8)
        assert out.placements[1].is_shard(1)
        assert torch.equal(out.to_local(), one[:, :2])
