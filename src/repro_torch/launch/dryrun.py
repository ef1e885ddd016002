"""Dry run of a cell (a port of ``repro.launch.dryrun``).

Counts one (architecture x input shape x mesh) cell on ``meta`` stand-ins
(nothing allocated, no card needed) and records the memory analysis, the
cost analysis and the collective schedule for the roofline, as the
reference's does from a lowered and compiled program:

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch granite-3-2b --shape decode_32k [--multi-pod] [--out out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --arch A
    PYTHONPATH=src python -m repro_torch.launch.dryrun --local --arch A --shape S

A dry run has two halves.  The analytic half (``count_params``,
``model_flops``, ``input_specs``, the int8-cache choice and
``launch.calibrate.analytic_bytes``) reads only a mesh's axis sizes, and
holds for every mesh.  The counted half (per-device FLOPs, bytes,
collectives and memory, ``core.cost.count_cost``) reads one device's
program.  By default a cell is counted on the reference's production mesh,
(16, 16) or (2, 16, 16) with ``--multi-pod``: a ``DeviceMesh`` on the CPU
over a ``fake`` process group of 256 or 512 ranks (``counting_mesh``), the
step's parameters, optimiser state, batch and caches placed by the
reference's specs as ``meta`` shards, and rank 0's program counted, the
collectives DTensor issues included.  ``--local`` counts the port's one
card instead (``make_local_mesh``, plain tensors).  Rows go to
``experiments/dryrun_torch`` by default, apart from the reference's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

from repro_torch.configs import SHAPES, get_config, valid_cells
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.cost import count_cost
from repro_torch.core.roofline import analyze_cost, report_from_values
from repro_torch.launch.calibrate import analytic_bytes, calibrated_cost
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.lm import init_caches, init_params
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.train.sharding import (
    axis_names,
    is_device_mesh,
    make_batch_shardings,
    make_cache_shardings,
    make_param_shardings,
    mesh_shape,
    place,
    set_activation_axes,
)
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step
from repro_torch.tree import flatten_with_path, leaves

META = torch.device("meta")
OUT_DIR = "experiments/dryrun_torch"


def params_struct(cfg: ArchConfig) -> dict:
    """The parameter tree of ``init_params`` on ``meta``: its shapes and
    dtypes, nothing drawn."""
    return init_params(cfg, generator=None, device=META)


def _names(path) -> list:
    return [str(k) for k in path]


def count_params(p_struct) -> tuple:
    """(total, active) param counts.  As the reference's, ``active`` is
    never discounted: it equals ``total``."""
    total = active = 0
    for path, leaf in flatten_with_path(p_struct):
        names = _names(path)
        n = math.prod(leaf.shape)
        total += n
        if leaf.dim() >= 3 and names[-1] in ("w_gate", "w_up", "w_down") and "moe" in names:
            active += n  # the reference leaves the top_k/n_exp correction to its caller
        else:
            active += n
    return total, active


def model_flops(cfg: ArchConfig, shape: ShapeSpec, p_struct) -> float:
    """Useful FLOPs per step: 6*N_active*tokens (train) / 2*N_active*tokens
    (inference) + the causal-attention term."""
    total = 0
    expert = 0
    for path, leaf in flatten_with_path(p_struct):
        names = _names(path)
        n = math.prod(leaf.shape)
        total += n
        if leaf.dim() >= 3 and names[-1] in ("w_gate", "w_up", "w_down") and any(
            "moe" in s for s in names
        ):
            expert += n
    n_active = total - expert + (expert * cfg.top_k / max(cfg.n_experts, 1))
    if cfg.enc_layers:
        # enc-dec: encoder params see frontend frames, not decoder tokens —
        # weight the per-token count by each stack's share of active params
        enc_frac = cfg.enc_layers / (cfg.enc_layers + cfg.n_layers)
        frame_ratio = cfg.frontend_tokens / max(shape.seq_len, 1)
        n_active = n_active * ((1 - enc_frac) + enc_frac * frame_ratio)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        mult = 6.0
        attn_ctx = shape.seq_len
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        mult = 2.0
        attn_ctx = shape.seq_len
    else:  # decode
        tokens = shape.global_batch
        mult = 2.0
        attn_ctx = min(shape.seq_len, cfg.swa_window or shape.seq_len)
    flops = mult * n_active * tokens
    if cfg.block_pattern == "attn" or cfg.block_pattern == "mamba_hybrid":
        n_attn = (
            cfg.n_layers
            if cfg.block_pattern == "attn"
            else cfg.n_layers // cfg.hybrid_attn_every
        )
        hd = cfg.resolved_head_dim
        # q@k + p@v, causal halves it; train adds backward (x3)
        att = 2.0 * tokens * attn_ctx * cfg.n_heads * hd * 2 * n_attn * 0.5
        flops += att * (3.0 if shape.kind == "train" else 1.0)
    return flops


def _stand_in(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_struct(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    out = {
        "tokens": _stand_in((B, S), torch.int32),
        "labels": _stand_in((B, S), torch.int32),
    }
    if cfg.frontend:
        out["frontend"] = _stand_in((B, cfg.frontend_tokens, cfg.frontend_dim), torch.float32)
    return out


def input_specs(arch: str, shape_name: str):
    """Public entry: ``meta`` stand-ins for every model input of the given
    cell (shapes and dtypes, no allocation)."""
    return cell_input_specs(get_config(arch), SHAPES[shape_name])


def cell_input_specs(cfg: ArchConfig, shape: ShapeSpec):
    if shape.kind == "train":
        return batch_struct(cfg, shape)
    if shape.kind == "prefill":
        bs = batch_struct(cfg, shape)
        bs.pop("labels")
        return bs
    # decode: one new token against a full cache
    B = shape.global_batch
    out = {
        "token": _stand_in((B, 1), torch.int32),
        "positions": _stand_in((B, 1), torch.int32),
        "caches": init_caches(cfg, B, min(shape.seq_len, cfg.swa_window or shape.seq_len),
                              device=META),
    }
    if cfg.enc_layers:
        out["encoder_out"] = _stand_in((B, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
    return out


def kv_int8_for(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """The reference's int8-cache choice: a decode cell whose bf16 KV cache
    spread over 512 devices would take more than 8 GB of a 16 GB chip (its
    ``/ 512`` is the production mesh's size, whatever mesh runs)."""
    if shape.kind in ("decode", "long_decode") and cfg.block_pattern in (
        "attn", "mamba_hybrid"
    ):
        cap = min(shape.seq_len, cfg.swa_window) if cfg.swa_window else shape.seq_len
        n_attn = (cfg.n_layers if cfg.block_pattern == "attn"
                  else cfg.n_layers // cfg.hybrid_attn_every)
        cache_gb = (n_attn * 2 * shape.global_batch * cfg.n_kv * cap
                    * cfg.resolved_head_dim * 2) / 512 / 1e9
        if cache_gb > 8.0:  # bf16 cache alone would crowd a 16GB chip
            return True
    return False


def _data_parallel(mesh) -> int:
    dp = 1
    for a in ("pod", "data"):
        if a in axis_names(mesh):
            dp *= dict(zip(axis_names(mesh), mesh_shape(mesh)))[a]
    return dp


def train_microbatches(cfg: ArchConfig, shape: ShapeSpec, mesh) -> int:
    """The reference's microbatch rule: a per-device microbatch of about 1,
    at most 8 (4 for MoE archs, whose expert gathers repeat a microbatch)."""
    mb = max(1, min(8, shape.global_batch // _data_parallel(mesh)))
    if cfg.n_experts:
        mb = max(1, min(4, mb))
    return mb


def step_cost(cfg: ArchConfig, shape: ShapeSpec, p_struct, microbatches: int = 1, mesh=None):
    """``count_cost`` of the cell's whole step on ``meta``: the train step
    (``microbatches``, the optimiser's update included), the prefill step
    or the decode step, on ``cell_input_specs``' stand-ins.  On a
    ``DeviceMesh`` the parameters (and the moments, which follow them),
    batch and caches are placed by the reference's specs, the tokens of a
    batch-1 prefill sequence-sharded as the reference's are, and one rank's
    program is counted."""
    spec = cell_input_specs(cfg, shape)
    placed = is_device_mesh(mesh)

    def batch(tree, shard_seq=False):
        if not placed:
            return tree
        return place(tree, make_batch_shardings(tree, mesh, shard_seq=shard_seq), mesh)

    params = place(p_struct, make_param_shardings(p_struct, mesh), mesh) if placed else p_struct
    if placed and "caches" in spec:
        spec["caches"] = place(spec["caches"], make_cache_shardings(spec["caches"], mesh), mesh)
    if shape.kind == "train":
        opt = init_opt_state(OptConfig(), params)
        step = make_train_step(cfg, OptConfig(), microbatches=microbatches)
        return count_cost(step, params, opt, batch(spec))[1]
    with torch.no_grad():
        if shape.kind == "prefill":
            cap = shape.seq_len if not cfg.swa_window else min(shape.seq_len, cfg.swa_window)
            args = [batch(spec["tokens"], shard_seq=shape.global_batch == 1)]
            if cfg.frontend:
                args.append(batch(spec["frontend"]))
            return count_cost(make_prefill_step(cfg, cap), params, *args)[1]
        args = [batch(spec["token"]), spec["caches"], batch(spec["positions"])]
        if cfg.enc_layers:
            args.append(batch(spec["encoder_out"]))
        return count_cost(make_decode_step(cfg), params, *args)[1]


def mesh_name(mesh) -> str:
    return "x".join(str(d) for d in mesh_shape(mesh))


@contextlib.contextmanager
def counting_mesh(multi_pod: bool):
    """The reference's production mesh, (16, 16) or (2, 16, 16), as a
    ``DeviceMesh`` on the CPU with its activation axes set.  Where no
    process group is initialised a ``fake`` group of 256 or 512 ranks (this
    process rank 0, which runs no collective) is opened for it and
    destroyed after, and the axes are unset, also on an error.  A group of
    another size raises ``launch.mesh.make_mesh``'s ``RuntimeError``."""
    import torch.distributed as dist

    opened = not dist.is_initialized()
    if opened:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        set_activation_axes(mesh)
        yield mesh
    finally:
        set_activation_axes(None)
        if opened:
            dist.destroy_process_group()


def lower_cell(arch: str, shape_name: str, multi_pod: bool, local: bool = False) -> dict:
    """The reference's row for one cell, counted on the production mesh
    (``counting_mesh``), or with ``local`` on the port's one card (a 1 x 1
    mesh of ``meta``)."""
    if local:
        mesh = make_local_mesh(META)
        set_activation_axes(mesh)
        return _row(arch, shape_name, mesh)
    with counting_mesh(multi_pod) as mesh:
        return _row(arch, shape_name, mesh)


def _row(arch: str, shape_name: str, mesh) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    kv_int8 = kv_int8_for(cfg, shape)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_int8=True)
    n_chips = math.prod(mesh_shape(mesh))
    p_struct = params_struct(cfg)
    n_params = sum(math.prod(leaf.shape) for leaf in leaves(p_struct))
    mb_used = train_microbatches(cfg, shape, mesh) if shape.kind == "train" else 1
    name = f"{arch}/{shape_name}/{mesh_name(mesh)}"

    t0 = time.time()
    cost = step_cost(cfg, shape, p_struct, mb_used, mesh)
    compile_s = time.time() - t0
    mf = model_flops(cfg, shape, p_struct)

    # raw whole-step count (memory proof + collective schedule record)
    raw = analyze_cost(name, cost, n_chips, model_flops_total=mf)
    mem = raw.detail.get("memory_analysis", {})
    print(f"memory_analysis: {mem}")
    print(f"cost_analysis(raw): flops={raw.flops:.3e} bytes={raw.hbm_bytes:.3e}")

    # calibrated per-layer accounting (launch/calibrate.py)
    cc = calibrated_cost(cfg, shape, mesh, microbatches=mb_used, n_params=n_params)
    ab = analytic_bytes(cfg, shape, mesh, mb_used, n_params)
    report = report_from_values(
        raw.name,
        flops=cc.flops,
        hbm_bytes=ab["total"],
        coll_wire_bytes=cc.coll_wire + raw.coll_wire_bytes,
        n_chips=n_chips,
        model_flops_total=mf,
        peak_bytes_per_device=mem.get("peak_bytes", 0),
    )
    row = report.row()
    row.update(
        {
            "arch": arch,
            "shape": shape_name,
            "mesh": mesh_name(mesh),
            "compile_s": compile_s,
            "model_flops": mf,
            "n_params": n_params,
            "kv_int8": kv_int8,
            "raw_cost_analysis": {
                "flops": raw.flops,
                "hbm_bytes": raw.hbm_bytes,
                "coll_wire_bytes": raw.coll_wire_bytes,
                "dot_flops": cost.dot_flops,
                "transcendentals": cost.transcendentals,
            },
            "calibrated_unfused_bytes": cc.bytes,
            "analytic_bytes": {k: float(v) for k, v in ab.items()},
            "collectives": {
                k: {kk: float(vv) for kk, vv in v.items()}
                for k, v in raw.detail["collectives"].items()
            },
            "memory": {k: int(v) for k, v in mem.items()},
        }
    )
    return row


ALL_ARCHS = [
    "rwkv6-1.6b", "qwen1.5-32b", "phi3-mini-3.8b", "qwen1.5-110b",
    "granite-3-2b", "whisper-base", "zamba2-2.7b", "internvl2-76b",
    "mixtral-8x7b", "arctic-480b",
]


def all_cells():
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        for s in valid_cells(cfg):
            yield arch, s.name


def _meshes(local: bool) -> tuple:
    """(suffix, multi_pod) of each mesh a cell is counted on."""
    return (("local", False),) if local else (("sp", False), ("mp", True))


def orchestrate(out_dir: str, jobs: int, multi_pod_list=(False, True),
                timeout: int = 3600, local: bool = False):
    os.makedirs(out_dir, exist_ok=True)
    meshes = _meshes(True) if local else tuple(
        ("mp" if mp else "sp", mp) for mp in multi_pod_list)
    tasks = []
    for arch, shape in all_cells():
        for suffix, mp in meshes:
            name = f"{arch}__{shape}__{suffix}"
            out = os.path.join(out_dir, name + ".json")
            if os.path.exists(out):
                continue
            cmd = [
                sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", shape, "--out", out,
            ] + (["--multi-pod"] if mp else []) + (["--local"] if local else [])
            tasks.append((name, cmd))
    procs: list = []
    results = {}
    while tasks or procs:
        while tasks and len(procs) < jobs:
            name, cmd = tasks.pop(0)
            log = open(os.path.join(out_dir, name + ".log"), "w")
            p = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                 env={**os.environ, "PYTHONPATH": "src"})
            procs.append((name, p, time.time(), log))
            print(f"[dryrun] start {name} ({len(tasks)} queued)")
        for item in list(procs):
            name, p, t0, log = item
            rc = p.poll()
            if rc is None and time.time() - t0 > timeout:
                p.kill()
                rc = p.wait()
            if rc is not None:
                procs.remove(item)
                log.close()
                results[name] = rc
                print(f"[dryrun] done {name} rc={rc} ({time.time()-t0:.0f}s)")
        time.sleep(2)
    failed = {k: v for k, v in results.items() if v != 0}
    print(f"[dryrun] finished: {len(results) - len(failed)} ok, {len(failed)} failed")
    for k in failed:
        print("  FAILED:", k)
    return failed


def sweep_arch(arch: str, out_dir: str, local: bool = False):
    """Run every (shape x mesh) cell of one arch in-process; one JSON per
    cell."""
    os.makedirs(out_dir, exist_ok=True)
    cfg = get_config(arch)
    failed = []
    for s in valid_cells(cfg):
        for suffix, mp in _meshes(local):
            name = f"{arch}__{s.name}__{suffix}"
            out = os.path.join(out_dir, name + ".json")
            if os.path.exists(out):
                continue
            t0 = time.time()
            try:
                row = lower_cell(arch, s.name, mp, local=local)
                with open(out, "w") as f:
                    json.dump(row, f, indent=1)
                print(f"[sweep] {name} OK ({time.time()-t0:.0f}s)", flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                failed.append((name, repr(e)))
                with open(os.path.join(out_dir, name + ".FAILED"), "w") as f:
                    import traceback

                    f.write(traceback.format_exc())
                print(f"[sweep] {name} FAILED: {e!r}", flush=True)
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--local", action="store_true",
                    help="count the cell on the port's one card (a 1 x 1 mesh)")
    ap.add_argument("--out")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sweep", action="store_true", help="all cells of --arch")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    if args.local and args.multi_pod:
        ap.error("--local counts one card; --multi-pod names the (2, 16, 16) mesh")
    if args.sweep:
        failed = sweep_arch(args.arch, args.out_dir, local=args.local)
        sys.exit(1 if failed else 0)
    if args.all:
        failed = orchestrate(args.out_dir, args.jobs, local=args.local)
        sys.exit(1 if failed else 0)
    row = lower_cell(args.arch, args.shape, args.multi_pod, local=args.local)
    print(json.dumps({k: v for k, v in row.items() if k != "collectives"}, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)


if __name__ == "__main__":
    main()
