#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA H100.

Runs the paper's fig.-1 loop through the port's own entry points at the
paper's §5.2 size (range-4 star stencil, 25 points, domain (512, 512, 640),
fp64): builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
ranks all 168 launches of the per-point kernel analytically on the H100,
runs ``star_stencil`` at the winning launch, and holds every kernel against
its plain PyTorch version on the card.  It then times each kernel beside its
bound, its plain version and one library call that computes the same
function.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  It exits nonzero, and prints no result,
without a CUDA device or without the repository beside it.  The last line
of its output is ``{"ok": true, "device": {...}}``; the line before it is
the ``{"kernels": [...]}`` record.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
R = 4
DOMAIN = (512, 512, 640)          # (Z, Y, X), paper §5.2
EDGE_DOMAIN = (509, 511, 637)     # no block extent divides it: edge guards run
ZMARCH_VARIANTS = ({"variant": "ring"},
                   {"variant": "ytile_ring", "ty": 8},
                   {"variant": "ytile_ring", "ty": 16})
EDGE_LAUNCHES = (((16, 2, 32), (1, 1, 1)), ((32, 8, 4), (1, 2, 1)),
                 ((64, 4, 4), (1, 1, 2)), ((1024, 1, 1), (1, 1, 1)),
                 ((8, 16, 8), (1, 2, 1)), ((4, 4, 64), (1, 1, 2)))
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {8: 33.5e12, 4: 67e12}
# tolerances: the kernels sum the taps in the plain version's order, but the
# compiler contracts multiply-adds into FMAs, which round once instead of twice
TOL = {8: dict(rtol=1e-12, atol=1e-12), 4: dict(rtol=1e-5, atol=1e-5)}
SOURCE = "src/repro_torch/csrc/stencil3d25.cu"
REPLACES = {
    "replane": "src/repro/kernels/stencil3d25/kernel.py:69",
    "ring": "src/repro/kernels/stencil3d25/kernel.py:102",
    "ytile_ring": "src/repro/kernels/stencil3d25/kernel.py:145",
}


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound(padded, r: int) -> tuple:
    """Least time (ms) the card needs for one stencil on ``padded``: each
    padded input element read once and each output written once at the HBM
    rate, against (6r+1) multiplies + 6r adds per point at the peak rate."""
    eb = padded.element_size()
    pts = 1
    for n in padded.shape:
        pts *= n - 2 * r
    t_bytes = (padded.numel() + pts) * eb / HBM_BYTES_PER_S * 1e3
    t_ops = (12 * r + 1) * pts / PEAK_FLOPS[eb] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(torch, got, want, elem_bytes: int, what: str) -> float:
    """Max abs error of ``got`` against the plain version; raises when the
    shapes differ, a value is not finite, or the tolerance is exceeded."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **TOL[elem_bytes]):
        raise AssertionError(f"{what}: max abs error {err!r} exceeds {TOL[elem_bytes]}")
    return err


def star_conv_weight(torch, weights, r: int):
    """(1, 1, 2r+1, 2r+1, 2r+1) conv3d weight equal to the star's weights on
    its 6r+1 taps and zero elsewhere (conv3d correlates: tap offset s sits at
    index r + s)."""
    k = torch.zeros((2 * r + 1,) * 3, dtype=weights.dtype, device=weights.device)
    k[r, r, r] = weights[0]
    w = 1
    for axis in range(3):
        for o in range(1, r + 1):
            for s in (-o, o):
                idx = [r, r, r]
                idx[axis] += s
                k[tuple(idx)] = weights[w]
                w += 1
    return k.view(1, 1, *k.shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {ROOT / 'src'}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.machines import H100
    from repro_torch.core.selector import ranking_quality
    from repro_torch.kernels import _build
    from repro_torch.kernels.stencil3d25 import kernel as K
    from repro_torch.kernels.stencil3d25.generator import best_config, rank_configs
    from repro_torch.kernels.stencil3d25.ops import star_stencil, zmarch_tile
    from repro_torch.kernels.stencil3d25.ref import pad_input, star_stencil_ref, star_weights

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats(dev)

    # 1. the card
    card = card_line()
    say(f"card: {card}")
    say(f"torch device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build every kernel source, one nvcc each, in parallel
    t0 = time.perf_counter()
    libs = _build.build()
    say(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        log = lib.with_name(lib.name + ".log")
        for line in log.read_text().splitlines() if log.is_file() else ():
            if "registers" in line or "spill" in line:
                say(f"  ptxas[{name}]: {line.strip()}")

    # 3. the ranking: every launch priced on the H100, nothing run
    t0 = time.perf_counter()
    ranked = rank_configs(R, DOMAIN, 8, H100)
    t_rank = time.perf_counter() - t0
    n_pts = DOMAIN[0] * DOMAIN[1] * DOMAIN[2]
    say(f"ranking: {len(ranked)} launches priced on {H100.name} in {t_rank:.2f} s "
        f"(r={R}, domain {DOMAIN}, fp64)")
    if len(ranked) != 168:
        raise AssertionError(f"expected 168 priced launches, got {len(ranked)}")
    for i, rc in enumerate(ranked[:5]):
        say(f"  #{i + 1} block {rc.launch.block} folding {rc.launch.folding}: "
            f"{rc.perf / 1e9:.2f} GLUP/s predicted ({n_pts / rc.perf * 1e3:.3f} ms), "
            f"{rc.estimate.limiter}-limited")
    for s in ranked.skipped:
        say(f"  skipped {s.config}: {s.reason}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    src = torch.randn(DOMAIN, dtype=torch.float64, device=dev, generator=gen)
    w64 = star_weights(R, torch.float64, dev)
    padded = pad_input(src, R)
    kernels = []

    # 4. the main path: star_stencil(config=None) ranks and runs star_pointwise
    best = best_config(R, DOMAIN, 8, H100)
    K.reset_launch_counts()
    out = star_stencil(src, r=R)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    if launches["star_pointwise"] < 1:
        raise AssertionError(f"main path launched no star_pointwise: {launches}")
    ref64 = star_stencil_ref(padded, w64, R)
    err = check(torch, out, ref64, 8, "star_stencil(config=None) fp64")
    say(f"main path: star_stencil(src, r={R}) fp64 at block {best.launch.block} "
        f"folding {best.launch.folding}; launches {launches}; max abs error {err!r} "
        f"(tolerance {TOL[8]}: FMA contraction, same tap order)")
    del out
    kernels.append({"name": "star_pointwise", "config": None,
                    "launches": launches["star_pointwise"], "max_abs_err": err,
                    "replaces": REPLACES["replane"]})

    # 5. folding and edge coverage at pinned launches on a domain that no
    # block extent divides
    src_e = torch.randn(EDGE_DOMAIN, dtype=torch.float64, device=dev, generator=gen)
    ref_e = star_stencil_ref(pad_input(src_e, R), w64, R)
    w32 = star_weights(R, torch.float32, dev)
    src_e32 = src_e.float()
    ref_e32 = star_stencil_ref(pad_input(src_e32, R), w32, R)
    for block, fold in EDGE_LAUNCHES:
        cfg = {"block": block, "folding": fold}
        e64 = check(torch, star_stencil(src_e, r=R, config=cfg), ref_e, 8, f"edge {cfg} fp64")
        e32 = check(torch, star_stencil(src_e32, r=R, config=cfg), ref_e32, 4,
                    f"edge {cfg} fp32")
        say(f"edge {EDGE_DOMAIN} block {block} folding {fold}: max abs error "
            f"fp64 {e64!r}, fp32 {e32!r}")
    for cfg in ZMARCH_VARIANTS[:1]:
        e64 = check(torch, star_stencil(src_e, r=R, config=cfg), ref_e, 8, f"edge {cfg} fp64")
        say(f"edge {EDGE_DOMAIN} {cfg}: max abs error fp64 {e64!r}")

    # 6. the z-march variants, each through the entry point with its own
    # launch count
    for cfg in ZMARCH_VARIANTS:
        K.reset_launch_counts()
        out = star_stencil(src, r=R, config=cfg)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        if launches["star_zmarch"] < 1:
            raise AssertionError(f"{cfg} launched no star_zmarch: {launches}")
        err = check(torch, out, ref64, 8, f"star_stencil({cfg}) fp64")
        tile = zmarch_tile(cfg, R, DOMAIN, 8)
        say(f"z-march {cfg} fp64: tile {tile[0]}x{tile[1]}, "
            f"{K.zmarch_smem_bytes(R, *tile, 8)} B shared memory; launches {launches}; "
            f"max abs error {err!r}")
        del out
        name = ("star_zmarch[ring]" if cfg["variant"] == "ring"
                else f"star_zmarch[ytile_ring,ty={cfg['ty']}]")
        kernels.append({"name": name, "config": cfg,
                        "launches": launches["star_zmarch"], "max_abs_err": err,
                        "replaces": REPLACES[cfg["variant"]]})

    # fp32: the main path and every z-march variant at the paper size
    src32 = src.float()
    padded32 = pad_input(src32, R)
    ref32 = star_stencil_ref(padded32, w32, R)
    best32 = best_config(R, DOMAIN, 4, H100)
    for cfg in (None,) + ZMARCH_VARIANTS:
        err = check(torch, star_stencil(src32, r=R, config=cfg), ref32, 4,
                    f"star_stencil({cfg}) fp32")
        say(f"fp32 star_stencil(config={cfg}): max abs error {err!r} (atol 1e-5)"
            + (f"; launch block {best32.launch.block} folding {best32.launch.folding}"
               if cfg is None else ""))

    del src_e, ref_e, src_e32, ref_e32, ref32, ref64

    # 7. times at the paper size on the pre-padded input
    conv_w = {8: star_conv_weight(torch, w64, R), 4: star_conv_weight(torch, w32, R)}
    inputs = {8: (padded, w64, best), 4: (padded32, w32, best32)}
    lib_ms = {}
    for eb, (pad_x, w, rc) in inputs.items():
        x5 = pad_x.view(1, 1, *pad_x.shape)
        conv = F.conv3d(x5, conv_w[eb])[0, 0]
        conv_err = float((conv - star_stencil_ref(pad_x, w, R)).abs().max())
        del conv
        lib_ms[eb] = cuda_ms(torch, lambda: F.conv3d(x5, conv_w[eb]), warmup=1, reps=5)
        say(f"library F.conv3d ({2 * R + 1}^3 = {(2 * R + 1) ** 3} taps, zero off the star, "
            f"where the stencil does {6 * R + 1}) fp{eb * 8}: {lib_ms[eb]:.4f} ms (median of 5), "
            f"max abs diff to the plain version {conv_err!r} (cudnn.allow_tf32=False)")
    for eb, (pad_x, w, rc) in inputs.items():
        plain = cuda_ms(torch, lambda: star_stencil_ref(pad_x, w, R), warmup=1, reps=5)
        b_ms, b_by = bound(pad_x, R)
        for k in kernels:
            if k["config"] is None:
                launch = rc.launch
                ms = cuda_ms(torch, lambda: K.star_pointwise(pad_x, w, R, launch))
                pred = (f"; predicted {n_pts / rc.perf * 1e3:.4f} ms at block "
                        f"{launch.block} folding {launch.folding}")
            else:
                tile = zmarch_tile(k["config"], R, DOMAIN, eb)
                ms = cuda_ms(torch, lambda: K.star_zmarch(pad_x, w, R, *tile))
                pred = f"; not priced by the GPU model (tile {tile[0]}x{tile[1]})"
            say(f"time {k['name']} fp{eb * 8}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{b_ms / ms * 100:.1f}% of bound; plain {plain:.4f} ms (median of 5); "
                f"library {lib_ms[eb]:.4f} ms{pred}")
            if eb == 8:
                k.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms[eb])
    # the ranking against the card: every priced launch of star_pointwise,
    # fp64, 1 warm-up + median of 5 (the paper's §5.8 criterion)
    measured = []
    for rc in ranked:
        launch = rc.launch
        t_ms = cuda_ms(torch, lambda: K.star_pointwise(padded, w64, R, launch), warmup=1, reps=5)
        measured.append(n_pts / (t_ms * 1e-3))
    quality = ranking_quality([rc.perf for rc in ranked], measured)
    best_i = max(range(len(measured)), key=measured.__getitem__)
    top_place = 1 + sum(m > measured[0] for m in measured)
    say(f"ranking vs card (fp64, {len(ranked)} launches): efficiency "
        f"{quality['efficiency']:.4f}, Spearman {quality['spearman']:.4f}; predicted best "
        f"{ranked[0].launch.block}/{ranked[0].launch.folding} measures "
        f"{n_pts / measured[0] * 1e3:.4f} ms (place {top_place}); measured best "
        f"{ranked[best_i].launch.block}/{ranked[best_i].launch.folding} "
        f"{n_pts / measured[best_i] * 1e3:.4f} ms (predicted place {best_i + 1}, "
        f"{n_pts / ranked[best_i].perf * 1e3:.4f} ms predicted); slowest "
        f"{n_pts / min(measured) * 1e3:.4f} ms")
    call_ms = cuda_ms(torch, lambda: star_stencil(src, r=R))
    say(f"time star_stencil(src, r={R}) fp64 incl. pad: {call_ms:.4f} ms; "
        f"fp32: {cuda_ms(torch, lambda: star_stencil(src32, r=R)):.4f} ms")

    # 8. peak memory
    say(f"peak memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)")

    # 9. the kernels record
    say(f"card: {card}")
    say(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": SOURCE, "replaces": k["replaces"],
         "launches": k["launches"], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"], "pass": True}
        for k in kernels]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
