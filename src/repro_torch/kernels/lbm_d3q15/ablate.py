"""Ablation of ``lbm_ytile``'s design choices on the card.

Builds variants of ``repro_torch/csrc/lbm_d3q15.cu`` that each undo one
piece of the redesign, by a textual edit of the source, and, given
``--base`` (a checkout of the commit before the redesign, e.g. ``git archive
6d08183`` unpacked), the kernel's previous version from that checkout ("old
kernel"), and times them in turns at the paper's size, (256, 256, 256), on
the same pre-padded fields, in fp64 and fp32 at ty 8 and 16 (the tiles
``ytile_tile`` picks, those ``chip_smoke.py`` runs), beside ``lbm_pointwise``
at the ranked launch:

* ``synchronous fill``: no producer warp ring; every thread fills each
  phase plane with plain loads between two CTA barriers, under the ring's
  register split (``kAsyncRing``);
* ``one point a thread``: 15 pulls in flight a thread, not 30 (``kPoints``);
* ``cache hints``: pulls by ``ld.global.nc`` and stores by ``st.global.cs``
  (``kCacheHints``), not plain ones;
* ``64-bit offsets`` (``kNarrowOffsets``);
* ``3 stages``, ``4 stages``, ``6 stages``: ring depths other than the
  default;
* ``slab grid``: the previous kernel's grid, z slabs until there are four
  CTAs an SM, in place of one CTA a resident slot;
* ``every slot``: one CTA a resident slot, not rounded down to a multiple
  of the tiles (so the CTAs' ranges start at scattered z planes);
* ``route cp_async``: fp64's ring filled by element copies into one
  (ty+2) x (tx+2) plane a slot, on named barriers, not by TMA;
* ``old kernel``: the previous ``lbm_ytile`` (three-plane ring filled by
  the CTA between two barriers, one point a thread per iteration);
* ``old lbm_pointwise``: the previous ``lbm_pointwise`` at the ranked
  launch, beside this one (the redesign leaves it as it was; both launched
  through their C launchers, as every variant is).

    python -m repro_torch.kernels.lbm_d3q15.ablate [--base DIR] [--rounds 20] [--seed 0]

Needs a CUDA device and nvcc (exits nonzero without); prints the card's
name and power limit and each variant's median time against the bound.
Every variant is first held to the plain version (fp64 1e-12, fp32 1e-5).
The variants are built under ``repro_torch/.build/ablate``.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

VARIANTS = {
    "synchronous fill": [("constexpr bool kAsyncRing = true;",
                          "constexpr bool kAsyncRing = false;")],
    "one point a thread": [("constexpr int kPoints = sizeof(T) == 8 ? 2 : 4;",
                            "constexpr int kPoints = 1;")],
    "cache hints": [("constexpr bool kCacheHints = false;", "constexpr bool kCacheHints = true;")],
    "64-bit offsets": [("constexpr bool kNarrowOffsets = true;",
                        "constexpr bool kNarrowOffsets = false;")],
}
# runtime pins of the as-built library
PINS = {
    "3 stages": {"stages": 3},
    "4 stages": {"stages": 4},
    "6 stages": {"stages": 6},
    "slab grid": {"grid": "slabs"},
    "every slot": {"grid": "slots"},
    "route cp_async": {"route": "cp_async"},
}
OLD = "old kernel"
POINTWISE = "lbm_pointwise (ranked)"
OLD_POINTWISE = "old lbm_pointwise"
DOMAIN = (256, 256, 256)
HBM_BYTES_PER_S = 3.35e12
TOL = {8: dict(rtol=1e-12, atol=1e-12), 4: dict(rtol=1e-5, atol=1e-5)}
_OLD_CTAS_PER_SM = 4  # the previous kernel's z slabs: at least this many CTAs an SM


def old_source(base: Path) -> Path:
    """The previous ``lbm_d3q15.cu`` in the checkout ``base``;
    FileNotFoundError when it is not a checkout of the repo, ValueError when
    its y-tile kernel is not the previous version."""
    path = Path(base) / "src" / "repro_torch" / "csrc" / "lbm_d3q15.cu"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: --base takes a checkout of the repo")
    if "cp.async / TMA staging and vector loads are later work" not in path.read_text():
        raise ValueError(f"{path} is not the previous lbm_ytile (its synchronous "
                         f"three-plane ring is missing)")
    return path


def build_libs(base: Path | None) -> dict:
    """name -> ctypes library: "as built", each source variant and, with a
    ``base`` checkout, the old kernel (its own C signature)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lbm_d3q15.kernel import _SIGNATURES

    paths = _build.build_variants("lbm_d3q15", {"as built": [], **VARIANTS})
    libs = {}
    for name, so in paths.items():
        lib = ctypes.CDLL(str(so))
        for fn in ("lbm_ytile_launch", "lbm_ytile_blocks_per_sm", "lbm_pointwise_launch"):
            getattr(lib, fn).argtypes = _SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    if base is not None:
        so = _build.build_variants("lbm_d3q15", {OLD: []}, old_source(base))[OLD]
        lib = ctypes.CDLL(str(so))
        lib.lbm_ytile_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 +
                                         [ctypes.c_int] * 6 + [ctypes.c_double] * 2 +
                                         [ctypes.c_void_p])
        lib.lbm_ytile_launch.restype = ctypes.c_int
        lib.lbm_pointwise_launch.argtypes = _SIGNATURES["lbm_pointwise_launch"]
        lib.lbm_pointwise_launch.restype = ctypes.c_int
        libs[OLD] = lib
    return libs


def old_slab(ty: int, tx: int, sms: int) -> int:
    """The previous ``ytile_slab``: the deepest z slab that still gives
    four CTAs an SM."""
    Z, Y, X = DOMAIN
    tiles = -(-Y // ty) * -(-X // tx)
    return max(1, Z // -(-(_OLD_CTAS_PER_SM * sms) // tiles))


def launcher_call(fn, args: tuple):
    """A call of the C launcher ``fn`` with ``args``."""
    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{fn.__name__}: launch failed with CUDA error {rc}")
    return call


def ablate(torch, libs: dict, rounds: int, seed: int) -> None:
    from repro_torch.core.machines import H100
    from repro_torch.kernels.lbm_d3q15 import kernel as K
    from repro_torch.kernels.lbm_d3q15.generator import best_config
    from repro_torch.kernels.lbm_d3q15.ref import lbm_step_ref, pad_inputs
    from repro_torch.kernels.matmul.ablate import in_turns

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(seed)
    Z, Y, X = DOMAIN
    pts = Z * Y * X
    phase64 = torch.sigmoid(torch.randn(DOMAIN, dtype=torch.float64, device=dev, generator=gen))
    pdf64 = torch.rand((15, *DOMAIN), dtype=torch.float64, device=dev, generator=gen)
    for eb, dtype in ((8, torch.float64), (4, torch.float32)):
        pdf_p, phase_p = pad_inputs(pdf64.to(dtype), phase64.to(dtype))
        want = lbm_step_ref(pdf_p, phase_p)[0]
        out = torch.empty_like(want)
        launch = best_config(DOMAIN, eb, H100).launch
        # each PDF pulls one Z x Y x X box, the phase its 7-point footprint, each output once
        bound = (30 * pts + pts + 2 * (Y * X + Z * X + Z * Y)) * eb / HBM_BYTES_PER_S * 1e3
        for ty in (8, 16):
            ty, tx = K.ytile_tile(ty, eb)
            rule = K.ytile_route(ty, tx, X + 2, eb, phase_p.data_ptr())

            def run(lib, name, stages=None, grid=None, route=rule):
                lay = K.ytile_layout(ty, tx, eb, route)
                stages = K.ytile_stages(ty, tx, eb, route) if stages is None else stages
                smem = K.ytile_smem_bytes(ty, tx, eb, stages, route)
                n = lib.lbm_ytile_blocks_per_sm(eb, smem)
                if n < 1:
                    raise RuntimeError(f"{name}: occupancy query returned {n}")
                ctas = K.ytile_ctas(DOMAIN, ty, tx, n * sms)
                if grid == "slabs":
                    ctas = K.ytile_steps(DOMAIN, ty, tx) // old_slab(ty, tx, sms)
                elif grid == "slots":
                    ctas = min(n * sms, K.ytile_steps(DOMAIN, ty, tx))
                args = (eb, pdf_p.data_ptr(), phase_p.data_ptr(), out.data_ptr(), Z, Y, X, ty,
                        tx, lay["nb"], lay["w"], lay["bw"], lay["sub_elems"], stages,
                        K.YTILE_ROUTES.index(route), ctas, 0.8, 0.15, stream)

                def call():
                    rc = lib.lbm_ytile_launch(*args)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
                return call, ctas

            fns, grid = {}, {}
            for name, lib in libs.items():
                if name == OLD:
                    zs = old_slab(ty, tx, sms)
                    fns[name] = launcher_call(lib.lbm_ytile_launch,
                                         (eb, pdf_p.data_ptr(), phase_p.data_ptr(),
                                          out.data_ptr(), Z, Y, X, ty, tx, zs, 0.8, 0.15, stream))
                    grid[name] = f"z slabs of {zs}"
                    fns[OLD_POINTWISE] = launcher_call(
                        lib.lbm_pointwise_launch,
                        (eb, pdf_p.data_ptr(), phase_p.data_ptr(), out.data_ptr(), Z, Y, X,
                         *launch.block, *launch.folding, 0.8, 0.15, stream))
                    grid[OLD_POINTWISE] = f"block {launch.block} folding {launch.folding}"
                    continue
                fns[name], ctas = run(lib, name)
                grid[name] = f"{ctas} CTAs"
            for name, pin in PINS.items():
                if name == "route cp_async" and rule != "tma":
                    continue  # as built already fills by cp.async
                if pin.get("stages") == K.ytile_stages(ty, tx, eb, rule):
                    continue  # as built already has this ring depth
                fns[name], ctas = run(libs["as built"], name, **pin)
                grid[name] = f"{ctas} CTAs"
            for name, fn in fns.items():
                out.fill_(0)
                fn()
                torch.cuda.synchronize()
                if not torch.allclose(out, want, **TOL[eb]):
                    err = float((out - want).abs().max())
                    raise AssertionError(f"variant {name!r} fp{eb * 8} ty={ty}: max abs error "
                                         f"{err!r} exceeds {TOL[eb]}")
            fns[POINTWISE] = launcher_call(
                libs["as built"].lbm_pointwise_launch,
                (eb, pdf_p.data_ptr(), phase_p.data_ptr(), out.data_ptr(), Z, Y, X,
                 *launch.block, *launch.folding, 0.8, 0.15, stream))
            grid[POINTWISE] = f"block {launch.block} folding {launch.folding}"
            times = in_turns(torch, fns, rounds)
            ref = statistics.median(times["as built"])
            print(f"lbm_ytile fp{eb * 8} {DOMAIN} tile {ty}x{tx}, as built route {rule}, "
                  f"{K.ytile_stages(ty, tx, eb, rule)} stages, {K.YTILE_POINTS[eb]} points a "
                  f"thread; in "
                  f"turns ({rounds} rounds, order reversed every other round), byte bound "
                  f"{bound:.4f} ms:", flush=True)
            for name, t in times.items():
                med = statistics.median(t)
                print(f"  {name} ({grid[name]}): median {med:.4f} ms ({(med / ref - 1) * 100:+.1f} "
                      f"% against as built; {bound / med * 100:.1f} % of the bound), quartiles "
                      f"{t[len(t) // 4]:.4f}-{t[3 * len(t) // 4]:.4f} ms", flush=True)
        del pdf_p, phase_p, want, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, default=None,
                    help="a checkout of the commit before the redesign, whose kernel is "
                         "timed as the old kernel (left out without it)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ablate: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = build_libs(args.base)
    if args.base is None:
        print("old kernel: left out (no --base checkout given)")
    ablate(torch, libs, args.rounds, args.seed)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
