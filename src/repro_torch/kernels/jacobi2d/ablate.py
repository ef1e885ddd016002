"""Ablation of the Jacobi kernels' design choices on the card.

Builds variants of ``repro_torch/csrc/jacobi2d.cu`` that each undo one
piece of the redesign, by a textual edit of the source, and, given
``--base`` (a checkout of the commit before the redesign, e.g. ``git archive
bb7f74b`` unpacked), the kernels' previous versions from that checkout ("old
kernel"), and times them in turns at the paper's size, (4096, 4096), on the
same pre-padded field, in fp64 and fp32: ``jacobi_pointwise`` at the ranked
launch, ``jacobi_ytile`` at ty 8 and 16 (the tiles ``ytile_tile`` picks,
those ``chip_smoke.py`` runs), beside ``F.conv2d`` and a copy of the same
bytes.  Every run is ``--calls`` launches back to back through the C
launchers, so the time is the card's, not the host's.

``jacobi_pointwise``:

* ``runtime folds``: the generic kernel, its fold loops bounded at run
  time, for the priced launches too (``kFoldInstances``);
* ``32-bit offsets``: ``int`` element offsets in place of the 64-bit ones
  (``PointOffset``), right only below 2^31 padded elements;
* ``minimum-blocks bound``: ``__launch_bounds__(1024, 2)``, ptxas held to
  32 registers, in place of no minimum block count;
* ``cache hints on`` (or ``off``): loads by ``ld.global.nc`` and stores by
  ``st.global.cs`` against plain ones, whichever is not as built
  (``kCacheHints``; the stores of ``jacobi_ytile`` too).

``jacobi_ytile``:

* ``synchronous fill``: the producer waits for each slot's copies to land
  and for the consumers to finish the slot before, before the next
  (``kAsyncRing``);
* ``one row a thread``: the up and centre taps read from shared memory for
  every output, not carried in registers down the column
  (``kYTapsInRegisters``);
* ``cache hints``, as above (the stores);
* ``2 stages``, ``3 stages``, ``6 stages``: ring depths other than as built;
* ``route cp_async``: fp64's ring filled by 16-byte ``cp.async`` copies,
  not by the TMA unit's bulk copies;
* ``one column a consumer``: each consumer thread one output column, its
  taps and output single elements, not two columns in pairs;
* ``one CTA an SM``, ``3 CTAs an SM``, ``4 CTAs an SM``: a persistent grid
  of so many CTAs an SM, not two (rounded down to a multiple of the strips,
  as built is);
* ``every slot``: one CTA a resident slot, not rounded down to a multiple
  of the strips (so the strips' CTAs start at scattered rows);
* ``probe: strips of 512 columns``: the kernel marching strips of two tiles,
  its 256 consumers two columns each (where the field takes pairs), so the
  rows it copies and stores are twice as long;
* ``probe: X = 4094 by TMA`` (fp32): the as-built kernel on a (4096, 4094)
  field, whose 16,384-byte padded rows take the TMA route.

With ``--base`` each group also times the old kernel: the per-point kernel
with runtime folds, and the y-tile kernel that stages
one tile a CTA between two barriers.

    python -m repro_torch.kernels.jacobi2d.ablate [--base DIR] [--rounds 20] [--calls 10] [--seed 0]

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

HINTS_OFF = "constexpr bool kCacheHints = false;"
HINTS_ON = "constexpr bool kCacheHints = true;"
# source variant -> (its edits, the kernels it is timed on)
VARIANTS = {
    "runtime folds": ([("constexpr bool kFoldInstances = true;",
                        "constexpr bool kFoldInstances = false;")], ("pointwise",)),
    "32-bit offsets": ([("using PointOffset = int64_t;", "using PointOffset = int;")],
                       ("pointwise",)),
    "minimum-blocks bound": ([("__launch_bounds__(1024)\n", "__launch_bounds__(1024, 2)\n")],
                             ("pointwise",)),
    "synchronous fill": ([("constexpr bool kAsyncRing = true;",
                           "constexpr bool kAsyncRing = false;")], ("ytile",)),
    "one row a thread": ([("constexpr bool kYTapsInRegisters = true;",
                           "constexpr bool kYTapsInRegisters = false;")], ("ytile",)),
}
# runtime pins of the as-built library
PINS = {
    "2 stages": ("ytile", {"stages": 2}),
    "3 stages": ("ytile", {"stages": 3}),
    "6 stages": ("ytile", {"stages": 6}),
    "route cp_async": ("ytile", {"route": "cp_async"}),
    "one column a consumer": ("ytile", {"columns": 1}),
    "one CTA an SM": ("ytile", {"ctas_per_sm": 1}),
    "3 CTAs an SM": ("ytile", {"ctas_per_sm": 3}),
    "4 CTAs an SM": ("ytile", {"ctas_per_sm": 4}),
    "every slot": ("ytile", {"every_slot": True}),
    "probe: strips of 512 columns": ("ytile", {"strip": 512}),
}
# a probe beside the fp32 y-tiles: the same kernel on a (4096, 4094) field,
# whose 16,384-byte padded rows take the TMA route
PROBE_X = 4094
PROBE = "probe: X = 4094 by TMA"
OLD = "old kernel"
CONV = "library F.conv2d"
COPY = "copy of the same bytes"
DOMAIN = (4096, 4096)
WEIGHTS = (0.5, 0.125)
HBM_BYTES_PER_S = 3.35e12
TOL = {8: dict(rtol=1e-12, atol=1e-12), 4: dict(rtol=1e-5, atol=1e-5)}
_OLD_YTILE_THREADS = 256


def old_source(base: Path) -> Path:
    """The previous ``jacobi2d.cu`` in the checkout ``base``;
    FileNotFoundError when it is not a checkout of the repo, ValueError when
    its kernels are not the previous versions."""
    path = Path(base) / "src" / "repro_torch" / "csrc" / "jacobi2d.cu"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: --base takes a checkout of the repo")
    if "tile[i] = (gy < Yp && gx < Xp) ? src[gy * Xp + gx] : T(0);" not in path.read_text():
        raise ValueError(f"{path} is not the previous jacobi2d.cu (its one-tile-a-CTA "
                         f"staging is missing)")
    return path


def source_variants() -> dict:
    """name -> (edits, kernels) of the source variants, the cache-hint one
    named for what it turns on or off against the source as built."""
    from repro_torch.kernels import _build

    text = (_build.CSRC / "jacobi2d.cu").read_text()
    hints = (("cache hints on", [(HINTS_OFF, HINTS_ON)]) if HINTS_OFF in text
             else ("cache hints off", [(HINTS_ON, HINTS_OFF)]))
    return {**VARIANTS, hints[0]: (hints[1], ("pointwise", "ytile"))}


def build_libs(base: Path | None, variants: dict) -> dict:
    """name -> ctypes library: "as built", each source variant and, with a
    ``base`` checkout, the old kernels (their own C signatures)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.jacobi2d.kernel import _SIGNATURES

    paths = _build.build_variants(
        "jacobi2d", {"as built": [], **{n: edits for n, (edits, _) in variants.items()}})
    libs = {}
    for name, so in paths.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    if base is not None:
        so = _build.build_variants("jacobi2d", {OLD: []}, old_source(base))[OLD]
        lib = ctypes.CDLL(str(so))
        head = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_double]
        lib.jacobi_pointwise_launch.argtypes = _SIGNATURES["jacobi_pointwise_launch"]
        lib.jacobi_ytile_launch.argtypes = head + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        for fn in (lib.jacobi_pointwise_launch, lib.jacobi_ytile_launch):
            fn.restype = ctypes.c_int
        libs[OLD] = lib
    return libs


def launcher_call(fn, args: tuple, name: str):
    """A call of the C launcher ``fn`` with ``args``."""
    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
    return call


def report(title: str, times: dict, bound: float) -> None:
    ref = statistics.median(times["as built"])
    print(title, flush=True)
    for name, t in times.items():
        med = statistics.median(t)
        print(f"  {name}: median {med:.4f} ms ({(med / ref - 1) * 100:+.1f} % against as "
              f"built; {bound / med * 100:.1f} % of the bound), quartiles "
              f"{t[len(t) // 4]:.4f}-{t[3 * len(t) // 4]:.4f} ms", flush=True)


def ablate(torch, libs: dict, variants: dict, rounds: int, calls: int, seed: int) -> None:
    import torch.nn.functional as F

    from repro_torch.core.machines import H100
    from repro_torch.kernels.jacobi2d import kernel as K
    from repro_torch.kernels.jacobi2d.generator import best_config
    from repro_torch.kernels.jacobi2d.ref import jacobi_padded_ref, pad_input
    from repro_torch.kernels.matmul.ablate import in_turns

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(seed)
    Y, X = DOMAIN
    src64 = torch.randn(DOMAIN, dtype=torch.float64, device=dev, generator=gen)
    for eb, dtype in ((8, torch.float64), (4, torch.float32)):
        padded = pad_input(src64.to(dtype))
        want = jacobi_padded_ref(padded, WEIGHTS)
        out = torch.empty_like(want)
        bound = (2 * Y * X + 2 * (Y + X)) * eb / HBM_BYTES_PER_S * 1e3
        x4 = padded.view(1, 1, *padded.shape)
        wc, wn = WEIGHTS
        weight = torch.tensor([[0.0, wn, 0.0], [wn, wc, wn], [0.0, wn, 0.0]], dtype=dtype,
                              device=dev).view(1, 1, 3, 3)
        copy_src = torch.empty(DOMAIN, dtype=dtype, device=dev).uniform_()
        copy_dst = torch.empty_like(copy_src)
        common = (eb, padded.data_ptr(), out.data_ptr(), *WEIGHTS, Y, X)
        launch = best_config(DOMAIN, eb, H100).launch
        groups = {"pointwise": None, 8: K.ytile_tile(8, eb)[1], 16: K.ytile_tile(16, eb)[1]}
        for group, tx in groups.items():
            kind = "pointwise" if group == "pointwise" else "ytile"
            fns, what = {}, {}
            if kind == "pointwise":
                for name, lib in libs.items():
                    if name in ("as built", OLD) or kind in variants[name][1]:
                        fns[name] = launcher_call(lib.jacobi_pointwise_launch,
                                                  (*common, *launch.block, *launch.folding,
                                                   stream), name)
                title = (f"jacobi_pointwise fp{eb * 8} {DOMAIN} at block {launch.block} folding "
                         f"{launch.folding}")
            else:
                ty = group
                rule = K.ytile_route(tx, X + 2, eb, padded.data_ptr())
                tile_x = tx

                def ytile(lib, name, stages=None, route=rule, ctas_per_sm=None,
                          every_slot=False, columns=None, args=common, strip=None):
                    tx = strip or tile_x
                    xp = args[6] + 2
                    rows, fit = K.ytile_plan(ty, tx, eb, xp)
                    stages = stages or fit
                    columns = columns or K.ytile_columns(tx, args[6], eb, args[1])
                    threads = K.ytile_threads(tx, columns)
                    ring = K.ytile_ring_bytes(rows, tx, eb, stages, xp)
                    n = lib.jacobi_ytile_blocks_per_sm(eb, columns, threads, ring)
                    if n < 1:
                        raise RuntimeError(f"{name}: occupancy query returned {n}")
                    per_sm = min(n, ctas_per_sm or K.YTILE_CTAS_PER_SM)
                    steps = K.ytile_steps(tuple(args[5:7]), ty, tx)
                    ctas = K.ytile_ctas(steps, per_sm * sms, 1 if every_slot else -(-args[6] // tx))
                    what[name] = (f"{route}, {stages} x {rows} rows, {columns} column(s) a "
                                  f"consumer, {ctas} CTAs")
                    return launcher_call(
                        lib.jacobi_ytile_launch,
                        (*args, ty, tx, rows, K.ytile_row_bytes(tx, eb, xp), stages,
                         K.YTILE_ROUTES.index(route), columns, ctas, stream), name)
                for name, lib in libs.items():
                    if name == OLD:
                        fns[name] = launcher_call(lib.jacobi_ytile_launch,
                                                  (*common, ty, tx, _OLD_YTILE_THREADS, stream),
                                                  name)
                        what[name] = "one CTA a tile"
                    elif name == "as built" or kind in variants[name][1]:
                        fns[name] = ytile(lib, name)
                rows, fit = K.ytile_plan(ty, tx, eb, X + 2)
                for name, (applies, pin) in PINS.items():
                    if applies != "ytile" or pin.get("stages") == fit or (
                            pin.get("route") == "cp_async" and rule != "tma") or (
                            pin.get("columns") == K.ytile_columns(tx, X, eb, padded.data_ptr())):
                        continue  # not a y-tile pin, or as built already
                    fns[name] = ytile(libs["as built"], name, **pin)
                title = (f"jacobi_ytile fp{eb * 8} {DOMAIN} tile {ty}x{tx}, as built {rule}, "
                         f"{fit} slots of {rows} rows")
            checks = {name: (out, want) for name in fns}
            if kind == "ytile" and rule != "tma":
                probe = pad_input(src64[:, :PROBE_X].to(dtype))
                probe_out = torch.empty((Y, PROBE_X), dtype=dtype, device=dev)
                fns[PROBE] = ytile(libs["as built"], PROBE, route="tma",
                                   args=(eb, probe.data_ptr(), probe_out.data_ptr(), *WEIGHTS, Y,
                                         PROBE_X))
                checks[PROBE] = (probe_out, jacobi_padded_ref(probe, WEIGHTS))
            for name, fn in fns.items():
                got, exp = checks[name]
                got.fill_(0)
                fn()
                torch.cuda.synchronize()
                if not torch.allclose(got, exp, **TOL[eb]):
                    err = float((got - exp).abs().max())
                    raise AssertionError(f"{title}: variant {name!r} max abs error {err!r} "
                                         f"exceeds {TOL[eb]}")
            fns[CONV] = lambda: F.conv2d(x4, weight)
            fns[COPY] = lambda: copy_dst.copy_(copy_src)
            queued = {name: (lambda fn=fn: [fn() for _ in range(calls)])
                      for name, fn in fns.items()}
            times = {name: [t / calls for t in ts]
                     for name, ts in in_turns(torch, queued, rounds).items()}
            report(f"{title}; {calls} calls back to back a run, in turns ({rounds} rounds, order "
                   f"reversed every other round), byte bound {bound:.4f} ms:"
                   + "".join(f"\n    {n}: {w}" for n, w in what.items()), times, bound)
        del padded, want, out, copy_src, copy_dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, default=None,
                    help="a checkout of the commit before the redesign, whose kernels are "
                         "timed as the old kernel (left out without it)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--calls", type=int, default=10)
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
    variants = source_variants()
    libs = build_libs(args.base, variants)
    if args.base is None:
        print("old kernel: left out (no --base checkout given)")
    ablate(torch, libs, variants, args.rounds, args.calls, args.seed)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
