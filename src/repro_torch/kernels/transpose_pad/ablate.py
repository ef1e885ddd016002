"""Ablation of ``transpose_pointwise``'s design choices on the card.

Builds a variant of ``repro_torch/csrc/transpose_pad.cu`` that undoes the
redesign's one switch, by a textual edit of the source, and, given ``--base`` (a checkout
of the commit before the redesign, e.g. ``git archive 8a5a615`` unpacked),
the kernel's previous version from that checkout ("old kernel"), and times
them in turns at the paper's size, (8192, 8192), on the same operand, at
the kept top launch of each dtype (fp64 and fp32, the launches
``chip_smoke.py``'s ``run_transpose`` runs), beside
``x.mT.contiguous()``:

* ``runtime folds``: the generic kernel, its fold loops bounded at run
  time, instead of the compile-time folds of the priced launches;
* ``old kernel``: the same, with plain loads and stores, its loads and
  stores interleaved.

    python -m repro_torch.kernels.transpose_pad.ablate [--base DIR] [--rounds 30] [--seed 0]

Needs a CUDA device and nvcc (exits nonzero without); prints the card's
name and power limit and each variant's median time against the bound
and the library call.  Every variant is first held bit for bit to the
plain version.  The variants are built under ``repro_torch/.build/ablate``.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

VARIANTS = {
    "runtime folds": [("constexpr bool kFoldInstances = true;",
                       "constexpr bool kFoldInstances = false;")],
}
OLD = "old kernel"
LIBRARY = "library x.mT.contiguous()"
SHAPE = (8192, 8192)
HBM_BYTES_PER_S = 3.35e12


def old_source(base: Path) -> Path:
    """The previous ``transpose_pad.cu`` in the checkout ``base``;
    FileNotFoundError when it is not a checkout of the repo, ValueError
    when its kernel is not the previous version."""
    path = Path(base) / "src" / "repro_torch" / "csrc" / "transpose_pad.cu"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: --base takes a checkout of the repo")
    if "xt[(int64_t)y * M + m] = x[(int64_t)m * N + y];" not in path.read_text():
        raise ValueError(f"{path} is not the previous transpose_pointwise (its 64-bit "
                         f"interleaved load and store are missing)")
    return path


def build_libs(base: Path | None) -> dict:
    """name -> ctypes library of each variant, "as built" and, with a
    ``base`` checkout, the old kernel (its launcher has the same C
    signature)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.transpose_pad.kernel import _SIGNATURES

    paths = _build.build_variants("transpose_pad", {"as built": [], **VARIANTS})
    if base is not None:
        paths[OLD] = _build.build_variants("transpose_pad", {OLD: []}, old_source(base))[OLD]
    libs = {}
    for name, so in paths.items():
        lib = ctypes.CDLL(str(so))
        fn = lib.transpose_pointwise_launch
        fn.argtypes = _SIGNATURES["transpose_pointwise_launch"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def ablate(torch, libs: dict, rounds: int, seed: int) -> None:
    from repro_torch.core.machines import H100
    from repro_torch.kernels.matmul.ablate import in_turns
    from repro_torch.kernels.transpose_pad.generator import best_config
    from repro_torch.kernels.transpose_pad.ref import transpose_ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stream = torch.cuda.current_stream().cuda_stream
    x32 = torch.randn(SHAPE, dtype=torch.float32, device=dev, generator=gen)
    for eb, dtype in ((8, torch.float64), (4, torch.float32)):
        x = x32.to(dtype)
        want = transpose_ref(x)
        out = torch.empty_like(want)
        launch = best_config(SHAPE, eb, H100).launch
        args = (eb, x.data_ptr(), out.data_ptr(), *SHAPE, *launch.block, *launch.folding)

        def run(lib, name):
            def call():
                rc = lib.transpose_pointwise_launch(*args, stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
            return call

        fns = {name: run(lib, name) for name, lib in libs.items()}
        for name, fn in fns.items():
            out.fill_(0)
            fn()
            if not torch.equal(out, want):
                raise AssertionError(f"variant {name!r} fp{eb * 8} is not the plain version "
                                     f"bit for bit at {launch}")
        fns[LIBRARY] = lambda: transpose_ref(x)
        bound = 2 * x.numel() * eb / HBM_BYTES_PER_S * 1e3
        times = in_turns(torch, fns, rounds)
        ref = statistics.median(times["as built"])
        lib_ms = statistics.median(times[LIBRARY])
        print(f"transpose_pointwise fp{eb * 8} {SHAPE} at block {launch.block} folding "
              f"{launch.folding}, in turns ({rounds} rounds, order reversed every other "
              f"round), byte bound {bound:.4f} ms:", flush=True)
        for name, t in times.items():
            med = statistics.median(t)
            print(f"  {name}: median {med:.4f} ms ({(med / ref - 1) * 100:+.1f} % against as "
                  f"built; {med / lib_ms:.4f}x the library; {bound / med * 100:.1f} % of the "
                  f"bound), quartiles {t[len(t) // 4]:.4f}-{t[3 * len(t) // 4]:.4f} ms",
                  flush=True)
        del x, want, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, default=None,
                    help="a checkout of the commit before the redesign, whose kernel is "
                         "timed as the old kernel (left out without it)")
    ap.add_argument("--rounds", type=int, default=30)
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
