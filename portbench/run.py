"""Run one cell of the port's benchmark and print its result line.

    python -m portbench.run --workload star25.ranked --seed 7 --seconds 10 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each compared number beside its limit),
and the compared numbers are the last lines of standard error.  Without
enough CUDA devices, or when the JAX stack or the JAX package was loaded,
it prints no result and exits with another code than 0.  ``--control fp32``
puts the reference, computed in float32, in the program's place: the run
has to come out not correct.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp32",), default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import harness

    harness.cache_bytecode(ROOT)

    try:
        result = harness.run_cell(harness.manifest(ROOT), args.workload, args.seed, args.seconds,
                                  bool(args.trace), control=args.control, t0=T0)
    except harness.Refused as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return exc.code
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded modules of the JAX stack or package: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
