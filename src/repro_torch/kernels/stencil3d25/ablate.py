"""Ablation of the star-stencil kernels' design choices on the card.

Builds variants of ``repro_torch/csrc/stencil3d25.cu`` that each undo one
choice, by a textual edit of the source, and, given ``--base`` (a checkout
of the commit before the redesign, e.g. ``git archive aba071b`` unpacked),
the kernels' first version from that checkout ("old kernel"), and times
them in turns at the paper's size, (512, 512, 640) and r = 4, on the same
pre-padded field, in fp64 and fp32.

``--part pointwise``: ``star_pointwise`` at the ranked launch (the main
path of ``chip_smoke.py``'s ``run_stencil``):

* ``weights in shared memory``: the weights staged per block in shared
  memory, one shared load beside each global one, instead of the
  constant bank;
* ``weights by ldg``: the weights read from the weights tensor through
  ``ld.global.nc``, as the generic (any r) kernels read them, instead of
  the constant bank (no bank, so no guard);
* ``64-bit offsets``: the build as it is, with the launcher's 64-bit
  path forced, instead of 32-bit offsets below 2^31 elements;
* ``old kernel``: both, the loads interleaved with the sums and one
  instantiation for every r.

``--part zmarch``: ``star_zmarch`` on the ring tile 16x32 (as built: TMA,
4 stages, z segments by ``kernel.zmarch_segments``) against

* ``2 stages`` and ``3 stages``;
* ``cp.async``: the producer's element copies on these 16-byte rows too;
* ``1 segment``: Z not split;
* ``weights by ldg``: as for ``star_pointwise``;
* ``all taps from shared memory``: the ring holds an output's 2r+1 planes
  (2r+3 stages) and the z taps come from it, in tap order;
* ``old kernel``: the first version's synchronous (2r+1)-plane ring;

then each y-tile as built (against its old kernel, with ``--base``), and the 16x128 fp64
tile that the smaller ring allows (the tile rule keeps 16x64).

    python -m repro_torch.kernels.stencil3d25.ablate [--part pointwise|zmarch|all] [--base DIR] [--rounds 30] [--seed 0]

Needs a CUDA device and nvcc (exits nonzero without); prints the card's
name and power limit and each variant's median time against the bound.
Every variant is first held to the smoke's tolerance against the plain
version.  The variants are built under ``repro_torch/.build/ablate``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

VARIANTS = {
    "weights in shared memory": [("constexpr bool kConstWeights = true;",
                                  "constexpr bool kConstWeights = false;")],
    "weights by ldg": [("constexpr bool kBankWeights = true;",
                        "constexpr bool kBankWeights = false;")],
    "all taps from shared memory": [("constexpr bool kZInRegisters = true;",
                                     "constexpr bool kZInRegisters = false;")],
}
OLD = "old kernel"
R = 4
DOMAIN = (512, 512, 640)
TOL = {8: dict(rtol=1e-12, atol=1e-12), 4: dict(rtol=1e-5, atol=1e-5)}

_P = ctypes.c_void_p
_I = ctypes.c_int
OLD_SIGNATURES = {  # the first version's C launchers
    "star_pointwise_launch": [_I, _P, _P, _P] + [_I] * 10 + [_P],
    "star_zmarch_launch": [_I, _P, _P, _P] + [_I] * 7 + [_P],
}


def old_source(base: Path) -> Path:
    """The first version's ``stencil3d25.cu`` in the checkout ``base``;
    FileNotFoundError when it is not a checkout of the repo."""
    path = Path(base) / "src" / "repro_torch" / "csrc" / "stencil3d25.cu"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: --base takes a checkout of the repo")
    if "constexpr int kPrefetch = 8;" not in path.read_text():
        raise ValueError(f"{path} is not the first version of the stencil kernels "
                         f"(its register prefetch kPrefetch is missing)")
    return path


def build_libs(base: Path | None) -> dict:
    """name -> ctypes library of each variant, "as built" and, with a
    ``base`` checkout, the old kernel."""
    from repro_torch.kernels import _build

    paths = _build.build_variants("stencil3d25", {"as built": [], **VARIANTS})
    if base is not None:
        paths[OLD] = _build.build_variants("stencil3d25", {OLD: []}, old_source(base))[OLD]
    from repro_torch.kernels.stencil3d25.kernel import _SIGNATURES

    libs = {}
    for name, so in paths.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in (OLD_SIGNATURES if name == OLD else _SIGNATURES).items():
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def old_zmarch_threads(r: int, ty: int, tx: int) -> int:
    """Threads of the old z-march block: one for every two outputs, more
    when its register prefetch (8 elements a thread) needs them."""
    want = max(-(-ty * tx // 2), -(-(ty + 2 * r) * (tx + 2 * r) // 8))
    return -(-want // 32) * 32


def old_ytile_tx(r: int, ty: int, elem_bytes: int) -> int:
    """The old kernel's y-tile width: the widest whose (2r+1)-plane ring,
    weights and threads fit."""
    from repro_torch.kernels import SMEM_PER_BLOCK
    from repro_torch.kernels.stencil3d25.kernel import YTILE_TX

    for tx in YTILE_TX:
        smem = ((2 * r + 1) * (ty + 2 * r) * (tx + 2 * r) + 6 * r + 1) * elem_bytes
        if smem <= SMEM_PER_BLOCK and old_zmarch_threads(r, ty, tx) <= 1024:
            return tx
    raise ValueError(f"no old y-tile of {ty} rows at r={r}")


def checked(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: launch failed with CUDA error {rc}")


def timed(torch, fns: dict, rounds: int, bound_ms: float, base: str) -> None:
    """Time ``fns`` in turns and print each median against ``base`` and
    the bound."""
    import statistics

    from repro_torch.kernels.matmul.ablate import in_turns

    times = in_turns(torch, fns, rounds)
    ref = statistics.median(times[base])
    for name, t in times.items():
        med = statistics.median(t)
        print(f"  {name}: median {med:.4f} ms ({(med / ref - 1) * 100:+.1f} % against {base}; "
              f"{bound_ms / med * 100:.1f} % of the {bound_ms:.4f} ms bound), "
              f"quartiles {t[len(t) // 4]:.4f}-{t[3 * len(t) // 4]:.4f} ms")


def field(torch, eb: int, seed: int):
    """The padded field, weights, output and plain result at the paper size."""
    from repro_torch.kernels.stencil3d25.ref import pad_input, star_stencil_ref

    dtype = torch.float64 if eb == 8 else torch.float32
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randn(DOMAIN, dtype=torch.float64, device=dev, generator=gen).to(dtype)
    padded = pad_input(src, R)
    w = torch.randn(6 * R + 1, dtype=torch.float64, device=dev, generator=gen).to(dtype)
    return padded, w, torch.empty(DOMAIN, dtype=dtype, device=dev), star_stencil_ref(padded, w, R)


def ablate_pointwise(torch, libs: dict, rounds: int, seed: int) -> None:
    from repro_torch.core.machines import H100
    from repro_torch.kernels.stencil3d25.generator import rank_configs

    stream = torch.cuda.current_stream().cuda_stream
    for eb in (8, 4):
        padded, w, out, want = field(torch, eb, seed)
        launch = rank_configs(R, DOMAIN, eb, H100)[0].launch
        args = (eb, padded.data_ptr(), out.data_ptr(), w.data_ptr(), R, *DOMAIN,
                *launch.block, *launch.folding)

        def run(lib, name, wide=0):
            if name == OLD:
                return lambda: checked(lib.star_pointwise_launch(*args, stream), name)
            return lambda: checked(lib.star_pointwise_launch(*args, wide, stream), name)

        fns = {name: run(lib, name) for name, lib in libs.items()
               if name != "all taps from shared memory"}
        fns["64-bit offsets"] = run(libs["as built"], "64-bit offsets", wide=1)
        for name, fn in fns.items():
            out.fill_(float("nan"))
            fn()
            if not torch.allclose(out, want, **TOL[eb]):
                raise AssertionError(f"pointwise variant {name!r} disagrees with the plain "
                                     f"version at {launch}")
        print(f"star_pointwise fp{eb * 8} at block {launch.block} folding {launch.folding} "
              f"({launch.threads} threads), in turns ({rounds} rounds):")
        timed(torch, fns, rounds, bound_ms(padded), "as built")
        del padded, out, want


def bound_ms(padded) -> float:
    """The smoke's byte bound (``chip_smoke.bound``): the star's footprint
    read once and the output written once at 3.35 TB/s."""
    Z, Y, X = DOMAIN
    pts = Z * Y * X
    foot = pts + 2 * R * (Y * X + Z * X + Z * Y)
    return (foot + pts) * padded.element_size() / 3.35e12 * 1e3


def ablate_zmarch(torch, libs: dict, rounds: int, seed: int) -> None:
    from repro_torch.kernels.stencil3d25 import kernel as K

    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    Z, Y, X = DOMAIN
    for eb in (8, 4):
        padded, w, out, want = field(torch, eb, seed)
        b_ms = bound_ms(padded)

        def new(lib, ty, tx, route="tma", stages=K.ZMARCH_STAGES, segments=None):
            lay = K.zmarch_layout(R, ty, tx, eb)
            if segments is None:
                smem = K.zmarch_smem_bytes(R, ty, tx, eb, stages)
                per_sm = lib.star_zmarch_blocks_per_sm(eb, R, lay["cy"], lay["threads"], smem)
                segments = K.zmarch_segments(-(-X // tx) * -(-Y // ty), Z, R, per_sm * sms)
                print(f"    {ty}x{tx}, {stages} stages: {lay['threads']} threads, {smem} B, "
                      f"{per_sm} CTAs a SM, {segments} z segments, "
                      f"{-(-X // tx) * -(-Y // ty) * segments / (per_sm * sms):.2f} waves")
            segments = -(-Z // -(-Z // segments))
            args = (eb, padded.data_ptr(), out.data_ptr(), w.data_ptr(), R, Z, Y, X, ty, tx,
                    lay["cy"], lay["rows"], lay["bw"], lay["slot_elems"], stages, segments,
                    K.ZMARCH_ROUTES.index(route), lay["threads"], stream)
            return lambda: checked(lib.star_zmarch_launch(*args), f"star_zmarch {ty}x{tx}")

        def old(ty, tx):
            args = (eb, padded.data_ptr(), out.data_ptr(), w.data_ptr(), R, Z, Y, X, ty, tx,
                    old_zmarch_threads(R, ty, tx), stream)
            return lambda: checked(libs[OLD].star_zmarch_launch(*args), f"old {ty}x{tx}")

        built = libs["as built"]
        ring = K.ring_tile(R, eb)
        print(f"star_zmarch fp{eb * 8}, the ring tile {ring[0]}x{ring[1]}:")
        fns = {"as built": new(built, *ring),
               "2 stages": new(built, *ring, stages=2),
               "3 stages": new(built, *ring, stages=3),
               "cp.async": new(built, *ring, route="cp_async"),
               "1 segment": new(built, *ring, segments=1),
               "weights by ldg": new(libs["weights by ldg"], *ring),
               "all taps from shared memory": new(libs["all taps from shared memory"], *ring,
                                                  stages=2 * R + 3)}
        if OLD in libs:
            fns[OLD] = old(*ring)
        for ty in (8, 16):
            tile = K.ytile_tile(R, ty, eb)
            fns[f"ytile {tile[0]}x{tile[1]}"] = new(built, *tile)
            fns[f"ytile {tile[0]}x{tile[1]} weights by ldg"] = new(libs["weights by ldg"], *tile)
            if OLD in libs:
                otx = old_ytile_tx(R, ty, eb)
                fns[f"ytile {ty}x{otx} old kernel"] = old(ty, otx)
        if eb == 8:
            fns["ytile 16x128 (wider than the tile rule)"] = new(built, 16, 128)
        for name, fn in fns.items():
            out.fill_(float("nan"))
            fn()
            if not torch.allclose(out, want, **TOL[eb]):
                raise AssertionError(f"z-march variant {name!r} fp{eb * 8} disagrees with the "
                                     f"plain version")
        print(f"  in turns ({rounds} rounds):")
        timed(torch, fns, rounds, b_ms, "as built")
        del padded, out, want


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("pointwise", "zmarch", "all"), default="all")
    ap.add_argument("--base", type=Path, default=None,
                    help="a checkout of the commit before the redesign, whose kernels are "
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
    print(f"card: {card}")
    libs = build_libs(args.base)
    if args.base is None:
        print("old kernel: left out (no --base checkout given)")
    if args.part in ("pointwise", "all"):
        ablate_pointwise(torch, libs, args.rounds, args.seed)
    if args.part in ("zmarch", "all"):
        ablate_zmarch(torch, libs, args.rounds, args.seed)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
