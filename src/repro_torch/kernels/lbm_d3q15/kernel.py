"""Wrappers of the hand-written CUDA D3Q15 LBM kernels
(``repro_torch/csrc/lbm_d3q15.cu``).

* ``lbm_pointwise`` — the per-point kernel the GPU estimator prices, at a
  ``LaunchConfig`` (thread block x thread folding).  Replaces the TPU's
  ``make_replane``.
* ``lbm_ytile`` — z-marching kernel over ty x tx output tiles: a producer
  warp keeps an S-stage shared-memory ring of the phase field's planes in
  flight (``ytile_route``: TMA, or ``cp.async`` for rows that are not
  16-byte multiples and for tiles whose TMA ring does not fit), and the
  consumer threads pull ``YTILE_POINTS`` points' PDFs at a time; the grid
  is persistent, one CTA an SM and the CTAs in step (``ytile_ctas``).
  Replaces ``make_ytile(ty)`` (``ytile_tile`` picks tx).  ``LAST_YTILE``
  records the route, tile, stages, points a thread and CTAs of the last
  launch.

Both take the halo-1 padded PDFs (15, Z+2, Y+2, X+2) and phase field
(Z+2, Y+2, X+2) and return the new PDFs (15, Z, Y, X).  On a CPU tensor they
compute the plain version (``ref.lbm_step_ref``); on a CUDA tensor they
launch the kernel on the current stream or raise.  ``LAUNCHES`` counts
kernel launches on the card per wrapper, as the ``obs`` counter group
``kernels.lbm_d3q15.launches``, and ``LAST_LAUNCH`` holds the launch
(``LaunchConfig``, or the (ty, tx) tile) each wrapper last ran on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.access import LaunchConfig
from repro_torch.kernels import SMEM_PER_BLOCK, _build, raw_stream
from repro_torch.kernels.lbm_d3q15.ref import lbm_step_ref
from repro_torch.obs import metrics

LAUNCHES = metrics.CounterGroup("kernels.lbm_d3q15.launches", {
    "lbm_pointwise": "lbm_pointwise kernels launched on the card",
    "lbm_ytile": "lbm_ytile kernels launched on the card",
})
LAST_LAUNCH = {"lbm_pointwise": None, "lbm_ytile": None}
# {"route", "tile", "stages", "points", "ctas"} of the last lbm_ytile launch
LAST_YTILE: dict = {}

YTILE_TX = (256, 128, 64, 32, 16, 8, 4, 2, 1)  # tx choices of lbm_ytile, widest first
YTILE_ROUTES = ("tma", "cp_async")
# ring slots of lbm_ytile where they fit, by element size: on an H100 at
# (256, 256, 256), fp64's 3 measured 2.2-3.4 % faster than 4 at ty 8 and 16,
# fp32's 4 6.8-13.6 % faster than 3
YTILE_STAGES = {4: 4, 8: 3}
YTILE_MIN_STAGES = 3       # the three planes one output reads
YTILE_MAX_STAGES = 7       # route "cp_async" names two barriers a slot, of 15 (kMaxStages)
# points a consumer thread pulls at once, by element size (kPoints): 60 values
YTILE_POINTS = {4: 4, 8: 2}
YTILE_THREADS = 128 + 16 * 32  # a producer warpgroup and 16 consumer warps (kYtileThreads)
_TMA_BOX_MAX = 256         # elements on each side of a TMA box
_GRID_YZ_MAX = 65_535

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "lbm_pointwise_launch": [_I, _P, _P, _P] + [_I] * 9 + [_D, _D, _P],
    "lbm_ytile_launch": [_I, _P, _P, _P] + [_I] * 12 + [_D, _D, _P],
    "lbm_ytile_blocks_per_sm": [_I, _I],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAST_LAUNCH[k] = None
    LAST_YTILE.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    lib = _build.load("lbm_d3q15")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.lbm_error_string.argtypes = [ctypes.c_int]
    lib.lbm_error_string.restype = ctypes.c_char_p
    return lib


def _check(pdf_p: torch.Tensor, phase_p: torch.Tensor) -> tuple:
    """Validate the operands; return the output domain (Z, Y, X)."""
    if not isinstance(pdf_p, torch.Tensor) or not isinstance(phase_p, torch.Tensor):
        raise TypeError("pdf_p and phase_p must be torch tensors")
    if pdf_p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pdf_p.device}")
    if pdf_p.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {pdf_p.dtype}")
    if phase_p.dtype != pdf_p.dtype or phase_p.device != pdf_p.device:
        raise ValueError("phase_p must have the dtype and device of pdf_p")
    if pdf_p.dim() != 4 or pdf_p.shape[0] != 15 or tuple(pdf_p.shape[1:]) != tuple(phase_p.shape):
        raise ValueError(
            f"expected PDFs (15, Z+2, Y+2, X+2) and a phase field (Z+2, Y+2, X+2), "
            f"got {tuple(pdf_p.shape)} and {tuple(phase_p.shape)}")
    if not (pdf_p.is_contiguous() and phase_p.is_contiguous()):
        raise ValueError("pdf_p and phase_p must be contiguous")
    domain = tuple(n - 2 for n in phase_p.shape)
    if min(domain) < 1:
        raise ValueError(f"padded shape {tuple(phase_p.shape)} is smaller than its halo of 1")
    if pdf_p.numel() >= 2**31:
        raise ValueError("fields of 2**31 elements or more are not supported")
    return domain


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().lbm_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def lbm_pointwise(pdf_p: torch.Tensor, phase_p: torch.Tensor, launch: LaunchConfig,
                  tau: float = 0.8, kappa: float = 0.15) -> torch.Tensor:
    """One LBM step, one thread per (point x fold iteration) at ``launch``
    (the mapping of ``core.gridwalk.block_points``)."""
    Z, Y, X = _check(pdf_p, phase_p)
    (bx, by, bz), (fx, fy, fz) = launch.block, launch.folding
    if min(bx, by, bz, fx, fy, fz) < 1 or launch.threads > 1024 or bz > 64:
        raise ValueError(f"launch {launch} is not a valid CUDA block")
    gx, gy, gz = launch.grid_for((Z, Y, X))
    if gy > _GRID_YZ_MAX or gz > _GRID_YZ_MAX:
        raise ValueError(f"grid {(gx, gy, gz)} exceeds CUDA's y/z grid limit")
    if pdf_p.device.type == "cpu":
        return lbm_step_ref(pdf_p, phase_p, tau, kappa)[0]
    out = torch.empty((15, Z, Y, X), dtype=pdf_p.dtype, device=pdf_p.device)
    with torch.cuda.device(pdf_p.device):
        rc = _lib().lbm_pointwise_launch(
            pdf_p.element_size(), pdf_p.data_ptr(), phase_p.data_ptr(), out.data_ptr(),
            Z, Y, X, bx, by, bz, fx, fy, fz, tau, kappa,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "lbm_pointwise")
    LAUNCHES["lbm_pointwise"] += 1
    LAST_LAUNCH["lbm_pointwise"] = launch
    return out


def ytile_layout(ty: int, tx: int, elem_bytes: int, route: str) -> dict:
    """A ring slot of ``lbm_ytile`` for a ty x tx tile on ``route``: ``nb``
    sub-tiles of ``w`` output columns each, each ``rows`` = ty + 2 rows of
    ``bw`` elements, ``sub_elems`` from one sub-tile to the next,
    ``slot_elems`` a slot.  Route ``"cp_async"``: one (ty + 2) x (tx + 2)
    plane.  Route ``"tma"``: a TMA box is at most 256 elements wide and a
    tile needs its w + 2 halo columns, so sub-tiles of at most 254 output
    columns, bw rounded up to 16 bytes and sub_elems to 128 bytes, where a
    box may land."""
    rows = ty + 2
    if route == "cp_async":
        return {"nb": 1, "w": tx, "bw": tx + 2, "rows": rows, "sub_elems": rows * (tx + 2),
                "slot_elems": rows * (tx + 2)}
    per16 = 16 // elem_bytes
    nb = -(-tx // (_TMA_BOX_MAX - 2))
    w = -(-tx // nb)
    bw = -(-(w + 2) // per16) * per16
    per128 = 128 // elem_bytes
    sub = -(-rows * bw // per128) * per128
    return {"nb": nb, "w": w, "bw": bw, "rows": rows, "sub_elems": sub,
            "slot_elems": nb * sub}


def ytile_smem_bytes(ty: int, tx: int, elem_bytes: int, stages: int = YTILE_MIN_STAGES,
                     route: str = "cp_async") -> int:
    """Shared memory of ``lbm_ytile``: ``stages`` ring slots
    (``ytile_layout``), and on route ``"tma"`` a full and an empty mbarrier
    (8 bytes each) per slot and 128 bytes of room to align the ring as TMA
    needs.  By default the three (ty+2) x (tx+2) planes of the least ring."""
    slot = ytile_layout(ty, tx, elem_bytes, route)["slot_elems"] * elem_bytes
    return stages * slot if route == "cp_async" else stages * (slot + 16) + 128


def ytile_stages(ty: int, tx: int, elem_bytes: int, route: str) -> int:
    """Ring slots of ``lbm_ytile`` for a ty x tx tile on ``route``:
    YTILE_STAGES, or as many as fit one block's shared memory, at least the
    three planes an output reads; ValueError when three do not fit."""
    for stages in range(YTILE_STAGES[elem_bytes], YTILE_MIN_STAGES - 1, -1):
        if ytile_smem_bytes(ty, tx, elem_bytes, stages, route) <= SMEM_PER_BLOCK:
            return stages
    raise ValueError(
        f"tile {ty}x{tx} needs "
        f"{ytile_smem_bytes(ty, tx, elem_bytes, YTILE_MIN_STAGES, route)} B of shared memory "
        f"for {YTILE_MIN_STAGES} ring slots, more than the {SMEM_PER_BLOCK} B a block can use")


def ytile_tile(ty: int, elem_bytes: int) -> tuple:
    """(TY, TX) of ``lbm_ytile(ty)``: the widest TX whose three phase planes
    fit in one block's shared memory (capacity takes the place of the TPU's
    VMEM layer condition); ValueError when none does."""
    for tx in YTILE_TX:
        if ytile_smem_bytes(ty, tx, elem_bytes) <= SMEM_PER_BLOCK:
            return ty, tx
    raise ValueError(
        f"no y-tile of {ty} rows fits a {YTILE_MIN_STAGES}-plane phase ring in "
        f"{SMEM_PER_BLOCK} B of shared memory")


def ytile_route(ty: int, tx: int, xp: int, elem_bytes: int, data_ptr: int = 0) -> str:
    """How ``lbm_ytile``'s producer fills its ring for a ty x tx tile of a
    padded phase field with rows of ``xp`` elements at address ``data_ptr``:
    ``"tma"`` (one 3D box load a sub-tile) where TMA takes the field and the
    boxes, i.e. the rows (xp · elem_bytes), the address and every box's first
    column (tiles tx and sub-tiles ``ytile_layout``'s w apart) are 16-byte
    multiples and a box's ty + 2 rows are at most 256, and where three slots
    of its layout fit; ``"cp_async"`` (element copies by the producer warp,
    any row stride) everywhere else."""
    w = ytile_layout(ty, tx, elem_bytes, "tma")["w"]
    if ((xp * elem_bytes) % 16 == 0 and data_ptr % 16 == 0 and (tx * elem_bytes) % 16 == 0
            and (w * elem_bytes) % 16 == 0 and ty + 2 <= _TMA_BOX_MAX
            and ytile_smem_bytes(ty, tx, elem_bytes, YTILE_MIN_STAGES, "tma") <= SMEM_PER_BLOCK):
        return "tma"
    return "cp_async"


@functools.cache
def _ytile_plan(ty: int, tx: int, elem_bytes: int, route: str) -> tuple:
    """(``ytile_layout``, ``ytile_stages``) of a tile on a route, once per
    tile: the wrapper's host time before a launch is time an idle card
    waits."""
    return ytile_layout(ty, tx, elem_bytes, route), ytile_stages(ty, tx, elem_bytes, route)


def ytile_steps(domain: tuple, ty: int, tx: int) -> int:
    """(tile, output plane) steps of ``lbm_ytile`` on ``domain``."""
    Z, Y, X = domain
    return -(-Y // ty) * -(-X // tx) * Z


def ytile_ctas(domain: tuple, ty: int, tx: int, slots: int) -> int:
    """CTAs of ``lbm_ytile``'s persistent grid on a card that holds
    ``slots`` of them at once: one a slot, no more than the steps, and a
    multiple of the tiles where there are no more tiles than that, so that
    each CTA marches one tile's equal share of Z and all CTAs are at the
    same few z planes at once (0.4-1.9 % faster than every slot on an H100
    at (256, 256, 256), though 4 of its 132 slots stay idle at ty 8 and 16)."""
    steps = ytile_steps(domain, ty, tx)
    ctas = max(1, min(slots, steps))
    tiles = steps // domain[0]
    return ctas - ctas % tiles if tiles <= ctas else ctas


def ytile_slab(domain: tuple, ty: int, tx: int, ctas: int) -> int:
    """Output planes each of ``ctas`` CTAs marches at most: the steps cut
    into equal contiguous ranges, one a CTA (a range that crosses a tile's
    last plane is two z segments)."""
    steps = ytile_steps(domain, ty, tx)
    return -(-steps // max(1, min(ctas, steps)))


@functools.cache
def _ytile_slots(device_index: int, elem_bytes: int, smem: int) -> int:
    """y-tile CTAs the card holds at once with ``smem`` bytes of shared
    memory: blocks per SM (the occupancy query) times SMs."""
    n = _lib().lbm_ytile_blocks_per_sm(elem_bytes, smem)
    if n < 1:
        raise RuntimeError(f"lbm_ytile fits no SM at {YTILE_THREADS} threads and {smem} B "
                           f"of shared memory (occupancy query returned {n})")
    return n * torch.cuda.get_device_properties(device_index).multi_processor_count


def lbm_ytile(pdf_p: torch.Tensor, phase_p: torch.Tensor, ty: int, tx: int,
              tau: float = 0.8, kappa: float = 0.15) -> torch.Tensor:
    """One LBM step marching over z per ty x tx output tile, the phase
    field's planes in a shared-memory ring."""
    return _ytile(pdf_p, phase_p, ty, tx, tau, kappa)


def _ytile(pdf_p: torch.Tensor, phase_p: torch.Tensor, ty: int, tx: int, tau: float = 0.8,
           kappa: float = 0.15, *, route: str | None = None, stages: int | None = None,
           ctas: int | None = None) -> torch.Tensor:
    """``lbm_ytile`` with the kernel's choices pinned, for the tests and the
    smoke's other route: ``route`` (``ytile_route`` by default), ``stages``
    (``ytile_stages`` by default) and ``ctas`` (one a resident slot by
    default)."""
    Z, Y, X = _check(pdf_p, phase_p)
    eb = pdf_p.element_size()
    if ty < 1 or tx < 1:
        raise ValueError(f"tile {ty}x{tx} is empty")
    rule = ytile_route(ty, tx, X + 2, eb, phase_p.data_ptr())
    if route not in (None, *YTILE_ROUTES) or (route == "tma" and rule != "tma"):
        raise ValueError(f"route {route!r} does not take this field (ytile_route says {rule!r})")
    route = route or rule
    lay, fit = _ytile_plan(ty, tx, eb, route)
    stages = fit if stages is None else stages
    if (not YTILE_MIN_STAGES <= stages <= YTILE_MAX_STAGES
            or ytile_smem_bytes(ty, tx, eb, stages, route) > SMEM_PER_BLOCK):
        raise ValueError(f"{stages} ring slots for tile {ty}x{tx}: {YTILE_MIN_STAGES} to "
                         f"{YTILE_MAX_STAGES}, in {SMEM_PER_BLOCK} B of shared memory")
    steps = ytile_steps((Z, Y, X), ty, tx)
    if steps >= 2**31:
        raise ValueError(f"{steps} (tile, plane) steps exceed the kernel's 32-bit count")
    if ctas is not None and not 1 <= ctas <= steps:
        raise ValueError(f"{ctas} CTAs for {steps} (tile, plane) steps")
    if pdf_p.device.type == "cpu":
        return lbm_step_ref(pdf_p, phase_p, tau, kappa)[0]
    index = pdf_p.device.index if pdf_p.device.index is not None else torch.cuda.current_device()
    if ctas is None:
        smem = ytile_smem_bytes(ty, tx, eb, stages, route)
        ctas = ytile_ctas((Z, Y, X), ty, tx, _ytile_slots(index, eb, smem))
    out = torch.empty((15, Z, Y, X), dtype=pdf_p.dtype, device=pdf_p.device)
    with torch.cuda.device(index):
        rc = _lib().lbm_ytile_launch(
            eb, pdf_p.data_ptr(), phase_p.data_ptr(), out.data_ptr(), Z, Y, X, ty, tx,
            lay["nb"], lay["w"], lay["bw"], lay["sub_elems"], stages,
            YTILE_ROUTES.index(route), ctas, tau, kappa, raw_stream(index))
    _raise_on(rc, "lbm_ytile")
    LAUNCHES["lbm_ytile"] += 1
    LAST_LAUNCH["lbm_ytile"] = (ty, tx)
    LAST_YTILE.clear()
    LAST_YTILE.update(route=route, tile=(ty, tx), stages=stages, points=YTILE_POINTS[eb],
                      ctas=ctas)
    return out
