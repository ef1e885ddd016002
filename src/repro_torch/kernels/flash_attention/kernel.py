"""Wrappers of the hand-written CUDA attention kernels
(``repro_torch/csrc/flash_attention.cu``).

* ``flash_attention_fwd(q, k, v, bq, bk, causal, blocks=None)`` — the
  causal GQA forward with online softmax over q blocks of bq rows and KV
  blocks of bk keys.  Replaces the TPU's ``make_flash_attention(B, Hq,
  Hkv, Sq, Skv, D, bq, bk, causal)``; bq | Sq and bk | Skv, as there.  Head
  dims 32, 64, 80, 96 and 128 (the repo's configs) in both dtypes.
  ``fwd_route`` names the kernel a call runs: bf16 at (128, 128) and
  (64, 64) the persistent, warp-specialised wgmma + TMA kernel
  (``"wgmma"``; D 32, 80 and 96 padded to whole 64-column boxes in shared
  memory only), fp32 three TF32 passes on the tensor cores
  (``"split_tf32"``, plain emulation ``ref.attention_split_tf32_ref``),
  each at every head dim.  A causal row that sees no key (Sq > Skv)
  gets the reference kernel's value at the tile ``blocks`` (the tile that
  runs by default, else a multiple of it, as every config of the
  reference's space is of (128, 128)): the mean of V over the keys of the
  KV blocks the reference computes for its q block, or 0 where it computes
  none (``ref.attention_blocks_ref``).
* ``flash_decode(q, k, v, bk, splits=None)`` — one query token against
  the KV cache.  Replaces ``make_flash_decode(B, Hq, Hkv, Skv, D, bk)``.
  ``decode_route`` names the kernel: bf16 at D 64 or 128 runs the
  tensor-core kernel fed by a TMA ring (``"tma_mma"``), bf16 at D 32, 80
  and 96 and fp32 the CUDA-core kernel fed by a ring of bulk copies
  (``"cuda_cores"``).  Both walk their own blocks (bk is validated as the
  reference's, not used) and, where their units would not fill the card,
  split the cache into ``decode_splits`` parts of whole 128-key blocks
  (``splits`` pins the count) whose partials the second kernel,
  ``decode_combine``, merges.

q is (B, Hq, Sq, D) (Sq = 1 for decode), k and v (B, Hkv, Skv, D), all
contiguous and of one dtype; Hkv divides Hq.  On CPU tensors both compute
the plain version (``ref.attention_ref``); on CUDA tensors they launch the
kernel on the current stream or raise.  ``LAUNCHES`` counts kernel
launches per wrapper, and ``LAST_LAUNCH`` holds what each last ran on the
card: ``(bq, bk, causal)`` and ``bk``; ``LAST_DECODE`` the last decode's
route and splits.  ``wgmma_pv_probe`` runs one
consumer's P·V of the wgmma kernel alone, a card check of its register
fragment layout.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, raw_stream
from repro_torch.kernels.flash_attention.ref import (
    DECODE_BLOCK,
    attention_blocks_ref,
    attention_ref,
    combine_partials_ref,
    decode_split_bounds,
)

LAUNCHES = {"flash_attention_fwd": 0, "flash_decode": 0, "flash_decode_combine": 0}
LAST_LAUNCH = {"flash_attention_fwd": None, "flash_decode": None}
LAST_DECODE = {"route": None, "splits": None}

# the instantiated forward kernels: (bq, bk) tiles, and head dims per dtype
# (the repo's model configs: 64, 80 zamba2-2.7b, 96 phi3-mini-3.8b, 128 mixtral-8x7b
# and others; 32 their reduced forms)
HEAD_DIMS = (32, 64, 80, 96, 128)
FWD_TILES = ((128, 128), (64, 64))
FWD_HEAD_DIMS = {torch.bfloat16: HEAD_DIMS, torch.float32: HEAD_DIMS}
# the kernel of each forward route, as csrc/flash_attention.cu's flash_fwd_route numbers them
FWD_ROUTES = {"wgmma": 1, "split_tf32": 5}
DECODE_HEAD_DIMS = HEAD_DIMS
DECODE_BK_MAX = 2048          # the largest bk flash_decode validates (no kernel reads bk)
# the kernel of each decode route, as csrc/flash_attention.cu's flash_decode_route numbers them
DECODE_ROUTES = {"tma_mma": 4, "cuda_cores": 3}
TMA_DECODE_HEAD_DIMS = (64, 128)
DECODE_ROWS = 16              # query heads of one tensor-core decode unit (an m16n8k16 A tile)
CORE_DECODE_ROWS = (4, 8)     # query heads of one CUDA-core decode unit: 4 for groups of <= 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launch_counts() -> None:
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    LAST_LAUNCH.update(dict.fromkeys(LAST_LAUNCH))
    LAST_DECODE.update(route=None, splits=None)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = _build.load("flash_attention")
    lib.flash_fwd_launch.argtypes = [_I, _P, _P, _P, _P] + [_I] * 10 + [_F, _I, _P]
    lib.flash_decode_launch.argtypes = [_I, _P, _P, _P, _P, _P] + [_I] * 6 + [_F, _P]
    lib.flash_decode_combine_launch.argtypes = [_P, _P, _I, _I, _I, _I, _P]
    lib.flash_fwd_route.argtypes = [_I] * 4
    lib.flash_decode_route.argtypes = [_I] * 2
    lib.flash_pv_probe_launch.argtypes = [_P, _P, _P, _I, _P]
    for fn in (lib.flash_fwd_launch, lib.flash_decode_launch, lib.flash_decode_combine_launch,
               lib.flash_fwd_route, lib.flash_decode_route, lib.flash_pv_probe_launch):
        fn.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> tuple:
    """Validate the operands; return (B, Hq, Hkv, Sq, Skv, D)."""
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        raise TypeError("q, k and v must be torch tensors")
    if q.dtype not in FWD_HEAD_DIMS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be bfloat16 or float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1 or q.device.type not in ("cpu", "cuda"):
        raise ValueError("q, k and v must lie on one CPU or CUDA device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or min(B, Hq, Sq, D, Hkv, Skv) < 1 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)} do not match "
                         "(same B and D, Hkv dividing Hq)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    return B, Hq, Hkv, Sq, Skv, D


def fwd_route(dtype: torch.dtype, D: int, bq: int, bk: int) -> str:
    """The forward kernel that a call with ``dtype``, head dim ``D`` and tile
    (bq, bk) runs on the card: ``"wgmma"`` (bf16 at (128, 128) and
    (64, 64)) or ``"split_tf32"`` (fp32); raises ValueError for a
    combination not instantiated."""
    if (bq, bk) not in FWD_TILES:
        raise ValueError(f"(bq, bk) = {(bq, bk)} is not instantiated; choose from {FWD_TILES}")
    if dtype not in FWD_HEAD_DIMS or D not in FWD_HEAD_DIMS[dtype]:
        raise ValueError(f"head dim {D} is not instantiated for {dtype}; "
                         f"choose from {FWD_HEAD_DIMS.get(dtype, ())}")
    return "split_tf32" if dtype == torch.float32 else "wgmma"


def decode_route(dtype: torch.dtype, D: int) -> str:
    """The decode kernel that a call with ``dtype`` and head dim ``D`` runs
    on the card: ``"tma_mma"`` (bf16 at D 64 and 128) or ``"cuda_cores"``
    (bf16 at D 32, 80 and 96; fp32); raises ValueError for a combination
    not instantiated."""
    if dtype not in FWD_HEAD_DIMS or D not in DECODE_HEAD_DIMS:
        raise ValueError(f"decode at head dim {D} is not instantiated for {dtype}; choose "
                         f"bfloat16 or float32 and a head dim from {DECODE_HEAD_DIMS}")
    return "tma_mma" if dtype == torch.bfloat16 and D in TMA_DECODE_HEAD_DIMS else "cuda_cores"


def decode_chunks(route: str, group: int) -> int:
    """Units a decode kernel makes of a KV head's ``group`` query heads:
    chunks of DECODE_ROWS on ``"tma_mma"``, and on ``"cuda_cores"`` of 4
    where the group has at most 4 heads, else of 8 (``CORE_DECODE_ROWS``)."""
    rows = DECODE_ROWS if route == "tma_mma" else CORE_DECODE_ROWS[group > CORE_DECODE_ROWS[0]]
    return -(-group // rows)


@functools.cache
def decode_splits(B: int, Hkv: int, chunks: int, Skv: int, sms: int) -> int:
    """How many parts either decode kernel splits the cache into.  A unit
    is (b, KV head, chunk of the group's query heads (``decode_chunks``),
    split); persistent CTAs, one per SM, walk the units.  1 where the B·Hkv·chunks units already
    fill the ``sms`` SMs; else the count, up to four times what gives each
    SM a unit, with the least modelled time: waves of units times (blocks
    of 128 keys a unit + 1, the unit's start and end; the ablation's split
    sweep at B 8 measured that overhead at about one block).  Each split is
    a whole number of blocks (``ref.decode_split_bounds``)."""
    units = B * Hkv * chunks
    if units >= sms:
        return 1
    nb = -(-Skv // DECODE_BLOCK)

    def cost(s):
        return -(-units * s // sms) * (-(-nb // s) + 1)

    return min(range(1, min(nb, 4 * -(-sms // units)) + 1), key=lambda s: (cost(s), s))


def _aligned(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("q, k and v must be 16-byte aligned")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().flash_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int = 128,
                        bk: int = 128, causal: bool = True, blocks: tuple | None = None
                        ) -> torch.Tensor:
    """Causal (or full) GQA attention, (B, Hq, Sq, D), in q's dtype, at the
    tile (bq, bk).  ``blocks`` (rbq, rbk), by default (bq, bk), is the
    reference's tile whose KV blocks the rows that see no key average
    (``ref.attention_blocks_ref``): a multiple of (bq, bk), with rbq | Sq and
    rbk | Skv."""
    B, Hq, Hkv, Sq, Skv, D = _check(q, k, v)
    bq, bk, causal = int(bq), int(bk), bool(causal)
    rbq, rbk = (bq, bk) if blocks is None else (int(blocks[0]), int(blocks[1]))
    if Sq % bq or Skv % bk:
        raise ValueError(f"bq={bq} must divide Sq={Sq} and bk={bk} Skv={Skv}")
    if min(rbq, rbk) < 1 or Sq % rbq or Skv % rbk or rbq % bq or rbk % bk:
        raise ValueError(f"blocks {(rbq, rbk)}: must be a multiple of the tile {(bq, bk)}, rbq "
                         f"must divide Sq={Sq} and rbk Skv={Skv}")
    fwd_route(q.dtype, D, bq, bk)
    if q.device.type == "cpu":
        return attention_blocks_ref(q, k, v, causal, rbq, rbk)
    _aligned(q, k, v)
    out = torch.empty_like(q)
    index = q.get_device()
    with torch.cuda.device(index):
        rc = _lib().flash_fwd_launch(
            q.element_size(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Skv, D, bq, bk, rbq, rbk, D ** -0.5, int(causal), raw_stream(index))
    _raise_on(rc, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    LAST_LAUNCH["flash_attention_fwd"] = (bq, bk, causal)
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bk: int = 128,
                 splits: int | None = None) -> torch.Tensor:
    """One query token (B, Hq, 1, D) against the whole cache (no mask).
    ``bk`` is the reference's block, validated for every call as there (it
    also makes Skv a multiple of 64, the CUDA-core kernel's block); neither
    kernel uses it.  ``splits`` pins the split count (1 up to the cache's
    128-key blocks); by default ``decode_splits`` chooses it from the
    card's SM count."""
    B, Hq, Hkv, Sq, Skv, D = _check(q, k, v)
    bk = int(bk)
    if Sq != 1:
        raise ValueError(f"flash_decode takes one query token, got Sq={Sq}")
    if bk < 64 or bk % 64 or bk > DECODE_BK_MAX or Skv % bk:
        raise ValueError(f"bk={bk} must be a multiple of 64 up to {DECODE_BK_MAX} "
                         f"that divides Skv={Skv}")
    if D not in DECODE_HEAD_DIMS:
        raise ValueError(f"head dim {D} is not instantiated; choose from {DECODE_HEAD_DIMS}")
    route = decode_route(q.dtype, D)
    if splits is not None:
        splits = int(splits)
        decode_split_bounds(Skv, splits)  # 1 <= splits <= the cache's 128-key blocks
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=False)
    _aligned(q, k, v)
    if splits is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = decode_splits(B, Hkv, decode_chunks(route, Hq // Hkv), Skv, sms)
    # one split writes the output, more write the partials for decode_combine
    if splits == 1:
        out, part = torch.empty_like(q), None
    else:
        out, part = None, torch.empty((B, Hq, splits, D + 2), device=q.device, dtype=torch.float32)
    index = q.get_device()
    with torch.cuda.device(index):
        stream = raw_stream(index)
        rc = _lib().flash_decode_launch(
            q.element_size(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr() if part is None else None, None if part is None else part.data_ptr(),
            B, Hq, Hkv, Skv, D, splits, D ** -0.5, stream)
        _raise_on(rc, "flash_decode")
        LAUNCHES["flash_decode"] += 1
        LAST_LAUNCH["flash_decode"] = bk
        LAST_DECODE.update(route=route, splits=splits)
        return out if part is None else _combine(part, q.dtype, stream)


def decode_combine(part: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, Hq, 1, D) in ``dtype`` (bfloat16 or float32) from the split
    decode's partials (B, Hq, splits, D + 2) fp32 (each split's
    unnormalised O, its max m of the scaled scores, its sum l;
    ``ref.decode_partials_ref``), D one of ``DECODE_HEAD_DIMS``: on the
    card the combine kernel, on the CPU the plain version
    ``ref.combine_partials_ref``."""
    if not isinstance(part, torch.Tensor) or part.dim() != 4 or part.dtype != torch.float32 \
            or part.shape[-1] - 2 not in DECODE_HEAD_DIMS:
        raise ValueError(f"expected partials fp32 (B, Hq, splits, D + 2) with D in "
                         f"{DECODE_HEAD_DIMS}, got {getattr(part, 'dtype', type(part))} "
                         f"{tuple(getattr(part, 'shape', ()))}")
    if dtype not in FWD_HEAD_DIMS:
        raise ValueError(f"the combine writes bfloat16 or float32, not {dtype}")
    if part.device.type == "cpu":
        return combine_partials_ref(part, dtype)
    part = part.contiguous()
    index = part.get_device()
    with torch.cuda.device(index):
        return _combine(part, dtype, raw_stream(index))


def _combine(part: torch.Tensor, dtype: torch.dtype, stream: int) -> torch.Tensor:
    """Launch the combine kernel on contiguous partials of the current
    device, on ``stream``."""
    B, Hq, splits, D = part.shape[0], part.shape[1], part.shape[2], part.shape[3] - 2
    out = torch.empty((B, Hq, 1, D), device=part.device, dtype=dtype)
    rc = _lib().flash_decode_combine_launch(part.data_ptr(), out.data_ptr(), B * Hq, D, splits,
                                            out.element_size(), stream)
    _raise_on(rc, "flash_decode_combine")
    LAUNCHES["flash_decode_combine"] += 1
    return out


def wgmma_pv_probe(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One consumer warpgroup's O = P·V in the wgmma kernel, alone: p fp32
    (64, 128) goes into the S accumulator's registers, is rounded to bf16 A
    fragments as the kernel rounds them and multiplied with v bf16
    (128, D), D one of ``HEAD_DIMS``, loaded by TMA (zero-padded to whole
    64-column boxes, as in the kernel); returns O fp32 (64, D).  A card
    check of the register-A fragment layout; it has no plain version."""
    if p.shape != (64, 128) or p.dtype != torch.float32 or v.dtype != torch.bfloat16 \
            or v.dim() != 2 or v.shape[0] != 128 or v.shape[1] not in HEAD_DIMS:
        raise ValueError(f"expected p fp32 (64, 128) and v bf16 (128, D in {HEAD_DIMS}), got "
                         f"{p.dtype} {tuple(p.shape)}, {v.dtype} {tuple(v.shape)}")
    if p.device.type != "cuda" or v.device != p.device:
        raise ValueError("wgmma_pv_probe runs only on the card")
    p, v = p.contiguous(), v.contiguous()
    _aligned(p, v)
    out = torch.empty((64, v.shape[1]), device=p.device, dtype=torch.float32)
    index = p.get_device()
    with torch.cuda.device(index):
        rc = _lib().flash_pv_probe_launch(p.data_ptr(), v.data_ptr(), out.data_ptr(), v.shape[1],
                                          raw_stream(index))
    _raise_on(rc, "wgmma_pv_probe")
    return out
