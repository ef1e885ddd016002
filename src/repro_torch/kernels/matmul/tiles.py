"""The CUDA GEMM's instantiated tiles and its 16-byte load width, without
torch: the generator (and through it the suite, the wire codec and the
pricing daemon) reads them, and none of those touches a tensor."""
from __future__ import annotations

# the instantiated CTA tiles (bm, bn, bk) of the tensor-core routes per
# element size: bf16 one wgmma pass, fp32 three TF32 passes (split_tf32),
# whose slab sums need a second accumulator: no room for a 256-wide tile
TILES = {
    2: ((128, 256, 64), (128, 128, 64)),
    4: ((128, 128, 32),),
}


def vector_width(elem_bytes: int) -> int:
    """Elements of one 16-byte load: K and N must be multiples of it."""
    return 16 // elem_bytes
