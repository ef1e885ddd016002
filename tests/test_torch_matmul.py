"""The port's matmul against the JAX package's Pallas matmul.

The same numpy inputs go through ``repro``'s ``make_matmul`` (interpret
mode, 128-blocks, as ``tests/test_kernels.py::test_matmul_sweep`` runs it)
and through ``repro_torch``'s ``tuned_matmul`` at each of its tiles and its
plain version, with the reference sweep's tolerances (fp32 1e-4, bf16 2e-2,
atol 8x).  On the CPU the wrapper runs the plain version; the CUDA GEMM is
compared with it by the ``gpu``-marked tests, which skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.core.machines import H100
from repro_torch.kernels import TPU_REASON, get_generator, tpu_skipped
from repro_torch.kernels.matmul import kernel as K
from repro_torch.kernels.matmul import ops
from repro_torch.kernels.matmul.generator import (
    DEFAULT,
    SUITE_GPU_BLOCKS,
    TILES,
    default_config,
    suite_gpu_configs,
    suite_price,
    tpu_space,
)
from repro_torch.kernels.matmul.ops import tuned_matmul
from repro_torch.kernels.matmul.ref import matmul_ref

SWEEP = [(128, 128, 128), (256, 384, 128), (128, 256, 256)]


def _ab(seed, shape, scale=1.0):
    M, K_, N = shape
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K_)).astype(np.float32)
    b = (rng.standard_normal((K_, N)) * scale).astype(np.float32)
    return a, b


def _tol(dtype):
    tol = 1e-4 if dtype == "float32" else 2e-2
    return dict(rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tuned_matmul_matches_pallas_kernel(shape, dtype):
    import jax.numpy as jnp

    from repro.kernels.matmul.kernel import make_matmul

    M, K_, N = shape
    a_np, b_np = _ab(0, shape)
    a, b = jnp.asarray(a_np).astype(dtype), jnp.asarray(b_np).astype(dtype)
    want = np.asarray(make_matmul(M, K_, N, 128, 128, 128, a.dtype)(a, b), np.float32)
    at, bt = convert.from_numpy(np.asarray(a), "cpu"), convert.from_numpy(np.asarray(b), "cpu")
    eb = at.element_size()
    for config in (None, *TILES[eb]):
        got = tuned_matmul(at, bt, config)
        assert got.dtype == at.dtype and got.shape == (M, N)
        np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))
    np.testing.assert_allclose(matmul_ref(at, bt).float().numpy(), want, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tuned_matmul_matches_reference_entry_point(dtype):
    """The reference's ``tuned_matmul`` with a pinned config (its ranking
    needs the tracer, broken on jax 0.9) against the port's with none."""
    import jax.numpy as jnp

    from repro.kernels.matmul.ops import tuned_matmul as jtuned

    a_np, b_np = _ab(1, (256, 256, 384))
    a, b = jnp.asarray(a_np).astype(dtype), jnp.asarray(b_np).astype(dtype)
    want = np.asarray(jtuned(a, b, {"bm": 128, "bk": 128, "bn": 128}), np.float32)
    got = tuned_matmul(convert.from_numpy(np.asarray(a), "cpu"),
                       convert.from_numpy(np.asarray(b), "cpu"))
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))


def test_matmul_ref_accumulates_in_fp32():
    a = torch.full((1, 4096), 1.0, dtype=torch.bfloat16)
    b = torch.full((4096, 1), 1.0 + 2 ** -7, dtype=torch.bfloat16)
    assert float(matmul_ref(a, b)) == 4128.0  # a bf16 running sum would stall at 256
    assert matmul_ref(a, b).dtype == torch.bfloat16
    assert matmul_ref(a, b, torch.float32).dtype == torch.float32


def test_config_cache_is_shape_keyed():
    ops._CONFIG_CACHE.clear()
    a, b = torch.zeros((64, 32)), torch.zeros((32, 48))
    tuned_matmul(a, b)
    tuned_matmul(a.bfloat16(), b.bfloat16())
    assert ops._CONFIG_CACHE == {(64, 32, 48, 4): DEFAULT[4], (64, 32, 48, 2): DEFAULT[2]}


@pytest.mark.parametrize("shape,dtype", [
    ((16, 30, 8), torch.bfloat16),   # K not a multiple of 8
    ((16, 32, 12), torch.bfloat16),  # N not a multiple of 8
    ((16, 6, 8), torch.float32),     # K not a multiple of 4
    ((16, 32, 32), torch.float64),   # no kernel for the dtype
    ((16, 32, 32), torch.float16),
])
def test_shapes_no_tile_fits_run_the_plain_version(monkeypatch, shape, dtype):
    M, K_, N = shape
    a = torch.randn((M, K_), generator=torch.Generator().manual_seed(0)).to(dtype)
    b = torch.randn((K_, N), generator=torch.Generator().manual_seed(1)).to(dtype)
    assert default_config(M, K_, N, a.element_size()) is None or dtype not in K.KERNEL_DTYPES

    def no_kernel(*args):
        raise AssertionError("the kernel wrapper was called")

    monkeypatch.setattr(ops, "matmul_tiled", no_kernel)
    ops._CONFIG_CACHE.clear()
    got = tuned_matmul(a, b)
    assert torch.equal(got, matmul_ref(a, b)) and ops._CONFIG_CACHE == {}


def test_generator_skips_the_tpu_space():
    skipped = tpu_skipped(tpu_space(256, 512, 1024))
    assert [s.config for s in skipped] == list(tpu_space(256, 512, 1024))
    assert all(s.reason == TPU_REASON for s in skipped)
    assert "VMEM" in TPU_REASON and "tensor-core" in TPU_REASON
    assert skipped[0].config == {"bm": 128, "bk": 128, "bn": 128}
    assert len(skipped) == 2 * 3 * 4
    assert tpu_skipped(tpu_space(64, 64, 64)) == []
    assert get_generator("matmul").tpu_space is tpu_space


def test_tpu_space_equals_reference():
    from repro.kernels.matmul.generator import _space

    for shape in [(256, 512, 1024), (384, 4096, 128), (2048, 2048, 8192), (100, 128, 128)]:
        assert list(tpu_space(*shape)) == list(_space(*shape))


def test_tiles_and_defaults():
    assert DEFAULT == {2: {"bm": 128, "bn": 128, "bk": 32}, 4: {"bm": 128, "bn": 128, "bk": 16}}
    assert len(TILES[2]) >= 2
    for eb, tiles in TILES.items():
        assert DEFAULT[eb] in tiles
        assert [(t["bm"], t["bn"], t["bk"]) for t in tiles] == list(K.TILES[eb])
    assert default_config(16384, 2048, 3072, 2) == DEFAULT[2]
    assert default_config(1000, 2056, 776, 4) == DEFAULT[4]


def test_suite_blocks_equal_reference():
    from repro.suite.lowering import SUITE_GPU_BLOCKS as REF_BLOCKS
    from repro.suite.lowering import suite_gpu_configs as ref_configs

    assert SUITE_GPU_BLOCKS == REF_BLOCKS
    assert [(c.block, c.folding) for c in suite_gpu_configs()] == [
        (c.block, c.folding) for c in ref_configs()]


def test_suite_price_ranks_the_eight_blocks():
    ranked = suite_price(192, 64, 128, 2, H100)
    assert len(ranked) == 8 and ranked.skipped == []
    assert {rc.launch.block for rc in ranked} == set(SUITE_GPU_BLOCKS)
    assert all(a.perf >= b.perf for a, b in zip(ranked, ranked[1:]))
    assert ranked[0].estimate.kernel == "gemm_192x64x128"


@pytest.mark.parametrize("a,b,exc,match", [
    (np.zeros((4, 8), np.float32), torch.zeros((8, 8)), TypeError, "torch tensors"),
    (torch.zeros((4, 8)), torch.zeros((8, 8), dtype=torch.bfloat16), TypeError, "bfloat16"),
    (torch.zeros((4, 8), dtype=torch.float64), torch.zeros((8, 8), dtype=torch.float64),
     TypeError, "bfloat16"),
    (torch.zeros((4, 8)), torch.zeros((4, 8)), ValueError, r"\(M, K\)"),
    (torch.zeros((0, 8)), torch.zeros((8, 8)), ValueError, r"\(M, K\)"),
    (torch.zeros((8, 4)).T, torch.zeros((8, 8)), ValueError, "contiguous"),
    (torch.zeros((4, 6)), torch.zeros((6, 8)), ValueError, "multiples of 4"),
    (torch.zeros((4, 8), dtype=torch.bfloat16), torch.zeros((8, 12), dtype=torch.bfloat16),
     ValueError, "multiples of 8"),
])
def test_wrapper_validates_its_operands(a, b, exc, match):
    tile = K.TILES[2 if getattr(a, "dtype", None) == torch.bfloat16 else 4][0]
    with pytest.raises(exc, match=match):
        K.matmul_tiled(a, b, *tile)


def test_wrapper_validates_its_tile():
    a, b = torch.zeros((4, 8)), torch.zeros((8, 8))
    with pytest.raises(ValueError, match="not instantiated"):
        K.matmul_tiled(a, b, 128, 128, 32)  # a bf16 tile
    with pytest.raises(ValueError, match="not instantiated"):
        tuned_matmul(a, b, {"bm": 128, "bk": 128, "bn": 128})  # a TPU block
    with pytest.raises(ValueError, match="grid limit"):
        K.matmul_tiled(torch.empty((128 * 65_536, 4)), torch.zeros((4, 4)), 128, 128, 16)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        tuned_matmul(a, torch.zeros((4, 8)))


# ---------------------------------------------------------------------------
# On the card: every tile of the CUDA GEMM against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2), torch.float32: dict(rtol=1e-4, atol=8e-4)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1000, 2056, 776), (129, 40, 264), (7, 8, 8), (4100, 512, 1032)])
def test_card_every_tile_matches_plain_on_ragged_shapes(cuda, dtype, shape):
    """No tile divides these shapes: every edge mask and the K tail run."""
    a_np, b_np = _ab(2, shape, scale=shape[1] ** -0.5)
    a = torch.from_numpy(a_np).to(cuda).to(dtype)
    b = torch.from_numpy(b_np).to(cuda).to(dtype)
    want = matmul_ref(a, b)
    for tile in K.TILES[a.element_size()]:
        before = K.LAUNCHES["matmul_tiled"]
        got = K.matmul_tiled(a, b, *tile)
        torch.cuda.synchronize()
        assert K.LAUNCHES["matmul_tiled"] == before + 1
        assert K.LAST_LAUNCH["matmul_tiled"] == tile
        assert got.dtype == dtype and got.shape == (shape[0], shape[2])
        torch.testing.assert_close(got, want, **CARD_TOL[dtype], msg=str(tile))


@pytest.mark.gpu
def test_card_entry_point_launches_the_default_tile(cuda):
    a_np, b_np = _ab(3, (512, 256, 384), scale=256 ** -0.5)
    a = torch.from_numpy(a_np).to(cuda).bfloat16()
    b = torch.from_numpy(b_np).to(cuda).bfloat16()
    K.reset_launch_counts()
    got = tuned_matmul(a, b)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"matmul_tiled": 1}
    d = DEFAULT[2]
    assert K.LAST_LAUNCH["matmul_tiled"] == (d["bm"], d["bn"], d["bk"])
    torch.testing.assert_close(got, matmul_ref(a, b), **CARD_TOL[torch.bfloat16])
    # a shape no tile fits runs the plain version, launching nothing
    odd = torch.ones((16, 30), device=cuda, dtype=torch.bfloat16)
    assert torch.equal(tuned_matmul(odd, odd.T.contiguous()),
                       matmul_ref(odd, odd.T.contiguous()))
    assert K.LAUNCHES == {"matmul_tiled": 1}
    with pytest.raises(ValueError, match="aligned"):
        K.matmul_tiled(a.view(-1)[1:1 + 511 * 256].view(511, 256), b, *K.TILES[2][0])
