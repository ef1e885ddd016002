"""The port's matmul against the JAX package's Pallas matmul.

The same numpy inputs go through ``repro``'s ``make_matmul`` (interpret
mode, 128-blocks, as ``tests/test_kernels.py::test_matmul_sweep`` runs it)
and through ``repro_torch``'s ``tuned_matmul`` at each of its tiles and its
plain version, with the reference sweep's tolerances (fp32 1e-4, bf16 2e-2,
atol 8x).  On the CPU the wrapper runs the plain version; the CUDA GEMM is
compared with it by the ``gpu``-marked tests, which skip without a card.
The fp32 kernel sums three TF32 passes: ``ref.split_tf32`` and
``matmul_split_tf32_ref`` emulate it here, and on the card its split pass is
held to that emulation bit for bit.
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
from repro_torch.kernels.matmul.ref import (
    matmul_ref,
    matmul_split_parts_ref,
    matmul_split_tf32_ref,
    split_tf32,
    tf32_round,
)

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


@pytest.mark.parametrize("config", list(tpu_space(256, 256, 256)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_space_configs_match_the_jax_entry_point(monkeypatch, dtype, config):
    """Every config of the reference's space at 256 x 256 x 256 runs through
    the entry point, at the kernel's default tile for the dtype (a VMEM
    block decides nothing on the card), and matches the JAX entry point with
    the same config in interpret mode; the port refused them all before
    (every one has bk >= 128)."""
    import jax.numpy as jnp

    from repro.kernels.matmul.ops import tuned_matmul as jtuned

    a_np, b_np = _ab(2, (256, 256, 256))
    a, b = jnp.asarray(a_np).astype(dtype), jnp.asarray(b_np).astype(dtype)
    want = np.asarray(jtuned(a, b, dict(config)), np.float32)
    tiles, real = [], ops.matmul_tiled

    def spy(a, b, bm, bn, bk):
        tiles.append({"bm": bm, "bn": bn, "bk": bk})
        return real(a, b, bm, bn, bk)

    monkeypatch.setattr(ops, "matmul_tiled", spy)
    at, bt = convert.from_numpy(np.asarray(a), "cpu"), convert.from_numpy(np.asarray(b), "cpu")
    got = tuned_matmul(at, bt, dict(config))
    assert tiles == [DEFAULT[at.element_size()]]
    assert got.dtype == at.dtype and got.shape == (256, 256)
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
    assert DEFAULT == {2: {"bm": 128, "bn": 256, "bk": 64}, 4: {"bm": 128, "bn": 128, "bk": 32}}
    assert K.TILES[2] == ((128, 256, 64), (128, 128, 64))
    assert K.TILES[4] == ((128, 128, 32),)
    assert K.ROUTE == {2: "wgmma", 4: "split_tf32"}
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


@pytest.mark.parametrize("name", ["not persistent", "row raster", "no wgmma overlap",
                                  "fp32 one pass", "fp32 not persistent", "fp32 2 stages",
                                  "fp32 no slab sums"])
def test_ablation_edits_find_their_text_once(name):
    """Each variant of ``matmul/ablate.py`` (``--part bf16`` and, prefixed
    "fp32 ", ``--part fp32``) edits text that occurs exactly once in
    ``matmul.cu`` (the PTX helpers moved to ``sm90.cuh``), so it changes
    what it names."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul import ablate

    src = (_build.CSRC / "matmul.cu").read_text()
    table = ablate.F32_VARIANTS if name.startswith("fp32 ") else ablate.VARIANTS
    for old, new in table[name.removeprefix("fp32 ")]:
        assert src.count(old) == 1 and old != new


def test_hopper_helpers_live_in_the_shared_header(monkeypatch, tmp_path):
    """matmul.cu and flash_attention.cu include sm90.cuh for the mbarrier,
    TMA, descriptor and wgmma helpers and the tensor-map encoder, and
    neither keeps a copy; a change to the header rebuilds both."""
    import shutil

    from repro_torch.kernels import _build

    header = (_build.CSRC / "sm90.cuh").read_text()
    for helper in ("mbar_wait", "tma_load_2d", "smem_desc", "wgmma_fence", "encode_bf16"):
        assert f" {helper}(" in header
    for name in ("matmul", "flash_attention"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "sm90.cuh"' in src
        assert "__forceinline__ void mbar_wait(" not in src and "int encode_bf16(" not in src
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in ("matmul", "flash_attention")}
    (csrc / "sm90.cuh").write_text(header + "\n")
    assert all(_build.library_path(n) != p for n, p in before.items())


def test_wrapper_validates_its_tile():
    a, b = torch.zeros((4, 8)), torch.zeros((8, 8))
    with pytest.raises(ValueError, match="not instantiated"):
        K.matmul_tiled(a, b, 128, 256, 64)  # a bf16 tile
    with pytest.raises(ValueError, match="not instantiated"):
        tuned_matmul(a, b, {"bm": 128, "bk": 128, "bn": 128})  # a TPU block
    with pytest.raises(ValueError, match="not instantiated"):
        K.matmul_tiled(a.bfloat16(), b.bfloat16(), 128, 128, 32)  # the mma.sync kernel's tile
    with pytest.raises(ValueError, match="not instantiated"):
        K.matmul_tiled(a, b, 128, 128, 16)  # the CUDA-core kernel's tile, the ablation's alone
    # both kernels are persistent: more row tiles than CUDA's y grid limit
    # (65535, which bound the CUDA-core kernel's (N/bn, M/bm) grid) are no limit
    bf = torch.empty((128 * 65_536, 8), dtype=torch.bfloat16)
    assert K._check(bf, torch.zeros((8, 8), dtype=torch.bfloat16), K.TILES[2][0]) == (
        128 * 65_536, 8, 8)
    f32 = torch.empty((128 * 65_536, 4))
    assert K._check(f32, torch.zeros((4, 4)), K.TILES[4][0]) == (128 * 65_536, 4, 4)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        tuned_matmul(a, torch.zeros((4, 8)))


def test_split_tf32_rounds_to_nearest_ties_away():
    """cvt.rna.tf32.f32: 10 mantissa bits kept, the low 13 zero, halves away
    from zero."""
    x = torch.tensor([1 + 2 ** -12, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 3.0,
                      2 ** -130, 0.0])
    want = torch.tensor([1.0, 1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 3.0, 2 ** -130, 0.0])
    got = tf32_round(x)
    assert torch.equal(got, want) and ((got.view(torch.int32) & 0x1FFF) == 0).all()
    hi, lo = split_tf32(x)
    assert torch.equal(hi, got)
    assert torch.equal(lo[:4], torch.tensor([2 ** -12, -(2 ** -11), 2 ** -11, -(2 ** -11)]))


def test_split_tf32_recovers_x_to_2_pow_minus_22():
    """hi + lo recovers x to 2^-22 of |x|, both parts TF32 values, over a
    spread of magnitudes and signs."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(1 << 16) * np.exp2(rng.integers(-60, 60, 1 << 16))).astype(np.float32)
    hi, lo = split_tf32(torch.from_numpy(x))
    for part in (hi, lo):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    xd = torch.from_numpy(x).double()
    assert float(((hi.double() + lo.double() - xd).abs() / xd.abs()).max()) <= 2.0 ** -22
    assert float(((hi.double() - xd).abs() / xd.abs()).max()) > 2.0 ** -13  # hi alone is not


def test_three_pass_emulation_within_tol_where_one_pass_is_not():
    """At K = 2048 the three-pass product stays within the fp32 GEMM
    tolerance of the fp32 product, where one TF32 pass (hi * hi) does not:
    three passes are needed, one is not enough."""
    a_np, b_np = _ab(6, (128, 2048, 128), scale=2048 ** -0.5)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    want = matmul_ref(a, b)
    tol = _tol("float32")
    torch.testing.assert_close(matmul_split_tf32_ref(a, b), want, **tol)
    one = split_tf32(a)[0] @ split_tf32(b)[0]
    assert not torch.allclose(one, want, **tol)
    exact = a.double() @ b.double()
    err = lambda x: float((x.double() - exact).pow(2).mean().sqrt())
    assert err(matmul_split_tf32_ref(a, b)) <= 3 * err(want) < err(one) / 100


@pytest.mark.parametrize("shape", SWEEP)
def test_split_tf32_emulation_matches_pallas_kernel(shape):
    """The fp32 kernel's arithmetic (three TF32 passes, emulated) against the
    reference's fp32 Pallas matmul, at the sweep's fp32 tolerance."""
    import jax.numpy as jnp

    from repro.kernels.matmul.kernel import make_matmul

    M, K_, N = shape
    a_np, b_np = _ab(7, shape)
    want = np.asarray(make_matmul(M, K_, N, 128, 128, 128, jnp.float32)(
        jnp.asarray(a_np), jnp.asarray(b_np)))
    got = matmul_split_tf32_ref(torch.from_numpy(a_np), torch.from_numpy(b_np))
    np.testing.assert_allclose(got.numpy(), want, **_tol("float32"))


def test_split_wrappers_run_their_plain_versions_on_the_cpu():
    a_np, b_np = _ab(8, (48, 64, 40))
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    K.reset_launch_counts()
    hi, lo = K.split_b(b)
    want_hi, want_lo = split_tf32(b.mT)
    assert hi.shape == lo.shape == (40, 64) and hi.is_contiguous()
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    for tile in K.TILES[4]:
        assert torch.equal(K.split_tf32_gemm(a, hi, lo, tile), matmul_split_parts_ref(a, hi, lo))
        assert torch.equal(K.matmul_tiled(a, b, *tile), matmul_ref(a, b))
    assert K.LAUNCHES == {"matmul_tiled": 0, "matmul_split_b": 0}  # nothing launched
    with pytest.raises(ValueError, match="not instantiated"):
        K.split_tf32_gemm(a, hi, lo, (128, 128, 16))
    with pytest.raises(ValueError, match=r"b_hi, b_lo \(N, K\)"):
        K.split_tf32_gemm(a, hi[:, :32].contiguous(), lo[:, :32].contiguous(), K.TILES[4][0])
    with pytest.raises(ValueError, match="float32"):
        K.split_b(b.bfloat16())


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
    route = K.ROUTE[a.element_size()]
    for tile in K.TILES[a.element_size()]:
        before = dict(K.LAUNCHES)
        got = K.matmul_tiled(a, b, *tile)
        torch.cuda.synchronize()
        assert K.LAUNCHES == {"matmul_tiled": before["matmul_tiled"] + 1,
                              "matmul_split_b": before["matmul_split_b"] + (dtype == torch.float32)}
        assert K.LAST_LAUNCH["matmul_tiled"] == (route, tile)
        assert got.dtype == dtype and got.shape == (shape[0], shape[2])
        torch.testing.assert_close(got, want, **CARD_TOL[dtype], msg=str(tile))


def _layer_gemm_shapes():
    """(M, K, N) of the granite-3-2b layer's GEMMs at 16384 tokens: qkv,
    out, the MLP's input (run twice on the main path) and output."""
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.layers.shapes import attention_proj_shapes, mlp_shapes

    proj = attention_proj_shapes(CONFIG.d_model, CONFIG.n_heads, CONFIG.n_kv,
                                 CONFIG.resolved_head_dim)
    mlp = mlp_shapes(CONFIG.d_model, CONFIG.d_ff, CONFIG.mlp)
    return [(16384, *proj["qkv"]), (16384, *proj["out"]), (16384, *mlp["in"][0]),
            (16384, *mlp["out"][0])]


def test_layer_gemm_shapes():
    assert _layer_gemm_shapes() == [(16384, 2048, 3072), (16384, 2048, 2048),
                                    (16384, 2048, 8192), (16384, 8192, 2048)]


# (8200, 264, 8200): 2145 tiles of 128 x 256 and 4225 of 128 x 128, more than
# 132 SMs x 4, so every persistent CTA walks many tiles and the last wave is
# partial; K = 264 leaves a tail of 8 in the last 64-deep slab
@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["qkv", "out", "mlp.in", "mlp.out", (8200, 264, 8200)])
def test_card_wgmma_matches_plain_on_the_layer_and_many_tiles(cuda, shape):
    if isinstance(shape, str):
        shape = dict(zip(("qkv", "out", "mlp.in", "mlp.out"), _layer_gemm_shapes()))[shape]
    a_np, b_np = _ab(4, shape, scale=shape[1] ** -0.5)
    a = torch.from_numpy(a_np).to(cuda).bfloat16()
    b = torch.from_numpy(b_np).to(cuda).bfloat16()
    want = matmul_ref(a, b)
    for tile in K.TILES[2]:
        got = K.matmul_tiled(a, b, *tile)
        torch.cuda.synchronize()
        assert K.LAST_LAUNCH["matmul_tiled"] == ("wgmma", tile)
        torch.testing.assert_close(got, want, **CARD_TOL[torch.bfloat16], msg=str(tile))


@pytest.mark.gpu
def test_card_entry_point_launches_the_default_tile(cuda):
    a_np, b_np = _ab(3, (512, 256, 384), scale=256 ** -0.5)
    a = torch.from_numpy(a_np).to(cuda).bfloat16()
    b = torch.from_numpy(b_np).to(cuda).bfloat16()
    K.reset_launch_counts()
    got = tuned_matmul(a, b)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"matmul_tiled": 1, "matmul_split_b": 0}
    d = DEFAULT[2]
    assert K.LAST_LAUNCH["matmul_tiled"] == ("wgmma", (d["bm"], d["bn"], d["bk"])) == (
        "wgmma", (128, 256, 64))
    torch.testing.assert_close(got, matmul_ref(a, b), **CARD_TOL[torch.bfloat16])
    # a shape no tile fits runs the plain version, launching nothing
    odd = torch.ones((16, 30), device=cuda, dtype=torch.bfloat16)
    assert torch.equal(tuned_matmul(odd, odd.T.contiguous()),
                       matmul_ref(odd, odd.T.contiguous()))
    assert K.LAUNCHES == {"matmul_tiled": 1, "matmul_split_b": 0}
    # fp32 runs the split pass and the split-TF32 GEMM at its default tile
    got = tuned_matmul(a.float(), b.float())
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"matmul_tiled": 2, "matmul_split_b": 1}
    assert K.LAST_LAUNCH["matmul_tiled"] == ("split_tf32", (128, 128, 32))
    torch.testing.assert_close(got, matmul_ref(a.float(), b.float()), **CARD_TOL[torch.float32])
    with pytest.raises(ValueError, match="aligned"):
        K.matmul_tiled(a.view(-1)[1:1 + 511 * 256].view(511, 256), b, *K.TILES[2][0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("config", [{"bm": 128, "bk": 128, "bn": 128},
                                    {"bm": 512, "bk": 256, "bn": 128}])
def test_card_reference_configs_run_the_default_tile(cuda, dtype, config):
    """A config of the reference's space runs the GEMM at the dtype's
    default tile, and ``LAST_LAUNCH`` names the tile that ran."""
    a_np, b_np = _ab(4, (512, 256, 384), scale=256 ** -0.5)
    a, b = torch.from_numpy(a_np).to(cuda).to(dtype), torch.from_numpy(b_np).to(cuda).to(dtype)
    K.reset_launch_counts()
    got = tuned_matmul(a, b, config)
    torch.cuda.synchronize()
    eb = a.element_size()
    d = DEFAULT[eb]
    assert K.LAUNCHES["matmul_tiled"] == 1
    assert K.LAST_LAUNCH["matmul_tiled"] == (K.ROUTE[eb], (d["bm"], d["bn"], d["bk"]))
    torch.testing.assert_close(got, matmul_ref(a, b), **CARD_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 1028, 260), (70, 12, 4), (513, 100, 1000)])
def test_card_split_tf32_on_k_tails(cuda, shape):
    """K not a multiple of the 32-deep slab (a tail of 4, K below one slab,
    a tail of 4 after three slabs): TMA zero-fills the tail of A, B_hi and
    B_lo alike."""
    a_np, b_np = _ab(10, shape, scale=shape[1] ** -0.5)
    a, b = torch.from_numpy(a_np).to(cuda), torch.from_numpy(b_np).to(cuda)
    for tile in K.TILES[4]:
        got = K.matmul_tiled(a, b, *tile)
        torch.cuda.synchronize()
        assert K.LAST_LAUNCH["matmul_tiled"] == ("split_tf32", tile)
        torch.testing.assert_close(got, matmul_ref(a, b), **CARD_TOL[torch.float32],
                                   msg=str(tile))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2048, 2048), (1028, 260), (12, 4), (100, 1000)])
def test_card_split_b_matches_its_plain_version_bit_for_bit(cuda, shape):
    rng = np.random.default_rng(11)
    b_np = (rng.standard_normal(shape) * np.exp2(rng.integers(-30, 30, shape))).astype(np.float32)
    b = torch.from_numpy(b_np).to(cuda)
    before = K.LAUNCHES["matmul_split_b"]
    hi, lo = K.split_b(b)
    torch.cuda.synchronize()
    assert K.LAUNCHES["matmul_split_b"] == before + 1 and K.LAST_LAUNCH["matmul_split_b"] == shape
    want_hi, want_lo = split_tf32(b.mT)
    assert hi.shape == lo.shape == (shape[1], shape[0])
    assert torch.equal(hi.view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), want_lo.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(128, 128, 32)])
def test_card_split_tf32_fragments_exactly(cuda, tile):
    """A single nonzero x in A at (i, k) and y in B at (k, j) must land on
    C[i, j] alone, bit for bit, at positions across rows mod 16, both
    consumer halves, k within and across slabs, and every output chunk.
    x = 1 + 2^-12 and y = 1 + 2^-13 split into hi 1 and lo 2^-12, 2^-13, so
    C[i, j] = 1 + 2^-12 + 2^-13 needs all three passes (one pass gives 1,
    a missing term drops its own bit): the test pins the A fragment's
    register layout, the ldmatrix swizzle, B's descriptors and the
    epilogue's."""
    assert tile in K.TILES[4]
    M, K_, N = 2 * tile[0], 3 * tile[2], 2 * tile[1]
    x, y, want = 1 + 2 ** -12, 1 + 2 ** -13, 1 + 2 ** -12 + 2 ** -13
    rng = np.random.default_rng(12)
    cases = [(0, 0, 0), (M - 1, K_ - 1, N - 1), (63, 31, 127), (64, 32, 128), (15, 7, 31),
             (8, 4, 8), (71, 36, 33)]
    cases += [tuple(int(v) for v in rng.integers(0, (M, K_, N))) for _ in range(25)]
    a = torch.zeros((M, K_), device=cuda)
    b = torch.zeros((K_, N), device=cuda)
    for i, k, j in cases:
        a[i, k], b[k, j] = x, y
        got = K.matmul_tiled(a, b, *tile)
        torch.cuda.synchronize()
        nz = got.nonzero().tolist()
        assert nz == [[i, j]] and float(got[i, j]) == want, (tile, (i, k, j), nz[:4],
                                                            float(got[i, j]))
        a[i, k], b[k, j] = 0.0, 0.0


@pytest.mark.gpu
def test_card_split_tf32_error_within_3x_of_torch_matmul(cuda):
    """Against an fp64 product on fp32-drawn operands (K = 2048), the
    kernel's RMS and max abs errors are each at most 3x those of
    torch.matmul with TF32 off, a gate that one TF32 pass fails."""
    a_np, b_np = _ab(13, (2048, 2048, 1024), scale=2048 ** -0.5)
    a, b = torch.from_numpy(a_np).to(cuda), torch.from_numpy(b_np).to(cuda)
    exact = a.double() @ b.double()

    def errors(x):
        d = x.double() - exact
        return float(d.pow(2).mean().sqrt()), float(d.abs().max())

    off = errors(torch.matmul(a, b))
    torch.backends.cuda.matmul.allow_tf32 = True
    one = errors(torch.matmul(a, b))
    torch.backends.cuda.matmul.allow_tf32 = False
    assert one[0] > 3 * off[0] and one[1] > 3 * off[1]
    for tile in K.TILES[4]:
        got = errors(K.matmul_tiled(a, b, *tile))
        assert got[0] <= 3 * off[0] and got[1] <= 3 * off[1], (tile, got, off)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1000, 2056, 776), (129, 40, 264)])
def test_card_cuda_core_comparator_matches_plain(cuda, shape):
    """The fp32 CUDA-core kernel the split route replaced, which the
    ablation reaches through the C entry point as its "before", is still
    right."""
    from repro_torch.kernels.matmul.ablate import CUDA_CORE_TILE

    a_np, b_np = _ab(14, shape, scale=shape[1] ** -0.5)
    a, b = torch.from_numpy(a_np).to(cuda), torch.from_numpy(b_np).to(cuda)
    got = torch.empty((shape[0], shape[2]), device=cuda)
    rc = K._lib().matmul_tiled_launch(4, a.data_ptr(), b.data_ptr(), got.data_ptr(), shape[0],
                                      shape[2], shape[1], *CUDA_CORE_TILE,
                                      torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    torch.testing.assert_close(got, matmul_ref(a, b), **CARD_TOL[torch.float32])
