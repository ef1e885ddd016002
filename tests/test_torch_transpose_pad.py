"""The port's transpose against the JAX package's Pallas kernel.

The same numpy inputs go through ``repro``'s padded tiled transpose
(``make_transpose`` in interpret mode at pinned tiles, and its entry point
``transpose(x, config)``) and through ``repro_torch``
(``convert.from_numpy``); a transpose only moves data, so they must agree
exactly.  Every shape is non-square, so that an M/N swap shows.  On the CPU
the port's wrappers run their plain version; the CUDA kernels themselves are
compared with it by the ``gpu``-marked tests, which skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.core.access import LaunchConfig
from repro_torch.core.machines import H100
from repro_torch.core.selector import enumerate_gpu_configs, rank_gpu_configs
from repro_torch.core.specs import transpose_pad
from repro_torch.kernels import DEPTH_REASON, SCRATCH_REASON, dtype_for, fills_depth, get_generator
from repro_torch.kernels.transpose_pad import kernel as K
from repro_torch.kernels.transpose_pad.generator import (
    generate,
    pad_to_tiles,
    pow2_tiles,
    rank_configs,
    tile_space,
)
from repro_torch.kernels.transpose_pad.ops import transpose
from repro_torch.kernels.transpose_pad.ref import transpose_ref


def _x(seed, dtype, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,bm,bn", [((40, 56), 8, 8), ((64, 32), 16, 32)])
def test_plain_version_matches_pallas_kernel(shape, bm, bn, dtype):
    import jax
    import jax.numpy as jnp

    from repro.kernels.transpose_pad.kernel import make_transpose

    x_np = _x(0, dtype, shape)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(make_transpose(*shape, bm, bn, jnp.asarray(x_np).dtype)(
            jnp.asarray(x_np)))
    got = transpose_ref(convert.from_numpy(x_np, "cpu"))
    assert got.shape == shape[::-1] and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("config", [
    None, {"bm": 16, "bn": 32}, {"bm": 8, "bn": 8},
    {"block": (8, 4, 2), "folding": (1, 2, 1)}, {"block": (4, 4, 64), "folding": (1, 2, 1)}])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_transpose_end_to_end_matches_reference(config, dtype):
    """A shape off the tile grid: the reference pads it to whole tiles and
    crops; the port pads nothing."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.transpose_pad.ops import transpose as jtranspose

    x_np = _x(7, dtype, (37, 53))
    ref_config = config if config and "bm" in config else {"bm": 8, "bn": 8}
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jtranspose(jnp.asarray(x_np), ref_config))
    got = transpose(convert.from_numpy(x_np, "cpu"), config)
    assert got.shape == (53, 37) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.int32, torch.float64])
def test_transpose_moves_every_width(dtype):
    x = torch.arange(5 * 7).reshape(5, 7).to(dtype)
    assert torch.equal(transpose(x), x.T.contiguous())
    assert torch.equal(transpose(x.T), x)  # a non-contiguous input is made contiguous


def test_tile_helpers_equal_reference():
    from repro.core.tpu_adapt import pow2_tiles as ref_pow2_tiles
    from repro.kernels.transpose_pad.generator import pad_to_tiles as ref_pad_to_tiles

    for n in (1, 7, 8, 9, 37, 512, 8192):
        for tile in (8, 32, 128):
            assert pad_to_tiles(n, tile) == ref_pad_to_tiles(n, tile)
    assert pow2_tiles(8, 512) == ref_pow2_tiles(8, 512) == [8, 16, 32, 64, 128, 256, 512]
    assert pow2_tiles(8, 4) == ref_pow2_tiles(8, 4) == []


@pytest.mark.parametrize("shape", [(37, 53), (64, 96), (8192, 8192)])
def test_generator_ranks_every_launch_and_skips_the_tile_space(shape):
    from repro.kernels.transpose_pad.generator import _space

    ranked = rank_configs(shape, 4, H100)
    # 22 of the 168 launches fill the (1, Y, X) domain's depth; 146 are skipped
    deep = [s for s in ranked.skipped if s.reason == DEPTH_REASON]
    assert len(ranked) == 22 and len(deep) == 146
    want = list(_space(pad_to_tiles(shape[0], 8), pad_to_tiles(shape[1], 8)))
    tiles = ranked.skipped[:len(want)]
    assert [s.config for s in tiles] == want == list(tile_space(shape))
    assert want and all(s.reason == SCRATCH_REASON for s in tiles)
    assert ranked.skipped == tiles + deep
    ranked.clear()  # callers get a copy; the memoized ranking is untouched
    assert len(rank_configs(shape, 4, H100)) == 22


@pytest.mark.parametrize("shape,elem_bytes", [((37, 53), 4), ((64, 96), 8), ((8192, 8192), 4)])
def test_ranking_is_the_core_ranking_filtered_to_flat_launches(shape, elem_bytes):
    """Kept: the core's ranking (pinned to the reference's in
    test_torch_core.py), bitwise and in order, less the launches with
    bz·fz > 1, which are skipped with DEPTH_REASON in that same order."""
    core = rank_gpu_configs(transpose_pad(shape, elem_bytes), H100)
    assert len(core) == 168
    ranked = rank_configs(shape, elem_bytes, H100)
    flat = [rc for rc in core if rc.launch.block[2] * rc.launch.folding[2] == 1]
    assert [(rc.launch, rc.perf) for rc in ranked] == [(rc.launch, rc.perf) for rc in flat]
    assert all(fills_depth(rc.launch) for rc in ranked)
    deep = [s.config for s in ranked.skipped if s.reason == DEPTH_REASON]
    assert deep == [{"block": rc.launch.block, "folding": rc.launch.folding}
                    for rc in core if not fills_depth(rc.launch)]
    kern, best = generate(shape, dtype=dtype_for(elem_bytes), device="cpu")
    assert best.launch == ranked[0].launch == flat[0].launch
    if shape == (8192, 8192):  # the paper size: the top launch overall has bz = 64
        assert core[0].launch.block[2] > 1
        assert ranked[0].launch == LaunchConfig(block=(4, 256, 1), folding=(1, 1, 1))


def test_tile_space_of_the_paper_size():
    space = list(tile_space((8192, 8192)))
    assert len(space) == 49 and space[0] == {"bm": 8, "bn": 8} and space[-1] == {
        "bm": 512, "bn": 512}
    assert get_generator("transpose_pad").rank_configs is rank_configs


def test_generate_returns_the_best_launch():
    kern, best = generate((40, 24), dtype=torch.float32, device="cpu")
    assert best.launch == rank_configs((40, 24), 4, H100)[0].launch
    x = convert.from_numpy(_x(3, np.float32, (40, 24)), "cpu")
    assert torch.equal(kern(x), x.T)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate((40, 24), device="cuda")


@pytest.mark.parametrize("config,match", [
    ({"bm": 16}, "both bm and bn"),
    ({"bm": 0, "bn": 8}, "empty"),
    ({"variant": "bogus"}, "unknown config"),
])
def test_transpose_rejects_bad_configs(config, match):
    with pytest.raises(ValueError, match=match):
        transpose(torch.zeros((16, 24)), config=config)


def test_wrappers_validate_their_operands():
    x = torch.zeros((16, 24))
    launch = LaunchConfig((8, 4, 2))
    with pytest.raises(TypeError):
        K.transpose_pointwise(x.numpy(), launch)
    with pytest.raises(TypeError, match="bytes"):
        K.transpose_pointwise(x.to(torch.complex128), launch)
    with pytest.raises(ValueError, match=r"\(M, N\)"):
        K.transpose_pointwise(x[None], launch)
    with pytest.raises(ValueError, match=r"\(M, N\)"):
        K.transpose_pointwise(x[:0], launch)
    with pytest.raises(ValueError, match="contiguous"):
        K.transpose_pointwise(x.T, launch)
    with pytest.raises(ValueError, match="valid CUDA block"):
        K.transpose_pointwise(x, LaunchConfig((64, 32, 1)))
    with pytest.raises(ValueError, match="valid CUDA block"):
        K.transpose_pointwise(x, LaunchConfig((1, 1, 128)))
    with pytest.raises(ValueError, match="grid limit"):
        K.transpose_pointwise(torch.zeros((1, 70_000)), LaunchConfig((1024, 1, 1)))
    with pytest.raises(ValueError, match="grid limit"):
        K.transpose_tiled(torch.zeros((70_000, 1)), 1, 8)
    with pytest.raises(ValueError, match="empty"):
        K.transpose_tiled(x, 8, 0)
    with pytest.raises(ValueError, match=r"\(M, N\)"):
        transpose(x[None])


# ---------------------------------------------------------------------------
# On the card: every CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", [(37, 70), (70, 37)])
def test_card_pointwise_matches_plain_at_every_launch(cuda, dtype, shape):
    x = torch.from_numpy(_x(0, np.float32, shape) * 40).to(cuda).to(dtype)
    want = transpose_ref(x)
    for launch in enumerate_gpu_configs():
        before = K.LAUNCHES["transpose_pointwise"]
        got = K.transpose_pointwise(x, launch)
        torch.cuda.synchronize()
        assert K.LAUNCHES["transpose_pointwise"] == before + 1
        assert K.LAST_LAUNCH["transpose_pointwise"] == launch
        assert torch.equal(got, want), launch


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16])
@pytest.mark.parametrize("shape", [(37, 70), (300, 129), (8, 1000)])
def test_card_tiled_matches_plain(cuda, dtype, shape):
    x = torch.from_numpy(_x(1, np.float32, shape)).to(cuda).to(dtype)
    want = transpose_ref(x)
    for bm, bn in ((8, 8), (32, 32), (16, 128), (128, 16), (512, 512), (3, 5)):
        before = K.LAUNCHES["transpose_tiled"]
        got = K.transpose_tiled(x, bm, bn)
        torch.cuda.synchronize()
        assert K.LAUNCHES["transpose_tiled"] == before + 1
        assert K.LAST_LAUNCH["transpose_tiled"] == (bm, bn)
        assert torch.equal(got, want), (bm, bn)


@pytest.mark.gpu
def test_card_entry_point_runs_the_ranked_launch(cuda):
    x = torch.from_numpy(_x(2, np.float32, (96, 160))).to(cuda)
    K.reset_launch_counts()
    got = transpose(x)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"transpose_pointwise": 1, "transpose_tiled": 0}
    best = rank_configs((96, 160), 4, H100)[0]
    assert K.LAST_LAUNCH["transpose_pointwise"] == best.launch
    assert torch.equal(got, x.T)
    kern, best = generate((96, 160), device=cuda)
    assert torch.equal(kern(x), x.T)
    with pytest.raises(ValueError):
        kern(x.cpu())
