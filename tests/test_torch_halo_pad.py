"""The entry points' zero halo (``repro_torch.kernels.halo_pad``).

On the CPU the wrapper returns ``F.pad``'s result, and its vector rule is
plain Python.  The ``gpu``-marked tests hold the CUDA kernel to ``F.pad``
bit for bit, at every store width, and skip without a card.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch.kernels import halo_pad as HP
from repro_torch.kernels.lbm_d3q15 import ops as lbm_ops
from repro_torch.kernels.stencil3d25 import ops as star_ops
from repro_torch.obs import metrics

F = torch.nn.functional
DTYPES = [torch.float32, torch.float64]


def _field(shape, dtype, device="cpu", seed=0):
    """Noise with a -0.0 and a NaN in it, so that a copy is checked bit for bit."""
    x = torch.randn(shape, dtype=torch.float64, generator=torch.Generator().manual_seed(seed))
    x = x.to(dtype)
    flat = x.view(-1)
    flat[0] = -0.0
    flat[flat.numel() // 2] = float("nan")
    return x.to(device)


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


# ---- on the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", [0, 1, 4, 5])
@pytest.mark.parametrize("shape", [(3, 5, 7), (15, 2, 3, 4), (2, 3, 4, 1, 6)])
def test_cpu_returns_f_pads_result(dtype, h, shape):
    x = _field(shape, dtype)
    got = HP.halo_pad(x, h)
    assert got.shape == (*shape[:-3], *(n + 2 * h for n in shape[-3:]))
    assert torch.equal(_bits(got), _bits(F.pad(x, (h,) * 6)))


@pytest.mark.parametrize("bad,h,err,match", [
    (torch.zeros((4, 6, 8)).transpose(0, 2), 1, ValueError, "contiguous"),
    (torch.zeros((4, 6, 8))[:, :, ::2], 1, ValueError, "contiguous"),
    (torch.zeros((4, 6, 8), dtype=torch.bfloat16), 1, TypeError, "float32 or float64"),
    (torch.zeros((4, 6), dtype=torch.float64), 1, ValueError, "non-empty"),
    (torch.zeros((0, 6, 8)), 1, ValueError, "non-empty"),
    (torch.zeros((4, 6, 8)), -1, ValueError, ">= 0"),
    ([[[1.0]]], 1, TypeError, "torch tensor"),
], ids=["transposed", "strided", "bf16", "2d", "empty", "negative-h", "list"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, h, err, match):
    """A non-contiguous field is refused on either device (the entry points
    pass ``.contiguous()``), as are other dtypes, fewer than three dims, an
    empty dim and a negative halo."""
    with pytest.raises(err, match=match):
        HP.halo_pad(bad, h)


@pytest.mark.parametrize("X,h,eb,dst_ptr,want", [
    (256, 1, 8, 0, 2),   # the LBM: 16 B stores
    (256, 1, 4, 0, 2),   # 258 fp32 a row: 8 B stores
    (640, 4, 8, 0, 2),   # the star: 16 B stores
    (16, 4, 4, 0, 4),
    (13, 1, 4, 0, 1),    # an odd padded row
    (640, 4, 4, 8, 2),   # an output 8 B off a 16 B address: 8 B stores
    (640, 4, 8, 8, 1),   # an output 8 B off: single stores
])
def test_pad_vector_is_the_widest_the_rows_and_addresses_take(X, h, eb, dst_ptr, want):
    assert HP.pad_vector(X, h, eb, dst_ptr) == want


def test_counter_group_is_registered_and_the_cpu_launches_nothing():
    described = metrics.describe()
    assert HP.LAUNCHES.name == "kernels.halo_pad.launches"
    assert set(HP.LAUNCHES) == {"halo_pad"}
    for field in HP.LAUNCHES:
        assert described[f"kernels.halo_pad.launches.{field}"].doc
    before = dict(HP.LAUNCHES)
    HP.halo_pad(torch.zeros((3, 4, 5)), 2)
    assert dict(HP.LAUNCHES) == before


def _counting(monkeypatch, module) -> list:
    calls, real = [], HP.halo_pad

    def counting(src, h):
        calls.append((tuple(src.shape), h))
        return real(src, h)

    monkeypatch.setattr(module, "halo_pad", counting)
    return calls


def test_entry_points_pad_through_halo_pad(monkeypatch):
    """``star_stencil`` pads its field by r, ``lbm_step`` its PDFs and its
    phase field by 1, each through ``halo_pad``; the kernels still get the
    padded fields under their own names."""
    calls = _counting(monkeypatch, star_ops)
    src = torch.rand((4, 6, 8), dtype=torch.float64)
    star_ops.star_stencil(src, r=2, config={"variant": "ring"})
    assert calls == [((4, 6, 8), 2)]
    calls = _counting(monkeypatch, lbm_ops)
    phase = torch.rand((3, 4, 4), dtype=torch.float64)
    lbm_ops.lbm_step(phase.expand(15, 3, 4, 4) / 15, phase, tau=1.2,
                     config={"variant": "ytile", "ty": 2})
    assert calls == [((15, 3, 4, 4), 1), ((3, 4, 4), 1)]


# ---- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _check_card(x, h):
    got = HP.halo_pad(x, h)
    torch.cuda.synchronize()
    want = F.pad(x, (h,) * 6)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want)), (tuple(x.shape), h, dict(HP.LAST_PAD))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", [1, 4, 5])
@pytest.mark.parametrize("lead", [(), (15,)], ids=["3d", "15-fields"])
@pytest.mark.parametrize("X", [32, 13], ids=["16-byte-rows", "odd-rows"])
def test_card_matches_f_pad_bit_for_bit(cuda, dtype, h, lead, X):
    x = _field((*lead, 5, 7, X), dtype, cuda)
    got = _check_card(x, h)
    vec = HP.pad_vector(X, h, x.element_size(), got.data_ptr())
    assert HP.LAST_PAD == {"h": h, "fields": lead[0] if lead else 1, "vector": vec}
    # an odd padded row stores single elements, every other one vectors
    assert (vec == 1) == (X == 13)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_pads_rows_wider_than_one_pass_and_unaligned_addresses(cuda, dtype):
    """Padded rows of more vectors than a warp loads in one pass, and a
    source and an output that sit off their vector's alignment."""
    _check_card(_field((2, 3, 5, 700), dtype, cuda, seed=2), 1)
    _check_card(_field((3, 4, 2100), dtype, cuda, seed=3), 4)
    base = _field((4 * 6 * 16 + 1,), dtype, cuda, seed=4)
    x = base[1:].view(4, 6, 16)              # one element off a 16-byte address
    _check_card(x, 4)
    # the loads take any source address; the output from torch.empty takes 16-byte stores
    assert HP.LAST_PAD["vector"] == 16 // x.element_size()


@pytest.mark.gpu
def test_card_counts_each_launch_and_refuses_a_strided_field(cuda):
    before = HP.LAUNCHES["halo_pad"]
    _check_card(_field((6, 8, 16), torch.float64, cuda), 4)
    _check_card(_field((6, 8, 16), torch.float64, cuda), 1)
    _check_card(_field((2, 6, 8, 16), torch.float32, cuda), 1)
    assert HP.LAUNCHES["halo_pad"] == before + 3
    assert HP.LAST_PAD == {"h": 1, "fields": 2, "vector": 2}
    with pytest.raises(ValueError, match="contiguous"):
        HP.halo_pad(_field((6, 8, 16), torch.float64, cuda).transpose(0, 2), 1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,h", [
    ((512, 512, 640), 4),
    ((15, 256, 256, 256), 1),
], ids=["star25", "lbm15"])
def test_card_pads_the_cells_fields(cuda, shape, h):
    x = torch.rand(shape, dtype=torch.float64, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(5))
    _check_card(x, h)
    assert HP.LAST_PAD["vector"] == 2


@pytest.mark.gpu
def test_card_entry_points_launch_the_pad_kernel(cuda):
    """A stencil step pads by one launch, an LBM step by two (the PDFs, then
    the phase field)."""
    src = torch.rand((6, 16, 32), dtype=torch.float64, device=cuda)
    before = HP.LAUNCHES["halo_pad"]
    star_ops.star_stencil(src, r=4, config={"variant": "ring"})
    assert HP.LAUNCHES["halo_pad"] == before + 1
    phase = torch.rand((4, 8, 8), dtype=torch.float64, device=cuda)
    lbm_ops.lbm_step(phase.expand(15, 4, 8, 8) / 15, phase, tau=1.2)
    assert HP.LAUNCHES["halo_pad"] == before + 3
    torch.cuda.synchronize()
