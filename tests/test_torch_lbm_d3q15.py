"""The port's D3Q15 LBM step against the JAX package's Pallas kernels.

The same numpy inputs (the phase field ``sigmoid(randn)`` and PDFs
``w_q * phase``, the state of tests/test_kernels.py) go through ``repro``'s
Pallas kernels (interpret mode, pinned variants, as tests/test_kernels.py
runs them) and through ``repro_torch`` (``convert.from_numpy``).  On the CPU
the port's wrappers run their plain versions; the CUDA kernels themselves are
compared with those plain versions by the ``gpu``-marked tests, which skip
without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.core.access import LaunchConfig
from repro_torch.core.machines import H100
from repro_torch.core.selector import enumerate_gpu_configs
from repro_torch.kernels import SCRATCH_REASON, get_generator
from repro_torch.kernels.lbm_d3q15 import kernel as K
from repro_torch.kernels.lbm_d3q15.generator import generate, rank_configs, ytile_space
from repro_torch.kernels.lbm_d3q15.ops import lbm_step
from repro_torch.kernels.lbm_d3q15.ref import VELOCITIES, WEIGHTS, lbm_step_ref, pad_inputs

DOMAINS = [(3, 8, 16), (4, 16, 8)]
TOL = {np.float32: 2e-5, np.float64: 1e-12}  # the reference's own fp32 tolerance


def _state(seed, dtype, shape):
    """(pdf (15, Z, Y, X), phase (Z, Y, X)) as numpy: phase = sigmoid(randn),
    pdf[q] = w_q * phase."""
    phase = 1.0 / (1.0 + np.exp(-np.random.default_rng(seed).standard_normal(shape)))
    pdf = np.stack([w * phase for w in WEIGHTS])
    return pdf.astype(dtype), phase.astype(dtype)


def _jax_kernel(pdf_np, phase_np, variant, ty):
    """The JAX package's Pallas kernel, in interpret mode, at a pinned variant
    (padded as ``repro.kernels.lbm_d3q15.ops`` pads it)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.lbm_d3q15.kernel import make_kernel
    from repro.kernels.lbm_d3q15.ref import pad_inputs as jpad

    with jax.enable_x64(pdf_np.dtype == np.float64):
        pdf_p, ph_p = jpad(jnp.asarray(pdf_np), jnp.asarray(phase_np))
        _q, Z, Y, X = pdf_np.shape
        if variant == "ytile":
            extra = (Y // ty + 1) * ty - (Y + 2)
            pdf_p = jnp.pad(pdf_p, ((0, 0), (0, 0), (0, extra), (0, 0)))
            ph_p = jnp.pad(ph_p, ((0, 0), (0, extra), (0, 0)))
        return np.asarray(make_kernel(variant, (Z, Y, X), ty, dtype=pdf_p.dtype)(pdf_p, ph_p))


def _jax_lbm_step(pdf_np, phase_np):
    """The JAX package's entry point at its per-plane kernel (``config=None``
    would reach the reference's tracer, which is broken on this jax)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.lbm_d3q15.ops import lbm_step as jlbm_step

    with jax.enable_x64(pdf_np.dtype == np.float64):
        new_pdf, phase = jlbm_step(jnp.asarray(pdf_np), jnp.asarray(phase_np),
                                   config={"variant": "replane"})
        return np.asarray(new_pdf), np.asarray(phase)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("variant,ty", [("replane", None), ("ytile", 4)])
@pytest.mark.parametrize("dom", DOMAINS)
def test_plain_version_matches_pallas_kernel(dom, variant, ty, dtype):
    pdf_np, phase_np = _state(0, dtype, dom)
    want = _jax_kernel(pdf_np, phase_np, variant, ty)
    pdf, phase = convert.from_numpy((pdf_np, phase_np), "cpu")
    got, got_phase = lbm_step_ref(*pad_inputs(pdf, phase))
    assert got.dtype == pdf.dtype and got.shape == (15, *dom)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(got_phase.numpy(), want.sum(0), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("config", [
    None, {"variant": "replane"}, {"block": (8, 4, 2), "folding": (1, 2, 1)},
    {"block": (16, 1, 4), "folding": (1, 1, 2)}, {"variant": "ytile", "ty": 4},
    {"variant": "ytile"}])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lbm_step_end_to_end_matches_reference(config, dtype):
    dom = DOMAINS[1]
    pdf_np, phase_np = _state(7, dtype, dom)
    want_pdf, want_phase = _jax_lbm_step(pdf_np, phase_np)
    pdf, phase = convert.from_numpy((pdf_np, phase_np), "cpu")
    got_pdf, got_phase = lbm_step(pdf, phase, config=config)
    assert got_pdf.shape == (15, *dom) and got_phase.shape == dom
    assert got_pdf.device.type == "cpu"
    np.testing.assert_allclose(got_pdf.numpy(), want_pdf, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(got_phase.numpy(), want_phase, rtol=0, atol=TOL[dtype])


def test_tau_and_kappa_reach_the_step():
    pdf_np, phase_np = _state(5, np.float64, DOMAINS[0])
    pdf, phase = convert.from_numpy((pdf_np, phase_np), "cpu")
    got, _ = lbm_step(pdf, phase, tau=0.6, kappa=0.3, config={"variant": "ytile", "ty": 4})
    want, _ = lbm_step_ref(*pad_inputs(pdf, phase), tau=0.6, kappa=0.3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, lbm_step(pdf, phase)[0])


def test_velocities_and_weights_equal_reference():
    from repro.kernels.lbm_d3q15 import ref

    from repro_torch.core.specs import D3Q15_VELOCITIES

    assert VELOCITIES is D3Q15_VELOCITIES
    assert VELOCITIES == ref.VELOCITIES
    assert WEIGHTS == ref.WEIGHTS
    assert abs(sum(WEIGHTS) - 1.0) < 1e-15


def test_generator_ranks_every_launch_and_skips_the_ytile_variants():
    from repro.kernels.lbm_d3q15.generator import _space

    dom = (4, 32, 8)
    ranked = rank_configs(dom, 8, H100)
    assert len(ranked) == 168
    want = [cfg for cfg in _space(dom) if cfg["variant"] == "ytile"]
    assert [s.config for s in ranked.skipped] == want == [
        {"variant": "ytile", "ty": 8}, {"variant": "ytile", "ty": 16}]
    assert all(s.reason == SCRATCH_REASON for s in ranked.skipped)
    assert list(ytile_space((4, 12, 8))) == [] and list(ytile_space((4, 24, 8))) == [
        {"variant": "ytile", "ty": 8}]
    ranked.clear()  # callers get a copy; the memoized ranking is untouched
    assert len(rank_configs(dom, 8, H100)) == 168
    assert get_generator("lbm_d3q15").rank_configs is rank_configs


def test_generate_returns_the_best_launch():
    dom = DOMAINS[1]
    kern, best = generate(dom, dtype=torch.float64, device="cpu")
    assert best.launch == rank_configs(dom, 8, H100)[0].launch
    pdf, phase = convert.from_numpy(_state(3, np.float64, dom), "cpu")
    padded = pad_inputs(pdf, phase)
    torch.testing.assert_close(kern(*padded), lbm_step_ref(*padded)[0], rtol=0, atol=0)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(DOMAINS[0], device="cuda")


@pytest.mark.parametrize("config,match", [
    ({"variant": "ytile", "ty": 5}, "ty must divide Y"),
    ({"variant": "ytile", "ty": 1}, "ty must divide Y"),
    ({"variant": "bogus"}, "unknown variant"),
])
def test_lbm_step_rejects_bad_configs(config, match):
    pdf, phase = torch.zeros((15, *DOMAINS[1])), torch.zeros(DOMAINS[1])
    with pytest.raises(ValueError, match=match):
        lbm_step(pdf, phase, config=config)


def test_lbm_step_rejects_mismatched_fields():
    with pytest.raises(ValueError, match="expected pdf"):
        lbm_step(torch.zeros((14, 4, 16, 8)), torch.zeros((4, 16, 8)))
    with pytest.raises(ValueError, match="expected pdf"):
        lbm_step(torch.zeros((15, 4, 16, 8)), torch.zeros((4, 16, 9)))


def test_wrappers_validate_their_operands():
    pdf_p, ph_p = pad_inputs(torch.zeros((15, *DOMAINS[1]), dtype=torch.float64),
                             torch.zeros(DOMAINS[1], dtype=torch.float64))
    launch = LaunchConfig((8, 4, 2))
    with pytest.raises(TypeError):
        K.lbm_pointwise(pdf_p.to(torch.int32), ph_p.to(torch.int32), launch)
    with pytest.raises(TypeError):
        K.lbm_pointwise(pdf_p.numpy(), ph_p, launch)
    with pytest.raises(ValueError, match="dtype and device"):
        K.lbm_pointwise(pdf_p, ph_p.float(), launch)
    with pytest.raises(ValueError, match="expected PDFs"):
        K.lbm_pointwise(pdf_p[:14], ph_p, launch)
    with pytest.raises(ValueError, match="expected PDFs"):
        K.lbm_pointwise(pdf_p, ph_p[:, :-1], launch)
    with pytest.raises(ValueError, match="contiguous"):
        K.lbm_pointwise(pdf_p.transpose(2, 3), ph_p.transpose(1, 2), launch)
    with pytest.raises(ValueError, match="halo"):
        K.lbm_pointwise(pdf_p[:, :2].contiguous(), ph_p[:2], launch)
    with pytest.raises(ValueError, match="valid CUDA block"):
        K.lbm_pointwise(pdf_p, ph_p, LaunchConfig((64, 32, 1)))
    with pytest.raises(ValueError, match="valid CUDA block"):
        K.lbm_pointwise(pdf_p, ph_p, LaunchConfig((1, 1, 128)))
    with pytest.raises(ValueError, match="empty"):
        K.lbm_ytile(pdf_p, ph_p, 0, 32)
    with pytest.raises(ValueError, match="shared memory"):
        K.lbm_ytile(pdf_p, ph_p, 64, 256)


def test_ytile_tiles_respect_shared_memory():
    assert K.ytile_tile(8, 8) == (8, 256)
    assert K.ytile_smem_bytes(8, 256, 8) == 61_920
    assert K.ytile_tile(16, 8) == (16, 256)
    assert K.ytile_smem_bytes(16, 256, 8) == 111_456
    assert K.ytile_tile(64, 8) == (64, 128)
    assert K.ytile_tile(128, 8) == (128, 64)
    assert K.ytile_tile(64, 4) == (64, 256)
    for ty in (2, 4, 8, 16, 32, 64, 128, 256, 512):
        for eb in (4, 8):
            _, tx = K.ytile_tile(ty, eb)
            assert K.ytile_smem_bytes(ty, tx, eb) <= K.SMEM_PER_BLOCK == 232_448
            assert tx == K.YTILE_TX[0] or K.ytile_smem_bytes(ty, 2 * tx, eb) > K.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        K.ytile_tile(10_000, 8)


@pytest.mark.parametrize("domain,ty,tx,zs", [
    ((256, 256, 256), 8, 256, 15), ((256, 256, 256), 16, 256, 7),
    ((61, 120, 251), 8, 256, 1), ((3, 8, 16), 4, 256, 1), ((256, 2048, 2048), 8, 256, 256)])
def test_ytile_slabs_fill_the_card(domain, ty, tx, zs):
    Z, Y, X = domain
    sms = 132  # the H100 SXM's
    assert K.ytile_slab(domain, ty, tx, sms) == zs
    tiles = -(-Y // ty) * -(-X // tx)
    slabs = -(-Z // zs)
    assert tiles * slabs >= K.YTILE_CTAS_PER_SM * sms or slabs == Z
    assert (slabs - 1) * zs < Z <= slabs * zs


def test_ytile_slabs_follow_the_sm_count():
    # half the SMs need half the CTAs: the slabs deepen
    assert K.ytile_slab((256, 256, 256), 8, 256, 66) == 28
    assert K.ytile_slab((256, 256, 256), 8, 256, 264) == 7


# ---------------------------------------------------------------------------
# On the card: every CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_case(cuda, dtype, shape, seed=0):
    """Padded fields with independent random PDFs (so that a pull from the
    wrong cell shows) and the plain version's new PDFs."""
    rng = np.random.default_rng(seed)
    phase = torch.from_numpy(1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).to(cuda, dtype)
    pdf = torch.from_numpy(rng.random((15, *shape))).to(cuda, dtype)
    pdf_p, phase_p = pad_inputs(pdf, phase)
    return pdf, phase, pdf_p, phase_p, lbm_step_ref(pdf_p, phase_p)[0]


GPU_TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12), torch.float32: dict(rtol=1e-5, atol=1e-5)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(13, 37, 70), (16, 32, 64)])
def test_card_pointwise_matches_plain_at_every_launch(cuda, dtype, shape):
    _, _, pdf_p, phase_p, want = _card_case(cuda, dtype, shape)
    for launch in enumerate_gpu_configs():
        before = K.LAUNCHES["lbm_pointwise"]
        got = K.lbm_pointwise(pdf_p, phase_p, launch)
        torch.cuda.synchronize()
        assert K.LAUNCHES["lbm_pointwise"] == before + 1
        assert K.LAST_LAUNCH["lbm_pointwise"] == launch
        torch.testing.assert_close(got, want, **GPU_TOL[dtype], msg=str(launch))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(13, 37, 70), (9, 48, 40), (40, 16, 300)])
def test_card_ytile_matches_plain(cuda, dtype, shape):
    _, _, pdf_p, phase_p, want = _card_case(cuda, dtype, shape)
    eb = torch.empty((), dtype=dtype).element_size()
    for tile in {K.ytile_tile(8, eb), K.ytile_tile(16, eb), K.ytile_tile(64, eb), (3, 5)}:
        before = K.LAUNCHES["lbm_ytile"]
        got = K.lbm_ytile(pdf_p, phase_p, *tile, tau=0.7, kappa=0.2)
        torch.cuda.synchronize()
        assert K.LAUNCHES["lbm_ytile"] == before + 1
        want_t = lbm_step_ref(pdf_p, phase_p, 0.7, 0.2)[0]
        torch.testing.assert_close(got, want_t, **GPU_TOL[dtype], msg=str(tile))


@pytest.mark.gpu
def test_card_entry_point_runs_the_ranked_launch(cuda):
    pdf, phase, pdf_p, phase_p, want = _card_case(cuda, torch.float64, (16, 32, 64))
    K.reset_launch_counts()
    got, got_phase = lbm_step(pdf, phase)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"lbm_pointwise": 1, "lbm_ytile": 0}
    best = rank_configs((16, 32, 64), 8, H100)[0]
    assert K.LAST_LAUNCH["lbm_pointwise"] == best.launch
    torch.testing.assert_close(got, want, **GPU_TOL[torch.float64])
    torch.testing.assert_close(got_phase, want.sum(0), **GPU_TOL[torch.float64])
    kern, best = generate((16, 32, 64), device=cuda)
    torch.testing.assert_close(kern(pdf_p, phase_p), want, **GPU_TOL[torch.float64])
    with pytest.raises(ValueError):
        kern(pdf_p.cpu(), phase_p.cpu())
