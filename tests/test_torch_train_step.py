"""The port's train step (``repro_torch.train.step``: ``xent``, ``loss_fn``,
``loss_and_grads``, ``make_train_step``) against ``repro.train.step`` on
the decoder-only attention archs, and its own properties (remat, the
in-place update).  The comparison and its tolerances are
``tests/torch_train_parity.py``'s (fp32: loss and gradient norm 1e-5
relative, each gradient leaf 1e-4 and each update 1e-3 relative L2, the
moments 1e-4; bf16 as its ``FP16`` says); the MoE archs are in
``test_torch_train_step_moe.py``, the recurrent and encoder archs in
``test_torch_train_step_ssm_enc.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

import torch_train_parity as tp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import batch_for_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train.step import loss_and_grads, loss_fn, xent  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCHS = ["granite-3-2b", "internvl2-76b", "phi3-mini-3.8b", "qwen1.5-110b", "qwen1.5-32b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_fp32(arch):
    tp.check(arch, "float32", 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_bf16(arch):
    tp.check(arch, "bfloat16", 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_train_step_matches_reference(arch):
    """``microbatches=2`` on both sides, fp32."""
    tp.check(arch, "float32", 2)


@pytest.mark.parametrize("shape", [(2, 5, 7), (3, 1, 640)])
def test_xent_matches_reference(shape):
    """``xent`` against the reference's one-hot form on random fp32 logits,
    every column counted (a padded vocab's too)."""
    import jax.numpy as jnp

    from repro.train.step import xent as jxent

    rng = np.random.default_rng(sum(shape))
    logits = rng.standard_normal(shape).astype(np.float32) * 3
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    want = float(jxent(jnp.asarray(logits), jnp.asarray(labels)))
    got = xent(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-6)
    lse = np.log(np.exp(logits.astype(np.float64)).sum(-1))
    plain = (lse - np.take_along_axis(logits, labels[..., None], -1)[..., 0]).mean()
    assert float(got) == pytest.approx(plain, rel=1e-6)


def test_loss_fn_scores_only_the_text_positions_of_a_vision_arch():
    """internvl2's patches come first in the logits; ``loss_fn`` scores the
    last S positions, as the reference's."""
    _, _, jp, p = _setup("internvl2-76b")
    cfg = dataclasses.replace(get_config("internvl2-76b").reduced(), param_dtype="float32")
    batch = batch_for_step(tp.data_config(cfg), 1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, _, _ = lm.forward(cfg, p, tb["tokens"], frontend_embeds=tb["frontend"])
        assert logits.shape[1] == tp.S + cfg.frontend_tokens
        want = xent(logits[:, cfg.frontend_tokens:], tb["labels"])
        got = loss_fn(cfg, p, tb)
    assert float(got) == float(want)


def _setup(arch):
    import jax

    from repro.configs import get_config as jget
    from repro.models.lm import init_params

    from repro_torch import convert

    jcfg = dataclasses.replace(jget(arch).reduced(), param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype="float32")
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")


def test_remat_gradients_equal_without_remat_bit_for_bit():
    """granite-3-2b with ``remat=True`` (each block under
    ``torch.utils.checkpoint``) gives the very gradients and loss of
    ``remat=False`` on the CPU, in one microbatch and in two."""
    _, cfg, _, p = _setup("granite-3-2b")
    batch = {k: torch.from_numpy(v)
             for k, v in batch_for_step(tp.data_config(cfg), 2).items()}
    for mb in (1, 2):
        runs = [loss_and_grads(dataclasses.replace(cfg, remat=r), p, batch, mb)
                for r in (False, True)]
        assert torch.equal(runs[0][0], runs[1][0])
        for a, b in zip(leaves(runs[0][1]), leaves(runs[1][1]), strict=True):
            assert torch.equal(a, b)


def test_loss_and_grads_reads_the_parameters_and_keeps_their_dtype():
    """One microbatch gives gradients in each parameter's dtype, two give
    fp32 sums; the parameters are left as they were."""
    _, cfg, _, p = _setup("granite-3-2b")
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    p = {k: v for k, v in lm.init_params(cfg, generator=torch.Generator().manual_seed(1),
                                         device="cpu").items()}
    before = [t.clone() for t in leaves(p)]
    batch = {k: torch.from_numpy(v) for k, v in batch_for_step(tp.data_config(cfg), 0).items()}
    _, g1 = loss_and_grads(cfg, p, batch)
    _, g2 = loss_and_grads(cfg, p, batch, microbatches=2)
    assert [t.dtype for t in leaves(g1)] == [t.dtype for t in leaves(p)]
    assert all(t.dtype == torch.float32 for t in leaves(g2))
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(p)))
    assert not any(t.requires_grad for t in leaves(p))
    with pytest.raises(ValueError, match="microbatches"):
        loss_and_grads(cfg, p, batch, microbatches=3)


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-base", "zamba2-2.7b"])
def test_unstacked_views_give_the_gradients_of_per_layer_selects(arch, monkeypatch):
    """``models.lm`` takes each stacked parameter's layer views by one
    ``unbind`` (``_unstack``), so its gradient is stacked once; a ``select``
    a layer (``_index``) gives the same loss and gradients bit for bit."""
    from repro_torch.train import ablate

    _, cfg, _, p = _setup(arch)
    batch = {k: torch.from_numpy(v)
             for k, v in batch_for_step(tp.data_config(cfg), 3).items()}
    built = loss_and_grads(cfg, p, batch)
    monkeypatch.setattr(lm, "_unstack", ablate._selects)
    selects = loss_and_grads(cfg, p, batch)
    assert torch.equal(built[0], selects[0])
    for a, b in zip(leaves(built[1]), leaves(selects[1]), strict=True):
        assert torch.equal(a, b)
