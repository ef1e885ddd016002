"""The port's train step against ``repro.train.step`` on the recurrent
archs (rwkv6-1.6b, zamba2-2.7b with its shared attention) and the
encoder-decoder (whisper-base over its frames): fp32 and bf16, one
microbatch and two.  The comparison and its tolerances are
``tests/torch_train_parity.py``'s.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

import torch_train_parity as tp  # noqa: E402

ARCHS = ["rwkv6-1.6b", "whisper-base", "zamba2-2.7b"]
# fp32 at 6 Mamba2 layers a group: the gradients' growth through the group
# carries the two frameworks' sum orders with it (a CPU run reads the norm
# within 1.3e-5, a leaf within 6.6e-5); the bounds are about 8 and 15 times
DEEP_FP32 = {"grad_norm": 1e-4, "grads": 1e-3}


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


def test_deep_hybrid_gradients_match_reference_in_fp32_and_stay_near_in_bf16():
    """zamba2-2.7b at 6 Mamba2 layers a group (its own ``hybrid_attn_every``),
    width 128: its gradients grow backward through the group at init (each
    layer's about twice the next one's), and bf16's roundings grow with
    them.  The port's fp32 gradients equal the reference's (``DEEP_FP32``),
    and its bf16 gradient norm stays within 0.5
    of its fp32 one, the bound ``chip_smoke.py`` holds zamba2-2.7b whole to
    (``TRAIN_T4``)."""
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config as jget
    from repro.models.lm import init_params
    from repro.train.step import loss_fn as jloss_fn

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import leaves

    deep = dict(n_layers=6, hybrid_attn_every=6)
    norms = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jget("zamba2-2.7b").reduced(), param_dtype=dtype, **deep)
        cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(), param_dtype=dtype, **deep)
        jp = init_params(jcfg, jax.random.PRNGKey(0))
        batch = batch_for_step(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2), 0)
        p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
        _, g = loss_and_grads(cfg, p, {k: torch.from_numpy(v) for k, v in batch.items()})
        got = [t.float().numpy() for t in leaves(g)]
        norms[dtype] = float(np.sqrt(sum(np.square(x, dtype=np.float64).sum() for x in got)))
        if dtype == "float32":
            _, jg = jax.jit(jax.value_and_grad(functools.partial(jloss_fn, jcfg)))(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})
            want = [np.asarray(x, np.float32) for x in jax.tree.leaves(jg)]
            wnorm = float(np.sqrt(sum(np.square(x, dtype=np.float64).sum() for x in want)))
            assert tp.rel(norms[dtype], wnorm) <= DEEP_FP32["grad_norm"]
            err, path = tp.worst(got, want, [str(i) for i in range(len(got))])
            assert err <= DEEP_FP32["grads"], (path, err)
    assert tp.rel(norms["bfloat16"], norms["float32"]) <= 0.5, norms
