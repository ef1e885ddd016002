"""The port's train step against ``repro.train.step`` on the MoE archs
(mixtral-8x7b, arctic-480b), in fp32 only: in bf16 a near-tie in the router
can send a token to another expert on one side (their routing is held
equal at layer level by ``tests/test_torch_layers.py``).  One microbatch
and two; the comparison and its tolerances are
``tests/torch_train_parity.py``'s.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

import torch_train_parity as tp  # noqa: E402

ARCHS = sorted(tp.MOE_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_fp32(arch):
    tp.check(arch, "float32", 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_train_step_matches_reference(arch):
    """``microbatches=2`` on both sides: each slice's MoE call keeps its own
    capacity, as the reference's scan does."""
    tp.check(arch, "float32", 2)
