"""Decision-space sweeps over parameterized kernel builders.

A generator of Triton kernels supplies one ``build(config)`` callback
returning a :class:`KernelBuild` (the kernel's launcher, placeholder args,
and cost annotations), and the frontend traces each configuration into its
spec mechanically, instead of a hand-written ``OperandSpec`` a point.

Configurations the tracer rejects yield ``(config, RejectedSpec(reason))``
pairs: the exploration engine's Pallas backend resolves those to
``report.skipped`` entries carrying the tracing diagnostic, so a non-affine
kernel shows up as an actionable skip reason in the ranking report instead
of an exception mid-sweep.

A copy of ``repro.frontend.candidates``; ``KernelBuild.call`` is a launcher
(the closure around ``kernel[grid](...)``), not a Pallas builder.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

from repro_torch.core.engine.protocol import RejectedSpec

from .lower import CostModel, lower_tpu
from .trace import TraceError, trace_kernel


@dataclass
class KernelBuild:
    """One configuration of a kernel builder, ready to trace."""

    call: Callable                    # the launcher to trace
    args: tuple                       # trace.arg placeholders, by position
    name: str = "kernel"
    costs: CostModel | None = None
    operand_names: tuple | None = None
    out_names: tuple | None = None
    trace_body: bool = False

    def trace(self):
        return trace_kernel(
            self.call, self.args, name=self.name,
            operand_names=self.operand_names, out_names=self.out_names,
            trace_body=self.trace_body)


def candidates(build: Callable, space: Iterable,
               skip_build_errors: tuple = (ValueError,)) -> Iterator[tuple]:
    """Yield ``(config, PallasKernelSpec | RejectedSpec)`` for each config.

    ``build(config)`` returns a :class:`KernelBuild` (or ``None`` to drop a
    configuration silently, e.g. a non-dividing tile).  Builder exceptions
    in ``skip_build_errors`` and tracer rejections become ``RejectedSpec``
    entries instead of aborting the sweep.
    """
    for config in space:
        try:
            kb = build(config)
        except skip_build_errors as e:
            yield config, RejectedSpec(str(config), f"build failed: {e}")
            continue
        if kb is None:
            continue
        try:
            traced = kb.trace()
            spec = lower_tpu(traced, kb.costs, name=kb.name)
        except TraceError as e:
            yield config, RejectedSpec(kb.name, str(e))
            continue
        yield config, spec


def grid_space(**axes) -> Iterator[dict]:
    """Cartesian decision space: ``grid_space(bm=[128, 256], bn=[128])``
    yields config dicts in row-major order with the given key order."""
    keys = list(axes)
    vals = [list(axes[k]) for k in keys]

    def rec(i, acc):
        if i == len(keys):
            yield dict(acc)
            return
        for v in vals[i]:
            acc.append((keys[i], v))
            yield from rec(i + 1, acc)
            acc.pop()

    yield from rec(0, [])
