"""Shape-only stand-ins of the kernels for tensors on the meta device, for
the dry run.

The dry run (``launch.dryrun.count_collectives``) runs a full-width step on
the meta device, where nothing is computed, to record the collectives the
sharded step calls. Inside ``shapes_only()`` a kernel wrapper given meta
tensors returns ``outputs``: meta tensors of its outputs' shapes and
dtypes that carry autograd back to its inputs as meta gradients of their
shapes, and the xLSTM scan runs one step. No kernel and no plain version
runs, and no launch is counted. Outside the scope meta tensors are what
they always were to a wrapper: neither the CPU nor a card, so it raises.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch

# the open scopes: one count for the process, not a thread-local, because
# the autograd engine may run a backward and remat's recomputation on
# threads of its own
_SCOPES = [0]


@contextlib.contextmanager
def shapes_only():
    """Within the block, kernel wrappers answer meta tensors with shapes."""
    _SCOPES[0] += 1
    try:
        yield
    finally:
        _SCOPES[0] -= 1


def active(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the meta device inside ``shapes_only()``."""
    return t.device.type == "meta" and _SCOPES[0] > 0


class _Shapes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, specs, *inputs):
        ctx.inputs = [(t.shape, t.dtype) for t in inputs]
        return tuple(torch.empty(s, dtype=d, device="meta") for s, d in specs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(torch.empty(s, dtype=d, device="meta")
                        for s, d in ctx.inputs))


def outputs(inputs: Sequence[torch.Tensor],
            specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]]):
    """Meta tensors of ``specs`` ((shape, dtype) each), differentiable
    with respect to ``inputs`` when autograd is on."""
    return _Shapes.apply(tuple(specs), *inputs)
