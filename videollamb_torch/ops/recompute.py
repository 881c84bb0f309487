"""Kernel forward, plain-recompute backward: the port's ``custom_vjp`` rule.

The JAX package differentiates through its attention kernels with
``jax.custom_vjp`` rules whose forward calls the Pallas kernel and whose
backward takes the VJP of the plain XLA statement, recomputed from the
saved inputs (``_sc_bwd``, ``_scp_bwd``, ``_ta_bwd``, ``_ta_fm_bwd``). The
TPU has no backward kernel, and neither does the port.

:func:`kernel_forward` is that rule as one ``torch.autograd.Function``: its
forward runs ``kernel(*inputs)`` (the CUDA kernel on a CUDA tensor, the
plain version on a CPU tensor), its backward runs ``plain(*inputs)`` again
under ``torch.enable_grad()`` and returns its VJP. No kernel launches in
the backward.
"""

from __future__ import annotations

from typing import Callable

import torch


class _KernelForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, *inputs: torch.Tensor) -> torch.Tensor:
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*leaves)
            grads = iter(torch.autograd.grad(out, [x for x, n in zip(leaves, needs) if n], grad))
        return (None, None, *(next(grads) if n else None for n in needs))


def kernel_forward(kernel: Callable, plain: Callable, *inputs: torch.Tensor) -> torch.Tensor:
    """``kernel(*inputs)``, differentiable through the VJP of ``plain(*inputs)``."""
    return _KernelForward.apply(kernel, plain, *inputs)
