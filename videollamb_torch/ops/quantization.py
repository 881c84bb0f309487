"""int8 KV quantization helpers of the paged pools.

The port's own copy of the three helpers the JAX package takes from
``jax.experimental.pallas.ops.tpu.paged_attention.quantization_utils``:
absmax scales over the last axis and ``x ~ i8 * scale / 127.5``.

Every float -> int8 conversion of the port goes through :func:`round_to_int8`,
which rounds half to even and then SATURATES to [-128, 127]. The row's
absmax element lands on exactly +-127.5, which rounds to +-128: JAX's
``astype(int8)`` saturates +128 to 127, but ``Tensor.to(torch.int8)``
wraps it to -128 and flips the sign of that element. NaN (an all-zero row
has scale 0, so 0 * (127.5 / 0)) converts to 0, as XLA does.

Divisions that feed a requantisation go through :func:`exact_div`: torch
computes ``float / tensor`` (and, on CUDA, ``tensor / float``) as a product
with a reciprocal, which rounds differently from XLA's division and can move
a rint by one step.
"""

from __future__ import annotations

import torch

MAX_INT8 = 127.5


def exact_div(a, b) -> torch.Tensor:
    """IEEE ``a / b`` where either side may be a Python float."""
    if not torch.is_tensor(a):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    if not torch.is_tensor(b):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b


def round_to_int8(x: torch.Tensor) -> torch.Tensor:
    """rint (half to even), saturate to [-128, 127], NaN -> 0; returns int8."""
    return torch.nan_to_num(torch.round(x), nan=0.0).clamp(-128, 127).to(torch.int8)


def get_quantization_scales(x: torch.Tensor) -> torch.Tensor:
    """Absmax over the last axis, kept as a size-1 axis."""
    return x.abs().amax(dim=-1, keepdim=True)


def to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return round_to_int8(x * exact_div(MAX_INT8, scale))


def from_int8(x: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return exact_div(x.to(dtype) * scale, MAX_INT8)
