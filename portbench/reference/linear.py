"""Dense products and the small layers the references share."""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def no_tf32() -> None:
    """Float32 products in float32: TF32 would round their inputs to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Weights:
    """State-dict tensors by name, handed out in float32 (TF32 off) and, for
    the ``fp8`` control, rounded to float8 per output channel."""

    def __init__(self, tensors: Mapping[str, torch.Tensor], precision: str = "f32",
                 device=None, keep: tuple = ()):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}: f32 or fp8")
        self.tensors = tensors
        self.precision = precision
        self.device = device
        # Names under these prefixes stay converted once fetched (the small
        # towers and the bridge); the LM's layers are converted at each use.
        self.keep = keep
        self._kept = {}

    def __call__(self, name: str) -> torch.Tensor:
        if name in self._kept:
            return self._kept[name]
        t = self.tensors[name]
        out = t.to(device=self.device or t.device, dtype=torch.float32)
        if name.startswith(self.keep) and self.keep:
            self._kept[name] = out
        return out

    def has(self, name: str) -> bool:
        return name in self.tensors

    def linear(self, x: torch.Tensor, prefix: str, bias: bool = True) -> torch.Tensor:
        """x @ W^T (+ b) for the nn.Linear stored under ``prefix``."""
        w = self(prefix + ".weight")
        b = self(prefix + ".bias") if bias and self.has(prefix + ".bias") else None
        return self.matmul(x, w, b)

    def matmul(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.float()
        if self.precision == "fp8":
            x, w = _fp8(x, -1), _fp8(w, -1)
        return F.linear(x, w, b)


def layer_norm(x: torch.Tensor, w: Weights, prefix: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], w(prefix + ".weight"), w(prefix + ".bias"),
                        eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * weight


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, scale: float = 1.0) -> torch.Tensor:
    """(..., Sq, E) x (..., Sk, E) -> (..., Sq, E); ``bias`` is added to the scores."""
    s = (q @ k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    return torch.softmax(s, dim=-1) @ v


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU, HF's ``gelu``."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
