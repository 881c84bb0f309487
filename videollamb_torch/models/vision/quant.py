"""int8 inference path of the vision tower.

Port of ``videollamb_tpu/models/vision/quant.py``. Every dense kernel of the
CLIP-ViT encoder (spatial and temporal q/k/v/out projections, MLP fc1/fc2,
the patch embedding) becomes symmetric per-output-channel int8 with a bf16
scale, by the LM's quantiser (``models/lm/quant.quantize_kernel``). At
inference the activations are quantised per row (per token) on the fly, the
product is int8 x int8 -> int32, and the f32 dequantisation (row scale times
channel scale) joins the bias add.

The int32 product is a library call, as it is XLA's in the JAX package:
``torch._int_mm`` on the card (operands padded to its shape rules), an int32
``matmul`` on the CPU. LayerNorms, the temporal, class and position
embeddings stay in the tower's type.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.models.lm.quant import quantize_kernel
from videollamb_torch.ops.quantization import exact_div

_DENSE_LEAVES = ("q_proj", "k_proj", "v_proj", "out_proj")


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.

    ``torch._int_mm`` wants M > 16 and K, N multiples of 8 (the patch
    embedding has K = 588): the operands are padded with zeros up to that.
    """
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    m, k = a.shape
    n = b.shape[1]
    pad_m, pad_k, pad_n = max(0, 17 - m), (-k) % 8, (-n) % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def dense_int8(kernel: Mapping[str, torch.Tensor], x: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W + b with W int8 per output channel and x quantised per row;
    int32 accumulation, dequantisation and bias in f32, result in x's type."""
    xf = x.float()
    sx = exact_div(xf.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(1e-8)
    # In [-127, 127] after the clamp, so the plain cast is exact (and NaN-free
    # for finite x: sx has a floor).
    qx = torch.round(exact_div(xf, sx)).clamp(-127, 127).to(torch.int8)
    acc = int8_matmul(qx.reshape(-1, qx.shape[-1]), kernel["q"])
    acc = acc.reshape(*x.shape[:-1], acc.shape[-1])
    y = acc.float() * sx * kernel["scale"].float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


class Int8Dense(nn.Module):
    """A dense layer of the tower with an int8 kernel ``q`` (d_in, d_out), its
    ``scale`` (1, d_out) and an optional ``bias``; stands where an
    ``nn.Linear`` (or the patch embedding's weight holder) stood."""

    def __init__(self, kernel: Mapping[str, torch.Tensor], bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("q", kernel["q"])
        self.register_buffer("scale", kernel["scale"])
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.in_features, self.out_features = kernel["q"].shape

    @classmethod
    def empty(cls, d_in: int, d_out: int, bias: bool, dtype=torch.float32,
              device="cpu") -> "Int8Dense":
        """Uninitialised holder, for ``load_state_dict``."""
        return cls({"q": torch.empty((d_in, d_out), dtype=torch.int8, device=device),
                    "scale": torch.empty((1, d_out), dtype=torch.bfloat16, device=device)},
                   torch.empty((d_out,), dtype=dtype, device=device) if bias else None)

    @property
    def kernel(self):
        return {"q": self.q, "scale": self.scale}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_int8(self.kernel, x, self.bias)


def _quantize_dense(parent: nn.Module, name: str) -> None:
    module = getattr(parent, name)
    if isinstance(module, nn.Linear):
        with torch.no_grad():
            setattr(parent, name, Int8Dense(quantize_kernel(module.weight.t()),
                                            module.bias.detach()))


def _quantize_attn(attn: nn.Module) -> None:
    for name in _DENSE_LEAVES:
        _quantize_dense(attn, name)


def quantize_vision_params(tower: nn.Module, quantize_patch_embed: bool = True) -> nn.Module:
    """Quantise the tower's dense kernels to int8, in place.

    CONSUMES the tower layer by layer: each full-precision kernel is freed
    once its int8 replacement exists.
    """
    vm = tower.vision_model
    for layer in vm.encoder.layers:
        _quantize_attn(layer.self_attn)
        _quantize_dense(layer.mlp, "fc1")
        _quantize_dense(layer.mlp, "fc2")
        if hasattr(layer, "temporal_attn"):
            _quantize_attn(layer.temporal_attn)
    patch = vm.embeddings.patch_embedding
    if quantize_patch_embed and not isinstance(patch, Int8Dense):
        with torch.no_grad():
            kernel = patch.weight.reshape(patch.weight.shape[0], -1).t()  # (C*p*p, D)
            vm.embeddings.patch_embedding = Int8Dense(quantize_kernel(kernel))
    return tower
