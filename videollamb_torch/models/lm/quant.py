"""Weight-only int8 and int4 quantisation of the LM.

Port of ``videollamb_tpu/models/lm/quant.py``. A quantised kernel is a
dictionary in the JAX package's (d_in, d_out) orientation:

- int8, ``{"q": int8 (d_in, d_out), "scale": bf16 (1, d_out)}``: symmetric,
  one scale per output channel, values clipped to +-127;
- int4, ``{"q4": uint8 (d_in/2, d_out), "scale": bf16 (d_in/g, d_out)}``:
  symmetric, one scale per group of g input rows and output channel
  (``ops/int4_matmul.py``).

:class:`QuantLinear` holds such a kernel where an ``nn.Linear`` stood and
dispatches a product as the JAX package's ``_proj`` does. The
``quantize_llama_params*`` functions replace the LM's seven projections per
layer and ``lm_head`` in place, freeing each full-precision weight as soon as
its replacement exists, so that quantising needs the model plus one weight.

NF4 (bitsandbytes 4-bit) tensors are decoded on load to dense weights, which
:func:`quantize_kernel_int4` then requantises for the kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from videollamb_torch.ops.int4_matmul import (
    MAX_KERNEL_M,
    dequantize_int4,
    int4_matmul,
    quantize_int4,
)
from videollamb_torch.ops.quantization import exact_div, round_to_int8

QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")

Kernel = Dict[str, torch.Tensor]


def _quantize_2d(w: torch.Tensor) -> Kernel:
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = exact_div(amax, 127.0).clamp_min(1e-8)
    q = round_to_int8(torch.round(exact_div(wf, scale)).clamp(-127, 127))
    return {"q": q.contiguous(), "scale": scale.to(torch.bfloat16)}


def _per_layer(fn, w: torch.Tensor) -> Kernel:
    """``fn`` on each (d_in, d_out) slice of a stacked (L, d_in, d_out) kernel,
    so the f32 scratch is one layer's."""
    parts = [fn(layer) for layer in w]
    return {key: torch.stack([p[key] for p in parts]) for key in parts[0]}


def quantize_kernel(w: torch.Tensor) -> Kernel:
    """(..., d_in, d_out) -> int8 values and per-output-channel bf16 scales."""
    return _per_layer(_quantize_2d, w) if w.ndim == 3 else _quantize_2d(w)


def dequantize_kernel(qk: Mapping[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """int8 kernel -> dense weight; the product is taken in ``dtype``."""
    return qk["q"].to(dtype) * qk["scale"].to(dtype)


def is_quantized(kernel: Any) -> bool:
    if isinstance(kernel, QuantLinear):
        return kernel.kind == "int8"
    return isinstance(kernel, Mapping) and "q" in kernel and "scale" in kernel


def quantize_kernel_int4(w: torch.Tensor, group: int = 128) -> Kernel:
    """(d_in, d_out) or stacked (L, d_in, d_out) -> packed int4 kernels."""
    if w.ndim == 3:
        return _per_layer(lambda x: quantize_int4(x, group), w)
    return quantize_int4(w, group)


def is_int4(kernel: Any) -> bool:
    if isinstance(kernel, QuantLinear):
        return kernel.kind == "int4"
    return isinstance(kernel, Mapping) and "q4" in kernel


def project(kernel: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x (..., d_in) @ kernel`` for a quantised kernel, in x's type.

    int4 with at most 64 rows on the card goes through kernel K7
    (``ops/int4_matmul.int4_matmul``); int4 with more rows, and int4 on the
    CPU, is dequantised to x's type and multiplied by the library, as XLA
    does in the JAX package. int8 is dequantised in x's type
    (``q.to(dtype) * scale.to(dtype)``, one rounding in bf16) and multiplied.
    """
    if "q4" in kernel:
        lead = x.shape[:-1]
        m = x.numel() // x.shape[-1]
        if x.device.type == "cuda" and m <= MAX_KERNEL_M:
            y = int4_matmul(x.reshape(m, x.shape[-1]), kernel["q4"], kernel["scale"])
            return y.reshape(*lead, y.shape[-1])
        weight = dequantize_int4(kernel, x.dtype)
    else:
        weight = dequantize_kernel(kernel, x.dtype)
    return torch.matmul(x, weight)


class QuantLinear(nn.Module):
    """A bias-free projection holding an int8 or int4 kernel as buffers
    (``q`` or ``q4``, and ``scale``); stands where an ``nn.Linear`` stood."""

    def __init__(self, kernel: Mapping[str, torch.Tensor]):
        super().__init__()
        self.kind = "int4" if "q4" in kernel else "int8"
        values = kernel["q4" if self.kind == "int4" else "q"]
        self.register_buffer("q4" if self.kind == "int4" else "q", values)
        self.register_buffer("scale", kernel["scale"])
        self.in_features = values.shape[0] * (2 if self.kind == "int4" else 1)
        self.out_features = values.shape[1]

    @classmethod
    def empty(cls, values_key: str, values_shape, scale_shape, device="cpu") -> "QuantLinear":
        """Uninitialised holder of the given buffer shapes, for ``load_state_dict``."""
        dtype = torch.uint8 if values_key == "q4" else torch.int8
        return cls({values_key: torch.empty(tuple(values_shape), dtype=dtype, device=device),
                    "scale": torch.empty(tuple(scale_shape), dtype=torch.bfloat16,
                                         device=device)})

    @property
    def kernel(self) -> Kernel:
        key = "q4" if self.kind == "int4" else "q"
        return {key: getattr(self, key), "scale": self.scale}

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.kernel.values())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return project(self.kernel, x)

    def extra_repr(self) -> str:
        return f"{self.in_features}, {self.out_features}, {self.kind}"


def _replace_linears(lm: nn.Module, targets, quantize) -> nn.Module:
    """Swap the plain target projections of every layer, then ``lm_head``, for
    :class:`QuantLinear`; each full-precision weight is freed as it is replaced."""
    owners = []
    for layer in lm.model.layers:
        for parent in (layer.self_attn, layer.mlp):
            owners += [(parent, name) for name in targets if hasattr(parent, name)]
    owners.append((lm, "lm_head"))
    for parent, name in owners:
        module = getattr(parent, name)
        if hasattr(module, "lora_a"):  # adapters ride a quantised base
            parent, name, module = module, "base", module.base
        if isinstance(module, nn.Linear):
            with torch.no_grad():
                setattr(parent, name, QuantLinear(quantize(module.weight.t())))
            del module
    return lm


def quantize_llama_params(lm: nn.Module, targets=QUANT_TARGETS) -> nn.Module:
    """int8 weights for the layers' projections and ``lm_head``, in place.

    CONSUMES the model: peak memory is the model plus one weight's f32
    scratch. The embedding table stays in full precision (it is gathered,
    not multiplied).
    """
    return _replace_linears(lm, targets, quantize_kernel)


def quantize_llama_params_int4(lm: nn.Module, targets=QUANT_TARGETS,
                               group: int = 128) -> nn.Module:
    """int4 variant of :func:`quantize_llama_params` (same consuming discipline)."""
    return _replace_linears(lm, targets, lambda w: quantize_kernel_int4(w, group))


def linear_weight_bytes(lm: nn.Module) -> int:
    """Bytes of the projections' weights (plain or quantised) and of ``lm_head``."""
    total = 0
    for module in lm.modules():
        if isinstance(module, QuantLinear):
            total += module.nbytes()
        elif isinstance(module, nn.Linear):
            total += module.weight.numel() * module.weight.element_size()
    return total


# bitsandbytes NF4 codebook (public constant): the 16 quantile points of a
# standard normal, normalised to [-1, 1].
NF4_CODE = torch.tensor([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], dtype=torch.float32)


def dequantize_nf4(packed, absmax, shape, blocksize: int = 64,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Decode a bitsandbytes NF4 tensor to a dense weight.

    packed: (numel//2,) uint8, two codes per byte, high nibble first;
    absmax: (numel//blocksize,) per-block scales; shape: the original
    (d_out, d_in) shape, row-major. Returns the weight as (d_in, d_out),
    ready for :func:`quantize_kernel_int4`.
    """
    p = torch.as_tensor(np.asarray(packed, dtype=np.uint8)).to(torch.int32)
    codes = torch.stack([(p >> 4) & 0xF, p & 0xF], dim=-1).reshape(-1)
    vals = NF4_CODE[codes.long()]
    scales = torch.as_tensor(np.asarray(absmax, dtype=np.float32))
    scales = scales.repeat_interleave(blocksize)[: vals.numel()]
    w = (vals * scales).reshape(tuple(shape))  # (d_out, d_in)
    return w.t().contiguous().to(dtype)


def load_nf4_state_dict(state: Mapping[str, Any], dtype=torch.bfloat16) -> Dict[str, Any]:
    """Walk a bitsandbytes-serialised state dict: every ``<name>.weight`` with
    sibling ``.absmax`` / ``.shape`` (/ ``.blocksize``) entries is decoded;
    the quantisation-state entries are dropped; everything else passes through.
    Nested (double) quantisation is expected to be expanded by the caller."""
    out: Dict[str, Any] = {}
    for key, val in state.items():
        if key.endswith(".weight") and f"{key}.absmax" in state:
            shape = tuple(int(s) for s in state[f"{key}.shape"])
            out[key] = dequantize_nf4(val, state[f"{key}.absmax"], shape,
                                      blocksize=int(state.get(f"{key}.blocksize", 64)),
                                      dtype=dtype)
        elif key.endswith((".absmax", ".shape", ".blocksize", ".quant_map")):
            continue
        else:
            out[key] = val
    return out
