"""Int4 weight-only dequantise-and-multiply (kernel K7).

Port of ``videollamb_tpu/ops/int4_matmul.py``. A decode step reads every LM
weight once, so its time on the card follows the weight bytes: int4 weights
are a quarter of bf16's.

Packing, "split halves": ``byte[i, n] = (w[i + K/2, n] + 8) << 4 | (w[i, n] + 8)``.
The low nibbles hold rows [0, K/2), the high nibbles rows [K/2, K), both
offset-binary. Quantisation is symmetric and group-wise along K: ``group``
consecutive rows of one output column share ``scale[row // group, n]`` (bf16).

- :func:`int4_matmul` replaces the Pallas kernel of the same name: on a CUDA
  tensor it launches ``csrc/int4_matmul.cu``, on a CPU tensor it runs
  :func:`int4_matmul_reference`. It serves the small-M products of decode and
  of a speculative verify step (M <= 64). The source holds two kernels of the
  same arithmetic and picks by what it is given: tensor-core products for
  bf16 activations from M = 2 on (groups of whole 32-row chunks), f32 FMAs
  for f32 activations, other group sizes and M = 1.
- :func:`int4_matmul_reference` is the plain statement, group by group:
  ``acc += (x_g @ nibbles_g) * scale_g`` in f32, one cast at the end. The
  scale multiplies the group's sum, not the weight.
- :func:`dequantize_int4` serves large-M products (prefill): the weight is
  rebuilt in the activations' type and a library product follows, as XLA
  does in the JAX package. In bf16 this route rounds ``q * scale`` first, so
  it differs from the kernel's in the last bits; the JAX package has the same
  two routes.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from videollamb_torch.kernels import build as kb
from videollamb_torch.ops.quantization import exact_div

MAX_KERNEL_M = 64       # the kernel serves M <= 64 (decode, verify)
MAX_KERNEL_GROUP = 128  # x tile of one group pair per warp in shared memory


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) integers in [-8, 7] -> (K//2, N) uint8, split-half layout."""
    k = q.shape[0]
    assert k % 2 == 0, k
    u = q.to(torch.int32) + 8  # offset-binary nibbles; uint8 << 4 would overflow in-type
    return (u[: k // 2] | (u[k // 2:] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` -> (K, N) int8 in [-8, 7]."""
    p = packed.to(torch.int32)
    return torch.cat([(p & 0xF) - 8, ((p >> 4) & 0xF) - 8], dim=0).to(torch.int8)


def quantize_int4(w: torch.Tensor, group: int = 128) -> Dict[str, torch.Tensor]:
    """(K, N) float -> {'q4': (K//2, N) uint8, 'scale': (K//g, N) bf16}.

    ``g`` is ``group`` shrunk by halves until it divides both K and K/2, so
    a group never straddles the two nibble halves. Values are rounded with
    the f32 scale; the stored scale is its bf16 rounding.
    """
    k, n = w.shape
    g = min(group, k)
    while k % g or (k // 2) % g:
        g //= 2
    wf = w.float().reshape(k // g, g, n)
    amax = wf.abs().amax(dim=1, keepdim=True)
    scale = exact_div(amax, 7.0).clamp_min(1e-8)
    q = torch.round(exact_div(wf, scale)).clamp(-8, 7).to(torch.int8).reshape(k, n)
    # contiguous: a transposed view of an nn.Linear weight hands its strides on
    return {"q4": pack_int4(q).contiguous(),
            "scale": scale[:, 0].to(torch.bfloat16).contiguous()}


def dequantize_int4(qk: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack and apply the group scales -> dense (K, N) weight in ``dtype``."""
    q = unpack_int4(qk["q4"])
    k, n = q.shape
    scale = qk["scale"].float()  # (K//g, N)
    g = k // scale.shape[0]
    w = q.float().reshape(k // g, g, n) * scale[:, None, :]
    return w.reshape(k, n).to(dtype)


def int4_matmul_reference(x: torch.Tensor, q4: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(q4, scale) -> (M, N) in x's type; plain PyTorch.

    The nibbles become integers in x's type (exact), each group's dot product
    and the sum over groups are f32, the group's sum is multiplied by the f32
    of its bf16 scale.
    """
    m, k = x.shape
    n_groups, n = scale.shape
    g = k // n_groups
    nib = unpack_int4(q4).to(x.dtype).float()
    xf = x.float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for i in range(n_groups):
        rows = slice(i * g, (i + 1) * g)
        acc = acc + (xf[:, rows] @ nib[rows]) * scale[i].float()[None]
    return acc.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _ksplit(m: int, k: int, n: int, g: int, bf16: bool) -> int:
    """How many ways the launch splits K (a pure function of shape and type)."""
    return kb.kernels().int4_matmul_ksplit(m, k, n, g, int(bf16))


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M <= 64, K) @ dequant(q4 (K//2, N) uint8, scale (K//g, N) bf16) -> (M, N)."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, q4, scale)
    m, k = x.shape if x.ndim == 2 else (0, 0)
    k_half, n = q4.shape
    n_groups = scale.shape[0]
    g = k // n_groups if n_groups else 0
    if (x.device.type != "cuda" or x.ndim != 2 or x.dtype not in (torch.bfloat16, torch.float32)
            or not 1 <= m <= MAX_KERNEL_M or q4.dtype != torch.uint8 or 2 * k_half != k
            or scale.dtype != torch.bfloat16 or scale.shape != (n_groups, n)
            or g * n_groups != k or k_half % g or g % 16 or g > MAX_KERNEL_GROUP
            or q4.device != x.device or scale.device != x.device
            or not (q4.is_contiguous() and scale.is_contiguous())):
        raise ValueError(
            "int4 matmul kernel takes a CUDA bf16/f32 (M <= 64, K) operand, contiguous uint8 "
            "(K/2, N) nibbles and bf16 (K/g, N) scales with g a multiple of 16, at most 128, "
            f"dividing K/2; got x {x.dtype} {tuple(x.shape)} on {x.device}, q4 {q4.dtype} "
            f"{tuple(q4.shape)}, scale {scale.dtype} {tuple(scale.shape)}")
    kb.refuse_grad("int4_matmul", x, scale)
    x = x.contiguous()
    if x.data_ptr() % 4:  # the kernels copy x two bf16 values at a time
        x = x.clone()
    lib = kb.kernels()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ksplit = _ksplit(m, k, n, g, x.dtype == torch.bfloat16)
    partial = (torch.empty((ksplit, m, n), dtype=torch.float32, device=x.device)
               if ksplit > 1 else None)
    kb.check(lib.int4_matmul(
        kb.ptr(x), kb.ptr(q4), kb.ptr(scale), kb.ptr(out),
        kb.ptr(partial) if partial is not None else None, m, k, n, g,
        int(x.dtype == torch.bfloat16), kb.current_stream(x.device)), "int4_matmul")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0
