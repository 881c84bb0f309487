"""LoRA adapters for the Llama backbone.

Port of ``videollamb_tpu/models/lm/lora.py`` and of the adapter term of its
``_lproj``. An adapted projection is a :class:`LoRALinear` around the base
module (an ``nn.Linear`` or a quantised ``QuantLinear``) holding
``lora_a`` (d_in, r) and ``lora_b`` (r, d_out) in the JAX package's
orientation: ``y = base(x) + (x @ A) @ B``, each product rounded to x's type.

B starts at zero (identity at initialisation) and the alpha / r scale is
folded into A, so no scale is kept at run time. A and B are parameters that
the train step makes trainable over a frozen base: a plain weight, or the
int8 kernel of the QLoRA recipe, whose buffers take no gradient. The base
product runs in x's dtype (``llama.proj``), and so do the adapter's. Stacks of several adapters
selected per row are ``models/lm/mlora.py``.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from videollamb_torch.config import LlamaConfig
from videollamb_torch.models.lm.llama import proj
from videollamb_torch.parallel.tensor_parallel import tp_matmul

LORA_TARGETS = ["q_proj", "k_proj", "v_proj", "o_proj",
                "gate_proj", "up_proj", "down_proj"]


class LoRALinear(nn.Module):
    def __init__(self, base: nn.Module, lora_a: torch.Tensor, lora_b: torch.Tensor):
        super().__init__()
        self.base = base
        # Created without gradients, as serving holds them; the train step
        # turns them on for tune_mode "lora" (train/step.apply_trainable_mask).
        self.lora_a = nn.Parameter(lora_a, requires_grad=False)
        self.lora_b = nn.Parameter(lora_b, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Under tensor parallelism B shards with a column-parallel base's
        # outputs and A with a row-parallel base's inputs (tp_matmul).
        down = tp_matmul(x, self.lora_a)
        return proj(self.base, x) + tp_matmul(down, self.lora_b)


def _targets(lm: nn.Module, names):
    for layer in lm.model.layers:
        for parent in (layer.self_attn, layer.mlp):
            for name in names:
                if hasattr(parent, name):
                    yield parent, name


def add_lora_params(lm: nn.Module, cfg: LlamaConfig, *, r: int = 128, alpha: float = 256.0,
                    generator: Optional[torch.Generator] = None,
                    targets: Optional[List[str]] = None,
                    dtype=torch.float32) -> nn.Module:
    """Add adapters to the LM's layer projections, in place, over a plain or a
    quantised base. A is normal with deviation (alpha / r) / sqrt(d_in), B zero."""
    del cfg  # the shapes come from the modules
    scale = alpha / r
    for parent, name in _targets(lm, targets or LORA_TARGETS):
        base = getattr(parent, name)
        d_in, d_out = base.in_features, base.out_features
        ref = next(iter(base.parameters()), None)
        device = ref.device if ref is not None else next(base.buffers()).device
        a = torch.randn((d_in, r), generator=generator, dtype=torch.float32,
                        device=generator.device if generator is not None else "cpu")
        a = (a * (scale / math.sqrt(d_in))).to(device=device, dtype=dtype)
        setattr(parent, name, LoRALinear(base, a, torch.zeros((r, d_out), dtype=dtype,
                                                              device=device)))
    return lm


def merge_lora_params(lm: nn.Module) -> nn.Module:
    """Fold the adapters into the base weights and drop them, in place
    (``merge_and_unload``). The bases must be full precision."""
    for parent, name in _targets(lm, LORA_TARGETS):
        module = getattr(parent, name)
        if not isinstance(module, LoRALinear):
            continue
        if not isinstance(module.base, nn.Linear):
            raise ValueError(f"{name}: adapters merge into full-precision weights only")
        weight = module.base.weight
        delta = torch.matmul(module.lora_a, module.lora_b)  # (d_in, d_out)
        with torch.no_grad():
            weight += delta.t().to(weight.dtype)
        setattr(parent, name, module.base)
    return lm
