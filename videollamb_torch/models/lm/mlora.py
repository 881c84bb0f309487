"""Multi-adapter LoRA serving: K unmerged adapters, selected per row.

Port of ``videollamb_tpu/models/lm/mlora.py`` and of the per-row delta of
its ``llama._mlora_delta`` / ``_lproj``. K adapters stay unmerged and
stacked beside the base weights: each adapted projection becomes a
:class:`MultiLoRALinear` around its base module (an ``nn.Linear``, a
``QuantLinear`` or a ``LoRALinear``) holding ``lora_a`` (K, d_in, r) and
``lora_b`` (K, r, d_out). The row adapters of a call are an index vector
(B,) set on the LM, for the calling thread, with :func:`adapter_rows`
around it; each projection gathers its rows' adapters and adds
``(x @ A) @ B`` after the base projection, so one base-weight read serves
every adapter of the batch. A row with index -1, or a call made outside
:func:`adapter_rows`, runs exactly the base model.

Adapters of different ranks co-serve: smaller ranks are padded with zeros
to the widest (zero A columns and B rows add nothing). The alpha / r scale
is folded into A at load, as in ``models/lm/lora.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from videollamb_torch.models.lm.llama import proj
from videollamb_torch.models.lm.lora import LORA_TARGETS, LoRALinear, _targets
from videollamb_torch.parallel.tensor_parallel import local, tp_linear


class AdapterRows(threading.local):
    """The row adapter indices of the LM call in flight on this thread
    (None: base model), shared by every MultiLoRALinear of one LM. Per
    thread, because threads share the LM: a server's worker steps its
    engine under adapter rows while a stream tick on a handler thread runs
    the same LM on the base model."""

    idx: Optional[torch.Tensor] = None


class MultiLoRALinear(nn.Module):
    def __init__(self, base: nn.Module, lora_a: torch.Tensor, lora_b: torch.Tensor,
                 rows: AdapterRows):
        super().__init__()
        self.base = base
        self.lora_a = nn.Parameter(lora_a, requires_grad=False)  # (K, d_in, r)
        self.lora_b = nn.Parameter(lora_b, requires_grad=False)  # (K, r, d_out)
        self.rows = rows

    @property
    def in_features(self) -> int:
        return self.base.in_features

    @property
    def out_features(self) -> int:
        return self.base.out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idx = self.rows.idx
        if idx is None:
            return proj(self.base, x)
        # x (B, S, d_in), idx (B,): each product summed in f32 and rounded to
        # x's type, as the JAX einsums with preferred_element_type=f32 do.
        # Under tensor parallelism the stacks are DTensors placed as their
        # base (parallel/sharding.py): the adapter axis is replicated, so the
        # row gather is local, and the products run on this rank's shard. On
        # a row-parallel base the delta is this rank's partial sum, added
        # before the base's all-reduce.
        safe = idx.clamp(min=0)
        u = torch.bmm(x, local(self.lora_a)[safe].to(x.dtype))
        delta = torch.bmm(u, local(self.lora_b)[safe].to(x.dtype))
        delta = delta * (idx >= 0).to(x.dtype)[:, None, None]
        if isinstance(self.base, nn.Linear):
            return tp_linear(x, self.base.weight, self.base.bias, partial=delta)
        return self.base(x) + delta


@contextlib.contextmanager
def adapter_rows(lm: nn.Module, idx: Optional[torch.Tensor]):
    """Run the LM calls of the block with row adapters ``idx`` (B,) int, -1
    the base model; None runs every row on the base model."""
    rows = getattr(lm, "mlora_rows", None)
    if rows is None:
        if idx is not None:
            raise ValueError("the LM carries no multi-LoRA stack (add_multi_lora_params)")
        yield
        return
    prev, rows.idx = rows.idx, idx
    try:
        yield
    finally:
        rows.idx = prev


def load_peft_adapter(path: str, num_layers: int) -> Dict[str, np.ndarray]:
    """A PEFT LoRA adapter directory (``adapter_config.json`` and
    ``adapter_model.safetensors`` or ``.bin``, or the checkpoint shards that
    ``models/builder.load_state_dict`` reads) as stacked numpy arrays
    ``{"{proj}_lora_a": (L, d_in, r), "{proj}_lora_b": (L, r, d_out)}`` with
    alpha / r folded into A. PEFT's lora_A is (r, d_in) and lora_B
    (d_out, r); both are transposed."""
    from videollamb_torch.models.builder import load_state_dict

    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    scale = acfg["lora_alpha"] / acfg["r"]
    st, binf = (os.path.join(path, "adapter_model." + ext) for ext in ("safetensors", "bin"))
    if os.path.exists(st):
        from safetensors.torch import load_file

        sd = load_file(st, device="cpu")
    elif os.path.exists(binf):
        sd = torch.load(binf, map_location="cpu", weights_only=True)
    else:
        sd = load_state_dict(path)

    per_target: Dict[str, Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
    for k in [k for k in sd if k.endswith("lora_A.weight")]:
        # base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight
        parts = k.split(".")
        if "layers" not in parts:
            continue  # not an LM module (e.g. the projector): not servable here
        layer = int(parts[parts.index("layers") + 1])
        target = parts[-3]
        if target not in LORA_TARGETS:
            continue
        a = sd[k].float().numpy().T * scale  # (d_in, r)
        b = sd[k.replace("lora_A", "lora_B")].float().numpy().T  # (r, d_out)
        per_target.setdefault(target, {})[layer] = (a, b)
    if not per_target:
        raise ValueError(f"{path}: no LM LoRA weights found")
    out: Dict[str, np.ndarray] = {}
    for target, rows in per_target.items():
        missing = sorted(set(range(num_layers)) - set(rows))
        if missing:
            raise ValueError(
                f"{path}: target {target!r} missing layers {missing[:4]}... "
                f"({len(missing)}/{num_layers}): partial-layer adapters are not stackable")
        out[f"{target}_lora_a"] = np.stack([rows[i][0] for i in range(num_layers)])
        out[f"{target}_lora_b"] = np.stack([rows[i][1] for i in range(num_layers)])
    return out


def extract_lora_layers(lm: nn.Module) -> Dict[str, np.ndarray]:
    """The single-adapter LoRA of an LM (``models/lm/lora.add_lora_params``
    layout) as a standalone adapter dict ``{"{proj}_lora_a": (L, d_in, r),
    "{proj}_lora_b": (L, r, d_out)}``."""
    found: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
    for parent, name in _targets(lm, LORA_TARGETS):
        mod = getattr(parent, name)
        if isinstance(mod, LoRALinear):
            found.setdefault(name, []).append((mod.lora_a.detach().float().cpu().numpy(),
                                               mod.lora_b.detach().float().cpu().numpy()))
    if not found:
        raise ValueError("the LM carries no LoRA adapter")
    out = {}
    for name in LORA_TARGETS:
        if name in found:
            out[f"{name}_lora_a"] = np.stack([a for a, _ in found[name]])
            out[f"{name}_lora_b"] = np.stack([b for _, b in found[name]])
    return out


def _pad_rank(a: np.ndarray, b: np.ndarray, r_max: int):
    r = a.shape[-1]
    if r == r_max:
        return a, b
    pad_a = [(0, 0)] * (a.ndim - 1) + [(0, r_max - r)]
    pad_b = [(0, 0)] * (b.ndim - 2) + [(0, r_max - r), (0, 0)]
    return np.pad(a, pad_a), np.pad(b, pad_b)


def add_multi_lora_params(lm: nn.Module, adapters: Mapping[str, Dict[str, Any]],
                          dtype=None) -> Tuple[nn.Module, Dict[str, int]]:
    """Stack named adapters into the LM's projections, in place.

    ``adapters``: name -> adapter dict (the :func:`extract_lora_layers`
    layout). Every adapter must target the same projections; ranks may
    differ (zero-padded). ``dtype`` defaults to the stacks' own (f32).
    Returns (the LM, registry name -> adapter index); pass a request's index
    as its row of :func:`adapter_rows`, -1 for the base model."""
    if not adapters:
        raise ValueError("no adapters given")
    if getattr(lm, "mlora_rows", None) is not None:
        raise ValueError("the LM already carries a multi-LoRA stack")
    names = list(adapters)
    targets = sorted(k[:-len("_lora_a")] for k in adapters[names[0]] if k.endswith("_lora_a"))
    if not targets:
        raise ValueError(f"adapter {names[0]!r} carries no LoRA keys")
    for n in names[1:]:
        t = sorted(k[:-len("_lora_a")] for k in adapters[n] if k.endswith("_lora_a"))
        if t != targets:
            raise ValueError(f"adapter {n!r} targets {t} but {names[0]!r} targets {targets}: "
                             "co-served adapters must share targets")
    stacks = {}
    for name in targets:
        r_max = max(np.asarray(adapters[n][f"{name}_lora_a"]).shape[-1] for n in names)
        pairs = [_pad_rank(np.asarray(adapters[n][f"{name}_lora_a"]),
                           np.asarray(adapters[n][f"{name}_lora_b"]), r_max) for n in names]
        # (L, K, d_in, r) / (L, K, r, d_out), as the JAX package stacks them.
        stacks[name] = (np.stack([a for a, _ in pairs], axis=1),
                        np.stack([b for _, b in pairs], axis=1))
    rows = AdapterRows()
    layer_of = {}
    for parent, name in _targets(lm, targets):
        layer = layer_of[name] = layer_of.get(name, -1) + 1
        base = getattr(parent, name)
        ref = next(iter(base.parameters()), None)
        device = ref.device if ref is not None else next(base.buffers()).device
        ma, mb = (torch.from_numpy(np.ascontiguousarray(s[layer])) for s in stacks[name])
        dt = dtype or ma.dtype
        setattr(parent, name, MultiLoRALinear(base, ma.to(device, dt), mb.to(device, dt), rows))
    lm.mlora_rows = rows
    return lm, {n: i for i, n in enumerate(names)}


def drop_multi_lora_params(lm: nn.Module) -> nn.Module:
    """Unload the stack: every MultiLoRALinear back to its base module, in
    place (the LM is then the base model again)."""
    for parent, name in _targets(lm, LORA_TARGETS):
        mod = getattr(parent, name)
        if isinstance(mod, MultiLoRALinear):
            setattr(parent, name, mod.base)
    lm.mlora_rows = None
    return lm


def resolve_adapter_idx(registry: Mapping[str, int], adapter_names: List[Any]) -> np.ndarray:
    """Per-row adapter names (None = base) -> an int32 index vector."""
    idx = np.full((len(adapter_names),), -1, np.int32)
    for i, n in enumerate(adapter_names):
        if n is None:
            continue
        if n not in registry:
            raise KeyError(f"unknown adapter {n!r}; have {sorted(registry)}")
        idx[i] = registry[n]
    return idx
