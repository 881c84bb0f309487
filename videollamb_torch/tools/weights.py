"""Weight-surgery tools.

Port of ``videollamb_tpu/tools/weights.py``, counterparts of the reference
checkpoint utilities:

- apply / make delta (llava/model/apply_delta.py:13, make_delta.py:13);
- consolidate (llava/model/consolidate.py:13);
- extract the projector (scripts/extract_mm_projector.py);
- merge LoRA (scripts/merge_lora_weights.py:6);
- ``export_hf_checkpoint``: a reference-format ``pytorch_model.bin`` from
  the port's model.

The functions take state dicts (names to tensors or arrays, nested dicts
allowed); the CLIs read checkpoints through the port's own
``models/builder.load_state_dict`` and ``_merge_lora`` and run on the host.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

from videollamb_torch.models.builder import _merge_lora, load_state_dict


def _map(fn: Callable, a: Any, b: Any) -> Any:
    if isinstance(a, Mapping):
        return {k: _map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _leaf(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def apply_delta(base: Mapping[str, Any], delta: Mapping[str, Any]) -> Dict[str, Any]:
    """target = base + delta, leaf by leaf (over ``base``'s names). Where
    special tokens grew a table (rows differ), the shared leading rows add and
    the delta's extra rows pass through (reference apply_delta.py)."""
    def add(b, d):
        b, d = _leaf(b), _leaf(d)
        if b.shape != d.shape:
            out = d.clone()
            n = min(b.shape[0], d.shape[0])
            out[:n] = b[:n] + d[:n]
            return out
        return b + d

    return _map(add, base, delta)


def make_delta(base: Mapping[str, Any], target: Mapping[str, Any]) -> Dict[str, Any]:
    """delta = target - base, leaf by leaf (over ``target``'s names); rows
    past the base's keep the target's values."""
    def sub(t, b):
        t, b = _leaf(t), _leaf(b)
        if t.shape != b.shape:
            out = t.clone()
            n = min(b.shape[0], t.shape[0])
            out[:n] = t[:n] - b[:n]
            return out
        return t - b

    return _map(sub, target, base)


def extract_mm_projector(state_dict: Mapping[str, Any], prefix: str = "mm_projector"
                         ) -> Dict[str, Any]:
    """Only the projector weights of a full checkpoint's state dict."""
    return {k: v for k, v in state_dict.items() if prefix in k}


def consolidate_cli(argv=None):
    """Merge a sharded checkpoint dir into one ``.npz`` of float32 arrays
    (integer tensors keep their type), the JAX tool's output format."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True)
    parser.add_argument("--dst", required=True)
    args = parser.parse_args(argv)
    sd = load_state_dict(args.src)
    np.savez(args.dst, **{k: (v.float() if v.is_floating_point() else v).numpy()
                          for k, v in sd.items()})
    print(f"consolidated {len(sd)} tensors -> {args.dst}")


def extract_projector_cli(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)
    proj = extract_mm_projector(load_state_dict(args.model_path))
    torch.save(proj, args.output)
    print(f"extracted {len(proj)} projector tensors -> {args.output}")


def merge_lora_cli(argv=None):
    """Merge a PEFT LoRA checkpoint into its base and save a full checkpoint
    (reference scripts/merge_lora_weights.py)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True, help="LoRA dir")
    parser.add_argument("--model-base", required=True)
    parser.add_argument("--save-model-path", required=True)
    args = parser.parse_args(argv)
    merged = _merge_lora(load_state_dict(args.model_base), args.model_path)
    os.makedirs(args.save_model_path, exist_ok=True)
    torch.save(merged, os.path.join(args.save_model_path, "pytorch_model.bin"))
    for name in ("config.json", "tokenizer_config.json", "tokenizer.model"):
        src = os.path.join(args.model_base, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.save_model_path, name))
    print(f"merged -> {args.save_model_path}")


def export_hf_checkpoint(model: nn.Module, out_dir: str) -> str:
    """Write a reference-format ``pytorch_model.bin`` from a ``VideoLLaMB``
    (the inverse of ``load_pretrained_model``'s reading): the LM under
    ``model.*`` and ``lm_head.weight``, the projector under
    ``model.mm_projector.*``. The port's modules already carry the
    reference's names; adapters must be merged and weights unquantised
    first. Returns the written file's path."""
    sd: Dict[str, torch.Tensor] = {}
    lm = getattr(model, "lm", None)
    if lm is not None:
        lm_sd = lm.state_dict()
        odd = [k for k in lm_sd if not k.endswith(".weight") or ".base." in k]
        if odd:
            raise ValueError(f"export needs plain weights: merge adapters and dequantise "
                             f"first ({odd[0]})")
        sd.update(lm_sd)
    projector = getattr(model, "mm_projector", None)
    if projector is not None:
        sd.update({f"model.mm_projector.{k}": v for k, v in projector.state_dict().items()})
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "pytorch_model.bin")
    torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()}, path)
    return path
