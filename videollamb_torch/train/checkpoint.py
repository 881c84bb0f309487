"""Training checkpoints on ``torch.save``, with adapter-only records.

Port of ``videollamb_tpu/train/checkpoint.py`` (reference HF Trainer
checkpoints, llava/train/llava_trainer.py:246-265, and the auto-resume of
train.py:1120-1123). A checkpoint is a directory ``checkpoint-{step}``
holding one record, ``train_state.pt``: the step, the parameters, the
optimizer's and the schedule's state, and the state of the generator that
draws dropout. The JAX package writes the whole parameter tree with orbax;
here the parameters are the trained ones only (the frozen base and towers
are the ones the run was started from, and resuming loads them again), so
a LoRA record is the adapters and the projector, not the 7B base.

- Adapter-only records (``tune_mm_mlp_adapter``): the ``mm_projector``
  parameters (and optionally ``embed_tokens``), restorable into a fresh
  model with :func:`restore_adapter`, and beside them the reference-format
  ``mm_projector.bin`` (keys ``model.mm_projector.*``, the values of
  ``export_rmt_r_state_dict``), which the reference's
  ``--pretrain_mm_mlp_adapter`` loads, for the RMT-R bridge. Another
  projector kind has no reference-format export: the record alone holds it,
  and a line says so (the JAX package prints and skips there). The JAX
  package skips that file on any error; the port raises on an RMT-R
  bridge's, so a broken export cannot pass unseen.
- ``save_total_limit`` rotation, :func:`latest_checkpoint` and
  :func:`maybe_resume`, as in the JAX package.
- Sharded models (``parallel/sharding.py``): every rank joins the gathers
  of the full parameters and optimizer state, and rank 0 alone keeps the
  host copy and writes it; a resume shards them back to each parameter's
  placement.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from videollamb_torch.models.bridge.rmt_r import RMTRBridge
from videollamb_torch.train.step import TrainState

RECORD = "train_state.pt"


def _ckpt_dirs(output_dir: str):
    if not os.path.isdir(output_dir):
        return []
    dirs = []
    for name in os.listdir(output_dir):
        m = re.match(r"^checkpoint-(\d+)$", name)
        if m and os.path.isdir(os.path.join(output_dir, name)):
            dirs.append((int(m.group(1)), os.path.join(output_dir, name)))
    return sorted(dirs)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    dirs = _ckpt_dirs(output_dir)
    return dirs[-1][1] if dirs else None


def _host(v):
    """A full host copy: a sharded DTensor is gathered (a collective)."""
    if isinstance(v, DTensor):
        v = v.full_tensor()
    return v.detach().cpu().contiguous() if torch.is_tensor(v) else v


def _writer_host(v):
    """:func:`_host` on the writer; elsewhere the gather (a collective every
    rank joins) is run and its result dropped, so one host copy exists."""
    if not _writer():
        if isinstance(v, DTensor):
            v.full_tensor()
        return None
    return _host(v)


def _map_tensors(obj, fn):
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return fn(obj) if torch.is_tensor(obj) else obj


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def export_rmt_r_state_dict(bridge: nn.Module, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The RMT-R bridge's parameters under the reference's names (host copies)."""
    if not isinstance(bridge, RMTRBridge):
        raise TypeError(f"mm_projector.bin holds an RMT-R bridge, not {type(bridge).__name__}")
    return {prefix + k: _host(v) for k, v in bridge.state_dict().items()}


def _adapter_params(model: nn.Module, include_embed_tokens: bool) -> Dict[str, torch.Tensor]:
    params = {f"mm_projector.{k}": v for k, v in model.mm_projector.state_dict().items()}
    if include_embed_tokens:
        params["lm.model.embed_tokens.weight"] = model.lm.model.embed_tokens.weight
    return params


def save_checkpoint(output_dir: str, state: TrainState, *, step: Optional[int] = None,
                    save_total_limit: int = 1, adapter_only: bool = False,
                    include_embed_tokens: bool = False,
                    generator: Optional[torch.Generator] = None) -> str:
    """Write ``checkpoint-{step}``, rotate old ones, return the path. Under
    ``torch.distributed`` every rank calls it (the gathers are collectives)
    and rank 0 writes; only rank 0 keeps the gathered state in host memory."""
    step = state.step if step is None else step
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    model = state.model
    if adapter_only:
        params = _adapter_params(model, include_embed_tokens)
    else:
        trained = {id(p) for p in state.tx.params}
        params = {name: p for name, p in model.named_parameters() if id(p) in trained}
    record = {"step": step,
              "params": {k: _writer_host(v) for k, v in params.items()},
              "optimizer": _map_tensors(state.tx.state_dict(), _writer_host),
              "generator": None if generator is None else generator.get_state()}
    if not _writer():
        dist.barrier()
        return path
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, RECORD + ".tmp")
    torch.save(record, tmp)
    os.replace(tmp, os.path.join(path, RECORD))

    if adapter_only and not isinstance(model.mm_projector, RMTRBridge):
        # As the JAX package, which prints and skips the export there.
        print(f"mm_projector.bin export skipped: a {type(model.mm_projector).__name__} "
              f"projector has no reference-format export (its weights are in {RECORD})")
    elif adapter_only:  # export_rmt_r_state_dict's names, from the gathered params
        sd = {"model." + k: v for k, v in record["params"].items()
              if k.startswith("mm_projector.")}
        if include_embed_tokens:
            sd["model.embed_tokens.weight"] = record["params"]["lm.model.embed_tokens.weight"]
        torch.save(sd, os.path.join(path, "mm_projector.bin"))

    if save_total_limit and save_total_limit > 0:
        for _, old in _ckpt_dirs(output_dir)[:-save_total_limit]:
            if os.path.abspath(old) != path:
                shutil.rmtree(old, ignore_errors=True)
    if dist.is_initialized():
        dist.barrier()
    return path


def _load_params(model: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    own = dict(model.named_parameters())
    missing = [k for k in params if k not in own]
    if missing:
        raise KeyError(f"checkpoint parameters not in the model: {missing[:5]}")
    with torch.no_grad():
        for name, value in params.items():
            p = own[name]
            if isinstance(p, DTensor):  # shard the full value to the parameter's placement
                value = distribute_tensor(value.to(p.dtype), p.device_mesh, p.placements)
            p.copy_(value)


def restore_checkpoint(path: str, state: TrainState,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """Load a record into ``state``'s model and optimizer (and ``generator``)."""
    record = torch.load(os.path.join(path, RECORD), map_location="cpu", weights_only=True)
    _load_params(state.model, record["params"])
    opt = record["optimizer"]
    if opt["acc"] is not None:
        opt["acc"] = [a.to(p.device) for a, p in zip(opt["acc"], state.tx.params)]
    state.tx.load_state_dict(opt)
    for p in state.tx.params:  # moments of sharded parameters, sharded the same way
        if isinstance(p, DTensor):
            moments = state.tx.adamw.state.get(p, {})
            for key, value in moments.items():
                if torch.is_tensor(value) and not isinstance(value, DTensor) \
                        and value.shape == p.shape:
                    moments[key] = distribute_tensor(value.to(p.dtype), p.device_mesh,
                                                     p.placements)
    if generator is not None and record["generator"] is not None:
        generator.set_state(record["generator"])
    return dataclasses.replace(state, step=int(record["step"]))


def restore_adapter(path: str, model: nn.Module) -> nn.Module:
    """Load an adapter-only record's projector (and embed_tokens) into ``model``."""
    record = torch.load(os.path.join(path, RECORD), map_location="cpu", weights_only=True)
    _load_params(model, record["params"])
    return model


def maybe_resume(output_dir: str, state: TrainState,
                 generator: Optional[torch.Generator] = None) -> TrainState:
    """Resume from the newest ``checkpoint-*`` in ``output_dir``, if any."""
    path = latest_checkpoint(output_dir)
    return state if path is None else restore_checkpoint(path, state, generator)
