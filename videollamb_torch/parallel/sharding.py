"""Parameter sharding of a ``VideoLLaMB`` over a ('data', 'model') mesh.

Port of ``videollamb_tpu/parallel/sharding.py``. :func:`param_specs` is the
JAX package's placement table under the port's parameter names, one axis
name (or None) for each dim of each parameter in torch's orientation (a
Linear weight is (out, in)):

- Megatron tensor parallelism on the LM: q / k / v / gate / up column
  parallel (output features on 'model'), o / down row parallel (input
  features on 'model'); a vocabulary-parallel ``embed_tokens`` and
  ``lm_head``;
- FSDP by sharding the other matrix dim over 'data';
- the CLIP towers the same way; LoRA and multi-LoRA leaves follow their
  base's dims (A the input's, B the output's); norms, the bridge and
  ``lm_memory`` replicated.

:func:`shard_params` applies it: tensor parallelism with
``parallelize_module`` whenever the mesh has a 'model' axis, even one of
size 1, as JAX's ``NamedSharding`` places its arrays (the weights become
DTensors over that axis, which ``parallel/tensor_parallel.py`` computes
with), then FSDP2 ``fully_shard`` over 'data' (over ('replica', 'data') as
hybrid sharding on a multi-host mesh) per decoder layer and tower layer,
then the root. FSDP2
shards dim 0 where JAX's table names the other dim for 'data': the same
math, another layout. An FSDP unit holds parameters of one dtype (FSDP2's
rule): those of another dtype in its scope (a trained float32 projector
beside a frozen bf16 LM) stay replicated, and :func:`make_sharded_train_step`
averages their gradients over the data ranks itself.

The sharded step runs the model through its module call
(``VideoLLaMB.forward``), so that FSDP gathers each unit's weights around
its forward and reduce-scatters its gradients in the backward; the loss is
the mean over the global batch's supervised tokens, as the JAX step's
under GSPMD, for the plain loss and for ``rmt_loss``'s per-segment one.

The serving paths run the LM's parts as functions (``llama._qkv``,
``_mlp``, ``_final``, ``embed_tokens``), which no module hook sees: they
wrap each layer, and the root unit's embedding, head, norm and bridge, in
:func:`gathered`, which all-gathers a unit's weights (FSDP2's ``unshard``)
and frees them after. Every rank steps the same engine in lockstep over its
local heads (:func:`local_heads`) and gets the replicated logits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import Counter
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import FSDPModule, fully_shard
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor.parallel import ParallelStyle, parallelize_module

Spec = Tuple[Optional[str], ...]
COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")  # o / down are row parallel
LM_PARENTS = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
              "o_proj": "self_attn", "gate_proj": "mlp", "up_proj": "mlp", "down_proj": "mlp"}


def _proj_specs(module: nn.Module, key: str, in_axis, out_axis, specs: Dict[str, Spec]) -> None:
    from videollamb_torch.models.lm.lora import LoRALinear
    from videollamb_torch.models.lm.mlora import MultiLoRALinear

    if isinstance(module, MultiLoRALinear):  # (K, d_in, r) / (K, r, d_out)
        specs[f"{key}.lora_a"] = (None, in_axis, None)
        specs[f"{key}.lora_b"] = (None, None, out_axis)
        _proj_specs(module.base, f"{key}.base", in_axis, out_axis, specs)
    elif isinstance(module, LoRALinear):  # (d_in, r) / (r, d_out)
        specs[f"{key}.lora_a"] = (in_axis, None)
        specs[f"{key}.lora_b"] = (None, out_axis)
        _proj_specs(module.base, f"{key}.base", in_axis, out_axis, specs)
    elif isinstance(module, nn.Linear):
        specs[f"{key}.weight"] = (out_axis, in_axis)
    # A quantised base holds buffers, no parameters.


def _lm_specs(lm: nn.Module, prefix: str, fsdp, tp, specs: Dict[str, Spec]) -> None:
    specs[f"{prefix}model.embed_tokens.weight"] = (tp, fsdp)
    specs[f"{prefix}lm_head.weight"] = (tp, fsdp)  # JAX's (D, V) kernel on (fsdp, tp)
    for i, layer in enumerate(lm.model.layers):
        for name, parent in LM_PARENTS.items():
            in_axis, out_axis = (fsdp, tp) if name in COLUMN else (tp, fsdp)
            _proj_specs(getattr(getattr(layer, parent), name),
                        f"{prefix}model.layers.{i}.{parent}.{name}", in_axis, out_axis, specs)


def _tower_specs(tower: nn.Module, prefix: str, fsdp, tp, specs: Dict[str, Spec]) -> None:
    if not hasattr(tower, "vision_model"):
        raise ValueError(f"the sharding table covers the CLIP towers, not "
                         f"{type(tower).__name__} (as the JAX package's)")
    vm = f"{prefix}vision_model."
    specs[f"{vm}embeddings.patch_embedding.weight"] = (tp, None, None, None)
    for i, layer in enumerate(tower.vision_model.encoder.layers):
        attns = ["self_attn"] + (["temporal_attn"] if hasattr(layer, "temporal_attn") else [])
        for attn in attns:
            for name in ("q_proj", "k_proj", "v_proj"):
                key = f"{vm}encoder.layers.{i}.{attn}.{name}"
                specs[f"{key}.weight"] = (tp, fsdp)
                specs[f"{key}.bias"] = (tp,)
            specs[f"{vm}encoder.layers.{i}.{attn}.out_proj.weight"] = (fsdp, tp)
        specs[f"{vm}encoder.layers.{i}.mlp.fc1.weight"] = (tp, fsdp)
        specs[f"{vm}encoder.layers.{i}.mlp.fc1.bias"] = (tp,)
        specs[f"{vm}encoder.layers.{i}.mlp.fc2.weight"] = (fsdp, tp)


def param_specs(model: nn.Module, *, shard_params_over_data: bool = True,
                tensor_parallel: bool = True) -> Dict[str, Spec]:
    """The placement of every parameter of ``model``: each dim's mesh axis
    ('data', 'model') or None; unnamed parameters are replicated."""
    fsdp = "data" if shard_params_over_data else None
    tp = "model" if tensor_parallel else None
    table: Dict[str, Spec] = {}
    if getattr(model, "lm", None) is not None:
        _lm_specs(model.lm, "lm.", fsdp, tp, table)
    for key in ("video_tower", "image_tower"):
        if getattr(model, key, None) is not None:
            _tower_specs(getattr(model, key), f"{key}.", fsdp, tp, table)
    return {name: table.get(name, (None,) * p.ndim) for name, p in model.named_parameters()}


class _PlaceParams(ParallelStyle):
    """Make a module's named parameters DTensors with the given placements
    on the tensor-parallel mesh; the model code computes with them
    (``parallel/tensor_parallel.py``), so no forward hooks are installed."""

    def __init__(self, placements: Dict[str, Shard]):
        super().__init__()
        self.placements = placements

    def _apply(self, module: nn.Module, device_mesh: DeviceMesh) -> nn.Module:
        for leaf, placement in self.placements.items():
            p = getattr(module, leaf)
            module.register_parameter(leaf, nn.Parameter(
                distribute_tensor(p.data, device_mesh, [placement]),
                requires_grad=p.requires_grad))
        return module


def _check_tensor_parallel(model: nn.Module, tp: int) -> None:
    from videollamb_torch.models.lm.mlora import MultiLoRALinear

    for name, module in model.named_modules():
        kind = type(module).__name__
        if kind in ("QuantLinear", "Int8Dense"):
            raise NotImplementedError(
                f"{name}: tensor parallelism takes float weights and (multi-)LoRA adapters; "
                f"{kind} modules (quantised weights) stay unsharded")
        if isinstance(module, MultiLoRALinear) and not isinstance(module.base, nn.Linear):
            raise NotImplementedError(
                f"{name}: a multi-LoRA stack shards over a plain base weight, not over "
                f"{type(module.base).__name__}")
        attn = getattr(module, "self_attn", None)
        heads = getattr(attn, "num_heads", None)
        if heads is not None:
            for what, n in (("query", heads), ("key / value", attn.num_key_value_heads)):
                if n % tp:
                    raise ValueError(f"{name}: {n} {what} heads do not split over {tp} "
                                     "tensor-parallel ranks")
    for name, p in model.named_parameters():
        if name.endswith("embed_tokens.weight") and p.shape[0] % tp:
            raise ValueError(f"{name}: {p.shape[0]} rows do not split over {tp} ranks")


def _dp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    names = mesh.mesh_dim_names
    return mesh["replica", "data"] if "replica" in names else mesh["data"]


def _dp_groups(mesh: DeviceMesh) -> List[dist.ProcessGroup]:
    """The process groups of the mesh's data-parallel axes."""
    return [mesh.get_group(name) for name in ("replica", "data") if name in mesh.mesh_dim_names]


def _fully_shard(module: nn.Module, dp_mesh: DeviceMesh) -> None:
    """``fully_shard`` over the parameters in ``module``'s scope (those of no
    inner unit) of its largest dtype; the others stay replicated."""
    inner = {id(p) for m in module.modules() if m is not module and isinstance(m, FSDPModule)
             for p in m.parameters()}
    scope = [p for p in module.parameters() if id(p) not in inner]
    if not scope:
        return
    sizes = Counter()
    for p in scope:
        sizes[p.dtype] += p.numel()
    major = sizes.most_common(1)[0][0]
    ignored = {p for p in scope if p.dtype != major}
    fully_shard(module, mesh=dp_mesh, ignored_params=ignored or None)


def shard_params(mesh: DeviceMesh, model: nn.Module, *, shard_params_over_data: bool = True,
                 tensor_parallel: bool = True) -> nn.Module:
    """Shard ``model`` in place by :func:`param_specs` (see the module docstring)."""
    names = mesh.mesh_dim_names
    if tensor_parallel and "model" in names:
        _check_tensor_parallel(model, mesh["model"].size())
        plan: Dict[str, Dict[str, Shard]] = {}
        for name, spec in param_specs(model, shard_params_over_data=False).items():
            if "model" in spec:
                owner, leaf = name.rsplit(".", 1)
                plan.setdefault(owner, {})[leaf] = Shard(spec.index("model"))
        parallelize_module(model, mesh["model"],
                           {owner: _PlaceParams(p) for owner, p in plan.items()})
    if shard_params_over_data:
        dp_mesh = _dp_mesh(mesh)
        units = []
        if getattr(model, "lm", None) is not None:
            units += list(model.lm.model.layers)
        for key in ("video_tower", "image_tower"):
            tower = getattr(model, key, None)
            if tower is not None:
                units += list(tower.vision_model.encoder.layers)
        for unit in units:
            _fully_shard(unit, dp_mesh)
        _fully_shard(model, dp_mesh)
        if isinstance(model, FSDPModule):
            # Mark the root as FSDP's root now, as its first forward would:
            # serving gathers units by hand (gathered) and may never call it.
            model._get_fsdp_state()._lazy_init()
        _record_units(model)
    return model


# Each module -> a weak reference to the FSDP unit whose scope holds its own
# parameters; each unit -> (a weak reference to a submodule, the name of one
# of its FSDP-managed parameters), read to tell whether it is gathered.
_UNIT_OF: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_PROBE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _record_units(model: nn.Module) -> None:
    def walk(module: nn.Module, unit: Optional[nn.Module]) -> None:
        if isinstance(module, FSDPModule):
            unit = module
        if unit is not None:
            _UNIT_OF[module] = weakref.ref(unit)
            if unit not in _PROBE:
                for leaf, p in module.named_parameters(recurse=False):
                    if _fsdp_managed(p):
                        _PROBE[unit] = (weakref.ref(module), leaf)
                        break
        for child in module.children():
            walk(child, unit)

    walk(model, None)


@contextlib.contextmanager
def gathered(module: nn.Module):
    """Run the block with the weights of the FSDP unit that holds ``module``'s
    own parameters all-gathered (FSDP2's ``unshard``), and free them after
    (``reshard``), for code that uses the weights without calling the unit as
    a module. Nothing happens for a module of no FSDP unit, or when the unit
    is gathered already (by an outer block, or by FSDP around the unit's
    forward), so blocks nest."""
    ref = _UNIT_OF.get(module)
    unit = ref() if ref is not None else None
    probe = _PROBE.get(unit) if unit is not None else None
    if probe is None or not _fsdp_managed(getattr(probe[0](), probe[1])):
        yield
        return
    unit.unshard()
    try:
        yield
    finally:
        unit.reshard()


def _linear_rows(module: nn.Module) -> Tuple[int, int]:
    """(output rows, tensor-parallel ranks they split over) of a projection:
    an ``nn.Linear`` under any adapter wrappers; quantised weights are never
    split."""
    while not isinstance(module, nn.Linear) and hasattr(module, "base"):
        module = module.base
    if not isinstance(module, nn.Linear):
        return module.out_features, 1
    w = module.weight
    tp = 1
    if isinstance(w, DTensor):
        names = w.device_mesh.mesh_dim_names or ()
        for i, (name, placement) in enumerate(zip(names, w.placements)):
            if name == "model" and placement.is_shard(0):
                tp *= w.device_mesh.size(i)
    return w.shape[0], tp


def local_heads(attn: nn.Module) -> Tuple[int, int]:
    """(query heads, key / value heads) of a Llama attention module on this
    rank: all of them, or 1 / tp of each under tensor parallelism, from the
    widths of ``q_proj`` and ``k_proj`` on this rank (FSDP-sharded or not)."""
    out = []
    for proj in (attn.q_proj, attn.k_proj):
        rows, tp = _linear_rows(proj)
        out.append(rows // tp // attn.head_dim)
    return out[0], out[1]


class BatchShard(NamedTuple):
    """This rank's slice of the global batch: ``index`` of ``count``."""

    count: int
    index: int


def batch_sharding(mesh: DeviceMesh) -> BatchShard:
    """The batch splits over the data axes (('replica', 'data') on a
    multi-host mesh); the ranks of one data slice share its rows."""
    count, index = 1, 0
    for name in ("replica", "data"):
        if name in mesh.mesh_dim_names:
            sub = mesh[name]
            count, index = count * sub.size(), index * sub.size() + sub.get_local_rank()
    return BatchShard(count, index)


def _fsdp_managed(p: torch.Tensor) -> bool:
    return isinstance(p, DTensor) and "data" in (p.device_mesh.mesh_dim_names or ())


def _all_reduce_(t: torch.Tensor, groups) -> torch.Tensor:
    for group in groups:
        dist.all_reduce(t, group=group)
    return t


def make_sharded_train_step(mesh: DeviceMesh, model_cfg, tx, *, remat: bool = True,
                            attn_impl: str = "chunked", rmt_loss: bool = False,
                            mask: Optional[Dict[str, bool]] = None) -> Callable:
    """The train step of a model sharded by :func:`shard_params`:
    (state, this rank's batch rows, generator) -> (state, metrics), with the
    loss, its gradients and the metrics of the global batch. ``rmt_loss``
    takes the per-segment retro loss (``train/retro.py``), normalised like
    the plain one by the global batch's supervised tokens."""
    from videollamb_torch.models.assembly import causal_lm_loss_sum, videollamb_forward
    from videollamb_torch.train.retro import videollamb_retro_forward
    from videollamb_torch.train.step import apply_trainable_mask, global_norm

    groups = _dp_groups(mesh)
    dp_world = batch_sharding(mesh).count

    def train_step(state, batch, generator=None):
        model = state.model
        apply_trainable_mask(model, mask)
        fsdp = isinstance(model, FSDPModule)
        scale = dp_world if fsdp else 1  # FSDP averages gradients over the data ranks
        with torch.enable_grad():
            if rmt_loss:
                logits, labels = model(videollamb_retro_forward, model_cfg, batch, generator,
                                       remat=remat, attn_impl=attn_impl)
            else:
                logits, spliced = model(videollamb_forward, model_cfg, batch, generator,
                                        remat=remat, attn_impl=attn_impl)
                labels = spliced.labels
            total, count = causal_lm_loss_sum(logits, labels)
            n = _all_reduce_(count.clone(), groups).clamp(min=1)
            loss = total / n
            if loss.requires_grad:
                (loss * scale).backward()
        grads = []
        for p in tx.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if not _fsdp_managed(p) and groups:
                _all_reduce_(g.to_local() if isinstance(g, DTensor) else g, groups)
                if scale != 1:
                    g = g / scale
            grads.append(g)
            p.grad = None
        grad_norm = global_norm(grads)
        tx.update(grads)
        metrics = {"loss": _all_reduce_(loss.detach().clone(), groups), "tokens": n,
                   "grad_norm": grad_norm}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step
