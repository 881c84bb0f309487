"""Pipeline parallelism: GPipe over the ranks of a 'pipe' mesh axis.

Port of ``videollamb_tpu/parallel/pipeline.py``. Stage s (pipe rank s) holds
the contiguous layers [sL/P, (s+1)L/P) (:func:`shard_stacked_layers`); the
batch splits into M microbatches, and each stage runs every microbatch
through its layers and hands the activations to the next stage with
``isend`` / ``irecv``: the (M + P - 1)-tick GPipe schedule, with stage s on
microbatch t - s at tick t. The last stage's outputs are broadcast to every
stage, as JAX's psum does, so every stage computes the same logits and loss.

The whole pipeline is one ``torch.autograd.Function``: its backward runs
the schedule in reverse (microbatches last to first; each stage receives
its outputs' gradients from the next stage and sends its inputs' to the
previous one), accumulating the stage's parameter gradients over the
microbatches, the gradient JAX takes through its ``fori_loop``. With
``remat`` a stage keeps only its inputs and recomputes each microbatch in
the backward (GPipe's memory story); without it, it keeps each
microbatch's graph.

The steps take gradients of the stage's layers from that stage, of the
replicated parameters (embeddings, norm, head, tower and projector) from
stage 0, which holds them all, and sum them over the data ranks where there
is a data axis; the clipping norm is the global one over every stage.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from videollamb_torch.parallel.mesh import mesh_device_type


def create_pipeline_mesh(n_stages: int):
    """A ('pipe',) mesh of ``n_stages`` ranks (the whole world)."""
    from torch.distributed.device_mesh import init_device_mesh

    if dist.get_world_size() != n_stages:
        raise ValueError(f"{n_stages} stages need as many ranks, not {dist.get_world_size()}")
    return init_device_mesh(mesh_device_type(), (n_stages,), mesh_dim_names=("pipe",))


def create_pipe_data_mesh(n_stages: int, n_data: int):
    """A ('data', 'pipe') mesh: rank d * n_stages + s is stage s of data
    replica d (the stages of one replica are neighbours)."""
    from torch.distributed.device_mesh import init_device_mesh

    if dist.get_world_size() != n_stages * n_data:
        raise ValueError(f"{n_data} x {n_stages} needs as many ranks")
    return init_device_mesh(mesh_device_type(), (n_data, n_stages),
                            mesh_dim_names=("data", "pipe"))


def stage_range(mesh, n_layers: int) -> range:
    """The layers this rank's stage holds."""
    group = mesh.get_group("pipe")
    p, s = dist.get_world_size(group), dist.get_rank(group)
    if n_layers % p:
        raise ValueError(f"{n_layers} layers do not split over {p} stages")
    per = n_layers // p
    return range(s * per, (s + 1) * per)


def shard_stacked_layers(mesh, lm: nn.Module) -> nn.Module:
    """Keep only this stage's decoder layers in ``lm`` (in place); the
    layers of the other stages are dropped with their memory."""
    keep = stage_range(mesh, len(lm.model.layers))
    lm.model.layers = nn.ModuleList(lm.model.layers[i] for i in keep)
    return lm


def _send(t: torch.Tensor, dst: int, group) -> None:
    dist.isend(t.contiguous(), dist.get_global_rank(group, dst), group=group).wait()


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    out = torch.empty_like(like)
    dist.irecv(out, dist.get_global_rank(group, src), group=group).wait()
    return out


class _GPipe(torch.autograd.Function):
    """Forward and backward GPipe schedules of one stage; the inputs are
    ``run_stage(h, m)``, the pipe group, ``remat``, the microbatches x and
    the stage's trained parameters."""

    @staticmethod
    def forward(ctx, run_stage, group, remat, x, *params):
        s, p = dist.get_rank(group), dist.get_world_size(group)
        keep = []  # per microbatch: its input and, without remat, its graph
        outs = []
        for m in range(x.shape[0]):
            h = x[m] if s == 0 else _recv(x[m], s - 1, group)
            leaf = h.detach().requires_grad_(not remat)
            with torch.set_grad_enabled(not remat):
                out = run_stage(leaf, m)
            keep.append((leaf, None if remat else out))
            if s < p - 1:
                _send(out.detach(), s + 1, group)
            else:
                outs.append(out.detach())
        y = torch.stack(outs) if s == p - 1 else torch.empty_like(x)
        dist.broadcast(y, dist.get_global_rank(group, p - 1), group=group)
        ctx.run_stage, ctx.group, ctx.remat = run_stage, group, remat
        ctx.keep, ctx.params, ctx.x_like = keep, params, x
        return y

    @staticmethod
    def backward(ctx, grad_y):
        group, params = ctx.group, list(ctx.params)
        s, p = dist.get_rank(group), dist.get_world_size(group)
        param_grads: List[Optional[torch.Tensor]] = [None] * len(params)
        dx = torch.zeros_like(ctx.x_like)
        for m in reversed(range(len(ctx.keep))):
            leaf, out = ctx.keep[m]
            # Every stage holds the same loss: the last one's gradient is the one.
            g_out = grad_y[m] if s == p - 1 else _recv(grad_y[m], s + 1, group)
            with torch.enable_grad():
                if ctx.remat:
                    leaf = leaf.detach().requires_grad_()
                    out = ctx.run_stage(leaf, m)
                grads = torch.autograd.grad(out, [leaf] + params, g_out, allow_unused=True)
            for i, g in enumerate(grads[1:]):
                if g is not None:
                    param_grads[i] = g if param_grads[i] is None else param_grads[i] + g
            if s > 0:
                _send(grads[0], s - 1, group)
            else:
                dx[m] = grads[0]
        ctx.keep = None
        return (None, None, None, dx, *param_grads)


def pipeline_apply(mesh, layer_fn: Callable, layers: nn.ModuleList, x: torch.Tensor, *,
                   remat: bool = False) -> torch.Tensor:
    """Run the microbatches x (M, mb, ...) through every stage's ``layers``
    with GPipe; returns the (M, mb, ...) outputs on every stage.
    ``layer_fn(layer, h, m)`` applies one layer to microbatch m's
    activations. Differentiable in x and the stage's parameters."""
    def run_stage(h, m):
        for layer in layers:
            h = layer_fn(layer, h, m)
        return h

    params = [q for q in layers.parameters() if q.requires_grad]
    return _GPipe.apply(run_stage, mesh.get_group("pipe"), remat, x, *params)


def pipeline_llama_forward(mesh, lm, cfg, inputs_embeds: torch.Tensor,
                           attention_mask: torch.Tensor, n_micro: int, *,
                           remat: bool = False) -> torch.Tensor:
    """Full-sequence forward with the layer stack pipelined over 'pipe';
    ``lm`` holds this stage's layers (:func:`shard_stacked_layers`) and the
    replicated embeddings, norm and head. The batch rows are this data
    rank's; returns their (B, S, V) logits on every stage."""
    from videollamb_torch.models.lm.llama import _final, _layer
    from videollamb_torch.models.lm.rope import rope_cos_sin_cfg

    b, s, d = inputs_embeds.shape
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    mb = b // n_micro
    cos, sin = rope_cos_sin_cfg(cfg, torch.arange(s, device=inputs_embeds.device)[None])
    valid = attention_mask.bool().reshape(n_micro, mb, s)

    def layer_fn(layer, h, m):
        return _layer(layer, cfg, h, cos, sin, valid[m], "chunked", None)

    out = pipeline_apply(mesh, layer_fn, lm.model.layers,
                         inputs_embeds.reshape(n_micro, mb, s, d), remat=remat)
    return _final(lm, cfg, out.reshape(b, s, d))


def _stage_norm_fn(stage_params, group):
    """The global gradient norm over every stage: this stage's layers'
    squares summed over the pipe ranks, the replicated parameters' once."""
    ids = {id(q) for q in stage_params}

    def norm_fn(params, grads):
        local = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        shared = torch.zeros_like(local)
        for q, g in zip(params, grads):
            sq = g.float().pow(2).sum()
            if id(q) in ids:
                local = local + sq
            else:
                shared = shared + sq
        dist.all_reduce(local, group=group)
        return torch.sqrt(local + shared)

    return norm_fn


def _pipeline_update(mesh, tx, model, loss, n, data_axis, stage_params):
    """Gradients, their reductions (see the module docstring), the update
    and the metrics of the global loss."""
    pipe = mesh.get_group("pipe")
    data = mesh.get_group(data_axis) if data_axis else None
    first = dist.get_global_rank(pipe, 0)
    stage_ids = {id(q) for q in stage_params}
    wanted = [q for q in model.parameters() if q.requires_grad]
    grads = (torch.autograd.grad(loss, wanted, allow_unused=True) if loss.requires_grad
             else [None] * len(wanted))
    by_param = {q: torch.zeros_like(q) if g is None else g for q, g in zip(wanted, grads)}
    out = []
    for q in tx.params:
        g = by_param.get(q, torch.zeros_like(q))
        if id(q) not in stage_ids:
            dist.broadcast(g, first, group=pipe)
        if data is not None:
            dist.all_reduce(g, group=data)
        out.append(g)
    total = loss.detach().clone()
    if data is not None:
        dist.all_reduce(total, group=data)
    norm_fn = _stage_norm_fn(stage_params, pipe)
    grad_norm = norm_fn(tx.params, out)
    tx.update(out, norm_fn=norm_fn)
    return {"loss": total, "tokens": n, "grad_norm": grad_norm}


def _global_loss(logits, labels, data_axis, mesh):
    from videollamb_torch.models.assembly import causal_lm_loss_sum

    total, n = causal_lm_loss_sum(logits, labels)
    if data_axis:
        dist.all_reduce(n, group=mesh.get_group(data_axis))
    n = n.clamp(min=1)
    return total / n, n


def make_pipeline_train_step(mesh, cfg, tx, n_micro: int, *, data_axis: Optional[str] = None,
                             remat: bool = True) -> Callable:
    """Pipelined LM step: ``step(state, embeds, mask, labels) -> (state,
    metrics)``, ``state.model`` the stage-sharded LM, the rows this data
    rank's."""
    def step(state, embeds, mask, labels):
        lm = state.model
        with torch.enable_grad():
            logits = pipeline_llama_forward(mesh, lm, cfg, embeds, mask, n_micro, remat=remat)
            loss, n = _global_loss(logits, labels, data_axis, mesh)
        metrics = _pipeline_update(mesh, tx, lm, loss, n, data_axis,
                                   list(lm.model.layers.parameters()))
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step


def make_pipeline_videollamb_step(mesh, cfg, tx, n_micro: int, *,
                                  data_axis: Optional[str] = None, remat: bool = True,
                                  mask: Optional[dict] = None) -> Callable:
    """Pipelined multimodal step: tower, bridge and splice on every stage,
    the spliced stream through the GPipe-staged LM; ``step(state, batch,
    generator) -> (state, metrics)`` (the contract of
    ``train.step.make_train_step``). The spliced rows split into
    ``n_micro`` microbatches."""
    from videollamb_torch.models.assembly import _prepare
    from videollamb_torch.train.step import apply_trainable_mask

    def step(state, batch, generator=None):
        model = state.model
        apply_trainable_mask(model, mask)
        with torch.enable_grad():
            spliced = _prepare(model, cfg, batch, generator)
            logits = pipeline_llama_forward(mesh, model.lm, cfg.lm, spliced.embeds,
                                            spliced.attention_mask, n_micro, remat=remat)
            loss, n = _global_loss(logits, spliced.labels, data_axis, mesh)
        metrics = _pipeline_update(mesh, tx, model, loss, n, data_axis,
                                   list(model.lm.model.layers.parameters()))
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step
