"""Sequence-parallel Llama forward and training steps.

Port of ``videollamb_tpu/parallel/seq_parallel.py``: the full decoder stack
with the sequence split over the ranks of a 'seq' mesh axis.

- Activations stay split, (B, S / P, D) on each rank end to end; norms,
  projections and the MLP are local, RoPE takes global positions from the
  shard index.
- Attention is the ring of ``parallel/ring_attention.py`` in every layer;
  GQA repeats k / v heads locally before the ring. ``remat`` recomputes
  each layer (and its ring) in the backward.
- The parameters are replicated: each rank's backward gives the gradient of
  its shard's tokens, and the steps sum the gradients over the seq ranks
  (and the data ranks, with a data axis), as JAX's shard_map transpose
  does.
- The loss shift crosses shard boundaries: the labels are shifted on the
  whole sequence before they are split, and the mean is over the global
  count of supervised tokens.
- The multimodal step runs the tower, bridge and splice on every rank and
  feeds this rank's slice of the spliced stream into the split stack,
  padded to a multiple of the shard count (JAX requires it divisible); the
  gradients reach the projector through the slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from videollamb_torch.constants import IGNORE_INDEX
from videollamb_torch.models.lm.llama import _final, _mlp, _qkv, proj
from videollamb_torch.models.lm.rope import rope_cos_sin_cfg
from videollamb_torch.parallel.ring_attention import ring_attention_local


def _groups(mesh, axis: str, data_axis: Optional[str]):
    seq = mesh.get_group(axis)
    data = mesh.get_group(data_axis) if data_axis else None
    return seq, data


def _sp_layer(layer, cfg, x, cos, sin, valid, group):
    b, s, _ = x.shape
    q, k, v = _qkv(layer, cfg, x, cos, sin)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    attn = ring_attention_local(q, k, v, group=group, causal=True, k_valid=valid)
    x = x + proj(layer.self_attn.o_proj, attn.reshape(b, s, -1))
    return _mlp(layer, cfg, x)


def _shard(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's slice of dim 1."""
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    n = t.shape[1] // p
    return t[:, idx * n:(idx + 1) * n]


def seq_parallel_llama_forward(mesh, lm, cfg, inputs_embeds: torch.Tensor,
                               attention_mask: torch.Tensor, *, axis: str = "seq",
                               remat: bool = False) -> torch.Tensor:
    """Causal forward of this rank's shard of the sequence.

    ``inputs_embeds`` (B, S, D) and ``attention_mask`` (B, S) are the whole
    sequence of this rank's batch rows (on a mesh with a data axis, each data
    rank passes its own rows, as JAX's ``data_axis`` shards them); S divides
    by the mesh's ``axis`` size. Returns this rank's logits (B, S / P, V)."""
    group = mesh.get_group(axis)
    p = dist.get_world_size(group)
    s_global = inputs_embeds.shape[1]
    if s_global % p:
        raise ValueError(f"sequence {s_global} does not split over {p} shards")
    x = _shard(inputs_embeds, group)
    valid = _shard(attention_mask, group).bool()
    sl = x.shape[1]
    pos = (dist.get_rank(group) * sl + torch.arange(sl, device=x.device))[None]
    cos, sin = rope_cos_sin_cfg(cfg, pos)
    for layer in lm.model.layers:
        args = (layer, cfg, x, cos, sin, valid, group)
        x = (checkpoint(_sp_layer, *args, use_reentrant=False)
             if remat and torch.is_grad_enabled() else _sp_layer(*args))
    return _final(lm, cfg, x)


def sharded_loss(logits_local: torch.Tensor, labels: torch.Tensor, group,
                 data_group=None):
    """(this rank's share of the global mean loss, the global token count):
    the labels (B, S) are the whole sequence's, shifted before the split;
    summing the shares over the seq (and data) ranks gives
    ``causal_lm_loss`` of the whole batch."""
    shifted = F.pad(labels[:, 1:], (0, 1), value=IGNORE_INDEX)
    lab = _shard(shifted, group)
    valid = lab != IGNORE_INDEX
    logp = torch.log_softmax(logits_local.float(), dim=-1)
    tok = torch.gather(logp, -1, torch.where(valid, lab, 0).long()[..., None])[..., 0]
    n = valid.sum()
    for g in (group, data_group):
        if g is not None:
            dist.all_reduce(n, group=g)
    n = n.clamp(min=1)
    return -torch.where(valid, tok, 0.0).sum() / n, n


def _reduced_step(tx, params, loss, n, groups):
    """Gradients of every replicated parameter summed over ``groups``, the
    update, and the metrics of the global loss."""
    from videollamb_torch.train.step import global_norm

    wanted = [p for p in params if p.requires_grad]
    grads = (torch.autograd.grad(loss, wanted, allow_unused=True) if loss.requires_grad
             else [None] * len(wanted))
    by_param = {p: torch.zeros_like(p) if g is None else g for p, g in zip(wanted, grads)}
    out = [by_param.get(p, torch.zeros_like(p)) for p in tx.params]
    total = loss.detach().clone()
    for g in groups:
        for t in out + [total]:
            dist.all_reduce(t, group=g)
    grad_norm = global_norm(out)
    tx.update(out)
    return {"loss": total, "tokens": n, "grad_norm": grad_norm}


def make_seq_parallel_train_step(mesh, cfg, tx, *, axis: str = "seq",
                                 data_axis: Optional[str] = None,
                                 remat: bool = True) -> Callable:
    """Long-context LM step with the sequence split over ``axis``:
    ``step(state, embeds, mask, labels) -> (state, metrics)``, ``state.model``
    the LM; the batch rows are this data rank's."""
    seq, data = _groups(mesh, axis, data_axis)
    groups = [g for g in (seq, data) if g is not None]

    def step(state, embeds, mask, labels):
        lm = state.model
        with torch.enable_grad():
            logits = seq_parallel_llama_forward(mesh, lm, cfg, embeds, mask, axis=axis,
                                                remat=remat)
            loss, n = sharded_loss(logits, labels, seq, data)
        metrics = _reduced_step(tx, list(lm.parameters()), loss, n, groups)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step


def pad_to_shards(embeds, mask, labels, p: int):
    """Right-pad the spliced stream to a multiple of ``p`` tokens (masked,
    unsupervised)."""
    pad = (-embeds.shape[1]) % p
    if not pad:
        return embeds, mask, labels
    return (F.pad(embeds, (0, 0, 0, pad)), F.pad(mask, (0, pad)),
            F.pad(labels, (0, pad), value=IGNORE_INDEX))


def make_seq_parallel_videollamb_step(mesh, cfg, tx, *, axis: str = "seq",
                                      data_axis: Optional[str] = None, remat: bool = True,
                                      mask: Optional[dict] = None) -> Callable:
    """Sequence-parallel multimodal step: ``step(state, batch, generator) ->
    (state, metrics)`` over this data rank's ``MultimodalBatch`` rows (the
    contract of ``train.step.make_train_step``). ``mask``
    (``train.step.trainable_mask``) freezes what the recipe freezes."""
    from videollamb_torch.models.assembly import _prepare
    from videollamb_torch.train.step import apply_trainable_mask

    seq, data = _groups(mesh, axis, data_axis)
    groups = [g for g in (seq, data) if g is not None]
    p = dist.get_world_size(seq)

    def step(state, batch, generator=None):
        model = state.model
        apply_trainable_mask(model, mask)
        with torch.enable_grad():
            spliced = _prepare(model, cfg, batch, generator)
            embeds, am, labels = pad_to_shards(spliced.embeds, spliced.attention_mask,
                                               spliced.labels, p)
            logits = seq_parallel_llama_forward(mesh, model.lm, cfg.lm, embeds, am,
                                                axis=axis, remat=remat)
            loss, n = sharded_loss(logits, labels, seq, data)
        metrics = _reduced_step(tx, list(model.parameters()), loss, n, groups)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step
