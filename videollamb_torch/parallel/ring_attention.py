"""Ring attention: sequence parallelism over a group of ranks.

Port of ``videollamb_tpu/parallel/ring_attention.py`` (the classic ring
schedule, Liu et al. arXiv:2310.01889). Every rank of the group holds one
contiguous shard of the sequence:

- it keeps its q shard and accumulates online-softmax statistics (m, l, o
  in f32) against one k / v shard at a time, passing the k / v shard and
  its validity mask to the next rank (``dist.batch_isend_irecv``);
- causal masking uses global positions, the shard held at step t being
  owned by rank (idx - t) mod P.

Point-to-point operations have no autograd, so the ring is one
``torch.autograd.Function``. Its backward runs the ring again from the saved
(m, l): each rank recomputes each block's probabilities, adds the block's
dq, and adds the block's dk and dv to accumulators that travel with the
k / v shard, which after P steps are back with their owner. These are the
gradients that ``jax.vjp`` takes through the JAX ring's ``ppermute``. Each
block is plain PyTorch, as the JAX package computes it in XLA.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _ring_pass(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each tensor to the next rank of the group and receive the
    previous rank's."""
    p = dist.get_world_size(group)
    if p == 1:
        return tensors
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % p)
    prv = dist.get_global_rank(group, (idx - 1) % p)
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, o, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _block_mask(valid, q_pos, k_pos, causal):
    mask = valid.bool()[:, None, None, :]
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])[None, None]
    return mask


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid, group, causal, scale):
        idx, p = dist.get_rank(group), dist.get_world_size(group)
        b, s, h, dh = q.shape
        dev = q.device
        q_pos = idx * s + torch.arange(s, device=dev)
        qf = q.float() * scale
        m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
        o = torch.zeros((b, h, s, dh), dtype=torch.float32, device=dev)
        kc, vc, vd = k, v, valid
        for t in range(p):
            k_pos = ((idx - t) % p) * s + torch.arange(s, device=dev)
            scores = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float())
            scores = scores.masked_fill(~_block_mask(vd, q_pos, k_pos, causal), NEG_INF)
            m_new = torch.maximum(m, scores.amax(-1))
            alive = m_new > NEG_INF / 2  # a fully masked row keeps l = o = 0
            e = torch.where(alive[..., None], torch.exp(scores - m_new[..., None]), 0.0)
            corr = torch.where(alive, torch.exp(m - m_new), 0.0)
            l = corr * l + e.sum(-1)
            o = corr[..., None] * o + torch.einsum("bhqk,bkhd->bhqd", e, vc.float())
            m = m_new
            if t < p - 1:
                kc, vc, vd = _ring_pass([kc, vc, vd], group)
        out = (o / l.clamp(min=1e-30)[..., None]).transpose(1, 2)
        ctx.save_for_backward(q, k, v, valid, m, l, out)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, m, l, out = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        idx, p = dist.get_rank(group), dist.get_world_size(group)
        b, s, h, dh = q.shape
        dev = q.device
        q_pos = idx * s + torch.arange(s, device=dev)
        qf = q.float() * scale
        do = dout.float().transpose(1, 2)  # (B, H, S, Dh)
        o = out.transpose(1, 2)
        delta = (do * o).sum(-1)  # (B, H, S)
        alive = (m > NEG_INF / 2)[..., None]
        inv_l = 1.0 / l.clamp(min=1e-30)
        dq = torch.zeros_like(qf)
        kc, vc, vd = k, v, valid
        dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=dev)
        for t in range(p):
            k_pos = ((idx - t) % p) * s + torch.arange(s, device=dev)
            scores = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float())
            mask = _block_mask(vd, q_pos, k_pos, causal) & alive
            pr = torch.where(mask, torch.exp(scores - m[..., None]), 0.0) * inv_l[..., None]
            dv = dv + torch.einsum("bhqk,bhqd->bkhd", pr, do)
            dp = torch.einsum("bhqd,bkhd->bhqk", do, vc.float())
            ds = pr * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kc.float())
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            # The accumulators travel with their shard; after P passes they are
            # back with its owner.
            if t < p - 1:
                kc, vc, vd, dk, dv = _ring_pass([kc, vc, vd, dk, dv], group)
            else:
                dk, dv = _ring_pass([dk, dv], group)
        return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         group=None, causal: bool = True, scale: Optional[float] = None,
                         k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-rank ring-attention body: q / k / v (B, S_local, H, Dh) are
    this rank's shards of a sequence split over ``group`` in rank order;
    ``k_valid`` (B, S_local) masks this shard's padded keys. Returns
    (B, S_local, H, Dh). Differentiable in q, k and v."""
    group = group or dist.group.WORLD
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    # The mask travels as uint8: gloo sends no bool.
    valid = (torch.ones(q.shape[:2], dtype=torch.uint8, device=q.device)
             if k_valid is None else k_valid.to(torch.uint8))
    return _RingAttention.apply(q, k, v, valid, group, causal, scale)


def create_seq_mesh(n_shards: int):
    """A one-axis ('seq',) mesh of ``n_shards`` ranks (the whole world)."""
    from torch.distributed.device_mesh import init_device_mesh

    from videollamb_torch.parallel.mesh import mesh_device_type

    if dist.get_world_size() != n_shards:
        raise ValueError(f"a seq mesh of {n_shards} needs as many ranks, "
                         f"not {dist.get_world_size()}")
    return init_device_mesh(mesh_device_type(), (n_shards,), mesh_dim_names=("seq",))


def ring_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, axis: str = "seq") -> torch.Tensor:
    """Multi-head attention over a sequence split over the mesh's ``axis``:
    q / k / v (B, S, H, Dh) hold the whole sequence on every rank; returns
    this rank's shard of the output, (B, S / P, H, Dh)."""
    group = mesh.get_group(axis)
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    s_global = q.shape[1]
    if s_global % p:
        raise ValueError(f"sequence {s_global} does not split over {p} shards")
    sl = s_global // p
    shard = slice(idx * sl, (idx + 1) * sl)
    return ring_attention_local(q[:, shard], k[:, shard], v[:, shard], group=group,
                                causal=causal)
