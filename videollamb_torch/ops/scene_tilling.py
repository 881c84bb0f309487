"""SceneTilling segmentation (port of ``videollamb_tpu/ops/scene_tilling.py``).

Cosine similarity of adjacent frame CLS embeddings, the depth scores
(two-sided, and the causal left-only ones of the streaming mode), the
top-k, threshold and left boundary modes, and the static per-segment frame
plan.

Three details are matched exactly, because a flipped boundary changes which
frames reach the bridge: top-k picks break ties towards the lowest index
(as ``lax.top_k`` does: a stable descending sort, never ``torch.topk``);
the threshold modes take the unbiased std written out as the JAX package
computes it; ``segment_plan`` truncates an f32 linspace computed in the
same order as the JAX function. The threshold and left modes keep the JAX
package's static packing: fixed-size bounds and a validity mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity of two (n, d) tensors, norms floored at eps."""
    na = torch.clamp(torch.linalg.norm(a, dim=-1), min=eps)
    nb = torch.clamp(torch.linalg.norm(b, dim=-1), min=eps)
    return torch.sum(a * b, dim=-1) / (na * nb)


def _monotone_run_peaks(sim: torch.Tensor, *, reverse: bool) -> torch.Tensor:
    """Peak at the end of the non-decreasing run left (or right) of each position.

    The JAX scan carries ``peak[i] = peak[i-1] if sim[i-1] >= sim[i] else
    sim[i]``, so a run restarts at 0 and wherever that test fails, and each
    position's peak is the value at its run's start: a gather at the running
    maximum of the restart indices. No arithmetic, so it equals the scan bit
    for bit (-inf and NaN included: the restart test is the scan's own).
    """
    xs = sim.flip(0) if reverse else sim
    pos = torch.arange(xs.shape[0], device=xs.device)
    restart = torch.ones_like(pos, dtype=torch.bool)
    restart[1:] = ~(xs[:-1] >= xs[1:])
    start = torch.cummax(torch.where(restart, pos, 0), dim=0).values
    out = xs[start]
    return out.flip(0) if reverse else out


def depth_scores(sim: torch.Tensor) -> torch.Tensor:
    """lpeak + rpeak - 2*sim per adjacent-frame similarity."""
    return (_monotone_run_peaks(sim, reverse=False)
            + _monotone_run_peaks(sim, reverse=True) - 2.0 * sim)


def left_depth_scores(sim: torch.Tensor) -> torch.Tensor:
    """Causal (streaming) depth score lpeak - sim: looks left only."""
    return _monotone_run_peaks(sim, reverse=False) - sim


def _frame_sims(features: torch.Tensor) -> torch.Tensor:
    return cosine_similarity(features[:-1], features[1:])


def top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties to the lowest index (``lax.top_k``)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _threshold_stats(depths: torch.Tensor, n_live: Optional[int] = None):
    """(mean, std, live) over the first ``n_live`` depths (all by default):
    the std unbiased (ddof=1) as ``jnp.std`` computes it, the mean first, then
    the centred squares over n - 1; ``live`` masks those depths. The rest of
    the buffer is zeroed out of the sums, so its shape stays fixed."""
    n = depths.shape[0] if n_live is None else n_live
    live = torch.arange(depths.shape[0], device=depths.device) < n
    dv = torch.where(live, depths, 0.0)
    mean = torch.sum(dv) / max(n, 1)
    var = torch.sum(torch.where(live, (dv - mean) ** 2, 0.0)) / max(n - 1, 1)
    return mean, torch.sqrt(var), live


def _threshold(depths: torch.Tensor, alpha: float, n_live: Optional[int] = None
               ) -> torch.Tensor:
    """depths > mean + alpha * std over the first ``n_live`` depths; the rest
    never fire."""
    mean, std, live = _threshold_stats(depths, n_live)
    return live & (depths > mean + alpha * std)


def _fired_sorted(cond: torch.Tensor, mk: int, width: int, fill: int) -> torch.Tensor:
    """Fired positions in order, the first ``mk``, padded to ``width`` with ``fill``."""
    n = cond.shape[0]
    positions = torch.arange(n, dtype=torch.int32, device=cond.device)
    fired = torch.sort(torch.where(cond, positions, n)).values[:mk]
    return torch.cat([fired, fired.new_full((width - mk,), fill)])


def segment_topk(features: torch.Tensor, k: int = 3) -> torch.Tensor:
    """(T, d) CLS embeddings -> (k+1,) int32 sorted segment ends; last is T-1."""
    t = features.shape[0]
    depths = depth_scores(_frame_sims(features))
    bounds = torch.sort(top_indices(depths, k)).values
    last = torch.full((1,), t - 1, dtype=bounds.dtype, device=bounds.device)
    return torch.cat([bounds, last]).to(torch.int32)


def threshold_bounds(depths: torch.Tensor, alpha: float, max_boundaries: int, fill: int,
                     n_live: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threshold rule and its static packing, shared by ``segment_threshold``
    and the stream's detector (``ops/streaming_boundaries.py``).

    Fired positions in order; when more than ``mk`` = min(max_boundaries,
    len(depths)) fire, the top-``mk`` depths instead. Only the first
    ``n_live`` depths (all by default) count: the rest must be -inf, so that
    top-k takes them last. Returns bounds (max_boundaries + 1,) int32, padded
    with ``fill`` from slot n_valid on, and n_valid (a 0-d tensor).
    """
    cond = _threshold(depths, alpha, n_live)
    n_fired = torch.sum(cond)
    mk = min(max_boundaries, depths.shape[0])  # short videos have fewer positions
    fired_sorted = _fired_sorted(cond, mk, max_boundaries, fill)
    top = torch.sort(top_indices(depths, mk).to(torch.int32)).values
    top_sorted = torch.cat([top, top.new_full((max_boundaries - mk,), fill)])
    use_topk = n_fired > mk
    n_valid = torch.where(use_topk, mk, n_fired)
    raw = torch.where(use_topk, top_sorted, fired_sorted)
    slot = torch.arange(max_boundaries + 1, dtype=torch.int32, device=depths.device)
    picked = raw[torch.clamp(slot, max=max_boundaries - 1)]
    return torch.where(slot < n_valid, picked, fill).to(torch.int32), n_valid


def segment_threshold(features: torch.Tensor, alpha: float = 0.5,
                      max_boundaries: int = 15) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threshold-mode SceneTilling (reference self_segment.py:33-39).

    Boundaries where depth > mean + alpha * std; when more than ``mk`` =
    min(max_boundaries, T-1) fire, the top-``mk`` depths instead. The final
    frame T-1 follows the valid prefix.

    Returns bounds (max_boundaries + 1,) int32, sorted valid entries first and
    padded with T-1, and valid (max_boundaries + 1,) bool.
    """
    t = features.shape[0]
    bounds, n_valid = threshold_bounds(depth_scores(_frame_sims(features)), alpha,
                                       max_boundaries, t - 1)
    slot = torch.arange(max_boundaries + 1, dtype=torch.int32, device=features.device)
    return bounds, slot <= n_valid


def segment_left(features: torch.Tensor, alpha: float = 0.5,
                 max_boundaries: int = 15) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming (causal) segmentation (reference self_segment.py:77-118).

    The threshold rule over the left depth scores, no final-frame append
    unless nothing fires (then the one valid entry is T-1).

    Returns (bounds, valid), both (max_boundaries,).
    """
    t = features.shape[0]
    depths = left_depth_scores(_frame_sims(features))
    cond = _threshold(depths, alpha)
    n_fired = torch.sum(cond)
    mk = min(max_boundaries, depths.shape[0])
    fired_sorted = _fired_sorted(cond, mk, max_boundaries, t - 1)
    slot = torch.arange(max_boundaries, dtype=torch.int32, device=features.device)
    bounds = torch.where(slot < n_fired, fired_sorted, t - 1).to(torch.int32)
    valid = torch.where(n_fired == 0, slot == 0, slot < torch.clamp(n_fired, max=mk))
    return bounds, valid


def segment_plan(bounds: torch.Tensor, max_frames: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static (S, F) frame-subsample plan of the segments ending at ``bounds``.

    idx[s, j] = start_s + trunc(j * (bounds_s - start_s) / max(nf-1, 1)) in
    f32, nf = min(F, segment length); returns (idx int64, mask bool).
    """
    starts = torch.cat([bounds.new_zeros(1), bounds[:-1] + 1])
    length = bounds - starts + 1
    nf = torch.clamp(length, max=max_frames)
    denom = torch.clamp(nf - 1, min=1).float()
    j = torch.arange(max_frames, dtype=torch.float32, device=bounds.device)[None, :]
    span = (bounds - starts).float()[:, None]
    step = span / denom[:, None]
    idx = (starts.float()[:, None] + j * step).to(torch.int32)
    mask = torch.arange(max_frames, device=bounds.device)[None, :] < nf[:, None]
    hi = torch.clamp(bounds[-1], min=0)
    idx = torch.where(mask, idx, torch.minimum(torch.clamp(idx, min=0), hi))
    return idx.long(), mask
