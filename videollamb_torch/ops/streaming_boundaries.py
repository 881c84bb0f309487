"""Fixed-shape, O(1)-per-tick SceneTilling boundary detection for streams.

Port of ``videollamb_tpu/ops/streaming_boundaries.py``. The detection state
lives on the stream's device in buffers whose shapes never change:

- ``cls_buf`` (cap, d): the last ``cap`` frame CLS embeddings;
- ``sims`` (cap-1,): adjacent-frame cosine similarities, each computed once,
  when its right frame arrives; invalid slots hold -inf;
- the frame count ``n`` (host int).

Each frame runs one step over the whole masked buffer: write the CLS, fill
``sims[n-1]``, and apply the threshold rule of ``segment_threshold``
(``ops/scene_tilling.threshold_bounds``, reference self_segment.py:33-39)
to the valid prefix. Masking the invalid similarities to -inf cuts both
monotone-run scans exactly at the valid frontier (a -inf never extends a
non-decreasing run), so the bounds equal ``segment_threshold`` over the frames seen, as long as they fit the
window. Streams longer than ``cap`` slide the window by ``cap // 2``;
bounds stay absolute through ``base``, and the mean and std then cover the
window, not all history.

The JAX package keeps a two-entry compile cache for the stream (step and
slide); the port has no compiler, and what that cache stood for is the
buffers' fixed shapes, which the step and the slide never change.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from videollamb_torch.ops.scene_tilling import depth_scores, threshold_bounds

_NEG = float("-inf")


def _boundary_step(cls_buf: torch.Tensor, sims: torch.Tensor, n: int, new_cls: torch.Tensor,
                   alpha: float = 0.5, max_boundaries: int = 15
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ingest one frame into the window holding ``n`` frames (in place).

    Returns (cls_buf, sims, bounds, n_valid): ``bounds`` (max_boundaries + 1,)
    int32 packs like ``segment_threshold``: sorted fired positions (or the
    top-k when more than ``max_boundaries`` fire), then the final frame index
    n, which also pads; entries [0, n_valid] are the meaningful prefix.
    """
    cap = cls_buf.shape[0]
    new_cls = new_cls.to(cls_buf.dtype)
    prev = cls_buf[max(n - 1, 0)].float()
    cls_buf[n] = new_cls
    if n > 0:
        eps = 1e-8
        cur = new_cls.float()
        na = torch.clamp(torch.linalg.norm(prev), min=eps)
        nb = torch.clamp(torch.linalg.norm(cur), min=eps)
        sims[n - 1] = torch.sum(prev * cur) / (na * nb)

    m = n  # valid similarities, with n + 1 frames now resident
    live = torch.arange(cap - 1, device=sims.device) < m
    # depth_scores over the -inf tail is NaN there (-inf + -inf + inf): mask
    # it back to -inf before the threshold rule, as the JAX step does.
    depths = torch.where(live, depth_scores(torch.where(live, sims, _NEG)), _NEG)
    bounds, n_valid = threshold_bounds(depths, alpha, max_boundaries, n, n_live=m)
    return cls_buf, sims, bounds, n_valid


def _slide(cls_buf: torch.Tensor, sims: torch.Tensor, shift: int):
    """Drop the oldest ``shift`` frames. sims[j] is the (frame j, frame j+1)
    similarity, so it shifts by as much; the vacated tail becomes -inf."""
    cls_buf = torch.roll(cls_buf, -shift, dims=0)
    sims = torch.roll(sims, -shift)
    sims[sims.shape[0] - shift:] = _NEG
    return cls_buf, sims


class BoundaryDetector:
    """Absolute-index boundary detection with fixed-shape device buffers and
    one host read per frame."""

    def __init__(self, dim: int, cap: int = 512, alpha: float = 0.5,
                 max_boundaries: int = 15, dtype=torch.float32, device="cpu"):
        self.cap = cap
        self.alpha = alpha
        self.max_boundaries = max_boundaries
        self.base = 0  # absolute index of window slot 0
        self.n = 0  # frames in the window
        self.total = 0  # frames ever seen
        self.cls_buf = torch.zeros((cap, dim), dtype=dtype, device=device)
        self.sims = torch.full((cap - 1,), _NEG, dtype=torch.float32, device=device)
        self._bounds: List[int] = [0]

    def add_frame(self, cls_vec) -> None:
        if self.n >= self.cap:
            shift = self.cap // 2
            self.cls_buf, self.sims = _slide(self.cls_buf, self.sims, shift)
            self.base += shift
            self.n -= shift
        cls_vec = torch.as_tensor(cls_vec, device=self.cls_buf.device)
        self.cls_buf, self.sims, bounds, n_valid = _boundary_step(
            self.cls_buf, self.sims, self.n, cls_vec, self.alpha, self.max_boundaries)
        self.n += 1
        self.total += 1
        # One read: the count, then the bounds.
        host = torch.cat([n_valid.reshape(1).to(torch.int32), bounds]).tolist()
        self._bounds = [b + self.base for b in host[1: host[0] + 2]]

    def boundaries(self) -> List[int]:
        """Fired positions (absolute frame indices) and the final frame;
        [total-1] while fewer than 3 frames have been seen."""
        if self.total < 3:
            return [max(self.total - 1, 0)]
        return self._bounds

    @property
    def state_shapes(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(cls_buf, sims) shapes: fixed for the life of the stream."""
        return tuple(self.cls_buf.shape), tuple(self.sims.shape)
