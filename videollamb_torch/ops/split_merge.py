"""Merge counters of the key-split paged decode kernels (K4 and K6).

Both kernels split each slot's keys across blocks and merge the blocks'
partials in the same launch (``csrc/split_merge.cuh``): every block of a
(slot, kv head) adds one to that pair's counter after writing its partial,
and the block that arrives last merges them and sets the counter back to
zero. So a launch finds its counters zero and leaves them zero (a launch
that faults ends the CUDA context, counters and all), and launches in order
on one stream can share one buffer, whichever of the two kernels they run.
"""

from __future__ import annotations

import torch

_COUNTERS = {}  # (device, stream handle) -> merge counters, zero between launches


def merge_counters(device: torch.device, n: int) -> torch.Tensor:
    """``n`` int32 counters, zero, for one launch's merge: one per (slot, kv
    head).

    Calls on one stream run in order and share one buffer, kept from call to
    call so that a call is one launch; calls on another stream get their
    own. A call captured into a CUDA graph gets counters of its own,
    zeroed by a memset node of the graph, from the graph's memory pool, so
    no later call can free or share them under the graph."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < n:
        counters = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return counters
