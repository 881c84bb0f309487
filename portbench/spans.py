"""The program's own spans (``videollamb_torch/utils/profiling.py``), as the
per-layer readers see them.

Every time here is a host time: a span closes once the host has queued its
work, and the device may still be running it. A reader returns None where
the program has no recorder, or recorded none of the spans it reads.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def program_records(t0: float = float("-inf"), t1: float = float("inf")) -> Optional[list]:
    """The recorder's records between ``t0`` and ``t1``; None without a recorder."""
    try:
        from videollamb_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    return RECORDER.records(t0, t1)


def in_steps(view, steps) -> Optional[list]:
    """The records lying wholly inside one of ``steps`` (the benchmark's step spans)."""
    recs = program_records(view.t_start, view.t_end)
    if recs is None:
        return None
    return [r for r in recs if any(s.t0 <= r.t0 and r.t1 <= s.t1 for s in steps)]


def _admitted(view):
    """The untraced steps that admitted a request, and the requests' uids."""
    steps = [s for s in view.steps(untraced=True) if s.admitted]
    return steps, {uid for s in steps for uid in s.admitted}


def per_request_ms(view, name: str) -> Optional[float]:
    """Mean host ms of ``name`` spans per request that an untraced step admitted."""
    steps, uids = _admitted(view)
    recs = in_steps(view, steps) if steps else None
    if not recs or not any(r.name == name for r in recs):
        return None
    ms: Dict[object, float] = {uid: 0.0 for uid in uids}
    for r in recs:
        if r.name == name and r.uid in ms:
            ms[r.uid] += 1e3 * (r.t1 - r.t0)
    return statistics.fmean(ms.values())


def first_token_wait_ms(view) -> Optional[float]:
    """Median, over the requests that untraced steps admitted, of the host ms
    from the end of the request's ``admit.prefill`` to its
    ``request.first_token`` mark."""
    steps, uids = _admitted(view)
    recs = in_steps(view, steps) if steps else None
    if not recs:
        return None
    prefill_end: Dict[object, float] = {}
    first: Dict[object, float] = {}
    for r in recs:
        if r.uid not in uids:
            continue
        if r.name == "admit.prefill":
            prefill_end[r.uid] = max(prefill_end.get(r.uid, r.t1), r.t1)
        elif r.name == "request.first_token":
            first.setdefault(r.uid, r.t0)
    waits: List[float] = [1e3 * (first[u] - prefill_end[u]) for u in first if u in prefill_end]
    return statistics.median(waits) if waits else None


def per_decode_step_ms(view, name: str) -> Optional[float]:
    """Host ms in ``name`` spans per decode step, over the untraced steps
    that admitted nothing (``decode_step_ms.sweep``'s population)."""
    steps = [s for s in view.steps(untraced=True) if not s.admitted]
    recs = in_steps(view, steps) if steps else None
    if not recs or not any(r.name == name for r in recs):
        return None
    total = sum(r.t1 - r.t0 for r in recs if r.name == name)
    return 1e3 * total / sum(s.k for s in steps)


def kernel_load_s(view) -> Optional[float]:
    """Seconds of this process's ``kernels.load`` span (the kernel library
    loaded, and built where ``kernels.compile`` ran inside it)."""
    recs = program_records()
    loads = [r for r in recs or () if r.name == "kernels.load"]
    return loads[0].t1 - loads[0].t0 if loads else None
