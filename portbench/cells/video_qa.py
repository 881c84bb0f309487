"""The ``video_qa`` generator's cells: questions about clips, served by the
paged serving engine. The mix's ``arrivals`` say how requests come:

- ``closed``: ``clients`` clients, each sending its next request when its
  last answer is back;
- ``backlog``: a queue kept longer than the slots, taken in order;
- ``open``: requests due at fixed times from the window's start, gaps drawn
  from an exponential of ``rate_per_s`` (the same gaps for every seed, in
  another order), each ``burst`` request brought forward to the one before.
  A request's time to its first token runs from its due time.

The window times requests on the host clock: submit (or due), the first
token's commit (the engine's ``on_token`` hook), completion. Every step call
is a span; a step in which some request got its first token admitted it, and
the tokens a step committed are read from the engine's slot table (each
request's token count before and after the call). What the traced part of
the window did (tower encodes, each decode step's slot lengths) is kept as
facts for the roofline work counts.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from portbench import gen, work
from portbench.harness import Spans, log, now, traced_window


@dataclass
class Served:
    plan: gen.VideoRequest
    submitted: float = 0.0
    first: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    token_times: List[float] = field(default_factory=list)
    done: Optional[float] = None
    error: Optional[str] = None
    req: object = None


@dataclass
class StepRecord:
    t0: float
    t1: float
    k: int
    admitted: List[int]                 # request indices that got their first token
    committed: Dict[int, int]           # request index -> tokens committed in the step (slot table)
    before: Dict[int, int]              # request index -> tokens it had before the step
    traced: int = 0                     # the traced part it belongs to, 0 for none


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans: Spans):
        from portbench.models import build_videollamb

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.spans = spans
        self.model, self.mcfg, self.weights = build_videollamb(cfg, seed, device)
        self.tokens_per_frame = cfg["bridge"]["pool_h"] * cfg["bridge"]["pool_w"]
        self.dtype = getattr(torch, cfg["dtype"])
        eng = traffic["engine"]
        self.k = eng["step_k"]
        self.engine = self._engine(eng)
        self.pages_per_seq = self.engine.pages_per_seq
        self.served: Dict[int, Served] = {}
        self.steps: List[StepRecord] = []
        self.next_index = 0
        self.arrivals = traffic["arrivals"]
        if self.arrivals["kind"] not in ("closed", "backlog", "open"):
            raise ValueError(f"arrivals {self.arrivals['kind']!r}: closed, backlog or open")

    # ------------------------------------------------------------------ requests
    def _engine(self, eng: dict):
        from videollamb_torch.serve.paged import PagedServingEngine

        return PagedServingEngine(self.model, self.mcfg, num_slots=eng["slots"],
                                  quantize_kv=eng["pages"] == "int8", eos_token_id=-1,
                                  seed=self.seed % (2 ** 31))

    def plan(self, i: int) -> gen.VideoRequest:
        return gen.video_request(self.traffic, self.seed, i, self.cfg["lm"]["vocab_size"],
                                 self.tokens_per_frame)

    def clip(self, plan: gen.VideoRequest) -> torch.Tensor:
        return gen.make_clip(plan, self.traffic, self.cfg["vision"]["image_size"], self.device,
                             self.dtype)

    def _request(self, plan: gen.VideoRequest, uid) -> Served:
        from videollamb_torch.models.assembly import MultimodalBatch
        from videollamb_torch.serve.server import Request

        rec = Served(plan=plan)
        ids = torch.tensor([plan.ids], dtype=torch.long, device=self.device)
        batch = MultimodalBatch(input_ids=ids, attention_mask=torch.ones_like(ids),
                                videos=self.clip(plan)[None])

        def on_token(_req, tok, rec=rec):
            t = now()
            if rec.first is None:
                rec.first = t
            rec.tokens.append(int(tok))
            rec.token_times.append(t)

        rec.req = Request(uid=uid, batch=batch, max_new_tokens=plan.answer_tokens,
                          on_token=on_token)
        return rec

    def submit(self, i: Optional[int] = None, plan: Optional[gen.VideoRequest] = None,
               due: Optional[float] = None) -> Served:
        if plan is None:
            plan = self.plan(i)
        uid = plan.index
        rec = self._request(plan, uid)
        rec.submitted = now() if due is None else due
        self.served[uid] = rec
        self.engine.submit(rec.req)
        return rec

    def _slot_tokens(self) -> Dict[int, int]:
        """Token counts of the requests in the engine's slot table."""
        return {r.uid: len(r.tokens) for r in self.engine.slots if r is not None}

    def step(self, traced: int = 0) -> StepRecord:
        before = self._slot_tokens()
        with self.spans.span("engine.step") as sp:
            finished = self.engine.step(self.k)
        t = now()
        after = self._slot_tokens()
        for req in finished:
            after[req.uid] = len(req.tokens)
            rec = self.served.get(req.uid)
            if rec is not None and rec.done is None:
                rec.done = t
                rec.error = req.error
        committed = {uid: n - before.get(uid, 0) for uid, n in after.items()
                     if n > before.get(uid, 0)}
        admitted = [uid for uid in committed if before.get(uid, 0) == 0]
        rec = StepRecord(sp.t0, sp.t1, self.k, admitted, committed,
                         {uid: before.get(uid, 0) for uid in committed}, traced=traced)
        self.steps.append(rec)
        return rec

    # ------------------------------------------------------------------ set-up
    def warm_up(self) -> None:
        """The shapes of the cell's traffic: for a backlog the first slots' worth
        of requests admitted and a step decoded; otherwise one request of each
        frame count at the mix's longest answer."""
        if self.arrivals["kind"] == "backlog":
            for _ in range(self.traffic["engine"]["slots"]):
                self.submit(self.next_index)
                self.next_index += 1
            self.step()
        else:
            for n, frames in enumerate(sorted(set(self.traffic["frames"]), reverse=True)):
                self.submit(plan=gen.warm_request(self.traffic, self.seed, n, frames,
                                                  self.cfg["lm"]["vocab_size"],
                                                  self.tokens_per_frame))
                while self.engine.has_work():
                    self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.steps.clear()

    # ------------------------------------------------------------------ the window
    def _top_up(self, t_start: float, due: List[float]) -> None:
        """Submit what the arrivals ask for before the next step."""
        kind = self.arrivals["kind"]
        if kind == "closed":
            busy = sum(1 for r in self.served.values() if r.done is None)
            for _ in range(self.arrivals["clients"] - busy):
                self.submit(self.next_index)
                self.next_index += 1
        elif kind == "backlog":
            while self.engine.pending.qsize() < self.traffic["engine"]["slots"]:
                self.submit(self.next_index)
                self.next_index += 1
        else:
            while t_start + due[self.next_index] <= now():
                self.submit(self.next_index, due=t_start + due[self.next_index])
                self.next_index += 1
            if not self.engine.has_work():  # idle until the next request is due
                time.sleep(max(0.0, min(t_start + due[self.next_index] - now(), 0.01)))

    def window(self, seconds: float, trace_seconds: float = 0.0) -> dict:
        """Drive the cell for ``seconds``; with ``trace_seconds`` the profiler
        covers the whole steps from ``trace_seconds`` before the close, and
        the window runs on until it has covered that long."""
        due = (gen.arrival_offsets(self.arrivals, self.seed, self.traffic["block"], seconds)
               if self.arrivals["kind"] == "open" else [])

        def one(t_start, traced):
            self._top_up(t_start, due)
            if self.engine.has_work():
                self.step(traced)

        return traced_window(one, seconds, trace_seconds, self.spans, self.device)

    def free(self) -> None:
        """Drop the engine (its page pool and queues) and the requests' engine
        records; the weights stay for the reference."""
        self.engine = None
        for rec in self.served.values():
            rec.req = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def finish(self, t_start: float, t_end: float, control: bool = False):
        """Once the window has closed: free the engine, run the reference over a
        sample drawn from the seed of the requests the window finished (the
        longest among them), and return the compared numbers and what else
        was read. With ``control`` the float8 control stands in the program's
        place: its number is the gap of the token the control puts first."""
        done = self.in_window(t_start, t_end)
        sample = sample_for_check(self.finished_in(t_start, t_end), self.seed,
                                  self.traffic["check"]["requests"])
        self.free()
        out = check(self, sample, precision_control=control)
        numbers = {"logit_gap_max": out["control_gap_max"] if control else out["logit_gap_max"],
                   "requests_short": requests_short(sample)}
        info = {"prompt_lengths": [r.plan.prompt_len for r in done],
                "checked_prompt_lengths": out["prompt_lens"], "gaps": out["gaps"],
                "off_plan": out["off_plan"], "bounds_margin_min": out["bounds_margin_min"],
                "tokens_checked": out["tokens_checked"], "reference_s": out["reference_s"],
                "program": {"logit_gap_max": out["logit_gap_max"]}}
        if control:
            info["control_gaps"] = out["control_gaps"]
        return numbers, info

    # ------------------------------------------------------------------ numbers
    def in_window(self, t_start: float, t_end: float) -> List[Served]:
        """Requests submitted and completed inside the window (TTFT's population)."""
        return [r for r in self.served.values() if r.plan.index >= 0
                and r.done is not None and t_start <= r.submitted and r.done <= t_end]

    def finished_in(self, t_start: float, t_end: float) -> List[Served]:
        """Requests whose answers were completed inside the window."""
        return [r for r in self.served.values() if r.plan.index >= 0
                and r.done is not None and t_start <= r.done <= t_end]

    def tokens_in(self, t_start: float, t_end: float) -> int:
        return sum(1 for r in self.served.values() for t in r.token_times
                   if t_start <= t <= t_end)

    def attempted(self, t_start: float, t_end: float):
        touched = [r for r in self.served.values() if r.plan.index >= 0 and (
            any(t_start <= t <= t_end for t in r.token_times)
            or (r.done is not None and t_start <= r.done <= t_end))]
        return len(touched), sum(1 for r in touched if r.error)

    def model_ops(self, t_start: float, t_end: float) -> float:
        """Operations of the work the window completed: every admission in it
        (tower, bridge, prefill) and every token committed in it."""
        ops = 0.0
        lm = self.cfg["lm"]
        for st in self.steps:
            if not (t_start <= st.t0 and st.t1 <= t_end):
                continue
            for uid in st.admitted:
                p = self.served[uid].plan
                ops += work.videollamb_admission_ops(self.cfg, p.frames, p.prompt_len)
            for uid, n in st.committed.items():
                p = self.served[uid].plan
                c0 = st.before[uid]
                ops += sum(work.decode_ops(lm, p.prompt_len + c) for c in range(c0, c0 + n))
        return ops

    def trace_facts(self, part: int) -> dict:
        """Tower encodes and decode-step slot lengths of the steps of traced part ``part``."""
        vis = self.cfg["vision"]
        layers = vis["num_hidden_layers"] + vis["select_layer"] + 1
        encodes, lengths = [], []
        for st in self.steps:
            if st.traced != part:
                continue
            for uid in st.admitted:
                encodes.append((self.served[uid].plan.frames, layers))
            slot_len = [self.served[uid].plan.prompt_len + st.before[uid]
                        for uid in st.committed]
            pad = self.traffic["engine"]["slots"] - len(slot_len)
            for j in range(st.k):
                lengths.append([x + j for x in slot_len] + [0] * pad)
        return {"encodes": encodes, "decode_lengths": lengths,
                "pages_per_seq": self.pages_per_seq}


def sample_for_check(done: List[Served], seed: int, n: int) -> List[Served]:
    """The request with the most served tokens (then the most frames), and
    others drawn from the seed, n in all."""
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), r.plan.frames, -r.plan.index))
    rest = [r for r in done if r is not longest]
    rng = gen._rng(seed, 3)
    pick = [rest[j] for j in rng.permutation(len(rest))[:max(0, n - 1)]]
    return [longest] + sorted(pick, key=lambda r: r.plan.index)


def check(cell: Cell, sample: List[Served], precision_control: bool = False) -> dict:
    """The reference over each sampled request's prompt and served tokens.

    Returns the widest gap by which a served token's logit lies below the
    reference's best (and, with ``precision_control``, the widest gap of the
    token the float8 control puts first), the requests whose scene bounds
    left the plan, and the reference's seconds."""
    from portbench.reference.linear import Weights, no_tf32
    from portbench.reference.videollamb import score_request

    no_tf32()
    t0 = now()
    keep = ("video_tower", "mm_projector")
    ref = Weights(cell.weights, "f32", keep=keep)
    ctl = Weights(cell.weights, "fp8", keep=keep) if precision_control else None
    gaps, ctl_gaps, off_plan, plens, bounds, margins = [], [], 0, [], [], []
    for r in sample:
        clip = cell.clip(r.plan)
        with torch.no_grad():
            s = score_request(ref, cell.cfg, r.plan.ids, clip, r.tokens)
            best = s.logits.max(dim=-1).values
            served = s.logits.gather(1, torch.tensor(r.tokens, device=s.logits.device)[:, None])[:, 0]
            gaps.append(float((best - served).max()))
            if ctl is not None:
                c = score_request(ctl, cell.cfg, r.plan.ids, clip, r.tokens)
                first = c.logits.argmax(dim=-1)
                ctl_gaps.append(float((best - s.logits.gather(1, first[:, None])[:, 0]).max()))
        plens.append(s.prompt_len)
        bounds.append(s.bounds)
        margins.append(s.margin)
        if s.bounds != gen.expected_bounds(r.plan) or s.prompt_len != r.plan.prompt_len:
            off_plan += 1
            log(f"[check] request {r.plan.index}: reference bounds {s.bounds} prompt "
                f"{s.prompt_len}; planned {gen.expected_bounds(r.plan)} {r.plan.prompt_len}")
    out = {"logit_gap_max": max(gaps) if gaps else float("inf"),
           "requests_checked": len(sample),
           "tokens_checked": sum(len(r.tokens) for r in sample),
           "off_plan": off_plan, "reference_s": now() - t0,
           "gaps": gaps, "prompt_lens": plens, "bounds": bounds,
           "bounds_margin_min": min(margins) if margins else None}
    if ctl is not None:
        out["control_gap_max"] = max(ctl_gaps) if ctl_gaps else float("inf")
        out["control_gaps"] = ctl_gaps
    return out


def requests_short(sample: List[Served]) -> int:
    """Sampled requests dropped or answered with fewer or more tokens than planned."""
    return sum(1 for r in sample if r.error is not None or len(r.tokens) != r.plan.answer_tokens)

