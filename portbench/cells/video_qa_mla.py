"""The ``video_qa_mla`` generator's cells: the ``video_qa`` traffic served by
the paged engine over a DeepSeek-V3-family LM (latent attention, routed and
shared experts), as ``serve/batch_cli.py --paged`` serves a VideoLLaMB
checkpoint whose config.json says ``model_type: deepseek_v3``.

What differs from ``video_qa``:

- the model is built with ``videollamb_torch.models.lm.mla``'s LM; each MoE
  layer's experts live in one stacked tensor, so the weights are drawn per
  storage (the stacked experts, every other parameter), one uniform draw
  each from one generator seeded by the run's seed, scaled by the same
  classes as ``models.fill_seeded`` (the router's weight a product, variance
  1 / fan-in; ``e_score_correction_bias`` a bias, U(-0.02, 0.02));
- after every step call the engine's expert counters are read (one copy
  from the device, between steps) and kept on the step's record as the
  step's difference: tokens routed to each expert of each MoE layer, and
  the forwards in which each had a token;
- operations count the latent attention absorbed in decode and unabsorbed
  in prefill, the routed and shared experts (``portbench/work_mla.py``);
- the check runs ``reference/mla_moe.py``; the compared number is the mean,
  over every served token, of the gap by which its logit lies below the
  reference's best (the widest gap is reported beside it), and the check
  reports how near the reference's routing came to ties.

A configuration whose LM is of the Llama family is served by ``video_qa``;
this generator refuses it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import gen, work_mla
from portbench.cells import video_qa
from portbench.harness import log, now
from portbench.models import _fields, _scale_class


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a latent-attention configuration file."""
    if "kv_lora_rank" not in cfg["lm"]:
        raise ValueError("video_qa_mla serves the DeepSeek-V3 family (an LM with "
                         "kv_lora_rank); a Llama-family configuration takes video_qa")
    from videollamb_torch.config import BridgeConfig, MLAConfig, ModelConfig, VisionConfig

    return ModelConfig(vision=VisionConfig(**_fields(VisionConfig, cfg["vision"])),
                       bridge=BridgeConfig(**_fields(BridgeConfig, cfg["bridge"])),
                       lm=MLAConfig(**_fields(MLAConfig, cfg["lm"])),
                       max_length=cfg["max_length"], num_frames=cfg["vision"]["num_frames"],
                       dtype=cfg["dtype"])


def fill_seeded(module: torch.nn.Module, stacks, seed: int):
    """Every parameter of ``module`` drawn from one generator seeded by
    ``seed``: one uniform draw per storage (each stacked expert tensor, each
    other parameter), in the order of their scale classes, then scaled.
    Returns the parameters by state-dict name."""
    params = dict(module.named_parameters())
    in_stack = {id(p) for _, members in stacks for _, p in members}
    roots = []  # (scale class, name, tensor)
    for stack, members in stacks:
        name, first = members[0]
        roots.append((_scale_class(name, tuple(first.shape)), name, stack))
    for n, p in params.items():
        if id(p) not in in_stack:
            roots.append((_scale_class(n, tuple(p.shape)), n, p.data))
    g = torch.Generator(device=next(iter(params.values())).device).manual_seed(seed % (2 ** 63))
    with torch.no_grad():
        for (offset, half), _, t in sorted(roots, key=lambda r: (r[0], r[1])):
            t.uniform_(-1.0, 1.0, generator=g).mul_(half)
            if offset:
                t.add_(offset)
    return {n: p.data for n, p in params.items()}


def build_videollamb_mla(cfg: dict, seed: int, device):
    """(VideoLLaMB over the latent-attention LM, its ModelConfig, weights by name)."""
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.rmt_r import RMTRBridge
    from videollamb_torch.models.lm.mla import empty_mla_lm, moe_blocks
    from videollamb_torch.models.vision.clip_vit import CLIPVisionTower

    mcfg = model_config(cfg)
    dtype = getattr(torch, cfg["dtype"])
    with torch.device("meta"):
        tower = CLIPVisionTower(mcfg.vision)
        bridge = RMTRBridge(mcfg.bridge, mcfg.lm.hidden_size)
    tower = tower.to(dtype=dtype).to_empty(device=device)
    bridge = bridge.to(dtype=dtype).to_empty(device=device)
    lm = empty_mla_lm(mcfg.lm, device, dtype)
    model = VideoLLaMB(tower, bridge, lm).eval()
    names = {id(p): n for n, p in model.named_parameters()}
    stacks = []  # (stacked tensor, [(name, view)]): a tensor hashes by identity
    for moe in moe_blocks(lm):
        w13, w2 = moe.stacked()
        stacks.append((w13, [(names[id(p)], p) for ex in moe.experts
                             for p in (ex.gate_proj.weight, ex.up_proj.weight)]))
        stacks.append((w2, [(names[id(ex.down_proj.weight)], ex.down_proj.weight)
                            for ex in moe.experts]))
    return model, mcfg, fill_seeded(model, stacks, seed)


class Cell(video_qa.Cell):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.spans = spans
        self.model, self.mcfg, self.weights = build_videollamb_mla(cfg, seed, device)
        self.tokens_per_frame = cfg["bridge"]["pool_h"] * cfg["bridge"]["pool_w"]
        self.dtype = getattr(torch, cfg["dtype"])
        eng = traffic["engine"]
        self.k = eng["step_k"]
        self.engine = self._engine(eng)
        self.pages_per_seq = self.engine.pages_per_seq
        self.served = {}
        self.steps = []
        self.next_index = 0
        self.arrivals = traffic["arrivals"]
        self._load = self.engine.expert_load()

    # ------------------------------------------------------------------ steps
    def step(self, traced: int = 0):
        rec = super().step(traced)
        load = self.engine.expert_load()
        rec.load = load - self._load
        self._load = load
        return rec

    # ------------------------------------------------------------------ numbers
    def model_ops(self, t_start: float, t_end: float) -> float:
        ops = 0.0
        lm = self.cfg["lm"]
        for st in self.steps:
            if not (t_start <= st.t0 and st.t1 <= t_end):
                continue
            for uid in st.admitted:
                p = self.served[uid].plan
                ops += work_mla.admission_ops(self.cfg, p.frames, p.prompt_len)
            for uid, n in st.committed.items():
                p = self.served[uid].plan
                c0 = st.before[uid]
                ops += sum(work_mla.decode_ops(lm, p.prompt_len + c) for c in range(c0, c0 + n))
        return ops

    def trace_facts(self, part: int) -> dict:
        facts = super().trace_facts(part)
        facts["expert_load"] = [st.load for st in self.steps if st.traced == part]
        return facts

    def finish(self, t_start: float, t_end: float, control: bool = False):
        done = self.in_window(t_start, t_end)
        sample = video_qa.sample_for_check(self.finished_in(t_start, t_end), self.seed,
                                           self.traffic["check"]["requests"])
        route = {"decode_replays": self.engine.decode_replays,
                 "decode_eager": self.engine.decode_eager,
                 "decode_captures": self.engine.decode_captures,
                 "kv_bytes_per_token": self.engine.kv_bytes_per_token}
        self.free()
        out = check(self, sample, precision_control=control)
        # The widest gap is reported, not compared: routing near-ties make it
        # separate bf16 from the float8 control by a few percent only (PERF.md §2).
        numbers = {"logit_gap_mean": out["control_gap_mean"] if control else out["logit_gap_mean"],
                   "requests_short": video_qa.requests_short(sample)}
        info = {"prompt_lengths": [r.plan.prompt_len for r in done],
                "checked_prompt_lengths": out["prompt_lens"], "gaps": out["gaps"],
                "off_plan": out["off_plan"], "bounds_margin_min": out["bounds_margin_min"],
                "route_margin_min": out["route_margin_min"],
                "route_near_ties": out["route_near_ties"], "route_choices": out["route_choices"],
                "tokens_checked": out["tokens_checked"], "reference_s": out["reference_s"],
                "engine": route, "program": {"logit_gap_max": out["logit_gap_max"],
                                             "logit_gap_mean": out["logit_gap_mean"]}}
        if control:
            info["control_gaps"] = out["control_gaps"]
            info["control"] = {"logit_gap_max": out["control_gap_max"],
                               "logit_gap_mean": out["control_gap_mean"]}
        return numbers, info


def check(cell: Cell, sample, precision_control: bool = False) -> dict:
    """``video_qa.check`` with ``reference/mla_moe.py``: the widest gap by which
    a served token's logit lies below the reference's best and the mean gap
    over every served token (and the float8 control's), and the reference's
    routing margins."""
    from portbench.reference import mla_moe
    from portbench.reference.linear import Weights, no_tf32

    no_tf32()
    t0 = now()
    keep = ("video_tower", "mm_projector")
    ref = Weights(cell.weights, "f32", keep=keep)
    ctl = Weights(cell.weights, "fp8", keep=keep) if precision_control else None
    gaps, ctl_gaps, off_plan, plens, margins = [], [], 0, [], []
    sums, ctl_sums = [], []  # every served token's gap, for the means
    route_min, near, choices = float("inf"), 0, 0
    for r in sample:
        clip = cell.clip(r.plan)
        with torch.no_grad():
            s = mla_moe.score_request(ref, cell.cfg, r.plan.ids, clip, r.tokens)
            best = s.logits.max(dim=-1).values
            served = s.logits.gather(
                1, torch.tensor(r.tokens, device=s.logits.device)[:, None])[:, 0]
            gap = best - served
            gaps.append(float(gap.max()))
            sums.append((float(gap.sum()), gap.numel()))
            if ctl is not None:
                c = mla_moe.score_request(ctl, cell.cfg, r.plan.ids, clip, r.tokens)
                first = c.logits.argmax(dim=-1)
                cgap = best - s.logits.gather(1, first[:, None])[:, 0]
                ctl_gaps.append(float(cgap.max()))
                ctl_sums.append((float(cgap.sum()), cgap.numel()))
        plens.append(s.prompt_len)
        margins.append(s.margin)
        route_min = min(route_min, s.routing.margin_min)
        near += s.routing.near_ties
        choices += s.routing.choices
        if s.bounds != gen.expected_bounds(r.plan) or s.prompt_len != r.plan.prompt_len:
            off_plan += 1
            log(f"[check] request {r.plan.index}: reference bounds {s.bounds} prompt "
                f"{s.prompt_len}; planned {gen.expected_bounds(r.plan)} {r.plan.prompt_len}")
    if choices:
        log(f"[check] routing: smallest 6th-over-7th margin {route_min!r}; {near} of {choices} "
            f"choices under {mla_moe.NEAR_TIE}")
    def mean(parts):
        n = sum(k for _, k in parts)
        return sum(t for t, _ in parts) / n if n else float("inf")

    out = {"logit_gap_max": max(gaps) if gaps else float("inf"), "logit_gap_mean": mean(sums),
           "tokens_checked": sum(len(r.tokens) for r in sample),
           "off_plan": off_plan, "reference_s": now() - t0, "gaps": gaps,
           "prompt_lens": plens, "bounds_margin_min": min(margins) if margins else None,
           "route_margin_min": route_min if choices else None, "route_near_ties": near,
           "route_choices": choices}
    if ctl is not None:
        out["control_gap_max"] = max(ctl_gaps) if ctl_gaps else float("inf")
        out["control_gap_mean"] = mean(ctl_sums)
        out["control_gaps"] = ctl_gaps
    return out


def expert_imbalance(view):
    """Over the window's untraced steps that admitted nothing, the mean across
    MoE layers of the busiest expert's routed tokens over the mean expert's."""
    loads = [s.load for s in view.steps(untraced=True)
             if not s.admitted and getattr(s, "load", None) is not None]
    if not loads:
        return None
    tokens = np.sum([ld[0] for ld in loads], axis=0).astype(np.float64)  # (layers, experts)
    mean = tokens.mean(axis=1)
    keep = mean > 0
    if not keep.any():
        return None
    return float(np.mean(tokens[keep].max(axis=1) / mean[keep]))
