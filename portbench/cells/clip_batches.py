"""The ``clip_batches`` generator's cells: LanguageBind video embeddings of
clip batches, back to back, as ``/v1/embeddings`` computes them
(``binding_encode_modality``).

The host keeps at most two batches queued ahead of the device (an event per
batch), so the window's end waits for little, and every output is kept to
be compared once the window has closed.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Tuple

import torch

from portbench import gen
from portbench.harness import Spans, now, traced_window

LOOKAHEAD = 2


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans: Spans):
        from portbench.models import build_languagebind

        self.cfg, self.traffic, self.seed, self.device, self.spans = cfg, traffic, seed, device, spans
        self.model, self.vcfg, self.weights = build_languagebind(cfg, seed, device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.batches = gen.index_batches(traffic, seed, cfg["vision"]["image_size"], device,
                                         self.dtype)
        self.outputs: List[Tuple[int, torch.Tensor]] = []
        self.traced_encodes: Dict[int, int] = {}  # traced part -> encodes in it

    def encode(self, i: int) -> torch.Tensor:
        from videollamb_torch.models.binding import binding_encode_modality

        return binding_encode_modality(self.model, "video", self.batches[i], self.vcfg)

    def warm_up(self) -> None:
        self.encode(0)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, trace_seconds: float = 0.0) -> dict:
        events: List[torch.cuda.Event] = []
        state = {"i": 0}

        def one(_t_start, traced):
            j = state["i"] % len(self.batches)
            with self.spans.span("encode"):
                out = self.encode(j)
                if self.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                    events.append(ev)
                    if len(events) > LOOKAHEAD:
                        events[-LOOKAHEAD - 1].synchronize()
            self.outputs.append((j, out))
            if traced:
                self.traced_encodes[traced] = self.traced_encodes.get(traced, 0) + 1
            state["i"] += 1

        return traced_window(one, seconds, trace_seconds, self.spans, self.device)

    def attempted(self, t_start: float, t_end: float):
        return len(self.outputs), 0

    def frames_done(self) -> int:
        return len(self.outputs) * self.traffic["batch"] * self.traffic["frames"]

    def model_ops(self, t_start: float, t_end: float) -> float:
        """Operations of every clip the window embedded."""
        from portbench import work

        clips = len(self.outputs) * self.traffic["batch"]
        return clips * work.embed_clip_ops(self.cfg, self.traffic["frames"])

    def trace_facts(self, part: int) -> dict:
        frames = self.traffic["batch"] * self.traffic["frames"]
        layers = self.cfg["vision"]["num_hidden_layers"]
        return {"encodes": [(frames, layers)] * self.traced_encodes.get(part, 0)}

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def finish(self, t_start: float, t_end: float, control: bool = False):
        """Once the window has closed: every output against the reference, the
        compared number and what else was read. With ``control`` the float8
        control's embeddings stand in the program's place."""
        self.free()
        out = check(self, precision_control=control)
        key = "control_rel_err_max" if control else "embed_rel_err_max"
        return ({"embed_rel_err_max": out[key]},
                {"outputs_checked": out["outputs_checked"], "reference_s": out["reference_s"],
                 "program": {"embed_rel_err_max": out["embed_rel_err_max"]}})


def check(cell: Cell, precision_control: bool = False) -> dict:
    """Every output of the window against the reference embedding of its
    batch: the largest relative error of a row, ||e - r|| / ||r||."""
    from portbench.reference.languagebind import embed_video
    from portbench.reference.linear import Weights, no_tf32

    no_tf32()
    t0 = now()
    ref_w = Weights(cell.weights, "f32", keep=("modalities",))
    refs = []
    ctl_err = []
    with torch.no_grad():
        for j, batch in enumerate(cell.batches):
            r = torch.cat([embed_video(ref_w, cell.cfg, batch[b:b + 8])
                           for b in range(0, batch.shape[0], 8)])
            refs.append(r)
        if precision_control:
            ctl_w = Weights(cell.weights, "fp8", keep=("modalities",))
            for j, batch in enumerate(cell.batches):
                c = torch.cat([embed_video(ctl_w, cell.cfg, batch[b:b + 8])
                               for b in range(0, batch.shape[0], 8)])
                ctl_err.append(float(_rel(c, refs[j]).max()))
        worst = 0.0
        for j, out in cell.outputs:
            worst = max(worst, float(_rel(out.float(), refs[j]).max()))
    res = {"embed_rel_err_max": worst if cell.outputs else float("inf"),
           "outputs_checked": len(cell.outputs), "reference_s": now() - t0}
    if precision_control:
        res["control_rel_err_max"] = max(ctl_err)
    return res


def _rel(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a - r, dim=-1) / torch.linalg.vector_norm(r, dim=-1)
