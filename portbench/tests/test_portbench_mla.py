"""The ``video_qa_mla`` cells at tiny widths on the CPU: a run is correct
and reads its per-layer metrics; a routing fault makes it incorrect; the
work counts of ``work_mla.py`` against the configuration's parameters."""

import copy
import json

import pytest
import torch

from portbench import run, work_mla
from portbench.harness import benchmark, limits_path, load_json
from portbench.models import load_config
from portbench.tests import tiny

WL = "moonlight16b-caption-64slots"


def tiny_mla_cfg() -> dict:
    cfg = load_config("videollamb-moonlight-16b-a3b")
    base = tiny.videollamb_cfg()
    cfg.update(dtype="float32", max_length=512, vision=base["vision"], bridge=base["bridge"])
    cfg["lm"].update(vocab_size=256, hidden_size=64, intermediate_size=128,
                     moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
                     kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
                     n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2)
    return cfg


def _run(capsys, trace: bool) -> dict:
    res = run.run_cell(benchmark(), tiny.cell(WL), tiny_mla_cfg(), tiny.traffic(WL),
                       load_json(limits_path(WL)), tiny.SEED, 2.0, trace, torch.device("cpu"))
    assert res is not None
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_tiny_run_is_correct_and_reads_its_metrics(capsys):
    line = _run(capsys, trace=False)
    assert line["correct"] is True, line
    assert set(line["metrics"]) == {"output_tokens_per_s", "setup_s"}
    line = _run(capsys, trace=True)
    assert line["correct"] is True, line
    assert "moonlight_mfu" in line["metrics"]


def test_a_routing_fault_is_not_correct(capsys, monkeypatch):
    """The program routing each token to its least-scored experts serves other tokens."""
    from videollamb_torch.models.lm import mla

    def least(moe, cfg, h):
        scores = torch.sigmoid(torch.nn.functional.linear(h.float(), moe.gate.weight.float()))
        choice = torch.topk(-scores, cfg.num_experts_per_tok, dim=-1).indices
        w = scores.gather(1, choice)
        return choice, w / w.sum(dim=-1, keepdim=True) * cfg.routed_scaling_factor

    monkeypatch.setattr(mla, "route", least)
    cfg = tiny_mla_cfg()
    mix = copy.deepcopy(tiny.traffic(WL))
    res = run.run_cell(benchmark(), tiny.cell(WL), cfg, mix, load_json(limits_path(WL)),
                       tiny.SEED, 2.0, False, torch.device("cpu"))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res is not None and line["correct"] is False, line


def test_work_counts_against_the_parameters():
    """A decoded token's products are twice its active parameters (attention
    absorbed); the expert roofline counts weights once per touched forward."""
    lm = load_config("videollamb-moonlight-16b-a3b")["lm"]
    d, inter, e = lm["hidden_size"], lm["moe_intermediate_size"], lm["n_routed_experts"]
    active = (lm["num_hidden_layers"] * (d * 16 * 192 + d * 576 + 16 * 128 * d)
              + 3 * d * lm["intermediate_size"]
              + 26 * (d * e + 6 * 3 * d * inter + 2 * 3 * d * inter))
    absorbed = 27 * 16 * 512 * 256
    assert work_mla.token_ops(lm, absorbed=True) == pytest.approx(2 * (active + absorbed))
    import numpy as np

    load = np.zeros((2, 26, e), dtype=np.int64)
    load[0, :, :6] = 10
    load[1, :, :6] = 1
    ops, nbytes = work_mla.experts({"expert_load": [load]}, {"lm": lm})
    assert ops == pytest.approx(26 * 60 * 6 * d * inter)
    assert nbytes >= 26 * 6 * 3 * d * inter * 2
