"""The plain reference agrees with the port at tiny widths in float32, and
its float8 control does not."""

import torch

from portbench.cells import clip_batches, video_qa
from portbench.harness import Spans
from portbench.tests import tiny


def _serve(workload, seconds=4.0):
    torch.set_grad_enabled(False)
    cell = video_qa.Cell(tiny.videollamb_cfg(), tiny.traffic(workload), tiny.SEED,
                                torch.device("cpu"), Spans())
    cell.warm_up()
    win = cell.window(seconds)
    done = cell.in_window(win["t_start"], win["t_end"])
    sample = video_qa.sample_for_check(done, tiny.SEED, 3)
    cell.free()
    return sample, video_qa.check(cell, sample, precision_control=True)


def test_served_tokens_are_the_references_best():
    # f32 pages: greedy tokens are the reference's argmax up to rounding; int8
    # pages round each cached key and value to 1/254 of its row's largest.
    for workload, tol in (("mistral7b-mc-longvideo", 1e-4), ("mistral7b-sweep-24slots", 1e-2)):
        sample, out = _serve(workload)
        assert len(sample) >= 2 and video_qa.requests_short(sample) == 0
        assert out["logit_gap_max"] < tol
        assert out["control_gap_max"] >= 0.0


def test_the_control_rounds_every_product_to_float8():
    from portbench.reference.linear import Weights

    g = torch.Generator().manual_seed(0)
    w = {"l.weight": torch.randn(64, 128, generator=g), "l.bias": torch.zeros(64)}
    x = torch.randn(32, 128, generator=g)
    exact = Weights(w, "f32").linear(x, "l")
    low = Weights(w, "fp8").linear(x, "l")
    assert torch.equal(exact, x @ w["l.weight"].t())
    rel = float((low - exact).norm() / exact.norm())
    assert 0.01 < rel < 0.1  # e4m3 keeps 3 mantissa bits


def test_embeddings_match_the_reference_and_the_control_departs():
    torch.set_grad_enabled(False)
    cell = clip_batches.Cell(tiny.languagebind_cfg(), tiny.traffic("languagebind-video-index"),
                                tiny.SEED, torch.device("cpu"), Spans())
    cell.warm_up()
    cell.window(0.5)
    out = clip_batches.check(cell, precision_control=True)
    assert out["outputs_checked"] >= 1
    assert out["embed_rel_err_max"] < 1e-5
    assert out["control_rel_err_max"] > 100 * out["embed_rel_err_max"]
