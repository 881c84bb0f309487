"""A run with its timed path broken underneath comes out not correct: the
card check skipped, the rest of the run driven at tiny widths on the CPU."""

import pytest
import torch

from portbench.tests import tiny


def _alter_tokens(monkeypatch):
    """A token altered where it is produced: the decode loop's first token of
    every row moved half the vocabulary away."""
    from videollamb_torch.serve import server

    real = server.decode_steps

    def broken(forward, logits, k, **kw):
        out = real(forward, logits, k, **kw)
        toks = out.tokens.clone()
        toks[:, 0] = (toks[:, 0] + logits.shape[-1] // 2) % logits.shape[-1]
        return out._replace(tokens=toks)

    monkeypatch.setattr(server, "decode_steps", broken)


@pytest.mark.parametrize("workload", ["mistral7b-mc-longvideo", "mistral7b-sweep-24slots"])
def test_an_altered_token_fails(workload, monkeypatch, capsys):
    assert tiny.run_tiny(workload, 1.5, capsys=capsys)["correct"] is True
    _alter_tokens(monkeypatch)
    res = tiny.run_tiny(workload, 1.5, capsys=capsys)
    assert res["correct"] is False
    assert res["checks"]["logit_gap_max"]["value"] > res["checks"]["logit_gap_max"]["limit"]


def _break_encode(monkeypatch, how):
    from videollamb_torch.models import binding

    real = binding.binding_encode_modality

    def broken(model, name, pixels, cfg, use_temp=True):
        if how == "answer":
            out = real(model, name, pixels, cfg, use_temp)
            out = out.clone()
            out[0] = -out[0]
            return out
        # Half of the batch left out, the mean of the rest in its place.
        half = pixels.shape[0] // 2
        out = real(model, name, pixels[:half], cfg, use_temp)
        return torch.cat([out, out.mean(dim=0, keepdim=True).expand(pixels.shape[0] - half, -1)])

    monkeypatch.setattr(binding, "binding_encode_modality", broken)


@pytest.mark.parametrize("how", ["answer", "half_batch"])
def test_a_broken_encode_fails(how, monkeypatch, capsys):
    workload = "languagebind-video-index"
    assert tiny.run_tiny(workload, 0.5, capsys=capsys)["correct"] is True
    _break_encode(monkeypatch, how)
    res = tiny.run_tiny(workload, 0.5, capsys=capsys)
    assert res["correct"] is False
