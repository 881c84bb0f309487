"""Training projectors other than RMT-R, on the CPU in f32 at
``ModelConfig.tiny`` size (dropout off):

- for ``mlp`` and ``qformer``, the loss and every projector gradient against
  ``jax.value_and_grad`` of the JAX forward, and one adapter step of each
  package's train step (loss, gradient norm, tokens), from the same seeded
  JAX parameters; only the projector trains;
- the train CLI trains an ``mlp2x_gelu`` projector (LLaVA's stage 1) on a
  base LM, keeps it in its record without a reference-format
  ``mm_projector.bin`` (and says so), and ``--rmt_loss`` refuses the kind
  before the first step.

Tolerance: 1e-4 relative on losses, gradient norms and gradients (f32
forward and backward through tower, projector and LM, summed in other
orders than XLA's, as ``test_torch_train_step``); gradients also 1e-4 of the
largest entry absolute.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import (  # noqa: E402
    base_lm_checkpoint,
    port_config,
    projector_models,
    video_batch,
)

GRAD_RTOL = 1e-4


@pytest.mark.parametrize("kind", ["mlp", "qformer"])
def test_projector_gradients_and_train_step_match_jax(kind):
    from videollamb_tpu.config import TrainConfig as JaxTrainConfig
    from videollamb_tpu.models.assembly import causal_lm_loss as jax_loss
    from videollamb_tpu.models.assembly import videollamb_forward as jax_forward
    from videollamb_tpu.train import step as jstep
    from videollamb_torch.config import TrainConfig
    from videollamb_torch.models.assembly import causal_lm_loss, videollamb_forward
    from videollamb_torch.models.convert import to_jax_params
    from videollamb_torch.train import step as pstep

    cfg, params, model = projector_models(kind, seed=4)
    params = jax.tree.map(jnp.asarray, params)
    pcfg = port_config(cfg)
    jbatch, batch = video_batch(cfg, seed=5)

    def loss_of(projector):
        logits, spliced = jax_forward({**params, "mm_projector": projector}, cfg, jbatch,
                                      attn_impl="chunked")
        return jax_loss(logits, spliced.labels)[0]

    want_loss, want_grads = jax.value_and_grad(loss_of)(params["mm_projector"])
    logits, spliced = videollamb_forward(model, pcfg, batch, attn_impl="chunked")
    loss, _ = causal_lm_loss(logits, spliced.labels)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=GRAD_RTOL)
    grads = to_jax_params({f"mm_projector.{k}": p.grad
                           for k, p in model.mm_projector.named_parameters()})["mm_projector"]
    want_flat = jax.tree_util.tree_leaves_with_path(want_grads)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(grads))
    scale = max(float(np.abs(np.asarray(g)).max()) for _, g in want_flat)
    for path, g in want_flat:
        np.testing.assert_allclose(got_flat[path], np.asarray(g), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale, err_msg=jax.tree_util.keystr(path))
    model.zero_grad(set_to_none=True)

    # One adapter step of each package's train step.
    tcfg = dict(tune_mode="adapter", learning_rate=1e-3)
    jtx = jstep.create_optimizer(JaxTrainConfig(**tcfg), 4, params)
    jfn = jax.jit(jstep.make_train_step(
        cfg, jtx, remat=True, attn_impl="chunked",
        mask=jstep.trainable_mask(JaxTrainConfig(**tcfg), params)))
    _, jm = jfn(jstep.create_train_state(params, jtx), jbatch, jax.random.PRNGKey(0))
    ptx = pstep.create_optimizer(TrainConfig(**tcfg), 4, model)
    fn = pstep.make_train_step(pcfg, ptx, remat=True, attn_impl="chunked",
                               mask=pstep.trainable_mask(TrainConfig(**tcfg), model))
    _, m = fn(pstep.create_train_state(model, ptx), batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=GRAD_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=GRAD_RTOL)
    assert int(m["tokens"]) == int(jm["tokens"])
    assert {n for n, p in model.named_parameters() if p.requires_grad} == {
        n for n, _ in model.named_parameters() if n.startswith("mm_projector.")}


def test_train_cli_trains_an_mlp2x_gelu_projector(tmp_path, capsys):
    """LLaVA's stage 1 on a base LM: ``--mm_projector_type mlp2x_gelu
    --tune_mm_mlp_adapter`` takes two steps with finite losses, keeps the
    projector in the record and says that it has no reference-format
    ``mm_projector.bin``; ``--rmt_loss`` refuses the kind before the first
    step."""
    from test_preprocess import WordTokenizer

    from videollamb_torch.models.bridge.variants import MLPProjector
    from videollamb_torch.train import cli
    from videollamb_torch.train.checkpoint import RECORD, latest_checkpoint

    model_dir, tower_dir = base_lm_checkpoint(str(tmp_path))
    data = tmp_path / "data.json"
    data.write_text(json.dumps([{"conversations": [{"from": "human", "value": f"say {w}"},
                                                   {"from": "gpt", "value": f"{w} {w}"}]}
                                for w in ("one", "two", "three", "four")]))
    argv = ["--model_name_or_path", model_dir, "--video_tower", tower_dir,
            "--data_path", str(data), "--output_dir", str(tmp_path / "out"),
            "--per_device_train_batch_size", "2", "--bf16", "False", "--tune_mm_mlp_adapter",
            "--learning_rate", "1e-3", "--device", "cpu", "--model_max_length", "64",
            "--mm_projector_type", "mlp2x_gelu"]
    logs = []
    state = cli.main(argv, tokenizer=WordTokenizer(), log_fn=logs.append)
    assert state.step == 2
    losses = [m["loss"] for m in logs if "loss" in m]
    assert losses and all(np.isfinite(x) for x in losses)
    projector = state.model.mm_projector
    assert isinstance(projector, MLPProjector) and len(projector.layers) == 2
    path = latest_checkpoint(str(tmp_path / "out"))
    assert os.path.exists(os.path.join(path, RECORD))
    assert not os.path.exists(os.path.join(path, "mm_projector.bin"))
    assert "mm_projector.bin export skipped" in capsys.readouterr().out
    record = torch.load(os.path.join(path, RECORD), weights_only=True)
    assert set(record["params"]) == {f"mm_projector.{k}" for k in projector.state_dict()}
    with pytest.raises(ValueError, match="rmt_loss"):
        cli.main(argv + ["--rmt_loss", "--output_dir", str(tmp_path / "out2")],
                 tokenizer=WordTokenizer())
