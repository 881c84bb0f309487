"""The port's train step against the JAX package's, on the CPU in f32 at
``ModelConfig.tiny`` size (with dropout off on both sides: the packages draw
from different generators), from the same seeded parameters and batches.

For the ``adapter`` recipe, ``lora`` over an f32 and over an int8 base, and
``full`` with a projector LR group and gradient accumulation over two calls,
every step's loss and ``grad_norm`` and, after the last step, every trained
leaf (through ``convert.to_jax_params``) must agree. ``max_grad_norm`` is set
low enough that every update clips, so per-group clipping is exercised. Also
the schedule against optax's, the labels against JAX's, and the retro loss.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import jax_params, port_config  # noqa: E402

from videollamb_tpu.config import BridgeConfig, ModelConfig  # noqa: E402
from videollamb_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from videollamb_tpu.constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX  # noqa: E402
from videollamb_torch.config import TrainConfig  # noqa: E402

CFG = ModelConfig.tiny(max_length=96, bridge=BridgeConfig(
    hidden_size=32, num_attention_heads=4, intermediate_size=64, num_memory_tokens=8,
    pool_h=2, pool_w=2, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
# Losses and gradient norms: f32 forward and backward through tower, bridge
# and LM, summed in other orders than XLA's.
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
LR = 1e-3
# Trained leaves after the steps: Adam moves each entry by about lr per
# update whatever its gradient's size, so an entry whose gradient is rounding
# noise (a key bias: softmax ignores a shift common to a row) moves by an
# amount set by that noise. Absolute error: 1% of one update's step at the
# largest lr of the recipe.
LEAF_RTOL, LEAF_ATOL_OF_LR = 1e-4, 0.01

RECIPES = {
    "adapter": (dict(tune_mode="adapter"), None, 3),
    "lora_f32": (dict(tune_mode="lora"), "f32", 3),
    "lora_int8": (dict(tune_mode="lora"), "int8", 3),
    # Five calls with k = 2: updates at calls 2 and 4 (the first at lr 0).
    "full_projector_lr_accum": (dict(tune_mode="full", mm_projector_lr=5e-3,
                                     gradient_accumulation_steps=2), None, 5),
}


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, CFG.lm.vocab_size, size=(2, 20)).astype(np.int32)
    ids[:, 2] = VIDEO_TOKEN_INDEX
    mask = (np.arange(20)[None] < np.array([[20], [14]])).astype(np.int32)
    labels = np.where(mask > 0, ids, IGNORE_INDEX).astype(np.int32)
    labels[:, :5] = IGNORE_INDEX
    img = CFG.vision.image_size
    videos = rng.normal(size=(2, 8, 3, img, img)).astype(np.float32)
    return ids, mask, labels, videos


def _models(base):
    """(JAX params, port model) holding the same seeded values; LoRA r=4
    adapters with a non-zero seeded B when ``base`` is set."""
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.rmt_r import RMTRBridge
    from videollamb_torch.models.convert import from_jax_params, load_converted_state
    from videollamb_torch.models.lm.llama import LlamaForCausalLM
    from videollamb_torch.models.lm.lora import LORA_TARGETS, add_lora_params
    from videollamb_torch.models.vision.clip_vit import CLIPVisionTower

    tree = jax_params(CFG, seed=9)
    if base == "int8":
        from videollamb_tpu.models.lm.quant import quantize_llama_params

        tree["lm"] = jax.tree.map(np.asarray, quantize_llama_params(
            jax.tree.map(jnp.asarray, tree["lm"])))
    if base is not None:
        rng = np.random.default_rng(2)
        layers = tree["lm"]["layers"]
        for name in LORA_TARGETS:
            kernel = layers[name]["q"] if isinstance(layers[name], dict) else layers[name]
            n, d_in, d_out = kernel.shape
            layers[f"{name}_lora_a"] = rng.normal(size=(n, d_in, 4)).astype(np.float32) * 0.2
            layers[f"{name}_lora_b"] = rng.normal(size=(n, 4, d_out)).astype(np.float32) * 0.02
    cfg = port_config(CFG)
    model = VideoLLaMB(CLIPVisionTower(cfg.vision), RMTRBridge(cfg.bridge, cfg.lm.hidden_size),
                       LlamaForCausalLM(cfg.lm))
    if base is not None:
        add_lora_params(model.lm, cfg.lm, r=4, alpha=8.0)
    load_converted_state(model, from_jax_params(tree))
    return jax.tree.map(jnp.asarray, tree), model


def _run_jax(params, tcfg, batches, total):
    from videollamb_tpu.models.assembly import MultimodalBatch
    from videollamb_tpu.train.step import (
        create_optimizer,
        create_train_state,
        make_train_step,
        trainable_mask,
    )

    tx = create_optimizer(tcfg, total, params)
    state = create_train_state(params, tx)
    step = jax.jit(make_train_step(CFG, tx, remat=True, attn_impl="chunked",
                                   mask=trainable_mask(tcfg, params)))
    metrics = []
    for ids, mask, labels, videos in batches:
        batch = MultimodalBatch(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                                labels=jnp.asarray(labels), videos=jnp.asarray(videos),
                                images=None)
        state, m = step(state, batch, jax.random.PRNGKey(0))
        metrics.append((float(m["loss"]), float(m["grad_norm"]), int(m["tokens"])))
    return state, metrics


def _run_port(model, tcfg, batches, total):
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.train.step import (
        create_optimizer,
        create_train_state,
        make_train_step,
        trainable_mask,
    )

    tx = create_optimizer(tcfg, total, model)
    state = create_train_state(model, tx)
    step = make_train_step(port_config(CFG), tx, remat=True, attn_impl="chunked",
                           mask=trainable_mask(tcfg, model))
    metrics = []
    for arrays in batches:
        batch = MultimodalBatch(*(torch.from_numpy(a) for a in arrays))
        state, m = step(state, batch, torch.Generator().manual_seed(0))
        metrics.append((float(m["loss"]), float(m["grad_norm"]), int(m["tokens"])))
    return state, metrics


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_train_steps_match_jax(recipe):
    from videollamb_torch.models.convert import to_jax_params
    from videollamb_torch.train.step import param_labels

    overrides, base, n_steps = RECIPES[recipe]
    common = dict(learning_rate=LR, warmup_ratio=0.25, max_grad_norm=0.05, **overrides)
    total = 4
    params, model = _models(base)
    batches = [_batch(s) for s in range(n_steps)]
    jstate, jmetrics = _run_jax(params, JaxTrainConfig(**common), batches, total)
    tcfg = TrainConfig(**common)
    pstate, pmetrics = _run_port(model, tcfg, batches, total)

    assert pstate.step == int(jstate.step) == n_steps
    for (pl, pn, pt), (jl, jn, jt) in zip(pmetrics, jmetrics):
        assert pt == jt
        np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(pn, jn, rtol=NORM_RTOL)
        assert pn > common["max_grad_norm"]  # every update clips

    labels = param_labels(tcfg, model)
    trained = {k: v for k, v in model.state_dict(keep_vars=True).items()
               if labels.get(k, "frozen") != "frozen"}
    assert trained
    got = dict(jax.tree_util.tree_flatten_with_path(to_jax_params(trained))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jstate.params)[0])
    moved = 0
    for path, value in got.items():
        np.testing.assert_allclose(value, np.asarray(want[path]), rtol=LEAF_RTOL,
                                   atol=LEAF_ATOL_OF_LR * max(LR, tcfg.mm_projector_lr or 0),
                                   err_msg=jax.tree_util.keystr(path))
        moved += int(not np.array_equal(np.asarray(want[path]), np.asarray(params_at(
            params, path))))
    assert moved > 0


def params_at(tree, path):
    for key in path:
        tree = tree[getattr(key, "key", getattr(key, "idx", None))]
    return tree


def test_labels_match_jax():
    """The port's per-parameter labels against JAX's per-leaf labels."""
    from videollamb_tpu.train.step import param_labels as jax_labels
    from videollamb_torch.models.convert import to_jax_params
    from videollamb_torch.train.step import param_labels

    params, model = _models("f32")
    for overrides in (dict(tune_mode="lora"), dict(tune_mode="lora", mm_projector_lr=1e-4),
                      dict(tune_mode="adapter"), dict(tune_mode="full", mm_projector_lr=1e-4)):
        want = dict(jax.tree_util.tree_flatten_with_path(
            jax_labels(JaxTrainConfig(**overrides), params))[0])
        labels = param_labels(TrainConfig(**overrides), model)
        for label in ("train", "projector", "frozen"):
            names = {k: torch.zeros(1) for k, v in labels.items() if v == label
                     and not k.startswith("video_tower.")}
            got = jax.tree_util.tree_flatten_with_path(to_jax_params(names))[0]
            for path, _ in got:
                assert want[path] == label, (overrides, jax.tree_util.keystr(path))


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_schedule_matches_optax(schedule):
    from videollamb_tpu.train.step import lr_schedule as jax_schedule
    from videollamb_torch.train.step import lr_schedule

    for total, ratio in ((100, 0.03), (7, 0.5), (1, 0.0)):
        kw = dict(learning_rate=2e-4, warmup_ratio=ratio, lr_schedule=schedule)
        want = jax_schedule(JaxTrainConfig(**kw), total)
        got = lr_schedule(TrainConfig(**kw), total)
        for count in range(total + 3):
            # optax evaluates the schedule in f32: a few ulps of the peak.
            np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-5,
                                       atol=1e-6 * kw["learning_rate"])


def test_first_update_at_lr_zero_keeps_parameters():
    """The schedule starts at 0: the first update leaves the parameters as
    they were (optax evaluates the schedule at the count of updates made)."""
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.train.step import create_optimizer, create_train_state, make_train_step

    _, model = _models(None)
    tcfg = TrainConfig(tune_mode="adapter", learning_rate=1e-2)
    before = {k: v.clone() for k, v in model.mm_projector.state_dict().items()}
    tx = create_optimizer(tcfg, 10, model)
    step = make_train_step(port_config(CFG), tx, remat=False)
    state, _ = step(create_train_state(model, tx), MultimodalBatch(
        *(torch.from_numpy(a) for a in _batch(0))))
    for k, v in model.mm_projector.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert tx.updates == 1 and state.step == 1
    assert tx.adamw.state  # the moments were updated all the same


def test_retro_loss_matches_jax():
    from videollamb_tpu.models.assembly import MultimodalBatch as JBatch
    from videollamb_tpu.train.retro import retro_loss as jax_retro
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.train.retro import retro_loss

    params, model = _models(None)
    ids, mask, labels, videos = _batch(4)
    want, want_n = jax_retro(params, CFG, JBatch(
        input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        labels=jnp.asarray(labels), videos=jnp.asarray(videos), images=None),
        deterministic=True, remat=False)
    got, n = retro_loss(model, port_config(CFG), MultimodalBatch(
        *(torch.from_numpy(a) for a in (ids, mask, labels, videos))), remat=False)
    assert int(n) == int(want_n)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)


def test_retro_lm_memory_forward_matches_jax():
    from videollamb_tpu.models.assembly import MultimodalBatch as JBatch
    from videollamb_tpu.train.retro import videollamb_retro_lm_forward as jax_fwd
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.train.retro import videollamb_retro_lm_forward

    params, model = _models(None)
    memory = np.random.default_rng(5).normal(size=(4, CFG.lm.hidden_size)).astype(np.float32)
    params = dict(params, lm_memory=jnp.asarray(memory * 0.02))
    model.lm_memory = torch.nn.Parameter(torch.from_numpy(memory * 0.02))
    ids, mask, labels, videos = _batch(5)
    want_logits, want_labels = jax_fwd(params, CFG, JBatch(
        input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        labels=jnp.asarray(labels), videos=jnp.asarray(videos), images=None),
        attn_impl="chunked")
    with torch.no_grad():
        logits, got_labels = videollamb_retro_lm_forward(
            model, port_config(CFG), MultimodalBatch(
                *(torch.from_numpy(a) for a in (ids, mask, labels, videos))),
            attn_impl="chunked")
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(want_labels))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-4)


def test_init_lm_memory_shape_and_scale():
    from videollamb_torch.train.retro import init_lm_memory

    mem = init_lm_memory(torch.Generator().manual_seed(0), port_config(CFG), num_mem_tokens=512)
    assert mem.shape == (512, CFG.lm.hidden_size)
    assert abs(float(mem.std()) - 0.02) < 0.002


def test_trainable_mask_freezes_the_tower_and_base():
    """After a lora step only adapters and the projector hold gradients on."""
    from videollamb_torch.train.step import apply_trainable_mask, trainable_mask

    _, model = _models("f32")
    apply_trainable_mask(model, trainable_mask(TrainConfig(tune_mode="lora"), model))
    on = [k for k, p in model.named_parameters() if p.requires_grad]
    assert on and all(k.startswith("mm_projector.") or k.endswith((".lora_a", ".lora_b"))
                      for k in on)
    assert dataclasses.is_dataclass(TrainConfig())
