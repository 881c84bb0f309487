"""Training's image and audio rows in the port against the JAX package, on
the CPU in f32 at ``ModelConfig.tiny`` size (bridge dropout off on both
sides), from the same files, tokenizer, seeded parameters and batches.

- ``SupervisedDataset`` samples of 'square', 'pad' and 'anyres' image rows
  and of an audio (WAV) row: exactly equal;
- the ``Collator``'s batches of each (anyres stacks with their grid specs)
  and a ``PackedCollator`` image batch: exactly equal; both packers refuse
  anyres stacks and video + image batches with the same errors; the Trainer
  gives its packer JAX's ``block_tokens_image``;
- one step's loss and gradients on a plain and on a packed image batch,
  against ``jax.value_and_grad`` of the JAX loss: the loss within STEP_TOL
  relative, every gradient entry within STEP_TOL of the step's largest
  gradient (f32 through tower, bridge and LM, summed in other orders than
  XLA's).
"""

from __future__ import annotations

import json
import wave

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402
from test_preprocess import WordTokenizer  # noqa: E402
from test_torch_parity_utils import drawn_params, port_config, port_model  # noqa: E402

from videollamb_tpu.config import BridgeConfig, ModelConfig  # noqa: E402
from videollamb_tpu.train import dataset as jds  # noqa: E402
from videollamb_torch.train import dataset as pds  # noqa: E402

CFG = ModelConfig.tiny(max_length=96, bridge=BridgeConfig(
    hidden_size=32, num_attention_heads=4, intermediate_size=64, num_memory_tokens=8,
    pool_h=2, pool_w=2, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
STEP_TOL = 1e-5
PINPOINTS = ((56, 112), (112, 56), (112, 112))
ASPECTS = ["square", "pad", "anyres"]
SIZES = [(90, 40), (40, 90), (60, 60)]
CONV = [{"from": "human", "value": "<image> what is here"},
        {"from": "gpt", "value": "a pattern of colors"}]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(SIZES):
        cv2.imwrite(str(root / f"{i}.png"), rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    wav = 0.3 * np.sin(2 * np.pi * 330 * np.linspace(0, 0.5, 8000))
    with wave.open(str(root / "a.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((wav * 32767).astype(np.int16).tobytes())
    records = [{"image": f"{i}.png", "conversations": CONV} for i in range(len(SIZES))]
    records.append({"audio": "a.wav", "conversations": [
        {"from": "human", "value": "<audio> what do you hear"},
        {"from": "gpt", "value": "a tone"}]})
    path = root / "data.json"
    path.write_text(json.dumps(records))
    return root, str(path)


def _datasets(files, aspect: str):
    """{"jax": dataset, "torch": dataset} over the same records."""
    from videollamb_torch.data.processing import ImageProcessor
    from videollamb_torch.models.vision.modalities import AudioProcessor
    from videollamb_tpu.data.processing import ImageProcessor as JaxImageProcessor
    from videollamb_tpu.models.vision.modalities import AudioProcessor as JaxAudioProcessor

    root, path = files
    kw = dict(image_folder=str(root), audio_folder=str(root), model_max_length=64,
              image_aspect_ratio=aspect, image_grid_pinpoints=PINPOINTS)
    return {
        "jax": jds.SupervisedDataset(path, WordTokenizer(), jds.DataConfig(**kw),
                                     image_processor=JaxImageProcessor(size=56),
                                     audio_processor=JaxAudioProcessor(num_mel_bins=56,
                                                                       target_length=56)),
        "torch": pds.SupervisedDataset(path, WordTokenizer(), pds.DataConfig(**kw),
                                       image_processor=ImageProcessor(size=56),
                                       audio_processor=AudioProcessor(num_mel_bins=56,
                                                                      target_length=56))}


def _equal_samples(got, want):
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def _equal_batches(got, want):
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if b is None or field == "blocks":
            assert a is None, field
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)


@pytest.mark.parametrize("aspect", ASPECTS)
def test_image_rows_equal_jax(files, aspect):
    sets = _datasets(files, aspect)
    for i in range(len(SIZES)):
        _equal_samples(sets["torch"][i], sets["jax"][i])
    assert sets["torch"].modality(0) == "image"


def test_audio_row_equal_jax(files):
    sets = _datasets(files, "pad")
    i = len(SIZES)
    got, want = sets["torch"][i], sets["jax"][i]
    assert got["image"].shape == (3, 56, 56)
    _equal_samples(got, want)
    assert sets["torch"].modality(i) == sets["jax"].modality(i) == "audio"


@pytest.mark.parametrize("aspect", ASPECTS)
def test_collated_image_batches_equal_jax(files, aspect):
    sets = _datasets(files, aspect)
    kw = dict(bucket=16, max_length=96, image_grid_pinpoints=PINPOINTS, vision_image_size=56,
              patches_per_side=4)
    idx = list(range(len(SIZES)))
    got = pds.Collator(**kw)([sets["torch"][i] for i in idx])
    want = jds.Collator(**kw)([sets["jax"][i] for i in idx])
    _equal_batches(got, want)
    assert (got.image_specs is not None) == (aspect == "anyres")


def _packers(**kw):
    return (pds.PackedCollator(bucket=16, max_length=96, **kw),
            jds.PackedCollator(bucket=16, max_length=96, **kw))


def test_packed_image_batch_equal_jax(files):
    sets = _datasets(files, "pad")
    idx = list(range(len(SIZES) + 1))  # the audio row travels as an image
    got = _packers(block_tokens=40, block_tokens_image=4, k_max=3, rows_bucket=2)
    got, want = (packer([s[i] for i in idx]) for packer, s in zip(got, (sets["torch"],
                                                                      sets["jax"])))
    _equal_batches(got, want)
    assert got.images.ndim == 5 and got.image_block_mask.any()


def test_packed_collator_refusals_equal_jax(files):
    anyres = _datasets(files, "anyres")
    plain = _datasets(files, "pad")
    video = {"input_ids": np.array([1, -201, 5]), "labels": np.array([1, -100, 5]),
             "video": np.zeros((8, 3, 56, 56), np.float32)}
    for batch_of in (lambda side: [anyres[side][0]],
                     lambda side: [plain[side][0], video]):
        errors = []
        for side, packer in zip(("torch", "jax"), _packers(block_tokens=40,
                                                            block_tokens_image=4)):
            with pytest.raises(ValueError) as err:
                packer(batch_of(side))
            errors.append(str(err.value))
        assert errors[0] == errors[1]


def test_trainer_packs_images_with_jax_block_tokens(files, tmp_path):
    from videollamb_torch.config import TrainConfig
    from videollamb_torch.train.trainer import Trainer
    from videollamb_tpu.models.assembly import measure_block_tokens

    sets = _datasets(files, "pad")
    tree = drawn_params(CFG)
    trainer = Trainer(port_config(CFG), TrainConfig(pack_sequences=True, per_device_batch_size=2,
                                                    output_dir=str(tmp_path), tune_mode="adapter"),
                      port_model(CFG, tree), sets["torch"], log_fn=lambda m: None)
    params = jax.tree.map(jnp.asarray, tree)
    assert trainer.collator.block_tokens_image == measure_block_tokens(params, CFG, "image")
    assert trainer.collator.block_tokens == measure_block_tokens(params, CFG, "video")


def _step_batches(files, packed: bool):
    sets = _datasets(files, "pad")
    idx = list(range(len(SIZES)))
    if packed:
        from videollamb_tpu.models.assembly import measure_block_tokens

        params = jax.tree.map(jnp.asarray, drawn_params(CFG))
        kw = dict(block_tokens=measure_block_tokens(params, CFG, "video"),
                  block_tokens_image=measure_block_tokens(params, CFG, "image"),
                  k_max=2, rows_bucket=1)
        packers = _packers(**kw)
    else:
        packers = (pds.Collator(bucket=16, max_length=96), jds.Collator(bucket=16, max_length=96))
    return (packers[0]([sets["torch"][i] for i in idx]),
            packers[1]([sets["jax"][i] for i in idx]))


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_image_train_step_loss_and_grads_equal_jax(files, packed):
    from videollamb_torch.models.assembly import MultimodalBatch as PortBatch
    from videollamb_torch.models.assembly import causal_lm_loss, videollamb_forward
    from videollamb_torch.models.convert import to_jax_params
    from videollamb_tpu.models.assembly import causal_lm_loss as jax_loss
    from videollamb_tpu.models.assembly import videollamb_forward as jax_forward

    pbatch, jbatch = _step_batches(files, packed)
    assert (pbatch.segment_ids is not None) == packed
    tree = drawn_params(CFG, seed=3)
    jbatch = jax.tree.map(jnp.asarray, jbatch)

    def loss_fn(trained, frozen):
        logits, spliced = jax_forward({**frozen, **trained}, CFG, jbatch, attn_impl="chunked")
        return jax_loss(logits, spliced.labels)[0]

    params = jax.tree.map(jnp.asarray, tree)
    trained = {k: params[k] for k in ("lm", "mm_projector")}
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        trained, {"video_tower": params["video_tower"]})

    model = port_model(CFG, tree)
    batch = PortBatch(*(None if a is None else torch.from_numpy(np.asarray(a)).long()
                        if np.asarray(a).dtype.kind in "iu" else
                        torch.from_numpy(np.asarray(a)) for a in pbatch))
    logits, spliced = videollamb_forward(model, port_config(CFG), batch, attn_impl="chunked")
    loss = causal_lm_loss(logits, spliced.labels)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=STEP_TOL)
    # Parameters an image row does not reach have no gradient; JAX's is zero.
    grads = to_jax_params({k: torch.zeros_like(p) if p.grad is None else p.grad
                           for k, p in model.named_parameters()
                           if k.startswith(("lm.", "mm_projector."))})
    want = dict(jax.tree_util.tree_flatten_with_path(want_grads)[0])
    got = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(got) == len(want)
    # Absolute error against the step's largest gradient: a leaf whose true
    # gradient is zero (a key bias: softmax ignores a shift common to a row)
    # holds rounding noise on both sides.
    scale = max(np.abs(np.asarray(w)).max() for w in want.values())
    for path, g in got:
        assert np.abs(g - np.asarray(want[path])).max() <= STEP_TOL * scale, \
            jax.tree_util.keystr(path)


def test_train_cli_passes_image_and_audio_flags(files, tmp_path, monkeypatch):
    """``--image_folder``, ``--audio_folder`` and ``--image_aspect_ratio``
    reach the dataset, as in the JAX CLI; its image rows then load."""
    from test_torch_parity_utils import write_reference_checkpoint

    from videollamb_torch.train import cli
    from videollamb_torch.train.trainer import Trainer

    model_dir, tower_dir = write_reference_checkpoint(str(tmp_path))
    root, data = files
    monkeypatch.setattr(Trainer, "train", lambda self: self)
    trainer = cli.main(["--model_name_or_path", model_dir, "--video_tower", tower_dir,
                        "--data_path", data, "--image_folder", str(root), "--audio_folder",
                        str(root), "--image_aspect_ratio", "square", "--output_dir",
                        str(tmp_path / "out"), "--bf16", "False", "--device", "cpu",
                        "--tune_mm_mlp_adapter"], tokenizer=WordTokenizer())
    cfg = trainer.dataset.cfg
    assert (cfg.image_folder, cfg.audio_folder, cfg.image_aspect_ratio) == (
        str(root), str(root), "square")
    sample = trainer.dataset[0]
    assert sample["image"].shape == (3, 56, 56)
    assert trainer.dataset[len(SIZES)]["image"].shape[0] == 3
