"""The port's checkpoint loader reads safetensors shards, as the JAX package's does.

One seeded tiny reference-format checkpoint (model dir + tower dir) is
written twice: as ``pytorch_model.bin`` and, in a second pair of dirs, as
``model.safetensors`` only. Both give equal state dicts (f32 and bf16
tensors alike), and the safetensors checkpoint loaded by the port's
``load_pretrained_model`` gives the JAX package's greedy tokens.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
safetensors_torch = pytest.importorskip("safetensors.torch")

from test_torch_parity_utils import REPO, write_reference_checkpoint  # noqa: E402

from videollamb_tpu.constants import VIDEO_TOKEN_INDEX  # noqa: E402
from videollamb_torch.models.builder import load_state_dict  # noqa: E402

MAX_NEW = 8


def _as_safetensors(src_dir: str, dst_dir: str) -> None:
    """Copy a checkpoint dir with its ``pytorch_model.bin`` rewritten as
    ``model.safetensors`` (and no ``.bin`` left)."""
    shutil.copytree(src_dir, dst_dir)
    bin_path = os.path.join(dst_dir, "pytorch_model.bin")
    sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    safetensors_torch.save_file({k: v.contiguous() for k, v in sd.items()},
                                os.path.join(dst_dir, "model.safetensors"))
    os.remove(bin_path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """((model_dir, tower_dir) as .bin, the same as .safetensors)."""
    root = str(tmp_path_factory.mktemp("ckpt"))
    model_dir, tower_dir = write_reference_checkpoint(os.path.join(root, "bin"), seed=3)
    st_model, st_tower = (os.path.join(root, "st", os.path.basename(d))
                          for d in (model_dir, tower_dir))
    _as_safetensors(model_dir, st_model)
    _as_safetensors(tower_dir, st_tower)
    return (model_dir, tower_dir), (st_model, st_tower)


def _assert_equal_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("which", [0, 1], ids=["model", "tower"])
def test_safetensors_and_bin_give_equal_state_dicts(checkpoints, which):
    (bin_dirs, st_dirs) = checkpoints
    assert not any(f.endswith(".bin") for f in os.listdir(st_dirs[which]))
    _assert_equal_state(load_state_dict(bin_dirs[which]), load_state_dict(st_dirs[which]))


def test_bf16_tensors_load_equal_from_both_formats(checkpoints, tmp_path):
    """bf16 tensors keep their dtype and bits through either format."""
    sd = {k: v.to(torch.bfloat16) for k, v in load_state_dict(checkpoints[0][0]).items()}
    sd["model.norm.weight"] = sd["model.norm.weight"].float()  # a mixed-dtype checkpoint
    bin_dir, st_dir = tmp_path / "bin", tmp_path / "st"
    bin_dir.mkdir()
    st_dir.mkdir()
    torch.save(sd, bin_dir / "pytorch_model.bin")
    half = len(sd) // 2  # two safetensors shards
    keys = sorted(sd)
    for i, part in enumerate((keys[:half], keys[half:])):
        safetensors_torch.save_file({k: sd[k] for k in part},
                                    str(st_dir / f"model-0000{i + 1}-of-00002.safetensors"))
    got_bin, got_st = load_state_dict(str(bin_dir)), load_state_dict(str(st_dir))
    _assert_equal_state(got_bin, got_st)
    _assert_equal_state(got_st, sd)
    assert got_st["lm_head.weight"].dtype == torch.bfloat16
    assert got_st["model.norm.weight"].dtype == torch.float32


def test_safetensors_are_preferred_over_bin(checkpoints, tmp_path):
    """A dir with both formats reads the safetensors shards, as the JAX
    builder does; a dir with neither raises."""
    (model_dir, _), (st_model, _) = checkpoints
    both = tmp_path / "both"
    shutil.copytree(st_model, both)
    zeros = {k: torch.zeros_like(v) for k, v in load_state_dict(model_dir).items()}
    torch.save(zeros, both / "pytorch_model.bin")
    _assert_equal_state(load_state_dict(str(both)), load_state_dict(model_dir))
    with pytest.raises(FileNotFoundError, match="safetensors or pytorch_model"):
        load_state_dict(str(tmp_path))


def test_missing_safetensors_package_raises_clearly(checkpoints, monkeypatch):
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="needs the safetensors package"):
        load_state_dict(checkpoints[1][0])
    load_state_dict(checkpoints[0][0])  # .bin shards need no safetensors


def test_port_loader_imports_safetensors_only_when_reading_it():
    code = ("import sys\n"
            "import videollamb_torch.models.builder\n"
            "assert 'safetensors' not in sys.modules, 'imported at the top'\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_safetensors_checkpoint_greedy_tokens_equal_jax(checkpoints):
    import jax.numpy as jnp

    from videollamb_tpu.models.assembly import MultimodalBatch as JBatch
    from videollamb_tpu.models.builder import load_pretrained_model as jax_load
    from videollamb_tpu.models.engine import generate as jax_generate
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.models.builder import load_pretrained_model
    from videollamb_torch.models.engine import generate

    model_dir, tower_dir = checkpoints[1]
    _, params, jcfg, _, _ = jax_load(model_dir, video_tower_path=tower_dir,
                                     dtype="float32", load_tokenizer=False)
    _, model, cfg, _, _ = load_pretrained_model(
        model_dir, video_tower_path=tower_dir, dtype="float32", load_tokenizer=False,
        device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)

    rng = np.random.default_rng(0)
    prompt_lens = [40, 27]
    b, t = len(prompt_lens), max(prompt_lens)
    ids = rng.integers(4, cfg.lm.vocab_size, size=(b, t)).astype(np.int32)
    ids[:, 2] = VIDEO_TOKEN_INDEX
    mask = (np.arange(t)[None] < np.asarray(prompt_lens)[:, None]).astype(np.int32)
    img = cfg.vision.image_size
    videos = rng.normal(size=(b, 16, 3, img, img)).astype(np.float32)
    max_seq = cfg.max_length + 64

    ref = jax_generate(params, jcfg, JBatch(jnp.asarray(ids), jnp.asarray(mask), None,
                                            jnp.asarray(videos), None),
                       jax.random.PRNGKey(0), max_new_tokens=MAX_NEW, do_sample=False,
                       max_seq_len=max_seq)
    out = generate(model, cfg, MultimodalBatch(torch.from_numpy(ids), torch.from_numpy(mask),
                                               None, torch.from_numpy(videos)),
                   max_new_tokens=MAX_NEW, do_sample=False, max_seq_len=max_seq)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
