"""LoRA in the port against the JAX package, on the CPU in f32.

- The adapter term of a projection (``LoRALinear``) over a plain, an int8 and
  an int4 base against JAX's ``_lproj`` on the same weights.
- ``add_lora_params`` (zero B: identity) and ``merge_lora_params``.
- ``load_pretrained_model``'s LoRA-merge and projector-only loads against the
  JAX package's loader on seeded checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import np_tree, port_config, write_reference_checkpoint  # noqa: E402

from videollamb_tpu.config import LlamaConfig, ModelConfig  # noqa: E402
from videollamb_tpu.models.lm import quant as jq  # noqa: E402
from videollamb_torch.models.lm import quant as pq  # noqa: E402
from videollamb_torch.models.lm.lora import (  # noqa: E402
    LORA_TARGETS,
    LoRALinear,
    add_lora_params,
    merge_lora_params,
)

CFG = LlamaConfig.tiny()


def _base(kind: str, w: np.ndarray):
    """(JAX kernel, port module) of one (d_in, d_out) weight."""
    if kind == "plain":
        linear = torch.nn.Linear(w.shape[0], w.shape[1], bias=False)
        linear.weight.data = torch.from_numpy(w.T.copy())
        return jnp.asarray(w), linear
    if kind == "int8":
        return jq.quantize_kernel(jnp.asarray(w)), pq.QuantLinear(
            pq.quantize_kernel(torch.from_numpy(w)))
    return jq.quantize_kernel_int4(jnp.asarray(w), 32), pq.QuantLinear(
        pq.quantize_kernel_int4(torch.from_numpy(w), 32))


@pytest.mark.parametrize("kind", ["plain", "int8", "int4"])
def test_adapter_term_matches_jax_lproj(kind):
    from videollamb_tpu.models.lm.llama import _lproj

    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 48)).astype(np.float32) * 0.1
    a = rng.normal(size=(64, 4)).astype(np.float32) * 0.1
    b = rng.normal(size=(4, 48)).astype(np.float32) * 0.1
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    jkernel, base = _base(kind, w)
    lp = {"q_proj": jkernel, "q_proj_lora_a": jnp.asarray(a), "q_proj_lora_b": jnp.asarray(b)}
    want = np.asarray(_lproj(lp, "q_proj", jnp.asarray(x)))
    module = LoRALinear(base, torch.from_numpy(a), torch.from_numpy(b))
    with torch.no_grad():
        got = module(torch.from_numpy(x))
        plain = base(torch.from_numpy(x))
    # f32 products of 64 and 4 terms, summed in another order than XLA's.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float((got - plain).abs().max()) > 1e-3  # the adapter does act


def _port_lm(seed: int = 0):
    from videollamb_tpu.models.lm.llama import init_llama_params
    from videollamb_torch.models.convert import from_jax_params, load_converted_state
    from videollamb_torch.models.lm.llama import LlamaForCausalLM

    tree = np_tree(init_llama_params(jax.random.PRNGKey(seed), CFG))
    lm = LlamaForCausalLM(port_config(ModelConfig.tiny()).lm)
    load_converted_state(lm, from_jax_params({"lm": tree}), prefix="lm.")
    return tree, lm.eval()


def _logits(lm, ids):
    from videollamb_torch.models.lm import llama as pl

    cfg = port_config(ModelConfig.tiny()).lm
    cache = pl.init_kv_cache(cfg, 1, 16, dtype=torch.float32)
    return pl.llama_prefill(lm, cfg, pl.embed_tokens(lm, ids), torch.ones_like(ids), cache)[0]


@pytest.mark.parametrize("base", ["plain", "int8"])
def test_add_lora_params_is_the_identity_at_init(base):
    _, lm = _port_lm()
    if base == "int8":
        lm = pq.quantize_llama_params(lm)
    ids = torch.from_numpy(np.random.default_rng(1).integers(4, CFG.vocab_size, (1, 7)))
    before = _logits(lm, ids)
    g = torch.Generator().manual_seed(0)
    out = add_lora_params(lm, port_config(ModelConfig.tiny()).lm, r=4, alpha=8.0, generator=g)
    assert out is lm
    adapted = [m for m in lm.modules() if isinstance(m, LoRALinear)]
    assert len(adapted) == len(LORA_TARGETS) * CFG.num_hidden_layers
    q = lm.model.layers[0].self_attn.q_proj
    assert q.lora_a.shape == (CFG.hidden_size, 4) and q.lora_b.shape == (4, q.base.out_features)
    assert float(q.lora_b.abs().max()) == 0.0
    # A ~ N(0, (alpha / r) / sqrt(d_in)), as the JAX initialiser draws it.
    std = float(torch.cat([m.lora_a.flatten() for m in adapted]).std())
    assert abs(std / (2.0 / np.sqrt(CFG.hidden_size)) - 1) < 0.1, std
    assert torch.equal(_logits(lm, ids), before)  # B is zero
    assert isinstance(q.base, pq.QuantLinear if base == "int8" else torch.nn.Linear)


def test_merge_lora_params_matches_jax():
    from videollamb_tpu.models.lm.lora import merge_lora_params as jax_merge

    tree, lm = _port_lm(seed=2)
    rng = np.random.default_rng(3)
    add_lora_params(lm, None, r=4, alpha=8.0, generator=torch.Generator().manual_seed(1))
    layers = dict(tree["layers"])
    for name in LORA_TARGETS:
        stack_a, stack_b = [], []
        for layer in lm.model.layers:
            parent = layer.self_attn if hasattr(layer.self_attn, name) else layer.mlp
            module = getattr(parent, name)
            module.lora_b.data = torch.from_numpy(
                rng.normal(size=tuple(module.lora_b.shape)).astype(np.float32) * 0.05)
            stack_a.append(module.lora_a.numpy())
            stack_b.append(module.lora_b.numpy())
        layers[f"{name}_lora_a"] = jnp.asarray(np.stack(stack_a))
        layers[f"{name}_lora_b"] = jnp.asarray(np.stack(stack_b))
    ids = torch.from_numpy(rng.integers(4, CFG.vocab_size, (1, 7)))
    adapted = _logits(lm, ids)
    merged = jax_merge({"lm": {**tree, "layers": jax.tree.map(jnp.asarray, layers)}})
    out = merge_lora_params(lm)
    assert out is lm and not [m for m in lm.modules() if isinstance(m, LoRALinear)]
    for i, layer in enumerate(lm.model.layers):
        np.testing.assert_allclose(
            layer.mlp.down_proj.weight.detach().numpy().T,
            np.asarray(merged["lm"]["layers"]["down_proj"][i]), rtol=1e-6, atol=1e-7)
        assert "q_proj_lora_a" not in merged["lm"]["layers"]
    # Merging changes where the adapter is added, not what the model computes.
    np.testing.assert_allclose(_logits(lm, ids).numpy(), adapted.numpy(), rtol=1e-4, atol=1e-5)


def test_merge_refuses_a_quantised_base():
    _, lm = _port_lm()
    add_lora_params(pq.quantize_llama_params(lm), None, r=2,
                    generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="full-precision"):
        merge_lora_params(lm)


def test_quantising_under_adapters_keeps_them():
    """QLoRA order: adapters first, then the base goes to int4 beneath them."""
    _, lm = _port_lm()
    add_lora_params(lm, None, r=2, generator=torch.Generator().manual_seed(0))
    pq.quantize_llama_params_int4(lm, group=32)
    q = lm.model.layers[1].mlp.up_proj
    assert isinstance(q, LoRALinear) and pq.is_int4(q.base)


# ---------------------------------------------------------------------------
# load_pretrained_model: LoRA merge and projector-only loads against the JAX loader.


def _split_checkpoint(root: str):
    """A seeded full checkpoint split into (base dir with the LM only, state of
    the bridge under its checkpoint names, tower dir)."""
    model_dir, tower_dir = write_reference_checkpoint(root, seed=5)
    sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"), weights_only=True)
    bridge = {k: v for k, v in sd.items() if k.startswith("model.mm_projector.")}
    base = os.path.join(root, "base")
    os.makedirs(base)
    torch.save({k: v for k, v in sd.items() if k not in bridge},
               os.path.join(base, "pytorch_model.bin"))
    shutil.copy(os.path.join(model_dir, "config.json"), base)
    return base, bridge, tower_dir, model_dir


def _assert_same_model(params, model):
    """Every parameter of the port's model equals the JAX tree's."""
    from videollamb_torch.models.convert import from_jax_params

    want = from_jax_params(np_tree(params))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, tensor in got.items():
        np.testing.assert_allclose(tensor.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def _load_both(path, base, tower_dir):
    from videollamb_tpu.models.builder import load_pretrained_model as jax_load
    from videollamb_torch.models.builder import load_pretrained_model

    kw = dict(video_tower_path=tower_dir, dtype="float32", load_tokenizer=False)
    _, params, jcfg, _, _ = jax_load(path, model_base=base, **kw)
    _, model, cfg, _, _ = load_pretrained_model(path, base, device="cpu", **kw)
    assert cfg.lm.hidden_size == jcfg.lm.hidden_size and cfg.max_length == jcfg.max_length
    return params, model


def test_loader_projector_only_load_matches_jax(tmp_path):
    base, bridge, tower_dir, _ = _split_checkpoint(str(tmp_path))
    proj = tmp_path / "proj"
    proj.mkdir()
    torch.save(bridge, str(proj / "mm_projector.bin"))
    shutil.copy(os.path.join(base, "config.json"), str(proj))
    params, model = _load_both(str(proj), base, tower_dir)
    _assert_same_model(params, model)
    key = next(iter(bridge))
    assert torch.equal(model.mm_projector.state_dict()[key[len("model.mm_projector."):]],
                       bridge[key])


def test_loader_lora_merge_matches_jax(tmp_path):
    base, bridge, tower_dir, _ = _split_checkpoint(str(tmp_path))
    sd = torch.load(os.path.join(base, "pytorch_model.bin"), weights_only=True)
    lora = tmp_path / "lora"
    lora.mkdir()
    r, alpha = 4, 8
    g = torch.Generator().manual_seed(2)
    lora_sd = {}
    for name in ("model.layers.0.self_attn.q_proj", "model.layers.1.mlp.down_proj"):
        d_out, d_in = sd[f"{name}.weight"].shape
        key = f"base_model.model.{name}"
        lora_sd[f"{key}.lora_A.weight"] = torch.randn(r, d_in, generator=g) * 0.05
        lora_sd[f"{key}.lora_B.weight"] = torch.randn(d_out, r, generator=g) * 0.05
    lora_sd["base_model.model.model.layers.9.mlp.up_proj.lora_A.weight"] = torch.zeros(r, 4)
    lora_sd["base_model.model.model.layers.9.mlp.up_proj.lora_B.weight"] = torch.zeros(4, r)
    torch.save(lora_sd, str(lora / "pytorch_model.bin"))
    with open(lora / "adapter_config.json", "w") as f:
        json.dump({"r": r, "lora_alpha": alpha}, f)
    # The bridge rides along as non-LoRA trainables, under the PEFT prefix.
    torch.save({f"base_model.model.{k}": v * 1.5 for k, v in bridge.items()},
               str(lora / "non_lora_trainables.bin"))

    params, model = _load_both(str(lora), base, tower_dir)
    _assert_same_model(params, model)
    name = "model.layers.0.self_attn.q_proj"
    expected = sd[f"{name}.weight"] + (
        lora_sd[f"base_model.model.{name}.lora_B.weight"]
        @ lora_sd[f"base_model.model.{name}.lora_A.weight"]) * (alpha / r)
    np.testing.assert_allclose(model.lm.model.layers[0].self_attn.q_proj.weight.detach().numpy(),
                               expected.numpy(), rtol=1e-5, atol=1e-6)
    untouched = "model.layers.1.self_attn.k_proj.weight"
    assert torch.equal(model.lm.state_dict()[untouched], sd[untouched])
    key = next(iter(bridge))
    assert torch.equal(model.mm_projector.state_dict()[key[len("model.mm_projector."):]],
                       bridge[key] * 1.5)


def test_loader_load_8bit_quantises_the_lm(tmp_path):
    from videollamb_tpu.models.builder import load_pretrained_model as jax_load
    from videollamb_torch.models.builder import load_pretrained_model
    from videollamb_torch.models.convert import from_jax_params

    model_dir, tower_dir = write_reference_checkpoint(str(tmp_path), seed=6)
    kw = dict(video_tower_path=tower_dir, dtype="float32", load_8bit=True, load_tokenizer=False)
    _, params, _, _, _ = jax_load(model_dir, **kw)
    _, model, _, _, _ = load_pretrained_model(model_dir, device="cpu", **kw)
    want = from_jax_params({"lm": np_tree(params["lm"])})
    got = {f"lm.{k}": v for k, v in model.lm.state_dict().items()}
    assert set(got) == set(want) and any(k.endswith(".q") for k in got)
    for name, tensor in got.items():
        if tensor.dtype == torch.int8:
            assert torch.equal(tensor, want[name]), name
        else:
            np.testing.assert_array_equal(tensor.float().numpy(), want[name].float().numpy(),
                                          err_msg=name)
    assert isinstance(model.video_tower.vision_model.encoder.layers[0].mlp.fc1, torch.nn.Linear)
