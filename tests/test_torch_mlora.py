"""Multi-LoRA serving in the port against the JAX package, on the CPU, on
``ModelConfig.tiny`` in f32 with text-only prompts.

- A seeded PEFT adapter directory (``adapter_config.json`` and
  ``adapter_model.safetensors``, written here) loads to JAX's arrays.
- ``add_multi_lora_params`` stacks two adapters of ranks 4 and 8 (the
  smaller zero-padded) exactly as JAX stacks them.
- A batch mixing both adapters and the base model gives the JAX engines'
  greedy tokens in the dense engine and the paged engine (f32 and int8
  pools), and over an int8 base (the delta added after ``QuantLinear``);
  base rows give the tokens of an engine without adapters.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_parity_utils import serve, text_requests, tiny_models  # noqa: E402

TARGETS = ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"]


def _dims(cfg):
    d, inter = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    return {"q_proj": (d, q), "k_proj": (d, kv), "v_proj": (d, kv), "o_proj": (q, d),
            "gate_proj": (d, inter), "up_proj": (d, inter), "down_proj": (inter, d)}


def seeded_adapter(cfg, seed: int, r: int, scale: float = 0.05):
    """{proj}_lora_a (L, d_in, r) / {proj}_lora_b (L, r, d_out), f32 numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (d_in, d_out) in _dims(cfg).items():
        out[f"{name}_lora_a"] = (rng.normal(size=(cfg.num_hidden_layers, d_in, r))
                                 * d_in ** -0.5).astype(np.float32)
        out[f"{name}_lora_b"] = (rng.normal(size=(cfg.num_hidden_layers, r, d_out))
                                 * scale).astype(np.float32)
    return out


def write_peft_dir(path, adapter, alpha: float):
    """A PEFT-format directory holding ``adapter`` (lora_A = A^T / (alpha / r))."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    r = next(v for k, v in adapter.items() if k.endswith("_lora_a")).shape[-1]
    sd = {}
    for name in TARGETS:
        a, b = adapter[f"{name}_lora_a"], adapter[f"{name}_lora_b"]
        group = "self_attn" if name in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
        for layer in range(a.shape[0]):
            key = f"base_model.model.model.layers.{layer}.{group}.{name}"
            sd[f"{key}.lora_A.weight"] = torch.from_numpy(
                np.ascontiguousarray(a[layer].T / (alpha / r)))
            sd[f"{key}.lora_B.weight"] = torch.from_numpy(np.ascontiguousarray(b[layer].T))
    save_file(sd, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha, "target_modules": TARGETS}, f)


def _stack_both(jcfg, params, model, adapters, int8: bool):
    """(JAX params, port model, registry) with ``adapters`` stacked on both."""
    import copy

    from videollamb_torch.models.lm.mlora import add_multi_lora_params
    from videollamb_torch.models.lm.quant import quantize_llama_params
    from videollamb_tpu.models.lm.mlora import add_multi_lora_params as jax_add
    from videollamb_tpu.models.lm.quant import quantize_llama_params as jax_quantize

    params = jax.tree.map(lambda x: x, params)
    model = copy.deepcopy(model)
    if int8:
        params["lm"] = jax_quantize(params["lm"])
        quantize_llama_params(model.lm)
    params, registry = jax_add(params, adapters)
    _, port_registry = add_multi_lora_params(model.lm, adapters)
    assert port_registry == registry
    return params, model, registry


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def test_peft_dir_loads_like_jax(models, tmp_path):
    from videollamb_torch.models.lm.mlora import load_peft_adapter
    from videollamb_tpu.models.lm.mlora import load_peft_adapter as jax_load_peft

    cfg = models[3].lm
    adapter = seeded_adapter(cfg, 3, r=4)
    write_peft_dir(str(tmp_path / "peft"), adapter, alpha=8.0)
    got = load_peft_adapter(str(tmp_path / "peft"), cfg.num_hidden_layers)
    want = jax_load_peft(str(tmp_path / "peft"), cfg.num_hidden_layers)
    assert sorted(got) == sorted(want) == sorted(adapter)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_allclose(got[k], adapter[k], rtol=1e-6, atol=1e-7)


def test_stacks_equal_jax(models):
    """Ranks 4 and 8: the rank-4 adapter is zero-padded, in the JAX layout."""
    from videollamb_torch.models.lm.mlora import MultiLoRALinear

    jcfg, params, model, cfg = models
    adapters = {"a": seeded_adapter(cfg.lm, 1, r=4), "b": seeded_adapter(cfg.lm, 2, r=8)}
    jparams, pmodel, registry = _stack_both(jcfg, params, model, adapters, int8=False)
    assert registry == {"a": 0, "b": 1}
    layers = jparams["lm"]["layers"]
    for li, layer in enumerate(pmodel.lm.model.layers):
        for parent in (layer.self_attn, layer.mlp):
            for name in TARGETS:
                mod = getattr(parent, name, None)
                if mod is None:
                    continue
                assert isinstance(mod, MultiLoRALinear)
                np.testing.assert_array_equal(mod.lora_a.numpy(),
                                              np.asarray(layers[f"{name}_mlora_a"][li]))
                np.testing.assert_array_equal(mod.lora_b.numpy(),
                                              np.asarray(layers[f"{name}_mlora_b"][li]))
                assert mod.lora_a.shape[-1] == 8 and not mod.lora_a[0, :, 4:].any()


@pytest.mark.parametrize("kind", ["dense", "paged_f32", "paged_int8", "dense_int8_base"])
def test_mixed_adapter_batch_equals_jax(models, kind):
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import ServingEngine
    from videollamb_tpu.serve.paged import PagedServingEngine as JaxPaged
    from videollamb_tpu.serve.server import ServingEngine as JaxDense

    jcfg, params, model, cfg = models
    adapters = {"a": seeded_adapter(cfg.lm, 1, r=4, scale=0.5),
                "b": seeded_adapter(cfg.lm, 2, r=8, scale=0.5)}
    jparams, pmodel, registry = _stack_both(jcfg, params, model, adapters,
                                            int8=kind == "dense_int8_base")
    if kind.startswith("dense"):
        def make(p, m, c, reg):
            cls = JaxDense if p is not None else ServingEngine
            return cls(p if p is not None else m, c, num_slots=4, eos_token_id=-1,
                       adapter_registry=reg)
    else:
        def make(p, m, c, reg):
            cls = JaxPaged if p is not None else PagedServingEngine
            return cls(p if p is not None else m, c, num_slots=4, eos_token_id=-1,
                       page_size=16, quantize_kv=kind == "paged_int8", adapter_registry=reg)
    # Prompts 60 and 61 each with an adapter and with the base; 62 with both.
    names = ["a", None, "b", None, "a", "b"]
    seeds = [60, 60, 61, 61, 62, 62]
    jreqs, preqs = [], []
    for i, (name, seed) in enumerate(zip(names, seeds)):
        j, p = text_requests(cfg.lm.vocab_size, [seed], 6, adapter=name)
        j[0].uid = p[0].uid = i
        jreqs += j
        preqs += p
    engine = make(None, pmodel, cfg, registry)
    got = serve(engine, preqs, 3)
    assert got == serve(make(jparams, None, jcfg, registry), jreqs, 3)
    assert engine._live_adapter_idx() is None and (engine._adapter_host == -1).all()
    # The adapters move the answers; base rows answer as without a stack.
    assert got[0] != got[1] and got[2] != got[3] and got[4] != got[5]
    if kind == "dense":
        _, base = text_requests(cfg.lm.vocab_size, [60, 61], 6)
        assert serve(ServingEngine(model, cfg, num_slots=4, eos_token_id=-1), base, 3) == [
            got[1], got[3]]


def test_adapter_refusals_and_resolve(models):
    from videollamb_torch.models.lm.mlora import adapter_rows, resolve_adapter_idx
    from videollamb_torch.serve.server import ServingEngine

    _, _, model, cfg = models
    engine = ServingEngine(model, cfg, num_slots=1, eos_token_id=-1)
    _, (req,) = text_requests(cfg.lm.vocab_size, [0], 4, adapter="x")
    engine.submit(req)
    assert req in engine.step(1) and "no adapter registry" in req.error
    assert resolve_adapter_idx({"a": 0, "b": 1}, ["b", None, "a"]).tolist() == [1, -1, 0]
    with pytest.raises(KeyError, match="unknown adapter"):
        resolve_adapter_idx({"a": 0}, ["z"])
    with pytest.raises(ValueError, match="no multi-LoRA stack"):
        with adapter_rows(model.lm, torch.zeros(1, dtype=torch.long)):
            pass


def test_set_adapters_waits_for_adapter_requests(models):
    """The stack swaps only while no adapter request is in flight; dropping
    it gives the base modules back."""
    import copy

    from videollamb_torch.models.lm.mlora import add_multi_lora_params, drop_multi_lora_params
    from videollamb_torch.serve.server import ServingEngine

    _, _, model, cfg = models
    stacked = copy.deepcopy(model)
    _, registry = add_multi_lora_params(stacked.lm, {"a": seeded_adapter(cfg.lm, 1, r=4)})
    engine = ServingEngine(stacked, cfg, num_slots=1, eos_token_id=-1, adapter_registry=registry)
    _, (req,) = text_requests(cfg.lm.vocab_size, [0], 6, adapter="a")
    engine.submit(req)
    engine.step(2)
    with pytest.raises(RuntimeError, match="in flight"):
        engine.set_adapters(model, None)
    engine.run_until_drained(k=2)
    engine.set_adapters(model, None)
    assert engine.model is model and engine.adapter_registry is None
    drop_multi_lora_params(stacked.lm)
    assert stacked.lm.mlora_rows is None
    assert type(stacked.lm.model.layers[0].self_attn.q_proj) is torch.nn.Linear
    _, (req,) = text_requests(cfg.lm.vocab_size, [0], 6, adapter="a")
    engine.submit(req)
    assert req in engine.step(1) and "no adapter registry" in req.error
