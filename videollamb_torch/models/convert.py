"""Parameter mapping between the JAX trees, the reference checkpoints and the port.

The port's modules use the reference checkpoints' own names and (out, in)
Linear orientation, so the mapping is mostly prefixes:

- LM: ``model.*`` and ``lm_head.weight`` of the full checkpoint load into
  ``VideoLLaMB.lm`` unchanged;
- bridge: ``model.mm_projector.*`` (or ``mm_projector.*``) loads into
  ``VideoLLaMB.mm_projector`` with the prefix removed;
- tower: the tower dir's ``vision_model.*`` loads into
  ``VideoLLaMB.video_tower`` unchanged.

:func:`from_jax_params` turns a JAX parameter tree (numpy leaves, as
``videollamb_tpu``'s initialisers and converters produce) into a state dict
of :class:`VideoLLaMB`: kernels are transposed, the LM's stacked layers
unstacked, the patchify kernel reshaped to the conv weight. Quantised
kernels (``{"q", "scale"}`` int8, ``{"q4", "scale", "group"}`` int4) keep the
JAX package's (d_in, d_out) orientation and cross bit for bit: integers stay
int8 / uint8 and scales bfloat16, under ``<module>.q`` / ``.q4`` / ``.scale``.
:func:`load_converted_state` loads such a state, swapping in the modules
that hold quantised kernels first.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

State = Dict[str, torch.Tensor]

LM_SKIP = ("model.mm_projector.", "model.video_tower.", "model.image_tower.")


def _t(x) -> torch.Tensor:
    """A leaf as a tensor: integers and bfloat16 keep their bits, other floats
    become float32."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype in (np.int8, np.uint8):
        return torch.from_numpy(a.copy())
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _is_quantized(kernel) -> bool:
    return isinstance(kernel, Mapping) and ("q" in kernel or "q4" in kernel)


def _put_quantized(out: State, key: str, kernel: Mapping[str, Any], layer=None) -> None:
    """A quantised kernel's integers and scales under ``key.``; ``layer``
    picks one slice of a stacked kernel. The int4 ``group`` leaf is implied
    by the shapes and dropped."""
    for name in ("q", "q4", "scale"):
        if name in kernel:
            leaf = np.asarray(kernel[name])
            out[f"{key}.{name}"] = _t(leaf if layer is None else leaf[layer])


def split_reference_state(sd: Mapping[str, torch.Tensor]):
    """Full reference checkpoint -> (LM state, bridge state) in the port's names."""
    lm = {k: v for k, v in sd.items()
          if k == "lm_head.weight" or (k.startswith("model.") and not k.startswith(LM_SKIP))}
    prefix = ("model.mm_projector."
              if any(k.startswith("model.mm_projector.") for k in sd) else "mm_projector.")
    bridge = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if "lm_head.weight" not in lm and "model.embed_tokens.weight" in lm:
        lm["lm_head.weight"] = lm["model.embed_tokens.weight"]  # tied embeddings
    return lm, bridge


def tower_state(sd: Mapping[str, torch.Tensor]) -> State:
    """A LanguageBind tower dir's state dict -> the tower module's state."""
    return {k: v for k, v in sd.items()
            if k.startswith("vision_model.") and not k.endswith("position_ids")}


def _put_tree(out: State, tree: Mapping[str, Any], prefix: str) -> None:
    """Generic JAX subtree -> torch names: {kernel,bias} is a Linear,
    {scale,bias} a LayerNorm, lists index ModuleLists."""
    for name, node in tree.items():
        key = f"{prefix}{name}"
        if isinstance(node, list):
            for i, child in enumerate(node):
                _put_tree(out, child, f"{key}.{i}.")
        elif isinstance(node, dict) and "kernel" in node:
            if _is_quantized(node["kernel"]):
                _put_quantized(out, key, node["kernel"])
            else:
                out[f"{key}.weight"] = _t(np.asarray(node["kernel"]).T)
            if "bias" in node:
                out[f"{key}.bias"] = _t(node["bias"])
        elif isinstance(node, dict) and "scale" in node:
            out[f"{key}.weight"] = _t(node["scale"])
            out[f"{key}.bias"] = _t(node["bias"])
        elif isinstance(node, dict):
            _put_tree(out, node, f"{key}.")
        else:
            out[key] = _t(node)


def _bridge_from_jax(tree: Mapping[str, Any]) -> State:
    out: State = {}
    _put_tree(out, tree, "")
    # Sequential children: mlp.0 and proj.0 hold the Linear of mlp.dense / proj.dense.
    return {k.replace(".mlp.dense.", ".mlp.0.").replace("projector.proj.dense.",
                                                         "projector.proj.0."): v
            for k, v in out.items()}


def _tower_from_jax(tree: Mapping[str, Any]) -> State:
    out: State = {}
    layers = tree["layers"]
    emb = tree["embeddings"]
    kernel = emb["patch_embedding"]["kernel"]  # (C*p*p, D), or its int8 dictionary
    d = np.asarray(emb["class_embedding"]).shape[0]
    out["vision_model.embeddings.class_embedding"] = _t(emb["class_embedding"])
    if _is_quantized(kernel):
        _put_quantized(out, "vision_model.embeddings.patch_embedding", kernel)
    else:
        kernel = np.asarray(kernel)
        p = int(round((kernel.shape[0] // 3) ** 0.5))
        out["vision_model.embeddings.patch_embedding.weight"] = _t(kernel.T.reshape(d, 3, p, p))
    out["vision_model.embeddings.position_embedding.weight"] = _t(emb["position_embedding"])
    _put_tree(out, {"pre_layrnorm": tree["pre_layrnorm"],
                    "post_layernorm": tree["post_layernorm"]}, "vision_model.")
    for i, layer in enumerate(layers):
        layer = dict(layer)
        temb = layer.pop("temporal_embedding", None)
        prefix = f"vision_model.encoder.layers.{i}."
        _put_tree(out, layer, prefix)
        if temb is not None:
            out[prefix + "temporal_embedding"] = _t(np.asarray(temb).reshape(1, -1, d))
    return out


def _lm_from_jax(tree: Mapping[str, Any]) -> State:
    out: State = {"model.embed_tokens.weight": _t(tree["embed_tokens"]),
                  "model.norm.weight": _t(tree["norm"])}
    if _is_quantized(tree["lm_head"]):
        _put_quantized(out, "lm_head", tree["lm_head"])
    else:
        out["lm_head.weight"] = _t(np.asarray(tree["lm_head"]).T)
    layers = tree["layers"]
    names = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
             "o_proj": "self_attn", "gate_proj": "mlp", "up_proj": "mlp",
             "down_proj": "mlp"}
    for i in range(np.asarray(layers["input_layernorm"]).shape[0]):
        prefix = f"model.layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[f"{prefix}{norm}.weight"] = _t(np.asarray(layers[norm])[i])
        for name, parent in names.items():
            if _is_quantized(layers[name]):
                _put_quantized(out, f"{prefix}{parent}.{name}", layers[name], layer=i)
            else:
                out[f"{prefix}{parent}.{name}.weight"] = _t(np.asarray(layers[name])[i].T)
    return out


def from_jax_params(tree: Mapping[str, Any]) -> State:
    """JAX parameter tree ({'lm', 'mm_projector', 'video_tower'}, numpy leaves)
    -> state dict of :class:`videollamb_torch.models.assembly.VideoLLaMB`."""
    state: State = {}
    parts = (("lm", _lm_from_jax), ("mm_projector", _bridge_from_jax),
             ("video_tower", _tower_from_jax))
    for key, fn in parts:
        if key in tree:
            state.update({f"{key}.{k}": v for k, v in fn(tree[key]).items()})
    return state


def load_converted_state(model: torch.nn.Module, state: Mapping[str, torch.Tensor],
                         prefix: str = "") -> None:
    """``load_state_dict(strict=True)`` of a state that may hold quantised
    kernels: every module whose entry is ``<name>.q`` / ``<name>.q4`` is first
    replaced by an empty holder of those shapes (``QuantLinear`` in the LM,
    ``Int8Dense`` in the tower). ``prefix`` is the model's place in the state's
    names (``"lm."`` when ``model`` is the LM of a whole-model state)."""
    from videollamb_torch.models.lm.quant import QuantLinear
    from videollamb_torch.models.vision.quant import Int8Dense

    state = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    for key in [k for k in state if k.endswith((".q", ".q4"))]:
        path, _, leaf = key.rpartition(".")
        parent_path, _, name = path.rpartition(".")
        parent = model.get_submodule(parent_path) if parent_path else model
        scale = state[f"{path}.scale"]
        if "video_tower" in f"{prefix}{path}".split(".") or "vision_model" in path.split("."):
            bias = state.get(f"{path}.bias")
            holder = Int8Dense.empty(*state[key].shape, bias=bias is not None,
                                     dtype=bias.dtype if bias is not None else torch.float32)
        else:
            holder = QuantLinear.empty(leaf, state[key].shape, scale.shape)
        setattr(parent, name, holder)
    model.load_state_dict(state, strict=True)
