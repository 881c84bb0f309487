"""Parameter mapping between the JAX trees, the reference checkpoints and the port.

The port's modules use the reference checkpoints' own names and (out, in)
Linear orientation, so the mapping is mostly prefixes:

- LM: ``model.*`` and ``lm_head.weight`` of the full checkpoint load into
  ``VideoLLaMB.lm`` unchanged;
- bridge: ``model.mm_projector.*`` (or ``mm_projector.*``) loads into
  ``VideoLLaMB.mm_projector`` with the prefix removed;
- towers: a tower dir's ``vision_model.*`` loads into
  ``VideoLLaMB.video_tower`` (or ``VideoLLaMB.image_tower``) unchanged.

:func:`from_jax_params` turns a JAX parameter tree (numpy leaves, as
``videollamb_tpu``'s initialisers and converters produce) into a state dict
of :class:`VideoLLaMB`: kernels are transposed, the LM's stacked layers
unstacked, the patchify kernel reshaped to the conv weight. Quantised
kernels (``{"q", "scale"}`` int8, ``{"q4", "scale", "group"}`` int4) keep the
JAX package's (d_in, d_out) orientation and cross bit for bit: integers stay
int8 / uint8 and scales bfloat16, under ``<module>.q`` / ``.q4`` / ``.scale``.
:func:`load_converted_state` loads such a state, swapping in the modules
that hold quantised kernels first. LoRA leaves (``{proj}_lora_a`` (L, d_in,
r) and ``{proj}_lora_b``) become ``<proj>.lora_a`` / ``.lora_b`` of a
``LoRALinear`` whose base weight is ``<proj>.base.*``.

:func:`to_jax_params` is the inverse for the LM, the bridge (the leaves
training updates) and a float image tower, so a training step of each
package can be compared leaf by leaf. The bridge maps by name for every
projector kind (``models/bridge/variants.py`` keeps the JAX tree's leaf
names).

:func:`research_tower_from_jax` / :func:`research_tower_to_jax` carry the
research towers of ``models/vision/builder.py`` by their kind; their
modules keep the JAX tree's leaf names. ``image_newline`` (the anyres row
terminator) maps to the model's parameter of that name.

:func:`binding_from_jax` / :func:`binding_to_jax` carry the LanguageBind
binding tree (``models/binding.py``: per-modality towers, projections and
logit scales, and the text encoder) both ways.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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


def _put_node(out: State, key: str, node: Any) -> None:
    """One JAX node under the torch name ``key``: {kernel,bias} is a Linear,
    {scale,bias} a LayerNorm, a list a ModuleList (of modules or Linears),
    another dict a module, an array a parameter."""
    if isinstance(node, list):
        for i, child in enumerate(node):
            _put_node(out, f"{key}.{i}", child)
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


def _put_tree(out: State, tree: Mapping[str, Any], prefix: str) -> None:
    """Generic JAX subtree -> torch names (:func:`_put_node` of each child)."""
    for name, node in tree.items():
        _put_node(out, f"{prefix}{name}", node)


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
            key = f"{prefix}{parent}.{name}"
            if f"{name}_lora_a" in layers:
                for ab in ("a", "b"):
                    out[f"{key}.lora_{ab}"] = _t(np.asarray(layers[f"{name}_lora_{ab}"])[i])
                key += ".base"
            if _is_quantized(layers[name]):
                _put_quantized(out, key, layers[name], layer=i)
            else:
                out[f"{key}.weight"] = _t(np.asarray(layers[name])[i].T)
    return out


LM_PARENTS = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
              "o_proj": "self_attn", "gate_proj": "mlp", "up_proj": "mlp", "down_proj": "mlp"}


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _lm_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The entries present in ``sd`` (a whole LM state or a part, such as its
    adapters), with the layers stacked."""
    tree: Dict[str, Any] = {}
    for key, name in (("model.embed_tokens.weight", "embed_tokens"), ("model.norm.weight", "norm")):
        if key in sd:
            tree[name] = _np(sd[key])
    if "lm_head.weight" in sd:
        tree["lm_head"] = _np(sd["lm_head.weight"]).T
    elif "lm_head.scale" in sd:
        tree["lm_head"] = {k: _np(sd[f"lm_head.{k}"]) for k in ("q", "q4", "scale")
                           if f"lm_head.{k}" in sd}
    layer_ids = {int(k.split(".")[2]) for k in sd if k.startswith("model.layers.")}
    if not layer_ids:
        return tree
    n_layers = 1 + max(layer_ids)
    layers: Dict[str, Any] = {}

    def stack(keys, leaf_fn=_np):
        if all(k in sd for k in keys):
            return np.stack([leaf_fn(sd[k]) for k in keys])
        return None

    for norm in ("input_layernorm", "post_attention_layernorm"):
        value = stack([f"model.layers.{i}.{norm}.weight" for i in range(n_layers)])
        if value is not None:
            layers[norm] = value
    for name, parent in LM_PARENTS.items():
        keys = [f"model.layers.{i}.{parent}.{name}" for i in range(n_layers)]
        for ab in ("a", "b"):
            value = stack([f"{k}.lora_{ab}" for k in keys])
            if value is not None:
                layers[f"{name}_lora_{ab}"] = value
        if f"{keys[0]}.base.weight" in sd or f"{keys[0]}.base.scale" in sd:
            keys = [f"{k}.base" for k in keys]
        value = stack([f"{k}.weight" for k in keys], lambda t: _np(t).T)
        if value is not None:
            layers[name] = value
        elif f"{keys[0]}.scale" in sd:
            layers[name] = {leaf: stack([f"{k}.{leaf}" for k in keys])
                            for leaf in ("q", "q4", "scale") if f"{keys[0]}.{leaf}" in sd}
    tree["layers"] = layers
    return tree


def _bridge_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Nested dicts by dotted name (:func:`_nested_to_jax`); ``mlp.0`` /
    ``proj.0`` are ``mlp.dense`` / ``proj.dense``."""
    return _nested_to_jax({k.replace(".mlp.0.", ".mlp.dense.").replace(
        "projector.proj.0.", "projector.proj.dense."): v for k, v in sd.items()})


def to_jax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A :class:`VideoLLaMB` state dict (or any part of it) -> the JAX tree of
    its ``lm``, ``mm_projector`` and ``image_tower`` entries, numpy leaves
    (bf16 as f32)."""
    tree: Dict[str, Any] = {}
    lm = {k[3:]: v for k, v in state.items() if k.startswith("lm.")}
    if lm:
        tree["lm"] = _lm_to_jax(lm)
    bridge = {k[len("mm_projector."):]: v for k, v in state.items()
              if k.startswith("mm_projector.")}
    if bridge:
        tree["mm_projector"] = _bridge_to_jax(bridge)
    image = {k[len("image_tower."):]: v for k, v in state.items()
             if k.startswith("image_tower.")}
    if image:
        tree["image_tower"] = _tower_to_jax(image)
    if "image_newline" in state:
        tree["image_newline"] = _np(state["image_newline"])
    return tree


def from_jax_params(tree: Mapping[str, Any], tower: Optional[str] = None) -> State:
    """JAX parameter tree ({'lm', 'mm_projector', 'video_tower', 'image_tower',
    'image_newline'}, numpy leaves) -> state dict of
    :class:`videollamb_torch.models.assembly.VideoLLaMB`. ``tower`` names a
    research tower's kind (``TowerSpec.kind``) whose converter maps the
    tower entries; the default is the CLIP family's."""
    state: State = {}
    tower_fn = _tower_from_jax if tower is None else (lambda t: research_tower_from_jax(tower, t))
    parts = (("lm", _lm_from_jax), ("mm_projector", _bridge_from_jax),
             ("video_tower", tower_fn), ("image_tower", tower_fn))
    for key, fn in parts:
        if key in tree:
            state.update({f"{key}.{k}": v for k, v in fn(tree[key]).items()})
    if "image_newline" in tree:
        state["image_newline"] = _t(tree["image_newline"])
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


def _nested_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`_put_tree` for float leaves: dotted names -> nested
    dicts, numbered children -> lists; a LayerNorm's weight is its ``scale``,
    a Linear's transposed weight its ``kernel``."""
    tree: Dict[str, Any] = {}
    for key, value in sd.items():
        parts = key.split(".")
        leaf = parts[-1]
        if leaf == "weight":
            leaf = "scale" if "norm" in parts[-2] else "kernel"
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = _np(value).T if leaf == "kernel" else _np(value)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def _tower_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`_tower_from_jax` (float towers): ``vision_model.*``
    state -> the JAX tower tree."""
    vm = {k[len("vision_model."):]: v for k, v in sd.items() if k.startswith("vision_model.")}
    weight = _np(vm["embeddings.patch_embedding.weight"])
    tree: Dict[str, Any] = {
        "embeddings": {
            "class_embedding": _np(vm["embeddings.class_embedding"]),
            "patch_embedding": {"kernel": weight.reshape(weight.shape[0], -1).T},
            "position_embedding": _np(vm["embeddings.position_embedding.weight"]),
        },
        "pre_layrnorm": {"scale": _np(vm["pre_layrnorm.weight"]),
                         "bias": _np(vm["pre_layrnorm.bias"])},
        "post_layernorm": {"scale": _np(vm["post_layernorm.weight"]),
                           "bias": _np(vm["post_layernorm.bias"])},
    }
    layers = _nested_to_jax({k[len("encoder.layers."):]: v for k, v in vm.items()
                             if k.startswith("encoder.layers.")
                             and not k.endswith("temporal_embedding")})
    for i, layer in enumerate(layers):
        temb = vm.get(f"encoder.layers.{i}.temporal_embedding")
        if temb is not None:
            layer["temporal_embedding"] = _np(temb).reshape(-1, temb.shape[-1])
    tree["layers"] = layers
    return tree


def _text_from_jax(tree: Mapping[str, Any]) -> State:
    out: State = {"text_model.embeddings.token_embedding.weight": _t(tree["token_embedding"]),
                  "text_model.embeddings.position_embedding.weight":
                      _t(tree["position_embedding"])}
    _put_tree(out, {"final_layer_norm": tree["final_layer_norm"]}, "text_model.")
    for i, layer in enumerate(tree["layers"]):
        _put_tree(out, layer, f"text_model.encoder.layers.{i}.")
    return out


def _text_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    tm = {k[len("text_model."):]: v for k, v in sd.items() if k.startswith("text_model.")}
    return {
        "token_embedding": _np(tm["embeddings.token_embedding.weight"]),
        "position_embedding": _np(tm["embeddings.position_embedding.weight"]),
        "layers": _nested_to_jax({k[len("encoder.layers."):]: v for k, v in tm.items()
                                  if k.startswith("encoder.layers.")}),
        "final_layer_norm": {"scale": _np(tm["final_layer_norm.weight"]),
                             "bias": _np(tm["final_layer_norm.bias"])},
    }


def binding_from_jax(tree: Mapping[str, Any]) -> State:
    """JAX binding tree ({"modalities": {name: {"tower", "projection",
    "logit_scale"}}, "text": {"encoder", "projection"}}, numpy leaves) ->
    state dict of :class:`videollamb_torch.models.binding.LanguageBind`.
    Projections are (in, out) in JAX and (out, in) Linear weights here."""
    state: State = {}
    for name, mod in tree["modalities"].items():
        pre = f"modalities.{name}."
        state.update({pre + "tower." + k: v for k, v in _tower_from_jax(mod["tower"]).items()})
        state[pre + "projection.weight"] = _t(np.asarray(mod["projection"]).T)
        state[pre + "logit_scale"] = _t(mod["logit_scale"])
    state.update({"text.encoder." + k: v
                  for k, v in _text_from_jax(tree["text"]["encoder"]).items()})
    state["text.projection.weight"] = _t(np.asarray(tree["text"]["projection"]).T)
    return state


def binding_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`binding_from_jax`: a ``LanguageBind`` state dict ->
    the JAX binding tree, numpy leaves (bf16 as f32)."""
    names = sorted({k.split(".")[1] for k in state if k.startswith("modalities.")})
    tree: Dict[str, Any] = {"modalities": {}}
    for name in names:
        pre = f"modalities.{name}."
        tower = {k[len(pre + "tower."):]: v for k, v in state.items()
                 if k.startswith(pre + "tower.")}
        tree["modalities"][name] = {
            "tower": _tower_to_jax(tower),
            "projection": _np(state[pre + "projection.weight"]).T,
            "logit_scale": _np(state[pre + "logit_scale"]),
        }
    text = {k[len("text.encoder."):]: v for k, v in state.items() if k.startswith("text.encoder.")}
    tree["text"] = {"encoder": _text_to_jax(text),
                    "projection": _np(state["text.projection.weight"]).T}
    return tree


# ---------------------------------------------------------------------------
# Research towers (models/vision/{vit,rmt_clip_vit,deform_clip,deformable,egovlp}.py)
# ---------------------------------------------------------------------------


def _put_research(out: State, key: str, node: Any) -> None:
    """One node of a research tower's JAX tree under the torch name ``key``:
    {kernel[, bias]} is a Linear ((in, out) kernel, transposed) or a
    convolution (OIHW kernel, as is), a bias of None is absent;
    {scale, bias, mean, var} an inference BatchNorm; {scale, bias} a
    LayerNorm or GroupNorm; lists are numbered children."""
    if isinstance(node, list):
        for i, child in enumerate(node):
            _put_research(out, f"{key}.{i}", child)
    elif isinstance(node, dict) and "kernel" in node:
        kernel = np.asarray(node["kernel"])
        out[f"{key}.weight"] = _t(kernel.T if kernel.ndim == 2 else kernel)
        if node.get("bias") is not None:
            out[f"{key}.bias"] = _t(node["bias"])
    elif isinstance(node, dict) and "scale" in node:
        out[f"{key}.weight"] = _t(node["scale"])
        out[f"{key}.bias"] = _t(node["bias"])
        if "mean" in node:
            out[f"{key}.running_mean"] = _t(node["mean"])
            out[f"{key}.running_var"] = _t(node["var"])
    elif isinstance(node, dict):
        for name, child in node.items():
            _put_research(out, f"{key}.{name}" if key else name, child)
    else:
        out[key] = _t(node)


def _research_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`_put_research`: a 2-D ``weight`` is a transposed
    kernel, a 4-D one a convolution kernel, a 1-D one a norm's scale;
    running statistics are a BatchNorm's mean and var."""
    tree: Dict[str, Any] = {}
    rename = {"running_mean": "mean", "running_var": "var"}
    for key, value in sd.items():
        parts = key.split(".")
        leaf = rename.get(parts[-1], parts[-1])
        arr = _np(value)
        if leaf == "weight":
            leaf, arr = (("scale", arr) if arr.ndim == 1 else
                         ("kernel", arr.T if arr.ndim == 2 else arr))
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def _clip_embeddings_from_jax(emb: Mapping[str, Any], prefix: str) -> State:
    kernel = np.asarray(emb["patch_embedding"]["kernel"])  # (C*p*p, D)
    d = kernel.shape[1]
    p = int(round((kernel.shape[0] // 3) ** 0.5))
    return {f"{prefix}class_embedding": _t(emb["class_embedding"]),
            f"{prefix}patch_embedding.weight": _t(kernel.T.reshape(d, 3, p, p)),
            f"{prefix}position_embedding.weight": _t(emb["position_embedding"])}


def research_tower_from_jax(kind: str, tree: Mapping[str, Any]) -> State:
    """A tower of ``kind`` (``TowerSpec.kind``), as the JAX package's
    ``init_*_params`` / converters build it -> the port module's state."""
    if kind == "rmt_languagebind_video":
        out = _tower_from_jax({k: v for k, v in tree.items() if k != "encoder_memory"})
        _put_research(out, "encoder_memory", tree["encoder_memory"])
        return out
    if kind == "deform_clip":
        out = _clip_embeddings_from_jax(tree["embeddings"], "embeddings.")
        _put_research(out, "", {k: v for k, v in tree.items() if k != "embeddings"})
        return out
    if kind in ("vit", "vitmae", "vivit", "videomae", "deformable", "egovlp"):
        out: State = {}
        _put_research(out, "", tree)
        return out
    return _tower_from_jax(tree)


def research_tower_to_jax(kind: str, state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`research_tower_from_jax` (float towers)."""
    if kind == "rmt_languagebind_video":
        tree = _tower_to_jax(state)
        tree["encoder_memory"] = {k.split(".")[-1]: _np(v) for k, v in state.items()
                                  if k.startswith("encoder_memory.")}
        return tree
    if kind == "deform_clip":
        weight = _np(state["embeddings.patch_embedding.weight"])
        tree = _research_to_jax({k: v for k, v in state.items()
                                 if not k.startswith("embeddings.")})
        tree["embeddings"] = {
            "class_embedding": _np(state["embeddings.class_embedding"]),
            "patch_embedding": {"kernel": weight.reshape(weight.shape[0], -1).T},
            "position_embedding": _np(state["embeddings.position_embedding.weight"])}
        return tree
    if kind in ("vit", "vitmae", "vivit", "videomae", "deformable", "egovlp"):
        return _research_to_jax(state)
    return _tower_to_jax(state)


# ---------------------------------------------------------------------------
# EgoVLP's text side (models/vision/egovlp_text.py) and its fusion tower
# ---------------------------------------------------------------------------

_TEXT_STACKS = {"layers": "layers", "fuse_layers": "fuse_layers"}


def _unstack(node: Mapping[str, Any]) -> list:
    """A scanned stack (every leaf with a leading layer axis) -> one subtree a layer."""
    leaves = []

    def walk(n, path):
        if isinstance(n, Mapping):
            for k, v in n.items():
                walk(v, path + (k,))
        else:
            leaves.append((path, np.asarray(n)))

    walk(node, ())
    out = [dict() for _ in range(leaves[0][1].shape[0])]
    for path, arr in leaves:
        for i, layer in enumerate(out):
            d = layer
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = arr[i]
    return out


def _stack(layers: list) -> Dict[str, Any]:
    if not layers:
        return None
    if isinstance(layers[0], Mapping):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers)


def egovlp_text_from_jax(tree: Mapping[str, Any]) -> State:
    """The JAX ``init_egovlp_text_params`` tree -> the state of
    ``egovlp_text.EgoVLPText``; a ``video`` entry (``init_fusion_video_params``'
    tree, its blocks split into ``blocks`` and ``fuse_blocks``) comes back
    under ``video.`` for the fusion ``EgoVLPTower``. The scanned layer stacks
    are unstacked; the MLM decoder is already (vocab, d)."""
    tree = dict(tree)
    out: State = {}
    video = tree.pop("video", None)
    text = dict(tree.pop("text_model"))
    for key in _TEXT_STACKS:
        text[key] = [] if text.get(key) is None else _unstack(text[key])
    _put_research(out, "text_model", text)
    mlm = dict(tree.pop("mlm_head"))
    out["mlm_head.decoder.weight"] = _t(mlm.pop("decoder")["kernel"])
    _put_research(out, "mlm_head", mlm)
    _put_research(out, "", tree)
    if video is not None:
        video = dict(video)
        video["blocks"] = _unstack(video["blocks"]) + _unstack(video.pop("fuse_blocks"))
        out.update({f"video.{k}": v for k, v in research_tower_from_jax("egovlp", video).items()})
    return out


def egovlp_text_to_jax(state: Mapping[str, torch.Tensor], n_fuse_video: int = 0
                       ) -> Dict[str, Any]:
    """Inverse of :func:`egovlp_text_from_jax`; ``n_fuse_video`` is the
    count of fusion blocks of a ``video.`` tower in ``state``."""
    text = {k: v for k, v in state.items() if not k.startswith("video.")}
    tree = _research_to_jax({k: v for k, v in text.items() if k != "mlm_head.decoder.weight"})
    tree["mlm_head"]["decoder"] = {"kernel": _np(text["mlm_head.decoder.weight"])}
    for key in _TEXT_STACKS:
        tree["text_model"][key] = _stack(tree["text_model"].get(key, []))
    video = {k[len("video."):]: v for k, v in state.items() if k.startswith("video.")}
    if video:
        vt = research_tower_to_jax("egovlp", video)
        blocks = vt.pop("blocks")
        cut = len(blocks) - n_fuse_video
        vt["blocks"], vt["fuse_blocks"] = _stack(blocks[:cut]), _stack(blocks[cut:])
        tree["video"] = vt
    return tree
