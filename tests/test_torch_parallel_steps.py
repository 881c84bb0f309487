"""The port's multi-GPU training of the whole model on four gloo ranks on the
CPU, against the JAX package (``ModelConfig.tiny``, f32, dropout off):

- ``sharding.param_specs`` equals JAX's ``param_specs`` table on a model
  with LoRA and multi-LoRA leaves, dim for dim in torch's orientation;
- FSDP x TP (``create_mesh(2, 2)``: ``shard_params``, then the sharded step)
  for the full, the stage-1 (adapter) and the LoRA recipes (LoRA r 4 on
  every LM projection, seeded non-zero A and B), and the multi-host
  ('replica', 'data', 'model') mesh (2, 1, 2) for the full recipe;
- the sequence-parallel multimodal step at 4 shards and the pipelined one at
  2 stages x 2 data ranks (2 microbatches each).

Every run takes two steps over one global batch of four rows (each data
rank its rows), the first at lr 0 under warmup, both clipping at a global
norm of 0.05, and must give JAX's step's loss (rtol 1e-5), grad_norm (rtol
1e-4) and updated trained parameters (rtol 1e-4, atol 1e-5: 1 % of one
update at lr 1e-3, the leaf tolerance of tests/test_torch_train_step.py;
Adam moves an entry whose gradient is rounding noise, such as a key bias's,
by an amount that noise sets). JAX's step is ``train.step.make_train_step``
on one device: its sharded runs compute the same function (GSPMD), which
JAX's own tests hold (tests/test_parallel.py, test_seq_parallel.py,
test_pipeline.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import test_torch_dist_utils as du  # noqa: E402
from test_torch_parity_utils import port_config, port_model  # noqa: E402

from videollamb_tpu.config import BridgeConfig, ModelConfig  # noqa: E402
from videollamb_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from videollamb_tpu.constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX  # noqa: E402

CFG = ModelConfig.tiny(max_length=96, bridge=BridgeConfig(
    hidden_size=32, num_attention_heads=4, intermediate_size=64, num_memory_tokens=8,
    pool_h=2, pool_w=2, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
TRAIN_KW = dict(learning_rate=1e-3, warmup_ratio=0.25, max_grad_norm=0.05)
TOTAL, STEPS = 4, 2
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
LEAF_RTOL, LEAF_ATOL = 1e-4, 0.01 * TRAIN_KW["learning_rate"]
TASKS = ["fsdp_tp_full", "fsdp_tp_stage1", "fsdp_tp_lora", "multislice_full",
         "seq_parallel_videollamb", "pipeline_videollamb"]
LORA_R, LORA_ALPHA = 4, 8.0


def _batch():
    rng = np.random.default_rng(4)
    ids = rng.integers(4, CFG.lm.vocab_size, size=(4, 20)).astype(np.int32)
    ids[:, 2] = VIDEO_TOKEN_INDEX
    mask = (np.arange(20)[None] < np.array([[20], [14], [17], [20]])).astype(np.int32)
    labels = np.where(mask > 0, ids, IGNORE_INDEX).astype(np.int32)
    labels[:, :5] = IGNORE_INDEX
    img = CFG.vision.image_size
    videos = rng.normal(size=(4, 8, 3, img, img)).astype(np.float32)
    return ids, mask, labels, videos


def _params():
    """``test_torch_parity_utils.jax_params(CFG, seed=9)``, its initialisers
    under one ``jax.jit`` (op by op they cost seconds of compiles)."""
    from videollamb_tpu.models.bridge.rmt_r import init_rmt_r_params
    from videollamb_tpu.models.lm.llama import init_llama_params
    from videollamb_tpu.models.vision.clip_vit import init_vision_params

    def init(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return {"video_tower": init_vision_params(k1, CFG.vision),
                "mm_projector": init_rmt_r_params(k2, CFG.bridge, CFG.lm.hidden_size),
                "lm": init_llama_params(k3, CFG.lm)}

    return jax.tree.map(np.asarray, jax.jit(init)(jax.random.PRNGKey(9)))


def _lora_params(tree):
    """``tree`` with seeded LoRA leaves on every LM projection (B non-zero,
    so the adapters change the forward from the first step)."""
    from videollamb_torch.models.lm.lora import LORA_TARGETS

    rng = np.random.default_rng(2)
    layers = dict(tree["lm"]["layers"])
    for name in LORA_TARGETS:
        n, d_in, d_out = layers[name].shape
        layers[f"{name}_lora_a"] = rng.normal(size=(n, d_in, LORA_R)).astype(np.float32) * 0.2
        layers[f"{name}_lora_b"] = rng.normal(size=(n, LORA_R, d_out)).astype(np.float32) * 0.02
    return {**tree, "lm": {**tree["lm"], "layers": layers}}


def _jax_run(tree, tune_mode, arrays):
    from videollamb_tpu.models.assembly import MultimodalBatch
    from videollamb_tpu.train.step import (
        create_optimizer,
        create_train_state,
        make_train_step,
        trainable_mask,
    )

    params = jax.tree.map(jnp.asarray, tree)
    tcfg = JaxTrainConfig(**TRAIN_KW, tune_mode=tune_mode)
    tx = create_optimizer(tcfg, TOTAL, params)
    state = create_train_state(params, tx)
    step = jax.jit(make_train_step(CFG, tx, remat=False, attn_impl="chunked",
                                   mask=trainable_mask(tcfg, params)))
    batch = MultimodalBatch(*(jnp.asarray(a) for a in arrays), images=None)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        metrics.append((float(m["loss"]), float(m["grad_norm"]), int(m["tokens"])))
    return jax.tree.map(np.asarray, state.params), metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree = _params()
    arrays = _batch()
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    lora_tree = _lora_params(tree)
    spec = {"tasks": TASKS, "cfg": port_config(CFG), "tree": tree, "batch": arrays,
            "train_kw": TRAIN_KW, "total_steps": TOTAL, "n_steps": STEPS,
            "lora": {"r": LORA_R, "alpha": LORA_ALPHA, "tree": lora_tree}}
    ctx = du.start_ranks(4, spec, out_dir)
    try:
        ref = {mode: _jax_run(tree, mode, arrays) for mode in ("full", "adapter")}
        ref["lora"] = _jax_run(lora_tree, "lora", arrays)
    finally:
        results = du.join_ranks(ctx, out_dir, 4)
    return ref, results


def _check(ref, got):
    from videollamb_torch.models.convert import to_jax_params

    jparams, jmetrics = ref
    for (pl, pn, pt), (jl, jn, jt) in zip(got["metrics"], jmetrics):
        assert pt == jt
        np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(pn, jn, rtol=NORM_RTOL)
        assert pn > TRAIN_KW["max_grad_norm"]  # every update clips
    trained = {k: torch.from_numpy(v) for k, v in got["params"].items()}
    flat = dict(jax.tree_util.tree_flatten_with_path(to_jax_params(trained))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert flat
    for path, value in flat.items():
        ref_leaf = np.asarray(want[path])
        np.testing.assert_allclose(value, ref_leaf, rtol=LEAF_RTOL, atol=LEAF_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name,mode", [("fsdp_tp_full", "full"), ("fsdp_tp_stage1", "adapter"),
                                       ("fsdp_tp_lora", "lora"), ("multislice_full", "full"),
                                       ("seq_parallel_videollamb", "full"),
                                       ("pipeline_videollamb", "full")])
def test_parallel_step_equal_jax(runs, name, mode):
    ref, results = runs
    for rank in range(4):
        got = du.result(results, name, rank)
        if name == "pipeline_videollamb":  # each stage holds its own layers
            got = dict(got)
            shared = {k: v for k, v in got["params"].items()
                      if not k.startswith("lm.model.layers.")}
            layers = {}
            for r in (rank - rank % 2, rank - rank % 2 + 1):  # the two stages of a replica
                layers.update({k: v for k, v in du.result(results, name, r)["params"].items()
                               if k.startswith("lm.model.layers.")})
            got["params"] = {**shared, **layers}
        _check(ref[mode], got)


def test_shards_are_local(runs):
    """Under FSDP x TP each rank holds a quarter of a q_proj (out over
    'model', in over 'data'), half of a norm (over 'data') and its LoRA
    leaves split as JAX's table splits them."""
    _, results = runs
    shapes = du.result(results, "fsdp_tp_full", 0)["local_shapes"]
    d, h = CFG.lm.hidden_size, CFG.lm.num_attention_heads * CFG.lm.head_dim
    assert shapes["lm.model.layers.0.self_attn.q_proj.weight"] == (h // 4, d)
    assert shapes["lm.model.layers.0.input_layernorm.weight"] == (d // 2,)
    vd = CFG.vision.hidden_size
    assert shapes["video_tower.vision_model.encoder.layers.0.self_attn.q_proj.weight"] \
        == (vd // 4, vd)
    # LoRA: B shards with a column-parallel base's outputs, A with a
    # row-parallel base's inputs (over 'model'); FSDP splits dim 0 over 'data'.
    shapes = du.result(results, "fsdp_tp_lora", 0)["local_shapes"]
    attn = "lm.model.layers.0.self_attn"
    assert shapes[f"{attn}.q_proj.lora_a"] == (d // 2, LORA_R)
    assert shapes[f"{attn}.q_proj.lora_b"] == (LORA_R // 2, h // 2)
    assert shapes[f"{attn}.o_proj.lora_a"] == (h // 4, LORA_R)
    assert shapes[f"{attn}.o_proj.lora_b"] == (LORA_R // 2, d)
    mesh = du.result(results, "multislice_full", 0)["mesh"]
    assert mesh == (("replica", "data", "model"), (2, 1, 2))


def _jax_spec_for(name, table):
    """JAX's PartitionSpec of the port parameter ``name``, in torch's
    orientation (a Linear weight transposed, the layer axis dropped)."""
    parts = name.split(".")
    if parts[0] == "mm_projector":
        return ()
    if parts[0] == "lm":
        lm = table["lm"]
        if name == "lm.model.embed_tokens.weight":
            return tuple(lm["embed_tokens"])
        if name == "lm.lm_head.weight":
            return tuple(reversed(tuple(lm["lm_head"])))
        if name == "lm.model.norm.weight":
            return tuple(lm["norm"])
        if parts[4].endswith("layernorm"):
            return tuple(lm["layers"][parts[4]])[1:]
        proj, rest = parts[5], parts[6:]
        if rest[-1] == "weight":
            return tuple(reversed(tuple(lm["layers"][proj])[1:]))
        # A multi-LoRA stack wraps the LoRA module: its own leaves are the outer ones.
        stacked = f"{proj}_mlora_a" in lm["layers"]
        kind = "mlora" if stacked and rest[0] != "base" else "lora"
        return tuple(lm["layers"][f"{proj}_{kind}_{rest[-1][-1]}"])[1:]
    node = table[parts[0]]
    if parts[2] == "encoder":
        node, parts = node["layers"][int(parts[4])], parts[5:]
    else:
        parts = parts[2:]
    for part in parts[:-1]:
        node = node[part]
    leaf = parts[-1]
    if "patch_embedding" in name:
        return (tuple(node["kernel"])[1], None, None, None)
    if leaf in ("class_embedding", "temporal_embedding"):
        return tuple(node[leaf])
    if "position_embedding" in name:
        return tuple(node)
    if leaf == "weight":
        return tuple(reversed(tuple(node["kernel" if "kernel" in node else "scale"])))
    return tuple(node["bias"])


def _norm(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _jax_structure(model, mlora: bool) -> dict:
    """A JAX parameter tree with the port model's structure (the table reads
    names, not values)."""
    from videollamb_torch.parallel.sharding import LM_PARENTS

    layers = {"input_layernorm": 0, "post_attention_layernorm": 0}
    for name in LM_PARENTS:
        layers.update({name: 0, f"{name}_lora_a": 0, f"{name}_lora_b": 0})
        if mlora and name in ("q_proj", "v_proj"):
            layers.update({f"{name}_mlora_a": 0, f"{name}_mlora_b": 0})
    tower = [{"temporal_attn": 0} if hasattr(layer, "temporal_attn") else {}
             for layer in model.video_tower.vision_model.encoder.layers]
    return {"lm": {"embed_tokens": 0, "layers": layers, "norm": 0, "lm_head": 0},
            "video_tower": {"layers": tower}, "mm_projector": {"x": 0}}


@pytest.mark.parametrize("fsdp,tp", [(True, True), (False, True), (True, False)])
def test_param_specs_equal_jax(fsdp, tp):
    from videollamb_tpu.parallel.sharding import param_specs as jax_specs
    from videollamb_torch.models.lm.lora import add_lora_params
    from videollamb_torch.models.lm.mlora import add_multi_lora_params
    from videollamb_torch.parallel.sharding import param_specs

    tree = _params()
    cfg = port_config(CFG)
    lm_cfg = cfg.lm
    n, d, h = lm_cfg.num_hidden_layers, lm_cfg.hidden_size, lm_cfg.num_attention_heads
    kv = lm_cfg.num_key_value_heads * lm_cfg.head_dim
    adapter = {"q_proj_lora_a": np.zeros((n, d, 2), np.float32),
               "q_proj_lora_b": np.zeros((n, 2, h * lm_cfg.head_dim), np.float32),
               "v_proj_lora_a": np.zeros((n, d, 2), np.float32),
               "v_proj_lora_b": np.zeros((n, 2, kv), np.float32)}
    for mlora in (False, True):
        model = port_model(CFG, tree)
        add_lora_params(model.lm, lm_cfg, r=4, alpha=8.0,
                        generator=torch.Generator().manual_seed(0))
        if mlora:
            add_multi_lora_params(model.lm, {"a": adapter, "b": adapter})
        table = jax_specs(_jax_structure(model, mlora), shard_params_over_data=fsdp,
                          tensor_parallel=tp)
        ours = param_specs(model, shard_params_over_data=fsdp, tensor_parallel=tp)
        assert set(ours) == set(dict(model.named_parameters()))
        for name, p in model.named_parameters():
            assert _norm(ours[name], p.ndim) == _norm(_jax_spec_for(name, table), p.ndim), name
