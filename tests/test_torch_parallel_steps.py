"""The port's multi-GPU training of the whole model on four gloo ranks on the
CPU, against the JAX package (``ModelConfig.tiny``, f32, dropout off):

- ``sharding.param_specs`` equals JAX's ``param_specs`` table on a model
  with LoRA and multi-LoRA leaves, dim for dim in torch's orientation;
- FSDP x TP (``create_mesh(2, 2)``: ``shard_params``, then the sharded step)
  for the full, the stage-1 (adapter) and the LoRA recipes (LoRA r 4 on
  every LM projection, seeded non-zero A and B), and the multi-host
  ('replica', 'data', 'model') mesh (2, 1, 2) for the full recipe;
- the sequence-parallel multimodal step at 4 shards and the pipelined one at
  2 stages x 2 data ranks (2 microbatches each);
- ``rmt_loss`` (the stage-1 recipe) through the Trainer's step on a dp 4
  mesh, and packed rows (segment ids, two video slots a row) through the
  sharded step at dp 2 x tp 2 (the full recipe), each against JAX's step on
  the global batch;
- serving over a dp 2 x tp 2 sharding (FSDP units on 'data', the LM tensor
  parallel on 'model'): ``generate``, the dense engine, the paged engine on
  float and int8 pages, device-grammar requests and a batch mixing two
  multi-LoRA adapters give the unsharded JAX engines' greedy tokens on every
  rank; the sampled engine (temperature 0.9, top-p 0.9, seed 4) gives the
  port's unsharded sampled engine's tokens (JAX draws from ``jax.random``,
  the port from a ``torch.Generator``); at tp 4 the tiny LM's 2 kv heads
  are refused by name.

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
         "seq_parallel_videollamb", "pipeline_videollamb", "rmt_loss_dp4", "packed_fsdp_tp",
         "sharded_engines", "sharded_mlora", "head_check"]
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


def _packed():
    """Four packed rows of 24 tokens: segments 1..3 a row (0 = padding), two
    video slots a row, the second empty in rows 1 and 2."""
    rng = np.random.default_rng(6)
    ids = rng.integers(4, CFG.lm.vocab_size, size=(4, 24)).astype(np.int32)
    seg = np.zeros((4, 24), np.int32)
    seg[0, :9], seg[0, 9:20] = 1, 2
    seg[1, :7], seg[1, 7:12], seg[1, 12:22] = 1, 2, 3
    seg[2, :24] = 1
    seg[3, :10], seg[3, 10:18] = 1, 2
    for row, pos in enumerate(([2, 12], [1, 14], [3], [2, 12])):
        ids[row, pos] = VIDEO_TOKEN_INDEX
    mask = (seg > 0).astype(np.int32)
    labels = np.where(mask > 0, ids, IGNORE_INDEX).astype(np.int32)
    labels[ids < 0] = IGNORE_INDEX
    img = CFG.vision.image_size
    videos = rng.normal(size=(4, 2, 8, 3, img, img)).astype(np.float32)
    block = np.array([[True, True], [True, False], [True, False], [True, True]])
    return ids, mask, labels, videos, seg, block


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


def _jax_run(tree, tune_mode, arrays, rmt_loss=False):
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
    step = jax.jit(make_train_step(CFG, tx, remat=False, attn_impl="chunked", rmt_loss=rmt_loss,
                                   mask=trainable_mask(tcfg, params)))
    ids, mask, labels, videos, *packed = (jnp.asarray(a) for a in arrays)
    batch = MultimodalBatch(ids, mask, labels, videos, images=None,
                            **dict(zip(("segment_ids", "video_block_mask"), packed)))
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        metrics.append((float(m["loss"]), float(m["grad_norm"]), int(m["tokens"])))
    return jax.tree.map(np.asarray, state.params), metrics


def _serve_spec():
    """The serving runs' requests (numpy): video rows for ``generate`` and the
    engines, text rows under a JSON grammar and under two adapters."""
    from test_grammar import EOS, _token_strs
    from test_torch_mlora import seeded_adapter

    img = CFG.vision.image_size

    def video_row(seed):
        rng = np.random.default_rng(seed)
        ids = rng.integers(4, CFG.lm.vocab_size, size=(1, 8)).astype(np.int32)
        ids[:, 2] = VIDEO_TOKEN_INDEX
        return ids, rng.normal(size=(1, 8, 3, img, img)).astype(np.float32)

    def text(seed):
        return np.random.default_rng(seed).integers(4, CFG.lm.vocab_size, size=(1, 6)).astype(
            np.int32)

    return {"new": 5, "generate": video_row(7), "rows": [video_row(0), video_row(1)],
            "sampled": video_row(55), "sampled_new": 6, "grammar_eos": EOS, "grammar_new": 12,
            "token_strs": _token_strs(CFG.lm.vocab_size), "grammar_ids": [text(20), text(21)],
            "adapters": {"a": seeded_adapter(CFG.lm, 1, r=4, scale=0.5),
                         "b": seeded_adapter(CFG.lm, 2, r=8, scale=0.5)},
            "mlora_new": 6,
            "mlora_rows": [("a", text(60)), (None, text(60)), ("b", text(61)), ("a", text(62))]}


def _jax_serving(tree, serve):
    """The unsharded JAX engines' greedy tokens on the serving runs."""
    from videollamb_tpu.models.assembly import MultimodalBatch
    from videollamb_tpu.models.engine import generate
    from videollamb_tpu.models.lm.mlora import add_multi_lora_params
    from videollamb_tpu.serve.grammar import json_constraint
    from videollamb_tpu.serve.paged import PagedServingEngine
    from videollamb_tpu.serve.server import Request, ServingEngine

    params = jax.tree.map(jnp.asarray, tree)

    def req(ids, video, uid, new, **fields):
        batch = MultimodalBatch(jnp.asarray(ids), jnp.ones(ids.shape, jnp.int32), None,
                                None if video is None else jnp.asarray(video), None)
        return Request(uid=uid, batch=batch, max_new_tokens=new, temperature=0.0, **fields)

    new = serve["new"]
    out = {"generate": np.asarray(generate(
        params, CFG, req(*serve["generate"], 0, new).batch, jax.random.PRNGKey(0),
        max_new_tokens=new, do_sample=False, eos_token_id=-1,
        max_seq_len=CFG.max_length + new).tokens).tolist()}
    engines = {
        "dense": lambda: ServingEngine(params, CFG, num_slots=2, eos_token_id=-1),
        "paged_float": lambda: PagedServingEngine(params, CFG, num_slots=2, page_size=32,
                                                  eos_token_id=-1),
        "paged_int8": lambda: PagedServingEngine(params, CFG, num_slots=2, page_size=32,
                                                 eos_token_id=-1, quantize_kv=True)}
    for name, make in engines.items():
        out[name] = du._serve(make(), [req(*row, i, new) for i, row in enumerate(serve["rows"])],
                              k=2)
    eos = serve["grammar_eos"]
    reqs = [req(ids, None, i, serve["grammar_new"], grammar=json_constraint(
        du.GrammarTokenizer(eos), token_strs=serve["token_strs"]))
        for i, ids in enumerate(serve["grammar_ids"])]
    out["grammar"] = du._serve(ServingEngine(params, CFG, num_slots=2, eos_token_id=eos), reqs,
                               k=4)
    stacked, registry = add_multi_lora_params(params, serve["adapters"])
    reqs = [req(ids, None, i, serve["mlora_new"], adapter=name)
            for i, (name, ids) in enumerate(serve["mlora_rows"])]
    out["mlora"] = du._serve(ServingEngine(stacked, CFG, num_slots=4, eos_token_id=-1,
                                           adapter_registry=registry), reqs, k=3)
    out["registry"] = registry
    return out


def _port_sampled(tree, serve):
    """The port's unsharded sampled engine on the sampled run."""
    from videollamb_torch.serve.server import ServingEngine

    req = du._video_request(serve["sampled"], 0, serve["sampled_new"], temperature=0.9,
                            top_p=0.9)
    with torch.no_grad():
        return du._serve(ServingEngine(port_model(CFG, tree), port_config(CFG), num_slots=2,
                                       eos_token_id=-1, seed=4), [req], k=3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree = _params()
    arrays = _batch()
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    lora_tree = _lora_params(tree)
    packed = _packed()
    serve = _serve_spec()
    spec = {"tasks": TASKS, "cfg": port_config(CFG), "tree": tree, "batch": arrays,
            "train_kw": TRAIN_KW, "total_steps": TOTAL, "n_steps": STEPS,
            "lora": {"r": LORA_R, "alpha": LORA_ALPHA, "tree": lora_tree}, "packed": packed,
            "serve": serve}
    ctx = du.start_ranks(4, spec, out_dir)
    try:
        ref = {mode: _jax_run(tree, mode, arrays) for mode in ("full", "adapter")}
        ref["lora"] = _jax_run(lora_tree, "lora", arrays)
        ref["adapter_rmt"] = _jax_run(tree, "adapter", arrays, rmt_loss=True)
        ref["full_packed"] = _jax_run(tree, "full", packed)
        ref["serve"] = _jax_serving(tree, serve)
        ref["sampled"] = _port_sampled(tree, serve)
    finally:
        results = du.join_ranks(ctx, out_dir, 4, timeout=150.0)
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
                                       ("pipeline_videollamb", "full"),
                                       ("rmt_loss_dp4", "adapter_rmt"),
                                       ("packed_fsdp_tp", "full_packed")])
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


@pytest.mark.parametrize("run", ["generate", "dense", "paged_float", "paged_int8", "grammar"])
def test_sharded_serving_equals_unsharded_jax(runs, run):
    """Every rank of the dp 2 x tp 2 sharding gives the unsharded JAX
    engine's greedy tokens (grammar rows decode to JSON objects)."""
    import json

    from test_grammar import _decode

    ref, results = runs
    want = ref["serve"][run]
    for rank in range(4):
        assert du.result(results, "sharded_engines", rank)[run] == want, rank
    if run == "grammar":
        for tokens in want:
            assert isinstance(json.loads(_decode(tokens)), dict)


def test_sharded_multi_lora_equals_unsharded_jax(runs):
    """Two adapters and the base model in one batch over the sharded stacks;
    the stacks shard as their bases (an o_proj A over 'model' on its input
    rows, then FSDP over 'data' on the adapter axis)."""
    ref, results = runs
    want = ref["serve"]["mlora"]
    assert want[0] != want[1]  # the adapter moves the answer
    d = CFG.lm.num_attention_heads * CFG.lm.head_dim
    for rank in range(4):
        got = du.result(results, "sharded_mlora", rank)
        assert got["registry"] == ref["serve"]["registry"]
        assert got["tokens"] == want, rank
        assert got["o_proj_lora_a"] == (1, d // 2, 8)


def test_sharded_sampled_engine_equals_unsharded(runs):
    ref, results = runs
    for rank in range(4):
        assert du.result(results, "sharded_engines", rank)["sampled"] == ref["sampled"], rank


def test_sharded_serving_keeps_the_shards(runs):
    """The served model stays sharded at rest: a rank holds a quarter of a
    q_proj, and the root's and the layers' weights are FSDP-sharded again
    after every run (gathered only around their use)."""
    _, results = runs
    d, h = CFG.lm.hidden_size, CFG.lm.num_attention_heads * CFG.lm.head_dim
    for rank in range(4):
        ev = du.result(results, "sharded_engines", rank)["evidence"]
        assert ev == {"q_proj": (h // 4, d), "root_sharded": True, "layer_sharded": True}


def test_tensor_parallel_refuses_heads_that_do_not_split(runs):
    _, results = runs
    for rank in range(4):
        msg = du.result(results, "head_check", rank)
        assert msg is not None and "2 key / value heads do not split over 4" in msg, msg


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
