"""Rank workers for the port's multi-process tests (no tests of its own).

The parity tests start one group of gloo ranks per world size per file, at
module scope, with :func:`start_ranks`; each rank imports only this module
and the port (never JAX), builds what its tasks need from a spec file the
test wrote (numpy trees and inputs, the port's configs), runs every task in
order and saves a dict of numpy results. :func:`join_ranks` waits with a
timeout, so a hung ring fails its tests instead of eating the suite's clock.
Each rank runs on one thread.
"""

from __future__ import annotations

import os
import socket
import traceback
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TASKS: Dict[str, Any] = {}


def task(fn):
    TASKS[fn.__name__] = fn
    return fn


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, spec_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    torch.manual_seed(0)
    store = dist.TCPStore("127.0.0.1", port, world, is_master=rank == 0)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    spec = torch.load(spec_path, weights_only=False)
    results: Dict[str, Any] = {}
    try:
        for i, name in enumerate(spec["tasks"]):
            if i:
                dist.barrier()  # every task starts on every rank together
            try:
                results[name] = TASKS[name](spec)
            except Exception:  # reported by the test that reads this task
                results[name] = {"error": traceback.format_exc()}
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        _leave(store, rank, world)


def _leave(store, rank: int, world: int) -> None:
    """Close the group once every rank is past its last collective, and keep
    rank 0 (which serves the store) until every rank has closed: a rank that
    closes its connections while a peer still reads from them breaks the
    peer's collective ("Connection closed by peer")."""
    store.set(f"done{rank}", "1")
    store.wait([f"done{r}" for r in range(world)])
    dist.destroy_process_group()
    store.set(f"left{rank}", "1")
    if rank == 0:
        store.wait([f"left{r}" for r in range(world)])


def start_ranks(world: int, spec: dict, out_dir: str):
    """Write ``spec`` and start ``world`` ranks that run ``spec['tasks']``;
    returns the handle for :func:`join_ranks`."""
    spec_path = os.path.join(out_dir, "spec.pt")
    torch.save(spec, spec_path)
    return mp.start_processes(_rank_main, args=(world, free_port(), spec_path, out_dir),
                              nprocs=world, join=False, start_method="spawn")


def join_ranks(ctx, out_dir: str, world: int, timeout: float = 90.0):
    """Every rank's results, in rank order; raises if a rank failed or the
    group outlived ``timeout`` seconds (its processes are then killed). The
    default is about 1.5 times a two-rank file's whole serial run, so a hung
    ring costs the suite little more than that file does; the four-rank
    spawn of tests/test_torch_parallel_steps.py passes its own."""
    import time

    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def result(results, name: str, rank: int):
    out = results[rank][name]
    if isinstance(out, dict) and "error" in out:
        raise AssertionError(f"rank {rank}, task {name}:\n{out['error']}")
    return out


def np_(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# Model builders
# ---------------------------------------------------------------------------

def build_model(spec, lora: bool = False):
    """The whole model from ``spec['tree']``; with ``lora``, LoRA adapters on
    every LM projection from ``spec['lora']`` (its r, alpha and tree)."""
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.rmt_r import RMTRBridge
    from videollamb_torch.models.convert import from_jax_params
    from videollamb_torch.models.lm.llama import LlamaForCausalLM
    from videollamb_torch.models.lm.lora import add_lora_params
    from videollamb_torch.models.vision.clip_vit import CLIPVisionTower

    cfg = spec["cfg"]
    model = VideoLLaMB(CLIPVisionTower(cfg.vision), RMTRBridge(cfg.bridge, cfg.lm.hidden_size),
                       LlamaForCausalLM(cfg.lm))
    tree = spec["tree"]
    if lora:
        add_lora_params(model.lm, cfg.lm, r=spec["lora"]["r"], alpha=spec["lora"]["alpha"])
        tree = spec["lora"]["tree"]
    model.load_state_dict(from_jax_params(tree), strict=True)
    return model


def build_lm(spec):
    from videollamb_torch.models.convert import from_jax_params
    from videollamb_torch.models.lm.llama import LlamaForCausalLM

    lm = LlamaForCausalLM(spec["lm_cfg"])
    lm.load_state_dict({k[3:]: v for k, v in from_jax_params({"lm": spec["lm_tree"]}).items()},
                       strict=True)
    return lm


def train_config(spec, tune_mode):
    from videollamb_torch.config import TrainConfig

    return TrainConfig(**spec["train_kw"], tune_mode=tune_mode)


class WordTokenizer:
    """``tests/test_preprocess.WordTokenizer`` (which imports JAX): a stable id
    per word, a leading BOS, legacy counting."""

    bos_token_id = 1
    pad_token_id = 0
    legacy = True
    model_max_length = 2048

    def __init__(self):
        self.vocab = {"<bos>": 1, "</s>": 2}

    def _id(self, w):
        if w not in self.vocab:
            self.vocab[w] = len(self.vocab) + 10
        return self.vocab[w]

    def __call__(self, text):
        class R:
            pass

        r = R()
        r.input_ids = [self.bos_token_id] + [self._id(w) for w in
                                             text.replace("</s>", " </s> ").split()]
        return r


def batch(arrays, rows=None):
    from videollamb_torch.models.assembly import MultimodalBatch

    ids, mask, labels, videos = arrays
    sl = slice(None) if rows is None else rows
    return MultimodalBatch(input_ids=torch.from_numpy(ids[sl]).long(),
                           attention_mask=torch.from_numpy(mask[sl]).long(),
                           labels=torch.from_numpy(labels[sl]).long(),
                           videos=torch.from_numpy(videos[sl]))


def trained_state(model, tx) -> Dict[str, np.ndarray]:
    ids = {id(p) for p in tx.params}
    return {name: np_(p) for name, p in model.named_parameters() if id(p) in ids}


def run_steps(step, state, batches, generator=False):
    metrics = []
    for b in batches:
        state, m = step(state, *b) if not generator else step(state, b, None)
        metrics.append((float(m["loss"]), float(m["grad_norm"]), int(m["tokens"])))
    return state, metrics


# ---------------------------------------------------------------------------
# Multimodal steps: FSDP x TP, the multi-host mesh, SP and PP (world 4)
# ---------------------------------------------------------------------------

def _sharded_steps(spec, mesh, tune_mode, lora: bool = False):
    from videollamb_torch.parallel.sharding import (
        batch_sharding,
        make_sharded_train_step,
        shard_params,
    )
    from videollamb_torch.train.step import (
        TrainState,
        create_optimizer,
        trainable_mask,
    )

    model = build_model(spec, lora)
    tcfg = train_config(spec, tune_mode)
    mask = trainable_mask(tcfg, model)
    shard_params(mesh, model)
    tx = create_optimizer(tcfg, spec["total_steps"], model)
    step = make_sharded_train_step(mesh, spec["cfg"], tx, remat=True, mask=mask)
    count, index = batch_sharding(mesh)
    per = spec["batch"][0].shape[0] // count
    rows = slice(index * per, (index + 1) * per)
    batches = [batch(spec["batch"], rows) for _ in range(spec["n_steps"])]
    state, metrics = run_steps(step, TrainState(0, model, tx), batches, generator=True)
    local = {name: tuple(p.to_local().shape) for name, p in model.named_parameters()
             if hasattr(p, "to_local")}
    return {"metrics": metrics, "params": trained_state(model, tx), "local_shapes": local,
            "labels_of_trained": sorted(trained_state(model, tx))}


@task
def fsdp_tp_full(spec):
    from videollamb_torch.parallel.mesh import create_mesh

    return _sharded_steps(spec, create_mesh(2, 2), "full")


@task
def fsdp_tp_stage1(spec):
    from videollamb_torch.parallel.mesh import create_mesh

    return _sharded_steps(spec, create_mesh(2, 2), "adapter")


@task
def fsdp_tp_lora(spec):
    """LoRA over every LM projection: A and B shard with their base's dims."""
    from videollamb_torch.parallel.mesh import create_mesh

    return _sharded_steps(spec, create_mesh(2, 2), "lora", lora=True)


@task
def multislice_full(spec):
    from videollamb_torch.parallel.mesh import create_multislice_mesh

    mesh = create_multislice_mesh(model_parallel=2, n_slices=2)
    out = _sharded_steps(spec, mesh, "full")
    out["mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    return out


@task
def seq_parallel_videollamb(spec):
    from videollamb_torch.parallel.ring_attention import create_seq_mesh
    from videollamb_torch.parallel.seq_parallel import make_seq_parallel_videollamb_step
    from videollamb_torch.train.step import TrainState, create_optimizer, trainable_mask

    model = build_model(spec)
    tcfg = train_config(spec, "full")
    tx = create_optimizer(tcfg, spec["total_steps"], model)
    step = make_seq_parallel_videollamb_step(create_seq_mesh(4), spec["cfg"], tx,
                                             mask=trainable_mask(tcfg, model))
    state, metrics = run_steps(step, TrainState(0, model, tx),
                               [batch(spec["batch"])] * spec["n_steps"], generator=True)
    return {"metrics": metrics, "params": trained_state(model, tx)}


@task
def pipeline_videollamb(spec):
    from videollamb_torch.parallel.pipeline import (
        create_pipe_data_mesh,
        make_pipeline_videollamb_step,
        shard_stacked_layers,
        stage_range,
    )
    from videollamb_torch.train.step import TrainState, create_optimizer, trainable_mask

    mesh = create_pipe_data_mesh(2, 2)
    model = build_model(spec)
    tcfg = train_config(spec, "full")
    layers = stage_range(mesh, len(model.lm.model.layers))
    shard_stacked_layers(mesh, model.lm)
    mask = trainable_mask(tcfg, model)
    tx = create_optimizer(tcfg, spec["total_steps"], model)
    step = make_pipeline_videollamb_step(mesh, spec["cfg"], tx, n_micro=2, data_axis="data",
                                         mask=mask)
    d = mesh.get_local_rank("data")
    rows = slice(2 * d, 2 * d + 2)
    state, metrics = run_steps(step, TrainState(0, model, tx),
                               [batch(spec["batch"], rows)] * spec["n_steps"], generator=True)
    params = trained_state(model, tx)
    # Stage-local layer names carry the stage's offset.
    renamed = {}
    for name, value in params.items():
        if name.startswith("lm.model.layers."):
            i, rest = name[len("lm.model.layers."):].split(".", 1)
            name = f"lm.model.layers.{layers[int(i)]}.{rest}"
        renamed[name] = value
    return {"metrics": metrics, "params": renamed}


# ---------------------------------------------------------------------------
# The LM alone: ring attention, sequence and pipeline parallelism (world 4)
# ---------------------------------------------------------------------------

@task
def ring(spec):
    from videollamb_torch.parallel.ring_attention import create_seq_mesh, ring_attention

    mesh = create_seq_mesh(4)
    idx = dist.get_rank(mesh.get_group("seq"))
    out = {}
    for causal in (True, False):
        q, k, v, ct = (torch.from_numpy(a).requires_grad_(a.dtype == np.float32)
                       for a in spec["ring"])
        s = q.shape[1] // 4
        sl = slice(idx * s, (idx + 1) * s)
        o = ring_attention(mesh, q, k, v, causal=causal)
        dq, dk, dv = torch.autograd.grad((o * ct[:, sl]).sum(), (q, k, v))
        out[causal] = {"out": np_(o), "dq": np_(dq[:, sl]), "dk": np_(dk[:, sl]),
                       "dv": np_(dv[:, sl])}
    return out


def _grads(loss, params):
    """Gradients of every parameter, zeros for those the loss never reads."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def _ce_share(logits_local, labels_local, n_total):
    logp = torch.log_softmax(logits_local.float(), dim=-1)
    return -torch.gather(logp, -1, labels_local.long()[..., None]).sum() / n_total


@task
def seq_parallel_lm(spec):
    """Forward and CE gradients at 4 shards, then the data-axis mesh (2 x 2)."""
    from torch.distributed.device_mesh import init_device_mesh

    from videollamb_torch.parallel.ring_attention import create_seq_mesh
    from videollamb_torch.parallel.seq_parallel import seq_parallel_llama_forward

    out = {}
    for name, mesh, data_axis in (
            ("seq4", create_seq_mesh(4), None),
            ("data2_seq2", init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "seq")),
             "data")):
        lm = build_lm(spec)
        embeds, mask, labels = (torch.from_numpy(a) for a in spec["sp_inputs"][name])
        seq = mesh.get_group("seq")
        rows = slice(None)
        if data_axis:
            d, n = mesh.get_local_rank(data_axis), mesh.size(0)
            per = embeds.shape[0] // n
            rows = slice(d * per, (d + 1) * per)
        p, idx = dist.get_world_size(seq), dist.get_rank(seq)
        sl = embeds.shape[1] // p
        logits = seq_parallel_llama_forward(mesh, lm, spec["lm_cfg"], embeds[rows], mask[rows],
                                            remat=True)
        lab = labels[rows][:, idx * sl:(idx + 1) * sl]
        loss = _ce_share(logits, lab, labels.numel())
        grads = _grads(loss, list(lm.parameters()))
        for g in grads:
            dist.all_reduce(g)
        out[name] = {"logits": np_(logits),
                     "grads": {n: np_(g) for (n, _), g in zip(lm.named_parameters(), grads)}}
    return out


@task
def seq_parallel_step(spec):
    from videollamb_torch.parallel.ring_attention import create_seq_mesh
    from videollamb_torch.parallel.seq_parallel import make_seq_parallel_train_step
    from videollamb_torch.train.step import TrainState, create_optimizer

    lm = build_lm(spec)
    tx = create_optimizer(spec["lm_train_cfg"], spec["total_steps"], lm)
    step = make_seq_parallel_train_step(create_seq_mesh(4), spec["lm_cfg"], tx)
    arrays = [torch.from_numpy(a) for a in spec["lm_batch"]]
    state, metrics = run_steps(step, TrainState(0, lm, tx), [arrays] * spec["n_steps"])
    return {"metrics": metrics, "params": trained_state(lm, tx)}


def _pipeline_lm(spec, mesh):
    from videollamb_torch.parallel.pipeline import shard_stacked_layers, stage_range

    lm = build_lm(spec)
    layers = stage_range(mesh, len(lm.model.layers))
    shard_stacked_layers(mesh, lm)
    return lm, layers


def _global_names(named, layers):
    out = {}
    for name, value in named.items():
        if name.startswith("model.layers."):
            i, rest = name[len("model.layers."):].split(".", 1)
            name = f"model.layers.{layers[int(i)]}.{rest}"
        out[name] = value
    return out


@task
def pipeline_lm(spec):
    """Forward 4 x 2 and 2 x 4 (two 2-stage replicas, one batch), CE
    gradients 4 x 2, train steps 4 x 2, 2 x 4 and pipe x data 2 x 2."""
    from videollamb_torch.parallel.pipeline import (
        create_pipe_data_mesh,
        create_pipeline_mesh,
        make_pipeline_train_step,
        pipeline_llama_forward,
    )
    from videollamb_torch.train.step import TrainState, create_optimizer

    cfg = spec["lm_cfg"]
    embeds, mask, labels = (torch.from_numpy(a) for a in spec["pp_inputs"])
    out = {}
    meshes = {"4x2": (create_pipeline_mesh(4), 2, None),
              "2x4": (create_pipe_data_mesh(2, 2), 4, None),
              "2x2_data": (create_pipe_data_mesh(2, 2), 2, "data")}
    for name in ("4x2", "2x4"):
        mesh, n_micro, _ = meshes[name]
        lm, layers = _pipeline_lm(spec, mesh)
        logits = pipeline_llama_forward(mesh, lm, cfg, embeds, mask, n_micro)
        entry = {"logits": np_(logits)}
        if name == "4x2":
            loss = _ce_share(logits, labels, labels.numel())
            grads = _grads(loss, list(lm.parameters()))
            entry["grads"] = _global_names(
                {n: np_(g) for (n, _), g in zip(lm.named_parameters(), grads)}, layers)
        out[name] = entry
    arrays = [torch.from_numpy(a) for a in spec["lm_batch"]]
    for name, (mesh, n_micro, data_axis) in meshes.items():
        lm, layers = _pipeline_lm(spec, mesh)
        tx = create_optimizer(spec["lm_train_cfg"], spec["total_steps"], lm)
        step = make_pipeline_train_step(mesh, cfg, tx, n_micro, data_axis=data_axis)
        rows = arrays
        if data_axis:
            d = mesh.get_local_rank("data")
            per = arrays[0].shape[0] // 2
            rows = [a[d * per:(d + 1) * per] for a in arrays]
        state, metrics = run_steps(step, TrainState(0, lm, tx), [rows] * spec["n_steps"])
        out[f"step_{name}"] = {"metrics": metrics,
                               "params": _global_names(trained_state(lm, tx), layers),
                               "n_local_layers": len(lm.model.layers)}
    return out


# ---------------------------------------------------------------------------
# The train CLI (world 2)
# ---------------------------------------------------------------------------

@task
def train_cli(spec):
    from videollamb_torch.train.cli import main

    out = {}
    for flag in ("--model_parallel", "--sequence_parallel"):
        logs = []
        argv = list(spec["cli_argv"]) + [flag, "2", "--output_dir",
                                         os.path.join(spec["cli_out"], flag.strip("-"))]
        main(argv, tokenizer=WordTokenizer(), log_fn=logs.append)
        out[flag] = [m for m in logs if "loss" in m]
        # Again on the same output dir: the run resumes from its gathered
        # checkpoint (re-sharded into the mesh) with nothing left to train.
        resumed = []
        state = main(argv, tokenizer=WordTokenizer(), log_fn=resumed.append)
        out[flag + " resumed"] = (state.step, len(resumed))
    return out


@task
def writer_host(spec):
    """The checkpoint's gather of a sharded tensor: every rank joins it, only
    rank 0 (the writer) keeps the host copy."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from videollamb_torch.train.checkpoint import _writer_host

    mesh = init_device_mesh("cpu", (dist.get_world_size(),))
    full = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    got = _writer_host(distribute_tensor(full, mesh, [Shard(0)]))
    return None if got is None else got.numpy()


# ---------------------------------------------------------------------------
# Serving over sharded weights, rmt_loss and packed rows (world 4)
# ---------------------------------------------------------------------------

def _video_request(row, uid, max_new, **fields):
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.serve.server import Request

    ids, video = row
    batch = MultimodalBatch(torch.from_numpy(ids).long(), torch.ones(ids.shape, dtype=torch.long),
                            videos=None if video is None else torch.from_numpy(video))
    return Request(uid=uid, batch=batch, max_new_tokens=max_new, **fields)


def _serve(engine, requests, k):
    for r in requests:
        engine.submit(r)
    engine.run_until_drained(k=k)
    return [list(r.tokens) for r in requests]


class GrammarTokenizer:
    """The grammar tests' ``_Tok``: the tables come from ``token_strs``."""

    def __init__(self, eos: int):
        self.eos_token_id = eos


def serving_runs(model, cfg, serve: dict) -> Dict[str, Any]:
    """Tokens of every run of ``serve`` (the spec's requests) over ``model``:
    ``generate``, the dense engine, the paged engine on float and int8
    pages, the sampled engine and grammar requests."""
    from videollamb_torch.models.engine import generate
    from videollamb_torch.serve.grammar import json_constraint
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import ServingEngine

    out = {}
    ids, video = serve["generate"]
    req = _video_request((ids, video), 0, serve["new"])
    out["generate"] = generate(model, cfg, req.batch, max_new_tokens=serve["new"],
                               eos_token_id=-1, max_seq_len=cfg.max_length + serve["new"]
                               ).tokens.tolist()
    engines = {
        "dense": lambda: ServingEngine(model, cfg, num_slots=2, eos_token_id=-1),
        "paged_float": lambda: PagedServingEngine(model, cfg, num_slots=2, page_size=32,
                                                  eos_token_id=-1),
        "paged_int8": lambda: PagedServingEngine(model, cfg, num_slots=2, page_size=32,
                                                 eos_token_id=-1, quantize_kv=True)}
    for name, make in engines.items():
        reqs = [_video_request(row, i, serve["new"]) for i, row in enumerate(serve["rows"])]
        out[name] = _serve(make(), reqs, k=2)
    reqs = [_video_request(serve["sampled"], 0, serve["sampled_new"], temperature=0.9,
                           top_p=0.9)]
    out["sampled"] = _serve(ServingEngine(model, cfg, num_slots=2, eos_token_id=-1, seed=4),
                            reqs, k=3)
    eos = serve["grammar_eos"]
    reqs = [_video_request((ids, None), i, serve["grammar_new"], grammar=json_constraint(
        GrammarTokenizer(eos), token_strs=serve["token_strs"]))
        for i, ids in enumerate(serve["grammar_ids"])]
    out["grammar"] = _serve(ServingEngine(model, cfg, num_slots=2, eos_token_id=eos), reqs, k=4)
    return out


def _sharding_evidence(model) -> Dict[str, Any]:
    """Local shapes of one layer's weights (sharded at rest) and whether the
    root's weights are FSDP-sharded (and so resharded after the runs)."""
    from videollamb_torch.parallel.sharding import _fsdp_managed

    attn = model.lm.model.layers[0].self_attn
    return {"q_proj": tuple(attn.q_proj.weight.to_local().shape),
            "root_sharded": _fsdp_managed(model.lm.model.embed_tokens.weight),
            "layer_sharded": _fsdp_managed(attn.q_proj.weight)}


@task
def sharded_engines(spec):
    """The engines over a dp 2 x tp 2 sharding of the spec's model."""
    from videollamb_torch.parallel.mesh import create_mesh
    from videollamb_torch.parallel.sharding import shard_params

    model = shard_params(create_mesh(2, 2), build_model(spec))
    with torch.no_grad():
        out = serving_runs(model, spec["cfg"], spec["serve"])
    out["evidence"] = _sharding_evidence(model)
    return out


@task
def sharded_mlora(spec):
    """Two adapters stacked, then sharded dp 2 x tp 2 (the stacks placed as
    their bases), through the dense engine."""
    from videollamb_torch.models.lm.mlora import add_multi_lora_params
    from videollamb_torch.parallel.mesh import create_mesh
    from videollamb_torch.parallel.sharding import shard_params
    from videollamb_torch.serve.server import ServingEngine

    serve = spec["serve"]
    model = build_model(spec)
    _, registry = add_multi_lora_params(model.lm, serve["adapters"])
    shard_params(create_mesh(2, 2), model)
    stack = model.lm.model.layers[0].self_attn.o_proj.lora_a
    reqs = [_video_request((ids, None), i, serve["mlora_new"], adapter=name)
            for i, (name, ids) in enumerate(serve["mlora_rows"])]
    engine = ServingEngine(model, spec["cfg"], num_slots=4, eos_token_id=-1,
                           adapter_registry=registry)
    with torch.no_grad():
        tokens = _serve(engine, reqs, k=3)
    return {"tokens": tokens, "registry": registry,
            "o_proj_lora_a": tuple(stack.to_local().shape)}


@task
def head_check(spec):
    """tp 4 over the tiny LM's 2 kv heads: shard_params refuses, naming them."""
    from videollamb_torch.parallel.mesh import create_mesh
    from videollamb_torch.parallel.sharding import shard_params

    try:
        shard_params(create_mesh(1, 4), build_model(spec))
    except ValueError as e:
        return str(e)
    return None


@task
def rmt_loss_dp4(spec):
    """The Trainer's step over a data-parallel mesh (dp 4) with rmt_loss,
    stage-1 recipe: each rank its row of the global batch."""
    import tempfile

    from videollamb_torch.config import TrainConfig
    from videollamb_torch.parallel.mesh import create_mesh
    from videollamb_torch.parallel.sharding import batch_sharding, shard_params
    from videollamb_torch.train.trainer import Trainer

    mesh = create_mesh(4, 1)
    model = shard_params(mesh, build_model(spec))
    count, index = batch_sharding(mesh)
    n_rows = spec["batch"][0].shape[0]
    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = TrainConfig(**spec["train_kw"], tune_mode="adapter", rmt_loss=True,
                           per_device_batch_size=n_rows // count, output_dir=out_dir)
        # total_steps = len(dataset) // the global batch: the spec's schedule.
        trainer = Trainer(spec["cfg"], tcfg, model, [None] * (n_rows * spec["total_steps"]),
                          mesh=mesh)
    per = n_rows // count
    rows = slice(index * per, (index + 1) * per)
    state, metrics = run_steps(trainer.step_fn, trainer.state,
                               [batch(spec["batch"], rows)] * spec["n_steps"], generator=True)
    return {"metrics": metrics, "params": trained_state(model, trainer.tx)}


@task
def packed_fsdp_tp(spec):
    """Packed rows (segment ids, two video slots a row) through the sharded
    step at dp 2 x tp 2, full recipe."""
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.parallel.mesh import create_mesh
    from videollamb_torch.parallel.sharding import (
        batch_sharding,
        make_sharded_train_step,
        shard_params,
    )
    from videollamb_torch.train.step import TrainState, create_optimizer, trainable_mask

    mesh = create_mesh(2, 2)
    model = build_model(spec)
    tcfg = train_config(spec, "full")
    mask = trainable_mask(tcfg, model)
    shard_params(mesh, model)
    tx = create_optimizer(tcfg, spec["total_steps"], model)
    step = make_sharded_train_step(mesh, spec["cfg"], tx, remat=True, mask=mask)
    count, index = batch_sharding(mesh)
    ids, mask_, labels, videos, seg, block = spec["packed"]
    per = ids.shape[0] // count
    sl = slice(index * per, (index + 1) * per)
    rows = MultimodalBatch(torch.from_numpy(ids[sl]).long(), torch.from_numpy(mask_[sl]).long(),
                           torch.from_numpy(labels[sl]).long(), torch.from_numpy(videos[sl]),
                           segment_ids=torch.from_numpy(seg[sl]).long(),
                           video_block_mask=torch.from_numpy(block[sl]))
    state, metrics = run_steps(step, TrainState(0, model, tx), [rows] * spec["n_steps"],
                               generator=True)
    return {"metrics": metrics, "params": trained_state(model, tx)}
