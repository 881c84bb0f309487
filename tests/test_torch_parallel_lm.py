"""The port's ring attention, sequence parallelism and pipeline parallelism
on four gloo ranks on the CPU, against the JAX package at the same shard
counts (``LlamaConfig.tiny`` with 4 layers, GQA 4 / 2 heads, f32):

- ``ring_attention`` at 4 shards, causal and not: outputs and the
  gradients of q, k and v against JAX's ``ring_attention`` and ``jax.vjp``
  (the padded keys of ``ring_attention_local`` are held through the ragged
  rows of the sequence-parallel forward);
- ``seq_parallel_llama_forward`` at 4 shards (a ragged row): logits, and
  every parameter's gradient of a cross-entropy, against JAX's
  ``seq_parallel_llama_forward`` and ``jax.grad`` (with remat); on a
  ('data', 'seq') 2 x 2 mesh against JAX's ``llama_forward`` on the same
  inputs, which JAX's tests hold its data-axis forward to
  (tests/test_seq_parallel.py);
- ``pipeline_llama_forward`` at 4 stages x 2 microbatches and 2 x 4 (a
  ragged row): logits, and the gradients at 4 x 2, against JAX's
  ``llama_forward`` and ``jax.grad`` (JAX's tests hold its pipeline
  forward to that function, tests/test_pipeline.py);
- two steps of ``make_seq_parallel_train_step`` (4 shards) and of
  ``make_pipeline_train_step`` (4 x 2, 2 x 4, and pipe x data 2 x 2)
  against two steps of JAX's LM step as those factories compose it
  (``causal_lm_loss`` of ``llama_forward``, ``create_optimizer``) over the
  unsplit forward, which JAX's tests hold its SP and pipeline steps to:
  losses (rtol 1e-5), grad_norm (rtol 1e-4), parameters rtol 1e-4, atol
  1e-5 (1 % of one update at lr 1e-3, the leaf tolerance of
  tests/test_torch_train_step.py: Adam moves an entry whose gradient is
  rounding noise by an amount that noise sets).

Outputs and gradients: within 1e-5 of the largest magnitude (TOL).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import test_torch_dist_utils as du  # noqa: E402

from videollamb_tpu.config import LlamaConfig  # noqa: E402
from videollamb_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from videollamb_tpu.constants import IGNORE_INDEX  # noqa: E402

TOL = 1e-5
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
LEAF_RTOL, LEAF_ATOL = 1e-4, 1e-5
CFG = LlamaConfig.tiny(num_hidden_layers=4)
TRAIN_KW = dict(learning_rate=1e-3, warmup_ratio=0.25, max_grad_norm=0.05)
TOTAL, STEPS = 4, 2
TASKS = ["ring", "seq_parallel_lm", "seq_parallel_step", "pipeline_lm"]


def _close(ours, ref, tol=TOL, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()), err_msg=msg)


def _inputs():
    rng = np.random.default_rng(0)
    d = CFG.hidden_size
    ring = [rng.normal(size=(2, 16, 4, 8)).astype(np.float32) for _ in range(4)]  # q k v ct

    def lm_inputs(b, s, ragged=None):
        embeds = rng.normal(size=(b, s, d)).astype(np.float32)
        mask = np.ones((b, s), np.int32)
        if ragged is not None:
            mask[1, ragged:] = 0
        labels = rng.integers(0, CFG.vocab_size, size=(b, s)).astype(np.int32)
        return embeds, mask, labels

    pp = lm_inputs(4, 12, ragged=9)
    sp = {"seq4": lm_inputs(2, 16, ragged=13), "data2_seq2": pp}
    embeds, mask, labels = lm_inputs(4, 8)
    labels[0, :3] = IGNORE_INDEX
    return ring, sp, pp, (embeds, mask, labels)


def _ce(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))


def _jax_refs(params, ring, sp, pp, lm_batch):
    import optax

    from videollamb_tpu.models.assembly import causal_lm_loss
    from videollamb_tpu.models.lm.llama import llama_forward
    from videollamb_tpu.parallel.ring_attention import create_seq_mesh, ring_attention
    from videollamb_tpu.parallel.seq_parallel import seq_parallel_llama_forward
    from videollamb_tpu.train.step import create_optimizer

    refs = {}
    mesh4 = create_seq_mesh(4)
    for causal in (True, False):
        @jax.jit
        def out_and_grads(q, k, v, ct):
            out, vjp = jax.vjp(lambda a, b, c: ring_attention(mesh4, a, b, c, causal=causal),
                               q, k, v)
            return (out,) + vjp(ct)

        refs[("ring", causal)] = [np.asarray(x) for x in
                                  out_and_grads(*(jnp.asarray(a) for a in ring))]
    e, m, lab = (jnp.asarray(a) for a in sp["seq4"])

    def sp_loss(p):
        logits = seq_parallel_llama_forward(mesh4, p, CFG, e, m, remat=True)
        return _ce(logits, lab), logits

    (_, logits), grads = jax.value_and_grad(sp_loss, has_aux=True)(params)
    refs[("sp", "seq4")] = (np.asarray(logits), jax.tree.map(np.asarray, grads))
    e, m, lab = (jnp.asarray(a) for a in pp)

    def pp_loss(p):
        logits = llama_forward(p, CFG, e, m)
        return _ce(logits, lab), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(pp_loss, has_aux=True))(params)
    refs["pp"] = (np.asarray(logits), jax.tree.map(np.asarray, grads))
    refs[("sp", "data2_seq2")] = refs["pp"]  # the same inputs

    # The LM step (as make_seq_parallel_train_step / make_pipeline_train_step
    # compose it) over the unsplit forward.
    tx = create_optimizer(JaxTrainConfig(**TRAIN_KW), TOTAL, params)
    e, m, lab = (jnp.asarray(a) for a in lm_batch)

    @jax.jit
    def step(p, opt):
        (loss, n), g = jax.value_and_grad(
            lambda q_: causal_lm_loss(llama_forward(q_, CFG, e, m), lab), has_aux=True)(p)
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt, loss, n, optax.global_norm(g)

    own, opt, metrics = params, tx.init(params), []
    for _ in range(STEPS):
        own, opt, loss, n, norm = step(own, opt)
        metrics.append((float(loss), float(norm), int(n)))
    refs["step"] = (jax.tree.map(np.asarray, own), metrics)
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from videollamb_torch import config as pc
    from videollamb_tpu.models.lm.llama import init_llama_params

    params = jax.tree.map(np.asarray, jax.jit(lambda key: init_llama_params(key, CFG))(
        jax.random.PRNGKey(0)))
    ring, sp, pp, lm_batch = _inputs()
    lm_cfg = pc.LlamaConfig(**{k: v for k, v in vars(CFG).items()})
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    spec = {"tasks": TASKS, "lm_cfg": lm_cfg, "lm_tree": params, "ring": ring,
            "sp_inputs": sp, "pp_inputs": pp, "lm_batch": lm_batch,
            "lm_train_cfg": pc.TrainConfig(**TRAIN_KW), "total_steps": TOTAL,
            "n_steps": STEPS}
    ctx = du.start_ranks(4, spec, out_dir)
    try:
        refs = _jax_refs(jax.tree.map(jnp.asarray, params), ring, sp, pp, lm_batch)
    finally:
        results = du.join_ranks(ctx, out_dir, 4)
    return refs, results


def _lm_grads_to_jax(grads):
    from videollamb_torch.models.convert import to_jax_params

    return to_jax_params({f"lm.{k}": torch.from_numpy(v) for k, v in grads.items()})["lm"]


def _close_trees(ours, ref, leaf_tol=False):
    got = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert set(got) == set(want)
    for path in want:
        if leaf_tol:
            np.testing.assert_allclose(got[path], want[path], rtol=LEAF_RTOL, atol=LEAF_ATOL,
                                       err_msg=jax.tree_util.keystr(path))
        else:
            _close(got[path], want[path], msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_and_gradients_equal_jax(runs, causal):
    refs, results = runs
    parts = [du.result(results, "ring", r)[causal] for r in range(4)]
    for i, key in enumerate(("out", "dq", "dk", "dv")):
        _close(np.concatenate([p[key] for p in parts], axis=1), refs[("ring", causal)][i],
               msg=key)


@pytest.mark.parametrize("name", ["seq4", "data2_seq2"])
def test_seq_parallel_forward_and_gradients_equal_jax(runs, name):
    refs, results = runs
    logits, grads = refs[("sp", name)]
    parts = [du.result(results, "seq_parallel_lm", r)[name] for r in range(4)]
    if name == "seq4":
        ours = np.concatenate([p["logits"] for p in parts], axis=1)
    else:  # rank = d * 2 + s: rows over data, sequence over seq
        ours = np.concatenate([np.concatenate([parts[2 * d + s]["logits"] for s in range(2)],
                                              axis=1) for d in range(2)], axis=0)
    _close(ours, logits)
    for r in range(4):
        _close_trees(_lm_grads_to_jax(parts[r]["grads"]), grads)


@pytest.mark.parametrize("stages", [4, 2])
def test_pipeline_forward_equal_jax(runs, stages):
    refs, results = runs
    for r in range(4):
        _close(du.result(results, "pipeline_lm", r)[f"{stages}x{8 // stages}"]["logits"],
               refs["pp"][0])


def test_pipeline_gradients_equal_jax(runs):
    refs, results = runs
    grads = {}
    for r in range(4):  # stage r holds layer r; the rest is replicated
        grads.update(du.result(results, "pipeline_lm", r)["4x2"]["grads"])
    _close_trees(_lm_grads_to_jax(grads), refs["pp"][1])


def _check_step(got_params, metrics, ref):
    jparams, jmetrics = ref
    for (pl, pn, pt), (jl, jn, jt) in zip(metrics, jmetrics):
        assert pt == jt
        np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(pn, jn, rtol=NORM_RTOL)
        assert pn > TRAIN_KW["max_grad_norm"]
    _close_trees(_lm_grads_to_jax(got_params), jparams, leaf_tol=True)


def test_seq_parallel_train_step_equal_jax(runs):
    refs, results = runs
    for r in range(4):
        got = du.result(results, "seq_parallel_step", r)
        _check_step(got["params"], got["metrics"], refs["step"])


@pytest.mark.parametrize("name,stages", [("4x2", 4), ("2x4", 2), ("2x2_data", 2)])
def test_pipeline_train_step_equal_jax(runs, name, stages):
    refs, results = runs
    for r in range(4):
        replica = r - r % stages
        params = {}
        for q in range(replica, replica + stages):
            params.update(du.result(results, "pipeline_lm", q)[f"step_{name}"]["params"])
        got = du.result(results, "pipeline_lm", r)[f"step_{name}"]
        assert got["n_local_layers"] == CFG.num_hidden_layers // stages
        _check_step(params, got["metrics"], refs["step"])
