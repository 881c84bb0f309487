"""The DeepSeek-V3-family LM (``models/lm/mla.py``): latent attention and
routed experts, its latent page pool and the paged engine over it.

The oracle is the plain reference ``portbench/reference/mla_moe.py``
(float32, no cache, a loop over experts), not the JAX package, which has no
such LM. Every CPU case runs in float32 at a tiny size: hidden 64, 4 heads,
kv rank 32, 16 rope, 16 nope and 16 v dims, one dense layer and two MoE
layers of 8 experts (top 2, one shared), vocabulary 256.

Tolerances: the program and the reference compute the same float32 sums in
another order (absorbed against expanded attention, grouped against
per-expert sums, einsums against matmuls), which moves logits of about unit
size by a few 1e-7; ``ATOL`` = 1e-5 leaves room for that and catches any
change of the mathematics, which moves them by 1e-3 or more. Served tokens
are held to the reference's best logit within ``GAP`` = 1e-4, the same
float32 agreement read through the harness's own comparison.

On the card (``cuda``): the paged decode forward of this family replays as
one CUDA graph, and replay and eager give equal tokens and logits within
1e-3, at small widths in bf16; the grouped route of the routed experts
equals the loop over experts there (and through the CPU's grouped product).
"""

from __future__ import annotations

import dataclasses
import os

import pytest
import torch

from videollamb_torch.config import MLAConfig
from videollamb_torch.models.lm import mla
from videollamb_torch.models.lm.paged import (
    fused_admit,
    init_paged_cache,
    latent_attention,
    paged_decode_step,
)

ATOL = 1e-5
GAP = 1e-4
CFG = MLAConfig.tiny()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes gain nothing from intra-op threads, and on a host shared by
    several test workers each small op's thread pool waits on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_cfg(cfg: MLAConfig) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _weights(lm, prefix="lm."):
    from portbench.reference.linear import Weights

    return Weights({prefix + k: v for k, v in lm.state_dict().items()})


@pytest.fixture(scope="module")
def lm():
    """The tiny LM, its routers spread so that scores differ (0.3 x N(0, 1))."""
    torch.manual_seed(0)
    model = mla.init_mla_params(CFG, seed=3)
    with torch.no_grad():
        for moe in mla.moe_blocks(model):
            moe.gate.weight.normal_(0.0, 0.3)
            moe.gate.e_score_correction_bias.normal_(0.0, 0.05)
    return model


@pytest.fixture(scope="module")
def sequence(lm):
    """40 input embeddings and the reference's logits at every position."""
    from portbench.reference import mla_moe

    emb = torch.randn(1, 40, CFG.hidden_size, generator=torch.Generator().manual_seed(5))
    return emb, mla_moe.lm_logits(_weights(lm), _ref_cfg(CFG), emb[0], 0)


def test_full_forward_matches_the_reference(lm, sequence):
    emb, ref = sequence
    got = mla.mla_forward(lm, CFG, emb, torch.ones(1, 40, dtype=torch.bool))[0]
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("chunks", [(40,), (17, 23)], ids=["one_pass", "extend"])
def test_dense_cache_prefill_and_extend(lm, sequence, chunks):
    """Prefill then extend on the dense latent cache, then dense decode."""
    emb, ref = sequence
    cache = mla.init_latent_cache(CFG, 1, 48, dtype=torch.float32)
    lo = 0
    for n in chunks[:-1] + (chunks[-1] - 4,):
        logits, cache = mla.mla_extend(lm, CFG, emb[:, lo:lo + n],
                                       torch.ones(1, n, dtype=torch.bool), cache)
        lo += n
        torch.testing.assert_close(logits[0], ref[lo - 1], atol=ATOL, rtol=0)
    for j in range(lo, 40):
        logits, cache = mla.mla_decode_step(lm, CFG, emb[:, j:j + 1], cache)
        torch.testing.assert_close(logits[0], ref[j], atol=ATOL, rtol=0)


def test_chunked_prefill_then_paged_decode_through_the_latent_pool(lm, sequence):
    """Admission into pages of 8 (its last page partial) and a slot beside it,
    then every decode step through the pool against the full forward."""
    emb, ref = sequence
    cache = init_paged_cache(CFG, 2, 1 + 12, page_size=8, pages_per_seq=6, dtype=torch.float32)
    logits = torch.zeros(2, CFG.vocab_size)
    # A splice buffer longer than the prompt, its tail padding.
    buf = torch.cat([emb[:, :27], torch.zeros(1, 5, CFG.hidden_size)], dim=1)
    mask = torch.arange(32)[None] < 27
    fused_admit(lm, CFG, buf, mask, 27, cache, logits, 1, [7, 8, 9, 10, 11, 12])
    torch.testing.assert_close(logits[1], ref[26], atol=ATOL, rtol=0)
    assert cache.lengths.tolist() == [0, 27]
    for j in range(27, 40):
        step_in = torch.zeros(2, 1, CFG.hidden_size)
        step_in[1, 0] = emb[0, j]
        out = paged_decode_step(lm, CFG, step_in, cache)
        torch.testing.assert_close(out[1], ref[j], atol=ATOL, rtol=0)
    assert cache.lengths.tolist() == [13, 40]


def test_absorbed_equals_unabsorbed_attention(lm):
    """One layer's attention over 20 cached rows: W_UK folded into q, scores
    over the 48-wide rows, W_UV after, against kv_b_proj expanding them."""
    g = torch.Generator().manual_seed(2)
    layer = lm.model.layers[1]
    x = torch.randn(3, 20, CFG.hidden_size, generator=g)
    pos = torch.arange(20)[None].expand(3, 20)
    cos, sin = mla.rope_cos_sin_cfg(CFG, pos)
    rows = mla.latent_rows(layer, CFG, x, cos, sin)
    q_nope, q_pe = mla.q_heads(layer, CFG, x[:, -1:], cos[:, -1:], sin[:, -1:])
    lengths = torch.tensor([20, 11, 4])
    keys = torch.arange(20)[None] < lengths[:, None]
    want = mla.unabsorbed_attention(layer, CFG, q_nope, q_pe, rows, keys[:, None])
    w_uk, w_uv = mla.absorbed_weights(layer, CFG)
    q_full = torch.cat([torch.einsum("bhd,hdr->bhr", q_nope[:, 0], w_uk), q_pe[:, 0]], -1)
    bias = torch.where(keys, 0.0, mla.NEG_INF)
    o_lat = latent_attention(q_full, rows, bias, CFG.softmax_scale, CFG.kv_lora_rank)
    got = torch.einsum("bhr,hdr->bhd", o_lat, w_uv).reshape(3, 1, -1)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_router_hand_worked():
    """Four experts, top 2, scaling 2: h = e_0, so the logits are the gate's
    first column and the scores their sigmoids."""
    cfg = MLAConfig.tiny(hidden_size=8, n_routed_experts=4, num_experts_per_tok=2,
                         routed_scaling_factor=2.0)
    moe = mla.MoE(cfg)
    logits = torch.tensor([2.0, 0.0, 1.0, -1.0])
    with torch.no_grad():
        moe.gate.weight.zero_()
        moe.gate.weight[:, 0] = logits
        moe.gate.e_score_correction_bias.zero_()
    h = torch.zeros(1, 8)
    h[0, 0] = 1.0
    s = torch.sigmoid(logits)
    choice, w = mla.route(moe, cfg, h)
    assert sorted(choice[0].tolist()) == [0, 2]
    by_expert = dict(zip(choice[0].tolist(), w[0].tolist()))
    assert by_expert[0] == pytest.approx(2.0 * s[0] / (s[0] + s[2]), abs=1e-6)
    assert by_expert[2] == pytest.approx(2.0 * s[2] / (s[0] + s[2]), abs=1e-6)
    # The bias lifts expert 1 over expert 2 for the choice; its weight still
    # comes from the unbiased score.
    with torch.no_grad():
        moe.gate.e_score_correction_bias[1] = 0.3
    choice, w = mla.route(moe, cfg, h)
    assert sorted(choice[0].tolist()) == [0, 1]
    by_expert = dict(zip(choice[0].tolist(), w[0].tolist()))
    assert by_expert[1] == pytest.approx(2.0 * s[1] / (s[0] + s[1]), abs=1e-6)


def test_counters_count_the_routes(lm):
    """Tokens routed to each expert, and the forwards in which each had one,
    of the valid tokens only."""
    moe = mla.moe_blocks(lm)[0]
    h = torch.randn(6, CFG.hidden_size, generator=torch.Generator().manual_seed(9))
    valid = torch.tensor([True, True, False, True, True, False])
    choice, _ = mla.route(moe, CFG, h)
    before = moe.routed.clone()
    mla.moe_forward(moe, CFG, h, valid)
    want = torch.zeros(CFG.n_routed_experts, dtype=torch.long)
    for e in choice[valid].reshape(-1).tolist():
        want[e] += 1
    assert torch.equal(moe.routed[0] - before[0], want)
    assert torch.equal(moe.routed[1] - before[1], (want > 0).long())
    load = mla.expert_load(lm)
    assert load.shape == (2, CFG.num_moe_layers, CFG.n_routed_experts)


# --------------------------------------------------------------------------- the engine
def tiny_cell_cfg() -> dict:
    """The benchmark's configuration file at the tiny widths above."""
    from portbench.models import load_config
    from portbench.tests import tiny

    cfg = load_config("videollamb-moonlight-16b-a3b")
    base = tiny.videollamb_cfg()
    cfg.update(dtype="float32", max_length=512, vision=base["vision"], bridge=base["bridge"])
    cfg["lm"].update({k: v for k, v in _ref_cfg(CFG).items()
                      if k in ("vocab_size", "hidden_size", "intermediate_size",
                               "moe_intermediate_size", "num_hidden_layers",
                               "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
                               "qk_rope_head_dim", "v_head_dim", "n_routed_experts",
                               "n_shared_experts", "num_experts_per_tok")})
    return cfg


@pytest.fixture(scope="module")
def video_model():
    from portbench.cells.video_qa_mla import build_videollamb_mla

    cfg = tiny_cell_cfg()
    model, mcfg, weights = build_videollamb_mla(cfg, 2 ** 31 + 77, torch.device("cpu"))
    return cfg, model, mcfg, weights


@pytest.fixture(scope="module")
def served(video_model):
    """A video and question prefix of more than one page registered once and
    mapped into two slots, each with its own suffix, and a third request
    with no prefix, through three slots at k = 2."""
    from portbench import gen
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import Request

    cfg, model, mcfg, _ = video_model
    traffic = {"cut_every": 8, "last_segment_frames": 8, "scenes": [4, 4], "weak_cut_mix": 0.2,
               "frame_noise": 0.05}
    plan = gen.VideoRequest(index=0, frames=32, ids=[], answer_tokens=0,
                            scene_frames=[8, 8, 8, 8], strong_cuts=[7, 15, 23], clip_seed=123,
                            prompt_len=0)
    clip = gen.make_clip(plan, traffic, cfg["vision"]["image_size"], "cpu", torch.float32)
    prefix_ids = [1, 9, 10, -201, 11, 12]
    suffixes = [[20, 21, 22], [30, 31], [40, 41, 42, 43]]
    engine = PagedServingEngine(model, mcfg, num_slots=3, page_size=8, eos_token_id=-1)

    def batch(ids, video=None):
        t = torch.tensor([ids])
        return MultimodalBatch(input_ids=t, attention_mask=torch.ones_like(t), videos=video)

    pid = engine.register_prefix(batch(prefix_ids, clip[None]))
    info = engine._prefixes[pid]
    reqs = [Request(uid=0, batch=batch(suffixes[0]), max_new_tokens=6, prefix_id=pid),
            Request(uid=1, batch=batch(suffixes[1]), max_new_tokens=5, prefix_id=pid),
            Request(uid=2, batch=batch(prefix_ids + suffixes[2], clip[None]), max_new_tokens=4)]
    for r in reqs:
        engine.submit(r)
    engine.step(2)
    refs = engine.allocator.refcount(info["pages"][0])
    while engine.has_work():
        engine.step(2)
    return engine, reqs, clip, prefix_ids, suffixes, info, refs


def test_engine_shares_a_prefix_page_and_matches_the_reference(video_model, served):
    """Every served token is the reference's best, teacher-forced over the
    whole prompt; the prefix's first page was mapped into both slots."""
    from portbench.reference import mla_moe
    from portbench.reference.linear import Weights

    cfg, _, _, weights = video_model
    engine, reqs, clip, prefix_ids, suffixes, info, refs = served
    assert len(info["pages"]) >= 1
    assert refs == 3  # the registration and two slots
    assert all(r.error is None and len(r.tokens) == r.max_new_tokens for r in reqs)
    w = Weights(weights, "f32")
    for r, suffix in zip(reqs, suffixes):
        s = mla_moe.score_request(w, cfg, prefix_ids + suffix, clip, r.tokens)
        served_logit = s.logits.gather(1, torch.tensor(r.tokens)[:, None])[:, 0]
        assert float((s.logits.max(dim=-1).values - served_logit).max()) <= GAP, r.uid


def test_engine_counters_reach_metrics(served):
    """The expert counters (admissions and decode) and the pool's bytes a
    token, in the engine and on /metrics."""
    from videollamb_torch.serve.http_server import Metrics

    engine = served[0]
    load = engine.expert_load()
    assert load.shape == (2, CFG.num_moe_layers, CFG.n_routed_experts) and load[0].sum() > 0
    assert (load[1] <= load[0]).all()
    assert engine.kv_bytes_per_token == CFG.num_hidden_layers * CFG.latent_dim * 4

    class Worker:
        def is_alive(self):
            return True

    vals = dict(line.rsplit(" ", 1) for line in Metrics().render(engine, Worker()).splitlines()
                if line and not line.startswith("#"))
    assert int(vals["videollamb_experts_routed_tokens_total"]) == load[0].sum()
    assert float(vals["videollamb_kv_bytes_per_token"]) == engine.kv_bytes_per_token
    for i, row in enumerate(load[0]):
        ratio = float(vals[f'videollamb_expert_load_imbalance{{layer="{i + 1}"}}'])
        assert ratio == pytest.approx(row.max() / row.mean())


def test_engine_counts_only_the_slots_holding_a_request(video_model):
    """One request of 11 text tokens and a budget of 6 through three slots at
    k = 2: two slots stay free through every decode forward while their
    lengths advance. The routed-token counters then hold exactly the routes
    of the 11 prompt tokens and the 6 tokens fed back, as the full forward
    over those 17 tokens routes them."""
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import Request

    _, model, mcfg, weights = video_model
    engine = PagedServingEngine(model, mcfg, num_slots=3, page_size=8, eos_token_id=-1)
    ids = torch.randint(3, CFG.vocab_size, (1, 11), generator=torch.Generator().manual_seed(8))
    req = Request(uid=0, batch=MultimodalBatch(ids, torch.ones_like(ids)), max_new_tokens=6)
    before = engine.expert_load()
    engine.submit(req)
    while engine.has_work():
        engine.step(2)
    assert len(req.tokens) == 6
    assert int(engine.cache.lengths.min()) > 1  # the free slots' lengths moved too
    got = engine.expert_load() - before
    seq = torch.tensor(ids[0].tolist() + req.tokens)
    emb = weights["lm.model.embed_tokens.weight"][seq][None]
    start = mla.expert_load(model.lm).clone()
    mla.mla_forward(model.lm, mcfg.lm, emb, torch.ones(1, 17, dtype=torch.bool))
    want = (mla.expert_load(model.lm) - start)[0].numpy()
    assert (got[0].sum(axis=1) == 17 * CFG.num_experts_per_tok).all()
    assert (got[0] == want).all()


def test_swap_out_and_in_of_latent_pages(video_model):
    """Four text requests through three slots of a pool too small for them:
    the youngest is swapped to host memory and resumed, and every served
    token is still the reference's best, teacher-forced."""
    from portbench.reference import mla_moe
    from portbench.reference.linear import Weights
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import Request

    cfg, model, mcfg, weights = video_model
    engine = PagedServingEngine(model, mcfg, num_slots=3, page_size=8, pages_per_seq=4,
                                total_pages=1 + 7, eos_token_id=-1)
    gen = torch.Generator().manual_seed(6)
    reqs = []
    for uid, (n, budget) in enumerate([(12, 10), (9, 12), (14, 8), (7, 6)]):
        ids = torch.randint(3, CFG.vocab_size, (1, n), generator=gen)
        reqs.append(Request(uid=uid, batch=MultimodalBatch(ids, torch.ones_like(ids)),
                            max_new_tokens=budget))
        engine.submit(reqs[-1])
    while engine.has_work():
        engine.step(4)
    assert engine.preempted >= 1 and engine.resumed == engine.preempted
    assert all(r.error is None and len(r.tokens) == r.max_new_tokens for r in reqs)
    w = Weights(weights, "f32")
    table = weights["lm.model.embed_tokens.weight"]
    for r in reqs:
        prompt = r.batch.input_ids[0].tolist()
        emb = table[torch.tensor(prompt + r.tokens[:-1])]
        logits = mla_moe.lm_logits(w, cfg["lm"], emb, len(prompt) - 1)
        served = logits.gather(1, torch.tensor(r.tokens)[:, None])[:, 0]
        assert float((logits.max(dim=-1).values - served).max()) <= GAP, r.uid


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist

    store = dist.FileStore(os.path.join(str(tmp_path), "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["int8_pages", "lora_stack", "int4_weights", "sharded",
                                  "dense_engine"])
def test_the_engine_refuses_what_this_family_lacks(video_model, case, request):
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import ServingEngine

    _, model, mcfg, _ = video_model
    kwargs = {}
    if case == "int8_pages":
        kwargs["quantize_kv"] = True
        match = "int8 KV pages"
    elif case == "lora_stack":
        kwargs["adapter_registry"] = {"a": 0}
        match = "multi-LoRA"
    elif case == "int4_weights":
        from videollamb_torch.models.lm.quant import quantize_kernel_int4, QuantLinear

        lm = mla.empty_mla_lm(mcfg.lm, "cpu", torch.float32)
        lm.load_state_dict(model.lm.state_dict())
        attn = lm.model.layers[0].self_attn
        attn.q_proj = QuantLinear(quantize_kernel_int4(attn.q_proj.weight.t(), group=32))
        model = type(model)(model.video_tower, model.mm_projector, lm)
        match = "quantised or adapter projections"
    elif case == "sharded":
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate

        request.getfixturevalue("one_rank")
        mesh = init_device_mesh("cpu", (1,))
        lm = mla.empty_mla_lm(mcfg.lm, "cpu", torch.float32)
        lm.load_state_dict(model.lm.state_dict())
        head = lm.lm_head
        head.weight = torch.nn.Parameter(DTensor.from_local(head.weight.data, mesh,
                                                            [Replicate()]), requires_grad=False)
        model = type(model)(model.video_tower, model.mm_projector, lm)
        match = "sharded"
    if case == "dense_engine":
        with pytest.raises(ValueError, match="PagedServingEngine"):
            ServingEngine(model, mcfg, num_slots=2)
        return
    with pytest.raises(ValueError, match=match):
        PagedServingEngine(model, mcfg, num_slots=2, page_size=8, **kwargs)


def test_the_decode_graph_route_takes_bf16_weights_only():
    """bf16 weights replay (grouped experts, counts on the device); f32 ones
    loop over the experts on the host and stay eager; never off the card."""
    from videollamb_torch.serve.paged import decode_graph_route

    cuda = torch.device("cuda")
    assert decode_graph_route(mla.empty_mla_lm(CFG, "cpu", torch.bfloat16), cuda)
    assert not decode_graph_route(mla.empty_mla_lm(CFG, "cpu", torch.float32), cuda)
    assert not decode_graph_route(mla.empty_mla_lm(CFG, "cpu", torch.bfloat16),
                                  torch.device("cpu"))


def test_the_builder_loads_a_deepseek_v3_checkpoint(video_model, tmp_path):
    """config.json with model_type deepseek_v3 builds this LM and loads it by
    its HF names, the experts into their stacked home."""
    import json

    from videollamb_torch.models.builder import config_from_json, load_pretrained_model

    cfg, model, mcfg, _ = video_model
    raw = dict(_ref_cfg(mcfg.lm), model_type="deepseek_v3", mm_projector_type="rmt_r_transformer1x",
               mm_hidden_size=cfg["bridge"]["hidden_size"])
    raw.pop("rope_scaling")
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    assert config_from_json(str(tmp_path)).lm == mcfg.lm
    sd = {"model." + k[len("lm.model."):] if k.startswith("lm.model.") else k[len("lm."):]: v
          for k, v in model.state_dict().items() if k.startswith("lm.")}
    assert "model.layers.1.mlp.experts.3.gate_proj.weight" in sd
    assert "model.layers.2.mlp.gate.e_score_correction_bias" in sd
    torch.save(sd, tmp_path / "pytorch_model.bin")
    with pytest.raises(ValueError, match="int8 weights"):
        load_pretrained_model(str(tmp_path), load_tokenizer=False, device="cpu",
                              dtype="float32", bridge_seed=0, load_8bit=True)
    _, loaded, lcfg, _, _ = load_pretrained_model(str(tmp_path), load_tokenizer=False,
                                                  device="cpu", dtype="float32", bridge_seed=0)
    assert isinstance(loaded.lm, mla.MLAForCausalLM) and lcfg.lm == mcfg.lm
    moe = mla.moe_blocks(loaded.lm)[0]
    w13, w2 = moe.stacked()
    assert moe.experts[3].gate_proj.weight.data_ptr() == w13[3].data_ptr()
    torch.testing.assert_close(w2[5], sd["model.layers.1.mlp.experts.5.down_proj.weight"])


# --------------------------------------------------------------------------- the card
def _card_engine(graph: bool, monkeypatch):
    from videollamb_torch.serve import paged

    cfg = tiny_cell_cfg()
    cfg["dtype"] = "bfloat16"
    # Widths the grouped products take (rows 16-byte aligned), small otherwise.
    cfg["lm"].update(hidden_size=256, intermediate_size=512, moe_intermediate_size=128,
                     num_attention_heads=4, kv_lora_rank=64, qk_nope_head_dim=32,
                     qk_rope_head_dim=32, v_head_dim=32, vocab_size=512)
    from portbench.cells.video_qa_mla import build_videollamb_mla

    model, mcfg, _ = build_videollamb_mla(cfg, 11, torch.device("cuda"))
    if not graph:
        monkeypatch.setattr(paged, "decode_graph_route", lambda lm, device: False)
    else:
        assert paged.decode_graph_route(model.lm, torch.device("cuda"))
    return paged.PagedServingEngine(model, mcfg, num_slots=4, page_size=16, pages_per_seq=8,
                                    total_pages=1 + 14, eos_token_id=-1)


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_the_card(monkeypatch):
    """Six text requests through four slots of a 14-page pool at k = 4
    (admissions between steps, a swap when pages run dry, slots released
    mid-batch), replayed and eager: equal tokens, logits within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.serve.server import Request

    runs = []
    for graph in (True, False):
        engine = _card_engine(graph, monkeypatch)
        gen = torch.Generator().manual_seed(4)
        reqs = []
        for uid, (n, budget) in enumerate([(40, 30), (24, 70), (33, 12), (50, 60), (20, 44),
                                           (36, 25)]):
            ids = torch.randint(3, 512, (1, n), generator=gen).cuda()
            reqs.append(Request(uid=uid, batch=MultimodalBatch(ids, torch.ones_like(ids)),
                                max_new_tokens=budget))
            engine.submit(reqs[-1])
        logits = []
        with torch.no_grad():
            while engine.has_work():
                engine.step(4)
                active = [i for i, r in enumerate(engine.slots) if r is not None]
                logits.append(engine.logits[active].cpu())
        runs.append((engine, [list(r.tokens) for r in reqs], logits,
                     engine.expert_load()))
    (g, g_tok, g_log, g_load), (e, e_tok, e_log, e_load) = runs
    assert g.decode_replays > 0 and g.decode_captures == 1 and g.decode_eager == 1
    assert e.decode_replays == 0 and g.preempted >= 1
    assert g_tok == e_tok
    assert len(g_log) == len(e_log)
    for a, b in zip(g_log, e_log):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0)
    assert (g_load == e_load).all()  # the counters count in a replay as eagerly


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("routing", ["gate", "sparse"])
def test_grouped_experts_equal_the_loop(routing, device):
    """The card's route of the routed experts (rows sorted by expert, two
    grouped products over the stacked weights, the weighted sum back) against
    the loop over experts, on the same h, choice and weights, bf16 at widths
    the grouped products take, on the card and through the CPU's grouped
    product. ``gate`` routes by the gate; ``sparse`` sends
    every token to experts 1, 2, 4 and 5 only, so the first, the last and two
    middle experts get no rows. Tolerance: both routes round the products'
    outputs and the activation to bf16 at the same points and differ only in
    the order the products sum, so an output moves by a few bf16 roundings
    (2^-8 relative) of its terms; torch.testing's bf16 tolerance, 1.6e-2,
    taken of the largest output because a sum that cancels near zero keeps
    its terms' absolute error. A row sent to the wrong expert, a wrong offset
    or a wrong weight moves outputs by their own size."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = MLAConfig.tiny(hidden_size=256, moe_intermediate_size=128)
    lm = mla.init_mla_params(cfg, seed=5, dtype=torch.bfloat16, device=device)
    moe = mla.moe_blocks(lm)[0]
    with torch.no_grad():
        moe.gate.weight.normal_(0.0, 0.3)
    h = torch.randn(40, cfg.hidden_size, generator=torch.Generator().manual_seed(2))
    h = h.to(device, torch.bfloat16)
    choice, w = mla.route(moe, cfg, h)
    if routing == "sparse":
        pairs = torch.tensor([[1, 2], [4, 5], [2, 4], [5, 1]], device=device)
        choice = pairs[torch.arange(40, device=device) % 4]
    counts = torch.bincount(choice.reshape(-1), minlength=cfg.n_routed_experts)
    if routing == "sparse":
        assert counts[[0, 3, 6, 7]].sum() == 0
    with torch.no_grad():
        grouped = mla._experts_grouped(moe, h, choice, w, counts)
        loop = mla._experts_loop(moe, h, choice, w)
    tol = 1.6e-2 * float(loop.abs().max())
    torch.testing.assert_close(grouped, loop, atol=tol, rtol=0)


def test_batch_cli_serves_the_family_paged(tmp_path):
    """``batch_cli --paged`` over a deepseek_v3 VideoLLaMB checkpoint in the
    reference's format (LM and projector, a LanguageBind tower dir, the tiny
    tokenizer): video and text rows answered; ``--quantize-kv`` refused."""
    import dataclasses as dc
    import importlib.util
    import json

    import cv2
    import numpy as np

    from portbench.cells.video_qa_mla import build_videollamb_mla
    from videollamb_torch.config import BridgeConfig
    from videollamb_torch.serve import batch_cli

    cfg = tiny_cell_cfg()
    cfg["lm"]["vocab_size"] = 512  # the tiny tokenizer's
    # The projector config.json implies: rmt_r_transformer1x at the tower's width.
    cfg["bridge"] = dc.asdict(BridgeConfig.from_projector_type(
        "rmt_r_transformer1x", hidden_size=cfg["vision"]["hidden_size"]))
    cfg["vision"]["num_hidden_layers"] = 2
    model, mcfg, _ = build_videollamb_mla(cfg, 5, torch.device("cpu"))
    model_dir, tower_dir = tmp_path / "ckpt", tmp_path / "tower"
    model_dir.mkdir()
    tower_dir.mkdir()
    sd = {k: v for k, v in model.lm.state_dict().items()}
    sd.update({"model.mm_projector." + k: v for k, v in model.mm_projector.state_dict().items()})
    torch.save(sd, model_dir / "pytorch_model.bin")
    torch.save(model.video_tower.state_dict(), tower_dir / "pytorch_model.bin")
    v = mcfg.vision
    (tower_dir / "config.json").write_text(json.dumps({"vision_config": {
        "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
        "num_hidden_layers": v.num_hidden_layers, "num_attention_heads": v.num_attention_heads,
        "image_size": v.image_size, "patch_size": v.patch_size, "num_frames": v.num_frames,
        "add_time_attn": True, "hidden_act": "quick_gelu"}}))
    raw = {k: val for k, val in _ref_cfg(mcfg.lm).items() if k != "rope_scaling"}
    raw.update(model_type="deepseek_v3", mm_projector_type="rmt_r_transformer1x",
               mm_hidden_size=v.hidden_size, mm_video_tower=str(tower_dir),
               mm_vision_select_layer=-2, num_frames=8, tokenizer_model_max_length=512)
    (model_dir / "config.json").write_text(json.dumps(raw))
    spec = importlib.util.spec_from_file_location(
        "parity_rehearsal", os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                                         "parity_rehearsal.py"))
    rehearsal = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rehearsal)
    rehearsal.build_tokenizer(str(model_dir))
    frames = tmp_path / "vid"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(frames / f"{i:04d}.jpg"),
                    rng.integers(0, 255, (64, 80, 3)).astype(np.uint8))
    src, dst = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    src.write_text(json.dumps({"id": "a", "prompt": "what happens", "video": str(frames),
                               "max_new_tokens": 5}) + "\n"
                   + json.dumps({"id": "b", "prompt": "describe it", "max_new_tokens": 4}) + "\n")
    args = ["--model-path", str(model_dir), "--video-tower", str(tower_dir), "--requests",
            str(src), "--output", str(dst), "--device", "cpu", "--fp32", "--num-slots", "2",
            "--paged"]
    batch_cli.main(args)
    out = {row["id"]: row for row in map(json.loads, dst.read_text().splitlines())}
    assert set(out) == {"a", "b"} and all("error" not in r for r in out.values())
    assert 1 <= out["a"]["tokens"] <= 5 and 1 <= out["b"]["tokens"] <= 4
    with pytest.raises(ValueError, match="int8 KV pages"):
        batch_cli.main(args + ["--quantize-kv"])
