"""EgoVLP text branch: the RoBERTa encoder, the dual-encoder projections,
the FIBER-style fusion heads (ITM / MLM) and the retrieval metrics.

Port of ``videollamb_tpu/models/vision/egovlp_text.py`` (reference
llava/model/multimodal_encoder/egovlp/model/{roberta.py, model.py:44-574,
heads.py, metric.py}). Like the reference factory entry
(multimodal_encoder/builder.py:56-58, commented out) it is an optional
component that no entry point reaches; the tests and ``chip_smoke.py``
drive it.

- Modules keep the JAX tree's names (``attention.query``,
  ``crossattention_t2i``, ``alpha_t2i``, ``output_LayerNorm``, ...);
  :func:`videollamb_torch.models.convert.egovlp_text_from_jax` carries a JAX
  tree across, unstacking its scanned layer stacks into ``layers`` and
  ``fuse_layers``.
- Attention scores and softmax are f32; the post-LN residual order follows
  the reference: self-attention dense, then the alpha_t2i-gated
  cross-attention over the video stream in the fusion layers, LN(+residual),
  FFN, LN(+residual).
- The video side of the fusion is ``egovlp.EgoVLPTower`` with its last
  ``num_fuse_block`` blocks built as fusion blocks (:func:`init_fusion_video_params`),
  whose space attention runs ``egovlp._i2t_cross``.
- It runs no kernel: the JAX package computes it in plain einsums, and so
  does the port.
- The retrieval metrics are numpy, copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.models.seeded import empty_module, generator
from videollamb_torch.models.vision.deformable import _ln
from videollamb_torch.models.vision.egovlp import (
    EgoVLPConfig,
    EgoVLPTower,
    _block,
    egovlp_embed_patches,
    init_egovlp_params,
)

NEG_INF = -1e9


@dataclass(frozen=True)
class RobertaTextConfig:
    """roberta-base defaults + the EgoNCE_MLM_ITM_Config.yml fusion settings
    (vocab 50265, hidden 768, 12 layers / heads, mlp_ratio 4,
    num_fuse_block 6, input_image_embed_size 768)."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: int = 4
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    num_fuse_block: int = 6
    dim_img: int = 768  # video hidden size feeding the cross-attention's k / v
    projection_dim: int = 4096  # FrozenInTime 'minimal' projection

    @property
    def intermediate_size(self) -> int:
        return self.hidden_size * self.mlp_ratio

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class RobertaAttention(nn.Module):
    """q from one stream, k / v from another (of width ``d_kv``), an output
    dense; the self-attention also holds its LayerNorm."""

    def __init__(self, d: int, d_kv: int, eps: Optional[float] = None):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d_kv, d)
        self.value = nn.Linear(d_kv, d)
        self.output = nn.Linear(d, d)
        if eps is not None:
            self.LayerNorm = nn.LayerNorm(d, eps=eps)


class RobertaLayer(nn.Module):
    def __init__(self, cfg: RobertaTextConfig, fused: bool):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = RobertaAttention(d, d, eps)
        self.intermediate = nn.Linear(d, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, d)
        self.output_LayerNorm = nn.LayerNorm(d, eps=eps)
        if fused:
            self.crossattention_t2i = RobertaAttention(d, cfg.dim_img)
            self.alpha_t2i = nn.Parameter(torch.empty(()))


class RobertaEmbeddings(nn.Module):
    def __init__(self, cfg: RobertaTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.position_embeddings = nn.Parameter(torch.empty(cfg.max_position_embeddings, d))
        self.token_type_embeddings = nn.Parameter(torch.empty(cfg.type_vocab_size, d))
        self.LayerNorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class RobertaText(nn.Module):
    """Embeddings, the unfused layers, then ``num_fuse_block`` fusion layers
    (none with ``fusion=False``)."""

    def __init__(self, cfg: RobertaTextConfig, fusion: bool = True):
        super().__init__()
        n_fuse = cfg.num_fuse_block if fusion else 0
        self.embeddings = RobertaEmbeddings(cfg)
        self.layers = nn.ModuleList(RobertaLayer(cfg, False)
                                    for _ in range(cfg.num_hidden_layers - n_fuse))
        self.fuse_layers = nn.ModuleList(RobertaLayer(cfg, True) for _ in range(n_fuse))


class Projection(nn.Module):
    """FrozenInTime 'minimal' projection (model.py:104-114)."""

    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.fc0 = nn.Linear(d_in, d, bias=False)
        self.fc1 = nn.Linear(d, d)
        self.fc2 = nn.Linear(d, d)


class Pooler(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dense = nn.Linear(d, d)


class ITMHead(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc = nn.Linear(2 * d, 2)


class MLMTransform(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d, d)
        self.LayerNorm = nn.LayerNorm(d, eps=eps)


class MLMHead(nn.Module):
    def __init__(self, cfg: RobertaTextConfig):
        super().__init__()
        self.transform = MLMTransform(cfg.hidden_size, cfg.layer_norm_eps)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.bias = nn.Parameter(torch.empty(cfg.vocab_size))


class EgoVLPText(nn.Module):
    """FrozenInTime without its video tower: the text model, the projections,
    the fusion transforms, the poolers and the ITM / MLM heads."""

    def __init__(self, tcfg: RobertaTextConfig, vcfg: Optional[EgoVLPConfig] = None):
        super().__init__()
        d, pd = tcfg.hidden_size, tcfg.projection_dim
        self.text_model = RobertaText(tcfg)
        self.txt_proj = Projection(d, pd)
        self.vid_proj = Projection((vcfg or EgoVLPConfig()).hidden_size, pd)
        self.cross_modal_text_transform = nn.Linear(d, d)
        self.cross_modal_video_transform = nn.Linear(tcfg.dim_img, d)
        self.cross_modal_text_pooler = Pooler(d)
        self.cross_modal_video_pooler = Pooler(d)
        self.itm_head = ITMHead(d)
        self.mlm_head = MLMHead(tcfg)


def create_position_ids(input_ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """RoBERTa's padding-aware position ids: non-pad tokens count up from
    pad_id + 1; pad positions stay at pad_id."""
    mask = (input_ids != pad_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_id


def roberta_embed(emb: RobertaEmbeddings, cfg: RobertaTextConfig,
                  input_ids: torch.Tensor) -> torch.Tensor:
    pos_ids = create_position_ids(input_ids, cfg.pad_token_id)
    x = (emb.word_embeddings[input_ids.long()] + emb.position_embeddings[pos_ids]
         + emb.token_type_embeddings[0][None, None])
    return _ln(emb.LayerNorm, x, cfg.layer_norm_eps)


def _mha(q_in: torch.Tensor, kv_in: torch.Tensor, p: RobertaAttention, h: int, e: int,
         bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Multi-head attention, q from q_in, k / v from kv_in; ``bias`` is
    (b, 1, 1, n_kv) additive (0 valid, NEG_INF pad)."""
    b, nq, _ = q_in.shape
    nk = kv_in.shape[1]
    q = p.query(q_in).reshape(b, nq, h, e)
    k = p.key(kv_in).reshape(b, nk, h, e)
    v = p.value(kv_in).reshape(b, nk, h, e)
    s = torch.einsum("bihe,bjhe->bhij", q.float(), k.float()) * e ** -0.5
    if bias is not None:
        s = s + bias
    pr = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhij,bjhe->bihe", pr.float(), v.float()).to(q_in.dtype)
    return o.reshape(b, nq, h * e)


def _roberta_layer(lp: RobertaLayer, cfg: RobertaTextConfig, x: torch.Tensor,
                   bias: torch.Tensor, video: Optional[torch.Tensor] = None,
                   last_norm: bool = True) -> torch.Tensor:
    """One post-LN RoBERTa layer (roberta.py RobertaLayer.forward): the
    self-attention dense (no LayerNorm inside SelfOutput: the vendored variant
    defers it), the alpha_t2i-gated cross-attention over ``video`` in a fusion
    layer, LN(+residual), FFN, LN(+residual) if ``last_norm``."""
    h, e = cfg.num_attention_heads, cfg.head_dim
    attn_out = lp.attention.output(_mha(x, x, lp.attention, h, e, bias))
    if video is not None:
        # The video tokens are all valid: model.py passes no encoder mask.
        cross = lp.crossattention_t2i
        cross_out = cross.output(_mha(attn_out, video, cross, h, e, None))
        attn_out = lp.alpha_t2i.float().to(x.dtype) * cross_out + attn_out
    x = _ln(lp.attention.LayerNorm, attn_out + x, cfg.layer_norm_eps)
    out = lp.output(F.gelu(lp.intermediate(x))) + x
    return _ln(lp.output_LayerNorm, out, cfg.layer_norm_eps) if last_norm else out


def _pad_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) mask -> (B, L) additive f32 bias, 0 valid and NEG_INF pad."""
    zero = torch.zeros((), dtype=torch.float32, device=attention_mask.device)
    return torch.where(attention_mask.bool(), zero, NEG_INF)


def roberta_encode(text_model: RobertaText, cfg: RobertaTextConfig,
                   input_ids: torch.Tensor, attention_mask: torch.Tensor,
                   video: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, L) ids -> (B, L, D) final hidden states.

    With ``video`` (B, N_v, dim_img) the fusion layers run their
    alpha_t2i-gated cross-attention over it (model.py:251-270); without it
    the fusion layers run as plain layers (compute_text's path,
    model.py:491-505)."""
    x = roberta_embed(text_model.embeddings, cfg, input_ids)
    bias = _pad_bias(attention_mask)[:, None, None, :]
    for lp in text_model.layers:
        x = _roberta_layer(lp, cfg, x, bias)
    for lp in text_model.fuse_layers:
        x = _roberta_layer(lp, cfg, x, bias, video=video)
    return x


def apply_projection(p: Projection, x: torch.Tensor) -> torch.Tensor:
    """Linear (no bias) -> ReLU -> Linear -> ReLU -> Linear."""
    return p.fc2(F.relu(p.fc1(F.relu(p.fc0(x)))))


def compute_text(model: EgoVLPText, cfg: RobertaTextConfig, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor, tokens: bool = False) -> torch.Tensor:
    """roberta -> CLS (or every token) -> txt_proj (model.py:491-522): the
    dual-encoder text embedding for EgoNCE retrieval."""
    hid = roberta_encode(model.text_model, cfg, input_ids, attention_mask)
    return apply_projection(model.txt_proj, hid if tokens else hid[:, 0])


def compute_video_embed(model: EgoVLPText, video_cls: torch.Tensor) -> torch.Tensor:
    """vid_proj over the space-time transformer's CLS feature (model.py:524-530;
    the tower itself is ``egovlp.egovlp_encode``)."""
    return apply_projection(model.vid_proj, video_cls)


def sim_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarity matrix (model.py:576-584)."""
    a = a / a.norm(dim=1, keepdim=True).clamp(min=eps)
    b = b / b.norm(dim=1, keepdim=True).clamp(min=eps)
    return a @ b.T


def pooler(p: Pooler, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(p.dense(x))


def itm_score(p: ITMHead, cls_feats: torch.Tensor) -> torch.Tensor:
    return p.fc(cls_feats)


def mlm_score(p: MLMHead, cfg: RobertaTextConfig, x: torch.Tensor) -> torch.Tensor:
    """BertPredictionHeadTransform (dense + gelu + LN), then the vocabulary
    decoder and its bias (heads.py MLMHead), f32 logits."""
    x = _ln(p.transform.LayerNorm, F.gelu(p.transform.dense(x)), cfg.layer_norm_eps)
    return (x.float() @ p.decoder.weight.float().T) + p.bias.float()


def apply_transform_to_hidden(model: EgoVLPText, tcfg: RobertaTextConfig,
                              x_txt: torch.Tensor) -> torch.Tensor:
    """The MLM path projects every text token through
    cross_modal_text_transform before scoring (model.py:360-366)."""
    del tcfg
    return model.cross_modal_text_transform(x_txt)


def fusion_forward(model: EgoVLPText, video: EgoVLPTower, vcfg: EgoVLPConfig,
                   tcfg: RobertaTextConfig, pixels: torch.Tensor, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor, mode: str = "itm") -> torch.Tensor:
    """The FIBER dual-stream fusion (model.py ITM :205-331, MLM :333-366).

    Both stacks run their unfused prefix apart; then in each of the last
    num_fuse_block layers the video block cross-attends the current text
    state (alpha_i2t gate) while the text layer cross-attends the previous
    video state (alpha_t2i gate: the reference overwrites the video tensor
    only after the text layer ran). ``video`` is a tower built with
    ``i2t_blocks=num_fuse_block``.

    mode 'itm' -> (B, 2) matched / unmatched logits from the concatenated
    pooled CLS features; 'mlm' -> (B, L, vocab) logits at every position."""
    f = pixels.shape[1]
    n_fuse = tcfg.num_fuse_block
    x_vid = egovlp_embed_patches(video, pixels.to(video.cls_token.dtype), vcfg)
    x_txt = roberta_embed(model.text_model.embeddings, tcfg, input_ids)
    y_bias = _pad_bias(attention_mask)
    bias = y_bias[:, None, None, :]
    blocks = list(video.blocks)
    for vlp in blocks[:len(blocks) - n_fuse]:
        x_vid = _block(vlp, x_vid, vcfg, f)
    for tlp in model.text_model.layers:
        x_txt = _roberta_layer(tlp, tcfg, x_txt, bias)
    for vlp, tlp in zip(blocks[len(blocks) - n_fuse:], model.text_model.fuse_layers):
        x_vid, x_txt = (_block(vlp, x_vid, vcfg, f, y=x_txt, y_bias=y_bias),
                        _roberta_layer(tlp, tcfg, x_txt, bias, video=x_vid))
    if mode == "mlm":
        return mlm_score(model.mlm_head, tcfg, apply_transform_to_hidden(model, tcfg, x_txt))
    vid_cls = _ln(video.norm, x_vid, vcfg.layer_norm_eps)[:, 0]
    txt_c = model.cross_modal_text_transform(x_txt[:, 0])
    vid_c = model.cross_modal_video_transform(vid_cls)
    cls_feats = torch.cat([pooler(model.cross_modal_text_pooler, txt_c),
                           pooler(model.cross_modal_video_pooler, vid_c)], dim=-1)
    return itm_score(model.itm_head, cls_feats)


# ---------------------------------------------------------------------------
# Initialisation and reference weight conversion
# ---------------------------------------------------------------------------

def _init_(module: nn.Module, g: torch.Generator) -> None:
    """JAX's draws in law: N(0, 0.02) matrices and tables, zero biases, the
    token-type table and the gates; unit LayerNorms."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if "LayerNorm" in name:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf in ("bias", "alpha_t2i", "token_type_embeddings"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=g)


def init_roberta_params(cfg: RobertaTextConfig, *, seed: int = 0, dtype=torch.float32,
                        device="cpu", fusion: bool = True) -> RobertaText:
    """Seeded text model; the fusion layers' gates start at zero, so it
    computes the unfused stack until they train."""
    model = empty_module(lambda: RobertaText(cfg, fusion), device, dtype)
    _init_(model, generator(device, seed))
    return model


def init_egovlp_text_params(tcfg: RobertaTextConfig, vcfg: Optional[EgoVLPConfig] = None, *,
                            seed: int = 0, dtype=torch.float32, device="cpu") -> EgoVLPText:
    """The whole FrozenInTime text side, seeded (the video tower is
    :func:`init_fusion_video_params`)."""
    model = empty_module(lambda: EgoVLPText(tcfg, vcfg), device, dtype)
    _init_(model, generator(device, seed))
    return model


def init_fusion_video_params(vcfg: EgoVLPConfig, tcfg: RobertaTextConfig, *, seed: int = 0,
                             dtype=torch.float32, device="cpu") -> EgoVLPTower:
    """The video tower for :func:`fusion_forward`: its last num_fuse_block
    blocks carry the image-to-text cross-attention, gated at zero
    (video_transformer.py:108-115)."""
    return init_egovlp_params(vcfg, seed=seed, dtype=dtype, device=device,
                              i2t_blocks=tcfg.num_fuse_block, text_hidden=tcfg.hidden_size)


def convert_roberta_state_dict(sd: Mapping[str, Any], cfg: RobertaTextConfig,
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """An HF ``RobertaModel`` state dict -> the state of :class:`RobertaText`
    (EgoVLP checkpoints prefix the same names with 'text_model.'). A plain
    HF checkpoint has no fusion weights: they start at zero with a zero gate."""
    def t(name):
        v = sd[prefix + name]
        return v.detach().float().cpu() if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v, np.float32))

    out: Dict[str, torch.Tensor] = {}

    def copy(dst, src):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = t(f"{src}.{leaf}")

    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out[f"embeddings.{name}"] = t(f"embeddings.{name}.weight")
    copy("embeddings.LayerNorm", "embeddings.LayerNorm")
    n_plain = cfg.num_hidden_layers - cfg.num_fuse_block
    d = cfg.hidden_size
    for i in range(cfg.num_hidden_layers):
        src = f"encoder.layer.{i}."
        dst = f"layers.{i}." if i < n_plain else f"fuse_layers.{i - n_plain}."
        for a, b in (("attention.query", "attention.self.query"),
                     ("attention.key", "attention.self.key"),
                     ("attention.value", "attention.self.value"),
                     ("attention.output", "attention.output.dense"),
                     ("attention.LayerNorm", "attention.output.LayerNorm"),
                     ("intermediate", "intermediate.dense"), ("output", "output.dense"),
                     ("output_LayerNorm", "output.LayerNorm")):
            copy(dst + a, src + b)
        if i < n_plain:
            continue
        cross = dst + "crossattention_t2i."
        if prefix + src + "crossattention_t2i.self.query.weight" in sd:
            for a, b in (("query", "self.query"), ("key", "self.key"), ("value", "self.value"),
                         ("output", "output.dense")):
                copy(cross + a, src + "crossattention_t2i." + b)
            out[dst + "alpha_t2i"] = t(src + "alpha_t2i").reshape(())
        else:
            for a, d_in in (("query", d), ("key", cfg.dim_img), ("value", cfg.dim_img),
                            ("output", d)):
                out[f"{cross}{a}.weight"] = torch.zeros(d, d_in)
                out[f"{cross}{a}.bias"] = torch.zeros(d)
            out[dst + "alpha_t2i"] = torch.zeros(())
    return out


# ---------------------------------------------------------------------------
# Retrieval metrics (metric.py): numpy, eval side
# ---------------------------------------------------------------------------

def _cols2metrics(cols: np.ndarray, num_queries: int) -> Dict[str, float]:
    metrics = {}
    for k in (1, 5, 10, 50):
        metrics[f"R{k}"] = 100 * float(np.sum(cols < k)) / num_queries
    metrics["MedR"] = float(np.median(cols)) + 1
    metrics["MeanR"] = float(np.mean(cols)) + 1
    metrics["geometric_mean_R1-R5-R10"] = float(
        np.exp(np.mean(np.log([max(metrics["R1"], 1e-12),
                               max(metrics["R5"], 1e-12),
                               max(metrics["R10"], 1e-12)]))))
    return metrics


def t2v_metrics(sims: np.ndarray) -> Dict[str, float]:
    """Text -> video retrieval over an (N_text, N_vid) similarity matrix
    with tie-averaged ranks (metric.py:26-131; queries_per_video texts map
    to each video in order)."""
    sims = np.asarray(sims)
    num_queries, num_vids = sims.shape
    dists = -sims
    sorted_dists = np.sort(dists, axis=1)
    qpv = num_queries // num_vids
    gt_dists = np.stack([dists[i, i // qpv] for i in range(num_queries)])[:, None]
    rows, cols = np.where((sorted_dists - gt_dists) == 0)
    if rows.size > num_queries:  # ties: average the tied rank positions
        cols = np.array([np.mean(cols[rows == i]) for i in range(num_queries)])
    return _cols2metrics(cols, num_queries)


def v2t_metrics(sims: np.ndarray) -> Dict[str, float]:
    """Video -> text retrieval: for each video the best-ranked of its
    ground-truth captions (metric.py:134-223, VSE-style)."""
    sims = np.asarray(sims).T  # (num_vids, num_caps)
    num_queries, num_caps = sims.shape
    dists = -sims
    qpv = num_caps // num_queries
    ranks = []
    for i in range(num_queries):
        order = np.argsort(dists[i])  # ascending distance
        gt_mask = np.zeros(num_caps, bool)
        gt_mask[i * qpv: (i + 1) * qpv] = True
        ranks.append(int(np.nonzero(gt_mask[order])[0][0]))
    return _cols2metrics(np.asarray(ranks), num_queries)


def egomcq_accuracy_metrics(preds: np.ndarray, labels: np.ndarray,
                            types: np.ndarray) -> Dict[str, float]:
    """EgoMCQ inter / intra-video accuracy (metric.py:225-243): argmax of each
    5-way similarity row against the label, grouped by question type."""
    preds, labels, types = map(np.asarray, (preds, labels, types))
    out = {}
    for type_i, group in zip(np.unique(types), ("Inter-video", "Intra-video")):
        sel = types == type_i
        correct = (np.argmax(preds[sel], axis=1) == labels[sel]).sum()
        out[group] = 100.0 * float(correct) / max(1, int(sel.sum()))
    return out
