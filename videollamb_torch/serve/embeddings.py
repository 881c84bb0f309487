"""Multimodal /v1/embeddings over the LanguageBind binding model.

Port of ``videollamb_tpu/serve/embeddings.py``.

The reference ships LanguageBind's joint-embedding meta-model
(llava/model/multimodal_encoder/languagebind/__init__.py:57-88) but never
serves it; this module turns it into an OpenAI-compatible embeddings
endpoint — text, image, video, and audio all land in ONE shared space
(models/binding.py), so cross-modal retrieval works straight from the
API:

  POST /v1/embeddings
    {"input": "a dog runs"}                      one text
    {"input": ["a", "b", ...]}                   text batch (one device
                                                 call per power-of-2
                                                 bucket — CLIP text is a
                                                 fixed 77-position graph)
    {"input": [{"type": "text", "text": ...},    mixed batch: content
               {"type": "video_url",             parts reuse the chat
                "video_url": {"url": ...}},      endpoint's grammar
               {"type": "image_url", ...},       (openai_api._URL_PARTS,
               {"type": "audio_url", ...},       data: URIs included)
               {"type": "input_audio", ...}]}
    "encoding_format": "float" (default) | "base64" (f32 little-endian,
    the OpenAI wire format). -> standard embeddings list response.

Embeddings are L2-normalized and UNSCALED (use_temp=False — the
exp(logit_scale) factor is a contrastive-loss temperature, not part of
the representation). Text batches pad to power-of-2 row buckets, so
serving sees a handful of shapes. On the card every tower's spatial
attention runs kernel K1 and the video tower's temporal attention K2.
"""

from __future__ import annotations

import base64
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from videollamb_torch.serve.openai_api import (
    _URL_PARTS,
    BadRequest,
    _cleanup,
    _materialize_url,
)

# OpenAI part type -> binding modality name (models/binding.py keys).
_PART_TO_MODALITY = {"image_url": "image", "video_url": "video",
                     "audio_url": "audio"}


class EmbeddingService:
    """Binding model + tokenizer + media processors -> embeddings.

    ``processors`` maps modality names ("image"/"video"/"audio") to
    pixel processors whose output matches the binding tower's input
    (B=1 media run one item per device call; text batches bucket); a
    processor may return numpy arrays or tensors (``DeviceVideoProcessor``).
    Device work runs on ``device`` (default: where the model lies) under
    one lock, which the handler threads share.
    """

    def __init__(self, model, vision_cfgs, tokenizer, processors,
                 text_cfg=None, model_name: str = "languagebind",
                 num_frames: int = 8, device=None):
        from videollamb_torch.models.binding import TextConfig

        self.model = model
        self.vision_cfgs = dict(vision_cfgs)
        self.tokenizer = tokenizer
        self.processors = processors
        self.text_cfg = text_cfg or TextConfig()
        self.model_name = model_name
        self.num_frames = num_frames
        weight = model.text.projection.weight
        self.device = torch.device(device) if device is not None else weight.device
        self.dtype = weight.dtype
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _tokenize(self, texts: List[str]) -> Tuple[np.ndarray, int]:
        """Texts -> (B, 77) int ids (truncate + zero-pad) and the total
        real token count (usage accounting)."""
        t_max = self.text_cfg.max_position_embeddings
        rows, total = [], 0
        for s in texts:
            ids = list(self.tokenizer(s).input_ids)[:t_max]
            total += len(ids)
            rows.append(ids + [0] * (t_max - len(ids)))
        return np.asarray(rows, np.int64), total

    @torch.no_grad()
    def embed_texts(self, texts: List[str]) -> Tuple[np.ndarray, int]:
        """(N texts) -> ((N, D) f32, token count). Rows pad to the next
        power-of-2 bucket so N different batch sizes share shapes."""
        from videollamb_torch.models.binding import binding_encode_text

        ids, n_tokens = self._tokenize(texts)
        n = len(texts)
        bucket = 1
        while bucket < n:
            bucket *= 2
        if bucket > n:
            ids = np.pad(ids, ((0, bucket - n), (0, 0)))
        out = binding_encode_text(self.model, torch.from_numpy(ids).to(self.device),
                                  self.text_cfg)
        return out[:n].float().cpu().numpy(), n_tokens

    @torch.no_grad()
    def embed_medium(self, modality: str, path: str) -> np.ndarray:
        """One media file -> (D,) f32 embedding in the joint space."""
        from videollamb_torch.data.media import load_media_blocks
        from videollamb_torch.models.binding import binding_encode_modality

        if modality not in self.vision_cfgs:
            raise BadRequest(
                f"this embedding server has no {modality!r} tower "
                f"(available: {sorted(self.vision_cfgs)})")
        blocks = load_media_blocks(
            {modality.upper(): path}, {modality.upper():
                                       self.processors[modality]},
            num_frames=self.num_frames if modality == "video" else None,
            strict=True)
        pixels = torch.as_tensor(blocks[0][1]).to(self.device, self.dtype)[None]
        if pixels.ndim == 4:  # image processors emit (C, H, W)
            pixels = pixels[:, None]
        out = binding_encode_modality(self.model, modality, pixels,
                                      self.vision_cfgs[modality], use_temp=False)
        return out[0].float().cpu().numpy()

    # ------------------------------------------------------------------
    def _parse_items(self, body: Dict[str, Any], temp_paths: List[str]):
        """OpenAI input -> ordered [("text", str) | (modality, path)]."""
        raw = body.get("input")
        if raw is None:
            raise BadRequest("'input' is required")
        if isinstance(raw, str):
            raw = [raw]
        if not isinstance(raw, list) or not raw:
            raise BadRequest("'input' must be a non-empty string or list")
        items: List[Tuple[str, str]] = []
        for item in raw:
            if isinstance(item, str):
                items.append(("text", item))
                continue
            if not isinstance(item, dict):
                raise BadRequest("input items must be strings or content "
                                 "parts")
            ptype = item.get("type")
            if ptype == "text":
                items.append(("text", item.get("text", "")))
            elif ptype in _URL_PARTS:
                spec = item.get(_URL_PARTS[ptype][1])
                url = spec.get("url") if isinstance(spec, dict) else spec
                if not url:
                    raise BadRequest(f"part {ptype!r} is missing its url")
                modality = _PART_TO_MODALITY[ptype]
                items.append((modality, _materialize_url(
                    url, modality, temp_paths)))
            elif ptype == "input_audio":
                spec = item.get("input_audio") or {}
                if not spec.get("data"):
                    raise BadRequest("input_audio part is missing 'data'")
                fmt = spec.get("format", "wav")
                items.append(("audio", _materialize_url(
                    f"data:audio/{fmt};base64,{spec['data']}", "audio",
                    temp_paths)))
            else:
                raise BadRequest(f"unsupported input part type {ptype!r}")
        return items

    def openai_embeddings(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Full /v1/embeddings request -> response dict."""
        model = body.get("model") or self.model_name
        if model != self.model_name:
            raise BadRequest(f"model {model!r} not found (embeddings are "
                             f"served by {self.model_name!r})",
                             code="model_not_found", status=404)
        fmt = body.get("encoding_format", "float")
        if fmt not in ("float", "base64"):
            raise BadRequest("encoding_format must be 'float' or 'base64'")
        temp_paths: List[str] = []
        try:
            items = self._parse_items(body, temp_paths)
            out: List[Optional[np.ndarray]] = [None] * len(items)
            text_idx = [i for i, (kind, _) in enumerate(items)
                        if kind == "text"]
            n_tokens = 0
            with self._lock:
                if text_idx:
                    embs, n_tokens = self.embed_texts(
                        [items[i][1] for i in text_idx])
                    for j, i in enumerate(text_idx):
                        out[i] = embs[j]
                for i, (kind, val) in enumerate(items):
                    if kind != "text":
                        out[i] = self.embed_medium(kind, val)
        finally:
            _cleanup(temp_paths)
        data = []
        for i, emb in enumerate(out):
            if fmt == "base64":
                enc = base64.b64encode(
                    emb.astype("<f4").tobytes()).decode()
            else:
                enc = [float(v) for v in emb]
            data.append({"object": "embedding", "index": i,
                         "embedding": enc})
        return {
            "object": "list",
            "data": data,
            "model": self.model_name,
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        }
