"""Supervised dataset, collators and the modality-grouped sampler.

Port of ``videollamb_tpu/train/dataset.py`` (reference
LazySupervisedDataset / DataCollatorForSupervisedDataset,
llava/train/train.py:680-872, and the modality-grouped length sampler,
llava/train/llava_trainer.py:59-146), host-side numpy:

- a JSON list of conversations; a row's modality is its 'video', 'image'
  or 'audio' key, or none (text); images are 'square', 'pad' (through
  ``expand2square``) or 'anyres' (a patch stack and the image's size);
  audio is a WAV read into a log-mel "image" (``AudioProcessor``); a sample
  that fails to load retries with a random sample of the same modality
  (train.py:823-825);
- the collator pads to shape buckets (multiples of ``bucket``), so the
  step sees a handful of shapes; anyres stacks are padded to the widest
  and carry their grid specs (``models/anyres.anyres_spec``);
- the packed collator fits several conversations into each row, separated
  by segment ids; it refuses anyres stacks and batches that mix video and
  image rows, as the JAX package does;
- the sampler builds per-modality megabatches and shuffles them by seed,
  as the reference does.

Batches are ``models.assembly.MultimodalBatch`` of numpy arrays; the
trainer moves them to the device.
"""

from __future__ import annotations

import copy
import json
import os
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from videollamb_torch.constants import IGNORE_INDEX
from videollamb_torch.data.processing import ImageProcessor, VideoProcessor
from videollamb_torch.data.video_reader import load_video
from videollamb_torch.models.assembly import MultimodalBatch
from videollamb_torch.train.preprocess import preprocess, preprocess_multimodal


@dataclass
class DataConfig:
    data_path: str = ""
    image_folder: str = ""
    video_folder: str = ""
    audio_folder: str = ""
    num_frames: int = 8
    is_multimodal: bool = True
    mm_use_x_start_end: bool = False
    model_max_length: int = 2048
    image_aspect_ratio: str = "pad"
    # Anyres pinpoint resolutions ((w, h), ...) when image_aspect_ratio is
    # 'anyres' (reference train.py DataArguments.image_grid_pinpoints).
    image_grid_pinpoints: Optional[Sequence[Sequence[int]]] = None


class SupervisedDataset:
    """Lazy JSON conversation dataset (reference train.py:680-825)."""

    def __init__(self, data_path: str, tokenizer, cfg: DataConfig,
                 video_processor: Optional[VideoProcessor] = None,
                 image_processor: Optional[ImageProcessor] = None,
                 audio_processor=None, seed: int = 0):
        with open(data_path) as f:
            self.records: List[Dict[str, Any]] = json.load(f)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.video_processor = video_processor or VideoProcessor()
        self.image_processor = image_processor or ImageProcessor()
        self.audio_processor = audio_processor
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.records)

    def modality(self, i: int) -> str:
        rec = self.records[i]
        for key in ("video", "image", "audio"):
            if key in rec:
                return key
        return "language"

    def modality_lengths(self) -> List[int]:
        """Signed conversation lengths: positive for multimodal samples,
        negative for pure language (reference train.py:720-733)."""
        lengths = []
        for rec in self.records:
            cur = sum(len(c["value"].split()) for c in rec["conversations"])
            mm = "image" in rec or "video" in rec or "audio" in rec
            lengths.append(cur if mm else -cur)
        return lengths

    def _load_one(self, i: int) -> Dict[str, Any]:
        rec = self.records[i]
        sources = copy.deepcopy([rec["conversations"]])
        out: Dict[str, Any] = {}
        x = None
        if "video" in rec:
            path = os.path.join(self.cfg.video_folder, rec["video"])
            frames = load_video(path, num_frames=self.cfg.num_frames)
            out["video"] = self.video_processor(frames)  # (T, C, H, W)
            x = "VIDEO"
        elif "image" in rec:
            from PIL import Image

            from videollamb_torch.mm_utils import expand2square, process_anyres_image

            img = Image.open(os.path.join(self.cfg.image_folder, rec["image"])).convert("RGB")
            if self.cfg.image_aspect_ratio == "anyres":
                out["image"] = process_anyres_image(
                    img, self.image_processor, list(self.cfg.image_grid_pinpoints))  # (P, C, H, W)
                out["image_size"] = img.size  # (w, h) for the unpad merge
            else:
                if self.cfg.image_aspect_ratio == "pad":
                    bg = tuple(int(v * 255) for v in self.image_processor.image_mean)
                    img = expand2square(img, bg)
                out["image"] = self.image_processor(img)  # (C, H, W)
            x = "IMAGE"
        elif "audio" in rec:
            # A WAV as a log-mel fbank "image" for the tower stream (the
            # reference never wires its audio encoder to training).
            from videollamb_torch.data.audio_reader import load_audio

            if self.audio_processor is None:
                from videollamb_torch.models.vision.modalities import AudioProcessor

                self.audio_processor = AudioProcessor()
            waveform, sr = load_audio(os.path.join(self.cfg.audio_folder, rec["audio"]))
            out["image"] = self.audio_processor(waveform, origin_sr=sr)
            x = "AUDIO"
        if x is not None:
            sources = preprocess_multimodal(
                sources, is_multimodal=self.cfg.is_multimodal,
                mm_use_x_start_end=self.cfg.mm_use_x_start_end)
        data = preprocess(sources, self.tokenizer, x=x,
                          model_max_length=self.cfg.model_max_length)
        out["input_ids"] = data["input_ids"][0][: self.cfg.model_max_length]
        out["labels"] = data["labels"][0][: self.cfg.model_max_length]
        return out

    def __getitem__(self, i: int) -> Dict[str, Any]:
        try:
            return self._load_one(i)
        except Exception as e:  # a corrupt sample: retry a random one of its modality
            print(f"dataset error at {i}: {e}; resampling same modality")
            modality = self.modality(i)
            candidates = [j for j in range(len(self)) if self.modality(j) == modality and j != i]
            if not candidates:
                raise
            return self[self.rng.choice(candidates)]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Collator:
    """Pad samples into one MultimodalBatch of bucketed shapes (reference
    DataCollatorForSupervisedDataset, train.py:827-872). Anyres samples (4-D
    patch stacks with 'image_size') need the pinpoints and the tower's
    geometry for their grid specs."""

    pad_token_id: int = 0
    bucket: int = 128
    max_length: int = 2048
    image_grid_pinpoints: Optional[Sequence[Sequence[int]]] = None
    vision_image_size: int = 336
    patches_per_side: int = 24

    def __call__(self, samples: Sequence[Dict[str, Any]]) -> MultimodalBatch:
        b = len(samples)
        max_len = max(len(s["input_ids"]) for s in samples)
        t = min(_round_up(max_len, self.bucket), self.max_length)

        ids = np.full((b, t), self.pad_token_id, np.int32)
        labels = np.full((b, t), IGNORE_INDEX, np.int32)
        mask = np.zeros((b, t), np.int32)
        for i, s in enumerate(samples):
            n = min(len(s["input_ids"]), t)
            ids[i, :n] = s["input_ids"][:n]
            labels[i, :n] = s["labels"][:n]
            mask[i, :n] = 1

        videos = images = specs = None
        if any("video" in s for s in samples):
            tv = max(s["video"].shape[0] for s in samples if "video" in s)
            shape = next(s["video"].shape for s in samples if "video" in s)
            videos = np.zeros((b, tv) + shape[1:], np.float32)
            for i, s in enumerate(samples):
                if "video" in s:
                    videos[i, : s["video"].shape[0]] = s["video"]
        elif any("image" in s for s in samples):
            shape = next(s["image"].shape for s in samples if "image" in s)
            if len(shape) == 4:  # anyres (P, C, H, W) stacks
                from videollamb_torch.models.anyres import anyres_spec

                p_max = max(s["image"].shape[0] for s in samples if "image" in s)
                images = np.zeros((b, p_max) + shape[1:], np.float32)
                specs = np.zeros((b, 4), np.int32)
                for i, s in enumerate(samples):
                    if "image" in s:
                        images[i, : s["image"].shape[0]] = s["image"]
                        specs[i] = anyres_spec(s["image_size"], self.image_grid_pinpoints,
                                               self.vision_image_size, self.patches_per_side)
            else:
                images = np.zeros((b,) + shape, np.float32)
                for i, s in enumerate(samples):
                    if "image" in s:
                        images[i] = s["image"]
        return MultimodalBatch(input_ids=ids, attention_mask=mask, labels=labels,
                               videos=videos, images=images, image_specs=specs)


@dataclass
class PackedCollator:
    """Pack several conversations into each row (packed-sequence training).

    Rows keep one shape while several samples share it, separated by segment
    ids: attention stays within a segment and RoPE positions restart per
    segment (``models/splice.splice_multimodal_packed``), so each sample
    trains as in its own row. The budget is counted after the splice: each
    media sentinel expands to ``block_tokens`` tokens for a video and
    ``block_tokens_image`` for an image or audio row (audio fbanks travel as
    'image'; ``models.assembly.measure_block_tokens`` of each). Batches must
    be of one modality, which the modality-grouped sampler guarantees;
    anyres stacks cannot be packed (their splice geometry is per row) and
    raise. First-fit decreasing under
    (max_length, k_max blocks); the row count pads to a multiple of
    ``rows_bucket``.

    With ``fixed_rows`` every batch is exactly ``fixed_rows`` x
    ``max_length`` x ``k_max`` slots (and ``fixed_frames`` frames when
    given); samples of the rows past ``fixed_rows`` carry over into the next
    call. A sample longer than the budget gets its own row and is truncated
    by the splice (reference llava_arch.py:610-613)."""

    pad_token_id: int = 0
    bucket: int = 128
    max_length: int = 2048
    block_tokens: int = 0
    block_tokens_image: Optional[int] = None
    k_max: int = 4
    rows_bucket: int = 8
    fixed_rows: Optional[int] = None
    fixed_frames: Optional[int] = None
    _carry: List[Dict[str, Any]] = field(default_factory=list)

    def _cost(self, s: Dict[str, Any]) -> Tuple[int, int]:
        ids = np.asarray(s["input_ids"])
        nb = int((ids < 0).sum())
        media = int("video" in s or "image" in s)
        if nb != media:
            # The k-th sentinel of a row binds media block k: a sample with more
            # sentinels than media would bind the NEXT sample's media.
            raise ValueError(
                f"sample has {nb} media sentinel(s) but {media} media "
                "array(s); packing binds sentinels to blocks positionally")
        if "video" in s or self.block_tokens_image is None:
            block = self.block_tokens
        else:
            block = self.block_tokens_image
        return len(ids) - nb + nb * max(block, 1), nb

    def pack(self, samples: Sequence[Dict[str, Any]]) -> List[List[int]]:
        """First-fit decreasing -> rows of sample indices (ascending, so the
        segment order is the dataset order)."""
        meta = [self._cost(s) for s in samples]
        order = sorted(range(len(samples)), key=lambda i: -meta[i][0])
        bins: List[Dict[str, Any]] = []
        for i in order:
            c, nb = meta[i]
            for b in bins:
                if b["cost"] + c <= self.max_length and b["nb"] + nb <= self.k_max:
                    b["items"].append(i)
                    b["cost"] += c
                    b["nb"] += nb
                    break
            else:
                bins.append({"items": [i], "cost": c, "nb": nb})
        return [sorted(b["items"]) for b in bins]

    def __call__(self, samples: Sequence[Dict[str, Any]]) -> MultimodalBatch:
        if any("image" in s and np.asarray(s["image"]).ndim == 4 for s in samples):
            raise ValueError("anyres image stacks cannot be packed")
        if self.fixed_rows is not None and self._carry:
            # The carry joins only a batch of its modality (the grouped
            # sampler alternates video and image megabatches); else it waits.
            cv = any("video" in s for s in self._carry)
            ci = any("image" in s for s in self._carry)
            nv = any("video" in s for s in samples)
            ni = any("image" in s for s in samples)
            if not ((cv and ni) or (ci and nv)):
                carried, self._carry = self._carry, []
                samples = carried + list(samples)
        has_video = any("video" in s for s in samples)
        has_image = any("image" in s for s in samples)
        if has_video and has_image:
            raise ValueError("packed batches must be modality-homogeneous")

        rows = self.pack(samples)
        if self.fixed_rows is not None:
            if len(rows) > self.fixed_rows:
                self._carry = [samples[i] for row in rows[self.fixed_rows:] for i in row]
                rows = rows[: self.fixed_rows]
            b = self.fixed_rows
            t = self.max_length
            k_max = self.k_max
        else:
            b = _round_up(len(rows), self.rows_bucket)
            t_raw = max(sum(len(samples[i]["input_ids"]) for i in row) for row in rows)
            t = min(_round_up(t_raw, self.bucket), self.max_length)
            k_max = max((sum(1 for i in row if "video" in samples[i] or "image" in samples[i])
                         for row in rows), default=0)

        ids = np.full((b, t), self.pad_token_id, np.int32)
        labels = np.full((b, t), IGNORE_INDEX, np.int32)
        mask = np.zeros((b, t), np.int32)
        seg = np.zeros((b, t), np.int32)
        videos = images = block_mask = None
        if has_video:
            tv = max(s["video"].shape[0] for s in samples if "video" in s)
            if self.fixed_frames is not None:
                tv = max(tv, self.fixed_frames)
            shape = next(s["video"].shape for s in samples if "video" in s)
            videos = np.zeros((b, max(k_max, 1), tv) + shape[1:], np.float32)
            block_mask = np.zeros((b, max(k_max, 1)), bool)
        elif has_image:
            shape = next(s["image"].shape for s in samples if "image" in s)
            images = np.zeros((b, max(k_max, 1)) + shape, np.float32)
            block_mask = np.zeros((b, max(k_max, 1)), bool)

        for r, row in enumerate(rows):
            cur = blk = 0
            for si, i in enumerate(row):
                s = samples[i]
                n = min(len(s["input_ids"]), t - cur)
                if n <= 0:
                    break
                ids[r, cur:cur + n] = np.asarray(s["input_ids"])[:n]
                labels[r, cur:cur + n] = np.asarray(s["labels"])[:n]
                # A segment's first label is IGNORE: the shifted loss would
                # otherwise train the previous segment's last token on it.
                labels[r, cur] = IGNORE_INDEX
                mask[r, cur:cur + n] = 1
                seg[r, cur:cur + n] = si + 1
                cur += n
                if videos is not None and "video" in s:
                    videos[r, blk, : s["video"].shape[0]] = s["video"]
                    block_mask[r, blk] = True
                    blk += 1
                elif images is not None and "image" in s:
                    images[r, blk] = s["image"]
                    block_mask[r, blk] = True
                    blk += 1

        return MultimodalBatch(
            input_ids=ids, attention_mask=mask, labels=labels, videos=videos, images=images,
            segment_ids=seg, video_block_mask=block_mask if videos is not None else None,
            image_block_mask=block_mask if images is not None else None)


def modality_grouped_indices(lengths: Sequence[int], batch_size: int, world_size: int,
                             seed: int = 0) -> List[int]:
    """Modality-grouped megabatch order, shuffled by ``seed`` (reference
    llava_trainer.py:59-100 get_modality_length_grouped_indices)."""
    rng = np.random.default_rng(seed)
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l <= 0]

    def shuffle_chunks(items):
        idx = [i for i, _ in items]
        perm = rng.permutation(len(idx))
        shuffled = [idx[p] for p in perm]
        mega = world_size * batch_size
        return [shuffled[k: k + mega] for k in range(0, len(shuffled), mega)]

    mm_mega = shuffle_chunks(mm) if mm else []
    lang_mega = shuffle_chunks(lang) if lang else []
    # Every full megabatch, then each modality's last one; shuffle their order.
    full = list(mm_mega[:-1]) if len(mm_mega) > 1 else []
    full += list(lang_mega[:-1]) if len(lang_mega) > 1 else []
    if mm_mega:
        full.append(mm_mega[-1])
    if lang_mega:
        full.append(lang_mega[-1])
    out: List[int] = []
    for oi in rng.permutation(len(full)):
        out.extend(full[oi])
    return out
