"""Shared media-block assembly for mixed-modality requests.

A copy of ``videollamb_tpu/data/media.py``: one implementation of the
video / image / audio load + preprocess dispatch, used here by the
embeddings service (``serve/embeddings.py``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# Canonical block order for a request naming several media.
MODALITY_ORDER = ("VIDEO", "IMAGE", "AUDIO")


def _audio_processor(processors: Dict[str, Any]):
    proc = processors.get("AUDIO")
    if proc is None:
        from videollamb_torch.models.vision.modalities import AudioProcessor

        proc = AudioProcessor()
    return proc


def load_media_blocks(
    paths: Dict[str, Optional[str]],
    processors: Dict[str, Any],
    *,
    num_frames: Optional[int] = None,
    fps: float = 1.0,
    max_frames: int = 512,
    strict: bool = True,
) -> Optional[List[Tuple[str, Any]]]:
    """Load every medium named in ``paths`` ({"VIDEO"|"IMAGE"|"AUDIO":
    file path or None}) into ordered (modality, processed-pixels) blocks.

    ``strict=True`` raises on a missing/unreadable file (serving: reject
    the request loudly); ``strict=False`` logs and returns None so eval
    drivers can skip the sample — BOTH media loaders previously disagreed
    here (a missing image crashed the whole eval run).
    Returns [] when no medium is named."""
    blocks: List[Tuple[str, Any]] = []
    for modality in MODALITY_ORDER:
        path = paths.get(modality)
        if not path:
            continue
        try:
            if modality == "VIDEO":
                from videollamb_torch.data.video_reader import load_video

                if num_frames is not None:
                    raw = load_video(path, num_frames=num_frames)
                else:
                    raw = load_video(path, fps=fps, max_frames=max_frames)
                blocks.append(("VIDEO", processors["VIDEO"](raw)))
            elif modality == "IMAGE":
                import cv2

                img = cv2.imread(path)
                if img is None:
                    raise FileNotFoundError(path)
                blocks.append(
                    ("IMAGE", processors["IMAGE"](
                        cv2.cvtColor(img, cv2.COLOR_BGR2RGB))))
            else:  # AUDIO: WAV -> log-mel fbank image (audio TowerSpec)
                from videollamb_torch.data.audio_reader import load_audio

                waveform, sr = load_audio(path)
                blocks.append(
                    ("AUDIO", _audio_processor(processors)(
                        waveform, origin_sr=sr)))
        except Exception:
            if strict:
                raise
            logger.warning("skipping sample: failed to load %s %r",
                           modality, path, exc_info=True)
            return None
    return blocks
