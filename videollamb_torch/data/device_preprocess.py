"""On-device video preprocessing: resize + crop + normalize on the card.

Port of ``videollamb_tpu/data/device_preprocess.py``. The host processor
(``data/processing.VideoProcessor``, reference
languagebind/video/processing_video.py:49-60) resizes each frame with cv2;
on a host with few cores that becomes the ingest bottleneck long before the
tower does. Here the affine part runs where the tower runs:

    uint8 (T, H, W, 3) host frames
      -> one small host-to-device copy (uint8: 4x smaller than f32)
      -> bilinear short-side scale to ``size`` (``F.interpolate`` with
         ``align_corners=False, antialias=False``: the half-pixel 2-tap
         sampling of ``jax.image.resize(..., antialias=False)`` and of
         cv2.INTER_LINEAR)
      -> centre crop
      -> /255, OpenAI mean/std normalise, (T, 3, size, size)

Plain PyTorch on the caller's device: there is no Pallas kernel behind the
JAX function. cv2's fixed-point bilinear differs from the float bilinear by
less than 1/255 per pixel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from videollamb_torch.data.processing import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


def device_video_preprocess(
    frames,  # (T, H, W, 3) uint8, numpy or tensor
    size: int = 224,
    mean: Sequence[float] = OPENAI_DATASET_MEAN,
    std: Sequence[float] = OPENAI_DATASET_STD,
    out_dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """(T, H, W, 3) uint8 -> (T, 3, size, size) normalised frames on
    ``device`` (default: where ``frames`` already are)."""
    x = torch.as_tensor(frames)
    if device is not None:
        x = x.to(device)
    t, h, w, c = x.shape
    x = x.permute(0, 3, 1, 2).float()
    if h < w:
        new_h, new_w = size, int(w / h * size)
    else:
        new_h, new_w = int(h / w * size), size
    if (new_h, new_w) != (h, w):
        x = F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False,
                          antialias=False)
    top = (new_h - size) // 2
    left = (new_w - size) // 2
    x = x[:, :, top: top + size, left: left + size]
    m = torch.tensor(mean, dtype=torch.float32, device=x.device).view(1, c, 1, 1) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device).view(1, c, 1, 1) * 255.0
    return ((x - m) / s).to(out_dtype).contiguous()


class DeviceVideoProcessor:
    """``VideoProcessor``'s call contract (uint8 frames in, (T, 3, size,
    size) out) returning a tensor on ``device``. The training-time
    horizontal flip stays with the host processor: this is the inference
    path's processor."""

    def __init__(self, size: int = 224, mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD,
                 out_dtype: torch.dtype = torch.float32, device="cuda"):
        self.size = size
        self.mean = tuple(float(v) for v in mean)
        self.std = tuple(float(v) for v in std)
        self.out_dtype = out_dtype
        self.device = torch.device(device)
        self.image_mean = mean

    def __call__(self, frames) -> torch.Tensor:
        x = torch.as_tensor(frames)
        if x.ndim == 3:
            x = x[None]
        return device_video_preprocess(x, size=self.size, mean=self.mean, std=self.std,
                                       out_dtype=self.out_dtype, device=self.device)
