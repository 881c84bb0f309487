"""Frame/image preprocessing: normalize + short-side scale + center crop.

Numpy counterpart of the vendored LanguageBind processors (reference:
languagebind/video/processing_video.py:32-76 video transform — scale/255 ->
Normalize(OpenAI mean/std) -> ShortSideScale(224) -> CenterCrop(224) [->
RandomHorizontalFlip(0.5) in training] — and
languagebind/image/processing_image.py:15-25 image transform — ToTensor ->
Resize(224, bicubic) -> CenterCrop(224) -> Normalize).

Resize kernels use OpenCV (bilinear for video ShortSideScale, bicubic for
images), matching torchvision's interpolation modes. A copy of
``videollamb_tpu/data/processing.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


def _short_side_scale(frames: np.ndarray, size: int, interpolation) -> np.ndarray:
    """(T, H, W, C) -> scaled so min(H, W) == size, aspect preserved."""
    import cv2

    t, h, w, c = frames.shape
    if h < w:
        new_h, new_w = size, int(math.floor(w / h * size))
    else:
        new_h, new_w = int(math.floor(h / w * size)), size
    if (new_h, new_w) == (h, w):
        return frames
    out = np.empty((t, new_h, new_w, c), dtype=frames.dtype)
    for i in range(t):
        out[i] = cv2.resize(frames[i], (new_w, new_h), interpolation=interpolation)
    return out


def _center_crop(frames: np.ndarray, size: int) -> np.ndarray:
    t, h, w, c = frames.shape
    top = (h - size) // 2
    left = (w - size) // 2
    return frames[:, top: top + size, left: left + size]


class VideoProcessor:
    """Video frames (T, H, W, C) uint8 -> (T, C, size, size) float32.

    Matches the reference video transform order: the normalize happens
    before the (linear) bilinear resize, which is mathematically equivalent
    to normalizing after — we normalize after resizing to halve the work.
    """

    def __init__(self, size: int = 224, mean=OPENAI_DATASET_MEAN,
                 std=OPENAI_DATASET_STD, training: bool = False,
                 hflip_prob: float = 0.5):
        self.size = size
        self.mean = np.asarray(mean, np.float32).reshape(1, 1, 1, 3)
        self.std = np.asarray(std, np.float32).reshape(1, 1, 1, 3)
        self.training = training
        self.hflip_prob = hflip_prob
        self.image_mean = mean

    def __call__(self, frames: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        import cv2

        frames = _short_side_scale(frames, self.size, cv2.INTER_LINEAR)
        frames = _center_crop(frames, self.size)
        x = frames.astype(np.float32) / 255.0
        x = (x - self.mean) / self.std
        if self.training and rng is not None and rng.random() < self.hflip_prob:
            x = x[:, :, ::-1]
        return np.ascontiguousarray(x.transpose(0, 3, 1, 2))  # (T, C, H, W)


class ImageProcessor:
    """PIL image / (H, W, C) uint8 -> (C, size, size) float32 (bicubic)."""

    def __init__(self, size: int = 224, mean=OPENAI_DATASET_MEAN,
                 std=OPENAI_DATASET_STD):
        self.size = size
        self.mean = np.asarray(mean, np.float32).reshape(1, 1, 3)
        self.std = np.asarray(std, np.float32).reshape(1, 1, 3)
        self.image_mean = mean
        self.crop_size = size
        self.shortest_edge = size

    def __call__(self, image) -> np.ndarray:
        import cv2

        arr = np.asarray(image)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        h, w = arr.shape[:2]
        # torchvision Resize(size) scales the short side to `size`.
        if h < w:
            new_h, new_w = self.size, int(math.floor(w / h * self.size))
        else:
            new_h, new_w = int(math.floor(h / w * self.size)), self.size
        arr = cv2.resize(arr, (new_w, new_h), interpolation=cv2.INTER_CUBIC)
        top = (new_h - self.size) // 2
        left = (new_w - self.size) // 2
        arr = arr[top: top + self.size, left: left + self.size]
        x = arr.astype(np.float32) / 255.0
        x = (x - self.mean) / self.std
        return np.ascontiguousarray(x.transpose(2, 0, 1))
