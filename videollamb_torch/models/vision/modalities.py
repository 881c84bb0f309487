"""LanguageBind audio / depth / thermal modality towers + processors.

A copy of ``videollamb_tpu/models/vision/modalities.py`` (numpy only).

Reference: llava/model/multimodal_encoder/languagebind/{audio,depth,thermal}
— each modality is the SAME OpenCLIP ViT encoder with a modality-specific
input transform:

- audio  (processing_audio.py:31-129): waveform -> kaldi-style log-mel
  fbank (25 ms frames / 10 ms shift, hanning), three fixed chunks
  (front/middle/back) stacked as channels, padded/cropped to
  ``target_length`` and transposed to a (3, num_mel_bins, target_length)
  "image"; the tower resizes its position grid to the rectangular
  mel shape (modeling_audio.py:808-854 resize_pos);
- depth  (processing_depth.py:21-57): depth/1000 m, clipped at min_depth,
  normalized by max depth, replicated to 3 channels, resize+crop 224,
  OpenAI CLIP mean/std;
- thermal (processing_thermal.py:17-24): plain image transform.

All three towers reuse the one parameterized CLIP implementation
(``models/vision/clip_vit.py``) with ``add_time_attn=False``; audio uses the
rectangular ``image_size_hw`` grid. Note: the reference's own audio path
cannot run as shipped (``import torchaudio`` is commented out at
processing_audio.py:4 while the code calls it); the fbank here is a
self-contained numpy implementation of the same recipe.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from videollamb_torch.config import VisionConfig

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)

# LanguageBind_Audio checkpoint geometry (config.json: vision ViT-L/14 with
# the position grid resized to the mel spectrogram).
AUDIO_NUM_MEL_BINS = 112
AUDIO_TARGET_LENGTH = 1036
# CLAP/AudioMAE normalization constants (processing_audio.py:38-39).
AUDIO_MEAN = -4.2677393
AUDIO_STD = 4.5689974


def audio_tower_config(**overrides) -> VisionConfig:
    base = dict(
        add_time_attn=False,
        image_size_hw=(AUDIO_NUM_MEL_BINS, AUDIO_TARGET_LENGTH),
        patch_size=14,
    )
    base.update(overrides)
    return VisionConfig(**base)


def depth_tower_config(**overrides) -> VisionConfig:
    base = dict(add_time_attn=False)
    base.update(overrides)
    return VisionConfig(**base)


thermal_tower_config = depth_tower_config
image_modality_config = depth_tower_config


# ---------------------------------------------------------------------------
# Audio: numpy kaldi-style log-mel fbank
# ---------------------------------------------------------------------------


def _mel_scale(freq: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log(1.0 + freq / 700.0)


def _mel_filterbank(num_bins: int, n_fft: int, sample_rate: int) -> np.ndarray:
    """HTK-compatible triangular mel filters over the FFT bins."""
    low_mel = _mel_scale(np.asarray(20.0))
    high_mel = _mel_scale(np.asarray(sample_rate / 2.0))
    mel_points = np.linspace(low_mel, high_mel, num_bins + 2)
    fft_freqs = np.arange(n_fft // 2 + 1) * sample_rate / n_fft
    fft_mels = _mel_scale(fft_freqs)
    fbank = np.zeros((num_bins, n_fft // 2 + 1), np.float32)
    for i in range(num_bins):
        left, center, right = mel_points[i], mel_points[i + 1], mel_points[i + 2]
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        fbank[i] = np.maximum(0.0, np.minimum(up, down))
    return fbank


def log_mel_fbank(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    num_mel_bins: int = AUDIO_NUM_MEL_BINS,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
) -> np.ndarray:
    """(T_samples,) -> (T_frames, num_mel_bins) log-mel energies
    (kaldi fbank recipe: snip edges, hanning window, htk_compat —
    reference processing_audio.py:115-129)."""
    x = np.asarray(waveform, np.float32)
    x = x - x.mean()
    win = int(sample_rate * frame_length_ms / 1000)
    hop = int(sample_rate * frame_shift_ms / 1000)
    n_fft = 1 << (win - 1).bit_length()
    n_frames = max(0, 1 + (len(x) - win) // hop)
    if n_frames == 0:
        return np.zeros((0, num_mel_bins), np.float32)
    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * np.hanning(win)[None, :].astype(np.float32)
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2
    mel = spec @ _mel_filterbank(num_mel_bins, n_fft, sample_rate).T
    return np.log(np.maximum(mel, 1e-10)).astype(np.float32)


class AudioProcessor:
    """waveform -> (3, num_mel_bins, target_length) normalized mel image
    (reference AudioTransform, processing_audio.py:31-113)."""

    def __init__(self, sample_rate: int = 16000,
                 num_mel_bins: int = AUDIO_NUM_MEL_BINS,
                 target_length: int = AUDIO_TARGET_LENGTH,
                 mean: float = AUDIO_MEAN, std: float = AUDIO_STD):
        self.sample_rate = sample_rate
        self.num_mel_bins = num_mel_bins
        self.target_length = target_length
        self.mean = mean
        self.std = std

    def __call__(self, waveform: np.ndarray, origin_sr: Optional[int] = None) -> np.ndarray:
        x = np.asarray(waveform, np.float32).reshape(-1)
        if origin_sr and origin_sr != self.sample_rate:
            # Linear resample (the reference uses torchaudio's polyphase;
            # adequate for feature extraction).
            n_out = int(round(len(x) * self.sample_rate / origin_sr))
            x = np.interp(
                np.linspace(0, len(x) - 1, n_out), np.arange(len(x)), x
            ).astype(np.float32)

        max_len = self.target_length * self.sample_rate // 100
        if x.shape[-1] > max_len:
            mel = log_mel_fbank(x, self.sample_rate, self.num_mel_bins)
            chunk = self.target_length
            total = mel.shape[0]
            ranges = np.array_split(np.arange(0, max(total - chunk + 1, 1)), 3)
            starts = [r[0] if len(r) else 0 for r in ranges]
            fusion = np.stack([mel[s: s + chunk] for s in starts], axis=0)
        else:
            if x.shape[-1] < max_len:  # repeat + zero-pad (short clips)
                n_rep = max(1, int(max_len / max(len(x), 1)))
                x = np.tile(x, n_rep)
                x = np.pad(x, (0, max(0, max_len - len(x))))
            mel = log_mel_fbank(x, self.sample_rate, self.num_mel_bins)
            fusion = np.stack([mel, mel, mel], axis=0)

        p = self.target_length - fusion.shape[1]
        if p > 0:
            fusion = np.pad(fusion, ((0, 0), (0, p), (0, 0)))
        elif p < 0:
            fusion = fusion[:, : self.target_length]
        fusion = fusion.transpose(0, 2, 1)  # (3, mel_bins, target_length)
        return ((fusion - self.mean) / self.std).astype(np.float32)


# ---------------------------------------------------------------------------
# Depth / thermal
# ---------------------------------------------------------------------------


def _resize_center_crop(img: np.ndarray, size: int = 224) -> np.ndarray:
    """(C, H, W) bicubic shortest-side resize + center crop (torchvision
    Resize(224) + CenterCrop(224) semantics)."""
    import cv2

    c, h, w = img.shape
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = np.stack([
        cv2.resize(img[i], (nw, nh), interpolation=cv2.INTER_CUBIC) for i in range(c)
    ])
    top = (nh - size) // 2
    left = (nw - size) // 2
    return resized[:, top: top + size, left: left + size]


class DepthProcessor:
    """Raw depth map (H, W) in millimeters -> (3, 224, 224) normalized
    (reference DepthNorm + transform, processing_depth.py:21-57)."""

    def __init__(self, max_depth: float = 10.0, min_depth: float = 0.01,
                 size: int = 224):
        self.max_depth = max_depth
        self.min_depth = min_depth
        self.size = size

    def __call__(self, depth: np.ndarray) -> np.ndarray:
        d = np.asarray(depth, np.float32) / 1000.0
        d = np.clip(d, self.min_depth, None)
        if self.max_depth:
            d = np.clip(d, None, self.max_depth) / self.max_depth
        else:
            d = d / max(d.max(), 1e-8)
        img = np.repeat(d[None], 3, axis=0)
        img = _resize_center_crop(img, self.size)
        mean = np.asarray(OPENAI_MEAN, np.float32)[:, None, None]
        std = np.asarray(OPENAI_STD, np.float32)[:, None, None]
        return ((img - mean) / std).astype(np.float32)


class ThermalProcessor:
    """Thermal image (H, W[, 3]) uint8 -> (3, 224, 224) normalized
    (reference processing_thermal.py:17-24)."""

    def __init__(self, size: int = 224):
        self.size = size

    def __call__(self, thermal: np.ndarray) -> np.ndarray:
        t = np.asarray(thermal)
        if t.ndim == 2:
            t = np.repeat(t[..., None], 3, axis=-1)
        img = t.astype(np.float32).transpose(2, 0, 1) / 255.0
        img = _resize_center_crop(img, self.size)
        mean = np.asarray(OPENAI_MEAN, np.float32)[:, None, None]
        std = np.asarray(OPENAI_STD, np.float32)[:, None, None]
        return ((img - mean) / std).astype(np.float32)
