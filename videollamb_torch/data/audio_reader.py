"""Audio file loading for the LanguageBind audio modality.

A copy of ``videollamb_tpu/data/audio_reader.py``. The reference's audio
path cannot run as shipped (its torchaudio import is commented out at
llava/model/multimodal_encoder/languagebind/audio/processing_audio.py:4
while the code calls it); this is the working
port-side equivalent: a dependency-free PCM WAV reader (stdlib ``wave``)
feeding models/vision/modalities.AudioProcessor's numpy log-mel fbank.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (mono float32 waveform in [-1, 1], sample_rate).

    Handles 8/16/32-bit integer and 32-bit float PCM; multi-channel input
    is averaged to mono (the LanguageBind recipe operates on mono fbanks).
    """
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 1:  # unsigned 8-bit
        data = np.frombuffer(raw, np.uint8).astype(np.float32)
        data = (data - 128.0) / 128.0
    elif width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        # WAV spec: 4-byte samples are int32 PCM (float WAVs use a
        # different format tag that stdlib wave rejects).
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, rate
