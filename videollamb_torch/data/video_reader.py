"""Host video decoding: frame sampling across multiple backends.

A copy of ``videollamb_tpu/data/video_reader.py`` (reference
llava/vid_utils.py:35-195 and languagebind/video/processing_video.py:78-197)
with the same sampling and backends:

- the native libav decoder (``videollamb_torch/native``), preferred by the
  ``auto`` backend whenever it builds, as in the JAX package;
- OpenCV (seek-based sparse sampling, like the reference's 'opencv'
  backend), where the native decoder is unavailable;
- PyAV ('av' backend), gif (imageio) and frame-directory backends;
- the streaming CLI's ffmpeg re-encode cache (reference
  llava/serve/cli_streaming.py:12-37).

All backends return (T, H, W, C) uint8 RGB frames at the sampled indices.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np


def sample_indices_uniform(total: int, num: int) -> np.ndarray:
    """linspace(0, total-1, num) as int — the reference's universal sampling
    (vid_utils.py:18-32, processing_video.py:105)."""
    return np.linspace(0, max(total - 1, 0), num, dtype=int)


def fps_num_frames(total_frames: int, avg_fps: float, target_fps: float,
                   min_frames: int = 8, max_frames: int = 512) -> int:
    """fps-driven frame budget: ceil(secs*fps) rounded down to a multiple of
    8, floored at 8, capped at 512 (reference processing_video.py:100-106)."""
    secs = total_frames / max(avg_fps, 1e-6)
    new_duration = math.ceil(secs * target_fps)
    num = max(min_frames, new_duration - new_duration % 8)
    return min(num, max_frames)


def probe_video(path: str) -> Tuple[int, float]:
    """(total_frames, avg_fps)."""
    native = _native_decoder()
    if native is not None:
        return native.probe(path)
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
    finally:
        cap.release()
    return total, fps


def _native_decoder():
    """The native decoder module where it builds and loads, else None."""
    from videollamb_torch.native import video_decoder

    return video_decoder if video_decoder.available() else None


def video_backend(backend: str = "auto") -> str:
    """The backend :func:`load_video` decodes a video file with."""
    if backend in ("auto", "native"):
        return "native" if _native_decoder() is not None else "cv2"
    return backend


def _read_cv2(path: str, indices: Sequence[int]) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    try:
        last_pos = -2
        for idx in indices:
            idx = int(idx)
            if idx != last_pos + 1:
                cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, frame = cap.read()
            if not ok:
                raise ValueError(f"video decode error at frame {idx}: {path}")
            last_pos = idx
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    return np.stack(frames)


def _read_gif(path: str, num_frames: int) -> np.ndarray:
    import imageio

    reader = imageio.get_reader(path)
    frames = [np.asarray(f) for f in reader]
    indices = sample_indices_uniform(len(frames), num_frames)
    out = []
    for i in indices:
        f = frames[int(i)]
        if f.ndim == 2:
            f = np.stack([f] * 3, -1)
        if f.shape[-1] == 4:
            f = f[..., :3]
        out.append(f)
    return np.stack(out)


def _read_frame_dir(path: str, num_frames: int) -> np.ndarray:
    from PIL import Image

    names = sorted(os.listdir(path))
    indices = sample_indices_uniform(len(names), num_frames)
    frames = []
    for i in indices:
        img = Image.open(os.path.join(path, names[int(i)]))
        if img.mode != "RGB":
            img = img.convert("RGB")
        frames.append(np.asarray(img))
    return np.stack(frames)


def _read_av(path: str, indices: Sequence[int]) -> np.ndarray:
    """PyAV backend (reference vid_utils.py:52-68 'av' branch): sequential
    decode, keep the sampled indices. Optional dependency — import is
    deferred so the backend is selectable only where PyAV exists."""
    import av  # noqa: PLC0415 — optional backend

    wanted = {int(i) for i in indices}
    frames = {}
    with av.open(path) as container:
        for idx, frame in enumerate(container.decode(video=0)):
            if idx in wanted:
                frames[idx] = frame.to_ndarray(format="rgb24")
            if len(frames) == len(wanted):
                break
    return np.stack([frames[int(i)] for i in indices])


def ffmpeg_command(src_path: str, dst_path: str, *, fps: Optional[int] = None,
                   resolution: Optional[int] = None, pad: str = "#000000",
                   mode: str = "bicubic") -> list:
    """The reference's streaming re-encode command (cli_streaming.py:12-27
    ``ffmpeg_once``): strip audio, optional fps resample, optional square
    pad-resize."""
    command = ["ffmpeg", "-y", "-sws_flags", mode, "-i", src_path, "-an",
               "-threads", "10"]
    if fps is not None:
        command += ["-r", str(fps)]
    if resolution is not None:
        command += [
            "-vf",
            f"scale='if(gt(iw\\,ih)\\,{resolution}\\,-2)':'if(gt(iw\\,ih)\\,-2\\,{resolution})'"
            f",pad={resolution}:{resolution}:(ow-iw)/2:(oh-ih)/2:color='{pad}'",
        ]
    return command + [dst_path]


def ffmpeg_reencode_cached(src_path: str, cache_dir: str, fps: int = 1,
                           resolution: Optional[int] = None) -> str:
    """Re-encode once into ``cache_dir`` and return the cached path (reference
    cli_streaming.py:30-37). Without ``ffmpeg`` on PATH it returns the source
    path, and the reader's fps resampling stands in."""
    import shutil
    import subprocess

    name, ext = os.path.splitext(os.path.basename(src_path))
    dst = os.path.join(cache_dir, f"{name}_{fps}fps{ext}")
    if os.path.exists(dst):
        return dst
    if shutil.which("ffmpeg") is None:
        return src_path
    os.makedirs(cache_dir, exist_ok=True)
    subprocess.run(ffmpeg_command(src_path, dst, fps=fps, resolution=resolution), check=True)
    return dst


def load_video(
    path: str,
    num_frames: Optional[int] = None,
    fps: Optional[float] = None,
    max_frames: int = 512,
    backend: str = "auto",
) -> np.ndarray:
    """Decode and uniformly sample a video.

    Args:
      path: video file, gif, or frame directory.
      num_frames: fixed frame budget; overridden by ``fps`` if given.
      fps: target sampling rate — frame budget becomes
        fps_num_frames(total, avg_fps, fps) (reference decord branch).
    Returns:
      (T, H, W, C) uint8 RGB.
    """
    if os.path.isdir(path):
        return _read_frame_dir(path, num_frames or 8)
    if path.lower().endswith(".gif"):
        return _read_gif(path, num_frames or 8)

    total, avg_fps = probe_video(path)
    if fps:
        num_frames = fps_num_frames(total, avg_fps, fps, max_frames=max_frames)
    elif num_frames is None:
        num_frames = 8
    indices = sample_indices_uniform(total, num_frames)

    if backend not in ("auto", "native", "cv2", "av"):
        raise ValueError(f"unknown video backend {backend!r} (auto, native, cv2, av)")
    chosen = video_backend(backend)
    if chosen == "av":
        return _read_av(path, indices)
    if chosen == "native":
        return _native_decoder().read_frames(path, indices)
    return _read_cv2(path, indices)
