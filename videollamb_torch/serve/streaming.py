"""Online streaming inference, the reference-parity loop (``LiveInfer``).

Port of ``videollamb_tpu/serve/streaming.py`` (reference
llava/serve/inference.py:26-273):

- ``load_videos``: the fps-resampled, processed video;
- ``input_video_stream``: encodes only the new frames of each tick, one
  frame at a time through the tower (T = 1, so no temporal attention, as
  the reference's ``encode_image_features``), and queues (time, features),
  (time, CLS) and (time, pixels);
- ``_call_for_streaming``: threshold SceneTilling over every queued CLS
  embedding; a fresh, recent boundary fires a response (the condition of
  inference.py:164-168, kept verbatim);
- ``_call_for_response``: renders the conversation and runs a full sampled
  ``Chat.generate_text`` over every buffered frame, subsampled to a multiple
  of 8.

For the carried-state engine see ``serve/incremental.py``.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Tuple

import numpy as np
import torch

from videollamb_torch.config import ModelConfig
from videollamb_torch.constants import DEFAULT_X_TOKEN
from videollamb_torch.data.video_reader import load_video
from videollamb_torch.models.vision.clip_vit import vision_encode
from videollamb_torch.ops.scene_tilling import segment_threshold
from videollamb_torch.serve.chat import Chat


def encode_frames(chat: Chat, frames) -> torch.Tensor:
    """Per-frame tower features: (L, C, H, W) -> (L, N, D) f32 on the chat's
    device (B = L, T = 1: no temporal attention)."""
    pixels = torch.as_tensor(frames).to(chat.device, chat.dtype)
    with torch.no_grad():
        feats = vision_encode(chat.model.video_tower, pixels[:, None], chat.cfg.vision)
    return feats[:, 0].float()


# The reference's response budget of one answer (inference.py:203-239).
LIVEINFER_MAX_NEW_TOKENS = 512


class LiveInfer:
    def __init__(self, chat: Chat, frame_fps: float = 1.0):
        self.chat = chat
        self.cfg: ModelConfig = chat.cfg
        self.frame_fps = frame_fps
        self.frame_interval = 1.0 / frame_fps
        self.reset()

    def reset(self) -> None:
        self.query_queue = collections.deque()
        self.frame_embeds_queue = collections.deque()
        self.cls_embeds_queue = collections.deque()
        self.all_frame_tensors_queue = collections.deque()
        self.boundaries: List[int] = [0]
        self.video_time = 0.0
        self.last_frame_idx = -1
        self.video_tensor: Optional[np.ndarray] = None
        self.chat.reset()

    def load_videos(self, video_path: str) -> None:
        raw = load_video(video_path, fps=self.frame_fps, max_frames=512)
        self.video_tensor = self.chat.processors["VIDEO"](raw)  # (T, C, H, W)
        self.num_video_frames = self.video_tensor.shape[0]
        self.video_duration = self.num_video_frames / self.frame_fps

    def input_query_stream(self, query: str, video_time: Optional[float] = None) -> str:
        t = self.video_time if video_time is None else video_time
        self.query_queue.append((t, query))
        return f'(NOTE: Received "{query}" (at {t}s).)'

    def input_video_stream(self, video_time: float) -> None:
        frame_idx = int(video_time * self.frame_fps)
        if frame_idx > self.last_frame_idx:
            ranger = range(self.last_frame_idx + 1, frame_idx + 1)
            frames = self.video_tensor[list(ranger)]
            feats = encode_frames(self.chat, frames)  # (L, N, D)
            self.frame_embeds_queue.extend(
                (r / self.frame_fps, f) for r, f in zip(ranger, feats))
            self.cls_embeds_queue.extend(
                (r / self.frame_fps, f[0]) for r, f in zip(ranger, feats))
            self.all_frame_tensors_queue.extend(
                (r / self.frame_fps, t) for r, t in zip(ranger, frames))
        self.last_frame_idx = frame_idx
        self.video_time = video_time

    def _segment_boundaries(self) -> List[int]:
        cls = torch.stack([x[1] for x in self.cls_embeds_queue])
        if cls.shape[0] < 3:
            return [cls.shape[0] - 1]
        bounds, valid = segment_threshold(cls)
        return bounds[valid].tolist()

    def _call_for_streaming(self) -> Tuple[Optional[float], Optional[str]]:
        while self.frame_embeds_queue:
            # A query older than the next frame is answered now.
            if self.query_queue and self.frame_embeds_queue[0][0] > self.query_queue[0][0]:
                video_time, query = self.query_queue.popleft()
                return video_time, query

            video_time, _ = self.frame_embeds_queue.popleft()

            # Online SceneTilling: respond on a fresh, recent boundary
            # (reference inference.py:164-168, condition kept verbatim).
            boundaries = self._segment_boundaries()
            if (
                boundaries[-1] not in self.boundaries
                and len(boundaries) > 2
                and video_time - boundaries[-1] < 3
                and boundaries[-1] - self.boundaries[-1] > 1
            ):
                for bd in boundaries:
                    if bd not in self.boundaries:
                        self.boundaries.append(bd)
                return video_time, None
        return None, None

    def _call_for_response(self, video_time: float, query: Optional[str]) -> Tuple[str, str]:
        if query is not None:
            self.chat.conv.append_message(
                self.chat.conv.roles[0], DEFAULT_X_TOKEN["VIDEO"] + "\n" + query)
            self.chat.conv.append_message(self.chat.conv.roles[1], None)
        prompt = self.chat.conv.get_prompt()

        buffered = [x[1] for x in self.all_frame_tensors_queue]
        frames = torch.stack(buffered) if torch.is_tensor(buffered[0]) else np.stack(buffered)
        num_select = max(8, frames.shape[0] - frames.shape[0] % 8)
        idx = np.linspace(0, frames.shape[0] - 1, num_select, dtype=int)
        frames = frames[idx]

        response = self.chat.generate_text(
            prompt, videos=frames, max_new_tokens=LIVEINFER_MAX_NEW_TOKENS, temperature=0.2,
            do_sample=True)
        if query is not None:
            self.chat.conv.messages[-1][1] = response
        query_str = f"(Video Time = {video_time}s) User: {query}"
        response_str = f"(Video Time = {video_time}s) Assistant:{response}"
        return query_str, response_str

    def __call__(self) -> Tuple[Optional[str], Optional[str]]:
        video_time, query = self._call_for_streaming()
        response = None
        if video_time is not None:
            query, response = self._call_for_response(video_time, query)
        return query, response
