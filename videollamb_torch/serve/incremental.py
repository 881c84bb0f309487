"""Incremental streaming engine with carried state (``StreamingSession``).

Port of ``videollamb_tpu/serve/incremental.py``. The reference loop
(llava/serve/inference.py:203-239, ``serve/streaming.LiveInfer`` here)
re-encodes every buffered frame and re-prefills the whole conversation for
each response. This engine carries its state across ticks instead:

- **Bridge state**: when SceneTilling closes a segment, one
  ``rmt_r_stream_step`` runs (the recurrent memory and a bounded ring of
  past memories, ``models/bridge/rmt_r.py``);
- **KV cache**: segment tokens and query / response text join the running
  context through ``llama_extend``; decode continues from the live cache;
- **Bounded buffers**: per-frame features are kept for the open segment
  only (an over-long segment is force-closed); boundary detection runs in
  fixed-shape device buffers (``ops/streaming_boundaries.py``);
- **Compaction**: when the fixed cache cannot take the next chunk, the
  context is rebuilt from the system prompt, the newest segments that fit a
  budget computed on the host, and the conversation tail; older visual
  history lives on in the bridge's memory;
- the response condition of ``LiveInfer`` (reference
  inference.py:164-168), kept verbatim.

Device memory is constant in stream length: one KV cache of
``max_seq_len``, one bridge ring, at most ``max_open_frames`` of features.

The per-frame encode of the next tick is dispatched before this tick's
host work (the detector's one read per frame, each decoded token's
argmax), on the current stream. At one frame a tick the encode is
host-bound: ``PERF.md`` records no tick-latency gain on the H100 from
running it on a stream of its own, nor from the prefetch itself.

``recent_segments`` records each closed segment as it left the bridge
(padded), even when ``_extend_segment`` installed only its newest tokens or
none: the JAX package does the same, and a compaction replays that record,
so the tokens stay equal to JAX's.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Tuple

import numpy as np
import torch

from videollamb_torch.config import ModelConfig
from videollamb_torch.mm_utils import KeywordStopper
from videollamb_torch.models.bridge.rmt_r import (
    StreamBridgeState,
    init_stream_state,
    rmt_r_stream_step,
)
from videollamb_torch.models.engine import sample_token
from videollamb_torch.models.lm.llama import (
    embed_tokens,
    init_kv_cache,
    llama_decode_step,
    llama_extend,
    llama_prefill,
)
from videollamb_torch.ops.streaming_boundaries import BoundaryDetector
from videollamb_torch.serve.chat import Chat, _round_up
from videollamb_torch.serve.streaming import encode_frames


def system_prompt_ids(chat: Chat) -> List[int]:
    """Token ids of the system preamble that a session prefills first (and
    again at every compaction)."""
    conv = chat.conv
    return list(chat.tokenizer(conv.system + (conv.sep if conv.sep else "")).input_ids)


class StreamingSession:
    """``LiveInfer``'s tick API (load_videos / input_video_stream /
    input_query_stream / __call__) over carried state."""

    def __init__(self, chat: Chat, frame_fps: float = 1.0, max_open_frames: int = 32,
                 cache_segments: int = 32, max_seq_len: int = 2048,
                 max_new_tokens: int = 128, temperature: float = 0.0, seed: int = 0):
        self.chat = chat
        self.cfg: ModelConfig = chat.cfg
        if self.cfg.bridge.kind != "rmt_r_transformer":
            raise ValueError(
                "a streaming session steps the rmt_r_transformer bridge's recurrence "
                f"(rmt_r_stream_step); this model's projector is {self.cfg.bridge.kind!r}")
        self.frame_fps = frame_fps
        self.max_open_frames = max_open_frames
        self.cache_segments = cache_segments
        self.max_seq_len = max_seq_len
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.seed = seed
        self.device = chat.device
        self.reset()

    # -- state ----------------------------------------------------------
    def reset(self) -> None:
        self.query_queue = collections.deque()
        self.frame_times: collections.deque = collections.deque()
        self.open_frames: collections.deque = collections.deque()  # (time, feats)
        self._detector: Optional[BoundaryDetector] = None  # sized on the first frame
        # Known boundaries: a list for [-1] and a set for membership, evicted
        # together once behind the detector's window (no detection re-fires them).
        self.boundaries: collections.deque = collections.deque([0])
        self._boundary_set = {0}
        self.closed_upto = 0  # frames already folded into the bridge
        self._compactions = 0  # context rebuilds
        self._compaction_drops = 0  # segments a budgeted rebuild left out
        self._compacting = False
        self.video_time = 0.0
        self.last_frame_idx = -1
        self.video_tensor: Optional[np.ndarray] = None
        # Encode prefetch: (start, end, features).
        self._prefetched = None
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.chat.reset()

        dtype = self.chat.dtype
        self.bridge_state: StreamBridgeState = init_stream_state(
            self.cfg.bridge, dtype=dtype, cache_segments=self.cache_segments,
            device=self.device)
        # The newest segments' tokens, replayed by a compaction.
        self.recent_segments = collections.deque(maxlen=4)
        self.kv = init_kv_cache(self.cfg.lm, 1, self.max_seq_len, dtype=dtype,
                                device=self.device)
        self._prefill_system()

    def _prefill_system(self) -> None:
        """Prefill the system preamble; everything else joins by extension."""
        ids = torch.tensor([system_prompt_ids(self.chat)], dtype=torch.long,
                           device=self.device)
        self._system_len = int(ids.shape[1])
        lm = self.chat.model.lm
        _, self.kv = llama_prefill(lm, self.cfg.lm, embed_tokens(lm, ids),
                                   torch.ones_like(ids), self.kv)

    # -- video side ------------------------------------------------------
    def load_videos(self, video_path: str) -> None:
        from videollamb_torch.data.video_reader import load_video

        raw = load_video(video_path, fps=self.frame_fps, max_frames=512)
        self.video_tensor = self.chat.processors["VIDEO"](raw)
        self.num_video_frames = self.video_tensor.shape[0]
        self.video_duration = self.num_video_frames / self.frame_fps

    def append_video(self, video_path: str) -> int:
        """Append a video chunk to the live stream (the HTTP streams API
        feeds a session chunk by chunk as the camera produces them; the CLI
        loads one file up front through ``load_videos``). Frames join at the
        stream's fps behind the buffered tail, concatenated on the session's
        device; returns the number of frames appended. The encode prefetch
        stays valid: its window names existing indices only."""
        from videollamb_torch.data.video_reader import load_video

        raw = load_video(video_path, fps=self.frame_fps, max_frames=512)
        t = torch.as_tensor(self.chat.processors["VIDEO"](raw)).to(self.device)
        if self.video_tensor is None:
            self.video_tensor = t
        else:
            self.video_tensor = torch.cat([torch.as_tensor(self.video_tensor).to(self.device), t])
        self.num_video_frames = self.video_tensor.shape[0]
        self.video_duration = self.num_video_frames / self.frame_fps
        return int(t.shape[0])

    def _take_frames(self, start: int, end: int) -> torch.Tensor:
        """Encoded frames [start, end): from the prefetch when its window
        matches, else encoded now. Re-arms the prefetch for the next window
        of the same size."""
        pf = self._prefetched
        self._prefetched = None
        if pf is not None and pf[0] == start and pf[1] == end:
            feats = pf[2]
            self.prefetch_hits += 1
        else:
            feats = encode_frames(self.chat, self.video_tensor[start:end])
            self.prefetch_misses += 1
        nxt_end = min(end + (end - start), self.num_video_frames)
        if nxt_end > end:
            self._prefetched = (end, nxt_end,
                                encode_frames(self.chat, self.video_tensor[end:nxt_end]))
        return feats

    def input_query_stream(self, query: str, video_time: Optional[float] = None) -> str:
        t = self.video_time if video_time is None else video_time
        self.query_queue.append((t, query))
        return f'(NOTE: Received "{query}" (at {t}s).)'

    def input_video_stream(self, video_time: float) -> None:
        frame_idx = int(video_time * self.frame_fps)
        if frame_idx > self.last_frame_idx:
            ranger = range(self.last_frame_idx + 1, frame_idx + 1)
            feats = self._take_frames(ranger.start, ranger.stop)
            for r, f in zip(ranger, feats):
                self.open_frames.append((r / self.frame_fps, f))
                if self._detector is None:
                    self._detector = BoundaryDetector(dim=f.shape[-1], device=self.device)
                self._detector.add_frame(f[0])
                self.frame_times.append(r / self.frame_fps)
            # Bounded open segment: force-close past the cap.
            while len(self.open_frames) > self.max_open_frames:
                self._close_segment(self.max_open_frames)
        self.last_frame_idx = frame_idx
        self.video_time = video_time

    # -- incremental folding ----------------------------------------------
    def _close_segment(self, n_frames: int) -> None:
        """Fold the first ``n_frames`` open frames into the bridge and append
        the segment's tokens to the cache."""
        n_frames = min(n_frames, len(self.open_frames))
        if n_frames == 0:
            return
        taken = [self.open_frames.popleft() for _ in range(n_frames)]
        feats = torch.stack([f for _, f in taken])  # (L, n, d)
        f_max = self.cfg.bridge.max_frames_per_segment
        if feats.shape[0] > f_max:  # uniform subsample into the bridge
            idx = np.linspace(0, feats.shape[0] - 1, f_max, dtype=int)
            feats = feats[torch.from_numpy(idx).to(self.device)]
        n_real = feats.shape[0]
        if n_real < f_max:
            feats = torch.cat([feats, feats.new_zeros((f_max - n_real,) + feats.shape[1:])])
        frame_mask = torch.arange(f_max, device=self.device) < n_real
        tokens, tmask, self.bridge_state = rmt_r_stream_step(
            self.chat.model.mm_projector, self.cfg.bridge, feats.to(self.chat.dtype),
            frame_mask, self.bridge_state)
        # The valid frames lead, so their tokens are already compacted to the
        # front: zero the rest.
        padded = torch.where(tmask[:, None], tokens, 0.0)
        n_valid = n_real * self.cfg.bridge.tokens_per_frame
        # Extend first, then record: a compaction fired inside this extend
        # replays the record, which must not hold this segment yet.
        self._extend_segment(padded, n_valid)
        self.recent_segments.append((padded, n_valid))
        self.closed_upto += n_frames

    def _extend_segment(self, padded: torch.Tensor, n_valid: int) -> None:
        # Room is checked against the valid count: llama_extend advances the
        # length by it, not by the padded width.
        self._ensure_room(n_valid)
        room = self.max_seq_len - self.context_length - self.max_new_tokens
        if room <= 0:
            return  # nothing fits even after compaction; the bridge memory keeps it
        if n_valid > room:
            # A segment larger than the whole budget keeps its newest tokens.
            cut = torch.zeros_like(padded)
            cut[:room] = padded[n_valid - room: n_valid]
            padded, n_valid = cut, room
        attn = (torch.arange(padded.shape[0], device=self.device) < n_valid)[None].long()
        _, self.kv = llama_extend(self.chat.model.lm, self.cfg.lm,
                                  padded[None].to(self.chat.dtype), attn, self.kv)

    def _tail_texts(self) -> List[str]:
        conv = self.chat.conv
        return [f"{conv.sep}{role}: {text}" for role, text in conv.messages[-4:] if text]

    def _text_cost(self, text: str) -> int:
        """Cache slots ``_extend_text`` takes for ``text``: its tokens without
        BOS (the 16-token bucket's padding takes none)."""
        ids = self.chat.tokenizer(text).input_ids
        bos = getattr(self.chat.tokenizer, "bos_token_id", None)
        if bos is not None and len(ids) and ids[0] == bos:
            return max(len(ids) - 1, 1)
        return max(len(ids), 1)

    def _ensure_room(self, incoming: int) -> None:
        """Compact the context when the cache cannot take ``incoming`` more
        tokens: rebuild it from the system prompt, the newest recorded
        segments whose valid tokens fit ``max_seq_len - system - tail -
        incoming - max_new_tokens``, and the conversation tail. The budget is
        computed on the host, so the rebuild fits by construction."""
        if self.context_length + incoming + self.max_new_tokens <= self.max_seq_len:
            return
        if self._compacting:
            return
        self._compacting = True
        self._compactions += 1
        self.kv = init_kv_cache(self.cfg.lm, 1, self.max_seq_len, dtype=self.chat.dtype,
                                device=self.device)
        self._prefill_system()
        tail = self._tail_texts()
        tail_cost = sum(self._text_cost(t) for t in tail)
        budget = (self.max_seq_len - self._system_len - tail_cost - incoming
                  - self.max_new_tokens)
        keep: List[Tuple[torch.Tensor, int]] = []
        used = 0
        for padded, n_valid in reversed(self.recent_segments):
            if used + n_valid > budget:
                break
            keep.append((padded, n_valid))
            used += n_valid
        keep.reverse()
        self._compaction_drops += len(self.recent_segments) - len(keep)
        self.recent_segments = collections.deque(keep, maxlen=self.recent_segments.maxlen)
        for padded, n_valid in keep:
            self._extend_segment(padded, n_valid)
        for text in tail:
            self._extend_text(text)
        self._compacting = False

    # -- response side ----------------------------------------------------
    def _segment_boundaries(self) -> List[int]:
        if self._detector is None:
            return [0]
        return self._detector.boundaries()

    def _note_boundary(self, bd: int) -> None:
        self.boundaries.append(bd)
        self._boundary_set.add(bd)
        floor = self._detector.base if self._detector else 0
        while len(self.boundaries) > 1 and self.boundaries[0] < floor:
            self._boundary_set.discard(self.boundaries.popleft())

    def _call_for_streaming(self) -> Tuple[Optional[float], Optional[str]]:
        while self.frame_times:
            if self.query_queue and self.frame_times[0] > self.query_queue[0][0]:
                video_time, query = self.query_queue.popleft()
                return video_time, query
            video_time = self.frame_times.popleft()
            boundaries = self._segment_boundaries()
            if (
                boundaries[-1] not in self._boundary_set
                and len(boundaries) > 2
                and video_time - boundaries[-1] < 3
                and boundaries[-1] - self.boundaries[-1] > 1
            ):
                for bd in boundaries:
                    if bd not in self._boundary_set:
                        self._note_boundary(bd)
                # Close the segment that ends at the fresh boundary.
                n = boundaries[-1] - self.closed_upto
                if n > 0:
                    self._close_segment(n)
                return video_time, None
        return None, None

    def _extend_text(self, text: str) -> torch.Tensor:
        ids = list(self.chat.tokenizer(text).input_ids)
        bos = getattr(self.chat.tokenizer, "bos_token_id", None)
        if bos is not None and len(ids) and ids[0] == bos:
            ids = ids[1:]
        self._ensure_room(len(ids))
        room = self.max_seq_len - self.context_length - self.max_new_tokens
        if len(ids) > room:
            # An over-budget text keeps its newest tokens; with no room at all
            # it extends nothing (one token would break ctx + headroom <= cap).
            ids = ids[len(ids) - room:] if room >= 1 else []
        t = _round_up(max(len(ids), 1), 16)
        buf = torch.zeros((1, t), dtype=torch.long)
        buf[0, : len(ids)] = torch.tensor(ids, dtype=torch.long)
        msk = (torch.arange(t) < len(ids))[None].long()
        buf, msk = buf.to(self.device), msk.to(self.device)
        lm = self.chat.model.lm
        logits, self.kv = llama_extend(lm, self.cfg.lm, embed_tokens(lm, buf), msk, self.kv)
        return logits

    def _decode(self, logits: torch.Tensor, temperature: float = 0.0, seed: int = 0) -> str:
        lm = self.chat.model.lm
        tok = self.chat.tokenizer
        eos = int(tok.eos_token_id or 2)
        stopper = KeywordStopper([self.chat.stop_str()], tok)
        stop_ids = set(stopper.stop_token_ids())
        gen = torch.Generator(device=self.device).manual_seed(seed)
        toks: List[int] = []
        for i in range(self.max_new_tokens):
            nxt = int(sample_token(logits[:1], gen, do_sample=temperature > 0,
                                   temperature=temperature, top_p=1.0)[0])
            if nxt == eos or nxt in stop_ids:
                break
            toks.append(nxt)
            if i % 8 == 7:
                text = tok.decode(toks, skip_special_tokens=True)
                if stopper.trim(text) != text.strip():
                    break
            ids = torch.tensor([[nxt]], dtype=torch.long, device=self.device)
            logits, self.kv = llama_decode_step(lm, self.cfg.lm, embed_tokens(lm, ids), self.kv)
        return stopper.trim(tok.decode(toks, skip_special_tokens=True).strip())

    def _call_for_response(self, video_time: float, query: Optional[str]) -> Tuple[str, str]:
        # Fold the still-open frames so that the answer sees them.
        if query is not None and self.open_frames:
            self._close_segment(len(self.open_frames))
        conv = self.chat.conv
        q_text = query if query is not None else ""
        chunk = f"{conv.sep if conv.messages else ''}{conv.roles[0]}: {q_text} {conv.roles[1]}:"
        logits = self._extend_text(chunk)
        response = self._decode(logits, temperature=self.temperature, seed=self.seed)
        self._extend_text(response + (conv.sep2 or conv.sep or ""))
        conv.append_message(conv.roles[0], q_text)
        conv.append_message(conv.roles[1], response)
        query_str = f"(Video Time = {video_time}s) User: {query}"
        response_str = f"(Video Time = {video_time}s) Assistant:{response}"
        return query_str, response_str

    def __call__(self) -> Tuple[Optional[str], Optional[str]]:
        video_time, query = self._call_for_streaming()
        response = None
        if video_time is not None:
            query, response = self._call_for_response(video_time, query)
        return query, response

    # -- introspection ----------------------------------------------------
    @property
    def hbm_resident_frames(self) -> int:
        return len(self.open_frames)

    @property
    def context_length(self) -> int:
        return int(self.kv.length[0])
