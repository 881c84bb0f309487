"""HTTP surface for the streaming video engine.

Port of ``videollamb_tpu/serve/streams_api.py``.

The reference ships its online/streaming mode (VideoLLaMB-Live,
``llava/serve/cli_streaming.py:29-68`` driving
``llava/serve/inference.py:203-239``) as a CLI only. This module turns the
constant-memory incremental engine (serve/incremental.py) into a served
product: session-based streaming over plain JSON so a camera/ingest
client can push video chunks and queries as they happen and read back
timestamped events — the same tick protocol as the CLI.

Routes (wired in serve/http_server.py):

  POST   /v1/streams                  {video?, fps?, query?, max_new_tokens?,
                                       temperature?, max_seq_len?} -> {id}
  POST   /v1/streams/<id>/video       {video} append a chunk (path | file://
                                       | data: URI) -> {frames, video_time}
  POST   /v1/streams/<id>/query       {text, video_time?} -> {queued}
  POST   /v1/streams/<id>/tick        {video_time?} advance one tick and run
                                       the engine once -> {video_time, event?}
  GET    /v1/streams                  list sessions
  GET    /v1/streams/<id>             status (context length, resident
                                       frames, compactions, prefetch stats)
  DELETE /v1/streams/<id>             close the session

One tick == one frame-interval step, exactly like the CLI loop: the
session folds any newly due frames (SceneTilling boundary detection,
bridge stream step, KV extend) and answers at most one due query. Without
an explicit ``video_time`` the tick advances by one frame interval.

Sessions hold real device memory (a KV cache + bridge ring each), so the
manager caps live sessions (default 4) and 409s past the cap. Each session
runs under its own lock; ticks from the same session serialize, different
sessions (and the batch engine's worker) interleave on the device. A
session's video buffer lives on its device (``StreamingSession.append_video``
concatenates there).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

import torch

from videollamb_torch.serve.openai_api import BadRequest, _materialize_url


class StreamsBusy(Exception):
    """Session cap reached -> HTTP 409."""


class UnknownStream(Exception):
    """No such stream id -> HTTP 404 (distinct from internal KeyErrors,
    which must surface as 500s, not masquerade as 404s)."""


class StreamManager:
    def __init__(self, chat, max_sessions: int = 4,
                 session_defaults: Optional[Dict[str, Any]] = None):
        self.chat = chat
        self.max_sessions = max_sessions
        self.session_defaults = session_defaults or {}
        self._lock = threading.Lock()
        self._sessions: Dict[str, Dict[str, Any]] = {}
        self._next = 0

    # ------------------------------------------------------------------
    def _entry(self, sid: str) -> Dict[str, Any]:
        with self._lock:
            e = self._sessions.get(sid)
        if e is None or "session" not in e:
            raise UnknownStream(sid)
        return e

    def _clone_chat(self):
        from videollamb_torch.serve.chat import Chat

        return Chat(self.chat.tokenizer, self.chat.model, self.chat.cfg,
                    self.chat.processors, conv_mode=self.chat.conv_mode,
                    text_bucket=self.chat.text_bucket)

    @staticmethod
    def _with_video_path(row: Dict[str, Any], fn):
        """Materialize row['video'] (data: URIs -> temp file), call
        ``fn(path)``, and ALWAYS unlink the temp file afterwards — the
        session copies frames into its own buffer, so keeping materialized
        chunks would grow /tmp without bound on long camera streams."""
        url = row.get("video")
        if not url or not isinstance(url, str):
            raise BadRequest("missing 'video' (path | file:// | data: URI)")
        temp_paths: list = []
        try:
            path = _materialize_url(url, "video", temp_paths)
            if not os.path.exists(path):
                raise BadRequest(f"video not found: {path}")
            return fn(path)
        finally:
            for p in temp_paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass

    # ------------------------------------------------------------------
    def create(self, row: Dict[str, Any]) -> Dict[str, Any]:
        from videollamb_torch.serve.incremental import StreamingSession

        with self._lock:
            if len(self._sessions) >= self.max_sessions:
                raise StreamsBusy(
                    f"stream session cap reached ({self.max_sessions}); "
                    "DELETE a session first")
            self._next += 1
            sid = f"stream-{self._next}"
            # Reserve the slot under the lock; build outside it.
            self._sessions[sid] = {"building": True}
        try:
            kw = dict(self.session_defaults)
            for key, cast in (("fps", float), ("max_new_tokens", int),
                              ("temperature", float), ("max_seq_len", int),
                              ("max_open_frames", int)):
                if key in row:
                    kw["frame_fps" if key == "fps" else key] = cast(row[key])
            with torch.no_grad():
                session = StreamingSession(self._clone_chat(), **kw)
            if row.get("video"):
                self._with_video_path(row, session.load_videos)
            if row.get("query"):
                session.input_query_stream(
                    str(row["query"]),
                    video_time=(float(row["query_time"])
                                if "query_time" in row else 0.0))
            entry = {"session": session, "lock": threading.Lock(),
                     "events": []}
            with self._lock:
                self._sessions[sid] = entry
        except Exception:
            with self._lock:
                self._sessions.pop(sid, None)
            raise
        return {"id": sid, "frames": getattr(session, "num_video_frames", 0),
                "fps": session.frame_fps}

    def append_video(self, sid: str, row: Dict[str, Any]) -> Dict[str, Any]:
        e = self._entry(sid)
        with e["lock"]:
            s = e["session"]
            n = self._with_video_path(row, s.append_video)
            return {"id": sid, "frames": n,
                    "total_frames": s.num_video_frames,
                    "video_time": s.video_time}

    def query(self, sid: str, row: Dict[str, Any]) -> Dict[str, Any]:
        text = row.get("text")
        if not text or not isinstance(text, str):
            raise BadRequest("missing 'text'")
        e = self._entry(sid)
        with e["lock"]:
            note = e["session"].input_query_stream(
                text, video_time=(float(row["video_time"])
                                  if "video_time" in row else None))
        return {"id": sid, "queued": True, "note": note}

    def tick(self, sid: str, row: Dict[str, Any]) -> Dict[str, Any]:
        e = self._entry(sid)
        with e["lock"]:
            s = e["session"]
            n_frames = getattr(s, "num_video_frames", 0)
            if n_frames == 0:
                raise BadRequest(
                    "no video buffered; POST /v1/streams/<id>/video first")
            if "video_time" in row:
                t = float(row["video_time"])
                if int(t * s.frame_fps) > n_frames - 1:
                    max_t = (n_frames - 1) / s.frame_fps
                    raise BadRequest(
                        f"video_time {t:.2f}s is beyond the buffered stream "
                        f"({max_t:.2f}s); POST more video first")
            else:
                # One frame-interval step past the last ingested frame —
                # the CLI's `i / fps` cadence without client-side clocks.
                # Aim at frame-center time: (f + 0.5)/fps survives the
                # int(t*fps) truncation in input_video_stream for every
                # fps (f/fps can round DOWN to f-1 and stall the stream).
                f = s.last_frame_idx + 1
                if f > n_frames - 1:
                    max_t = (n_frames - 1) / s.frame_fps
                    raise BadRequest(
                        f"stream consumed up to {max_t:.2f}s; POST more "
                        "video first")
                t = (f + 0.5) / s.frame_fps
            with torch.no_grad():  # grad mode is per thread
                s.input_video_stream(t)
                query, response = s()
            out: Dict[str, Any] = {"id": sid, "video_time": s.video_time}
            if query is not None or response is not None:
                event = {"time": s.video_time, "query": query,
                         "response": response}
                e["events"].append(event)
                out["event"] = event
            return out

    def status(self, sid: str) -> Dict[str, Any]:
        e = self._entry(sid)
        with e["lock"]:
            s = e["session"]
            return {
                "id": sid,
                "video_time": s.video_time,
                "frames_buffered": getattr(s, "num_video_frames", 0),
                "frames_ingested": s.last_frame_idx + 1,
                "hbm_resident_frames": s.hbm_resident_frames,
                "context_length": s.context_length,
                "compactions": s._compactions,
                "prefetch_hits": s.prefetch_hits,
                "prefetch_misses": s.prefetch_misses,
                "events": list(e["events"]),
            }

    def list(self) -> Dict[str, Any]:
        with self._lock:
            sids = [s for s, e in self._sessions.items()
                    if "session" in e]
        return {"streams": sids, "max_sessions": self.max_sessions}

    def delete(self, sid: str) -> Dict[str, Any]:
        with self._lock:
            e = self._sessions.pop(sid, None)
        if e is None:
            raise UnknownStream(sid)
        return {"id": sid, "deleted": True}
