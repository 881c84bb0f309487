"""HTTP serving front-end over the continuous-batching engines.

Port of ``videollamb_tpu/serve/http_server.py``; it runs on the card
unless ``--device cpu`` is given.

The reference's serving surfaces are interactive (CLI, gradio). This is
the deployment surface: a dependency-free (stdlib ``http.server``) JSON
API over `serve/server.ServingEngine` / `serve/paged.PagedServingEngine`,
with continuous batching across concurrent HTTP clients — requests from
different connections decode together in one slot batch.

  POST /v1/generate   {"prompt": ..., "video": <path>?, "adapter": <name>?,
                       "max_new_tokens": 128,
                       "temperature": 0.0, "top_p": 1.0, "stream": false}
      "adapter" selects a served LoRA fine-tune by name (multi-LoRA
      serving, models/lm/mlora.py; dense engine built with an adapter
      registry). Unknown names are rejected with HTTP 400.
      "choices": ["yes", "no"] constrains decoding — the output is
      guaranteed to be one of the strings (serve/constrained.py).
      "logprobs": true records each committed token's logprob
      ("top_logprobs": N adds the top-N alternatives, N <= 20); the
      engines extract them on-device alongside the token sync.
      -> {"id": ..., "text": ..., "tokens": N}
      "image": <path> and "audio": <WAV path> attach an image or an audio
      clip; a row naming several media is one mixed-modality request.
      With "stream": true the response is text/event-stream: one
      ``data: {"token": <piece>}`` event per committed token and a final
      ``data: {"done": true, "text": <full text>}`` (plus
      ``"timeout": true`` if the deadline truncated it).
  GET  /v1/health     -> {"status": "ok"|"degraded", "active": A,
                          "pending": P, ["last_error": ...]}
  GET  /metrics       -> Prometheus text format: request/token counters,
                          TTFT and end-to-end latency summaries, slot
                          occupancy and queue-depth gauges; histograms of
                          the engine's spans (queue wait, step, admission,
                          splice, one prefill, pages, decode phase, commit,
                          submit to first token);
                          the paged engine's prefix-cache, preemption and
                          page counters; spans dropped by the recorder.
  GET  /v1/adapters   -> {"adapters": [names...]}
  POST /v1/adapters   {"name": ..., "path": <PEFT adapter dir>} loads a
                          LoRA fine-tune at runtime: the adapter stack is
                          rebuilt in the live LM's projections, in place,
                          on the engine's worker thread between steps.
                          {"name": ..., "unload": true} removes one. 409
                          while adapter requests are in flight.
  POST /v1/cancel     {"id": ...} -> {"cancelled": bool}

OpenAI-compatible surface (serve/openai_api.py — existing OpenAI SDK /
LangChain clients work unchanged, multimodal content parts included):
  POST /v1/chat/completions   messages -> chat template; "model" routes
                              to the base model or a served LoRA adapter;
                              "stop" sequences cancel the slot on match;
                              "stream": true -> OpenAI SSE chunks.
  POST /v1/completions        raw continuation, no template.
  GET  /v1/models             base model + live adapters (+ embedder).
  POST /v1/embeddings         multimodal joint-space embeddings over the
                              LanguageBind binding model — text, image,
                              video, audio in one space (requires a
                              server built with an EmbeddingService;
                              serve/embeddings.py). 503 when absent.

Threading model: HTTP handler threads (ThreadingHTTPServer) build
requests — each under a throwaway per-request Chat clone, so media
decoding never serializes behind another client's — and wait on a
completion event; ONE worker thread drives ``engine.step(k)`` (the
engine is single-threaded by design: ``submit()`` is the only
thread-safe entry). A worker-side engine error fails all in-flight
requests with HTTP 500 and flips /v1/health to "degraded" instead of
silently hanging clients. Autograd is off on the worker thread (grad mode
is per thread in PyTorch). On the card a video request's tower runs K1 and
K2, the paged engine's decode K4 / K6 and K5, and a stream session's system
prefill K3 (the engines admit through ``chunked_prefill``, plain PyTorch).

    python -m videollamb_torch.serve.http_server \
        --model-path <ckpt> --video-tower <tower dir> --port 8000 \
        --paged --quantize-kv [--device-preprocess] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import torch

from videollamb_torch.serve.batch_cli import build_requests
from videollamb_torch.utils.profiling import BUCKETS, RECORDER, Aggregate


class RequestRejected(Exception):
    """Engine refused the request (policy, not server failure) -> 400."""


class AdapterBusy(Exception):
    """Adapter swap refused: adapter requests in flight -> 409."""


class EngineWorker(threading.Thread):
    """Drives the engine; signals each request's completion Event. An
    exception out of step() (OOM, pool exhaustion, compile failure) fails
    every in-flight request — clients get a response, not a hang — and is
    recorded for /v1/health; the worker keeps running so the server stays
    inspectable."""

    def __init__(self, engine, k: int = 4):
        super().__init__(daemon=True)
        self.engine = engine
        self.k = k
        self.last_error: Optional[str] = None
        self._stopping = threading.Event()
        # Admin ops applied between steps on this thread (adapter swaps).
        self.admin: "queue.Queue" = queue.Queue()

    def _fail_inflight(self, message: str) -> None:
        inflight = [r for r in self.engine.slots if r is not None]
        while not self.engine.pending.empty():
            try:
                inflight.append(self.engine.pending.get_nowait())
            except queue.Empty:
                break
        for i in range(len(self.engine.slots)):
            self.engine.slots[i] = None
        for req in inflight:
            req.error = req.error or message
            req.done = True
            ev = getattr(req, "_done_event", None)
            if ev is not None:
                ev.set()

    def _drain_admin(self) -> None:
        while not self.admin.empty():
            try:
                fn, done = self.admin.get_nowait()
            except queue.Empty:
                return
            try:
                fn()
                done["ok"] = True
            except Exception as e:  # noqa: BLE001 — reported to the caller
                done["error"] = f"{type(e).__name__}: {e}"
            done["event"].set()

    def run(self) -> None:
        while not self._stopping.is_set():
            self._drain_admin()
            if not self.engine.has_work():
                time.sleep(0.002)
                continue
            try:
                with torch.no_grad():
                    finished = self.engine.step(self.k)
            except Exception as e:  # noqa: BLE001 — engine-side failure
                self.last_error = f"{type(e).__name__}: {e}"
                self._fail_inflight(f"engine error: {self.last_error}")
                continue
            for req in finished:
                ev = getattr(req, "_done_event", None)
                if ev is not None:
                    ev.set()

    def stop(self) -> None:
        self._stopping.set()


# Span histograms of /metrics: (series, span name, help). The recorder is
# process-wide, so they count every engine of the process.
SPAN_HISTOGRAMS = (
    ("request_queue_seconds", "request.queue", "Engine submit to the start of admission."),
    ("engine_step_seconds", "engine.step", "One engine step (host)."),
    ("engine_admit_seconds", "engine.admit", "Admission phase of an engine step (host)."),
    ("splice_seconds", "splice", "One splice of media tokens into a prompt (host)."),
    ("admit_prefill_seconds", "admit.prefill", "One request's prefill (host enqueue)."),
    ("engine_pages_seconds", "engine.pages", "Page allocation and table upload (host)."),
    ("engine_decode_seconds", "engine.decode", "Decode phase of an engine step (host)."),
    ("decode_commit_seconds", "decode.commit", "Committing a step's tokens (host)."),
    ("first_token_seconds", "request.first_token", "Engine submit to the first token's commit."),
)
# The paged engine's counters: (series, attribute, help).
ENGINE_COUNTERS = (
    ("prefix_hits_total", "prefix_hits", "Automatic prefix cache hits."),
    ("prefix_misses_total", "prefix_misses", "Automatic prefix cache misses."),
    ("prefix_evictions_total", "prefix_evictions", "Cached prefixes evicted."),
    ("preempted_total", "preempted", "Requests swapped out to host memory."),
    ("resumed_total", "resumed", "Swapped-out requests resumed."),
    ("decode_graph_replays_total", "decode_replays", "Decode forwards replayed as a CUDA graph."),
    ("decode_eager_total", "decode_eager", "Decode forwards run eagerly."),
    ("decode_graph_captures_total", "decode_captures", "Decode forward graphs captured."),
)


class Metrics:
    """Process-wide serving counters in the Prometheus exposition format
    (text/plain 0.0.4; no client library). Counters and summaries are
    updated from handler threads and the per-token hooks, so every write
    takes the lock; reads (scrapes) render a consistent snapshot. The span
    histograms come from the span recorder (``utils/profiling.py``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.failed_total = 0
        self.tokens_total = 0
        self.ttft_sum = 0.0
        self.ttft_count = 0
        self.e2e_sum = 0.0
        self.e2e_count = 0

    def on_submit(self, req) -> None:
        req._t_submit = time.monotonic()
        req._t_first = None
        with self._lock:
            self.requests_total += 1

    def on_token(self, req) -> None:
        with self._lock:
            self.tokens_total += 1
            if req._t_first is None:
                req._t_first = time.monotonic()
                self.ttft_sum += req._t_first - req._t_submit
                self.ttft_count += 1

    def on_finish(self, req, failed: bool) -> None:
        with self._lock:
            self.e2e_sum += time.monotonic() - req._t_submit
            self.e2e_count += 1
            if failed:
                self.failed_total += 1

    def render(self, engine, worker) -> str:
        with self._lock:
            vals = dict(self.__dict__)
        lines = []

        def counter(name, v, help_):
            lines.append(f"# HELP videollamb_{name} {help_}")
            lines.append(f"# TYPE videollamb_{name} counter")
            lines.append(f"videollamb_{name} {v}")

        def gauge(name, v, help_):
            lines.append(f"# HELP videollamb_{name} {help_}")
            lines.append(f"# TYPE videollamb_{name} gauge")
            lines.append(f"videollamb_{name} {v}")

        counter("requests_total", vals["requests_total"],
                "Requests accepted by the HTTP layer.")
        counter("requests_failed_total", vals["failed_total"],
                "Requests that finished with an error.")
        counter("tokens_generated_total", vals["tokens_total"],
                "Tokens committed across all requests.")
        for key, help_ in (("ttft_seconds", "Submit-to-first-token latency."),
                           ("e2e_seconds", "Submit-to-completion latency.")):
            pfx = key.split("_")[0]
            lines.append(f"# HELP videollamb_{key} {help_}")
            lines.append(f"# TYPE videollamb_{key} summary")
            lines.append(f"videollamb_{key}_sum {vals[pfx + '_sum']}")
            lines.append(f"videollamb_{key}_count {vals[pfx + '_count']}")
        aggs = RECORDER.aggregates()
        none = Aggregate(0, 0.0, (0,) * (len(BUCKETS) + 1))
        for key, name, help_ in SPAN_HISTOGRAMS:
            agg = aggs.get(name, none)
            lines.append(f"# HELP videollamb_{key} {help_}")
            lines.append(f"# TYPE videollamb_{key} histogram")
            cum = 0
            for le, n in zip(BUCKETS, agg.buckets):
                cum += n
                lines.append(f'videollamb_{key}_bucket{{le="{le}"}} {cum}')
            lines.append(f'videollamb_{key}_bucket{{le="+Inf"}} {agg.count}')
            lines.append(f"videollamb_{key}_sum {agg.total}")
            lines.append(f"videollamb_{key}_count {agg.count}")
        counter("spans_dropped_total", RECORDER.dropped,
                "Span records the recorder's ring dropped to make room.")
        if hasattr(engine, "allocator"):  # the paged engine
            for key, attr, help_ in ENGINE_COUNTERS:
                counter(key, getattr(engine, attr), help_)
            gauge("pages_in_use", engine.pages_in_use,
                  "KV pages held by slots and cached prefixes.")
            gauge("pages_in_use_peak", engine.peak_pages_in_use,
                  "Most KV pages held at once.")
        gauge("slots_active", sum(r is not None for r in engine.slots),
              "Decode slots currently occupied.")
        gauge("slots_total", engine.num_slots, "Configured decode slots.")
        gauge("queue_pending", engine.pending.qsize(),
              "Requests waiting for admission.")
        # Liveness only — a past step error is sticky in /v1/health's
        # "degraded" but should not read as a dead engine forever here.
        gauge("engine_up", 1 if worker.is_alive() else 0,
              "1 while the engine worker thread is alive.")
        return "\n".join(lines) + "\n"


class Server:
    """Engine + worker + prompt assembly shared by all handler threads."""

    def __init__(self, chat, engine, k: int = 4, timeout_s: float = 600.0,
                 model_name: str = "videollamb", embedder=None):
        self.chat = chat
        self.engine = engine
        self.tokenizer = chat.tokenizer
        self.timeout_s = timeout_s
        self.model_name = model_name
        # Optional serve/embeddings.EmbeddingService: enables
        # POST /v1/embeddings (multimodal joint-space embeddings).
        self.embedder = embedder
        self._uid_lock = threading.Lock()
        self._next_uid = 0
        self.metrics = Metrics()
        # Adapter management state: name -> adapter arrays
        # (mlora.load_peft_adapter), the source of each restack.
        self._adapter_lock = threading.Lock()
        self._adapter_sources: Dict[str, Any] = {}
        # Streaming-video sessions (serve/streams_api.py): lazy so servers
        # that never stream pay nothing.
        self._streams: Optional[Any] = None
        self._streams_lock = threading.Lock()
        self.worker = EngineWorker(engine, k=k)
        self.worker.start()

    @property
    def streams(self):
        with self._streams_lock:
            if self._streams is None:
                from videollamb_torch.serve.streams_api import StreamManager

                self._streams = StreamManager(self.chat)
            return self._streams

    def _uid(self) -> str:
        with self._uid_lock:
            self._next_uid += 1
            return f"req-{self._next_uid}"

    def _register_clone(self, req):
        """Server-side bookkeeping for a forked choice (clone_request):
        own uid/completion event/metrics hooks, shared batch."""
        req.uid = self._uid()
        req._done_event = threading.Event()
        self.metrics.on_submit(req)
        req.on_token = lambda r, tok: self.metrics.on_token(r)
        return req

    def build(self, row: Dict[str, Any]):
        # Per-request Chat clone: conversation state is per-build, while
        # tokenizer/model/processors are shared — so media loading and
        # template assembly need no lock and concurrent clients'
        # preprocessing runs in parallel.
        from videollamb_torch.serve.chat import Chat

        chat = Chat(self.chat.tokenizer, self.chat.model, self.chat.cfg,
                    self.chat.processors, conv_mode=self.chat.conv_mode,
                    text_bucket=self.chat.text_bucket)
        req = build_requests([row], chat)[0]
        if req.uid is None:
            req.uid = self._uid()
        req.top_p = float(row.get("top_p", 1.0))
        # Text-only rows: the host-known prompt length skips the admission readback.
        b = req.batch
        if b.videos is None and b.images is None and b.blocks is None:
            req.prompt_len = int(b.attention_mask.sum())
        req._done_event = threading.Event()
        self.metrics.on_submit(req)
        req.on_token = lambda r, tok: self.metrics.on_token(r)
        return req

    def _finish(self, req) -> Dict[str, Any]:
        if req.error is not None:
            if req.error.startswith(("rejected", "unknown adapter",
                                     "engine has no adapter")):
                raise RequestRejected(req.error)
            raise RuntimeError(req.error)
        text = self.tokenizer.decode(req.tokens, skip_special_tokens=True)
        out = {"id": req.uid, "text": text.strip(), "tokens": len(req.tokens)}
        if req.logprobs:
            out["token_logprobs"] = list(req.token_logprobs)
            if req.top_logprobs > 0:
                out["top_tokens"] = [[[int(i), lp] for i, lp in tt]
                                     for tt in req.top_tokens]
        return out

    def generate(self, row: Dict[str, Any]) -> Dict[str, Any]:
        req = self.build(row)
        self.engine.submit(req)
        if not req._done_event.wait(self.timeout_s):
            self.engine.cancel(req.uid)
            self.metrics.on_finish(req, failed=True)
            raise TimeoutError(f"request {req.uid} timed out")
        self.metrics.on_finish(req, failed=req.error is not None)
        return self._finish(req)

    def generate_stream(self, row: Dict[str, Any], stops=None):
        """Per-token event dicts, then a final done event. ``stops``:
        server-side stop sequences — emission is withheld while the tail
        could still grow into a stop match, and a match cancels the slot
        immediately (serve/openai_api.StopMatcher)."""
        return self.stream_request(self.build(row), stops=stops)

    def _prompt_tokens(self, req) -> int:
        """Text prompt length (media splice expansion is device-side and
        not synced back; text-only rows report the exact spliced length)."""
        if req.prompt_len is not None:
            return int(req.prompt_len)
        return int(req.batch.attention_mask.sum())

    def stream_request(self, req, stops=None):
        from videollamb_torch.serve.openai_api import StopMatcher

        events: "queue.Queue[int]" = queue.Queue()
        metrics_hook = req.on_token  # chain: keep the metrics callback
        req.on_token = lambda r, tok: (metrics_hook(r, tok),
                                       events.put(tok))
        matcher = StopMatcher(stops) if stops else None
        self.engine.submit(req)
        deadline = time.monotonic() + self.timeout_s
        emitted = 0
        emitted_text: list = []
        timed_out = False
        stop_matched = False
        try:
            while True:
                try:
                    tok = events.get(timeout=0.1)
                except queue.Empty:
                    if req._done_event.is_set() and events.empty():
                        break
                    if time.monotonic() > deadline:
                        self.engine.cancel(req.uid)
                        timed_out = True
                        break
                    continue
                emitted += 1
                # Decode incrementally so multi-token pieces render correctly.
                piece = self.tokenizer.decode(req.tokens[:emitted],
                                              skip_special_tokens=True)
                prev = self.tokenizer.decode(req.tokens[:emitted - 1],
                                             skip_special_tokens=True)
                piece = piece[len(prev):]
                if matcher is not None:
                    piece, stop_matched = matcher.feed(piece)
                if piece:
                    emitted_text.append(piece)
                    event = {"token": piece}
                    if req.logprobs and emitted <= len(req.token_logprobs):
                        # The engine commits logprobs before on_token fires,
                        # so index emitted-1 is always populated here.
                        event["token_id"] = int(req.tokens[emitted - 1])
                        event["logprob"] = req.token_logprobs[emitted - 1]
                        if req.top_logprobs > 0:
                            event["top_logprobs"] = req.top_tokens[emitted - 1]
                    yield event
                if stop_matched:
                    # Free the slot now — decoding past the stop is waste.
                    self.engine.cancel(req.uid)
                    break
        except GeneratorExit:
            # Client went away mid-stream: free the slot immediately
            # instead of decoding the rest of max_new_tokens into the void.
            # Still record the end (failed): otherwise disconnects leave
            # requests_total and the e2e summary counting different
            # populations.
            self.engine.cancel(req.uid)
            self.metrics.on_finish(req, failed=True)
            raise
        if matcher is not None and not stop_matched:
            tail = matcher.flush()  # held text that never became a stop
            if tail:
                emitted_text.append(tail)
                yield {"token": tail}
        # Timeouts count as failures here, matching the non-streaming path.
        self.metrics.on_finish(req, failed=(req.error is not None or timed_out))
        if req.error is not None:
            yield {"done": True, "id": req.uid, "error": req.error}
            return
        if matcher is not None:
            text = "".join(emitted_text)
        else:
            text = self.tokenizer.decode(req.tokens, skip_special_tokens=True)
        if stop_matched or (not timed_out
                            and len(req.tokens) < req.max_new_tokens):
            finish_reason = "stop"
        else:
            finish_reason = "length"
        event = {"done": True, "id": req.uid, "text": text.strip(),
                 "tokens": len(req.tokens), "finish_reason": finish_reason,
                 "prompt_tokens": self._prompt_tokens(req)}
        if req.logprobs:
            event["logprobs_data"] = {
                "ids": list(req.tokens), "lps": list(req.token_logprobs),
                "tops": list(req.top_tokens), "top_n": req.top_logprobs,
            }
        if timed_out:
            event["timeout"] = True
        yield event

    # ------------------------------------------------------------------
    # OpenAI-compatible endpoints (serve/openai_api.py converters).
    def _adapter_names(self):
        return sorted(getattr(self.engine, "adapter_registry", None) or {})

    def openai_models(self) -> Dict[str, Any]:
        from videollamb_torch.serve import openai_api as oai

        out = oai.models_response(self.model_name, self._adapter_names())
        if self.embedder is not None:
            out["data"].append({
                "id": self.embedder.model_name, "object": "model",
                "created": out["data"][0]["created"],
                "owned_by": "videollamb-tpu"})
        return out

    def _openai_row(self, body: Dict[str, Any], chat_mode: bool):
        from videollamb_torch.serve import openai_api as oai

        if chat_mode:
            return oai.row_from_chat_completions(
                body, self.model_name, self._adapter_names())
        row, stops = oai.row_from_completions(
            body, self.model_name, self._adapter_names())
        return row, stops, []

    def openai_generate(self, body: Dict[str, Any],
                        chat_mode: bool = True) -> Dict[str, Any]:
        """Non-streaming chat/completions. Drains the token stream (the
        same engine path the SSE route uses) so stop sequences cancel the
        slot mid-decode and a timeout returns the partial text with
        finish_reason=length instead of HTTP 504."""
        from videollamb_torch.serve import openai_api as oai

        row, stops, temp_paths = self._openai_row(body, chat_mode)
        model = body.get("model") or self.model_name
        n = int(body.get("n", 1) or 1)
        try:
            def drain(r):
                final = None
                for event in self.generate_stream(r, stops=stops):
                    if event.get("done"):
                        final = event
                return final

            if n == 1:
                finals = [drain(row)]
            else:
                # n choices = n engine requests FORKED from one build: the
                # media decode, splice, and admission prefill are paid
                # once (clone_request + share_prefill), then the siblings
                # continuous-batch together in the slot pool and sampled
                # rows draw independently from the engine rng chain.
                from videollamb_torch.serve.server import (
                    clone_request,
                    share_prefill,
                )

                base = self.build(row)
                sibs = [base] + [self._register_clone(clone_request(base))
                                 for _ in range(n - 1)]
                share_prefill(sibs)
                finals: list = [None] * n
                errs: list = [None] * n

                def worker(i):
                    try:
                        final = None
                        for event in self.stream_request(sibs[i],
                                                         stops=stops):
                            if event.get("done"):
                                final = event
                        finals[i] = final
                    except Exception as e:  # noqa: BLE001 — re-raised below
                        errs[i] = e

                ts = [threading.Thread(target=worker, args=(i,))
                      for i in range(1, n)]
                for t in ts:
                    t.start()
                worker(0)  # choice 0 rides the handler thread
                for t in ts:
                    t.join()
                for e in errs:
                    if e is not None:
                        raise e
            for final in finals:
                if final.get("error"):
                    err = final["error"]
                    if err.startswith(("rejected", "unknown adapter",
                                       "engine has no adapter")):
                        raise RequestRejected(err)
                    raise RuntimeError(err)

            def lp_of(final):
                lpd = final.get("logprobs_data")
                if lpd is None:
                    return None
                build = (oai.chat_logprobs if chat_mode
                         else oai.completion_logprobs)
                return build(self.tokenizer, lpd["ids"], lpd["lps"],
                             lpd["tops"], lpd["top_n"])

            usage = oai.usage_dict(finals[0]["prompt_tokens"],
                                   sum(f["tokens"] for f in finals))
            if chat_mode:
                from videollamb_torch.serve import tools as toolmod

                tinfo = row.get("_tools")
                choices = []
                for i, final in enumerate(finals):
                    tool_calls = None
                    if tinfo:
                        parsed = toolmod.parse_tool_call(final["text"],
                                                         tinfo["names"])
                        if parsed is not None:
                            tool_calls = toolmod.tool_calls_payload(
                                parsed[0], parsed[1], final["id"])
                    choices.append(oai.chat_choice(
                        i, final["text"], final["finish_reason"],
                        logprobs=lp_of(final), tool_calls=tool_calls))
                return oai.chat_completion_response(
                    finals[0]["id"], model, "", "", usage, choices=choices)
            choices = [oai.completion_choice(
                i, f["text"], f["finish_reason"], logprobs=lp_of(f))
                for i, f in enumerate(finals)]
            return oai.completion_response(
                finals[0]["id"], model, "", "", usage, choices=choices)
        finally:
            oai._cleanup(temp_paths)

    def openai_stream(self, body: Dict[str, Any], chat_mode: bool = True):
        """Validates + builds the request EAGERLY (conversion errors must
        become 4xx JSON, not SSE), then returns the chunk generator:
        OpenAI chunk dicts, a final finish_reason chunk (plus a usage
        chunk under stream_options.include_usage), then "[DONE]"."""
        from videollamb_torch.serve import openai_api as oai

        if body.get("tools"):
            raise oai.BadRequest("streaming with tools is not supported — "
                                 "set stream=false for tool calls")
        # n is validated by _common_params inside _openai_row (non-int n
        # must 400 there, not ValueError into a 500 here).
        row, stops, temp_paths = self._openai_row(body, chat_mode)
        if (body.get("n", 1) or 1) != 1:
            oai._cleanup(temp_paths)
            raise oai.BadRequest("streaming with n>1 is not supported — "
                                 "set stream=false for multiple choices")
        model = body.get("model") or self.model_name
        include_usage = bool(
            (body.get("stream_options") or {}).get("include_usage"))
        try:
            req = self.build(row)
        except Exception:
            oai._cleanup(temp_paths)
            raise
        rid = req.uid

        top_n = int(row.get("top_logprobs", 0))

        def chunk_logprobs(event):
            """Per-chunk logprobs for the one token this delta carries."""
            if "logprob" not in event:
                return None
            if chat_mode:
                return {"content": [oai.chat_logprob_entry(
                    self.tokenizer, event["token_id"], event["logprob"],
                    event.get("top_logprobs"), top_n)]}
            return oai.completion_logprobs(
                self.tokenizer, [event["token_id"]], [event["logprob"]],
                [event.get("top_logprobs")], top_n)

        def chunks():
            try:
                first = True
                final = None
                for event in self.stream_request(req, stops=stops):
                    if event.get("done"):
                        final = event
                        continue
                    if chat_mode:
                        delta = {"content": event["token"]}
                        if first:
                            delta["role"] = "assistant"
                            first = False
                        yield oai.chat_completion_chunk(
                            rid, model, delta, None,
                            logprobs=chunk_logprobs(event))
                    else:
                        yield oai.completion_chunk(
                            rid, model, event["token"], None,
                            logprobs=chunk_logprobs(event))
                if final.get("error"):
                    yield oai.error_body(final["error"])
                else:
                    if chat_mode:
                        yield oai.chat_completion_chunk(
                            rid, model, {}, final["finish_reason"])
                    else:
                        yield oai.completion_chunk(
                            rid, model, "", final["finish_reason"])
                    if include_usage:
                        usage = oai.usage_dict(final["prompt_tokens"],
                                               final["tokens"])
                        chunk = (oai.chat_completion_chunk(rid, model, {},
                                                           None)
                                 if chat_mode else
                                 oai.completion_chunk(rid, model, "", None))
                        chunk["choices"] = []
                        chunk["usage"] = usage
                        yield chunk
                yield "[DONE]"
            finally:
                oai._cleanup(temp_paths)

        return chunks()

    def health(self) -> Dict[str, Any]:
        degraded = (self.worker.last_error is not None
                    or not self.worker.is_alive())
        out = {
            "status": "degraded" if degraded else "ok",
            "active": sum(r is not None for r in self.engine.slots),
            "pending": self.engine.pending.qsize(),
        }
        if self.worker.last_error:
            out["last_error"] = self.worker.last_error
        return out

    def cancel(self, uid) -> bool:
        return self.engine.cancel(uid)

    # ------------------------------------------------------------------
    # Runtime adapter management (models/lm/mlora.py). The adapter files
    # are read on the handler thread; the stack is rebuilt in the live LM's
    # projections, in place, on the worker thread between steps, so no
    # step sees a half-built stack. The chat shares that LM.
    def list_adapters(self) -> Dict[str, Any]:
        reg = getattr(self.engine, "adapter_registry", None) or {}
        return {"adapters": sorted(reg)}

    def manage_adapter(self, row: Dict[str, Any]) -> Dict[str, Any]:
        from videollamb_torch.models.lm.mlora import load_peft_adapter

        name = row.get("name")
        if not name:
            raise RequestRejected("missing adapter 'name'")
        with self._adapter_lock:
            current = dict(self._adapter_sources)
            if row.get("unload"):
                if name not in current:
                    raise RequestRejected(f"unknown adapter {name!r}")
                del current[name]
            else:
                path = row.get("path")
                if not path:
                    raise RequestRejected("missing adapter 'path'")
                current[name] = load_peft_adapter(
                    path, self.chat.cfg.lm.num_hidden_layers)
            done = {"event": threading.Event()}
            self.worker.admin.put((lambda: self._swap_adapters(current), done))
            if not done["event"].wait(30.0):
                raise RuntimeError("adapter swap timed out")
            if "error" in done:
                if "in flight" in done["error"]:
                    raise AdapterBusy(done["error"])
                raise RuntimeError(done["error"])
            self._adapter_sources = current
        return {"ok": True, "adapters": sorted(current)}

    def _swap_adapters(self, adapters: Dict[str, Any]) -> None:
        """Worker thread: restack ``adapters`` in the engine's LM (none:
        the base model) and hand the registry to the engine."""
        from videollamb_torch.models.lm.mlora import (
            add_multi_lora_params,
            drop_multi_lora_params,
        )

        engine = self.engine
        if (engine._adapter_host >= 0).any():
            raise RuntimeError("adapter requests in flight; retry when drained")
        lm = engine.model.lm
        if getattr(lm, "mlora_rows", None) is not None:
            drop_multi_lora_params(lm)
        registry = add_multi_lora_params(lm, adapters)[1] if adapters else None
        engine.set_adapters(engine.model, registry)

    def shutdown(self) -> None:
        self.worker.stop()
        self.worker.join(timeout=5)


class Handler(BaseHTTPRequestHandler):
    server_obj: Server  # injected via make_server

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> Dict[str, Any]:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n) or b"{}")

    def _streams_route(self, row: Dict[str, Any]) -> bool:
        """Dispatch /v1/streams[/<id>[/<op>]] for any method; returns True
        if the path belonged to the streams API."""
        parts = self.path.rstrip("/").split("/")
        if len(parts) < 3 or parts[1] != "v1" or parts[2] != "streams":
            return False
        from videollamb_torch.serve import openai_api as oai
        from videollamb_torch.serve.streams_api import StreamsBusy, UnknownStream

        mgr = self.server_obj.streams
        method = self.command
        try:
            if len(parts) == 3:
                if method == "GET":
                    self._json(200, mgr.list())
                elif method == "POST":
                    self._json(200, mgr.create(row))
                else:
                    self._json(405, {"error": f"{method} not allowed"})
                return True
            sid = parts[3]
            if len(parts) == 4:
                if method == "GET":
                    self._json(200, mgr.status(sid))
                elif method == "DELETE":
                    self._json(200, mgr.delete(sid))
                else:
                    self._json(405, {"error": f"{method} not allowed"})
                return True
            op = parts[4]
            if method != "POST" or op not in ("video", "query", "tick"):
                self._json(404, {"error": f"unknown path {self.path}"})
                return True
            fn = {"video": mgr.append_video, "query": mgr.query,
                  "tick": mgr.tick}[op]
            self._json(200, fn(sid, row))
        except UnknownStream as e:
            self._json(404, {"error": f"unknown stream {e}"})
        except oai.BadRequest as e:
            self._json(400, {"error": str(e)})
        except StreamsBusy as e:
            self._json(409, {"error": str(e)})
        except FileNotFoundError as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — surface, don't kill
            self._json(500, {"error": f"{type(e).__name__}: {e}"})
        return True

    def do_GET(self) -> None:
        if self._streams_route({}):
            return
        if self.path == "/v1/health":
            self._json(200, self.server_obj.health())
        elif self.path == "/v1/models":
            self._json(200, self.server_obj.openai_models())
        elif self.path == "/v1/adapters":
            self._json(200, self.server_obj.list_adapters())
        elif self.path == "/metrics":
            body = self.server_obj.metrics.render(
                self.server_obj.engine, self.server_obj.worker).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def _stream(self, row: Dict[str, Any]) -> None:
        """SSE response. Once headers are sent, errors become in-band
        ``data: {"error": ...}`` events — never a second header block."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        gen = self.server_obj.generate_stream(row)
        try:
            for event in gen:
                self.wfile.write(
                    b"data: " + json.dumps(event).encode() + b"\n\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            gen.close()  # triggers GeneratorExit -> engine.cancel
        except Exception as e:  # noqa: BLE001 — in-band error event
            try:
                payload = {"done": True,
                           "error": f"{type(e).__name__}: {e}"}
                self.wfile.write(
                    b"data: " + json.dumps(payload).encode() + b"\n\n")
                self.wfile.flush()
            except OSError:
                pass

    def _openai(self, body: Dict[str, Any], chat_mode: bool) -> None:
        """POST /v1/chat/completions and /v1/completions. Conversion and
        build errors are 4xx JSON with OpenAI error bodies; once an SSE
        stream has started, errors become in-band chunks."""
        from videollamb_torch.serve import openai_api as oai

        try:
            if not body.get("stream"):
                self._json(200, self.server_obj.openai_generate(
                    body, chat_mode=chat_mode))
                return
            chunks = self.server_obj.openai_stream(body, chat_mode=chat_mode)
        except oai.BadRequest as e:
            self._json(e.status, oai.error_body(str(e), e.code))
            return
        except FileNotFoundError as e:
            self._json(400, oai.error_body(str(e)))
            return
        except RequestRejected as e:
            self._json(400, oai.error_body(str(e)))
            return
        except Exception as e:  # noqa: BLE001 — surface, don't kill the thread
            self._json(500, {"error": {"message": f"{type(e).__name__}: {e}",
                                       "type": "server_error"}})
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            for chunk in chunks:
                payload = (b"[DONE]" if chunk == "[DONE]"
                           else json.dumps(chunk).encode())
                self.wfile.write(b"data: " + payload + b"\n\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            chunks.close()  # GeneratorExit -> engine.cancel + temp cleanup
        except Exception as e:  # noqa: BLE001 — in-band error chunk
            try:
                self.wfile.write(
                    b"data: " + json.dumps(oai.error_body(
                        f"{type(e).__name__}: {e}")).encode() + b"\n\n")
                self.wfile.flush()
            except OSError:
                pass

    def do_DELETE(self) -> None:
        if self._streams_route({}):
            return
        self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:
        try:
            row = self._read_body()
        except (ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": f"bad JSON: {e}"})
            return
        if self._streams_route(row):
            return
        if self.path == "/v1/cancel":
            self._json(200, {"cancelled": self.server_obj.cancel(row.get("id"))})
            return
        if self.path == "/v1/adapters":
            try:
                self._json(200, self.server_obj.manage_adapter(row))
            except RequestRejected as e:
                self._json(400, {"error": str(e)})
            except AdapterBusy as e:
                self._json(409, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if self.path in ("/v1/chat/completions", "/v1/completions"):
            self._openai(row, chat_mode=self.path == "/v1/chat/completions")
            return
        if self.path == "/v1/embeddings":
            from videollamb_torch.serve import openai_api as oai

            if self.server_obj.embedder is None:
                self._json(503, oai.error_body(
                    "no embedding model is loaded on this server"))
                return
            try:
                self._json(200, self.server_obj.embedder.openai_embeddings(row))
            except oai.BadRequest as e:
                self._json(e.status, oai.error_body(str(e), e.code))
            except FileNotFoundError as e:
                self._json(400, oai.error_body(str(e)))
            except Exception as e:  # noqa: BLE001 — surface, don't kill
                self._json(500, {"error": {
                    "message": f"{type(e).__name__}: {e}",
                    "type": "server_error"}})
            return
        if self.path != "/v1/generate":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        if "prompt" not in row:
            self._json(400, {"error": "missing 'prompt'"})
            return
        if row.get("stream"):
            self._stream(row)
            return
        try:
            self._json(200, self.server_obj.generate(row))
        except TimeoutError as e:
            self._json(504, {"error": str(e)})
        except (FileNotFoundError, RequestRejected) as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — surface, don't kill the thread
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(chat, engine, host: str = "127.0.0.1", port: int = 8000,
                k: int = 4, timeout_s: float = 600.0,
                model_name: str = "videollamb", embedder=None):
    """Returns (ThreadingHTTPServer, Server). Port 0 picks an ephemeral
    port (tests); read it back from httpd.server_address."""
    srv = Server(chat, engine, k=k, timeout_s=timeout_s,
                 model_name=model_name, embedder=embedder)
    handler = type("BoundHandler", (Handler,), {"server_obj": srv})
    httpd = ThreadingHTTPServer((host, port), handler)
    return httpd, srv


def build_embedder(spec: str, device="cuda", device_preprocess: bool = False):
    """--binding-towers "video=DIR,image=DIR" -> EmbeddingService on
    ``device``. Tokenizer and per-modality processors come from the
    checkpoints' configs (LanguageBind dirs ship CLIP tokenizer files);
    ``device_preprocess`` takes the video frames through
    ``DeviceVideoProcessor``."""
    from videollamb_torch.models.binding import load_binding_checkpoints
    from videollamb_torch.serve.embeddings import EmbeddingService

    paths = {}
    for part in spec.split(","):
        modality, _, path = part.partition("=")
        if not path:
            raise ValueError(f"--binding-towers entry {part!r} must be "
                             "modality=dir")
        paths[modality.strip()] = path.strip()
    model, vcfgs, tcfg = load_binding_checkpoints(paths, device=device)

    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(paths[sorted(paths)[0]])
    processors = {}
    for name, vcfg in vcfgs.items():
        if name == "audio":
            from videollamb_torch.models.vision.modalities import AudioProcessor

            processors[name] = AudioProcessor()
        elif name == "video" and device_preprocess:
            from videollamb_torch.data.device_preprocess import DeviceVideoProcessor

            processors[name] = DeviceVideoProcessor(size=vcfg.image_size, device=device)
        elif name == "video":
            from videollamb_torch.data.processing import VideoProcessor

            processors[name] = VideoProcessor(size=vcfg.image_size)
        else:
            from videollamb_torch.data.processing import ImageProcessor

            processors[name] = ImageProcessor(size=vcfg.image_size)
    return EmbeddingService(model, vcfgs, tokenizer, processors,
                            text_cfg=tcfg,
                            num_frames=max(v.num_frames for v in
                                           vcfgs.values()))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--video-tower", default=None,
                        help="LanguageBind video tower dir (video requests need it)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions "
                             "of the kernels)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--num-slots", type=int, default=8)
    parser.add_argument("--paged", action="store_true")
    parser.add_argument("--page-size", type=int, default=64)
    parser.add_argument("--quantize-kv", action="store_true")
    parser.add_argument("--prefix-cache-size", type=int, default=8,
                        help="max automatically cached prompt prefixes "
                             "(paged engine; 'shared_prefix' requests)")
    parser.add_argument("--load-8bit", action="store_true")
    parser.add_argument("--device-preprocess", action="store_true",
                        help="resize / crop / normalise video frames on the device "
                             "(data/device_preprocess.py)")
    parser.add_argument("--sync-every", type=int, default=4)
    parser.add_argument("--speculative", choices=["lookup", "draft"],
                        default=None,
                        help="batched speculation on the dense engine "
                             "(all-greedy batches): 'lookup' = prompt "
                             "n-gram proposals, 'draft' = a draft LM "
                             "(--draft-path; same tokenizer + hidden "
                             "size) proposing on device")
    parser.add_argument("--draft-path", default=None,
                        help="checkpoint dir of the draft LM for "
                             "--speculative draft")
    parser.add_argument("--spec-k", type=int, default=8)
    parser.add_argument("--served-model-name", default=None,
                        help="name under /v1/models and accepted as "
                             "'model' (default: the model path's basename)")
    parser.add_argument("--binding-towers", default=None,
                        help="enable /v1/embeddings: comma list of "
                             "modality=dir LanguageBind checkpoint dirs, "
                             "e.g. video=ckpts/LanguageBind_Video_merge,"
                             "image=ckpts/LanguageBind_Image")
    args = parser.parse_args(argv)

    from videollamb_torch.models.builder import load_pretrained_model, resolve_device
    from videollamb_torch.serve.chat import Chat

    device = resolve_device(args.device)
    tokenizer, model, cfg, processors, _ = load_pretrained_model(
        args.model_path, model_base=args.model_base, video_tower_path=args.video_tower,
        dtype="bfloat16", load_8bit=args.load_8bit, device_preprocess=args.device_preprocess,
        device=device)
    chat = Chat(tokenizer, model, cfg, processors)
    eos = int(tokenizer.eos_token_id or 2)
    if args.paged:
        from videollamb_torch.serve.paged import PagedServingEngine

        if args.speculative:
            parser.error("--speculative requires the dense engine "
                         "(drop --paged)")
        engine = PagedServingEngine(
            model, cfg, num_slots=args.num_slots, page_size=args.page_size,
            quantize_kv=args.quantize_kv, eos_token_id=eos,
            prefix_cache_size=args.prefix_cache_size)
    else:
        from videollamb_torch.serve.server import ServingEngine

        draft_params = draft_cfg = None
        if args.speculative == "draft":
            if not args.draft_path:
                parser.error("--speculative draft needs --draft-path")
            _, dp, dcfg, _, _ = load_pretrained_model(
                args.draft_path, dtype="bfloat16", load_8bit=args.load_8bit,
                load_tokenizer=False, device=device)
            draft_params, draft_cfg = dp, dcfg.lm
        engine = ServingEngine(model, cfg, num_slots=args.num_slots,
                               eos_token_id=eos,
                               speculative=args.speculative,
                               spec_k=args.spec_k,
                               draft_params=draft_params,
                               draft_cfg=draft_cfg)
    import os

    embedder = None
    if args.binding_towers:
        embedder = build_embedder(args.binding_towers, device=device,
                                  device_preprocess=args.device_preprocess)
    name = (args.served_model_name
            or os.path.basename(args.model_path.rstrip("/")) or "videollamb")
    httpd, srv = make_server(chat, engine, args.host, args.port,
                             k=args.sync_every, model_name=name,
                             embedder=embedder)
    print(f"serving on http://{args.host}:{httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    finally:
        srv.shutdown()


if __name__ == "__main__":
    main()
