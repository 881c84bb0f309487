"""OpenAI-compatible API: request/response converters for the HTTP server.

A copy of ``videollamb_tpu/serve/openai_api.py``: host-only format
plumbing, with the constrained-decoding helpers taken from the port's
``serve/{schema,regex_grammar,tools}.py``.

The reference serves interactively (``llava/serve/cli.py``, gradio); this
framework's deployment surface is ``serve/http_server.py``. This module
makes that surface speak the OpenAI protocol so existing OpenAI clients
(the ``openai`` SDK, LangChain, curl recipes) drive the engines unchanged:

  POST /v1/chat/completions   messages (system/user/assistant turns,
      multimodal content parts) -> one engine request. ``model`` selects
      the base model or a served LoRA adapter by name (multi-LoRA routing,
      the vLLM convention). ``stop`` sequences are enforced server-side
      with incremental matching: a stream never emits text past (or any
      prefix of) a stop match, and the request's slot is cancelled the
      moment the stop hits — no dead decoding.
  POST /v1/completions        raw continuation (no chat template).
  GET  /v1/models             base model + live adapters.

Logprobs: chat takes ``logprobs: true`` (+ ``top_logprobs: 0-20``),
completions the legacy ``logprobs: N``. Values are the BASE model
distribution (f32 log-softmax of raw logits — temperature/top_p/stop
masks don't change what is reported), extracted on-device alongside the
engines' token sync (serve/server.logprobs_of). With server-side stop
sequences the logprob list covers all committed tokens, which can run a
token or two past the stop-truncated text.

Media parts accepted in user-message content lists:
  {"type": "image_url", "image_url": {"url": <path|file://|data:...>}}
  {"type": "video_url", "video_url": {"url": ...}}   (vLLM extension)
  {"type": "audio_url", "audio_url": {"url": ...}}
  {"type": "input_audio", "input_audio": {"data": <b64>, "format": "wav"}}
``data:`` URIs / ``input_audio`` are materialized to temp files for the
media loaders; callers clean up via the returned ``temp_paths``.

This module is pure host-side format plumbing: converters raise
``BadRequest`` with an OpenAI-style error payload; the HTTP layer maps it
to a status code. One medium per modality per request — that is the
engines' row schema (``serve/batch_cli.build_requests``), which mirrors
the reference's one-X-per-prompt assembly (llava/serve/cli.py:61-72).
"""

from __future__ import annotations

import base64
import binascii
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from videollamb_torch.constants import DEFAULT_X_TOKEN

# OpenAI part type -> (modality key, url field) for URL-carrying parts.
_URL_PARTS = {
    "image_url": ("IMAGE", "image_url"),
    "video_url": ("VIDEO", "video_url"),
    "audio_url": ("AUDIO", "audio_url"),
}

_DATA_SUFFIX = {"image": ".png", "video": ".mp4", "audio": ".wav"}


class BadRequest(Exception):
    """Client error -> HTTP 4xx with an OpenAI error body."""

    def __init__(self, message: str, code: Optional[str] = None,
                 status: int = 400):
        super().__init__(message)
        self.code = code
        self.status = status


def error_body(message: str, code: Optional[str] = None) -> Dict[str, Any]:
    return {"error": {"message": message, "type": "invalid_request_error",
                      "code": code}}


def _materialize_url(url: str, kind: str,
                     temp_paths: List[str]) -> str:
    """data: URIs become temp files; file:// and plain paths pass through."""
    if url.startswith("data:"):
        try:
            header, payload = url.split(",", 1)
            raw = base64.b64decode(payload, validate=True)
        except (ValueError, binascii.Error) as e:
            raise BadRequest(f"bad data: URI for {kind}: {e}") from e
        mime = header[len("data:"):].split(";")[0]  # e.g. image/png
        suffix = ("." + mime.split("/", 1)[1] if "/" in mime
                  else _DATA_SUFFIX.get(kind, ""))
        f = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
        f.write(raw)
        f.close()
        temp_paths.append(f.name)
        return f.name
    if url.startswith("file://"):
        return url[len("file://"):]
    return url


def _content_to_text_and_media(
    content: Any, media: Dict[str, str], temp_paths: List[str],
) -> str:
    """One message's content -> text with inline <image>/<video>/<audio>
    tags where media parts appeared (tag order = splice block order)."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    if not isinstance(content, list):
        raise BadRequest("message content must be a string or a list of parts")
    pieces: List[str] = []
    for part in content:
        if not isinstance(part, dict):
            raise BadRequest("content parts must be objects")
        ptype = part.get("type")
        if ptype == "text":
            pieces.append(part.get("text", ""))
        elif ptype in _URL_PARTS:
            modality, field = _URL_PARTS[ptype]
            spec = part.get(field)
            url = spec.get("url") if isinstance(spec, dict) else spec
            if not url:
                raise BadRequest(f"part {ptype!r} is missing its url")
            if modality in media:
                raise BadRequest(
                    f"more than one {modality.lower()} attached — the model "
                    "binds one medium per modality per request")
            media[modality] = _materialize_url(
                url, modality.lower(), temp_paths)
            pieces.append(DEFAULT_X_TOKEN[modality])
        elif ptype == "input_audio":
            spec = part.get("input_audio") or {}
            data = spec.get("data")
            if not data:
                raise BadRequest("input_audio part is missing 'data'")
            if "AUDIO" in media:
                raise BadRequest("more than one audio attached")
            fmt = spec.get("format", "wav")
            media["AUDIO"] = _materialize_url(
                f"data:audio/{fmt};base64,{data}", "audio", temp_paths)
            pieces.append(DEFAULT_X_TOKEN["AUDIO"])
        else:
            raise BadRequest(f"unsupported content part type {ptype!r}")
    return "\n".join(p for p in pieces if p)


def resolve_model(body: Dict[str, Any], served_model: str,
                  adapters: List[str]) -> Optional[str]:
    """OpenAI ``model`` -> adapter name (None = base). Unknown -> 404,
    matching the OpenAI API's model_not_found behavior."""
    model = body.get("model") or served_model
    if model == served_model:
        return None
    if model in adapters:
        return model
    raise BadRequest(f"model {model!r} not found (served: {served_model}"
                     + (f", adapters: {', '.join(adapters)}" if adapters
                        else "") + ")",
                     code="model_not_found", status=404)


def _validate_regex(pattern) -> None:
    if not isinstance(pattern, str) or not pattern:
        raise BadRequest("a non-empty regex pattern string is required")
    from videollamb_torch.serve.regex_grammar import RegexError, RegexMachine

    try:
        RegexMachine(pattern)
    except RegexError as e:
        raise BadRequest(f"unsupported regex: {e}")


def _common_params(body: Dict[str, Any], row: Dict[str, Any],
                   tools_ok: bool = False) -> List[str]:
    """Sampling/limit params shared by both endpoints; returns stops."""
    n = body.get("n", 1) or 1
    if not isinstance(n, int) or not 1 <= n <= 8:
        raise BadRequest("'n' must be an integer between 1 and 8")
    if body.get("functions"):
        raise BadRequest("legacy 'functions' is not supported — use 'tools'")
    if body.get("tools") and not tools_ok:
        raise BadRequest("tools are only supported on /v1/chat/completions")
    fmt = (body.get("response_format") or {}).get("type", "text")
    if fmt == "json_object":
        # Grammar-constrained decoding (serve/grammar.py): the output is
        # guaranteed to parse as a JSON object, budget-closed.
        row["response_format"] = "json_object"
    elif fmt == "json_schema":
        # Structured outputs (serve/schema.py): schema-enforced decode.
        # Compile here (cheap, tokenizer-free) so unsupported schema
        # features 400 instead of erroring at admission.
        spec = (body["response_format"].get("json_schema") or {})
        schema = spec.get("schema")
        if not isinstance(schema, (dict, bool)):
            raise BadRequest("response_format.json_schema.schema is required")
        from videollamb_torch.serve.schema import SchemaError, compile_schema

        try:
            compile_schema(schema)
        except SchemaError as e:
            raise BadRequest(f"unsupported json_schema: {e}")
        row["response_format"] = {"type": "json_schema", "schema": schema}
    elif fmt == "regex":
        # Regex-constrained decoding (serve/regex_grammar.py): the output
        # full-matches the pattern, budget-closed. Compile here (cheap,
        # tokenizer-free) so unsupported constructs 400 at parse.
        pattern = body["response_format"].get("regex")
        _validate_regex(pattern)
        row["response_format"] = {"type": "regex", "regex": pattern}
    elif fmt != "text":
        raise BadRequest(f"response_format {fmt!r} is not supported")
    if body.get("guided_regex"):
        # vLLM-convention alias for response_format {"type": "regex"}.
        if row.get("response_format"):
            raise BadRequest(
                "guided_regex cannot be combined with response_format")
        pattern = body["guided_regex"]
        _validate_regex(pattern)
        row["response_format"] = {"type": "regex", "regex": pattern}
    row["max_new_tokens"] = int(
        body.get("max_completion_tokens") or body.get("max_tokens") or 128)
    row["temperature"] = float(body.get("temperature", 0.0) or 0.0)
    row["top_p"] = float(body.get("top_p", 1.0) or 1.0)
    # Sampling controls (per-step path in the engines; see Request docs).
    for pen in ("presence_penalty", "frequency_penalty"):
        if body.get(pen):
            val = float(body[pen])
            if not -2.0 <= val <= 2.0:
                raise BadRequest(f"'{pen}' must be between -2.0 and 2.0")
            row[pen] = val
    if body.get("logit_bias"):
        lb = body["logit_bias"]
        if not isinstance(lb, dict):
            raise BadRequest("'logit_bias' must map token ids to biases")
        try:
            row["logit_bias"] = {
                int(t): max(-100.0, min(100.0, float(b)))
                for t, b in lb.items()}
        except (TypeError, ValueError):
            raise BadRequest("'logit_bias' keys must be token ids")
    # Extensions (vLLM convention): min_tokens, top_k.
    if body.get("min_tokens"):
        row["min_tokens"] = int(body["min_tokens"])
    if body.get("top_k"):
        row["top_k"] = int(body["top_k"])
    # Logprob extraction (per-endpoint semantics resolved by the caller
    # into row["logprobs"] bool + row["top_logprobs"] int; the engines cap
    # alternatives at serve/server.TOP_LOGPROBS_K = 20, the OpenAI max).
    # ("seed" is accepted but ignored: the engine RNG is per-process, the
    # OpenAI contract for seed is best-effort anyway.)
    # Extension: constrained decoding rides through (serve/constrained.py).
    if body.get("choices") and isinstance(body["choices"], list):
        row["choices"] = body["choices"]
    stop = body.get("stop")
    if stop is None:
        return []
    stops = [stop] if isinstance(stop, str) else list(stop)
    if not all(isinstance(s, str) and s for s in stops):
        raise BadRequest("'stop' must be a non-empty string or a list of them")
    return stops


def row_from_chat_completions(
    body: Dict[str, Any], served_model: str, adapters: List[str],
) -> Tuple[Dict[str, Any], List[str], List[str]]:
    """Chat-completions body -> (engine row, stop sequences, temp paths).

    Conversation mapping: the (optional, leading) system message replaces
    the template's system prompt; alternating user/assistant turns become
    the row's ``history``; the final message must be from the user and
    becomes the prompt. Media may appear in any user turn (tags stay where
    the parts appeared, so the splice binds blocks in conversation order).
    """
    adapter = resolve_model(body, served_model, adapters)
    messages = body.get("messages")
    if not messages or not isinstance(messages, list):
        raise BadRequest("'messages' must be a non-empty list")

    temp_paths: List[str] = []
    media: Dict[str, str] = {}
    row: Dict[str, Any] = {}
    try:
        turns: List[Tuple[str, str]] = []  # (role, text)
        for i, msg in enumerate(messages):
            role = msg.get("role")
            if role == "system":
                if i != 0:
                    raise BadRequest("system message must come first")
                row["system"] = _content_to_text_and_media(
                    msg.get("content"), media, temp_paths)
                continue
            if role == "assistant" and msg.get("tool_calls"):
                from videollamb_torch.serve import tools as toolmod

                turns.append(
                    ("assistant", toolmod.render_assistant_tool_calls(msg)))
                continue
            if role == "tool":
                from videollamb_torch.serve import tools as toolmod

                # A tool result is (part of) the next user-side turn — it
                # may itself be the final message (the standard second
                # round of a tool-calling loop).
                turns.append(("user", toolmod.render_tool_result(msg)))
                continue
            if role not in ("user", "assistant"):
                raise BadRequest(f"unsupported role {role!r}")
            turns.append((role, _content_to_text_and_media(
                msg.get("content"), media, temp_paths)))
        # Merge consecutive same-role turns (tool results + follow-up user
        # text form one user turn).
        merged: List[Tuple[str, str]] = []
        for role, text in turns:
            if merged and merged[-1][0] == role:
                merged = merged[:-1] + [(role, merged[-1][1] + "\n" + text)]
            else:
                merged.append((role, text))
        turns = merged
        if not turns or turns[-1][0] != "user":
            raise BadRequest("the last message must be from the user")
        history: List[List[Optional[str]]] = []
        i = 0
        while i < len(turns) - 1:
            if turns[i][0] != "user" or turns[i + 1][0] != "assistant":
                raise BadRequest(
                    "messages must alternate user/assistant and end with "
                    "a user message")
            history.append([turns[i][1], turns[i + 1][1]])
            i += 2
        row["prompt"] = turns[-1][1]
        if history:
            row["history"] = history
        if body.get("top_logprobs") is not None and not body.get("logprobs"):
            raise BadRequest("'top_logprobs' requires 'logprobs': true")
        if body.get("logprobs"):
            row["logprobs"] = True
            n = int(body.get("top_logprobs") or 0)
            if not 0 <= n <= 20:
                raise BadRequest("'top_logprobs' must be between 0 and 20")
            row["top_logprobs"] = n
        for modality, path in media.items():
            row[modality.lower()] = path  # VIDEO->"video", IMAGE->"image", ...
        if body.get("shared_prefix"):
            # Extension param (paged engine): cache the system+media prompt
            # prefix across requests (serve/paged.py automatic prefix
            # caching) — repeated questions about the same video skip its
            # tower/bridge/prefill cost after the first request.
            if not media:
                raise BadRequest("'shared_prefix' requires media content "
                                 "(the shared part is system + media)")
            row["shared_prefix"] = True
        if adapter is not None:
            row["adapter"] = adapter
        stops = _common_params(body, row, tools_ok=True)
        _apply_tools(body, row)
        return row, stops, temp_paths
    except BadRequest:
        _cleanup(temp_paths)
        raise


def _apply_tools(body: Dict[str, Any], row: Dict[str, Any]) -> None:
    """OpenAI ``tools`` / ``tool_choice`` -> system-prompt injection +
    (for forced modes) a grammar-constrained call format (serve/tools.py).
    Adds ``row["_tools"]`` metadata the HTTP layer uses to parse the
    completion into ``message.tool_calls``."""
    tools = body.get("tools")
    if not tools:
        if body.get("tool_choice") not in (None, "auto", "none"):
            raise BadRequest("tool_choice given without tools")
        return
    from videollamb_torch.serve import tools as toolmod

    try:
        specs = toolmod.validate_tools(tools)
    except ValueError as e:
        raise BadRequest(str(e))
    choice = body.get("tool_choice", "auto")
    forced_name = None
    if isinstance(choice, dict):
        forced_name = (choice.get("function") or {}).get("name")
        if choice.get("type") != "function" or not forced_name:
            raise BadRequest(
                "tool_choice object must be "
                "{'type': 'function', 'function': {'name': ...}}")
        mode = "forced"
    elif choice in ("auto", "none", "required"):
        mode = choice
    else:
        raise BadRequest(f"unsupported tool_choice {choice!r}")
    row["system_suffix"] = toolmod.render_tools_system(specs)
    if mode in ("required", "forced"):
        if row.get("response_format"):
            raise BadRequest(
                "response_format cannot be combined with a forced "
                "tool_choice (the call format IS the response format)")
        try:
            schemas = toolmod.call_schemas(specs, forced_name)
        except ValueError as e:
            raise BadRequest(str(e))
        row["response_format"] = {"type": "tool_call", "schemas": schemas}
    if mode != "none":
        row["_tools"] = {"names": [s["name"] for s in specs],
                         "forced": mode in ("required", "forced")}


def row_from_completions(
    body: Dict[str, Any], served_model: str, adapters: List[str],
) -> Tuple[Dict[str, Any], List[str]]:
    """Legacy completions body -> (raw engine row, stop sequences)."""
    adapter = resolve_model(body, served_model, adapters)
    prompt = body.get("prompt")
    if isinstance(prompt, list):
        if len(prompt) != 1 or not isinstance(prompt[0], str):
            raise BadRequest("only a single string prompt is supported")
        prompt = prompt[0]
    if not isinstance(prompt, str) or not prompt:
        raise BadRequest("'prompt' must be a non-empty string")
    row: Dict[str, Any] = {"prompt": prompt, "raw": True}
    if adapter is not None:
        row["adapter"] = adapter
    stops = _common_params(body, row)
    if body.get("echo"):
        raise BadRequest("'echo' is not supported")
    # Legacy completions semantics: "logprobs": N means return the chosen
    # token's logprob plus the top-N alternatives per position.
    if body.get("logprobs") is not None:
        n = int(body["logprobs"])
        if not 0 <= n <= 20:
            raise BadRequest("'logprobs' must be between 0 and 20")
        row["logprobs"] = True
        row["top_logprobs"] = n
    return row, stops


def _cleanup(paths: List[str]) -> None:
    import os

    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


class StopMatcher:
    """Incremental stop-sequence matching for streams.

    ``feed(piece)`` returns (text safe to emit now, matched?). Text that
    could still grow into a stop match is held back, so a client never
    sees any prefix of a stop sequence; on a match everything before the
    match is released and the held remainder is dropped. ``flush()``
    releases the held tail at end-of-stream (it turned out not to be a
    stop after all)."""

    def __init__(self, stops: List[str]):
        self.stops = stops
        self._held = ""
        self.matched = False

    def feed(self, piece: str) -> Tuple[str, bool]:
        if self.matched:
            return "", True
        buf = self._held + piece
        cut = min((buf.find(s) for s in self.stops if s in buf), default=-1)
        if cut >= 0:
            self.matched = True
            self._held = ""
            return buf[:cut], True
        # Longest suffix of buf that is a proper prefix of some stop.
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(buf)), hold, -1):
                if buf.endswith(s[:k]):
                    hold = k
                    break
        self._held = buf[len(buf) - hold:] if hold else ""
        return buf[: len(buf) - hold] if hold else buf, False

    def flush(self) -> str:
        out, self._held = self._held, ""
        return out


def _tok_entry(tokenizer, token_id: int, logprob: float) -> Dict[str, Any]:
    s = tokenizer.decode([token_id])
    return {"token": s, "logprob": logprob, "bytes": list(s.encode())}


def chat_logprob_entry(tokenizer, token_id: int, logprob: float,
                       top_pairs, top_n: int) -> Dict[str, Any]:
    """One position of the chat-completions logprobs.content list."""
    entry = _tok_entry(tokenizer, token_id, logprob)
    entry["top_logprobs"] = [_tok_entry(tokenizer, i, lp)
                             for i, lp in (top_pairs or [])[:top_n]]
    return entry


def chat_logprobs(tokenizer, token_ids, token_logprobs, top_tokens,
                  top_n: int) -> Dict[str, Any]:
    """Chat-completions response logprobs object. With server-side stop
    sequences the list covers all committed tokens, which can extend a
    token or two past the stop-truncated text."""
    return {"content": [
        chat_logprob_entry(tokenizer, tid, lp,
                           top_tokens[i] if i < len(top_tokens) else None,
                           top_n)
        for i, (tid, lp) in enumerate(zip(token_ids, token_logprobs))]}


def completion_logprobs(tokenizer, token_ids, token_logprobs,
                        top_tokens, top_n: int) -> Dict[str, Any]:
    """Legacy completions logprobs object (tokens / token_logprobs /
    top_logprobs / text_offset, offsets relative to the completion)."""
    tokens, offsets, off = [], [], 0
    for tid in token_ids:
        s = tokenizer.decode([tid])
        tokens.append(s)
        offsets.append(off)
        off += len(s)
    top = None
    if top_n > 0:
        top = [{tokenizer.decode([i]): lp for i, lp in (tt or [])[:top_n]}
               for tt in top_tokens]
        top += [{}] * (len(tokens) - len(top))
    return {"tokens": tokens, "token_logprobs": list(token_logprobs),
            "top_logprobs": top, "text_offset": offsets}


def usage_dict(prompt_tokens: int, completion_tokens: int) -> Dict[str, int]:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


def chat_choice(index: int, text: str, finish_reason: str,
                logprobs: Optional[Dict[str, Any]] = None,
                tool_calls: Optional[List[Dict[str, Any]]] = None
                ) -> Dict[str, Any]:
    message: Dict[str, Any] = {"role": "assistant", "content": text}
    if tool_calls is not None:
        message = {"role": "assistant", "content": None,
                   "tool_calls": tool_calls}
        finish_reason = "tool_calls"
    return {"index": index, "message": message, "logprobs": logprobs,
            "finish_reason": finish_reason}


def completion_choice(index: int, text: str, finish_reason: str,
                      logprobs: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    return {"index": index, "text": text, "logprobs": logprobs,
            "finish_reason": finish_reason}


def chat_completion_response(
    rid: str, model: str, text: str, finish_reason: str,
    usage: Dict[str, int], logprobs: Optional[Dict[str, Any]] = None,
    tool_calls: Optional[List[Dict[str, Any]]] = None,
    choices: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Single-choice by default; ``choices`` overrides for n>1 (each built
    with chat_choice)."""
    if choices is None:
        choices = [chat_choice(0, text, finish_reason, logprobs, tool_calls)]
    return {
        "id": f"chatcmpl-{rid}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": usage,
    }


def chat_completion_chunk(
    rid: str, model: str, delta: Dict[str, Any],
    finish_reason: Optional[str],
    logprobs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    return {
        "id": f"chatcmpl-{rid}",
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "delta": delta, "logprobs": logprobs,
                     "finish_reason": finish_reason}],
    }


def completion_response(
    rid: str, model: str, text: str, finish_reason: str,
    usage: Dict[str, int], logprobs: Optional[Dict[str, Any]] = None,
    choices: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    if choices is None:
        choices = [completion_choice(0, text, finish_reason, logprobs)]
    return {
        "id": f"cmpl-{rid}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": usage,
    }


def completion_chunk(
    rid: str, model: str, text: str, finish_reason: Optional[str],
    logprobs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    return {
        "id": f"cmpl-{rid}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "text": text, "logprobs": logprobs,
                     "finish_reason": finish_reason}],
    }


def models_response(served_model: str, adapters: List[str]) -> Dict[str, Any]:
    now = int(time.time())
    data = [{"id": served_model, "object": "model", "created": now,
             "owned_by": "videollamb-tpu"}]
    data += [{"id": a, "object": "model", "created": now,
              "owned_by": "videollamb-tpu", "parent": served_model}
             for a in adapters]
    return {"object": "list", "data": data}
