"""OpenAI tool calling (function calling) over the serving engines.

The port's own copy of ``videollamb_tpu/serve/tools.py`` (plain Python and
numpy), with the same names and behaviour: the port imports nothing of the
JAX package.

The reference has no tool surface; this completes the OpenAI protocol on
top of the structured-output machinery (serve/schema.py):

- Tool definitions are injected into the system prompt as a documented
  JSON block plus the calling convention (emit
  ``{"name": ..., "arguments": {...}}``) — the standard recipe for
  models without native tool tokens.
- ``tool_choice``:
    "auto"  (default)  unconstrained decode; the response is parsed and
                       returned as ``tool_calls`` iff it is exactly a
                       call to a known tool;
    "none"             tools are shown but calling is disabled (never
                       parsed into tool_calls);
    "required"         decode is grammar-CONSTRAINED to the alternation
                       of every tool's call schema — the model cannot
                       emit anything but a valid call, and each tool's
                       ``arguments`` conform to that tool's parameter
                       schema (AltMachine dispatches on the forced
                       ``"name"`` const);
    {"type":"function","function":{"name":X}}
                       constrained to exactly tool X's call schema.
- Assistant history turns carrying ``tool_calls`` are re-rendered as the
  call JSON (what the model was asked to emit); ``tool`` role messages
  become the observation half of the next user turn.

Constrained calls inherit the budget-aware forced closing: a call is
always COMPLETE valid JSON with schema-valid arguments, even when the
token budget runs out mid-generation.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from videollamb_torch.serve.schema import SchemaError, compile_schema

TOOLS_PROMPT = """\

# Tools

You may call one of the following tools. To call a tool, reply with ONLY \
a JSON object of the form {{"name": <tool name>, "arguments": <arguments \
object>}} and nothing else. Otherwise reply normally.

{tool_lines}"""


def validate_tools(tools: Any) -> List[Dict[str, Any]]:
    """Normalize + validate the OpenAI ``tools`` list -> [{name,
    description, parameters}]. Raises ValueError (caller maps to 400) on
    malformed entries or parameter schemas outside the strict subset."""
    if not isinstance(tools, list) or not tools:
        raise ValueError("'tools' must be a non-empty list")
    out = []
    seen = set()
    for t in tools:
        if not isinstance(t, dict) or t.get("type") != "function":
            raise ValueError("each tool must be {'type': 'function', ...}")
        fn = t.get("function") or {}
        name = fn.get("name")
        if not name or not isinstance(name, str):
            raise ValueError("tool function.name is required")
        if json.dumps(name)[1:-1] != name:
            raise ValueError(f"tool name {name!r} needs JSON escaping")
        if name in seen:
            raise ValueError(f"duplicate tool name {name!r}")
        seen.add(name)
        params = fn.get("parameters")
        if params is None:
            params = {"type": "object", "properties": {}}
        try:
            compile_schema(params)
        except SchemaError as e:
            raise ValueError(f"tool {name!r} parameters: {e}") from e
        out.append({"name": name,
                    "description": fn.get("description") or "",
                    "parameters": params})
    return out


def render_tools_system(specs: Sequence[Dict[str, Any]]) -> str:
    """The system-prompt block describing the tools and call format."""
    lines = []
    for s in specs:
        lines.append(json.dumps(
            {"name": s["name"], "description": s["description"],
             "parameters": s["parameters"]},
            ensure_ascii=False))
    return TOOLS_PROMPT.format(tool_lines="\n".join(lines))


def call_schema(spec: Dict[str, Any]) -> Dict[str, Any]:
    """The schema of a call to one tool: name forced to the const, the
    arguments object conforming to the tool's parameter schema."""
    return {
        "type": "object",
        "properties": {
            "name": {"const": spec["name"]},
            "arguments": spec["parameters"],
        },
        "required": ["name", "arguments"],
        "additionalProperties": False,
    }


def call_schemas(
    specs: Sequence[Dict[str, Any]], name: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Schemas for a forced call: all tools ("required") or one (named
    tool_choice). Raises ValueError for an unknown name."""
    if name is not None:
        for s in specs:
            if s["name"] == name:
                return [call_schema(s)]
        raise ValueError(f"tool_choice names unknown tool {name!r}")
    return [call_schema(s) for s in specs]


def parse_tool_call(text: str,
                    names: Sequence[str]) -> Optional[Tuple[str, str]]:
    """If ``text`` is exactly one call to a known tool, return
    (name, arguments_json_string); else None. Arguments are re-serialized
    canonically so clients always get valid JSON in ``arguments``."""
    try:
        obj = json.loads(text)
    except ValueError:
        return None
    if not isinstance(obj, dict) or set(obj) != {"name", "arguments"}:
        return None
    if obj["name"] not in names:
        return None
    if not isinstance(obj["arguments"], dict):
        return None
    return obj["name"], json.dumps(obj["arguments"], ensure_ascii=False)


def tool_calls_payload(name: str, arguments: str,
                       call_id: str) -> List[Dict[str, Any]]:
    """The OpenAI response message.tool_calls list (single call)."""
    return [{"id": f"call_{call_id}", "type": "function",
             "function": {"name": name, "arguments": arguments}}]


def render_assistant_tool_calls(msg: Dict[str, Any]) -> str:
    """An assistant history turn that called tools -> the call JSON text
    (the exact format the system prompt asks the model to emit)."""
    calls = msg.get("tool_calls") or []
    parts = []
    for c in calls:
        fn = (c or {}).get("function") or {}
        try:
            args = json.loads(fn.get("arguments") or "{}")
        except ValueError:
            args = fn.get("arguments")
        parts.append(json.dumps({"name": fn.get("name"), "arguments": args},
                                ensure_ascii=False))
    return "\n".join(parts)


def render_tool_result(msg: Dict[str, Any]) -> str:
    """A ``tool`` role message -> observation text for the next user turn."""
    content = msg.get("content")
    if isinstance(content, list):  # content parts: concatenate text parts
        content = "\n".join(p.get("text", "") for p in content
                            if isinstance(p, dict))
    return f"[tool result] {content}"
