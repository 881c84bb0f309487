"""Structured outputs: JSON-Schema-constrained decoding (strict mode).

The port's own copy of ``videollamb_tpu/serve/schema.py`` (plain Python and
numpy), with the same names and behaviour: the port imports nothing of the
JAX package.

Extends the guaranteed-valid-JSON machinery (serve/grammar.py) to the
OpenAI ``response_format: {"type": "json_schema"}`` contract: the engine
cannot emit output that violates the schema — keys are forced
character-by-character, required properties cannot be skipped, value
types are enforced, and the budget-aware forced closing still guarantees
a COMPLETE schema-valid document within any token budget.

Semantics follow OpenAI strict structured outputs:

- objects: properties are emitted in schema declaration order; required
  properties are mandatory; optional properties may be skipped (but
  never reordered); ``additionalProperties`` must be false/absent;
- arrays: ``items`` schema enforced; ``minItems``/``maxItems`` honored;
- scalars: string / number / integer / boolean / null; ``enum`` and
  ``const`` are matched against their exact JSON texts;
- ``anyOf`` / ``type: [...]`` unions are supported when the branches are
  distinguishable by their first character (objects vs strings vs
  numbers vs null...), which covers the common nullable-field pattern;
- local ``$ref`` into ``$defs``/``definitions`` resolves by inlining
  (recursive schemas are rejected: the closing cost would be unbounded);
- unenforced annotations (``minLength``, ``pattern``, ``format``,
  numeric ranges, ``description``...) are accepted and ignored, like
  every production structured-output implementation built on automata.

Design: a :class:`SchemaMachine` subclasses the character-level
JsonMachine, pushing schema-aware container frames
``('O', node, last_prop_idx)`` / ``('A', node, items_done)`` whose
closing costs cover the *remaining required structure* (e.g. an object
frame's cost includes every required property not yet emitted, keys and
minimal values). The closing-cost invariant — stepping the closing char
lowers cost by exactly 1 — is preserved for every new state kind, so the
same GrammarTable / GrammarConstraint drive it (test_schema.py fuzzes
the invariant over reachable states of many schemas).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from videollamb_torch.serve.grammar import (
    _END,
    _WS,
    GrammarConstraint,
    GrammarTable,
    JsonMachine,
)


class SchemaError(ValueError):
    """The schema uses a feature outside the supported strict subset."""


# Compiled node layouts (plain tuples, hashable):
#   ('object', props)        props: tuple of (name, node_id, required)
#   ('array', items, lo, hi) hi None = unbounded
#   ('string',) ('number',) ('integer',) ('boolean',) ('null',) ('any',)
#   ('enum', texts)          texts: tuple of exact JSON texts, prefix-free
#   ('union', alt_ids)       first-char-disjoint alternatives


class CompiledSchema:
    def __init__(self):
        self.nodes: List[tuple] = []
        self.root: int = 0                # set by compile_schema
        self._cost: List[int] = []        # min completion chars per node
        self._first: List[str] = []       # first char of the min completion
        self._starts: List[frozenset] = []  # legal first chars per node

    def add(self, node: tuple) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    # -- per-node minimal completions (computed bottom-up: children are
    # always compiled before their parents, so plain recursion works) ---
    def finalize(self) -> None:
        n = len(self.nodes)
        self._cost = [0] * n
        self._first = [""] * n
        self._starts = [frozenset()] * n
        memo_c: Dict[int, int] = {}

        def cost(i: int) -> int:
            if i in memo_c:
                return memo_c[i]
            node = self.nodes[i]
            kind = node[0]
            if kind == "object":
                req = [(name, nid) for name, nid, r in node[1] if r]
                c = 2 + sum(len(name) + 2 + 1 + cost(nid) for name, nid in req)
                c += max(0, len(req) - 1)
            elif kind == "array":
                _, items, lo, _ = node
                c = 2 + lo * cost(items) + max(0, lo - 1)
            elif kind == "string":
                c = 2
            elif kind == "enum":
                c = min(len(t) for t in node[1])
            elif kind in ("number", "integer", "any"):
                c = 1
            elif kind in ("boolean", "null"):
                c = 4
            else:  # union
                c = min(cost(a) for a in node[1])
            memo_c[i] = c
            return c

        for i in range(n):
            self._cost[i] = cost(i)
        for i, node in enumerate(self.nodes):
            kind = node[0]
            if kind == "object":
                self._first[i], self._starts[i] = "{", frozenset("{")
            elif kind == "array":
                self._first[i], self._starts[i] = "[", frozenset("[")
            elif kind == "string":
                self._first[i], self._starts[i] = '"', frozenset('"')
            elif kind == "enum":
                best = min(node[1], key=len)
                self._first[i] = best[0]
                self._starts[i] = frozenset(t[0] for t in node[1])
            elif kind in ("number", "integer"):
                self._first[i], self._starts[i] = "0", frozenset("-0123456789")
            elif kind == "boolean":
                self._first[i], self._starts[i] = "t", frozenset("tf")
            elif kind == "null":
                self._first[i], self._starts[i] = "n", frozenset("n")
            elif kind == "any":
                self._first[i] = "0"
                self._starts[i] = frozenset('{["-0123456789tfn')
            else:  # union
                alts = node[1]
                best = min(alts, key=lambda a: self._cost[a])
                self._first[i] = self._first[best]
                self._starts[i] = frozenset().union(
                    *(self._starts[a] for a in alts))

    def cost(self, i: int) -> int:
        return self._cost[i]

    def first_char(self, i: int) -> str:
        return self._first[i]

    def starts(self, i: int) -> frozenset:
        return self._starts[i]


def _resolve_ref(schema: dict, root: dict, seen: frozenset) -> Tuple[dict, frozenset]:
    while isinstance(schema, dict) and "$ref" in schema:
        ref = schema["$ref"]
        if ref in seen:
            raise SchemaError(f"recursive $ref {ref!r} (closing cost "
                              "would be unbounded)")
        seen = seen | {ref}
        if not ref.startswith("#/"):
            raise SchemaError(f"only local $ref supported, got {ref!r}")
        node = root
        for part in ref[2:].split("/"):
            part = part.replace("~1", "/").replace("~0", "~")
            if not isinstance(node, dict) or part not in node:
                raise SchemaError(f"unresolvable $ref {ref!r}")
            node = node[part]
        schema = node
    return schema, seen


def compile_schema(schema, root=None) -> CompiledSchema:
    """Compile a JSON Schema (strict subset) into node tables."""
    cs = CompiledSchema()
    root = root if root is not None else schema

    def build(s, seen=frozenset()) -> int:
        if s is True or s == {}:
            return cs.add(("any",))
        if not isinstance(s, dict):
            raise SchemaError(f"unsupported schema: {s!r}")
        s, seen = _resolve_ref(s, root, seen)
        if "enum" in s or "const" in s:
            values = s["enum"] if "enum" in s else [s["const"]]
            if not values:
                raise SchemaError("empty enum")
            texts = tuple(json.dumps(v, ensure_ascii=True, sort_keys=True,
                                     separators=(",", ":")) for v in values)
            for a in texts:
                for b in texts:
                    if a != b and b.startswith(a):
                        raise SchemaError(
                            f"enum texts {a!r}/{b!r} are prefix-ambiguous")
            if len(set(texts)) != len(texts):
                raise SchemaError("duplicate enum values")
            if any(isinstance(v, (dict, list)) for v in values):
                raise SchemaError("enum of containers is not supported")
            return cs.add(("enum", texts))
        if "anyOf" in s or "oneOf" in s:
            alts = s.get("anyOf") or s.get("oneOf")
            return _union([build(a, seen) for a in alts])
        t = s.get("type")
        if isinstance(t, (list, tuple)):
            ids = [build({**s, "type": one}, seen) for one in t]
            return _union(ids)
        if t == "object":
            props_def = s.get("properties") or {}
            required = set(s.get("required") or [])
            unknown_req = required - set(props_def)
            if unknown_req:
                raise SchemaError(f"required names {sorted(unknown_req)} "
                                  "missing from properties")
            if s.get("additionalProperties") not in (None, False):
                raise SchemaError("additionalProperties must be false in "
                                  "strict mode")
            props = []
            for name, sub in props_def.items():
                if json.dumps(name)[1:-1] != name:
                    raise SchemaError(
                        f"property name {name!r} needs JSON escaping — "
                        "unsupported in key forcing")
                props.append((name, build(sub, seen), name in required))
            nid = cs.add(("object", tuple(props)))
            return nid
        if t == "array":
            lo = int(s.get("minItems") or 0)
            hi = s.get("maxItems")
            hi = int(hi) if hi is not None else None
            if hi is not None and hi < lo:
                raise SchemaError("maxItems < minItems")
            items = build(s.get("items", True), seen)
            return cs.add(("array", items, lo, hi))
        if t == "string":
            return cs.add(("string",))
        if t in ("number", "integer", "boolean", "null"):
            return cs.add((t,))
        if t is None:
            return cs.add(("any",))
        raise SchemaError(f"unsupported type {t!r}")

    def _union(ids: List[int]) -> int:
        return cs.add(("union", tuple(ids)))

    cs.root = build(schema)  # children compile before parents: root is last
    cs.finalize()
    # Union branches must be first-char disjoint (else the machine can't
    # dispatch deterministically).
    for node in cs.nodes:
        if node[0] == "union":
            seen_chars: set = set()
            for a in node[1]:
                overlap = seen_chars & set(cs.starts(a))
                if overlap:
                    raise SchemaError(
                        "union branches are ambiguous on first char(s) "
                        f"{sorted(overlap)}")
                seen_chars |= set(cs.starts(a))
    return cs


class SchemaMachine(JsonMachine):
    """Character-level machine accepting exactly the schema's documents.

    New state kinds (beyond JsonMachine's, which still serve free-form
    'any' values and generic strings/numbers/literals):
      ('sval', stack, nid)               expecting a value of node nid
      ('oopen', stack)                   after '{'; top frame ('O',nid,-1)
      ('onext', stack, min_idx)          after ',' in a schema object
      ('okey', stack, min_idx, prefix)   inside a forced key
      ('ocolon', stack, idx)             key matched, expecting ':'
      ('aopen', stack)                   after '['; top frame ('A',nid,0)
      ('aval', stack)                    after ',' in a schema array
      ('safter', stack)                  value complete inside schema frame
      ('senum', stack, nid, prefix)      inside an enum/const literal
      ('inum', stack, sub)               integer (no frac/exp)
    """

    def __init__(self, cs: CompiledSchema, max_depth: int = 16):
        super().__init__(top_object=False, max_depth=max_depth)
        self.cs = cs
        self.start = ("sval", (), cs.root)

    # -- frame hooks -----------------------------------------------------
    def _after_value(self, stack: tuple):
        if not stack:
            return _END
        return ("after", stack) if stack[-1] in ("o", "a") else (
            "safter", stack)

    def _rem_object(self, nid: int, last_idx: int) -> int:
        """Chars to close an object whose last emitted property index is
        ``last_idx`` (each remaining required prop: ',' + key + ':' +
        minimal value; then '}')."""
        props = self.cs.nodes[nid][1]
        c = 1  # '}'
        for i in range(last_idx + 1, len(props)):
            name, sub, req = props[i]
            if req:
                c += 1 + (len(name) + 2) + 1 + self.cs.cost(sub)
        return c

    def _rem_array(self, nid: int, done: int) -> int:
        _, items, lo, _ = self.cs.nodes[nid]
        need = max(0, lo - done)
        return 1 + need * (1 + self.cs.cost(items))

    def _frame_close_cost(self, frame) -> int:
        if frame == "o" or frame == "a":
            return 1
        if frame[0] == "O":
            return self._rem_object(frame[1], frame[2])
        return self._rem_array(frame[1], frame[2] + 1)

    def _frame_close_char(self, frame) -> str:
        if frame == "o":
            return "}"
        if frame == "a":
            return "]"
        if frame[0] == "O":
            nid, i = frame[1], frame[2]
            props = self.cs.nodes[nid][1]
            req_left = any(r for _, _, r in props[i + 1:])
            return "," if req_left else "}"
        nid, k = frame[1], frame[2]
        lo = self.cs.nodes[nid][2]
        return "," if k + 1 < lo else "]"

    # -- helpers ----------------------------------------------------------
    def _admissible(self, nid: int, min_idx: int):
        """Properties emittable next: in order from min_idx, optional ones
        may be skipped but the first required one blocks everything after
        it. Yields (idx, name, sub_nid, required)."""
        props = self.cs.nodes[nid][1]
        for i in range(min_idx, len(props)):
            name, sub, req = props[i]
            yield i, name, sub, req
            if req:
                return

    def _enter_value(self, stack: tuple, nid: int, ch: str):
        node = self.cs.nodes[nid]
        kind = node[0]
        if kind == "any":
            return self._value_start(stack, ch)
        if kind == "object":
            return ("oopen", stack + (("O", nid, -1),)) if ch == "{" else None
        if kind == "array":
            return ("aopen", stack + (("A", nid, 0),)) if ch == "[" else None
        if kind == "string":
            return ("str", stack, "v") if ch == '"' else None
        if kind == "enum":
            return self._senum(stack, nid, "", ch)
        if kind == "number":
            if ch == "-":
                return ("num", stack, "minus")
            if ch == "0":
                return ("num", stack, "zero")
            return ("num", stack, "int") if ch in "123456789" else None
        if kind == "integer":
            if ch == "-":
                return ("inum", stack, "minus")
            if ch == "0":
                return ("inum", stack, "zero")
            return ("inum", stack, "int") if ch in "123456789" else None
        if kind == "boolean":
            if ch == "t":
                return ("lit", stack, "true", 1)
            return ("lit", stack, "false", 1) if ch == "f" else None
        if kind == "null":
            return ("lit", stack, "null", 1) if ch == "n" else None
        # union: first-char-disjoint, so at most one branch accepts
        for alt in node[1]:
            if ch in self.cs.starts(alt):
                return self._enter_value(stack, alt, ch)
        return None

    def _senum(self, stack: tuple, nid: int, prefix: str, ch: str):
        texts = self.cs.nodes[nid][1]
        p2 = prefix + ch
        if p2 in texts:  # prefix-free: nothing else can extend it
            return self._after_value(stack)
        if any(t.startswith(p2) for t in texts):
            return ("senum", stack, nid, p2)
        return None

    # -- transitions -------------------------------------------------------
    def step(self, st, ch: str):
        kind = st[0]
        if kind == "sval":
            _, stack, nid = st
            if ch in _WS:
                return st
            return self._enter_value(stack, nid, ch)
        if kind == "oopen":
            stack = st[1]
            frame = stack[-1]
            nid = frame[1]
            props = self.cs.nodes[nid][1]
            if ch in _WS:
                return st
            if ch == "}":
                if any(r for _, _, r in props):
                    return None
                return self._after_value(stack[:-1])
            if ch == '"' and props:
                return ("okey", stack, 0, "")
            return None
        if kind == "onext":
            _, stack, min_idx = st
            if ch in _WS:
                return st
            return ("okey", stack, min_idx, "") if ch == '"' else None
        if kind == "okey":
            _, stack, min_idx, prefix = st
            nid = stack[-1][1]
            cands = list(self._admissible(nid, min_idx))
            if ch == '"':
                for i, name, sub, _ in cands:
                    if name == prefix:
                        return ("ocolon", stack, i)
                return None
            p2 = prefix + ch
            if any(name.startswith(p2) for _, name, _, _ in cands):
                return ("okey", stack, min_idx, p2)
            return None
        if kind == "ocolon":
            _, stack, i = st
            if ch in _WS:
                return st
            if ch != ":":
                return None
            frame = stack[-1]
            nid = frame[1]
            sub = self.cs.nodes[nid][1][i][1]
            stack2 = stack[:-1] + (("O", nid, i),)
            return ("sval", stack2, sub)
        if kind == "safter":
            stack = st[1]
            frame = stack[-1]
            if ch in _WS:
                return st
            if frame[0] == "O":
                nid, i = frame[1], frame[2]
                props = self.cs.nodes[nid][1]
                if ch == ",":
                    return ("onext", stack, i + 1) if i + 1 < len(props) else None
                if ch == "}":
                    if any(r for _, _, r in props[i + 1:]):
                        return None
                    return self._after_value(stack[:-1])
                return None
            nid, k = frame[1], frame[2]
            _, items, lo, hi = self.cs.nodes[nid]
            done = k + 1
            if ch == ",":
                if hi is not None and done >= hi:
                    return None
                return ("aval", stack[:-1] + (("A", nid, done),))
            if ch == "]":
                return self._after_value(stack[:-1]) if done >= lo else None
            return None
        if kind == "aopen":
            stack = st[1]
            frame = stack[-1]
            nid = frame[1]
            _, items, lo, hi = self.cs.nodes[nid]
            if ch in _WS:
                return st
            if ch == "]":
                return self._after_value(stack[:-1]) if lo == 0 else None
            if hi is not None and hi == 0:
                return None
            return self._enter_value(stack, items, ch)
        if kind == "aval":
            stack = st[1]
            items = self.cs.nodes[stack[-1][1]][1]
            if ch in _WS:
                return st
            return self._enter_value(stack, items, ch)
        if kind == "senum":
            _, stack, nid, prefix = st
            return self._senum(stack, nid, prefix, ch)
        if kind == "inum":
            _, stack, sub = st
            if sub == "minus":
                if ch == "0":
                    return ("inum", stack, "zero")
                return ("inum", stack, "int") if ch in "123456789" else None
            if sub == "zero":
                return self._num_delim(stack, ch)
            # 'int'
            if ch in "0123456789":
                return st
            return self._num_delim(stack, ch)
        return super().step(st, ch)

    # -- costs --------------------------------------------------------------
    def _best_key(self, nid: int, min_idx: int, prefix: str):
        """(min completion chars, next char) over candidate keys matching
        ``prefix`` — name remainder + '"' + ':' + min value + object rest."""
        best = None
        best_ch = None
        for i, name, sub, _ in self._admissible(nid, min_idx):
            if not name.startswith(prefix):
                continue
            c = (len(name) - len(prefix)) + 2 + self.cs.cost(sub) + \
                self._rem_object(nid, i)
            if best is None or c < best:
                best = c
                best_ch = name[len(prefix)] if len(prefix) < len(name) else '"'
        return best, best_ch

    def cost(self, st) -> int:
        kind = st[0]
        if kind == "sval":
            _, stack, nid = st
            return self.cs.cost(nid) + self._closers_cost(stack)
        if kind == "oopen":
            stack = st[1]
            nid = stack[-1][1]
            props = self.cs.nodes[nid][1]
            req = [(name, sub) for name, sub, r in props if r]
            below = self._closers_cost(stack[:-1])
            if not req:
                return 1 + below
            c = sum(len(name) + 2 + 1 + self.cs.cost(sub) for name, sub in req)
            return c + (len(req) - 1) + 1 + below
        if kind == "onext":
            _, stack, min_idx = st
            nid = stack[-1][1]
            best, _ = self._best_key(nid, min_idx, "")
            return 1 + best + self._closers_cost(stack[:-1])
        if kind == "okey":
            _, stack, min_idx, prefix = st
            nid = stack[-1][1]
            best, _ = self._best_key(nid, min_idx, prefix)
            return best + self._closers_cost(stack[:-1])
        if kind == "ocolon":
            _, stack, i = st
            nid = stack[-1][1]
            sub = self.cs.nodes[nid][1][i][1]
            return (1 + self.cs.cost(sub) + self._rem_object(nid, i)
                    + self._closers_cost(stack[:-1]))
        if kind == "safter":
            return self._closers_cost(st[1])
        if kind == "aopen":
            stack = st[1]
            nid = stack[-1][1]
            _, items, lo, _ = self.cs.nodes[nid]
            below = self._closers_cost(stack[:-1])
            if lo == 0:
                return 1 + below
            return lo * self.cs.cost(items) + (lo - 1) + 1 + below
        if kind == "aval":
            stack = st[1]
            nid, k = stack[-1][1], stack[-1][2]
            items = self.cs.nodes[nid][1]
            return (self.cs.cost(items) + self._rem_array(nid, k + 1)
                    + self._closers_cost(stack[:-1]))
        if kind == "senum":
            _, stack, nid, prefix = st
            texts = self.cs.nodes[nid][1]
            rem = min(len(t) - len(prefix) for t in texts
                      if t.startswith(prefix))
            return rem + self._closers_cost(stack)
        if kind == "inum":
            _, stack, sub = st
            extra = 1 if sub == "minus" else 0
            return extra + self._closers_cost(stack)
        return super().cost(st)

    def closing_char(self, st) -> Optional[str]:
        kind = st[0]
        if kind == "sval":
            return self.cs.first_char(st[2])
        if kind == "oopen":
            stack = st[1]
            nid = stack[-1][1]
            props = self.cs.nodes[nid][1]
            return '"' if any(r for _, _, r in props) else "}"
        if kind == "onext":
            return '"'
        if kind == "okey":
            _, stack, min_idx, prefix = st
            nid = stack[-1][1]
            _, ch = self._best_key(nid, min_idx, prefix)
            return ch
        if kind == "ocolon":
            return ":"
        if kind == "safter":
            return self._frame_close_char(st[1][-1])
        if kind == "aopen":
            stack = st[1]
            nid = stack[-1][1]
            _, items, lo, _ = self.cs.nodes[nid]
            return "]" if lo == 0 else self.cs.first_char(items)
        if kind == "aval":
            stack = st[1]
            items = self.cs.nodes[stack[-1][1]][1]
            return self.cs.first_char(items)
        if kind == "senum":
            _, stack, nid, prefix = st
            texts = [t for t in self.cs.nodes[nid][1] if t.startswith(prefix)]
            best = min(texts, key=len)
            return best[len(prefix)]
        if kind == "inum":
            _, stack, sub = st
            if sub == "minus":
                return "0"
            return self._frame_close_char(stack[-1]) if stack else None
        return super().closing_char(st)

    def closing_alphabet(self) -> set:
        """Chars any minimal completion may need (key/enum forcing)."""
        chars: set = set()
        for node in self.cs.nodes:
            if node[0] == "object":
                for name, _, _ in node[1]:
                    chars |= set(name)
            elif node[0] == "enum":
                for t in node[1]:
                    chars |= set(t)
        return chars


class AltMachine:
    """Alternation over K machines: legal iff legal for ANY branch.

    Used for multi-tool forced calling (serve/tools.py), where each tool
    is its own schema — the branches all open with '{"name": ...' so a
    first-char-disjoint union node cannot express it. The state is the
    tuple of live (branch, state) pairs; dead branches drop out as chars
    commit. The closing-cost invariant survives alternation because one
    char can lower any machine's cost by at most 1 (from the new state
    the old one completes in cost+1), so min-over-branches also steps
    down by exactly 1 along the cheapest branch's closing char.
    """

    def __init__(self, machines: Sequence):
        self.machines = tuple(machines)
        self.start = tuple((i, m.start) for i, m in enumerate(self.machines))

    def step(self, st, ch: str):
        if st == _END:
            return _END if ch in _WS else None
        live = []
        for i, s in st:
            s2 = self.machines[i].step(s, ch)
            if s2 is not None:
                live.append((i, s2))
        if not live:
            return None
        if all(s == _END for _, s in live):
            return _END  # collapse: GrammarConstraint.finished fires
        return tuple(live)

    def cost(self, st) -> int:
        if st == _END:
            return 0
        return min(self.machines[i].cost(s) for i, s in st)

    def closing_char(self, st) -> Optional[str]:
        if st == _END:
            return None
        i, s = min(st, key=lambda p: self.machines[p[0]].cost(p[1]))
        return self.machines[i].closing_char(s)

    def closing_alphabet(self) -> set:
        out: set = set()
        for m in self.machines:
            extra = getattr(m, "closing_alphabet", None)
            if extra is not None:
                out |= extra()
        return out


def alternation_constraint(
    tokenizer,
    schemas: Sequence,
    *,
    max_depth: int = 24,
    token_strs: Optional[Sequence[Optional[str]]] = None,
) -> GrammarConstraint:
    """Constraint matching ANY of the given schemas (tables cached on the
    tokenizer by the canonical dump of the schema list)."""
    from videollamb_torch.serve.grammar import cached_grammar_table

    def build(strs, eos):
        machines = [SchemaMachine(compile_schema(s), max_depth=max_depth)
                    for s in schemas]
        machine = machines[0] if len(machines) == 1 else AltMachine(machines)
        return GrammarTable(strs, eos, machine)

    table = cached_grammar_table(
        tokenizer,
        ("alt_schema", json.dumps(list(schemas), sort_keys=True), max_depth),
        build, token_strs=token_strs)
    return GrammarConstraint(table)


def schema_constraint(
    tokenizer,
    schema,
    *,
    max_depth: int = 24,
    token_strs: Optional[Sequence[Optional[str]]] = None,
) -> GrammarConstraint:
    """Build a schema-enforcing constraint; tables are cached on the
    tokenizer keyed by the canonical schema dump (shared across requests)."""
    from videollamb_torch.serve.grammar import cached_grammar_table

    table = cached_grammar_table(
        tokenizer,
        ("json_schema", json.dumps(schema, sort_keys=True), max_depth),
        lambda strs, eos: GrammarTable(
            strs, eos,
            SchemaMachine(compile_schema(schema), max_depth=max_depth)),
        token_strs=token_strs)
    return GrammarConstraint(table)
