"""Grammar-constrained decoding: guaranteed-valid JSON output.

The port's own copy of ``videollamb_tpu/serve/grammar.py`` (plain Python and
numpy), with the same names and behaviour: the port imports nothing of the
JAX package.

OpenAI's ``response_format: {"type": "json_object"}`` promises the
completion parses as a JSON object. The reference has no such surface
(its MC drivers string-match free-form output,
llava/eval/model_videoqa_mc.py:202-207); this module extends the
choice-set constraint machinery (serve/constrained.py) with a real
grammar so the engines CANNOT emit invalid JSON — greedy or sampled.

Design (host-side, engine-agnostic, same interface as ChoiceConstraint):

- :class:`JsonMachine` — a character-level pushdown automaton for strict
  RFC-8259 JSON with a bounded container depth (the bound makes the
  machine finite and every state's distance-to-accept computable).
  States are small tuples ``(kind, stack, ...)`` where ``stack`` is the
  open-container frame tuple ('o'/'a' per generic level;
  schema machines push richer frames — serve/schema.py).
- :class:`GrammarTable` — token-level transitions over the machine,
  computed lazily per state and cached: each vocab token's string is
  walked char-by-char; tokens that survive yield (allowed id, end state,
  end closing-cost). States recur heavily (in-string, between-values),
  so steady-state mask cost is an array index. Tables are cached on the
  tokenizer object, shared across requests and both engines.
- **Budget-aware forced closing** — every state knows its closing cost:
  the minimum number of characters to reach a complete value (each of
  which is emittable as a single-char token, verified at table build).
  When a request's remaining token budget approaches the cost, the mask
  drops any token whose end state could no longer be closed in budget —
  so generation ALWAYS terminates in complete, parseable JSON, never a
  truncated prefix. The invariant ``step(state, closing_char(state))``
  lowers cost by exactly 1 is what makes the guarantee inductive
  (test_grammar.py fuzzes it).

The per-step cost rides the existing constrained path: one (B, V) bool
mask per step for batches with constrained rows; unconstrained batches
keep the device-side k-step greedy loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_WS = " \t\n\r"
_HEX = "0123456789abcdefABCDEF"
_DIGITS = "0123456789"
_END = ("end", ())


class JsonMachine:
    """Character-level DFA/PDA for strict JSON, depth-bounded.

    ``top_object=True`` (the OpenAI json_object contract) requires the
    top-level value to be an object; False accepts any JSON value.

    State is ``(kind, stack, ...)`` where ``stack`` is a tuple of open
    container frames. Generic frames are the chars 'o'/'a'; subclasses
    (serve/schema.py) push richer frame tuples and hook
    ``_frame_close_cost`` / ``_after_value`` / extra state kinds.
    """

    def __init__(self, top_object: bool = True, max_depth: int = 16):
        self.top_object = top_object
        self.max_depth = max_depth
        self.start = ("val", ())

    # -- frame hooks (overridden by schema machines) --------------------
    def _after_value(self, stack: tuple):
        """State after a complete value whose container frames = stack."""
        if not stack:
            return _END
        return ("after", stack)

    def _frame_close_cost(self, frame) -> int:
        """Min chars to close ``frame`` once its in-flight value is done."""
        return 1  # generic 'o'/'a': the one closer char

    def _closers_cost(self, stack: tuple) -> int:
        return sum(self._frame_close_cost(f) for f in stack)

    def _frame_close_char(self, frame) -> str:
        """First char of the minimal closing of ``frame`` once its
        in-flight value is done."""
        return "}" if frame == "o" else "]"

    # ------------------------------------------------------------------
    def _value_start(self, stack: tuple, ch: str):
        if ch == "{":
            return ("obj_open", stack + ("o",)) if len(stack) < self.max_depth else None
        if ch == "[":
            return ("arr_open", stack + ("a",)) if len(stack) < self.max_depth else None
        if ch == '"':
            return ("str", stack, "v")
        if ch == "-":
            return ("num", stack, "minus")
        if ch == "0":
            return ("num", stack, "zero")
        if ch in "123456789":
            return ("num", stack, "int")
        if ch == "t":
            return ("lit", stack, "true", 1)
        if ch == "f":
            return ("lit", stack, "false", 1)
        if ch == "n":
            return ("lit", stack, "null", 1)
        return None

    def _num_delim(self, stack: tuple, ch: str):
        """A complete number ends at a delimiter: close the value, then
        let the after-state consume the delimiter char."""
        return self.step(self._after_value(stack), ch)

    def step(self, st, ch: str):
        """One character transition; None = illegal."""
        kind = st[0]
        if kind == "end":
            return st if ch in _WS else None
        if kind == "val":
            stack = st[1]
            if ch in _WS:
                return st
            if self.top_object and not stack:
                return ("obj_open", ("o",)) if ch == "{" else None
            return self._value_start(stack, ch)
        if kind == "obj_open":  # just after '{': first key or empty object
            stack = st[1]
            if ch in _WS:
                return st
            if ch == '"':
                return ("str", stack, "k")
            if ch == "}":
                return self._after_value(stack[:-1])
            return None
        if kind == "key":  # after ',' in an object: a key is mandatory
            stack = st[1]
            if ch in _WS:
                return st
            return ("str", stack, "k") if ch == '"' else None
        if kind == "colon":
            stack = st[1]
            if ch in _WS:
                return st
            return ("val", stack) if ch == ":" else None
        if kind == "after":  # a complete value inside a container
            stack = st[1]
            if ch in _WS:
                return st
            top = stack[-1]
            if ch == ",":
                return ("key", stack) if top == "o" else ("val", stack)
            if ch == "}" and top == "o":
                return self._after_value(stack[:-1])
            if ch == "]" and top == "a":
                return self._after_value(stack[:-1])
            return None
        if kind == "arr_open":  # just after '[': first element or ']'
            stack = st[1]
            if ch in _WS:
                return st
            if ch == "]":
                return self._after_value(stack[:-1])
            return self._value_start(stack, ch)
        if kind == "str":
            _, stack, k = st
            if ch == '"':
                return ("colon", stack) if k == "k" else self._after_value(stack)
            if ch == "\\":
                return ("esc", stack, k)
            return st if ord(ch) >= 0x20 else None
        if kind == "esc":
            _, stack, k = st
            if ch in '"\\/bfnrt':
                return ("str", stack, k)
            return ("hex", stack, k, 0) if ch == "u" else None
        if kind == "hex":
            _, stack, k, n = st
            if ch in _HEX:
                return ("str", stack, k) if n == 3 else ("hex", stack, k, n + 1)
            return None
        if kind == "num":
            _, stack, sub = st
            if sub == "minus":
                if ch == "0":
                    return ("num", stack, "zero")
                return ("num", stack, "int") if ch in "123456789" else None
            if sub == "zero":  # leading zero: no more int digits
                if ch == ".":
                    return ("num", stack, "frac0")
                if ch in "eE":
                    return ("num", stack, "exp0")
                return self._num_delim(stack, ch)
            if sub == "int":
                if ch in _DIGITS:
                    return st
                if ch == ".":
                    return ("num", stack, "frac0")
                if ch in "eE":
                    return ("num", stack, "exp0")
                return self._num_delim(stack, ch)
            if sub == "frac0":
                return ("num", stack, "frac") if ch in _DIGITS else None
            if sub == "frac":
                if ch in _DIGITS:
                    return st
                if ch in "eE":
                    return ("num", stack, "exp0")
                return self._num_delim(stack, ch)
            if sub == "exp0":
                if ch in "+-":
                    return ("num", stack, "expsign")
                return ("num", stack, "exp") if ch in _DIGITS else None
            if sub == "expsign":
                return ("num", stack, "exp") if ch in _DIGITS else None
            # sub == "exp"
            if ch in _DIGITS:
                return st
            return self._num_delim(stack, ch)
        # kind == "lit"
        _, stack, word, pos = st
        if ch != word[pos]:
            return None
        return self._after_value(stack) if pos + 1 == len(word) else (
            "lit", stack, word, pos + 1)

    # ------------------------------------------------------------------
    _NUM_COMPLETE = frozenset({"zero", "int", "frac", "exp"})

    def cost(self, st) -> int:
        """Minimum characters to a complete top-level value (0 = already
        complete). Each step of the minimal completion is a single char."""
        kind = st[0]
        if kind == "end":
            return 0
        stack = st[1]
        closers = self._closers_cost(stack)
        if kind == "after":
            return closers
        if kind == "val":
            if self.top_object and not stack:
                return 2  # "{}"
            return 1 + closers  # "0"
        if kind in ("obj_open", "arr_open"):
            return closers  # the immediate '}'/']' pops one level
        if kind == "key":
            return 4 + closers  # '"":0' then closers... '":0' after '"'
        if kind == "colon":
            return 2 + closers  # ':0'
        if kind == "str":
            return (1 if st[2] == "v" else 3) + closers  # '"' (+':0' for keys)
        if kind == "esc":
            return 1 + (1 if st[2] == "v" else 3) + closers
        if kind == "hex":
            return (4 - st[3]) + (1 if st[2] == "v" else 3) + closers
        if kind == "num":
            return closers if st[2] in self._NUM_COMPLETE else 1 + closers
        # "lit"
        return (len(st[2]) - st[3]) + closers

    def closing_char(self, st) -> Optional[str]:
        """First character of the minimal completion (None at cost 0).
        Invariant: step(st, closing_char(st)) has cost(st) - 1."""
        kind = st[0]
        if kind == "end":
            return None
        stack = st[1]
        if kind == "after":
            return self._frame_close_char(stack[-1])
        if kind == "val":
            return "{" if (self.top_object and not stack) else "0"
        if kind == "obj_open":
            return "}"
        if kind == "arr_open":
            return "]"
        if kind == "key" or kind == "str":
            return '"'
        if kind == "colon":
            return ":"
        if kind == "esc":
            return "n"
        if kind == "hex":
            return "0"
        if kind == "num":
            if st[2] in self._NUM_COMPLETE:
                return self._frame_close_char(stack[-1]) if stack else None
            return "0"
        return st[2][st[3]]  # next literal char


# The characters any minimal completion can need — each must exist as a
# single-token string for the budget guarantee to hold. Schema machines
# extend this with their key/enum characters (closing_alphabet()).
_CLOSING_ALPHABET = set('{}]":0n') | set("truefalsnull")


def _machine_closing_alphabet(machine) -> set:
    extra = getattr(machine, "closing_alphabet", None)
    if getattr(machine, "closing_alphabet_is_complete", False):
        # Non-JSON machines (serve/regex_grammar.py) declare their own
        # complete closing alphabet — don't demand JSON closers of them.
        return extra() if extra is not None else set()
    return _CLOSING_ALPHABET | (extra() if extra is not None else set())


class GrammarTable:
    """Token-level transition tables over a JsonMachine, lazily expanded
    and cached per state. Shared by every request on a tokenizer."""

    def __init__(
        self,
        token_strs: Sequence[Optional[str]],
        eos_token_id: int,
        machine: Optional[JsonMachine] = None,
    ):
        self.machine = machine or JsonMachine()
        self.eos = int(eos_token_id)
        # (id, string) for decodable, non-empty, non-special tokens.
        self.tokens: List[Tuple[int, str]] = [
            (i, s) for i, s in enumerate(token_strs) if s
        ]
        if not self.tokens:
            raise ValueError("no usable token strings")
        self._intern: Dict[tuple, int] = {}
        self._states: List[tuple] = []
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._trans: Dict[tuple, Optional[tuple]] = {}
        self.start = self._sid(self.machine.start)
        self.min_tokens = self.machine.cost(self.machine.start)
        # Budget guarantee precondition: every closing char is emittable
        # as its own token.
        single = {s: i for i, s in self.tokens if len(s) == 1}
        missing = sorted(
            c for c in _machine_closing_alphabet(self.machine)
            if c not in single)
        if missing:
            raise ValueError(
                "tokenizer lacks single-char tokens needed for forced JSON "
                f"closing: {missing!r}")

    def _sid(self, st: tuple) -> int:
        sid = self._intern.get(st)
        if sid is None:
            sid = len(self._states)
            self._intern[st] = sid
            self._states.append(st)
        return sid

    def state(self, sid: int) -> tuple:
        return self._states[sid]

    def is_end(self, sid: int) -> bool:
        return self._states[sid] == _END

    def _step(self, st: tuple, ch: str):
        key = (st, ch)
        try:
            return self._trans[key]
        except KeyError:
            nxt = self.machine.step(st, ch)
            self._trans[key] = nxt
            return nxt

    def expand(self, sid: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(allowed token ids asc, end state ids, end closing costs)."""
        hit = self._cache.get(sid)
        if hit is not None:
            return hit
        st = self._states[sid]
        step, cost = self._step, self.machine.cost
        allowed: List[int] = []
        ends: List[int] = []
        costs: List[int] = []
        for tid, s in self.tokens:
            cur = st
            for ch in s:
                cur = step(cur, ch)
                if cur is None:
                    break
            if cur is not None:
                allowed.append(tid)
                ends.append(self._sid(cur))
                costs.append(cost(cur))
        out = (np.asarray(allowed, np.int32), np.asarray(ends, np.int32),
               np.asarray(costs, np.int32))
        self._cache[sid] = out
        return out


class GrammarConstraint:
    """Per-request decode cursor over a GrammarTable.

    Same duck-typed interface as ChoiceConstraint (``node``/``mask``/
    ``advance``/``finished``) so build_constraint_masks and both engines
    drive it unchanged; ``budget_aware`` opts into the per-step
    ``set_remaining`` call that powers forced closing.
    """

    budget_aware = True

    def __init__(self, table: GrammarTable):
        self.table = table
        self.node: Optional[int] = table.start
        self.min_tokens = table.min_tokens
        self._remaining: Optional[int] = None

    def set_remaining(self, n: int) -> None:
        """Tokens still in budget INCLUDING the one about to be chosen."""
        self._remaining = int(n)

    def mask(self, vocab_size: int) -> np.ndarray:
        m = np.zeros((vocab_size,), bool)
        if self.node is None:
            return m
        allowed, _, costs = self.table.expand(self.node)
        if self._remaining is not None:
            # After emitting a token we have remaining-1 left; its end
            # state must close within that. Closing cost is in single-char
            # tokens (verified at table build), so chars == tokens here.
            allowed = allowed[costs <= self._remaining - 1]
        m[allowed] = True
        if self.table.machine.cost(self.table.state(self.node)) == 0:
            m[self.table.eos] = True
        return m

    def advance(self, token: int) -> None:
        if self.node is None:
            return
        token = int(token)
        if token == self.table.eos:
            self.node = None
            return
        allowed, ends, _ = self.table.expand(self.node)
        pos = int(np.searchsorted(allowed, token))
        if pos < len(allowed) and allowed[pos] == token:
            self.node = int(ends[pos])
        else:  # off-grammar token (shouldn't happen under the mask)
            self.node = None

    @property
    def finished(self) -> bool:
        return self.node is None or self.table.is_end(self.node)


# ----------------------------------------------------------------------
# Tokenizer plumbing


def _byte_decoder() -> Dict[str, int]:
    """Inverse of GPT-2's bytes_to_unicode: printable stand-in char ->
    raw byte. Byte-level BPE vocabs (GPT-2/Llama-3/Qwen style) spell
    tokens in this alphabet ('Ġ' = space, 'Ċ' = newline, ...)."""
    bs = (list(range(33, 127)) + list(range(161, 173))
          + list(range(174, 256)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


_BYTE_DECODER = _byte_decoder()


def _piece_to_text(piece: str, byte_level: bool) -> Optional[str]:
    """Vocab piece -> surface string. None = not independently decodable
    (special tokens, partial UTF-8 byte fragments) -> disallowed under
    the grammar. Handles SentencePiece ('▁' word boundary, '<0xNN>'
    byte fallback) and byte-level BPE (full bytes_to_unicode inverse)."""
    if not piece:
        return None
    if byte_level:
        raw = bytearray()
        for ch in piece:
            b = _BYTE_DECODER.get(ch)
            if b is None:
                return None  # added/special token outside the byte alphabet
            raw.append(b)
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError:
            return None  # partial multi-byte sequence
    if piece.startswith("<0x") and piece.endswith(">") and len(piece) == 6:
        try:
            b = int(piece[3:5], 16)
        except ValueError:
            return None
        return chr(b) if b < 0x80 else None
    if piece.startswith("<") and piece.endswith(">"):
        return None  # control/special pieces (<s>, <unk>, <pad>, ...)
    return piece.replace("▁", " ")


def token_strings(tokenizer) -> List[Optional[str]]:
    """Surface string per vocab id (None = disallowed). The property the
    whole grammar approach rests on — verified for real tokenizers in
    test_grammar_real_tokenizer.py — is that concatenating these strings
    along any token path equals what ``tokenizer.decode`` produces."""
    size = int(getattr(tokenizer, "vocab_size", 0) or len(tokenizer))
    special = set(getattr(tokenizer, "all_special_ids", None) or [])
    convert = getattr(tokenizer, "convert_ids_to_tokens", None)
    if convert is None:
        raise ValueError(
            "tokenizer has no convert_ids_to_tokens; pass token_strs "
            "explicitly to GrammarTable")
    pieces = convert(list(range(size)))
    # Byte-level BPE spells space as 'Ġ'; SentencePiece as '▁'.
    byte_level = any(isinstance(p, str) and "Ġ" in p for p in pieces)
    strs: List[Optional[str]] = [None] * size
    for i, p in enumerate(pieces):
        if i in special or not isinstance(p, str):
            continue
        strs[i] = _piece_to_text(p, byte_level)
    return strs


# Second-level grammar-table cache, keyed by CONTENT (grammar key + eos +
# the token strings themselves). The first level lives on the tokenizer
# instance; this level makes equal-content tokenizers — fresh wrapper
# objects around the same vocab, one per request in some CLIs — share ONE
# table object. Table identity matters beyond memory: the engines' device
# setup (server._grammar_device_setup) requires every constrained slot in
# a batch to ride the SAME table, so without this cache multi-request
# batches built from distinct tokenizer objects silently fell back to the
# per-step host-mask path (~4x slower; docs/PERFORMANCE.md).
_CONTENT_TABLE_CACHE: dict = {}
_CONTENT_TABLE_CACHE_CAP = 64


def cached_grammar_table(tokenizer, key, build, token_strs=None):
    """Two-level table lookup shared by every constraint factory
    (json/regex/schema). ``key`` identifies the grammar (mode, pattern,
    schema dump...); ``build(strs, eos)`` constructs the table on a full
    miss. The instance level costs one dict lookup; the content level
    hashes the token-string tuple (~1 ms at 32k vocab) once per request
    admission — noise next to table construction (seconds)."""
    cache = getattr(tokenizer, "_videollamb_grammar_tables", None)
    if cache is None:
        cache = {}
        try:
            tokenizer._videollamb_grammar_tables = cache
        except (AttributeError, TypeError):
            pass
    table = cache.get(key)
    if table is None:
        eos = int(getattr(tokenizer, "eos_token_id", None) or 2)
        strs = (list(token_strs) if token_strs is not None
                else token_strings(tokenizer))
        ckey = (key, eos, tuple(strs))
        table = _CONTENT_TABLE_CACHE.get(ckey)
        if table is None:
            table = build(strs, eos)
            if len(_CONTENT_TABLE_CACHE) >= _CONTENT_TABLE_CACHE_CAP:
                _CONTENT_TABLE_CACHE.clear()
            _CONTENT_TABLE_CACHE[ckey] = table
        cache[key] = table
    return table


def json_constraint(
    tokenizer,
    *,
    mode: str = "json_object",
    max_depth: int = 16,
    token_strs: Optional[Sequence[Optional[str]]] = None,
) -> GrammarConstraint:
    """Build a JSON-mode constraint; the (expensive) table is cached on
    the tokenizer object AND content-keyed across tokenizer objects
    (cached_grammar_table), so repeat requests share transitions and
    batches share one table."""
    if mode not in ("json_object", "json"):
        raise ValueError(f"unknown grammar mode {mode!r}")
    table = cached_grammar_table(
        tokenizer, (mode, max_depth),
        lambda strs, eos: GrammarTable(
            strs, eos,
            JsonMachine(top_object=(mode == "json_object"),
                        max_depth=max_depth)),
        token_strs=token_strs)
    return GrammarConstraint(table)
