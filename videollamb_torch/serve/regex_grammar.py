"""Regex-constrained decoding: the output is guaranteed to FULL-MATCH a
regular expression.

The port's own copy of ``videollamb_tpu/serve/regex_grammar.py`` (plain Python and
numpy), with the same names and behaviour: the port imports nothing of the
JAX package.

Completes the guided-decoding family next to JSON mode (serve/grammar.py),
structured outputs (serve/schema.py), choice sets (serve/constrained.py)
and tool-call alternation (serve/tools.py) — the vLLM ``guided_regex``
surface. The reference has no constrained decoding at all (its MC drivers
string-match free-form output, llava/eval/model_videoqa_mc.py:202-207).

Design: the pattern compiles to a character-level DFA whose states carry
the same contract as :class:`~videollamb_torch.serve.grammar.JsonMachine`
(``start`` / ``step`` / ``cost`` / ``closing_char``), so the whole
existing stack — GrammarTable token transitions, budget-aware forced
closing, the host mask path AND the device-side HBM grammar tables
(serve/device_grammar.py) — drives regex constraints unchanged:

- parse (supported subset: literals, escapes, ``.``, classes ``[..]``
  with ranges/negation, predefined ``\\d \\w \\s`` + complements,
  groups, ``|``, ``* + ?`` and bounded ``{m,n}`` repeats; lazy
  qualifiers accepted — greediness is meaningless for an acceptor);
- char classes become DISJOINT CODE-POINT ATOMS (alphabet partitioning:
  ``.`` spans all of Unicode, so transitions are labeled with interval
  atoms, not individual chars);
- Thompson NFA -> subset-construction DFA over atoms (state cap keeps
  pathological patterns a 400, not an OOM), dead states pruned;
- ``cost(state)`` = min chars to an accept state (reverse BFS), and per
  state a ``closing_char`` that provably lowers cost by 1 — the same
  inductive invariant the JSON budget guarantee rests on, so generation
  always terminates in a COMPLETE match, never a truncated prefix.

Unsupported constructs (backreferences, lookaround, inline flags,
anchors mid-pattern) raise :class:`RegexError` -> HTTP 400 at request
parse, never a crash at admission.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

MAX_CP = 0x10FFFF

Intervals = Tuple[Tuple[int, int], ...]  # sorted, disjoint, inclusive


class RegexError(ValueError):
    """Unsupported or malformed pattern (surfaces as HTTP 400)."""


# ----------------------------------------------------------------------
# Interval-set helpers


def _norm(ivs: List[Tuple[int, int]]) -> Intervals:
    ivs = sorted((lo, hi) for lo, hi in ivs if lo <= hi)
    out: List[Tuple[int, int]] = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def _complement(ivs: Intervals) -> Intervals:
    out, cur = [], 0
    for lo, hi in ivs:
        if cur < lo:
            out.append((cur, lo - 1))
        cur = hi + 1
    if cur <= MAX_CP:
        out.append((cur, MAX_CP))
    return tuple(out)


_D = _norm([(0x30, 0x39)])
_W = _norm([(0x30, 0x39), (0x41, 0x5A), (0x5F, 0x5F), (0x61, 0x7A)])
_S = _norm([(0x09, 0x0D), (0x20, 0x20)])
_DOT = _complement(_norm([(0x0A, 0x0A)]))  # '.' = anything but newline

_CLASS_ESCAPES: Dict[str, Intervals] = {
    "d": _D, "D": _complement(_D),
    "w": _W, "W": _complement(_W),
    "s": _S, "S": _complement(_S),
}
_CHAR_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
                 "0": "\0", "a": "\a", "b": "\b"}


# ----------------------------------------------------------------------
# Parser: pattern -> AST
# nodes: ("cls", Intervals) | ("cat", [..]) | ("alt", [..])
#        | ("rep", node, lo, hi|None) | ("eps",)


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _take(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise RegexError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self._take()
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        items = []
        while self._peek() not in (None, "|", ")"):
            items.append(self._repeat())
        if not items:
            return ("eps",)
        return items[0] if len(items) == 1 else ("cat", items)

    def _repeat(self):
        node = self._atom()
        while True:
            ch = self._peek()
            if ch == "*":
                self._take()
                node = ("rep", node, 0, None)
            elif ch == "+":
                self._take()
                node = ("rep", node, 1, None)
            elif ch == "?":
                self._take()
                node = ("rep", node, 0, 1)
            elif ch == "{":
                save = self.i
                bounds = self._try_bounds()
                if bounds is None:
                    self.i = save
                    break  # literal '{'... handled by _atom next time? no:
                    # '{' after an atom with no valid bounds is a literal
                    # only in lenient dialects — we already consumed the
                    # atom, so treat it as the next atom's literal char.
                lo, hi = bounds
                if hi is not None and hi < lo:
                    raise RegexError("{m,n} with n < m")
                if (hi or lo) > 256:
                    raise RegexError("repeat bound too large (max 256)")
                node = ("rep", node, lo, hi)
            else:
                break
            if self._peek() == "?":  # lazy qualifier: no-op for an acceptor
                self._take()
        return node

    def _try_bounds(self) -> Optional[Tuple[int, Optional[int]]]:
        assert self._take() == "{"
        num = ""
        while self._peek() is not None and self._peek().isdigit():
            num += self._take()
        if not num:
            return None
        lo = int(num)
        if self._peek() == "}":
            self._take()
            return lo, lo
        if self._peek() != ",":
            return None
        self._take()
        num2 = ""
        while self._peek() is not None and self._peek().isdigit():
            num2 += self._take()
        if self._peek() != "}":
            return None
        self._take()
        return lo, (int(num2) if num2 else None)

    def _atom(self):
        ch = self._take()
        if ch == "(":
            if self._peek() == "?":
                self._take()
                nxt = self._peek()
                if nxt == ":":
                    self._take()
                else:
                    raise RegexError(
                        f"unsupported group (?{nxt}...) — only (?:...) "
                        "and capturing groups are supported")
            node = self._alt()
            if self._peek() != ")":
                raise RegexError("unbalanced '('")
            self._take()
            return node
        if ch == "[":
            return ("cls", self._char_class())
        if ch == ".":
            return ("cls", _DOT)
        if ch == "\\":
            return self._escape(in_class=False)
        if ch in ")*+?":
            raise RegexError(f"unexpected {ch!r}")
        if ch in "^$":
            raise RegexError(
                "anchors are implicit (patterns always full-match); "
                f"{ch!r} mid-pattern is not supported")
        cp = ord(ch)
        return ("cls", ((cp, cp),))

    def _escape(self, in_class: bool):
        if self._peek() is None:
            raise RegexError("trailing backslash")
        ch = self._take()
        if ch in _CLASS_ESCAPES:
            ivs = _CLASS_ESCAPES[ch]
            return ivs if in_class else ("cls", ivs)
        if ch in _CHAR_ESCAPES and not (in_class and ch == "b"):
            c = _CHAR_ESCAPES[ch]
            ivs = ((ord(c), ord(c)),)
            return ivs if in_class else ("cls", ivs)
        if ch == "x" or ch == "u":
            n = 2 if ch == "x" else 4
            hexs = self.p[self.i: self.i + n]
            if len(hexs) != n:
                raise RegexError(f"bad \\{ch} escape")
            try:
                cp = int(hexs, 16)
            except ValueError:
                raise RegexError(f"bad \\{ch} escape")
            self.i += n
            ivs = ((cp, cp),)
            return ivs if in_class else ("cls", ivs)
        if ch.isalnum():
            raise RegexError(f"unsupported escape \\{ch}")
        cp = ord(ch)  # escaped metachar: literal
        ivs = ((cp, cp),)
        return ivs if in_class else ("cls", ivs)

    def _char_class(self) -> Intervals:
        negate = False
        if self._peek() == "^":
            self._take()
            negate = True
        ivs: List[Tuple[int, int]] = []
        first = True
        while True:
            ch = self._peek()
            if ch is None:
                raise RegexError("unbalanced '['")
            if ch == "]" and not first:
                self._take()
                break
            first = False
            if ch == "\\":
                self._take()
                part = self._escape(in_class=True)
                if len(part) != 1 or part[0][0] != part[0][1]:
                    ivs.extend(part)  # \d etc.: no range allowed after
                    continue
                lo = part[0][0]
            else:
                lo = ord(self._take())
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self._take()
                ch2 = self._take()
                if ch2 == "\\":
                    part = self._escape(in_class=True)
                    if len(part) != 1 or part[0][0] != part[0][1]:
                        raise RegexError("bad class range")
                    hi = part[0][0]
                else:
                    hi = ord(ch2)
                if hi < lo:
                    raise RegexError("bad class range")
                ivs.append((lo, hi))
            else:
                ivs.append((lo, lo))
        out = _norm(ivs)
        if not out:
            raise RegexError("empty character class")
        return _complement(out) if negate else out


# ----------------------------------------------------------------------
# Compilation: AST -> NFA over atom ids -> DFA


class RegexMachine:
    """Char-level DFA with closing costs; JsonMachine-compatible contract
    (``start``/``step``/``cost``/``closing_char``/``closing_alphabet``)
    so GrammarTable / GrammarConstraint / DeviceTable drive it unchanged.
    States are ints."""

    # The closing alphabet below is COMPLETE for this machine — the JSON
    # closing chars are irrelevant (grammar._machine_closing_alphabet).
    closing_alphabet_is_complete = True

    def __init__(self, pattern: str, max_states: int = 4096):
        if pattern.startswith("^"):
            pattern = pattern[1:]
        if pattern.endswith("$") and not pattern.endswith("\\$"):
            pattern = pattern[:-1]
        ast = _Parser(pattern).parse()

        # Alphabet partition: every class is a union of disjoint atoms.
        cuts = set()

        def collect(node):
            if node[0] == "cls":
                for lo, hi in node[1]:
                    cuts.add(lo)
                    cuts.add(hi + 1)
            elif node[0] in ("cat", "alt"):
                for c in node[1]:
                    collect(c)
            elif node[0] == "rep":
                collect(node[1])

        collect(ast)
        bounds = sorted(cuts)
        if not bounds:  # pattern matches only the empty string
            bounds = [0]
        # atom a = [starts[a], starts[a+1]-1]
        self._starts = [b for b in bounds if b <= MAX_CP]
        n_atoms = len(self._starts)

        def atoms_of(ivs: Intervals) -> FrozenSet[int]:
            out = set()
            for lo, hi in ivs:
                a = bisect_right(self._starts, lo) - 1
                while a < n_atoms and self._starts[a] <= hi:
                    if self._starts[a] >= lo:
                        out.add(a)
                    a += 1
            return frozenset(out)

        # Thompson NFA. eps[s] = list of targets; lab[s] = (atomset, t).
        eps: List[List[int]] = []
        lab: List[Optional[Tuple[FrozenSet[int], int]]] = []

        def new_state() -> int:
            if len(eps) > 64 * max_states:
                raise RegexError("pattern too large")
            eps.append([])
            lab.append(None)
            return len(eps) - 1

        def build(node) -> Tuple[int, int]:  # (start, accept)
            kind = node[0]
            if kind == "eps":
                s = new_state()
                return s, s
            if kind == "cls":
                s, t = new_state(), new_state()
                lab[s] = (atoms_of(node[1]), t)
                return s, t
            if kind == "cat":
                s, t = build(node[1][0])
                for child in node[1][1:]:
                    s2, t2 = build(child)
                    eps[t].append(s2)
                    t = t2
                return s, t
            if kind == "alt":
                s, t = new_state(), new_state()
                for child in node[1]:
                    cs, ct = build(child)
                    eps[s].append(cs)
                    eps[ct].append(t)
                return s, t
            # rep lo..hi (hi None = unbounded)
            _, child, lo, hi = node
            s = new_state()
            cur = s
            for _ in range(lo):
                cs, ct = build(child)
                eps[cur].append(cs)
                cur = ct
            t = new_state()
            if hi is None:
                cs, ct = build(child)
                eps[cur].append(cs)
                eps[ct].append(cs)  # loop
                eps[ct].append(t)
                eps[cur].append(t)
            else:
                eps[cur].append(t)
                for _ in range(hi - lo):
                    cs, ct = build(child)
                    eps[cur].append(cs)
                    eps[ct].append(t)
                    cur = ct
            return s, t

        nfa_start, nfa_accept = build(ast)

        def closure(states: FrozenSet[int]) -> FrozenSet[int]:
            out = set(states)
            stack = list(states)
            while stack:
                for t in eps[stack.pop()]:
                    if t not in out:
                        out.add(t)
                        stack.append(t)
            return frozenset(out)

        # Subset construction.
        start_set = closure(frozenset([nfa_start]))
        intern: Dict[FrozenSet[int], int] = {start_set: 0}
        dfa_sets = [start_set]
        trans_rows: List[np.ndarray] = []
        i = 0
        while i < len(dfa_sets):
            cur = dfa_sets[i]
            row = np.full((n_atoms,), -1, np.int32)
            move: Dict[int, set] = {}
            for s in cur:
                if lab[s] is not None:
                    atoms, t = lab[s]
                    for a in atoms:
                        move.setdefault(a, set()).add(t)
            for a, targets in move.items():
                nxt = closure(frozenset(targets))
                sid = intern.get(nxt)
                if sid is None:
                    if len(dfa_sets) >= max_states:
                        raise RegexError(
                            f"pattern needs more than {max_states} DFA "
                            "states")
                    sid = len(dfa_sets)
                    intern[nxt] = sid
                    dfa_sets.append(nxt)
                row[a] = sid
            trans_rows.append(row)
            i += 1
        self._trans = np.stack(trans_rows)  # (n_dfa, n_atoms)
        accept = np.asarray(
            [nfa_accept in s for s in dfa_sets], bool)

        # Closing costs: reverse BFS from accept states.
        n = len(dfa_sets)
        INF = 1 << 30
        cost = np.full((n,), INF, np.int64)
        cost[accept] = 0
        frontier = list(np.nonzero(accept)[0])
        # reverse adjacency
        radj: List[List[int]] = [[] for _ in range(n)]
        for s in range(n):
            for t in set(self._trans[s][self._trans[s] >= 0].tolist()):
                radj[t].append(s)
        while frontier:
            nxt_frontier = []
            for t in frontier:
                for s in radj[t]:
                    if cost[s] > cost[t] + 1:
                        cost[s] = cost[t] + 1
                        nxt_frontier.append(s)
            frontier = nxt_frontier
        if cost[0] >= INF:
            raise RegexError("pattern matches no string")
        # Prune dead states (can't reach accept): transitions into them
        # become illegal, so step() returns None there.
        dead = cost >= INF
        self._trans[np.isin(self._trans, np.nonzero(dead)[0])] = -1
        self._cost = cost

        # Closing char per state: a char that provably lowers cost by 1.
        self._closing: List[Optional[str]] = [None] * n
        for s in range(n):
            if dead[s] or cost[s] == 0:
                continue
            row = self._trans[s]
            good = np.nonzero((row >= 0) & (cost[np.maximum(row, 0)]
                                            == cost[s] - 1))[0]
            a = int(good[0])
            # Prefer a printable-ASCII representative when one overlaps.
            best = None
            for a2 in good.tolist():
                lo = self._starts[a2]
                hi = (self._starts[a2 + 1] - 1 if a2 + 1 < n_atoms
                      else MAX_CP)
                if lo <= 0x7E and hi >= 0x20:
                    best = max(lo, 0x20)
                    break
            if best is None:
                lo = self._starts[a]
                best = lo
            self._closing[s] = chr(best)

        self.start = 0
        self._n_atoms = n_atoms

    # -- JsonMachine-compatible contract --------------------------------
    def step(self, st: int, ch: str) -> Optional[int]:
        a = bisect_right(self._starts, ord(ch)) - 1
        if a < 0:
            return None
        nxt = int(self._trans[st, a])
        return nxt if nxt >= 0 else None

    def cost(self, st: int) -> int:
        return int(self._cost[st])

    def closing_char(self, st: int) -> Optional[str]:
        return self._closing[st]

    def closing_alphabet(self) -> set:
        return {c for c in self._closing if c is not None}


# ----------------------------------------------------------------------
# Constraint factory


def regex_constraint(tokenizer, pattern: str, *,
                     token_strs: Optional[Sequence[Optional[str]]] = None):
    """Build a regex decode constraint; the (expensive) token table is
    cached on the tokenizer per pattern, shared across requests and both
    engines — and the device-side HBM tables hang off it exactly as for
    JSON mode."""
    from videollamb_torch.serve.grammar import (
        GrammarConstraint,
        GrammarTable,
        cached_grammar_table,
    )

    table = cached_grammar_table(
        tokenizer, ("regex", pattern),
        lambda strs, eos: GrammarTable(strs, eos, RegexMachine(pattern)),
        token_strs=token_strs)
    return GrammarConstraint(table)
