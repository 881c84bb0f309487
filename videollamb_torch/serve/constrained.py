"""Constrained decoding: restrict generation to a fixed set of choices.

The port's own copy of ``videollamb_tpu/serve/constrained.py`` (plain Python and
numpy), with the same names and behaviour: the port imports nothing of the
JAX package.

Production serving + MC-eval helper beyond the reference: the reference's
MC drivers ask the model to "answer with the option's letter"
(llava/eval/model_videoqa_mc.py:202-207) and then string-match the free
output — an off-format answer scores wrong even when the model knew the
option. Here a request can carry token-level constraints so the decoder
CANNOT leave the choice set.

Design (host-side, engine-agnostic):
- a :class:`TokenTrie` holds the tokenized choices; each slot carries a
  cursor (trie node) advanced as tokens commit;
- each step the active cursors yield a per-slot boolean vocab mask
  (allowed continuations), applied additively to the logits before
  argmax/sampling — so greedy AND temperature/top-p sampling both stay
  inside the constraint;
- a cursor that reaches a childless leaf terminates its row (the engine
  treats it like EOS). At a leaf that still has children (one choice is a
  strict prefix of another, e.g. "yes" / "yes please"), the EOS token is
  ALSO allowed so the shorter choice stays reachable — emitting EOS there
  commits the shorter string;
- engines extend a constrained request's token budget to the longest
  choice, so no row is cut off mid-choice with a partial string.

The mask ride-along costs one (B, V) bool host->device transfer per step
for batches with constrained rows (~256 KB at V=32k B=8); unconstrained
batches pay nothing — the engines keep their device-side k-step greedy
loop when no constraint is active.

Grammar coverage is deliberately the choice-set case (what the eval
protocol needs); the trie API is the extension point for richer state
machines (JSON grammars etc.).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class TokenTrie:
    """Prefix trie over token-id sequences."""

    def __init__(self, sequences: Sequence[Sequence[int]]):
        if not sequences:
            raise ValueError("no sequences")
        self.children: List[Dict[int, int]] = [{}]
        self.is_leaf: List[bool] = [False]
        self.max_len = 0
        for seq in sequences:
            seq = [int(t) for t in seq]
            if not seq:
                raise ValueError("empty choice sequence")
            self.max_len = max(self.max_len, len(seq))
            node = 0
            for tok in seq:
                nxt = self.children[node].get(tok)
                if nxt is None:
                    nxt = len(self.children)
                    self.children.append({})
                    self.is_leaf.append(False)
                    self.children[node][tok] = nxt
                node = nxt
            self.is_leaf[node] = True

    def allowed(self, node: int) -> List[int]:
        return list(self.children[node].keys())

    def step(self, node: int, token: int) -> Optional[int]:
        """Advance; None if the token is not an allowed continuation."""
        return self.children[node].get(int(token))

    def done(self, node: int) -> bool:
        """A leaf with no continuations ends the row."""
        return self.is_leaf[node] and not self.children[node]


class ChoiceConstraint:
    """Per-request decode state over a TokenTrie.

    ``eos_token_id``: when set (>= 0), EOS is allowed at any LEAF node —
    the escape hatch that keeps a choice reachable when it is a strict
    prefix of another choice.
    """

    def __init__(self, trie: TokenTrie, eos_token_id: Optional[int] = None,
                 table: Optional["ChoiceTable"] = None):
        self.trie = trie
        self.node: Optional[int] = 0  # None after a finished/dead path
        self.eos = (eos_token_id
                    if eos_token_id is not None and eos_token_id >= 0
                    else None)
        # Device-scan ride-along (engines attach an engine-cached
        # ChoiceTable; None keeps the per-step host-mask path).
        self.table = table

    def mask(self, vocab_size: int) -> np.ndarray:
        """(V,) bool — True where the next token is allowed."""
        m = np.zeros((vocab_size,), bool)
        if self.node is not None:
            m[self.trie.allowed(self.node)] = True
            if self.eos is not None and self.trie.is_leaf[self.node]:
                m[self.eos] = True
        return m

    def advance(self, token: int) -> None:
        if self.node is not None:
            self.node = self.trie.step(self.node, token)

    @property
    def finished(self) -> bool:
        """True when a full choice has been emitted (EOS off a leaf lands
        here too: the trie has no EOS edge, so the cursor dies)."""
        return self.node is None or self.trie.done(self.node)


class ChoiceTable:
    """Device-grammar protocol over a TokenTrie (serve/device_grammar.py).

    Choice sets are tiny automata (an MC letter set is ~6 nodes), so they
    ride the same HBM state pool as JSON grammars: sids are trie node ids,
    ``expand`` yields (allowed tokens, end nodes, closing costs), and the
    closing cost of a node is the minimum tokens to a complete choice
    (0 at a leaf — a complete choice has been emitted, so EOS is allowed
    there, the prefix-choice escape hatch of :class:`ChoiceConstraint`).
    Unlike grammars every state is enumerable up front: ``prewarm_sids``
    lets the DeviceTable upload the whole trie at creation, so the choice
    scan NEVER freezes. Engines cache one table per choice-set signature,
    so a batch of same-choice requests (the MC-eval shape) shares one
    table and stays in the device k-step loop.
    """

    def __init__(self, trie: TokenTrie, eos_token_id: int):
        if eos_token_id is None or eos_token_id < 0:
            raise ValueError("device choice tables need a real EOS id")
        self.trie = trie
        self.eos = int(eos_token_id)
        self.start = 0
        self.machine = self  # DeviceTable calls table.machine.cost(state)
        n = len(trie.children)
        cost = [0] * n
        # Trie children are created after their parent (strictly larger
        # ids), so one reverse sweep sees every child before its parent.
        for node in range(n - 1, 0 - 1, -1):
            if trie.is_leaf[node]:
                cost[node] = 0
            else:
                cost[node] = min(1 + cost[c]
                                 for c in trie.children[node].values())
        self._cost = cost
        # A finished row needs no further tokens; min_tokens mirrors the
        # GrammarTable attr the engines use to extend budgets.
        self.min_tokens = cost[0]
        self.prewarm_sids = tuple(range(n))
        self.preferred_cap = n + 1  # slot 0 is the reserved FREE row
        self.preferred_sid_cap = max(n, 1)

    def state(self, sid: int) -> int:
        return sid

    def cost(self, st: int) -> int:
        return self._cost[st]

    def is_end(self, sid: int) -> bool:
        return self.trie.done(sid)

    def expand(self, sid: int):
        items = sorted(self.trie.children[sid].items())
        allowed = np.asarray([t for t, _ in items], np.int64)
        ends = np.asarray([c for _, c in items], np.int64)
        costs = np.asarray([self._cost[c] for _, c in items], np.int64)
        return allowed, ends, costs


def tokenize_choice(tokenizer, text: str) -> List[int]:
    """Tokenize one choice continuation-style: leading BOS stripped, empty
    results rejected. The single tokenization contract shared by the batch
    CLI, the HTTP rows, and the MC eval driver."""
    ids = list(tokenizer(text).input_ids)
    bos = getattr(tokenizer, "bos_token_id", None)
    if bos is not None and ids and ids[0] == bos:
        ids = ids[1:]
    if not ids:
        raise ValueError(f"choice {text!r} tokenizes to nothing")
    return ids


def choices_to_constraint(
    tokenizer, choices: Sequence[str], eos_token_id: Optional[int] = None
) -> ChoiceConstraint:
    """Tokenize choice strings into a constraint."""
    return ChoiceConstraint(
        TokenTrie([tokenize_choice(tokenizer, c) for c in choices]),
        eos_token_id=eos_token_id,
    )


def build_constraint_masks(slots: Sequence, vocab_size: int) -> Optional[np.ndarray]:
    """Build the (B, V) additive logit mask for the current slot set, or
    None when no slot is constrained. ``slots`` holds engine Requests (or
    None); a request participates iff it has a live ``_constraint``."""
    rows = []
    any_active = False
    for r in slots:
        c = getattr(r, "_constraint", None) if r is not None else None
        if c is None or c.node is None:
            rows.append(None)
        else:
            if getattr(c, "budget_aware", False):
                # Grammar constraints (serve/grammar.py) force-close within
                # the remaining budget (incl. the token chosen this step).
                c.set_remaining(r.max_new_tokens - len(r.tokens))
            rows.append(c.mask(vocab_size))
            any_active = True
    if not any_active:
        return None
    out = np.zeros((len(slots), vocab_size), np.float32)
    for i, m in enumerate(rows):
        if m is not None:
            out[i, ~m] = -1e30
    return out
