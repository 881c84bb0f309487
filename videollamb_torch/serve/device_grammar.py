"""Constrained decoding on the device: grammar and choice tables in device memory.

Port of ``videollamb_tpu/serve/device_grammar.py``. The host-mask path
(``serve/constrained.build_constraint_masks``) reads the logits back and
sends a (B, V) mask every token. Here each visited grammar state's
per-token closing-cost row and transition row is uploaded to a device pool
once, and the engines' k-step decode loops gather rows by state slot, so
constrained rows stay in the device loop. These are plain torch gathers on
the device, as they are ``jnp`` gathers in the JAX package (no kernel).

Per step, on the device:
  mask  = pool_costs[slot] <= remaining - 1     (budget forced closing)
  token = argmax(where(mask, logits, -inf))
  sid   = pool_next[slot, token]                (machine transition)
  slot  = sid2slot[sid]                         (lazy upload mapping)

A transition into a state the host has not uploaded yet FREEZES the row at
that step: its token is valid (chosen under a correct mask), the steps
after it are garbage. The loop reports the freeze step and the row's logits
right after its last valid token; the engine keeps the valid prefix,
rewinds the row's cache length over the garbage (the next steps write over
it), restores the logits, and resumes at the next sync, by which time the
host's ``advance()`` has interned the new state and :meth:`DeviceTable.slot`
uploads it.

Sentinels in ``next_sid``: ``DEAD`` (-2) sends the row to the reserved FREE
slot 0 (everything allowed, self-loop), after EOS and for unconstrained
rows; -1 or an unmapped sid means "not uploaded" and freezes the row.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

BIG_COST = 1 << 20
DEAD = -2
# Budget stand-in for unconstrained rows: large, but small enough that
# remaining - 1 never wraps int32 inside a loop.
FREE_REMAINING = 1 << 24


class DeviceTable:
    """Device pool of per-state (costs, next-sid) rows for ONE grammar table.

    Slot 0 is reserved FREE: costs all 0 (everything allowed, EOS included),
    next all DEAD (self-loop); unconstrained rows and rows whose constraint
    finished mid-loop ride it.
    """

    def __init__(self, table, vocab_size: int, cap: int = 192, sid_cap: int = 8192,
                 device="cpu"):
        self.table = table
        self.V = int(vocab_size)
        self.cap = cap
        self.sid_cap = sid_cap
        self.device = torch.device(device)
        self.costs = torch.full((cap, self.V), BIG_COST, dtype=torch.int32, device=device)
        self.costs[0] = 0
        self.next_sid = torch.full((cap, self.V), DEAD, dtype=torch.int32, device=device)
        self.sid2slot = torch.full((sid_cap,), -1, dtype=torch.int32, device=device)
        self._slot_of = {}
        self._n = 1

    def slot(self, sid: int) -> Optional[int]:
        """Slot of state ``sid``, uploading its rows on first use. None when
        the pool or the sid range is full (the caller takes the host-mask
        path)."""
        s = self._slot_of.get(sid)
        if s is not None:
            return s
        if self._n >= self.cap or sid >= self.sid_cap:
            return None
        allowed, ends, costs = self.table.expand(sid)
        row_cost = np.full((self.V,), BIG_COST, np.int32)
        row_cost[allowed] = costs
        row_next = np.full((self.V,), DEAD, np.int32)
        row_next[allowed] = ends
        eos = self.table.eos
        if self.table.machine.cost(self.table.state(sid)) == 0:
            row_cost[eos] = 0
        row_next[eos] = DEAD  # EOS finishes the row on the host; on the device: FREE
        s = self._n
        self._n += 1
        self._slot_of[sid] = s
        self.costs[s] = torch.from_numpy(row_cost).to(self.device)
        self.next_sid[s] = torch.from_numpy(row_next).to(self.device)
        self.sid2slot[sid] = s
        return s


class CombinedDeviceTable:
    """Several DeviceTables concatenated into ONE pool, so a batch that mixes
    constraint tables (a JSON grammar in one slot, a choice trie in another)
    stays in the k-step device loop.

    Pure rebasing, so the loops run unchanged: table i's rows move to global
    slots [slot_base[i], slot_base[i] + cap_i) and its states to global sids
    [sid_base[i], sid_base[i] + sid_cap_i); its ``next_sid`` entries shift by
    sid_base[i] (negative sentinels kept) and its ``sid2slot`` by
    slot_base[i] (-1 kept). Global slot 0 is table 0's FREE row, which is the
    same in every table. A row's table never changes mid-request, so every
    transition stays inside its own table's range. The concatenation is
    rebuilt only when a member uploaded a state since the last sync.
    """

    def __init__(self, tables):
        self.tables = tuple(tables)
        self.slot_base = np.cumsum([0] + [t.cap for t in self.tables])[:-1]
        self.sid_base = np.cumsum([0] + [t.sid_cap for t in self.tables])[:-1]
        self._versions = None
        self.refresh()

    def refresh(self) -> None:
        versions = tuple(t._n for t in self.tables)
        if versions == self._versions:
            return
        self._versions = versions
        nxt, s2s = [], []
        for t, sb, pb in zip(self.tables, self.sid_base, self.slot_base):
            nxt.append(torch.where(t.next_sid < 0, t.next_sid, t.next_sid + int(sb)))
            s2s.append(torch.where(t.sid2slot < 0, t.sid2slot, t.sid2slot + int(pb)))
        self.costs = torch.cat([t.costs for t in self.tables], 0)
        self.next_sid = torch.cat(nxt, 0)
        self.sid2slot = torch.cat(s2s, 0)


def combined_table_for(device_tables) -> CombinedDeviceTable:
    """One CombinedDeviceTable per ordered tuple of member DeviceTables,
    cached on the first member. Call AFTER uploading this sync's states:
    refresh() folds them in."""
    key = tuple(id(t) for t in device_tables)
    cache = getattr(device_tables[0], "_combined_cache", None)
    if cache is None:
        cache = device_tables[0]._combined_cache = {}
    ct = cache.get(key)
    if ct is None:
        ct = cache[key] = CombinedDeviceTable(device_tables)
    else:
        ct.refresh()
    return ct


def device_table_for(table, vocab_size: int, device="cpu") -> DeviceTable:
    """One DeviceTable per grammar or choice table and device, cached on the
    table (shared by every request and engine on that device).

    Tables with ``preferred_cap`` / ``preferred_sid_cap`` (choice tries, a
    handful of states) get a pool of their size instead of the 192-row
    grammar default, and ``prewarm_sids`` uploads every state at creation so
    their loops never freeze."""
    device = torch.device(device)
    cache = getattr(table, "_device_tables", None)
    if cache is None:
        cache = table._device_tables = {}
    dt = cache.get(device)
    if dt is None or dt.V != int(vocab_size):
        dt = DeviceTable(table, vocab_size, cap=getattr(table, "preferred_cap", 192),
                         sid_cap=getattr(table, "preferred_sid_cap", 8192), device=device)
        for sid in getattr(table, "prewarm_sids", ()):
            dt.slot(sid)
        cache[device] = dt
    return dt
