"""Slot-based continuous-batching serving engine over a dense KV cache.

Port of the dense engine of ``videollamb_tpu/serve/server.py``: a fixed set
of cache slots decodes in lock-step while new requests prefill on their own
and take free slots.

- admission splices the request (tower, SceneTilling, bridge), prefills it
  at B=1 in 256-token chunks up to its real length and copies the rows into
  a free slot; siblings marked by :func:`share_prefill` copy one prefill;
- one step advances every active slot by ``k`` tokens and syncs with the
  host once per ``k`` tokens (:func:`decode_steps`): greedy rows by argmax,
  sampled rows by temperature, top_k then top_p; the count-dependent
  sampling controls (logit_bias, presence and frequency penalties,
  min_tokens) carry their generated-token counts on the device; choice and
  grammar constraints gather their masks and transitions from device tables
  (``serve/device_grammar.py``), a row that reaches a state not uploaded
  yet freezes and is rewound; ``logprobs`` rows record the base model's
  log-probabilities of their tokens and the top alternatives;
- at ``k = 1``, or when a constraint has no device table, one host-synced
  step with host masks instead;
- finished slots free at once, and their rows are reused;
- ``adapter_registry`` serves multi-LoRA requests (``models/lm/mlora.py``):
  each row decodes with its own adapter, -1 rows with the base model;
- with ``speculative="lookup"`` or ``"draft"`` an all-greedy batch without
  constraints, controls or logprobs advances by speculation rounds instead
  (``models/speculative.py``): each slot's proposals are verified in one
  ragged cache-extend, and the tokens are the target's greedy chain.

Each step records spans (``utils/profiling.py``) at its phase boundaries:
``engine.step`` over the call; ``engine.admit`` (each request's
``request.queue`` wait from ``submit``, ``admit.splice`` and ``admit.prefill``
under its uid); ``engine.pages``; ``engine.decode`` with ``decode.enqueue``
(the host queuing the k forwards), ``decode.sync`` (the readbacks) and
``decode.commit``; and a ``request.first_token`` mark per request.

:class:`ServingEngine` is also the base class of the paged engine
(``serve/paged.py``), which adds prefix caching. Sampling draws from a
``torch.Generator``, so sampled tokens differ from the JAX package's
(``jax.random``); greedy tokens are the same. Image, audio and mixed rows
splice at admission like video rows. A request's ``prompt_len`` (the row's
mask sum) spares the admission its one device-to-host readback: exact for
text rows, through :func:`spliced_prompt_len_host` for a single image under
an rmt-family projector, that formula checked against the device once per
shape signature (:meth:`ServingEngine._resolve_prompt_len`).

The engines run unchanged over a model sharded by
``parallel/sharding.shard_params`` (tensor parallel on 'model', FSDP units
on 'data'): every rank of the mesh steps its own engine in lockstep over the
same requests, with caches at its local kv heads; the logits are gathered,
so the decode loop, its controls, grammar tables and logprobs, and the
seeded generator of the sampled rows give every rank the same tokens.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from videollamb_torch.config import ModelConfig, is_mla
from videollamb_torch.models.assembly import MultimodalBatch, VideoLLaMB, prepare_multimodal_embeds
from videollamb_torch.models.lm.llama import (
    KVCache,
    chunked_prefill,
    embed_tokens,
    init_kv_cache,
    llama_decode_step,
)
from videollamb_torch.models.lm.family import dense_ops
from videollamb_torch.models.lm.mlora import adapter_rows
from videollamb_torch.parallel.sharding import gathered
from videollamb_torch.utils.profiling import RECORDER, mark, span


@dataclasses.dataclass
class Request:
    uid: Any
    batch: MultimodalBatch  # B=1
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0
    # Sampling controls: adjusted = logits + logit_bias
    #   - presence_penalty * 1[count > 0] - frequency_penalty * count,
    # counts over GENERATED tokens only; EOS is suppressed softly (-1e9, so a
    # grammar's forced closing still wins) while len(tokens) < min_tokens.
    logit_bias: Optional[Dict[int, float]] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    min_tokens: int = 0
    # 0 = off; else sample only among the top_k logits (before top_p).
    top_k: int = 0
    # Paged engine only: an id from PagedServingEngine.register_prefix; then
    # ``batch`` holds only the suffix (the question), the prefix (system and
    # media) comes from the shared cached pages.
    prefix_id: Any = None
    # Paged engine only: automatic prefix caching. ``batch`` again holds only
    # the suffix; the engine hashes this prefix batch, reuses a cached prefix
    # on a hit and registers it on a miss. Exclusive with ``prefix_id``.
    prefix_batch: Any = None
    # Multi-LoRA: the name of this request's adapter in the engine's
    # registry; None = the base model.
    adapter: Optional[str] = None
    # Choice constraint: token-id sequences the output must be one of.
    choices: Optional[List[List[int]]] = None
    # Grammar constraint (serve/grammar.py), e.g. json_constraint(tokenizer).
    # Exclusive with ``choices``.
    grammar: Any = None
    # Optional host-known prompt length (valid tokens in attention_mask).
    # Text rows splice to exactly this length; a single image through an
    # rmt-family projector to spliced_prompt_len_host's, checked once per
    # shape signature. Either spares admission one device-to-host readback.
    # Other media rows ignore it (their spliced length is device-computed).
    prompt_len: Optional[int] = None
    # Per-token logprobs (OpenAI "logprobs"): the chosen token's, and the
    # ``top_logprobs`` (<= TOP_LOGPROBS_K) best alternatives, always under the
    # base model's distribution (raw f32 log-softmax, see logprobs_of).
    logprobs: bool = False
    top_logprobs: int = 0
    # filled by the engine
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    # Per position: [(token_id, logprob), ...], top_logprobs long.
    top_tokens: List[List[tuple]] = dataclasses.field(default_factory=list)
    done: bool = False
    # Set when the engine drops the request without decoding it (e.g. a
    # prompt over the paged engine's per-sequence budget).
    error: Optional[str] = None
    # Called with (request, token) as each token is committed on the host.
    on_token: Any = None
    cancelled: bool = False
    # Engine-internal: (spliced batch, prompt length), staged by the paged
    # engine's convoy prefetch (_prefetch_admissions) or kept while
    # admission waits for pages, so backpressure does not encode again;
    # consumed and cleared at admission.
    _spliced_cache: Any = None
    # Engine-internal: the live choice or grammar cursor.
    _constraint: Any = None
    # Engine-internal: the share_prefill group of this request.
    _shared_prefill: Any = None
    # Engine-internal: when submit() queued the request (time.perf_counter),
    # and whether its wait in the queue is still to be recorded.
    _submitted: Optional[float] = None
    _queued: bool = False

    def __post_init__(self):
        if self.grammar is not None and self.choices:
            raise ValueError("'choices' and 'grammar' are mutually exclusive")
        if self.prefix_id is not None and self.prefix_batch is not None:
            raise ValueError("'prefix_id' and 'prefix_batch' are mutually exclusive")

    @property
    def has_sampling_controls(self) -> bool:
        return bool(self.logit_bias or self.presence_penalty or self.frequency_penalty
                    or len(self.tokens) < self.min_tokens)


def clone_request(req: Request) -> Request:
    """An independent sibling of an UNSTARTED request: the same (read-only)
    batch, fresh per-request state (a new grammar cursor over the same table,
    empty token lists), uid left to the caller. With :func:`share_prefill`
    the siblings also share the admission prefill."""
    from videollamb_torch.serve.grammar import GrammarConstraint

    grammar = GrammarConstraint(req.grammar.table) if req.grammar is not None else None
    return Request(
        uid=None, batch=req.batch, max_new_tokens=req.max_new_tokens,
        temperature=req.temperature, top_p=req.top_p, top_k=req.top_k,
        logit_bias=dict(req.logit_bias) if req.logit_bias else None,
        presence_penalty=req.presence_penalty, frequency_penalty=req.frequency_penalty,
        min_tokens=req.min_tokens, prefix_id=req.prefix_id,
        prefix_batch=req.prefix_batch if req.prefix_id is None else None,
        adapter=req.adapter, choices=[list(c) for c in req.choices] if req.choices else None,
        grammar=grammar, prompt_len=req.prompt_len, logprobs=req.logprobs,
        top_logprobs=req.top_logprobs)


def spliced_prompt_len_host(cfg: ModelConfig, batch: MultimodalBatch,
                            text_len: int) -> Optional[int]:
    """The exact spliced prompt length computed on the host, or None where
    only the device knows it.

    ``text_len`` is the caller's token count of the row (its mask sum, the
    media sentinel included). For a single IMAGE through an rmt-family
    projector the visual block is always ``tokens_per_frame`` valid tokens
    (one pooled frame, every token valid), so the length is
    ``text_len - 1 + tokens_per_frame``. VIDEO rows return None: the RMT-R
    splice carries only the last SceneTilling segment, whose valid frame
    count depends on where the boundaries fall. Mixed blocks, anyres,
    batched rows and other projector kinds return None too. Engines check
    the formula against the device sum once per shape signature before
    trusting it (:meth:`ServingEngine._resolve_prompt_len`)."""
    b = batch
    if b.images is None or b.videos is not None or b.blocks is not None:
        return None
    if b.images.dim() != 4 or b.images.shape[0] != 1:
        return None
    br = cfg.bridge
    if br.kind not in ("rmt_transformer", "rmt_r_transformer"):
        return None
    return min(text_len - 1 + br.tokens_per_frame, cfg.max_length)


def _length_mismatch(host: int, device: int, sig) -> RuntimeError:
    return RuntimeError(
        f"host spliced-length formula gave {host} but the device splice produced "
        f"{device} for signature {sig}; the request's prompt_len must be the row's "
        "attention-mask sum with exactly one media sentinel")


def share_prefill(reqs: List[Request]) -> None:
    """Mark sibling requests (same batch, see clone_request) to share ONE
    admission prefill: the first admitted computes it, the rest copy its
    single-row cache into their slots. The shared cache is dropped once
    every sibling has passed admission (_shared_consume)."""
    shared = {"data": None, "left": len(reqs)}
    for r in reqs:
        r._shared_prefill = shared


def _shared_consume(req: Request) -> None:
    """One sibling is through admission (prefilled, dropped or rejected): the
    shared single-row cache is freed after the last one."""
    shared = req._shared_prefill
    if shared is not None:
        shared["left"] -= 1
        if shared["left"] <= 0:
            shared["data"] = None


def insert_into_cache(batch_cache: KVCache, single: KVCache, slot: int) -> None:
    """Copy a prefilled B=1 cache into row ``slot`` of the batch cache (in
    place); the rest of the row is zeroed."""
    s_single = single.k.shape[2]
    for buf, row in ((batch_cache.k, single.k), (batch_cache.v, single.v)):
        buf[:, slot] = 0
        buf[:, slot, :s_single] = row[:, 0].to(buf.dtype)
    batch_cache.length[slot] = single.length[0]


# ----------------------------------------------------------------------
# Sampling, controls, logprobs


def build_control_adjustments(slots, vocab_size: int, eos: int) -> Optional[np.ndarray]:
    """(B, V) additive logit adjustments of the slots with sampling controls
    (the host per-step path), or None when no slot has any. min_tokens
    suppresses EOS softly (-1e9, not the constraint mask's -1e30), so a
    grammar that leaves only EOS legal still closes."""
    rows: Optional[np.ndarray] = None
    for i, r in enumerate(slots):
        if r is None or not r.has_sampling_controls:
            continue
        if rows is None:
            rows = np.zeros((len(slots), vocab_size), np.float32)
        if r.logit_bias:
            for t, b in r.logit_bias.items():
                t = int(t)
                if 0 <= t < vocab_size:
                    rows[i, t] += float(b)
        if (r.presence_penalty or r.frequency_penalty) and r.tokens:
            counts = np.bincount(np.asarray(r.tokens, np.int64),
                                 minlength=vocab_size)[:vocab_size]
            rows[i] -= np.float32(r.frequency_penalty) * counts
            rows[i] -= np.float32(r.presence_penalty) * (counts > 0)
        if len(r.tokens) < r.min_tokens and 0 <= eos < vocab_size:
            rows[i, eos] -= 1e9
    return rows


def build_control_tensors(slots, vocab_size: int):
    """Per-row control arrays of the device loop: logit_bias rows, penalty
    coefficients, the generated-token counts so far (the loop updates them)
    and the min_tokens budget left. Rows without a control are zeros."""
    b = len(slots)
    bias = np.zeros((b, vocab_size), np.float32)
    pres = np.zeros((b,), np.float32)
    freq = np.zeros((b,), np.float32)
    counts = np.zeros((b, vocab_size), np.float32)
    min_left = np.zeros((b,), np.int32)
    for i, r in enumerate(slots):
        if r is None:
            continue
        if r.logit_bias:
            for t, v in r.logit_bias.items():
                t = int(t)
                if 0 <= t < vocab_size:
                    bias[i, t] += float(v)
        if r.presence_penalty or r.frequency_penalty:
            pres[i] = np.float32(r.presence_penalty)
            freq[i] = np.float32(r.frequency_penalty)
            if r.tokens:
                counts[i] = np.bincount(np.asarray(r.tokens, np.int64),
                                        minlength=vocab_size)[:vocab_size]
        min_left[i] = max(0, r.min_tokens - len(r.tokens))
    return bias, pres, freq, counts, min_left


def slot_sampling_vectors(slots):
    """(temps, top_ks, top_ps) host vectors from the slot list; empty slots greedy."""
    temps = np.asarray([(r.temperature if r is not None else 0.0) for r in slots], np.float32)
    top_ps = np.asarray([(r.top_p if r is not None else 1.0) for r in slots], np.float32)
    top_ks = np.asarray([(r.top_k if r is not None else 0) for r in slots], np.int64)
    return temps, top_ks, top_ps


class SamplingRows:
    """Device copies of the sampled rows' temperature, top_k and top_p, made
    once per decode call (a host-to-device copy each step would sync the
    host with the card)."""

    def __init__(self, temps: np.ndarray, top_ks: np.ndarray, top_ps: np.ndarray, device):
        hot = np.flatnonzero(temps > 0)
        self.any = hot.size > 0
        if not self.any:
            return
        self.rows = torch.as_tensor(hot, device=device)
        self.temp = torch.as_tensor(temps[hot], dtype=torch.float32, device=device)
        self.top_k = torch.as_tensor(top_ks[hot], dtype=torch.long, device=device)
        self.top_p = torch.as_tensor(top_ps[hot], dtype=torch.float32, device=device)
        # Pure temperature rows skip the full-vocabulary sort.
        self.filter = bool((top_ks[hot] > 0).any() or (top_ps[hot] < 1.0).any())

    def sample(self, logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Next token per row: argmax where the temperature is 0, else a draw
        from the temperature-scaled logits kept by top_k, then by the nucleus
        top_p (HF semantics), as the JAX package's ``sample_rows``."""
        nxt = torch.argmax(logits, dim=-1)
        if not self.any:
            return nxt
        scaled = logits[self.rows].float() / self.temp.clamp_min(1e-6)[:, None]
        if self.filter:
            v = scaled.shape[-1]
            sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
            kth_idx = torch.where(self.top_k > 0, self.top_k.clamp(max=v) - 1, v - 1)
            kth = sorted_desc.gather(1, kth_idx[:, None])
            off = (self.top_k == 0)[:, None]
            scaled = torch.where((scaled >= kth) | off, scaled, -torch.inf)
            sorted_logits = torch.where((sorted_desc >= kth) | off, sorted_desc, -torch.inf)
            probs = torch.softmax(sorted_logits, dim=-1)
            keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < self.top_p[:, None]
            threshold = torch.where(keep_sorted, sorted_logits, torch.inf).amin(dim=-1,
                                                                               keepdim=True)
            scaled = torch.where(scaled >= threshold, scaled, -torch.inf)
        draw = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)[:, 0]
        nxt[self.rows] = draw
        return nxt


def sample_rows(logits: torch.Tensor, generator: Optional[torch.Generator], temps: np.ndarray,
                top_ks: np.ndarray, top_ps: np.ndarray) -> torch.Tensor:
    """One draw per row (see :meth:`SamplingRows.sample`); host vectors."""
    return SamplingRows(temps, top_ks, top_ps, logits.device).sample(logits, generator)


# One top-k width for logprob extraction (the OpenAI API caps top_logprobs
# at 20), whatever the requests ask for.
TOP_LOGPROBS_K = 20


def logprobs_of(logits: torch.Tensor, nxt: torch.Tensor, top_k: int = TOP_LOGPROBS_K):
    """Per row: the chosen token's logprob and the top_k alternatives under
    the BASE model's distribution (f32 log-softmax of the raw logits:
    temperature, top_p, controls and masks do not change what is reported)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    chosen = logp.gather(1, nxt[:, None].long())[:, 0]
    top_vals, top_ids = torch.topk(logp, min(top_k, logp.shape[-1]), dim=-1)
    return chosen, top_vals, top_ids


# ----------------------------------------------------------------------
# Device grammar tables inside the decode loop


def grammar_mask_logits(logits: torch.Tensor, slot: torch.Tensor, remaining: torch.Tensor,
                        pool_costs: torch.Tensor) -> torch.Tensor:
    """Budget-aware grammar mask gathered from the state pool by slot: a token
    stays legal iff its closing cost fits the budget left after emitting it
    (the host path's set_remaining rule)."""
    return torch.where(pool_costs[slot] <= (remaining - 1)[:, None], logits, -torch.inf)


def grammar_transition(nxt: torch.Tensor, slot: torch.Tensor, invalid_at: torch.Tensor,
                       step: int, k: int, pool_next: torch.Tensor, sid2slot: torch.Tensor):
    """Machine transition through the pool's next-sid row; a row that lands
    on a state not uploaded yet freezes at ``step``. Returns (new slot,
    invalid_at)."""
    sid_cap = sid2slot.shape[0]
    nsid = pool_next[slot].gather(1, nxt[:, None])[:, 0].long()
    mapped = sid2slot[nsid.clamp(0, sid_cap - 1)].long()
    unknown = ((nsid >= 0) & ((nsid >= sid_cap) | (mapped == -1))) | (nsid == -1)
    invalid_at = torch.where(unknown & (invalid_at == k), step, invalid_at)
    new_slot = torch.where(nsid >= 0, mapped.clamp(min=0), 0)
    # Frozen rows decode unconstrained garbage that the host discards.
    return torch.where(invalid_at <= step, 0, new_slot), invalid_at


class DeviceGrammar(NamedTuple):
    """The loop's view of a device table: its pools, each slot's start state
    slot and token budget."""
    costs: torch.Tensor
    next_sid: torch.Tensor
    sid2slot: torch.Tensor
    slots0: np.ndarray
    remaining0: np.ndarray


class Decoded(NamedTuple):
    tokens: torch.Tensor                 # (B, k)
    logprobs: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    logits: torch.Tensor                 # (B, V) after the last step
    invalid_at: Optional[torch.Tensor]   # (B,) freeze step, k if none
    frozen_logits: Optional[torch.Tensor]


@torch.no_grad()
def decode_steps(forward: Callable[[torch.Tensor], torch.Tensor], logits: torch.Tensor, k: int,
                 *, generator: Optional[torch.Generator] = None,
                 sampling: Optional[SamplingRows] = None, controls=None, eos: int = -1,
                 grammar: Optional[DeviceGrammar] = None, top_k: int = 0) -> Decoded:
    """k decode steps on the device with one host sync at the end.

    ``forward(tokens (B,)) -> logits (B, V)`` advances the engine's cache by
    one token. Per step: the control adjustments (``controls``, the arrays of
    :func:`build_control_tensors`: logits + bias - freq * counts - pres *
    [counts > 0], EOS at -1e9 while min_tokens is left; the counts update
    on the device), then the budget-aware grammar mask (``grammar``), then
    argmax or the rows' draw (``sampling``), then the grammar transition.
    With ``top_k`` > 0 each step also records the base distribution's
    logprobs (:func:`logprobs_of` of the raw logits). This one loop stands
    for the JAX package's greedy / sampled / controls / grammar scans of
    both engines.

    A grammar row that freezes at step t (its token is valid; the next
    state is not uploaded yet) decodes garbage after t: ``invalid_at[i] =
    t``, ``frozen_logits[i]`` holds its logits right after token t, and the
    engine rewinds its cache length by k - 1 - t. Rows past their EOS decode
    garbage too, which the host discards.
    """
    b, dev = logits.shape[0], logits.device
    if controls is not None:
        bias, pres, freq, counts, min_left = (torch.as_tensor(c, device=dev) for c in controls)
        rowix = torch.arange(b, device=dev)
    if grammar is not None:
        slot = torch.as_tensor(grammar.slots0, dtype=torch.long, device=dev)
        remaining = torch.as_tensor(grammar.remaining0, dtype=torch.long, device=dev)
        invalid_at = torch.full((b,), k, dtype=torch.long, device=dev)
        frozen_logits = torch.zeros_like(logits)
    toks, lps = [], []
    for step in range(k):
        adjusted = logits
        if controls is not None:
            adj = bias - freq[:, None] * counts - pres[:, None] * (counts > 0)
            if eos >= 0:
                adj[:, eos] += torch.where(step < min_left, -1e9, 0.0)
            adjusted = logits + adj
        if grammar is not None:
            adjusted = grammar_mask_logits(adjusted, slot, remaining, grammar.costs)
        if sampling is not None:
            nxt = sampling.sample(adjusted, generator)
        else:
            nxt = torch.argmax(adjusted, dim=-1)
        if top_k:
            lps.append(logprobs_of(logits, nxt, top_k))
        if controls is not None:
            counts[rowix, nxt] += 1.0
        if grammar is not None:
            slot, invalid_at = grammar_transition(nxt, slot, invalid_at, step, k,
                                                  grammar.next_sid, grammar.sid2slot)
        toks.append(nxt)
        logits = forward(nxt)
        if grammar is not None:
            frozen_logits = torch.where((invalid_at == step)[:, None], logits, frozen_logits)
            remaining = remaining - 1
    lp = tuple(torch.stack(x, dim=1) for x in zip(*lps)) if top_k else None
    return Decoded(torch.stack(toks, dim=1), lp, logits,
                   invalid_at if grammar is not None else None,
                   frozen_logits if grammar is not None else None)


class ServingEngine:
    def __init__(self, model: VideoLLaMB, cfg: ModelConfig, *, num_slots: int = 4,
                 eos_token_id: int = 2, seed: int = 0,
                 adapter_registry: Optional[Dict[str, int]] = None,
                 speculative: Optional[str] = None, spec_k: int = 8, draft_params=None,
                 draft_cfg=None):
        # Batched speculation: an all-greedy batch verifies up to spec_k tokens
        # per slot in ONE ragged cache-extend (verify_chunks_batched).
        # - 'lookup': prompt-lookup proposals, matched on the host;
        # - 'draft': a draft LM (a module; same tokenizer AND hidden size, as
        #   the spliced prompt embeds feed its prefill too; for instance an
        #   int8 copy of the target) proposes on the device.
        if is_mla(cfg.lm):
            raise ValueError("the dense ServingEngine serves the Llama family; serve the "
                             "DeepSeek-V3 family (latent attention, routed experts) with "
                             "serve/paged.PagedServingEngine (batch_cli --paged)")
        if speculative not in (None, "lookup", "draft"):
            raise ValueError(f"speculative={speculative!r}: 'lookup' or 'draft'")
        if speculative == "draft":
            if draft_params is None or draft_cfg is None:
                raise ValueError("speculative='draft' needs draft_params and draft_cfg")
            if draft_cfg.hidden_size != cfg.lm.hidden_size:
                raise ValueError(
                    "draft hidden_size must match the target's "
                    f"({draft_cfg.hidden_size} != {cfg.lm.hidden_size}): "
                    "the spliced prompt embeds feed the draft prefill")
        self._init_slots(model, cfg, num_slots, eos_token_id, seed, adapter_registry)
        self.speculative = speculative
        self.spec_k = spec_k
        self.max_seq_len = cfg.max_length + 512
        self.cache = init_kv_cache(cfg.lm, num_slots, self.max_seq_len, dtype=self._dtype,
                                   device=self.device, lm=model.lm)
        if speculative == "draft":
            self.draft_lm = getattr(draft_params, "lm", draft_params)
            self.draft_cfg = draft_cfg
            self.draft_cache = init_kv_cache(draft_cfg, num_slots, self.max_seq_len,
                                             dtype=self._dtype, device=self.device)

    def _init_slots(self, model: VideoLLaMB, cfg: ModelConfig, num_slots: int,
                    eos_token_id: int, seed: int, adapter_registry=None) -> None:
        """State every engine shares; the cache runs in the LM's device and dtype."""
        self.model = model
        self.cfg = cfg
        self.num_slots = num_slots
        self.eos = eos_token_id
        weight = model.lm.model.embed_tokens.weight
        self.device, self._dtype = weight.device, weight.dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.speculative: Optional[str] = None  # the dense engine may set it
        self.spec_rounds = 0
        self.spec_committed = 0
        self._spec_nxt0: Optional[np.ndarray] = None
        self.slots: List[Optional[Request]] = [None] * num_slots
        # Last logits per slot (B, V); rows of empty slots are garbage.
        self.logits = torch.zeros((num_slots, cfg.lm.vocab_size), dtype=torch.float32,
                                  device=self.device)
        self.pending: "queue.Queue[Request]" = queue.Queue()
        # Requests dropped at admission (cancelled or rejected); step()
        # returns them with the finished ones.
        self._dropped: List[Request] = []
        # Multi-LoRA: adapter name -> index into the LM's stacks; each slot's
        # index on the device, and its host mirror, which gates the adapter
        # gathers off while no active slot has an adapter.
        self.adapter_registry = adapter_registry
        self.adapter_idx = torch.full((num_slots,), -1, dtype=torch.long, device=self.device)
        self._adapter_host = np.full((num_slots,), -1, np.int64)
        self._choice_tables: dict = {}
        # Shape signatures whose host prompt-length formula matched the device.
        self._len_verified: set = set()

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        request._submitted = time.perf_counter()
        request._queued = True
        self.pending.put(request)

    @staticmethod
    def _admission_starts(req: Request) -> None:
        """Record the request's wait in the queue, from submit to the first
        work of its admission, once."""
        if req._queued:
            req._queued = False
            RECORDER.add("request.queue", req.uid, req._submitted, time.perf_counter())

    @staticmethod
    def _first_token(req: Request) -> None:
        if len(req.tokens) == 1:
            mark("request.first_token", req.uid, since=req._submitted)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    @staticmethod
    def _readback(t: torch.Tensor) -> np.ndarray:
        """The one device-to-host copy of admission's prompt lengths."""
        return t.cpu().numpy()

    def _host_prompt_len(self, req: Request):
        """None (the device sum is needed), or ``(length, sig)``: ``sig`` is
        None for lengths exact by contract (text rows: the mask sum) and a
        shape signature for formula lengths (spliced_prompt_len_host), which
        must match the device sum once before they are trusted."""
        if req.prompt_len is None:
            return None
        b = req.batch
        if b.videos is None and b.images is None and b.blocks is None:
            return int(req.prompt_len), None
        val = spliced_prompt_len_host(self.cfg, b, int(req.prompt_len))
        if val is None:
            return None
        return val, (tuple(b.images.shape), int(req.prompt_len))

    def _trusted_prompt_len(self, req: Request) -> Optional[int]:
        hint = self._host_prompt_len(req)
        if hint is not None and (hint[1] is None or hint[1] in self._len_verified):
            return hint[0]
        return None

    def _check_prompt_len(self, req: Request, prompt_len: int) -> None:
        """Verify (and then trust) the request's host formula, if it has one."""
        hint = self._host_prompt_len(req)
        if hint is not None:
            if hint[0] != prompt_len:
                raise _length_mismatch(hint[0], prompt_len, hint[1])
            self._len_verified.add(hint[1])

    def _resolve_prompt_len(self, req: Request, spliced) -> int:
        """Spliced prompt length: the host's when known and verified, else the
        device mask sum (verifying the host formula for its signature)."""
        trusted = self._trusted_prompt_len(req)
        if trusted is not None:
            return trusted
        prompt_len = int(self._readback(spliced.attention_mask.sum()))
        self._check_prompt_len(req, prompt_len)
        return prompt_len

    def _splice(self, req: Request):
        """(spliced batch, prompt length) of a request, kept on it until admitted."""
        if req._spliced_cache is None:
            self._admission_starts(req)
            with span("admit.splice", req.uid):
                spliced = prepare_multimodal_embeds(self.model, self.cfg, req.batch)
                req._spliced_cache = (spliced, self._resolve_prompt_len(req, spliced))
        return req._spliced_cache

    def _drop(self, req: Request, error: Optional[str] = None) -> None:
        req.done = True
        req.error = error
        req._spliced_cache = None
        self._dropped.append(req)
        _shared_consume(req)

    def _refusal(self, req: Request) -> Optional[str]:
        """Why admission must drop ``req`` (None: admit it)."""
        if req.adapter is not None and (self.adapter_registry is None
                                        or req.adapter not in self.adapter_registry):
            return (f"unknown adapter {req.adapter!r}" if self.adapter_registry is not None
                    else "engine has no adapter registry")
        if req.prefix_id is not None or req.prefix_batch is not None:
            return self._prefix_refusal(req)
        return None

    def _prefix_refusal(self, req: Request) -> Optional[str]:
        # Decoding the suffix as a whole prompt would be wrong output.
        return "prefix caching (prefix_id/prefix_batch) requires the paged engine"

    def _set_adapter(self, slot: int, req: Request) -> Optional[torch.Tensor]:
        """Record the slot's adapter; returns the (1,) index of its prefill,
        None for the base model."""
        val = self.adapter_registry[req.adapter] if req.adapter is not None else -1
        self._adapter_host[slot] = val
        self.adapter_idx[slot] = val
        return torch.tensor([val], device=self.device) if val >= 0 else None

    def _prefill(self, req: Request, aidx1: Optional[torch.Tensor]):
        """(logits (1, V), dense B=1 cache, draft cache or None) of the request,
        or its share_prefill sibling's."""
        shared = req._shared_prefill
        if shared is not None and shared["data"] is not None:
            return shared["data"]
        spliced, prompt_len = self._splice(req)
        req._spliced_cache = None
        with span("admit.prefill", req.uid):
            embeds = spliced.embeds.to(self._dtype)
            ops = dense_ops(self.cfg.lm)
            single = ops.init_cache(self.cfg.lm, 1, self.cfg.max_length, dtype=self._dtype,
                                    device=self.device, lm=self.model.lm)
            with adapter_rows(self.model.lm, aidx1):
                logits, single = ops.chunked_prefill(self.model.lm, self.cfg.lm, embeds,
                                                     spliced.attention_mask, single,
                                                     lengths=[prompt_len])
            dsingle = None
            if self.speculative == "draft":
                # The draft tracks the same context from the same spliced embeds.
                dsingle = init_kv_cache(self.draft_cfg, 1, self.cfg.max_length,
                                        dtype=self._dtype, device=self.device)
                _, dsingle = chunked_prefill(self.draft_lm, self.draft_cfg, embeds,
                                             spliced.attention_mask, dsingle,
                                             lengths=[prompt_len])
        data = (logits, single, dsingle)
        if shared is not None:
            shared["data"] = data
        return data

    def _admit(self) -> None:
        while not self.pending.empty():
            slot = self._free_slot()
            if slot is None:
                return
            req = self.pending.get()
            if req.cancelled:
                self._drop(req)
                continue
            refusal = self._refusal(req)
            if refusal is not None:
                self._drop(req, refusal)
                continue
            self._admission_starts(req)
            logits, single, dsingle = self._prefill(req, self._set_adapter(slot, req))
            _shared_consume(req)
            insert_into_cache(self.cache, single, slot)
            if self.speculative == "draft":
                insert_into_cache(self.draft_cache, dsingle, slot)
            self.logits[slot] = logits[0]
            self._install_constraint(req)
            self.slots[slot] = req
            # Admission rewrote a logits row: the next-argmax carried between
            # speculation rounds is stale.
            self._spec_nxt0 = None

    def set_adapters(self, model: VideoLLaMB, registry: Optional[Dict[str, int]]) -> None:
        """Swap the multi-LoRA stack (a model whose LM carries it, and its
        registry). Call between steps, with no adapter request in flight:
        in-flight requests pin the old index space."""
        if (self._adapter_host >= 0).any():
            raise RuntimeError("adapter requests in flight; retry when drained")
        self.model = model
        self.adapter_registry = registry

    def _install_constraint(self, req: Request) -> None:
        """Install the request's decode constraint, if any: a grammar cursor
        (the budget extended to its shortest completion, so forced closing
        always has room) or a choice-set trie (the budget extended to the
        longest choice). Choice tables are cached per choice-set signature,
        so same-choice requests share one device table."""
        if req.grammar is not None:
            req._constraint = req.grammar
            req.max_new_tokens = max(req.max_new_tokens, getattr(req.grammar, "min_tokens", 1))
            return
        if not req.choices:
            return
        from videollamb_torch.serve.constrained import ChoiceConstraint, ChoiceTable, TokenTrie

        table = None
        if self.eos is not None and self.eos >= 0:
            sig = tuple(tuple(int(t) for t in c) for c in req.choices)
            table = self._choice_tables.get(sig)
            if table is None:
                if len(self._choice_tables) >= 256:  # bound the per-engine cache
                    self._choice_tables.clear()
                table = self._choice_tables[sig] = ChoiceTable(TokenTrie(req.choices), self.eos)
        trie = table.trie if table is not None else TokenTrie(req.choices)
        req._constraint = ChoiceConstraint(trie, eos_token_id=self.eos, table=table)
        req.max_new_tokens = max(req.max_new_tokens, trie.max_len)

    def _live_adapter_idx(self) -> Optional[torch.Tensor]:
        """The device index vector iff an active slot has an adapter, else
        None (the adapter gathers are skipped)."""
        if self.adapter_registry is None or not (self._adapter_host >= 0).any():
            return None
        return self.adapter_idx

    def _active_mask(self) -> np.ndarray:
        return np.asarray([r is not None for r in self.slots])

    def _wants_logprobs(self) -> bool:
        return any(r is not None and r.logprobs for r in self.slots)

    @staticmethod
    def _commit_logprob(req: Request, chosen, top_vals, top_ids) -> None:
        req.token_logprobs.append(float(chosen))
        if req.top_logprobs > 0:
            n = min(req.top_logprobs, len(top_ids))
            req.top_tokens.append([(int(top_ids[j]), float(top_vals[j])) for j in range(n)])

    def has_work(self) -> bool:
        return any(r is not None for r in self.slots) or not self.pending.empty()

    def _drain_dropped(self) -> List[Request]:
        dropped, self._dropped = self._dropped, []
        return dropped

    def _commit_k_tokens(self, toks_host: np.ndarray, lp_host, k: int, finished: List[Request],
                         invalid_host: Optional[np.ndarray] = None) -> np.ndarray:
        """Append each slot's tokens up to EOS, its budget or its constraint's
        end (a frozen grammar row: up to its freeze step), record logprobs,
        advance constraint cursors, fire the streaming hooks and release
        finished slots. Returns the rows that froze and go on next sync."""
        frozen = np.zeros((self.num_slots,), bool)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req.cancelled:
                req.done = True
                finished.append(req)
                self._release(i)
                continue
            con = req._constraint
            valid = k if con is None or invalid_host is None else min(k, int(invalid_host[i]) + 1)
            for t in range(valid):
                tok = int(toks_host[i, t])
                req.tokens.append(tok)
                self._first_token(req)
                if lp_host is not None and req.logprobs:
                    self._commit_logprob(req, lp_host[0][i, t], lp_host[1][i, t],
                                         lp_host[2][i, t])
                if req.on_token is not None:
                    req.on_token(req, tok)
                if con is not None:
                    con.advance(tok)  # interns the next state for upload
                if (tok == self.eos or len(req.tokens) >= req.max_new_tokens
                        or (con is not None and con.finished)):
                    req.done = True
                    finished.append(req)
                    self._release(i)
                    break
            else:
                frozen[i] = (con is not None and invalid_host is not None
                             and invalid_host[i] < k)
        return frozen

    def _release(self, slot: int) -> None:
        """Free a slot, its adapter index and its cache row."""
        self.slots[slot] = None
        if self._adapter_host[slot] >= 0:
            self._adapter_host[slot] = -1
            self.adapter_idx[slot] = -1
        self._free_cache_row(slot)

    def _free_cache_row(self, slot: int) -> None:
        """The row restarts at length 0: a free row keeps stepping with the
        batch, and the JAX package's out-of-range cache writes (dropped there)
        would be index errors here."""
        self.cache.length[slot] = 0
        if self.speculative == "draft":
            self.draft_cache.length[slot] = 0

    # ------------------------------------------------------------------
    # Decode: the cache-specific hooks the paged engine overrides.
    def _forward(self, nxt: torch.Tensor) -> torch.Tensor:
        """One decode step of every slot (tokens (B,) -> logits (B, V))."""
        tok_embeds = embed_tokens(self.model.lm, nxt[:, None]).to(self.cache.k.dtype)
        logits, self.cache = llama_decode_step(self.model.lm, self.cfg.lm, tok_embeds,
                                               self.cache)
        return logits

    def _advanced(self, k: int) -> None:
        """Host bookkeeping after k decode steps."""

    def _rewind(self, frozen: np.ndarray, garbage: np.ndarray) -> None:
        """Rewind frozen rows' cache lengths over their garbage steps: the
        next steps write over them."""
        self.cache = self.cache._replace(
            length=self.cache.length - torch.as_tensor(garbage, device=self.device))

    def _prepare_decode(self, k: int) -> None:
        """Make room for k more tokens of every active slot."""

    def _spec_context(self, req: Request) -> List[int]:
        """Token context for prompt-lookup proposals: the VALID text prompt ids
        (media sentinels included: they never collide with generated ids)
        plus everything generated so far. The bucket padding is cut off by the
        attention mask, so a tail n-gram near the end of the prompt proposes
        the real continuation, not pad zeros."""
        ctx = getattr(req, "_spec_prompt_ids", None)
        if ctx is None:
            n_valid = int(req.batch.attention_mask[0].sum())
            ctx = [int(t) for t in req.batch.input_ids[0, :n_valid].tolist()]
            req._spec_prompt_ids = ctx
        return ctx + req.tokens

    @torch.no_grad()
    def _step_speculative(self, dropped: List[Request]) -> List[Request]:
        """One speculation round: propose up to spec_k - 1 continuations per
        slot, verify all slots in ONE ragged cache-extend, commit each row's
        accepted prefix. The tokens are those of plain greedy decoding."""
        from videollamb_torch.models.speculative import (
            draft_propose_batched,
            propose_lookup,
            roll_draft_cache,
            verify_chunks_batched,
        )

        b, kk = self.num_slots, self.spec_k
        mask = np.zeros((b, kk), np.int64)
        if self.speculative == "draft":
            # Chunk column 0 is each row's committed-next token: the draft
            # loop embeds it first and emits it back.
            with span("decode.enqueue"):
                chunks_dev, self.draft_cache = draft_propose_batched(
                    self.draft_lm, self.draft_cfg, torch.argmax(self.logits, dim=-1),
                    self.draft_cache, kk)
                for i, r in enumerate(self.slots):
                    if r is not None:
                        mask[i, :max(1, min(kk, r.max_new_tokens - len(r.tokens)))] = 1
                accepted, self.logits, _, self.cache = verify_chunks_batched(
                    self.model, self.cfg, chunks_dev, torch.from_numpy(mask).to(self.device),
                    self.cache)
                self.draft_cache = roll_draft_cache(self.draft_cache, accepted, kk)
            self.spec_rounds += 1
            with span("decode.sync"):
                chunks_host, acc_host = chunks_dev.cpu().numpy(), accepted.cpu().numpy()
            with span("decode.commit"):
                return self._spec_commit(chunks_host, acc_host, dropped)

        # One host sync per round: nxt0 rides the PREVIOUS verify's readback,
        # unless an admission or a plain step rewrote the logits rows.
        nxt0 = self._spec_nxt0
        if nxt0 is None:
            with span("decode.sync"):
                nxt0 = torch.argmax(self.logits, dim=-1).cpu().numpy()
        chunks = np.zeros((b, kk), np.int64)
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            chunks[i, 0] = nxt0[i]
            mask[i, 0] = 1
            room = min(kk - 1, r.max_new_tokens - len(r.tokens) - 1)
            if room > 0 and nxt0[i] != self.eos:
                prop = propose_lookup(self._spec_context(r) + [int(nxt0[i])], k=room)
                chunks[i, 1:1 + len(prop)] = prop
                mask[i, 1:1 + len(prop)] = 1
        with span("decode.enqueue"):
            accepted, self.logits, next_argmax, self.cache = verify_chunks_batched(
                self.model, self.cfg, torch.from_numpy(chunks).to(self.device),
                torch.from_numpy(mask).to(self.device), self.cache)
        with span("decode.sync"):
            acc_host = accepted.cpu().numpy()
            self._spec_nxt0 = next_argmax.cpu().numpy()
        self.spec_rounds += 1
        with span("decode.commit"):
            return self._spec_commit(chunks, acc_host, dropped)

    def _spec_commit(self, chunks: np.ndarray, acc_host: np.ndarray,
                     finished: List[Request]) -> List[Request]:
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req.cancelled:
                req.done = True
                finished.append(req)
                self._release(i)
                continue
            for t in range(int(acc_host[i])):
                tok = int(chunks[i, t])
                req.tokens.append(tok)
                self._first_token(req)
                # Count only the tokens DELIVERED: acceptance past an EOS or
                # the budget would overstate the statistics.
                self.spec_committed += 1
                if req.on_token is not None:
                    req.on_token(req, tok)
                if tok == self.eos or len(req.tokens) >= req.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    self._release(i)
                    break
        return finished

    def _grammar_device_setup(self) -> Optional[DeviceGrammar]:
        """The device view of the constrained slots' tables when every one
        rides a device table (a grammar's or a choice trie's) and the pools
        have room; None -> the per-step host-mask path. A batch mixing
        different tables rides a CombinedDeviceTable; unconstrained rows ride
        the FREE slot 0."""
        from videollamb_torch.serve.device_grammar import (
            FREE_REMAINING,
            combined_table_for,
            device_table_for,
        )

        tables = []  # distinct, in order of first appearance
        for r in self.slots:
            c = r._constraint if r is not None else None
            if c is None:
                continue
            if getattr(c, "table", None) is None or c.node is None:
                return None
            if all(c.table is not t for t in tables):
                tables.append(c.table)
        if not tables:
            return None
        dts = [device_table_for(t, self.cfg.lm.vocab_size, self.device) for t in tables]
        # Upload every constrained slot's current state first (it mutates the
        # member pools), then combine: refresh() folds the uploads in.
        local = {}
        for i, r in enumerate(self.slots):
            c = r._constraint if r is not None else None
            if c is None:
                continue
            ti = next(j for j, t in enumerate(tables) if t is c.table)
            s = dts[ti].slot(c.node)
            if s is None:
                return None  # pool full
            local[i] = (ti, s)
        if len(dts) == 1:
            dt, slot_base = dts[0], (0,)
        else:
            dt = combined_table_for(dts)
            slot_base = dt.slot_base
        slots0 = np.zeros((self.num_slots,), np.int64)
        remaining0 = np.full((self.num_slots,), FREE_REMAINING, np.int64)
        for i, (ti, s) in local.items():
            slots0[i] = int(slot_base[ti]) + s
            remaining0[i] = max(1, self.slots[i].max_new_tokens - len(self.slots[i].tokens))
        return DeviceGrammar(dt.costs, dt.next_sid, dt.sid2slot, slots0, remaining0)

    @torch.no_grad()
    def _step_device(self, k: int, dropped: List[Request], grammar=None) -> List[Request]:
        """k decode steps on the device (greedy, sampled, with controls and
        logprobs as the slots ask), then the commit; frozen grammar rows get
        their logits back and their lengths rewound."""
        temps, top_ks, top_ps = slot_sampling_vectors(self.slots)
        sampling = SamplingRows(temps, top_ks, top_ps, self.device) if (temps > 0).any() else None
        controls = None
        if any(r is not None and r.has_sampling_controls for r in self.slots):
            controls = build_control_tensors(self.slots, self.cfg.lm.vocab_size)
        with span("decode.enqueue"), adapter_rows(self.model.lm, self._live_adapter_idx()):
            out = decode_steps(self._forward, self.logits, k, generator=self.generator,
                               sampling=sampling, controls=controls,
                               eos=self.eos if self.eos is not None else -1, grammar=grammar,
                               top_k=TOP_LOGPROBS_K if self._wants_logprobs() else 0)
        self.logits = out.logits
        self._advanced(k)
        with span("decode.sync"):
            lp_host = tuple(a.cpu().numpy() for a in out.logprobs) if out.logprobs else None
            invalid_host = out.invalid_at.cpu().numpy() if grammar is not None else None
            toks_host = out.tokens.cpu().numpy()
        with span("decode.commit"):
            frozen = self._commit_k_tokens(toks_host, lp_host, k, dropped, invalid_host)
        if frozen.any():
            garbage = np.where(frozen, k - 1 - invalid_host, 0)
            rows = torch.as_tensor(frozen, device=self.device)[:, None]
            self.logits = torch.where(rows, out.frozen_logits, self.logits)
            self._rewind(frozen, garbage)
        return dropped

    @torch.no_grad()
    def _step_host(self, dropped: List[Request]) -> List[Request]:
        """One host-synced step with host masks: constraint masks and control
        adjustments built on the host and added to the logits."""
        from videollamb_torch.serve.constrained import build_constraint_masks

        vocab = self.cfg.lm.vocab_size
        cmask = build_constraint_masks(self.slots, vocab)
        adj = build_control_adjustments(self.slots, vocab, self.eos)
        logits = self.logits
        for extra in (cmask, adj):
            if extra is not None:
                logits = logits + torch.from_numpy(extra).to(self.device)
        nxt = sample_rows(logits, self.generator, *slot_sampling_vectors(self.slots))
        # Logprobs of the RAW logits (the base distribution), before the step
        # overwrites them.
        lp = logprobs_of(self.logits, nxt) if self._wants_logprobs() else None
        with span("decode.enqueue"), adapter_rows(self.model.lm, self._live_adapter_idx()):
            self.logits = self._forward(nxt)
        self._advanced(1)
        with span("decode.sync"):
            lp_host = tuple(a.cpu().numpy()[:, None] for a in lp) if lp is not None else None
            toks_host = nxt.cpu().numpy()[:, None]
        with span("decode.commit"):
            self._commit_k_tokens(toks_host, lp_host, 1, dropped)
        return dropped

    def step(self, k: int = 1) -> List[Request]:
        """Admit pending requests, advance every active slot by up to ``k``
        tokens. Returns the requests finished (or dropped) in this step.
        Over an FSDP-sharded model the root unit (embeddings, head, bridge)
        is gathered once for the step."""
        with span("engine.step"), gathered(self.model):
            return self._step(k)

    def _step(self, k: int) -> List[Request]:
        with span("engine.admit"):
            self._admit()
        dropped = self._drain_dropped()
        if not any(self._active_mask()):
            return dropped
        all_greedy = all(r is None or r.temperature == 0.0 for r in self.slots)
        unconstrained = all(r is None or r._constraint is None for r in self.slots)
        no_controls = all(r is None or not r.has_sampling_controls for r in self.slots)
        if (self.speculative in ("lookup", "draft") and all_greedy and unconstrained
                and no_controls and not self._wants_logprobs()):
            with span("engine.decode"), adapter_rows(self.model.lm, self._live_adapter_idx()):
                return self._step_speculative(dropped)
        # Any other step rewrites the logits rows: the carried next-argmax is stale.
        self._spec_nxt0 = None
        with span("engine.pages"):
            self._prepare_decode(max(k, 1))
        with span("engine.decode"):
            if k > 1 and unconstrained:
                return self._step_device(k, dropped)
            if k > 1:
                # Constrained rows stay in the device loop while their tables are
                # on the device; otherwise, and at k = 1, host masks.
                grammar = self._grammar_device_setup()
                if grammar is not None:
                    return self._step_device(k, dropped, grammar)
            return self._step_host(dropped)

    def cancel(self, uid) -> bool:
        """Cancel a pending or running request by uid; it is dropped at
        admission or releases its slot at the next step boundary."""
        hit = False
        for r in list(self.pending.queue) + [r for r in self.slots if r is not None]:
            if r.uid == uid:
                r.cancelled = True
                hit = True
        return hit

    def run_until_drained(self, max_steps: int = 100000, k: int = 1) -> List[Request]:
        """Step until the queue and every slot are empty."""
        done: List[Request] = []
        for _ in range(max_steps):
            done += self.step(k)
            if not self.has_work():
                break
        return done
