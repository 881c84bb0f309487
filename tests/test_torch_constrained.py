"""Choice and grammar constraints in the port against the JAX package, on the CPU.

- The port's copies of the host grammar stack (``serve/{grammar,
  regex_grammar,schema,tools,constrained}.py``) behave as JAX's on the cases
  of ``tests/test_{grammar,regex_grammar,schema,tools,constrained}.py``:
  along a seeded token walk every mask, cost and end state is equal.
- ``serve/device_grammar.py``: DeviceTable rows, the sid map and the
  CombinedDeviceTable rebasing equal JAX's arrays.
- Greedy tokens under one shared choice set, mixed choice sets with
  ``json_object`` rows and free rows, with the dense engine and the paged
  engine (f32 and int8 pools), through the device loop (k = 4) and the
  host-mask path (k = 1): equal to JAX's. A cold grammar table freezes rows
  and rewinds their lengths, with JAX's tokens.

``ModelConfig.tiny`` in f32, text-only prompts, the piece vocabulary of
``tests/test_grammar.py``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from test_grammar import EOS, PIECES, VALID_OBJECTS, _decode, _token_strs  # noqa: E402
from test_regex_grammar import PATTERNS  # noqa: E402
from test_schema import FREE, NESTED, REFS, WEATHER  # noqa: E402
from test_tools import TOOLS  # noqa: E402
from test_torch_parity_utils import serve, text_requests, tiny_models  # noqa: E402


class _Tok:
    eos_token_id = EOS


def _char_strs(v=128):
    """Every printable ASCII character as a token, a few multi-char pieces."""
    strs = [None] * v
    for i, ch in enumerate(map(chr, range(32, 127))):
        strs[3 + i] = ch
    for i, p in enumerate(['{"', '": ', '", "', "true", "null", "abc", "12", "ye", "es"]):
        strs[3 + 95 + i] = p
    return strs


@pytest.fixture(autouse=True)
def _fresh_tables():
    """Both packages cache grammar tables by content: clear them, so each test
    builds (and the cold-table test freezes on) tables of its own."""
    from videollamb_torch.serve import grammar as port_grammar
    from videollamb_tpu.serve import grammar as jax_grammar

    for mod in (port_grammar, jax_grammar):
        mod._CONTENT_TABLE_CACHE.clear()
    yield
    for mod in (port_grammar, jax_grammar):
        mod._CONTENT_TABLE_CACHE.clear()


def _walk_equal(pc, jc, vocab, seed, steps=24):
    """Walk two cursors along the same seeded tokens: masks, costs and ends equal."""
    rng = np.random.default_rng(seed)
    for step in range(steps):
        budget = steps - step + 2
        for c in (pc, jc):
            if getattr(c, "budget_aware", False):
                c.set_remaining(budget)
        pm, jm = pc.mask(vocab), jc.mask(vocab)
        np.testing.assert_array_equal(pm, jm)
        assert pc.finished == jc.finished
        allowed = np.flatnonzero(pm)
        if pc.finished or allowed.size == 0:
            return
        tok = int(rng.choice(allowed))
        pc.advance(tok)
        jc.advance(tok)
        if hasattr(pc, "state"):
            assert pc.state == jc.state


def _cases():
    cases = [("json", mode, i) for mode in ("json_object", "json") for i in range(3)]
    cases += [("regex", p, 0) for p in PATTERNS]
    cases += [("schema", s, i) for s in ("WEATHER", "NESTED", "REFS", "FREE") for i in range(2)]
    cases += [("tools", None, i) for i in range(2)]
    return cases


@pytest.mark.parametrize("kind,arg,seed", _cases())
def test_grammar_copies_walk_like_jax(kind, arg, seed):
    from videollamb_torch.serve import grammar, regex_grammar, schema
    from videollamb_torch.serve import tools as ptools
    from videollamb_tpu.serve import grammar as jgrammar
    from videollamb_tpu.serve import regex_grammar as jregex
    from videollamb_tpu.serve import schema as jschema
    from videollamb_tpu.serve import tools as jtools

    strs = _char_strs()
    schemas = dict(WEATHER=WEATHER, NESTED=NESTED, REFS=REFS, FREE=FREE)
    if kind == "json":
        pc = grammar.json_constraint(_Tok(), mode=arg, token_strs=strs)
        jc = jgrammar.json_constraint(_Tok(), mode=arg, token_strs=strs)
    elif kind == "regex":
        pc = regex_grammar.regex_constraint(_Tok(), arg, token_strs=strs)
        jc = jregex.regex_constraint(_Tok(), arg, token_strs=strs)
    elif kind == "schema":
        pc = schema.schema_constraint(_Tok(), schemas[arg], token_strs=strs)
        jc = jschema.schema_constraint(_Tok(), schemas[arg], token_strs=strs)
    else:
        pc = schema.alternation_constraint(
            _Tok(), ptools.call_schemas(ptools.validate_tools(TOOLS)), token_strs=strs)
        jc = jschema.alternation_constraint(
            _Tok(), jtools.call_schemas(jtools.validate_tools(TOOLS)), token_strs=strs)
    assert pc.min_tokens == jc.min_tokens
    _walk_equal(pc, jc, len(strs), seed)


@pytest.mark.parametrize("obj", VALID_OBJECTS)
def test_json_machine_copy_accepts_like_jax(obj):
    from videollamb_torch.serve.grammar import JsonMachine
    from videollamb_tpu.serve.grammar import JsonMachine as JaxJsonMachine

    pm, jm = JsonMachine(), JaxJsonMachine()
    for text in (json.dumps(obj), json.dumps(obj, indent=2), '{"a":01}', '{"a":1,}'):
        ps, js = pm.start, jm.start
        for ch in text:
            ps, js = pm.step(ps, ch), jm.step(js, ch)
            assert ps == js
            if ps is None:
                break
        if ps is not None:
            assert pm.cost(ps) == jm.cost(js) and pm.closing_char(ps) == jm.closing_char(js)


def test_tools_copy_equals_jax():
    from videollamb_torch.serve import tools as pt
    from videollamb_tpu.serve import tools as jt

    specs = pt.validate_tools(TOOLS)
    assert specs == jt.validate_tools(TOOLS)
    assert pt.render_tools_system(specs) == jt.render_tools_system(specs)
    assert pt.call_schemas(specs) == jt.call_schemas(specs)
    assert pt.call_schemas(specs, "add") == jt.call_schemas(specs, "add")
    for text in ('{"name": "add", "arguments": {"a": 1, "b": 2}}', "let me think",
                 '{"name": "nope", "arguments": {}}', '{"name": "add", "arguments": 3}'):
        assert pt.parse_tool_call(text, ["get_weather", "add"]) == jt.parse_tool_call(
            text, ["get_weather", "add"])
    msg = {"role": "assistant", "tool_calls": [{"id": "c", "type": "function", "function": {
        "name": "add", "arguments": '{"a": 1}'}}]}
    assert pt.render_assistant_tool_calls(msg) == jt.render_assistant_tool_calls(msg)
    assert pt.tool_calls_payload("add", "{}", "c") == jt.tool_calls_payload("add", "{}", "c")
    with pytest.raises(ValueError, match="duplicate"):
        pt.validate_tools([TOOLS[0], TOOLS[0]])


@pytest.mark.parametrize("choices", [[[7, 8, 9], [11], [13, 14]], [[5], [5, 6], [5, 6, 7]],
                                     [[3, 4], [3, 5], [6]]])
def test_choice_copies_equal_jax(choices):
    from videollamb_torch.serve import constrained as pc
    from videollamb_tpu.serve import constrained as jc

    pt, jt = pc.TokenTrie(choices), jc.TokenTrie(choices)
    assert (pt.children, pt.is_leaf, pt.max_len) == (jt.children, jt.is_leaf, jt.max_len)
    ptab, jtab = pc.ChoiceTable(pt, EOS), jc.ChoiceTable(jt, EOS)
    assert ptab._cost == jtab._cost and ptab.prewarm_sids == jtab.prewarm_sids
    for sid in ptab.prewarm_sids:
        for a, b in zip(ptab.expand(sid), jtab.expand(sid)):
            np.testing.assert_array_equal(a, b)
    for path in choices:
        p, j = pc.ChoiceConstraint(pt, EOS), jc.ChoiceConstraint(jt, EOS)
        for tok in path + [EOS]:
            np.testing.assert_array_equal(p.mask(16), j.mask(16))
            assert p.finished == j.finished
            if p.finished:
                break
            p.advance(tok)
            j.advance(tok)

    class Row:
        pass

    rows = [Row(), Row(), None]
    rows[0]._constraint, rows[1]._constraint = pc.ChoiceConstraint(pt, EOS), None
    jrows = [Row(), Row(), None]
    jrows[0]._constraint, jrows[1]._constraint = jc.ChoiceConstraint(jt, EOS), None
    np.testing.assert_array_equal(pc.build_constraint_masks(rows, 16),
                                  jc.build_constraint_masks(jrows, 16))


def test_device_tables_equal_jax():
    from videollamb_torch.serve import device_grammar as pd
    from videollamb_torch.serve.constrained import ChoiceTable, TokenTrie
    from videollamb_torch.serve.grammar import json_constraint
    from videollamb_tpu.serve import device_grammar as jd
    from videollamb_tpu.serve.constrained import ChoiceTable as JChoiceTable
    from videollamb_tpu.serve.constrained import TokenTrie as JTokenTrie
    from videollamb_tpu.serve.grammar import json_constraint as jjson

    strs = _token_strs(64)
    pgram, jgram = json_constraint(_Tok(), token_strs=strs), jjson(_Tok(), token_strs=strs)
    pdt, jdt = pd.DeviceTable(pgram.table, 64, cap=16), jd.DeviceTable(jgram.table, 64, cap=16)
    for tok in (34, 32, 7, 8, 12):  # '{"', 'abc', '"', ':', '1'
        assert pdt.slot(pgram.node) == jdt.slot(jgram.node)
        pgram.advance(tok)
        jgram.advance(tok)
    choices = [[7, 8], [11], [13, 14]]
    pct = pd.device_table_for(ChoiceTable(TokenTrie(choices), EOS), 64)
    jct = jd.device_table_for(JChoiceTable(JTokenTrie(choices), EOS), 64)
    for p, j in ((pdt, jdt), (pct, jct)):
        for name in ("costs", "next_sid", "sid2slot"):
            np.testing.assert_array_equal(getattr(p, name).numpy(), np.asarray(getattr(j, name)))
    pcomb, jcomb = pd.combined_table_for([pdt, pct]), jd.combined_table_for([jdt, jct])
    assert pd.combined_table_for([pdt, pct]) is pcomb
    for name in ("costs", "next_sid", "sid2slot"):
        np.testing.assert_array_equal(getattr(pcomb, name).numpy(),
                                      np.asarray(getattr(jcomb, name)))
    assert list(pcomb.slot_base) == list(jcomb.slot_base)


# ----------------------------------------------------------------------
# Engines


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _engines(models, kind):
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import ServingEngine
    from videollamb_tpu.serve.paged import PagedServingEngine as JaxPaged
    from videollamb_tpu.serve.server import ServingEngine as JaxDense

    jcfg, params, model, cfg = models
    if kind == "dense":
        return (JaxDense(params, jcfg, num_slots=4, eos_token_id=EOS),
                ServingEngine(model, cfg, num_slots=4, eos_token_id=EOS))
    kw = dict(num_slots=4, page_size=16, eos_token_id=EOS, quantize_kv=kind == "paged_int8")
    return JaxPaged(params, jcfg, **kw), PagedServingEngine(model, cfg, **kw)


def _mixed_requests(vocab, mix):
    """(JAX, port) requests: 'shared' = three rows of one choice set; 'mixed' =
    two choice sets, two json_object rows and a free row."""
    from videollamb_torch.serve.grammar import json_constraint
    from videollamb_tpu.serve.grammar import json_constraint as jjson

    strs = _token_strs(vocab)
    json_row = {"grammar": lambda side: (jjson if side == "jax" else json_constraint)(
        _Tok(), token_strs=strs)}
    if mix == "shared":
        specs = [dict(choices=[[7, 8, 9], [11], [13, 14]])] * 3
    else:
        specs = [dict(choices=[[7, 8, 9], [11]]), dict(choices=[[20], [21, 22]]), json_row,
                 json_row, {}]
    jreqs, preqs = [], []
    for i, spec in enumerate(specs):
        j, p = text_requests(vocab, [40 + i], 12, **spec)
        j[0].uid = p[0].uid = i
        jreqs += j
        preqs += p
    return jreqs, preqs


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", ["dense", "paged_f32", "paged_int8"])
@pytest.mark.parametrize("mix", ["shared", "mixed"])
def test_constrained_greedy_tokens_equal_jax(models, mix, kind, k):
    vocab = models[0].lm.vocab_size
    jax_engine, engine = _engines(models, kind)
    jreqs, preqs = _mixed_requests(vocab, mix)
    assert serve(engine, preqs, k) == serve(jax_engine, jreqs, k)
    for r in preqs:
        if r.choices:
            assert r.tokens in r.choices or r.tokens[:-1] in r.choices
        elif r.grammar is not None:
            assert isinstance(json.loads(_decode(r.tokens)), dict)


@pytest.mark.parametrize("kind", ["dense", "paged_int8"])
def test_cold_table_freezes_and_rewinds(models, kind):
    """A fresh JSON table: first visits freeze rows at k = 4; the engine keeps
    the valid prefixes and rewinds the lengths over the garbage steps; the
    tokens are JAX's and the host path's."""
    from videollamb_torch.serve.grammar import json_constraint
    from videollamb_tpu.serve.grammar import json_constraint as jjson

    vocab = models[0].lm.vocab_size
    strs = _token_strs(vocab)
    got = {}
    for k in (4, 1):
        for mod in ("videollamb_torch", "videollamb_tpu"):
            __import__(f"{mod}.serve.grammar", fromlist=["x"])._CONTENT_TABLE_CACHE.clear()
        jax_engine, engine = _engines(models, kind)
        rewinds = []
        rewind = engine._rewind
        engine._rewind = lambda frozen, garbage: (rewinds.append(garbage.copy()),
                                                  rewind(frozen, garbage))
        jreqs, preqs = text_requests(vocab, [0, 1, 2], 12, grammar=lambda side: (
            jjson if side == "jax" else json_constraint)(_Tok(), token_strs=strs))
        for i, (j, p) in enumerate(zip(jreqs, preqs)):
            j.uid = p.uid = i
        got[k] = serve(engine, preqs, k)
        assert got[k] == serve(jax_engine, jreqs, k)
        if k == 4:
            assert rewinds and any(g.any() for g in rewinds)
        for toks in got[k]:
            assert isinstance(json.loads(_decode(toks)), dict)
    assert got[4] == got[1]
    assert set(PIECES) >= {t for toks in got[4] for t in toks if t != EOS}
