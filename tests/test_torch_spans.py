"""The serving engine's spans (``repro_torch.core.spans``) on the CPU at
phi3's smoke size: off, they change nothing and record nothing; on,
each step's span holds its children, its shapes are the engine's own,
and the spans sum to the engine's step counters."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import spans as S
from repro_torch.models import registry as R
from repro_torch.serving.engine import InferenceEngine, _bucket

ARCH = "phi3-mini-3.8b-smoke"
PROMPTS = (24, 9, 37, 50)
NEW = (5, 3, 6, 4)
CHILDREN = {"prefill": ("prefill.enqueue",), "decode": ("decode.enqueue",)}


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH)
    return cfg, R.init_params(cfg, torch.Generator().manual_seed(0))


def _serve(cfg, params, log=None):
    """Four ragged prompts on three slots (the fourth waits and takes a
    reused slot), stepped one by one: the completions, the engine, and
    the live slots' positions before each decode step."""
    eng = InferenceEngine(cfg, params, max_batch=3, max_len=96)
    eng.spans = log
    rng = np.random.default_rng(5)
    for i, (n, new) in enumerate(zip(PROMPTS, NEW)):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n), new, 10 + i)
    done, before = [], []
    while not eng.idle():
        if not (eng.queue and None in eng.active):
            before.append([(r.req_id, int(eng.positions[s]))
                           for s, r in enumerate(eng.active)
                           if r is not None])
        done.extend(eng.step())
    return {c.req_id: c.tokens for c in done}, eng, before


def _tops(log, name):
    return [s for s in log.spans if s.parent is None and s.name == name]


def test_spans_off_change_nothing_and_record_nothing(model):
    cfg, params = model
    plain_tokens, plain, _ = _serve(cfg, params)
    assert plain.spans is None
    log = S.SpanLog()
    tokens, traced, _ = _serve(cfg, params, log)
    assert log.spans
    assert tokens == plain_tokens
    for k in ("prefill_count", "decode_steps", "tokens_done"):
        assert getattr(traced, k) == getattr(plain, k), k
    assert torch.equal(traced.positions, plain.positions)
    assert torch.equal(traced.tokens, plain.tokens)


def test_every_step_span_holds_its_children(model):
    cfg, params = model
    log = S.SpanLog()
    _, eng, _ = _serve(cfg, params, log)
    assert [s.id for s in log.spans] == list(range(len(log.spans)))
    for name, kids in CHILDREN.items():
        tops = _tops(log, name)
        assert tops
        for top in tops:
            got = [s for s in log.spans if s.parent == top.id]
            assert tuple(s.name for s in got) == kids
            # the enqueue opens with its step and ends inside it
            assert got[0].start == top.start
            assert top.start <= got[0].end <= top.end
    assert len(_tops(log, "prefill")) == eng.prefill_count == len(PROMPTS)
    assert len(_tops(log, "decode")) == eng.decode_steps
    submits = _tops(log, "submit")
    assert [s.attrs for s in submits] == [{"req_id": 10 + i}
                                          for i in range(len(PROMPTS))]
    assert all(s.start == s.end for s in submits)
    names = {s.name for s in log.spans}
    assert names == {"submit", *CHILDREN, *CHILDREN["prefill"],
                     *CHILDREN["decode"]}


def test_span_shapes_are_the_engines_own(model):
    cfg, params = model
    log = S.SpanLog()
    _, eng, before = _serve(cfg, params, log)
    prefills = _tops(log, "prefill")
    assert [p.attrs["req_id"] for p in prefills] == [10, 11, 12, 13]
    for p, n in zip(prefills, PROMPTS):
        assert p.attrs["L"] == n
        assert p.attrs["bucket"] == min(_bucket(n), eng.max_len)
    decodes = _tops(log, "decode")
    assert len(decodes) == len(before)
    for d, live in zip(decodes, before):
        assert d.attrs["rows"] == eng.max_batch
        # keys attended: the position before the step plus the new token
        assert d.attrs["live"] == [(rid, pos + 1) for rid, pos in live]


def test_span_sums_are_the_step_counters(model):
    cfg, params = model
    log = S.SpanLog()
    _, eng, _ = _serve(cfg, params, log)
    for name, counter in (("prefill", "prefill_seconds"),
                          ("decode", "decode_seconds")):
        total = 0.0
        for s in _tops(log, name):
            total += s.end - s.start
        assert total == getattr(eng, counter), name


def test_no_profiler_event_carries_a_span_name(model):
    cfg, params = model
    log = S.SpanLog()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(cfg, params, log)
    events = {e.name for e in prof.events()}
    assert events and log.spans
    assert not events & {s.name for s in log.spans}
