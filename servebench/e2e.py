"""End-to-end arithmetic over the requests of one run.

Each served request is a ``Served`` record: when it was due, when the
runtime saw it complete (``done``, seconds from the window's start, so
``done - due`` is the runtime recorder's latency), and the engine's own
``ttft`` and ``latency``, which run from the engine's submit.

* time to first token, from when the request was due:
  ``ttft + (done - due - latency)``: the engine's TTFT plus how late
  the request reached the engine;
* latency: ``done - due``, TailBench++'s own measure;
* time per output token: the whole window's decode time over all its
  decode tokens, ``sum(latency - ttft) / sum(tokens - 1)`` over the
  requests with at least two tokens (not a mean of per-request means);
* a percentile is the linear interpolation between order statistics
  (numpy's default), written out here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Served:
    rid: int
    due: float
    done: float
    ttft: float           # engine: submit -> first token
    latency: float        # engine: submit -> last token
    tokens: int


def percentile(xs, q: float) -> float:
    v = sorted(xs)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def lag(r: Served) -> float:
    """How much later than its due time the request's engine saw it,
    plus any wait for the runtime to collect it."""
    return (r.done - r.due) - r.latency


def ttft_from_due(r: Served) -> float:
    return r.ttft + lag(r)


def latency(r: Served) -> float:
    return r.done - r.due


def tpot(served) -> float:
    num = den = 0.0
    for r in served:
        if r.tokens >= 2:
            num += r.latency - r.ttft
            den += r.tokens - 1
    return num / den if den else math.nan


def end_to_end(served) -> dict:
    """The end-to-end metrics in ms."""
    return {"ttft_p90_ms": 1e3 * percentile(
                [ttft_from_due(r) for r in served], 0.9),
            "latency_p90_ms": 1e3 * percentile(
                [latency(r) for r in served], 0.9),
            "tpot_ms": 1e3 * tpot(served)}
