"""The program's own spans (``repro_torch.core.spans``) over a run, and
the per-layer numbers they give.

``collect`` turns each replica's ``SpanLog`` of a window, with the step
log and the window's ``harness.Tracer`` (if traced), into
``record.spans``:

* ``replicas``: each replica's spans (``Span`` tuples), in order;
* ``opened``: when the profiler opened, on the spans' clock;
* ``offset_us``: where a program time lands on the profiler's clock,
  ``1e6 * t + offset_us``: the median over the traced steps of the
  ``sb.step.<replica>.<index>`` event's start less the start of the
  engine step it encloses (each encloses exactly one);
* ``idle_us``: the device-idle intervals of the traced slice on the
  profiler's clock, over the interval ``trace.py`` takes its gaps from
  (the first ``sb.`` span's start to the last one's end).

The last three are None without a profile.  Each reader takes the
record and returns None where the run gave it nothing to read:

* ``queue_wait_p90_ms``: p90 over requests of ``prefill.start -
  submit``, the time a request waits in its engine's queue;
* ``prefill_pad_ratio``: sum of ``bucket`` over sum of ``L``;
* ``decode_live_share``: live slots over ``rows`` of the decode steps,
  in %;
* ``token_wait_ms``: mean over decode tokens of the gap since the
  request's previous token (its ``prefill`` end for the second) less
  the producing ``decode`` span, in ms;
* ``decode_enqueue_ms``: mean ``decode.enqueue``, in ms;
* ``idle_enqueue_share``: the share of the idle intervals that falls
  inside a ``prefill.enqueue`` or ``decode.enqueue`` span, in %.

The loop stalls for seconds while the profiler closes, with requests
still decoding, so in a traced run the two waits read only the spans
that end before the profiler opened: a request's wait where its
``prefill`` span does, a token's where its ``decode`` span does.
"""
from __future__ import annotations

import math
import statistics

from servebench import e2e
from servebench import trace as TRACE

STEPS = ("prefill", "decode")
ENQUEUE = ("prefill.enqueue", "decode.enqueue")


def step_pairs(replicas, steps, events):
    """``(engine span, start_us, end_us)`` of each ``sb.step`` event:
    the engine's ``prefill`` or ``decode`` span of the step it encloses
    (the replica's n-th step in the step log is its n-th step span)."""
    tops = [[s for s in spans if s.parent is None and s.name in STEPS]
            for spans in replicas]
    rank, seen = [], {}
    for sid, *_ in steps:
        rank.append(seen.get(sid, 0))
        seen[sid] = rank[-1] + 1
    out = []
    for name, dev, s, e in events:
        if dev or not name.startswith("sb.step."):
            continue
        _, _, rep, i = name.split(".")
        out.append((tops[int(rep)][rank[int(i)]], s, e))
    return out


def idle_intervals(events):
    """The intervals with no device operation, from the first ``sb.``
    span's start to the last one's end (as ``trace.reduce``'s gaps)."""
    dev = [(s, e) for n, d, s, e in events
           if d and e > s and not n.startswith("sb.")]
    sb = [(s, e) for n, d, s, e in events if not d and n.startswith("sb.")]
    if not dev or not sb:
        return None
    lo, hi = min(s for s, _ in sb), max(e for _, e in sb)
    busy = TRACE._union(dev)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    return [(max(a, lo), min(b, hi)) for a, b in zip(edges[0::2],
                                                      edges[1::2])
            if min(b, hi) > max(a, lo)]


def collect(logs, steps, tracer=None) -> dict:
    out = {"replicas": [list(log.spans) for log in logs],
           "opened": None, "offset_us": None, "idle_us": None}
    if tracer is None or tracer.prof is None:
        return out
    out["opened"] = tracer._t0          # perf_counter, as the spans
    events = TRACE._events(tracer.prof)
    pairs = step_pairs(out["replicas"], steps, events)
    if pairs:
        out["offset_us"] = statistics.median(s - 1e6 * sp.start
                                             for sp, s, _ in pairs)
        out["idle_us"] = idle_intervals(events)
    return out


def named(record, name=None):
    rs = getattr(record, "spans", None)
    if rs is None:
        return []
    return [s for spans in rs["replicas"] for s in spans
            if name is None or s.name == name]


def _opened(record) -> float:
    """When the profiler opened; no end where it never did."""
    rs = getattr(record, "spans", None)
    if rs is None or rs["opened"] is None:
        return math.inf
    return rs["opened"]


def queue_waits(record, before=math.inf) -> dict:
    """req_id -> seconds from its submit to its prefill's start, of the
    requests whose ``prefill`` span ends before ``before``."""
    sub = {s.attrs["req_id"]: s.start for s in named(record, "submit")}
    return {p.attrs["req_id"]: p.start - sub[p.attrs["req_id"]]
            for p in named(record, "prefill")
            if p.attrs["req_id"] in sub and p.end < before}


def token_times(record, before=math.inf) -> dict:
    """req_id -> [(its previous token's time, the producing decode
    span's start and end)] for each of its decode tokens whose span
    ends before ``before``, in order; a request's first token comes at
    its ``prefill`` end."""
    last = {p.attrs["req_id"]: p.end for p in named(record, "prefill")}
    out: dict = {}
    for d in sorted(named(record, "decode"), key=lambda s: s.end):
        for rid, _ in d.attrs["live"]:
            if d.end < before:
                out.setdefault(rid, []).append((last[rid], d.start, d.end))
            last[rid] = d.end
    return out


def queue_wait_p90_ms(record):
    w = list(queue_waits(record, _opened(record)).values())
    return 1e3 * e2e.percentile(w, 0.9) if w else None


def prefill_pad_ratio(record):
    ps = named(record, "prefill")
    n = sum(p.attrs["L"] for p in ps)
    return sum(p.attrs["bucket"] for p in ps) / n if n else None


def decode_live_share(record):
    ds = named(record, "decode")
    rows = sum(d.attrs["rows"] for d in ds)
    return (100.0 * sum(len(d.attrs["live"]) for d in ds) / rows
            if rows else None)


def token_wait_ms(record):
    times = token_times(record, _opened(record))
    g = [start - prev for toks in times.values() for prev, start, _ in toks]
    return 1e3 * sum(g) / len(g) if g else None


def decode_enqueue_ms(record):
    es = named(record, "decode.enqueue")
    return 1e3 * sum(s.end - s.start for s in es) / len(es) if es else None


def _overlap(xs, ys) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        (a, b), (c, d) = xs[i], ys[j]
        total += max(0.0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            j += 1
    return total


def idle_enqueue_share(record):
    rs = getattr(record, "spans", None)
    if rs is None or rs["idle_us"] is None or rs["offset_us"] is None:
        return None
    idle = sum(b - a for a, b in rs["idle_us"])
    if not idle:
        return None
    off = rs["offset_us"]
    enq = TRACE._union([(1e6 * s.start + off, 1e6 * s.end + off)
                        for s in named(record) if s.name in ENQUEUE])
    return 100.0 * _overlap(rs["idle_us"], enq) / idle


READERS = {"queue_wait_p90_ms": queue_wait_p90_ms,
           "prefill_pad_ratio": prefill_pad_ratio,
           "decode_live_share": decode_live_share,
           "token_wait_ms": token_wait_ms,
           "decode_enqueue_ms": decode_enqueue_ms,
           "idle_enqueue_share": idle_enqueue_share}
