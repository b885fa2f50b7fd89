"""The program's spans read by the benchmark (``servebench/spans.py``)
at the smoke cell on the CPU: their shapes are the step log's, they
decompose TTFT and TPOT, they map onto the profiler's clock, each
reader gives a number where the run recorded spans and None where it
did not, and the waits read in a traced run stop where the profiler
opens."""
import types

import pytest

import smoke
from servebench import e2e, harness
from servebench import spans as SP
from servebench import trace as TRACE
from servebench.tools import spans as TS


@pytest.fixture(scope="module")
def traced():
    """One traced smoke window with spans on: the record and the
    profiler's events."""
    cell = smoke.cell()
    st = harness.setup(cell, 8, "cpu")
    tracer = harness.Tracer(0.5, "cpu")
    tracer.warm()
    rec = TS.serve(st, cell.rate, 2.0, 8, tracer)
    return rec, TRACE._events(tracer.prof)


def test_program_span_shapes_are_the_step_logs(traced):
    rec, _ = traced
    reps = rec.spans["replicas"]
    assert len(reps) == smoke.cell().traffic["replicas"]
    for rep, spans in enumerate(reps):
        tops = [s for s in spans if s.parent is None and s.name in SP.STEPS]
        logged = [(kind, info) for sid, kind, _, _, info in rec.steps
                  if sid == rep]
        assert len(tops) == len(logged) > 0
        for span, (kind, info) in zip(tops, logged):
            assert span.name == kind
            if kind == "prefill":
                assert (span.attrs["L"],) == info
            else:
                assert tuple(k for _, k in span.attrs["live"]) == info


def test_lag_queue_wait_and_prefill_make_up_ttft(traced):
    rec, _ = traced
    parts = TS.ttft_parts(rec)
    assert len(parts) == len(rec.served) > 10
    for lag, wait, pre, ttft in parts.values():
        assert wait >= 0 and pre > 0
        assert abs(lag + wait + pre - ttft) < 1e-3


def test_decode_span_and_token_wait_make_up_tpot(traced):
    rec, _ = traced
    tpot = 1e3 * e2e.tpot(list(rec.served.values()))
    dspan, wait = TS.tpot_parts(rec)
    assert abs(dspan + wait - tpot) <= 0.01 * tpot
    # the reader takes the same wait over the whole run where no
    # profiler opened in it
    whole = types.SimpleNamespace(spans=dict(rec.spans, opened=None))
    assert SP.token_wait_ms(whole) == pytest.approx(wait, rel=1e-12)
    # the wait lies in prefills, the other replica's decode steps and the
    # loop: on one host thread no two steps overlap
    split = TS.token_wait_split(rec)
    assert sum(split.values()) == pytest.approx(wait, rel=1e-9)
    assert min(split.values()) >= 0.0
    assert split["prefill"] > 0 and split["decode_other"] > 0


def test_mapped_engine_spans_lie_inside_their_step_events(traced):
    rec, events = traced
    pairs = SP.step_pairs(rec.spans["replicas"], rec.steps, events)
    assert len(pairs) > 3
    assert rec.spans["offset_us"] is not None
    assert TS.outside_us(pairs, rec.spans["offset_us"]) <= 100.0
    # each pair holds the step its event names
    for span, s, e in pairs:
        assert span.name in SP.STEPS and e > s


def test_readers_give_numbers_where_spans_were_recorded(traced):
    rec, _ = traced
    got = {n: f(rec) for n, f in SP.READERS.items()}
    # the CPU profile has no device operation, so no idle time to split
    assert got.pop("idle_enqueue_share") is None
    assert rec.spans["idle_us"] is None
    assert rec.spans["opened"] is not None
    assert all(isinstance(v, float) for v in got.values()), got
    assert got["prefill_pad_ratio"] >= 1.0
    assert 0.0 < got["decode_live_share"] <= 100.0
    assert got["queue_wait_p90_ms"] >= 0.0
    assert 0.0 < got["decode_enqueue_ms"]


def test_readers_give_none_without_spans():
    cell = smoke.cell()
    st = harness.setup(cell, 9, "cpu")
    rec = harness.serve(st, cell.rate, 0.5, 9)
    assert not hasattr(rec, "spans")
    assert {n: f(rec) for n, f in SP.READERS.items()} == dict.fromkeys(
        SP.READERS)
    empty = types.SimpleNamespace(spans={"replicas": [[], []],
                                         "opened": None, "offset_us": None,
                                         "idle_us": None}, served={})
    assert {n: f(empty) for n, f in SP.READERS.items()} == dict.fromkeys(
        SP.READERS)


class _Event:
    def __init__(self, name, cuda, start_us, end_us):
        self._n, self._c = name, cuda
        self._s, self._d = int(start_us * 1e3), int((end_us - start_us)
                                                    * 1e3)

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_idle_time_is_trace_reduces_and_split_by_enqueue_spans():
    from repro_torch.core.spans import SpanLog
    # two steps of replica 0 on the profiler's clock (µs), a program
    # clock 1000 s behind it; kernels leave idle 100-110, 130-150 and
    # 170-200 inside the steps' span 100-200
    evs = [_Event("sb.step.0.0", False, 100, 150),
           _Event("sb.step.0.1", False, 150, 200),
           _Event("k", True, 90, 100), _Event("k", True, 110, 130),
           _Event("k", True, 150, 170), _Event("sb.step.0.0", True, 0, 1)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    log = SpanLog()
    t = -1000.0 + 1e-6 * 100     # the first step's start, program clock
    d = log.add("decode", t, t + 50e-6, live=[(1, 5)], rows=2)
    log.add("decode.enqueue", t, t + 20e-6, d)       # 100-120
    d = log.add("decode", t + 50e-6, t + 100e-6, live=[(1, 6)], rows=2)
    log.add("decode.enqueue", t + 50e-6, t + 80e-6, d)    # 150-180
    steps = [(0, "decode", 0, 0, (5,)), (0, "decode", 0, 0, (6,))]
    rs = SP.collect([log], steps, types.SimpleNamespace(prof=prof, _t0=t))
    assert rs["offset_us"] == pytest.approx(1e9, abs=1e-3)
    assert rs["idle_us"] == [(100, 110), (130, 150), (170, 200)]
    reduced = TRACE.reduce(prof, 1.0, steps)
    assert sum(g for _, g in reduced["idle_gaps"]) == pytest.approx(
        1e-6 * sum(b - a for a, b in rs["idle_us"]))
    rec = types.SimpleNamespace(spans=rs)
    # idle 60 µs, of it 100-110 and 170-180 inside an enqueue span
    assert SP.idle_enqueue_share(rec) == pytest.approx(100 * 20 / 60,
                                                       rel=1e-6)
    assert SP.decode_live_share(rec) == 50.0


def test_waits_stop_where_the_profiler_opens():
    """A stall after the profiler opened (as its close makes one, with
    requests still decoding) moves neither wait read in a traced run."""
    from repro_torch.core.spans import SpanLog

    def log(stall: bool):
        g = SpanLog()
        g.add("submit", 0.0, 0.0, req_id=1)
        g.add("submit", 0.5, 0.5, req_id=2)
        p = g.add("prefill", 0.1, 0.2, req_id=1, L=5, bucket=8)
        g.add("prefill.enqueue", 0.1, 0.15, p)
        for t in (0.3, 0.4):
            g.add("decode", t, t + 0.05, rows=2, live=[(1, 6)])
        p = g.add("prefill", 0.6, 0.7, req_id=2, L=6, bucket=8)
        g.add("prefill.enqueue", 0.6, 0.65, p)
        g.add("decode", 0.8, 0.85, rows=2, live=[(1, 8), (2, 7)])
        if stall:     # the profiler opened at 1 s; the loop stalls 3 s
            g.add("submit", 0.9, 0.9, req_id=3)
            p = g.add("prefill", 4.0, 4.1, req_id=3, L=4, bucket=4)
            g.add("prefill.enqueue", 4.0, 4.05, p)
            g.add("decode", 4.2, 4.25, rows=2, live=[(1, 9), (2, 8)])
        return g

    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: [])))
    tracer = types.SimpleNamespace(prof=prof, _t0=1.0)
    waits = (SP.queue_wait_p90_ms, SP.token_wait_ms)

    def read(stall, tr):
        rec = types.SimpleNamespace(spans=SP.collect([log(stall)], [], tr))
        return [f(rec) for f in waits]

    calm = read(False, tracer)
    assert read(True, tracer) == calm
    # both requests waited 100 ms; tokens at 0.3, 0.4 and 0.8 (twice)
    # waited 100, 50, 350 and 100 ms
    assert calm == pytest.approx([100.0, 150.0])
    # untraced, the same stall is read: the cut is what holds them
    stalled = read(True, None)
    assert stalled[0] > 2000.0 and stalled[1] > 1000.0
