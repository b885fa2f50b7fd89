"""The program's spans over one cell: what recording them costs, and
the per-layer numbers they give.

    python3 servebench/tools/spans.py --workload <cell> [--seed 1]
        [--seconds 51] [--pairs 2]

One set-up, then windows of the cell's mix at its rate, all on one
seed: ``--pairs`` pairs without spans and with them, in turns (off, on,
on, off, ...), untraced, each line with the engines' ``prefill_ms`` and
``decode_step_ms``; then one traced window with spans (the profiler
over its last fifth, as ``run.py --trace 1``), whose line holds the
span readers of ``servebench/spans.py`` beside the benchmark's own
per-layer metrics, the TTFT and TPOT decompositions, how far a mapped
engine span reaches outside its ``sb.step`` event, and the span
bookkeeping's own cost, timed by recording the window's spans again.
One JSON line a window; all of them also go to
``chiprun_out/spans_<cell>.json``.  On the card only.

Imported, it gives the decompositions the CPU tests hold the spans to.
``serve`` gives the engines span logs from outside ``harness.serve``;
it goes once ``harness.serve`` builds them itself for traced runs.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    # the checkout's root in place of this script's folder
    sys.path[0] = str(Path(__file__).resolve().parents[2])
    from servebench import env
    env.prepare()

from servebench import e2e, harness  # noqa: E402
from servebench import spans as SP  # noqa: E402
from servebench import trace as TRACE  # noqa: E402


def serve(st, rate: float, seconds: float, seed: int, tracer=None):
    """``harness.serve`` with spans on, the profile (if traced) reduced
    as ``run_cell`` reduces it."""
    from repro_torch.core.spans import SpanLog
    logs = [SpanLog() for _ in st.engines]
    for e, log in zip(st.engines, logs):
        e.spans = log
    try:
        rec = harness.serve(st, rate, seconds, seed, tracer)
    finally:
        for e in st.engines:
            e.spans = None
    if tracer is not None and tracer.window is not None:
        rec.trace = TRACE.reduce(tracer.prof, tracer.window, rec.steps)
    rec.spans = SP.collect(logs, rec.steps, tracer)
    return rec


def outside_us(pairs, offset_us: float) -> float:
    """How far the farthest engine span of ``SP.step_pairs``, mapped
    onto the profiler's clock, reaches outside its ``sb.step`` event,
    in µs (0 inside)."""
    return max((max(s - (1e6 * sp.start + offset_us),
                    1e6 * sp.end + offset_us - e, 0.0)
                for sp, s, e in pairs), default=0.0)


def ttft_parts(record) -> dict:
    """req_id -> (generator lag, queue wait, prefill span, TTFT from the
    due time) in seconds, for each served request: the first three make
    up the fourth."""
    waits = SP.queue_waits(record)
    pre = {p.attrs["req_id"]: p.end - p.start
           for p in SP.named(record, "prefill")}
    return {rid: (e2e.lag(r), waits[rid], pre[rid], e2e.ttft_from_due(r))
            for rid, r in record.served.items()}


def tpot_parts(record):
    """(decode span, wait) means over every decode token of the run, in
    ms: together the run's time per output token."""
    toks = [t for ts in SP.token_times(record).values() for t in ts]
    if not toks:
        return None
    return (1e3 * sum(end - start for _, start, end in toks) / len(toks),
            1e3 * sum(start - prev for prev, start, _ in toks) / len(toks))


def token_wait_split(record) -> dict:
    """The wait of ``tpot_parts`` taken apart: the mean over decode
    tokens of how much of the wait (from the previous token to the
    producing decode span's start) lies inside a ``prefill`` span of any
    replica, inside another replica's ``decode`` span, and in neither
    (the runtime loop and the engines' bookkeeping), in ms."""
    waits = [(prev, start) for toks in SP.token_times(record).values()
             for prev, start, _ in toks]
    if not waits:
        return None
    out = {}
    for part, name in (("prefill", "prefill"), ("decode_other", "decode")):
        spans = TRACE._union([(s.start, s.end)
                              for s in SP.named(record, name)])
        ends = [e for _, e in spans]
        inside = 0.0
        for a, b in waits:
            i = bisect.bisect_right(ends, a)
            while i < len(spans) and spans[i][0] < b:
                inside += min(b, spans[i][1]) - max(a, spans[i][0])
                i += 1
        out[part] = 1e3 * inside / len(waits)
    out["rest"] = (1e3 * sum(b - a for a, b in waits) / len(waits)
                   - out["prefill"] - out["decode_other"])
    return out


def _engines(rec) -> dict:
    eng = rec.engines
    n_p = sum(e["prefill_count"] for e in eng)
    n_d = sum(e["decode_steps"] for e in eng)
    return {"prefill_count": n_p, "decode_steps": n_d,
            "prefill_ms": 1e3 * sum(e["prefill_seconds"] for e in eng)
            / max(n_p, 1),
            "decode_step_ms": 1e3 * sum(e["decode_seconds"] for e in eng)
            / max(n_d, 1)}


def bookkeeping_us(rec) -> dict:
    """µs a prefill's and a decode step's spans cost the engine, timed
    alone: the window's spans recorded again into fresh logs, with the
    engine's extra clock read and its live-slot lists."""
    from repro_torch.core.spans import SpanLog
    out = {}
    for name in ("prefill", "decode"):
        n, t = 0, time.perf_counter()
        for spans in rec.spans["replicas"]:
            log = SpanLog()
            for s in spans:
                attrs = s.attrs
                if s.name == name:
                    n += 1
                    time.perf_counter()
                    if "live" in attrs:
                        attrs = dict(attrs, live=[(r, k) for r, k
                                                  in attrs["live"]])
                elif not s.name.startswith(name + "."):
                    continue
                log.add(s.name, s.start, s.end, s.parent, **attrs)
        out[name] = 1e6 * (time.perf_counter() - t) / max(n, 1)
    return out


def decompose(rec) -> dict:
    """The span readers, and TTFT and TPOT taken apart, of a window
    with spans on."""
    served = list(rec.served.values())
    parts = ttft_parts(rec).values()
    tpot = 1e3 * e2e.tpot(served)
    dspan, wait = tpot_parts(rec)

    def mean_ms(i):
        return 1e3 * sum(p[i] for p in parts) / len(parts)

    return {"spans_read": {n: f(rec) for n, f in SP.READERS.items()},
            "ttft": {"requests": len(parts),
                     "max_abs_gap_ms": 1e3 * max(
                         abs(lag + w + pre - ttft)
                         for lag, w, pre, ttft in parts),
                     "lag_mean_ms": mean_ms(0),
                     "queue_wait_mean_ms": mean_ms(1),
                     "prefill_span_mean_ms": mean_ms(2)},
            "tpot": {"decode_span_ms": dspan, "wait_ms": wait,
                     "rel_gap": (dspan + wait - tpot) / tpot,
                     "wait_split_ms": token_wait_split(rec)}}


def run(cell, seed: int, seconds: float, pairs: int, device: str) -> list:
    import torch

    from servebench import spec
    st = harness.setup(cell, seed, device)
    lines = []

    def emit(rec, on, **more):
        line = {"workload": cell.name, "seed": seed, "spans": on,
                **_engines(rec),
                **e2e.end_to_end(list(rec.served.values())),
                **(decompose(rec) if on else {}), **more}
        lines.append(line)
        print(json.dumps(line), flush=True)

    order = [False, True] * pairs
    for i in range(2, len(order), 4):          # off, on, on, off, ...
        order[i:i + 2] = order[i:i + 2][::-1]
    for on in order:
        emit((serve if on else harness.serve)(st, cell.rate, seconds, seed),
             on)
    tracer = harness.Tracer(harness.TRACE_FROM * seconds, device)
    tracer.warm()
    rec = serve(st, cell.rate, seconds, seed, tracer)
    steps = SP.step_pairs(rec.spans["replicas"], rec.steps,
                          TRACE._events(tracer.prof))
    emit(rec, True, traced=True,
         per_layer={m["name"]: spec.metric_reader(m["name"])(rec)
                    for m in cell.per_layer},
         mapping={"steps": len(steps), "offset_us": rec.spans["offset_us"],
                  "outside_us_max": outside_us(
                      steps, rec.spans["offset_us"]) if steps else None},
         bookkeeping_us=bookkeeping_us(rec),
         device=(torch.cuda.get_device_name(0) if device == "cuda"
                 else device))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    from servebench import spec
    cell = spec.load_cell(args.workload)
    import torch
    if torch.cuda.device_count() < cell.chips:
        sys.exit("servebench: the tools run on the card only")
    lines = run(cell, args.seed, args.seconds, args.pairs, "cuda")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"spans_{cell.name}.json").write_text(json.dumps(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
