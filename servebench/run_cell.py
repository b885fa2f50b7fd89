"""The body of one run (``run.py`` checks the card first): set-up, the
window, the traced slice's reduction, the check, the result line."""
from __future__ import annotations

import gc
import json
import sys
import time

import torch

from servebench import check as C
from servebench import e2e, harness, spec
from servebench import trace as TRACE
from servebench.guard import fail, forbidden_modules


def metrics_of(cell, record, trace_on: bool, setup_s: float) -> dict:
    out = {}
    if not trace_on:
        values = e2e.end_to_end(list(record.served.values()))
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"])(record)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


#: iterations of the host probe, a fixed piece of plain Python
PROBE_N = 2_000_000


class HostWatch:
    """What the host did over the window and drain, beside the engines'
    own step times, for the causes a run's host-paced numbers follow: the
    process's CPU time, the garbage collector's pauses, and after the
    window a fixed piece of plain Python timed (how fast this host runs
    the kind of work the runtime loop and the model's launches are)."""

    def __enter__(self):
        self.gc_s, self.gc_n = 0.0, 0
        gc.callbacks.append(self._gc)
        self.cpu, self.wall = time.process_time(), time.perf_counter()
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_n += 1

    def __exit__(self, *exc):
        self.wall = time.perf_counter() - self.wall
        self.cpu = time.process_time() - self.cpu
        gc.callbacks.remove(self._gc)

    def line(self, record) -> str:
        t = time.perf_counter()
        sum(i * i for i in range(PROBE_N))
        probe = time.perf_counter() - t
        eng = record.engines
        n_p = sum(e["prefill_count"] for e in eng)
        n_d = sum(e["decode_steps"] for e in eng)
        p_s = sum(e["prefill_seconds"] for e in eng)
        d_s = sum(e["decode_seconds"] for e in eng)
        return (f"servebench host: wall {self.wall:.3f} s, process CPU "
                f"{self.cpu:.3f} s, {self.gc_n} collections "
                f"{1e3 * self.gc_s:.3f} ms, probe {1e3 * probe:.3f} ms; "
                f"{n_p} prefills {1e3 * p_s / max(n_p, 1):.3f} ms, {n_d} "
                f"decode steps {1e3 * d_s / max(n_d, 1):.3f} ms, "
                f"{len(record.lost)} requests lost by an engine "
                f"{record.lost[:20]}")


def run(cell, args, t_start: float, device: str = "cuda") -> int:
    st = harness.setup(cell, args.seed, device)
    tracer = (harness.Tracer(harness.TRACE_FROM * args.seconds, device)
              if args.trace else None)
    if tracer is not None:
        tracer.warm()
    setup_s = time.perf_counter() - t_start
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    with HostWatch() as watch:
        record = harness.serve(st, cell.rate, args.seconds, args.seed,
                               tracer)
    t_served = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        return fail(f"modules loaded that the run must not hold: {bad}", 3)
    if tracer is not None and tracer.window is not None:
        record.trace = TRACE.reduce(tracer.prof, tracer.window,
                                    record.steps)
    tracer = None                 # the profile's events go before the check
    harness.free(st)
    t_check = time.perf_counter()
    correct, numbers = C.verdict(cell, st.weights.tree(), record,
                                 args.seed, device)
    print(f"servebench: set-up {setup_s:.3f} s, window and drain "
          f"{t_served - t_window:.3f} s, trace reduction "
          f"{t_check - t_served:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr,
          flush=True)
    print(watch.line(record), file=sys.stderr, flush=True)
    result = {
        "correct": bool(correct),
        "attempted": len(record.arrivals),
        "failed": len(record.arrivals) - len(record.served),
        "metrics": metrics_of(cell, record, bool(args.trace), setup_s),
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if record.trace is not None:
        result["device"]["busy_s"] = record.trace["busy_s"]
        result["device"]["window_s"] = record.trace["window_s"]
        result["breakdown"] = TRACE.breakdown(record.trace)
    result["check"] = numbers
    for name, n in numbers.items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
