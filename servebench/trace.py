"""Reduce the traced slice of a run, in memory, to what the per-layer
metrics read.

From ``torch.profiler``'s events: every device operation (kernels,
copies, sets) with its start and end; the benchmark's own host spans
``sb.step.<replica>.<index>`` around each replica step (``StepLog``),
whose index points into the run's step log (what the step did).  A step
ends with its tokens read back, so every kernel a step launched runs
inside its span.

* ``busy_s``: the union of the device operations' intervals;
  ``window_s``: the host seconds the profiler was open;
* ``kernel_s``: device seconds by operation name;
* ``steps``: the step-log entries whose spans the slice holds whole;
* ``idle_gaps``: each interval inside the slice with no device
  operation, named by the host span it falls in (a replica's prefill
  or decode step, or the runtime loop between steps).
"""
from __future__ import annotations


def _events(prof):
    """(name, is_device, start_us, end_us) of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), str(e.device_type()).endswith("CUDA"), start,
                    start + e.duration_ns() / 1e3))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof, window_s: float, steps: list) -> dict:
    events = _events(prof)
    # the device side of a host span (``gpu_user_annotation``) is no
    # device operation
    dev = [(n, s, e) for n, d, s, e in events
           if d and e > s and not n.startswith("sb.")]
    spans = sorted((s, e, n) for n, d, s, e in events
                   if not d and n.startswith("sb."))
    kernel_s: dict = {}
    for n, s, e in dev:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) / 1e6
    busy = _union([(s, e) for _, s, e in dev])
    out = {"window_s": window_s,
           "busy_s": sum(e - s for s, e in busy) / 1e6,
           "kernel_s": kernel_s,
           "steps": [steps[int(n.rsplit(".", 1)[1])] for _, _, n in spans],
           "idle_gaps": []}
    if not spans or not busy:
        return out
    lo, hi = spans[0][0], spans[-1][1]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        mid = (a + b) / 2
        name = "runtime loop, between steps"
        for s, e, n in spans:
            if s <= mid <= e:
                _, _, rep, i = n.split(".")
                name = f"replica {rep} {steps[int(i)][1]} step, host"
                break
        gaps.append((name, (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    out["idle_gaps"] = gaps
    return out


def breakdown(tr: dict, n: int = 10) -> dict:
    ops = sorted(tr["kernel_s"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k[:200], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in tr["idle_gaps"][:n]]}
