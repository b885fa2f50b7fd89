"""ResultFrame: the sweep artifact — typed rows, round-trip, compare.

Copy of ``repro.sweep.results``.

One ``SweepRow`` per (point, repetition): the point's parameters, the
derived seed/stream, the extracted metrics, and (optionally) per-client
summaries and per-interval telemetry series.  ``ResultFrame`` holds the
rows plus the sweep's spec metadata and provides:

* ``aggregate(metric)`` — per-point mean and 95% CI across repetitions
  (the paper's error bars, via ``confidence95``);
* ``compare(other, metric)`` — Welch's t-test between two frames over
  the filter-matching rows (the paper's Table-4 equivalence
  methodology, reusable for any A/B sweep);
* ``to_json``/``from_json`` — exact round-trip (floats survive
  bit-for-bit through ``repr``-based JSON encoding, NaN included);
* ``to_csv`` — flat per-row or aggregated CSV, the benchmark artifact
  format the figure scripts and CI emit.
"""
from __future__ import annotations

import csv
import json
import math
import os
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.stats import confidence95, welch_ttest


@dataclass
class SweepRow:
    """One (point, repetition) outcome."""
    index: int                          # point index in declaration order
    params: dict
    rep: int
    seed: int                           # experiment seed actually used
    stream: int                         # repetition RNG stream
    metrics: dict = field(default_factory=dict)
    clients: Optional[dict] = None      # cid(str) -> summary dict
    series: Optional[list] = None       # per-interval rows (cid -1 = overall)
    error: Optional[str] = None         # failure capture: row kept, run lost

    @property
    def ok(self) -> bool:
        return self.error is None

    def to_dict(self) -> dict:
        d = {"index": self.index, "params": self.params, "rep": self.rep,
             "seed": self.seed, "stream": self.stream,
             "metrics": self.metrics}
        if self.clients is not None:
            d["clients"] = self.clients
        if self.series is not None:
            d["series"] = self.series
        if self.error is not None:
            d["error"] = self.error
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SweepRow":
        return cls(index=d["index"], params=d["params"], rep=d["rep"],
                   seed=d["seed"], stream=d["stream"],
                   metrics=d.get("metrics", {}),
                   clients=d.get("clients"), series=d.get("series"),
                   error=d.get("error"))


def series_window(series: list, metric: str, lo: int = 0,
                  hi: Optional[int] = None, cid: int = -1) -> list:
    """Per-interval ``metric`` values over ``[lo, hi)`` for one client
    (``-1`` = overall) from a row's captured telemetry series — the same
    windowing ``MetricsPipeline.window`` provides on a live run."""
    return [r[metric] for r in (series or ())
            if r["cid"] == cid and r["t"] >= lo
            and (hi is None or r["t"] < hi)]


@dataclass
class ResultFrame:
    """The result store for one executed sweep."""
    name: str
    spec: dict = field(default_factory=dict)   # Sweep.describe() metadata
    rows: list = field(default_factory=list)   # SweepRow, (index, rep) order

    # ---------------------------------------------------------- selection
    @property
    def ok_rows(self) -> list:
        return [r for r in self.rows if r.ok]

    @property
    def errors(self) -> list:
        return [r for r in self.rows if not r.ok]

    def raise_errors(self) -> "ResultFrame":
        """Raise if any row failed, carrying the captured error text —
        for consumers (the figure scripts) that need every point and
        would otherwise crash on an empty ``metrics`` dict with the real
        failure message sitting unread in ``row.error``."""
        if self.errors:
            detail = "; ".join(f"point={r.params} rep={r.rep}: {r.error}"
                               for r in self.errors[:5])
            more = len(self.errors) - 5
            if more > 0:
                detail += f" (+{more} more)"
            raise RuntimeError(f"sweep {self.name!r}: "
                               f"{len(self.errors)} failed rows — {detail}")
        return self

    def point_rows(self, index: int) -> list:
        return [r for r in self.rows if r.index == index]

    def values(self, metric: str, **filters) -> list:
        """Metric values (row order) over rows matching all ``filters``
        (matched against point params)."""
        return [r.metrics[metric] for r in self.ok_rows
                if all(r.params.get(k) == v for k, v in filters.items())]

    # --------------------------------------------------------- aggregation
    def points(self) -> list[tuple]:
        """Distinct (index, params) in declaration order."""
        seen: dict[int, dict] = {}
        for r in self.rows:
            seen.setdefault(r.index, r.params)
        return sorted(seen.items())

    def aggregate(self, metric: str) -> list[dict]:
        """Per-point mean + 95% CI half-width across repetitions.

        Failed repetitions are excluded from the aggregate (their count
        shows up as ``n_failed``); a fully-failed point aggregates to
        NaN rather than vanishing."""
        by_index: dict[int, list] = {}          # one pass, not O(points x rows)
        for r in self.rows:
            by_index.setdefault(r.index, []).append(r)
        out = []
        for index, params in self.points():
            rows = by_index.get(index, [])
            vals = [r.metrics[metric] for r in rows if r.ok]
            mean, ci = confidence95(vals)
            out.append({"index": index, "params": params, "metric": metric,
                        "mean": mean, "ci95": ci, "n_reps": len(vals),
                        "n_failed": sum(1 for r in rows if not r.ok),
                        "vals": vals})
        return out

    def compare(self, other: "ResultFrame", metric: str,
                **filters) -> "WelchCompare":
        """Welch's t-test of ``metric`` between this frame and another,
        POOLING every row that matches the param ``filters`` on each
        side — pin the filters to one grid point for a per-point test
        (unfiltered, between-point variance enters the pooled samples).
        Retained H0 (|t| < 2, p > 0.05) means the two sides are
        statistically indistinguishable, the paper's equivalence
        criterion."""
        a = self.values(metric, **filters)
        b = other.values(metric, **filters)
        w = welch_ttest(a, b)
        return WelchCompare(metric=metric, t_stat=w.t_stat,
                            p_value=w.p_value, n_a=len(a), n_b=len(b),
                            retained=bool(abs(w.t_stat) < 2
                                          and w.p_value > 0.05)
                            if not math.isnan(w.t_stat) else False)

    # --------------------------------------------------------- round-trip
    def to_dict(self) -> dict:
        return {"name": self.name, "spec": self.spec,
                "rows": [r.to_dict() for r in self.rows]}

    def iter_json(self, indent: int = 1):
        """Yield the frame's JSON text in row-sized pieces.  The
        concatenation is byte-identical to
        ``json.dumps(self.to_dict(), indent=indent)`` (a test pins
        this), but only one row is materialized at a time — the
        soak-scale path."""
        pad1 = " " * indent
        yield "{\n"
        yield f'{pad1}"name": {json.dumps(self.name)},\n'
        yield f'{pad1}"spec": {_dumps_at(self.spec, indent, 1)},\n'
        if not self.rows:
            yield f'{pad1}"rows": []\n'
        else:
            yield f'{pad1}"rows": [\n'
            pad2 = " " * (2 * indent)
            last = len(self.rows) - 1
            for i, r in enumerate(self.rows):
                body = _dumps_at(r.to_dict(), indent, 2)
                yield f"{pad2}{body}" + (",\n" if i != last else "\n")
            yield f"{pad1}]\n"
        yield "}"

    def to_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        """Serialize (and optionally write) the frame.  Python's JSON
        encoder emits ``repr``-exact floats (and NaN/Infinity literals),
        so ``from_json(to_json(frame))`` reproduces every value
        bit-for-bit.  With ``path`` the frame is STREAMED to the file
        row by row (no whole-frame string) and the path is returned;
        without, the text itself is returned."""
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                for piece in self.iter_json(indent):
                    f.write(piece)
            return path
        return "".join(self.iter_json(indent))

    @classmethod
    def from_json(cls, text_or_path: str) -> "ResultFrame":
        """Load a frame from JSON text or a file path.  File input is
        parsed incrementally (row by row, bounded buffer) — a
        soak-scale artifact never materializes as one string."""
        if "\n" not in text_or_path and os.path.exists(text_or_path):
            frame = cls(name="")
            with open(text_or_path) as f:
                for key, val in _iter_frame_stream(f):
                    if key == "row":
                        frame.rows.append(SweepRow.from_dict(val))
                    elif key == "name":
                        frame.name = val
                    elif key == "spec":
                        frame.spec = val
            return frame
        d = json.loads(text_or_path)
        return cls(name=d["name"], spec=d.get("spec", {}),
                   rows=[SweepRow.from_dict(r) for r in d.get("rows", [])])

    @classmethod
    def iter_json_rows(cls, path: str):
        """Yield ``SweepRow``s straight off a frame file, one at a time
        — stream consumers (drift detectors, row filters) never hold
        the whole frame."""
        with open(path) as f:
            for key, val in _iter_frame_stream(f):
                if key == "row":
                    yield SweepRow.from_dict(val)

    # --------------------------------------------------------------- CSV
    def to_csv(self, path: str, aggregated: Optional[str] = None) -> str:
        """Write the frame as CSV.  Default: one row per (point, rep)
        with params and metrics flattened.  ``aggregated=<metric>``
        writes the per-point mean/ci95 table for that metric instead."""
        if aggregated is not None:
            rows = [{**a["params"], "metric": aggregated, "mean": a["mean"],
                     "ci95": a["ci95"], "n_reps": a["n_reps"],
                     "n_failed": a["n_failed"]}
                    for a in self.aggregate(aggregated)]
        else:
            rows = []
            for r in self.rows:
                rows.append({**r.params, "rep": r.rep, "seed": r.seed,
                             **r.metrics,
                             "error": r.error if r.error else ""})
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cols: list = []
        for r in rows:
            for c in r:
                if c not in cols:
                    cols.append(c)
        # csv.writer, not ','.join: error rows carry free-form exception
        # text that needs real quoting
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for r in rows:
                w.writerow([r.get(c, "") for c in cols])
        return path


# ---------------------------------------------------------------------------
# Streaming JSON plumbing
# ---------------------------------------------------------------------------
def _dumps_at(obj, indent: int, depth: int) -> str:
    """``json.dumps(obj, indent=indent)`` re-anchored at nesting
    ``depth`` — every newline gains the enclosing indentation, which is
    exactly how the stock encoder lays out a nested value."""
    s = json.dumps(obj, indent=indent)
    if "\n" in s:
        s = s.replace("\n", "\n" + " " * (indent * depth))
    return s


class _JsonStream:
    """Incremental JSON reader over a file object: a bounded growing
    buffer + ``JSONDecoder.raw_decode``, with the consumed prefix
    dropped after every refill so memory tracks the LARGEST single
    value, not the file."""

    _WS = " \t\n\r"

    def __init__(self, f, chunk: int = 1 << 16):
        self.f = f
        self.chunk = chunk
        self.buf = ""
        self.pos = 0
        self._dec = json.JSONDecoder()

    def _fill(self) -> bool:
        data = self.f.read(self.chunk)
        if not data:
            return False
        if self.pos:
            self.buf = self.buf[self.pos:]
            self.pos = 0
        self.buf += data
        return True

    def peek(self) -> str:
        """Next non-whitespace char ('' at EOF); does not consume."""
        while True:
            while self.pos < len(self.buf) and \
                    self.buf[self.pos] in self._WS:
                self.pos += 1
            if self.pos < len(self.buf):
                return self.buf[self.pos]
            if not self._fill():
                return ""

    def expect(self, ch: str) -> None:
        got = self.peek()
        if got != ch:
            raise ValueError(f"malformed frame JSON: expected {ch!r}, "
                             f"got {got!r}")
        self.pos += 1

    def value(self):
        """Decode one complete JSON value, refilling as needed."""
        self.peek()                       # position at the value start
        while True:
            try:
                obj, end = self._dec.raw_decode(self.buf, self.pos)
            except ValueError:
                if not self._fill():
                    raise
                continue
            if end == len(self.buf) and self._fill():
                # the value touched the buffer end: it might be a
                # truncated number — re-decode with more data
                continue
            self.pos = end
            return obj


def _iter_frame_stream(f):
    """Yield ``(key, value)`` per top-level frame entry, with the
    ``rows`` list exploded into one ``("row", dict)`` per element."""
    s = _JsonStream(f)
    s.expect("{")
    if s.peek() == "}":
        return
    while True:
        key = s.value()
        s.expect(":")
        if key == "rows" and s.peek() == "[":
            s.pos += 1
            if s.peek() == "]":
                s.pos += 1
            else:
                while True:
                    yield ("row", s.value())
                    if s.peek() == ",":
                        s.pos += 1
                        continue
                    s.expect("]")
                    break
        else:
            yield (key, s.value())
        if s.peek() == ",":
            s.pos += 1
            continue
        s.expect("}")
        return


@dataclass(frozen=True)
class WelchCompare:
    metric: str
    t_stat: float
    p_value: float
    n_a: int
    n_b: int
    retained: bool
