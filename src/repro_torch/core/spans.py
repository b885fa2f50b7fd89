"""In-memory spans of the serving engine.

A ``SpanLog`` keeps each span as ``Span(id, parent, name, start, end,
attrs)``: ``parent`` is the id of the span that holds it (None at the
top), times are ``time.perf_counter()`` seconds, the clock of the
engine's step counters, and an event is a span whose start is its end.
A request's top spans carry its ``req_id`` in ``attrs``.  The log only
appends; a reader takes ``log.spans`` once the run is over.

``InferenceEngine`` records into the log its ``spans`` attribute holds
(None by default, and then it records nothing).  A span opens no
``torch.profiler.record_function``: a program annotation would show in
a device trace as a ``gpu_user_annotation`` and count as device work.
"""
from __future__ import annotations

from typing import NamedTuple, Optional


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    start: float
    end: float
    attrs: dict


class SpanLog:
    def __init__(self) -> None:
        self.spans: list[Span] = []

    def add(self, name: str, start: float, end: float,
            parent: Optional[int] = None, **attrs) -> int:
        """Record a finished span (an event where ``start == end``) and
        return its id."""
        sid = len(self.spans)
        self.spans.append(Span(sid, parent, name, start, end, attrs))
        return sid
