"""Request/response records shared by the simulator and real-engine paths.

Copy of ``repro.core.request``.

``slots=True`` matters at scale: a 10k-server, 1M-request run holds
millions of these; slots halve the per-object footprint and speed up the
attribute access on the simulator hot path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(slots=True)
class Request:
    req_id: int
    client_id: int
    created: float                  # generation time at the client
    service_demand: float           # seconds of server work (profile sample)
    # token-size semantics (batched ServiceModels): sampled client-side
    # from per-app length distributions so both runtime backends consume
    # identical request sizes.  0 = unsized (scalar service path).
    prompt_tokens: int = 0
    max_new_tokens: int = 0
    server_id: Optional[int] = None
    enqueued: Optional[float] = None
    started: Optional[float] = None
    completed: Optional[float] = None
    hedged: bool = False
    # O(1) hedge cancellation: a started twin tombstones its queued copy
    # instead of scanning the server queue (the queue skips it on pop).
    cancelled: bool = False
    _twin: Optional["Request"] = None      # mutual cancellation on start
    _primary: Optional["Request"] = None   # hedge clone credits the primary
    _recorded: bool = False

    @property
    def queue_time(self) -> float:
        return (self.started or 0.0) - (self.enqueued or self.created)

    @property
    def service_time(self) -> float:
        return (self.completed or 0.0) - (self.started or 0.0)

    @property
    def sojourn(self) -> float:
        """End-to-end latency (the paper's reported metric)."""
        return (self.completed or 0.0) - self.created
