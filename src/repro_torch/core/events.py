"""Calendar-queue event scheduler for the discrete-event simulator.

A classic binary heap costs O(log n) per operation with n pending events;
at 10k servers the heap holds tens of thousands of entries and every
push/pop walks ~17 levels.  A calendar queue (Brown 1988) exploits the
fact that simulation time only moves forward: events are hashed into
fixed-width time buckets, so insertion is O(1) and dequeue is O(1)
amortized.

This variant is a *timeline* calendar: the bucket array spans
``[0, horizon]`` (the simulator's configured duration), so there is no
year wrap-around to reason about.  Events inside the currently-active
bucket window live in a small binary heap (C-implemented ``heapq`` on a
few dozen entries), which gives an exact global ``(t, seq)`` total order
— identical to the order the seed heap engine produced, so results are
bit-reproducible across engines.

Entries are tuples whose first two fields are ``(t, seq)``; ties on ``t``
are broken by the monotone sequence number, never by the payload, so
heterogeneous payloads are safe.

The bucket array grows (4x, with full redistribution) whenever the
pending-event count exceeds ``GROW_FACTOR`` entries per bucket, keeping
the active-window heap small under load.  If the caller passes a horizon
much larger than the span events actually occupy, the structure degrades
gracefully to a single heap — correct, just not faster than the seed.

Copy of ``repro.core.events``.
"""
from __future__ import annotations

from heapq import heapify, heappop, heappush

GROW_FACTOR = 8          # pending events per bucket before growing
MAX_BUCKETS = 1 << 20


class CalendarQueue:
    """Monotone priority queue over ``[0, horizon]`` keyed on ``(t, seq)``."""

    __slots__ = ("horizon", "_nb", "_inv", "_buckets", "_act", "_idx", "_n",
                 "_last_t")

    def __init__(self, horizon: float, n_buckets: int = 256):
        self.horizon = max(float(horizon), 1e-9)
        self._nb = n_buckets
        self._inv = n_buckets / self.horizon        # 1 / bucket width
        self._buckets: list[list] = [[] for _ in range(n_buckets)]
        self._act: list = []       # heap for the active bucket window
        self._idx = -1             # last promoted bucket index
        self._n = 0
        self._last_t = 0.0

    def __len__(self) -> int:
        return self._n

    def push(self, item: tuple) -> None:
        i = int(item[0] * self._inv)
        if i >= self._nb:          # clamp BEFORE the active-window check:
            i = self._nb - 1       # a beyond-horizon event must land in the
        if i <= self._idx:         # heap when the last bucket is already
            heappush(self._act, item)  # active, or pop() would never see it
        else:
            self._buckets[i].append(item)
        self._n += 1
        if self._n > GROW_FACTOR * self._nb and self._nb < MAX_BUCKETS:
            self._grow()

    def pop(self):
        """Next event in global ``(t, seq)`` order, or None when empty."""
        act = self._act
        if act:
            self._n -= 1
            item = heappop(act)
            self._last_t = item[0]
            return item
        buckets, nb = self._buckets, self._nb
        idx = self._idx
        while idx + 1 < nb:
            idx += 1
            b = buckets[idx]
            if b:
                buckets[idx] = []
                heapify(b)
                self._act = b
                self._idx = idx
                self._n -= 1
                item = heappop(b)
                self._last_t = item[0]
                return item
        self._idx = idx
        return None

    def _grow(self) -> None:
        pending = self._act
        for i in range(self._idx + 1, self._nb):
            pending += self._buckets[i]
        self._nb *= 4
        self._inv = self._nb / self.horizon
        self._buckets = [[] for _ in range(self._nb)]
        self._idx = min(int(self._last_t * self._inv), self._nb - 1)
        act: list = []
        last = self._nb - 1
        for item in pending:
            i = min(int(item[0] * self._inv), last)
            if i <= self._idx:
                act.append(item)
            else:
                self._buckets[i].append(item)
        heapify(act)
        self._act = act
