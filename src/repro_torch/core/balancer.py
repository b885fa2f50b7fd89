"""Load balancing policies (the paper's LVS director, generalized).

Copy of ``repro.core.balancer``.

The paper balances at *connection* granularity (LVS assigns each client to
a server): ``assign(client, servers)``.  Round-robin and the load-aware
policy of Fig. 8 are connection-level.  Beyond the paper we add
request-level policies (``route``): join-shortest-queue and
power-of-two-choices, plus hedging in the simulator.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np


class Balancer:
    """Default: honor the connection assignment for every request.

    Lifecycle: the simulator calls ``assign`` when a client connects and
    ``release`` when it finishes (or its connection attempt fails), so
    stateful policies can drop per-client bookkeeping under churn.

    A request can reach ``route`` with no assignment — its client joined
    while the fleet was empty, or its server failed and every re-home
    attempt was refused.  That fallback goes through ``choose``, the
    policy's own per-request pick; the old ``servers[0]`` fallback
    silently hot-spotted the first alive server under exactly the churn
    conditions a balancer exists for.
    """

    def assign(self, client, servers) -> Optional[object]:
        raise NotImplementedError

    def release(self, client_id: int) -> None:
        """Client departed — forget any per-client state.  No-op by default."""

    def choose(self, req, servers):
        """Policy choice for an unassigned request (least-loaded unless
        the policy has a sharper criterion)."""
        if not servers:
            return None
        return min(servers, key=lambda s: s.load())

    def route(self, req, servers, assigned):
        if assigned is not None:
            return assigned
        return self.choose(req, servers)


class RoundRobin(Balancer):
    """LVS default: clients assigned to servers in arrival order."""

    def __init__(self):
        self._n = itertools.count()

    def assign(self, client, servers):
        if not servers:
            return None
        return servers[next(self._n) % len(servers)]

    def choose(self, req, servers):
        """Unassigned requests keep rotating instead of pinning the
        first alive server."""
        if not servers:
            return None
        return servers[next(self._n) % len(servers)]


class LoadAware(Balancer):
    """Paper Fig. 8: balance the *offered QPS* across servers — assign each
    arriving client to the server with the least total subscribed rate.

    Subscriptions are released when the client departs (``release``), so
    under churn new clients are not steered by the ghost load of clients
    that finished long ago."""

    def __init__(self):
        self.subscribed: dict[int, float] = {}
        self._client_sub: dict[int, tuple[int, float]] = {}  # cid -> (sid, qps)

    def assign(self, client, servers):
        if not servers:
            return None
        qps = client.cfg.schedule.rate(client.cfg.start_time)
        best = min(servers, key=lambda s: self.subscribed.get(s.server_id, 0.0))
        self.subscribed[best.server_id] = self.subscribed.get(best.server_id, 0.0) + qps
        self._client_sub[client.cfg.client_id] = (best.server_id, qps)
        return best

    def release(self, client_id: int) -> None:
        sub = self._client_sub.pop(client_id, None)
        if sub is None:
            return
        sid, qps = sub
        cur = self.subscribed.get(sid)
        if cur is not None:
            self.subscribed[sid] = max(0.0, cur - qps)

    def choose(self, req, servers):
        """Unassigned requests follow the least-subscribed criterion
        (no subscription is booked — the client never connected), with
        live queue load as the tie-break: a fresh fleet has every
        subscription at zero, and without the tie-break min() would pin
        the first server — the exact hot-spot this fallback replaces."""
        if not servers:
            return None
        return min(servers, key=lambda s: (self.subscribed.get(s.server_id,
                                                               0.0),
                                           s.load()))


class LeastConnections(Balancer):
    def assign(self, client, servers):
        if not servers:
            return None
        return min(servers, key=lambda s: len(s.connected))

    def choose(self, req, servers):
        if not servers:
            return None
        return min(servers, key=lambda s: len(s.connected))


class JoinShortestQueue(Balancer):
    """Request-level: ignore the connection, pick the least-loaded server."""

    def assign(self, client, servers):
        return servers[0] if servers else None

    def route(self, req, servers, assigned):
        if not servers:
            return None
        return min(servers, key=lambda s: s.load())


class PowerOfTwo(Balancer):
    """Request-level: sample two servers, take the less loaded (Mitzenmacher)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def assign(self, client, servers):
        return servers[0] if servers else None

    def route(self, req, servers, assigned):
        if not servers:
            return None
        if len(servers) == 1:
            return servers[0]
        i, j = self.rng.choice(len(servers), size=2, replace=False)
        a, b = servers[int(i)], servers[int(j)]
        return a if a.load() <= b.load() else b


POLICIES = {
    "round_robin": RoundRobin,
    "load_aware": LoadAware,
    "least_connections": LeastConnections,
    "jsq": JoinShortestQueue,
    "p2c": PowerOfTwo,
}
