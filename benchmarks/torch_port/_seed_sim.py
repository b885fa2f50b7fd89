"""Frozen copy of the seed discrete-event engine (commit 42b2234).

Twin of ``benchmarks/_seed_sim.py`` over ``repro_torch.core`` (the
reference's copy imports ``repro.core``), for
``benchmarks/torch_port/bench_simulator.py``.

Kept verbatim — binary heap, per-request closure allocation, O(n) alive-
server scan per routed request, list-based server queues with O(n)
``pop(0)``/``remove`` — so ``bench_simulator.py`` can A/B the rebuilt
calendar-queue engine against the exact algorithmic profile it replaced.
Only two deviations from the seed source:

* the recorder honors ``cfg.stats_mode`` so both engines pay identical
  stats costs in a comparison run;
* an ``events`` counter in ``run()`` (the benchmark's numerator).

Do not use outside benchmarks; the production engine lives in
``repro_torch.core.simulator``.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional

import numpy as np

from repro_torch.core.client import ClientConfig, ClientGenerator
from repro_torch.core.request import Request
from repro_torch.core.simulator import SimConfig
from repro_torch.core.stats import LatencyRecorder


class SeedSimServer:
    def __init__(self, server_id: int, workers: int = 1, speed: float = 1.0,
                 service_noise: float = 0.0):
        self.server_id = server_id
        self.workers = workers
        self.speed = speed
        self.service_noise = service_noise
        self._rng = np.random.default_rng((9176, server_id))
        self.queue: list[Request] = []
        self.busy = 0
        self.connected: set[int] = set()
        self.accepting = True
        self.draining = False
        self.total_served = 0
        self.busy_time = 0.0

    def connect(self, client_id: int) -> bool:
        if not self.accepting:
            return False
        self.connected.add(client_id)
        return True

    def disconnect(self, client_id: int):
        self.connected.discard(client_id)

    def enqueue(self, req: Request, now: float, sim: "SeedSimulator"):
        req.server_id = self.server_id
        req.enqueued = now
        if self.busy < self.workers:
            self._start(req, now, sim)
        else:
            self.queue.append(req)

    def _start(self, req: Request, now: float, sim: "SeedSimulator"):
        twin = getattr(req, "_twin", None)
        if twin is not None and twin.started is None:
            srv = sim.servers.get(twin.server_id)
            if srv is not None and twin in srv.queue:
                srv.queue.remove(twin)
        self.busy += 1
        req.started = now
        dur = req.service_demand / self.speed
        if self.service_noise > 0.0:
            dur *= float(np.exp(self.service_noise * self._rng.standard_normal()))
        self.busy_time += dur
        sim.schedule(now + dur, lambda t, r=req: self._finish(r, t, sim))

    def _finish(self, req: Request, now: float, sim: "SeedSimulator"):
        self.busy -= 1
        req.completed = now
        self.total_served += 1
        sim.on_completion(req)
        if self.queue:
            self._start(self.queue.pop(0), now, sim)

    def load(self) -> int:
        return self.busy + len(self.queue)


class SeedSimulator:
    def __init__(self, cfg: SimConfig, servers: list[SeedSimServer], balancer,
                 profile=None):
        self.cfg = cfg
        self.servers = {s.server_id: s for s in servers}
        self.balancer = balancer
        self.profile = profile
        self.recorder = LatencyRecorder(cfg.interval, mode=cfg.stats_mode)
        self._heap: list = []
        self._seq = itertools.count()
        self._req_ids = itertools.count()
        self.now = 0.0
        self.events = 0
        self.clients: dict[int, ClientGenerator] = {}
        self.assignment: dict[int, int] = {}
        self.dropped = 0
        self.completed_per_client: dict[int, int] = {}
        self._legacy_started = cfg.legacy_expected_clients == 0
        self._legacy_initial: set[int] = set()
        self._legacy_hold: list[Request] = []
        self._legacy_terminated = False

    def schedule(self, t: float, fn: Callable[[float], None]):
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def run(self):
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            if t > self.cfg.duration:
                break
            self.now = t
            fn(t)
            self.events += 1
        return self.recorder

    def add_client(self, ccfg: ClientConfig):
        gen = ClientGenerator(ccfg, self.profile)
        self.clients[ccfg.client_id] = gen
        self.schedule(ccfg.start_time, lambda t, c=ccfg: self._connect(c, t))

    def _connect(self, ccfg: ClientConfig, t: float):
        cid = ccfg.client_id
        if self.cfg.legacy_mode:
            if self._legacy_started and cid not in self._legacy_initial:
                self.dropped += 1
                return
            self._legacy_initial.add(cid)
        server = self.balancer.assign(self.clients[cid], self._alive_servers())
        if server is None or not server.connect(cid):
            self.dropped += 1
            return
        self.assignment[cid] = server.server_id
        if self.cfg.legacy_mode and not self._legacy_started:
            if len(self._legacy_initial) >= self.cfg.legacy_expected_clients:
                self._legacy_started = True
                for req in self._legacy_hold:
                    self._route(req, self.now)
                self._legacy_hold.clear()
        self._pump(cid)

    def _pump(self, cid: int):
        gen = self.clients[cid]
        if self.cfg.legacy_mode and self.cfg.legacy_requests_per_client is not None:
            if gen.sent >= self.cfg.legacy_requests_per_client:
                self._client_done(cid)
                return
        nxt = gen.next_arrival()
        if nxt is None:
            self._client_done(cid)
            return
        t, demand = nxt
        self.schedule(t, lambda tt, c=cid, d=demand: self._emit(c, d, tt))

    def _emit(self, cid: int, demand: float, t: float):
        req = Request(next(self._req_ids), cid, t, demand)
        if self.cfg.legacy_mode and not self._legacy_started:
            self._legacy_hold.append(req)
        elif self.cfg.legacy_mode and self._legacy_terminated:
            self.dropped += 1
        else:
            self._route(req, t)
        self._pump(cid)

    def _route(self, req: Request, t: float):
        sid = self.assignment.get(req.client_id)
        server = self.balancer.route(req, self._alive_servers(),
                                     self.servers.get(sid) if sid is not None else None)
        if server is None:
            self.dropped += 1
            return
        server.enqueue(req, t, self)
        if self.cfg.hedge_delay is not None:
            self.schedule(t + self.cfg.hedge_delay,
                          lambda tt, r=req: self._maybe_hedge(r, tt))

    def _maybe_hedge(self, req: Request, t: float):
        if req.completed is not None or req.hedged:
            return
        others = [s for s in self._alive_servers()
                  if s.server_id != req.server_id]
        if not others:
            return
        req.hedged = True
        clone = Request(req.req_id, req.client_id, req.created,
                        req.service_demand, hedged=True)
        clone._primary = req
        clone._twin = req
        req._twin = clone
        target = min(others, key=lambda s: s.load())
        target.enqueue(clone, t, self)

    def _client_done(self, cid: int):
        sid = self.assignment.pop(cid, None)
        if sid is not None:
            self.servers[sid].disconnect(cid)
        self.clients.pop(cid, None)
        if self.cfg.legacy_mode and not self.clients:
            self._legacy_terminated = True
        self.completed_per_client[cid] = self.completed_per_client.get(cid, 0)

    def on_completion(self, req: Request):
        primary = getattr(req, "_primary", None)
        if primary is not None:
            if getattr(primary, "_recorded", False):
                return
            primary.started = req.started
            primary.completed = req.completed
            primary.server_id = req.server_id
            req = primary
        if getattr(req, "_recorded", False):
            return
        req._recorded = True
        self.recorder.record(req)
        c = self.completed_per_client
        c[req.client_id] = c.get(req.client_id, 0) + 1

    def _alive_servers(self) -> list[SeedSimServer]:
        return [s for s in self.servers.values() if not s.draining]

    def add_server(self, server: SeedSimServer, at: float):
        def _add(t):
            self.servers[server.server_id] = server
        self.schedule(at, _add)

    def drain_server(self, server_id: int, at: float):
        def _drain(t):
            self.servers[server_id].draining = True
            self.servers[server_id].accepting = False
        self.schedule(at, _drain)
