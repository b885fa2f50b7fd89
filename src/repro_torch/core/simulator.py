"""Deterministic discrete-event simulator for multi-client/multi-server runs.

Implements the TailBench++ server semantics:
  Feature 1 — servers admit new client connections at any time
  Feature 2 — servers persist at zero connected clients
  Feature 3 — request budgets live in the clients
  Feature 4 — clients re-pace themselves from their QPS schedule
plus connection- and request-level load balancing, hedged requests, and
mid-run server add/drain (elastic scaling).  ``legacy_mode`` restores the
original TailBench restrictions (the paper's baseline for Fig. 4/Table 4).

Engine architecture (rebuilt for 10k-server scale):
  * events live in a calendar queue (``repro_torch.core.events.CalendarQueue``)
    — O(1) amortized push/pop with an exact ``(t, seq)`` total order, so
    runs are bit-identical to the original heap engine;
  * the two hot event types (client emit, server finish) are typed tuples
    dispatched inline by ``run()`` — no per-request closure allocation;
  * server queues are deques; hedge cancellation tombstones the queued
    twin in O(1) instead of scanning and splicing the queue;
  * the alive-server list is cached and invalidated only on server
    add/drain, removing the O(n_servers) scan from every routed request;
  * ``Balancer.release()`` is invoked when a client finishes, so stateful
    policies (e.g. load-aware subscription tracking) see churn.

Virtual time, seeded RNG streams: bit-reproducible.  Copy of
``repro.core.simulator``: host NumPy only, it never touches torch, and
its runs are bit-identical to the reference's.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.control import (AdmissionController, CircuitBreaker, ControlLoop,
                           RetryBudget)
from repro_torch.control.resilience import RESILIENCE_STREAM
from repro_torch.core.client import ClientConfig, ClientGenerator
from repro_torch.core.events import CalendarQueue
from repro_torch.core.profiles import BatchScheduler, apply_service_noise
from repro_torch.core.request import Request
from repro_torch.core.stats import LatencyRecorder, MetricsPipeline

# typed event kinds (first payload slot after (t, seq))
_EMIT, _FINISH, _CALL, _BSTEP = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Server: G/G/c FIFO queue with a service-time profile, or a
# continuous-batching serve loop behind a batched ServiceModel
# ---------------------------------------------------------------------------
class SimServer:
    """Two service disciplines behind one surface:

    * scalar (default): G/G/c FIFO — ``workers`` independent slots, each
      request holds one for its client-sampled ``service_demand``;
    * batched (``service_model.kind == "batched"``): a continuous-batching
      serve loop — admit up to ``max_batch`` resident sequences, ops
      (one prefill OR one batched decode step) are scheduled as calendar
      events, and per-step costs come from the ``BatchedService``.  The
      op sequencing lives in the shared ``BatchScheduler``, which the
      wall-clock ``BatchedStubEngine`` drives too — sim and engine agree
      on batching dynamics by construction.
    """

    def __init__(self, server_id: int, workers: int = 1, speed: float = 1.0,
                 service_noise: float = 0.0,
                 rng_seed: Optional[tuple] = None,
                 service_model=None, max_batch: Optional[int] = None):
        self.server_id = server_id
        self.workers = workers
        self.speed = speed
        # server-side execution variability (interference, GC pauses...):
        # multiplicative log-normal noise drawn per execution.  This is what
        # hedged requests exploit (Dean & Barroso).
        self.service_noise = service_noise
        # rng_seed threads (experiment seed, server_id, rep) through so
        # repetitions draw independent server-noise streams — the bare
        # (9176, server_id) default replayed identical noise across all 13
        # reps, understating confidence intervals.
        self._rng = np.random.default_rng(
            (9176, server_id) if rng_seed is None else rng_seed)
        self.queue: deque = deque()
        self._q_cancelled = 0          # tombstoned entries still in `queue`
        self.busy = 0
        self.connected: set[int] = set()       # client ids
        self.accepting = True
        self.draining = False
        self.failed = False            # fault injection: completions are lost
        self.total_served = 0
        self.busy_time = 0.0
        self.service_model = service_model
        self._batched = (service_model is not None
                         and getattr(service_model, "kind", "scalar")
                         == "batched")
        if self._batched:
            self.max_batch = max_batch or 8
            self.workers = None        # capacity is batch slots, not workers
            self.serializes_ops = True  # one op at a time: util normalizes
                                        # per server, not per slot
            self.batch = BatchScheduler(service_model, self.max_batch)
            self.queue = self.batch.waiting    # shared deque: load()/fail
            self.tokens_done = 0               # cumulative (tokens/s gauge)

    # -- connection management (Features 1 + 2) -----------------------------
    def connect(self, client_id: int) -> bool:
        if not self.accepting:
            return False
        self.connected.add(client_id)
        return True

    def disconnect(self, client_id: int):
        self.connected.discard(client_id)

    # -- request path --------------------------------------------------------
    def enqueue(self, req: Request, now: float, sim: "Simulator"):
        req.server_id = self.server_id
        req.enqueued = now
        if self._batched:
            self.batch.submit(req, req.prompt_tokens, req.max_new_tokens)
            if self.batch.op is None:          # engine idle: start serving
                self._kick(now, sim)
            return
        if self.busy < self.workers:
            self._start(req, now, sim)
        else:
            self.queue.append(req)

    def _tombstone_twin(self, req: Request, sim: "Simulator"):
        """Entering service tombstones the queued hedge twin — O(1),
        skipped on pop.  Shared by the scalar and batched start paths so
        the hedge-cancellation invariant lives in exactly one place."""
        twin = req._twin
        if twin is not None and twin.started is None and not twin.cancelled:
            twin.cancelled = True
            srv = sim.servers.get(twin.server_id)
            if srv is not None:
                srv._q_cancelled += 1

    # -- continuous-batching serve loop (batched ServiceModel) ---------------
    def _skip_cancelled(self, req: Request) -> bool:
        """start_op predicate: drop hedge-cancelled twins at admission."""
        if req.cancelled:
            self._q_cancelled -= 1
            return True
        return False

    def _kick(self, now: float, sim: "Simulator"):
        """Start the next batching op and schedule its finish event."""
        dur = self.batch.start_op(skip=self._skip_cancelled)
        if dur is None:
            self.busy = 0
            return
        op = self.batch.op
        if op[0] == "prefill":
            req = op[1].key
            self._tombstone_twin(req, sim)
            req.started = now
        dur = apply_service_noise(dur / self.speed, self.service_noise,
                                  self._rng)
        self.busy_time += dur
        self.busy = self.batch.occupancy()
        sim._push_batch_step(now + dur, self)

    def _batch_step(self, t: float, sim: "Simulator"):
        """Finish the in-flight op: complete exhausted requests, then
        start the next op (prefill-priority, like the real engine)."""
        if self.failed:
            # the server died mid-op: the whole resident batch is lost
            for req in self.batch.abort():
                if not req.cancelled:
                    sim._lost(req)
                    req.cancelled = True
            self.busy = 0
            return
        for req in self.batch.finish_op():
            req.completed = t
            self.total_served += 1
            sim.on_completion(req)
        self.tokens_done = self.batch.tokens_done
        self._kick(t, sim)

    def queued_requests(self) -> list:
        """Requests waiting for service (fault-injection accounting) —
        the scalar deque holds them directly, the batched scheduler
        wraps them in BatchItems."""
        if self._batched:
            return [it.key for it in self.batch.waiting]
        return list(self.queue)

    def _start(self, req: Request, now: float, sim: "Simulator"):
        self._tombstone_twin(req, sim)
        self.busy += 1
        req.started = now
        dur = apply_service_noise(req.service_demand / self.speed,
                                  self.service_noise, self._rng)
        self.busy_time += dur
        sim._push_finish(now + dur, self, req)

    def _finish(self, req: Request, now: float, sim: "Simulator"):
        self.busy -= 1
        if self.failed:
            # the server died while this request was in flight: the
            # response is lost, and nothing further starts here
            sim._lost(req)
            req.cancelled = True      # block any pending hedge timer
            return
        req.completed = now
        self.total_served += 1
        sim.on_completion(req)
        q = self.queue
        while q:
            nxt = q.popleft()
            if nxt.cancelled:
                self._q_cancelled -= 1
                continue
            self._start(nxt, now, sim)
            return

    def load(self) -> int:
        return self.busy + len(self.queue) - self._q_cancelled


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------
@dataclass
class SimConfig:
    duration: float = 60.0
    interval: float = 1.0                 # stats bucketing
    seed: int = 0
    legacy_mode: bool = False             # original TailBench semantics
    legacy_expected_clients: int = 0      # server waits for this many
    legacy_requests_per_client: Optional[int] = None  # server-owned budget
    hedge_delay: Optional[float] = None   # straggler mitigation (beyond paper)
    rep: int = 0                          # repetition index -> RNG stream
    stats_mode: str = "exact"             # "exact" | "streaming"
    fast_clients: bool = False            # vectorized arrival generation
    slo: Optional[float] = None           # latency SLO for telemetry frames
    gauges: bool = True                   # sample per-server telemetry gauges
                                          # each interval (off: saves the
                                          # O(n_servers) sweep per interval)
    # resilience + closed-loop control (repro_torch.control)
    retry: Optional[object] = None        # RetryPolicy: timeouts + retries
    breaker: Optional[object] = None      # BreakerSpec: per-server breaking
    control: Optional[object] = None      # ControlSpec: reactive controller


class Simulator:
    def __init__(self, cfg: SimConfig, servers: list[SimServer], balancer,
                 profile=None, lengths=None, service_model=None):
        self.cfg = cfg
        self.servers = {s.server_id: s for s in servers}
        self.balancer = balancer
        self.profile = profile
        self.lengths = lengths              # default TokenLengths for clients
        self.service_model = service_model  # applied to injected server joins
        self.recorder = LatencyRecorder(cfg.interval, mode=cfg.stats_mode,
                                        seed=cfg.seed, rep=cfg.rep)
        self.telemetry = MetricsPipeline(self.recorder, cfg.interval,
                                         slo=cfg.slo)
        self._queue = CalendarQueue(cfg.duration)
        self._seq = itertools.count()
        self._req_ids = itertools.count()
        # hot-path bindings: these run once per request
        self._push = self._queue.push
        self._next_seq = self._seq.__next__
        self._next_rid = self._req_ids.__next__
        self._legacy = cfg.legacy_mode
        self._hedge_delay = cfg.hedge_delay
        self._route_fn = balancer.route
        self.now = 0.0
        self.events = 0                           # executed event count
        self.clients: dict[int, ClientGenerator] = {}
        self.assignment: dict[int, int] = {}      # client -> server
        self.dropped = 0
        self.completed_per_client: dict[int, int] = {}
        # alive-server cache: kept valid at all times, rebuilt only on
        # server add/drain (the seed engine rebuilt it per routed request)
        self._alive: list[SimServer] = [s for s in self.servers.values()
                                        if not s.draining]
        # legacy-mode state
        self._legacy_started = cfg.legacy_expected_clients == 0
        self._legacy_initial: set[int] = set()
        self._legacy_hold: list[Request] = []
        self._legacy_terminated = False
        # resilience stack: admission control, circuit breaking, client
        # timeouts/retries.  The jitter/admission RNG is domain-tagged
        # (RESILIENCE_STREAM, seed, rep) and draws nothing unless a
        # policy is active — existing runs stay bit-identical.
        self.shed = 0                             # admission-rejected requests
        self.timeouts = 0                         # failed after all retries
        self.retries = 0                          # retry attempts issued
        self._res_rng = np.random.default_rng(
            (RESILIENCE_STREAM, cfg.seed, cfg.rep))
        self._admission: Optional[AdmissionController] = None
        self._breaker = CircuitBreaker(cfg.breaker) if cfg.breaker else None
        self._retry = cfg.retry
        self._retry_budget = (RetryBudget(cfg.retry.budget_ratio,
                                          cfg.retry.budget_burst)
                              if cfg.retry else None)
        # closed-loop control: one ControlLoop ticking every spec.interval,
        # acting through the same appliers as compiled injections
        self.control_log: list = []               # (t_applied, kind, params)
        self._control = ControlLoop(cfg.control) if cfg.control else None
        if self._control is not None:
            self.schedule(cfg.control.interval, self._control_tick)
        # telemetry: per-server gauges sampled at every interval boundary
        # (read-only callbacks — they never perturb simulation state)
        if cfg.gauges:
            self.schedule(cfg.interval, self._sample_gauges)

    # ------------------------------------------------------------------ core
    def schedule(self, t: float, fn: Callable[[float], None]):
        self._push((t, self._next_seq(), _CALL, fn))

    def _push_finish(self, t: float, server: SimServer, req: Request):
        self._push((t, self._next_seq(), _FINISH, server, req))

    def _push_batch_step(self, t: float, server: SimServer):
        self._push((t, self._next_seq(), _BSTEP, server))

    def run(self):
        pop = self._queue.pop
        horizon = self.cfg.duration
        emit = self._emit
        n = 0
        while True:
            ev = pop()
            if ev is None:
                break
            t = ev[0]
            if t > horizon:
                break
            self.now = t
            kind = ev[2]
            if kind == _EMIT:
                emit(ev[3], ev[4], ev[5], ev[6], t)
            elif kind == _FINISH:
                ev[3]._finish(ev[4], t, self)
            elif kind == _BSTEP:
                ev[3]._batch_step(t, self)
            else:
                ev[3](t)
            n += 1
        self.events += n
        return self.recorder

    # ------------------------------------------------------- client lifecycle
    def add_client(self, ccfg: ClientConfig):
        """Client appears at ccfg.start_time (Feature 1: any time)."""
        from repro_torch.core.client import BatchedClientGenerator, ConstantQPS
        if (self.cfg.fast_clients and isinstance(ccfg.schedule, ConstantQPS)
                and ccfg.schedule.qps > 0):
            gen = BatchedClientGenerator(ccfg, self.profile,
                                         rng_stream=self.cfg.rep,
                                         lengths=self.lengths)
        else:
            gen = ClientGenerator(ccfg, self.profile, rng_stream=self.cfg.rep,
                                  lengths=self.lengths)
        self.clients[ccfg.client_id] = gen
        self.schedule(ccfg.start_time, lambda t, c=ccfg: self._connect(c, t))

    def _connect(self, ccfg: ClientConfig, t: float):
        cid = ccfg.client_id
        if self.cfg.legacy_mode:
            if self._legacy_started and cid not in self._legacy_initial:
                self.dropped += 1          # original: no connects after start
                return
            self._legacy_initial.add(cid)
        server = self.balancer.assign(self.clients[cid], self._alive)
        if server is None or not server.connect(cid):
            self.balancer.release(cid)     # undo any subscription bookkeeping
            self.dropped += 1
            return
        self.assignment[cid] = server.server_id
        if self.cfg.legacy_mode and not self._legacy_started:
            if len(self._legacy_initial) >= self.cfg.legacy_expected_clients:
                self._legacy_started = True
                for req in self._legacy_hold:    # release held requests
                    self._route(req, self.now)
                self._legacy_hold.clear()
        self._pump(cid)

    def _pump(self, cid: int):
        gen = self.clients[cid]
        if self._legacy and self.cfg.legacy_requests_per_client is not None:
            if gen.sent >= self.cfg.legacy_requests_per_client:
                self._client_done(cid)
                return
        nxt = gen.next_arrival()
        if nxt is None:
            self._client_done(cid)
            return
        t, demand = nxt
        ptoks, mnew = gen.last_sizes
        self._push((t, self._next_seq(), _EMIT, cid, demand, ptoks, mnew))

    def _emit(self, cid: int, demand: float, ptoks: int, mnew: int, t: float):
        req = Request(self._next_rid(), cid, t, demand, ptoks, mnew)
        if self._legacy:
            if not self._legacy_started:
                self._legacy_hold.append(req)  # original: server not started
            elif self._legacy_terminated:
                self.dropped += 1
            else:
                self._route(req, t)
        else:
            self._route(req, t)
        self._pump(cid)

    def _route(self, req: Request, t: float, attempt: int = 0,
               prev_delay: float = 0.0):
        adm = self._admission
        if adm is not None and not adm.allow(t, self._res_rng):
            # load shedding is an explicit disposition, never a silent
            # drop: the request lands in the recorder's failure ledger
            self.shed += 1
            self.dropped += 1
            self.recorder.record_failure(t, "shed")
            return
        sid = self.assignment.get(req.client_id)
        pref = self.servers.get(sid) if sid is not None else None
        alive = self._alive
        brk = self._breaker
        if brk is not None:
            allowed = {s.server_id: brk.allow(s.server_id, t) for s in alive}
            ok = [s for s in alive if allowed[s.server_id]]
            if ok:                    # all-open: fail open, keep full fleet
                alive = ok
                if pref is not None and not allowed.get(pref.server_id, True):
                    pref = None       # broken preferred server: re-route
        server = self._route_fn(req, alive, pref)
        if server is None:
            self.dropped += 1
            self.recorder.record_failure(t, "failed")
            return
        server.enqueue(req, t, self)
        rp = self._retry
        if rp is not None:
            if attempt == 0 and self._retry_budget is not None:
                self._retry_budget.note_primary()
            self.schedule(t + rp.timeout,
                          lambda tt, r=req, a=attempt, p=prev_delay:
                          self._check_timeout(r, a, p, tt))
        hedge = self._hedge_delay
        if hedge is not None:
            self.schedule(t + hedge,
                          lambda tt, r=req: self._maybe_hedge(r, tt))

    def _maybe_hedge(self, req: Request, t: float):
        """Tail-at-scale hedging: re-issue if still incomplete."""
        if req.completed is not None or req.hedged or req.cancelled:
            return            # done, already hedged, or destroyed by a failure
        others = [s for s in self._alive
                  if s.server_id != req.server_id]
        if not others:
            return
        req.hedged = True
        clone = Request(req.req_id, req.client_id, req.created,
                        req.service_demand, req.prompt_tokens,
                        req.max_new_tokens, hedged=True)
        clone._primary = req          # first completion wins
        clone._twin = req             # mutual cancellation on start
        req._twin = clone
        target = min(others, key=lambda s: s.load())
        target.enqueue(clone, t, self)

    def _check_timeout(self, req: Request, attempt: int, prev_delay: float,
                       t: float):
        """Client-side timeout: the client abandons this attempt.  The
        server-side copy is NOT cancelled — it keeps burning capacity
        (wasted work), which is exactly what makes naive retry storms
        metastable.  The eventual completion is discarded by
        ``on_completion``'s ``_recorded`` guard (zombie semantics, same
        as the wall-clock engine)."""
        if req.completed is not None or req._recorded or req.cancelled:
            return
        rp = self._retry
        if rp is None:                 # policy removed mid-flight: no-op
            return
        req._recorded = True           # zombie: completion won't be recorded
        if self._breaker is not None and req.server_id is not None:
            self._breaker.record(req.server_id, False, t)
        budget = self._retry_budget
        if (attempt < rp.max_retries and budget is not None
                and budget.allow()):
            budget.note_retry()
            self.retries += 1
            delay = rp.delay(attempt + 1, prev_delay, self._res_rng)
            self.schedule(t + delay,
                          lambda tt, r=req, a=attempt + 1, d=delay:
                          self._retry_emit(r, a, d, tt))
        else:
            # retries exhausted (or budget says no): explicit disposition
            self.timeouts += 1
            self.dropped += 1
            self.recorder.record_failure(t, "timeout")

    def _retry_emit(self, orig: Request, attempt: int, prev_delay: float,
                    t: float):
        """Re-issue a timed-out request.  The fresh attempt keeps the
        ORIGINAL creation time, so a retried request's recorded latency
        honestly spans queueing + backoff across all attempts.  Retries
        re-enter ``_route``, so they pass admission control again."""
        req = Request(self._next_rid(), orig.client_id, orig.created,
                      orig.service_demand, orig.prompt_tokens,
                      orig.max_new_tokens)
        self._route(req, t, attempt=attempt, prev_delay=prev_delay)

    def _client_done(self, cid: int):
        sid = self.assignment.pop(cid, None)
        if sid is not None:
            self.servers[sid].disconnect(cid)
        self.clients.pop(cid, None)
        self.balancer.release(cid)     # stateful policies drop ghost load
        if self.cfg.legacy_mode and not self.clients:
            self._legacy_terminated = True     # original: server exits
        self.completed_per_client[cid] = self.completed_per_client.get(cid, 0)

    # ------------------------------------------------------------ completions
    def on_completion(self, req: Request):
        primary = req._primary
        if primary is not None:               # hedge clone: credit the primary
            if primary._recorded:
                return
            primary.started = req.started
            primary.completed = req.completed
            primary.server_id = req.server_id
            req = primary
        if req._recorded:                     # primary served first, or the
            return                            # client timed out (zombie work)
        req._recorded = True
        self.recorder.record(req)
        if self._breaker is not None and req.server_id is not None:
            self._breaker.record(req.server_id, True, req.completed)
        c = self.completed_per_client
        c[req.client_id] = c.get(req.client_id, 0) + 1

    # ------------------------------------------------------- elastic servers
    def _alive_servers(self) -> list[SimServer]:
        return self._alive

    def _rebuild_alive(self):
        self._alive = [s for s in self.servers.values() if not s.draining]

    def add_server(self, server: SimServer, at: float):
        def _add(t):
            self.servers[server.server_id] = server
            self._rebuild_alive()
        self.schedule(at, _add)

    def drain_server(self, server_id: int, at: float):
        def _drain(t):
            self.servers[server_id].draining = True
            self.servers[server_id].accepting = False
            self._rebuild_alive()
        self.schedule(at, _drain)

    # ------------------------------------------------------------- telemetry
    def _sample_gauges(self, t: float):
        self.telemetry.sample_servers(t, self.servers.values())
        nxt = t + self.cfg.interval
        if nxt <= self.cfg.duration:
            self.schedule(nxt, self._sample_gauges)

    # ------------------------------------------------------------ injections
    def fail_server(self, server_id: int, at: float):
        """Fault injection: at ``at`` the server dies — queued requests and
        in-flight responses are lost, connected clients rebalance."""
        def _fail(t):
            srv = self.servers.get(server_id)
            if srv is None or srv.failed:
                return
            srv.failed = True
            srv.accepting = False
            srv.draining = True
            # queued work is lost now; a batched server's resident batch
            # is lost when its in-flight op event fires (_batch_step)
            for req in srv.queued_requests():
                if not req.cancelled:
                    self._lost(req)
                    req.cancelled = True   # pending hedge timers must not
            srv.queue.clear()              # resurrect a destroyed request
            srv._q_cancelled = 0
            self._rebuild_alive()
            for cid in list(srv.connected):
                srv.disconnect(cid)
                self._reassign(cid, t)
        self.schedule(at, _fail)

    def _lost(self, req: Request):
        """A copy of ``req`` was destroyed by a server failure.  Count a
        drop only when no other copy can still deliver it — a hedged
        request with a live twin elsewhere is not lost, and counting it
        would double-book the request as both dropped and served."""
        primary = req._primary or req
        if primary._recorded:
            return
        twin = req._twin
        if twin is not None and not twin.cancelled and twin.completed is None:
            srv = self.servers.get(twin.server_id)
            if srv is not None and not srv.failed:
                return                # twin survives on a healthy server
        # no copy can deliver it: account the drop exactly once (a hedge
        # pair destroyed by the same failure reaches here for both copies)
        primary._recorded = True
        self.dropped += 1
        self.recorder.record_failure(self.now, "failed")
        if self._breaker is not None and req.server_id is not None:
            self._breaker.record(req.server_id, False, self.now)

    def _reassign(self, cid: int, t: float):
        """Re-home a live client after its server vanished."""
        self.balancer.release(cid)
        self.assignment.pop(cid, None)
        gen = self.clients.get(cid)
        if gen is None:
            return
        server = self.balancer.assign(gen, self._alive)
        if server is None or not server.connect(cid):
            self.balancer.release(cid)
            return               # unassigned: requests fall back to route()
        self.assignment[cid] = server.server_id

    def set_server_speed(self, server_id: int, at: float, factor: float):
        """Slowdown/speedup injection: scale the server's speed at ``at``."""
        def _set(t):
            srv = self.servers.get(server_id)
            if srv is not None:
                srv.speed *= factor
        self.schedule(at, _set)

    def set_policy(self, policy, at: float):
        """Swap the balancing policy mid-run: new assignments and
        request-level routing use it from ``at`` onward."""
        def _set(t):
            from repro_torch.core.balancer import POLICIES
            b = POLICIES[policy]() if isinstance(policy, str) else policy
            self.balancer = b
            self._route_fn = b.route
        self.schedule(at, _set)

    def set_hedge(self, delay: Optional[float], at: float):
        """Enable/retune/disable request hedging mid-run."""
        def _set(t):
            self._hedge_delay = delay
        self.schedule(at, _set)

    # ------------------------------------------------ resilience + control
    def set_admission(self, at: float, params: dict):
        """Install/replace/disable admission control at ``at``."""
        def _set(t):
            admit = params.get("admit")
            rate = params.get("rate")
            if rate is None and (admit is None or admit >= 1.0):
                self._admission = None     # fully open: no draws, no state
            else:
                self._admission = AdmissionController(
                    admit=admit, rate=rate, burst=params.get("burst", 1.0))
        self.schedule(at, _set)

    def set_retry(self, policy, at: float):
        """Install (policy) or remove (None) the client retry policy."""
        def _set(t):
            self._retry = policy
            self._retry_budget = (RetryBudget(policy.budget_ratio,
                                              policy.budget_burst)
                                  if policy is not None else None)
        self.schedule(at, _set)

    def set_breaker(self, spec, at: float):
        """Install (spec) or remove (None) per-server circuit breaking."""
        def _set(t):
            self._breaker = CircuitBreaker(spec) if spec is not None else None
        self.schedule(at, _set)

    def scale_to(self, n: int, at: float):
        """Elastic scale: activate the first ``n`` non-failed servers (in
        server-id order, drawing standbys out of drain) and drain the
        rest.  Draining servers finish residual work; their connected
        clients stay until the client-side lifecycle moves them."""
        def _scale(t):
            pool = [s for s in sorted(self.servers.values(),
                                      key=lambda s: s.server_id)
                    if not s.failed]
            for s in pool[:n]:
                if s.draining:
                    s.draining = False
                    s.accepting = True
            for s in pool[n:]:
                if not s.draining:
                    s.draining = True
                    s.accepting = False
                    for cid in list(s.connected):
                        s.disconnect(cid)
                        self._reassign(cid, t)
            self._rebuild_alive()
        self.schedule(at, _scale)

    def _control_tick(self, t: float):
        """One closed-loop controller step: observe the window, let the
        policy act, apply actions after the actuation lag through the
        same appliers compiled injections use.  Applied actions land in
        ``control_log`` for cost accounting and determinism checks."""
        loop = self._control
        admit = self._admission.level if self._admission is not None else 1.0
        obs = loop.observe(self.recorder, self._alive, t, self.cfg.slo,
                           admit)
        for kind, params in loop.tick(obs, t):
            at = t + loop.spec.lag
            self.control_log.append((at, kind, dict(params)))
            self.apply_injection(kind, at, params)
        nxt = t + loop.spec.interval
        if nxt <= self.cfg.duration:
            self.schedule(nxt, self._control_tick)

    def apply_injection(self, kind: str, at: float, params: dict):
        """Apply one compiled ``Scenario`` injection (see core/scenario.py)."""
        if kind == "server_fail":
            self.fail_server(params["server_id"], at)
        elif kind == "server_speed":
            self.set_server_speed(params["server_id"], at, params["factor"])
        elif kind == "server_join":
            sid = params["server_id"]
            # same (seed, server_id, rep) noise-stream layout as
            # build_simulator: injected joins must not replay identical
            # noise across repetitions either
            rng_seed = params.get("rng_seed") or (9176, self.cfg.seed, sid,
                                                  self.cfg.rep)
            self.add_server(
                SimServer(sid, params.get("workers", 1),
                          params.get("speed", 1.0),
                          params.get("service_noise", 0.0),
                          rng_seed=rng_seed,
                          service_model=self.service_model,
                          max_batch=params.get("max_batch")), at)
        elif kind == "server_drain":
            self.drain_server(params["server_id"], at)
        elif kind == "set_policy":
            self.set_policy(params["policy"], at)
        elif kind == "set_hedge":
            self.set_hedge(params["delay"], at)
        elif kind == "set_admission":
            self.set_admission(at, params)
        elif kind == "set_scale":
            self.scale_to(int(params["n"]), at)
        elif kind == "set_retry":
            self.set_retry(params["policy"], at)
        elif kind == "set_breaker":
            self.set_breaker(params["spec"], at)
        else:
            raise ValueError(f"unknown injection kind: {kind!r}")
