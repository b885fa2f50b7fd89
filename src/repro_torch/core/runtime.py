"""Runtime layer: a compiled scenario on the vector grid runtime, the
event simulator or real engines.

Trimmed copy of ``repro.core.runtime``:

* ``run_scenario`` runs a ``Scenario`` on the vector runtime (on the
  card unless ``vector_config`` asks for the CPU), with
  ``backend="sim"`` on the virtual-time event simulator (host NumPy,
  bit-identical to the reference's), or with ``backend="engine"`` on
  the engines it is given;
* ``SimulatorRuntime`` is the thin adapter over ``build_simulator``;
* ``EngineRuntime`` is the wall-clock loop that drives step-based
  engines (``repro_torch.serving.engine``: the real ``InferenceEngine``
  on the card, or the ``StubEngine`` and ``BatchedStubEngine``
  stand-ins) with the reference's
  ``ClientGenerator`` arrival processes, the ``Balancer``
  assign/route/release lifecycle and the ``LatencyRecorder`` /
  ``MetricsPipeline`` telemetry;
* ``VirtualClock`` lets that loop run in accelerated virtual time.

``EngineRuntime`` carries the reference's resilience and control stack
(``repro_torch.control``): admission control with sheds as an explicit
disposition, circuit-breaker-filtered routing, per-attempt timeouts
with budgeted, jittered retries (the engine keeps serving a timed-out
request as zombie work), the closed control loop with its actuation lag,
and the ``set_admission``, ``set_scale``, ``set_retry`` and
``set_breaker`` injections.  Its jitter and admission draws come from
the reference's ``(RESILIENCE_STREAM, seed, rep)`` stream, so stub
engines on a ``VirtualClock`` give the reference's rows bit for bit.
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.control import (AdmissionController, CircuitBreaker,
                                 ControlLoop, RetryBudget)
from repro_torch.control.resilience import RESILIENCE_STREAM
from repro_torch.core.balancer import POLICIES
from repro_torch.core.client import ClientConfig, ClientGenerator
from repro_torch.core.harness import Experiment, build_simulator
from repro_torch.core.profiles import FixedProfile
from repro_torch.core.request import Request
from repro_torch.core.scenario import Injection
from repro_torch.core.stats import LatencyRecorder, MetricsPipeline

# injection kinds the wall-clock backend honors; speed scaling and
# hedging need simulator control over service execution and are
# reported as unsupported, as the reference does (and so is
# ``legacy_mode``, which the reference's engine runtime ignores)
_ENGINE_INJECTIONS = ("server_join", "server_drain", "server_fail",
                      "set_policy", "set_admission", "set_scale",
                      "set_retry", "set_breaker")


class Runtime:
    """A scenario execution backend: run once, expose telemetry."""

    recorder: LatencyRecorder
    telemetry: MetricsPipeline

    def run(self) -> MetricsPipeline:
        raise NotImplementedError


class SimulatorRuntime(Runtime):
    """Virtual-time backend — thin adapter over ``build_simulator``.
    Runs on the host: it makes no device claim and never touches torch."""

    def __init__(self, experiment: Experiment, rep: int = 0):
        self.sim = build_simulator(experiment, rep=rep)
        self.recorder = self.sim.recorder
        self.telemetry = self.sim.telemetry

    @property
    def dropped(self) -> int:
        return self.sim.dropped

    @property
    def shed(self) -> int:
        return self.sim.shed

    @property
    def timeouts(self) -> int:
        return self.sim.timeouts

    @property
    def retries(self) -> int:
        return self.sim.retries

    @property
    def control_log(self) -> list:
        return self.sim.control_log

    def run(self) -> MetricsPipeline:
        self.sim.run()
        return self.telemetry


# ---------------------------------------------------------------------------
# Virtual clock (accelerated wall-clock for stub engines and tests)
# ---------------------------------------------------------------------------
class VirtualClock:
    """A manually-advanced monotonic clock.

    ``sleep`` advances time instead of blocking; ``advance_to`` jumps
    forward but never past ``limit`` (the runtime parks the next arrival
    deadline there so an engine skipping ahead to its next completion
    cannot leap over a due admission).
    """

    def __init__(self, t: float = 0.0):
        self.t = t
        self.limit: Optional[float] = None

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt

    def advance_to(self, t: float) -> None:
        if self.limit is not None:
            t = min(t, self.limit)
        if t > self.t:
            self.t = t


# ---------------------------------------------------------------------------
# Engine-backed wall-clock runtime
# ---------------------------------------------------------------------------
class EngineServerHandle:
    """Balancer-compatible view of one engine replica (the surface the
    simulator's servers offer: server_id/connected/accepting/load/
    connect)."""

    def __init__(self, server_id: int, engine):
        self.server_id = server_id
        self.engine = engine
        self.connected: set[int] = set()
        self.accepting = True
        self.draining = False
        self.failed = False
        # an engine replica's concurrency is its batch slots, not worker
        # threads: telemetry resolves capacity from max_batch
        self.workers = None
        self.max_batch = getattr(engine, "max_batch", 1)
        self.serializes_ops = getattr(engine, "serializes_ops", False)
        self.outstanding: set[int] = set()     # req_ids submitted, not done
        self.total_served = 0

    @property
    def tokens_done(self):
        """Cumulative generated tokens, when the engine counts them."""
        return getattr(self.engine, "tokens_done", None)

    @property
    def busy(self) -> int:
        return self.engine.n_active()

    @property
    def busy_time(self):
        """Cumulative service seconds, when the engine accounts for them
        (StubEngine does; telemetry falls back to instantaneous busy)."""
        return getattr(self.engine, "busy_time", None)

    def load(self) -> int:
        return self.engine.pending() + self.engine.n_active()

    def connect(self, client_id: int) -> bool:
        if not self.accepting:
            return False
        self.connected.add(client_id)
        return True

    def disconnect(self, client_id: int) -> None:
        self.connected.discard(client_id)


class EngineRuntime(Runtime):
    """Drive real engines with the harness's open-loop client machinery.

    Arrivals come lazily from ``ClientGenerator`` (the reference's RNG
    streams), connection assignment / request routing / departure go
    through the full ``Balancer`` lifecycle, completions are recorded by
    a ``LatencyRecorder`` and per-interval gauges feed the
    ``MetricsPipeline``.  Admission control, circuit breakers, retries
    and the control loop act on the wall clock as the simulator's act on
    virtual time.
    """

    def __init__(self, engines, clients: Sequence[ClientConfig], *,
                 policy: str = "round_robin", duration: float = 10.0,
                 prompt_len: int = 16, max_new_tokens: int = 4,
                 vocab: int = 256, seed: int = 0, time_scale: float = 1.0,
                 interval: float = 1.0, slo: Optional[float] = None,
                 injections: Sequence = (), rep: int = 0,
                 profile=None, lengths=None, stats_mode: str = "exact",
                 engine_factory: Optional[Callable[[int], object]] = None,
                 retry=None, breaker=None, control=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if isinstance(engines, dict):
            handle_map = {sid: EngineServerHandle(sid, e)
                          for sid, e in engines.items()}
        else:
            handle_map = {i: EngineServerHandle(i, e)
                          for i, e in enumerate(engines)}
        self.handles: dict[int, EngineServerHandle] = handle_map
        self.balancer = POLICIES[policy]() if isinstance(policy, str) else policy
        self.duration = duration
        self.interval = interval
        self.time_scale = time_scale
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.vocab = vocab
        self.engine_factory = engine_factory
        # timestamps are recorded in wall seconds; with a stretched clock
        # (time_scale != 1) the recorder's bucket width scales with them so
        # interval indices stay in *virtual* time
        self.recorder = LatencyRecorder(interval * time_scale,
                                        mode=stats_mode, seed=seed, rep=rep)
        self.telemetry = MetricsPipeline(self.recorder, interval, slo=slo)
        self.dropped = 0
        self.submitted = 0             # attempts handed to an engine
        self._clock = clock
        self._sleep = sleep
        self._rng = np.random.default_rng(seed)
        self._rid = itertools.count()
        prof = profile if profile is not None else FixedProfile("tok", 0.0)
        self.lengths = lengths
        self.client_cfgs: dict[int, ClientConfig] = {c.client_id: c
                                                     for c in clients}
        self._gens: dict[int, ClientGenerator] = {
            c.client_id: ClientGenerator(c, prof, rng_stream=rep,
                                         lengths=lengths)
            for c in clients}
        self.assignment: dict[int, EngineServerHandle] = {}
        # req_id -> (cid, t_created_wall, attempt, prev_delay, ptoks,
        #            mnew, server_id)
        self._meta: dict[int, tuple] = {}
        self.slo = slo
        # the resilience stack: the simulator's policies and its
        # domain-tagged RNG stream, actuated on the wall clock
        self.shed = 0
        self.timeouts = 0
        self.retries = 0
        self._res_rng = np.random.default_rng((RESILIENCE_STREAM, seed, rep))
        self._admission: Optional[AdmissionController] = None
        self._breaker = CircuitBreaker(breaker) if breaker else None
        self._retry = retry
        self._retry_budget = (RetryBudget(retry.budget_ratio,
                                          retry.budget_burst)
                              if retry else None)
        self._deadlines: list = []     # (deadline_wall, req_id)
        self._retry_q: list = []       # (due_wall, seq, cid, t_created_wall,
                                       #  attempt, prev_delay, ptoks, mnew)
        self._rseq = itertools.count()
        # closed-loop control: tick boundaries are wall instants; actions
        # apply after the actuation lag through the same dispatch as
        # compiled injections
        self.control_log: list = []    # (t_virtual_applied, kind, params)
        self._control = ControlLoop(control) if control else None
        self._pending_actions: list = []   # (due_wall, seq, kind, params)
        self._next_control: Optional[float] = None
        # (at, seq) order: ties at identical timestamps apply in
        # declaration order, matching the simulator's total order
        self._injections = sorted((i for i in injections
                                   if i.kind in _ENGINE_INJECTIONS),
                                  key=lambda i: (i.at, i.seq))
        self.unsupported = [i for i in injections
                            if i.kind not in _ENGINE_INJECTIONS]
        self._alive: list[EngineServerHandle] = [
            h for h in self.handles.values() if not h.draining and not h.failed]
        # build engines for scheduled joins now, outside the measured
        # loop: a real engine warms for seconds, which would otherwise
        # stall serving at the join instant
        self._prepared: dict[int, object] = {}
        if engine_factory is not None:
            for inj in self._injections:
                if inj.kind == "server_join":
                    sid = inj.params["server_id"]
                    self._prepared[sid] = engine_factory(sid)

    # ------------------------------------------------------------ assembly
    @classmethod
    def from_experiment(cls, exp, engines, *, engine_factory=None,
                        rep: int = 0, prompt_len: int = 16,
                        max_new_tokens: int = 4, vocab: int = 256,
                        time_scale: float = 1.0,
                        clock: Callable[[], float] = time.monotonic,
                        sleep: Callable[[float], None] = time.sleep
                        ) -> "EngineRuntime":
        """Build the wall-clock runtime from a compiled scenario.

        ``engines`` supplies one engine per initial server spec (list, in
        spec order, or dict keyed by server_id); servers that join later
        are built via ``engine_factory(server_id)``.  Uses the
        experiment's app profile for the client generators, so arrival
        timelines are the reference's draw for draw.
        """
        from dataclasses import replace as _replace

        base = [s for s in exp.servers if s.join_at == 0.0]
        if not isinstance(engines, dict):
            engines = list(engines)
            if len(engines) < len(base):
                raise ValueError(f"need {len(base)} engines for the initial "
                                 f"fleet, got {len(engines)}")
            engines = {s.server_id: e for s, e in zip(base, engines)}
        else:
            joining = {s.server_id for s in exp.servers if s.join_at > 0.0}
            early = joining & engines.keys()
            if early:
                raise ValueError(f"servers {sorted(early)} join mid-run; "
                                 f"supply them via engine_factory, not the "
                                 f"initial engines dict")
        injections = list(exp.injections)
        if exp.hedge_delay is not None:
            # hedging is simulator-only: surface it as unsupported
            injections.append(Injection(0.0, "set_hedge",
                                        {"delay": exp.hedge_delay}))
        if exp.legacy_mode:
            # so is the legacy open-loop mode: the runtime serves the
            # experiment in its current mode and records the skip
            injections.append(Injection(0.0, "legacy_mode", {}))
        # spec-derived joins/drains get seq=-1: the simulator schedules
        # them BEFORE the compiled injections at equal timestamps
        for s in exp.servers:
            if s.join_at > 0.0:
                injections.append(Injection(s.join_at, "server_join",
                                            {"server_id": s.server_id,
                                             "workers": s.workers,
                                             "speed": s.speed,
                                             "service_noise": s.service_noise,
                                             "max_batch": s.max_batch},
                                            seq=-1))
            if s.drain_at is not None:
                injections.append(Injection(s.drain_at, "server_drain",
                                            {"server_id": s.server_id},
                                            seq=-1))
        clients = [_replace(c, seed=c.seed if c.seed else exp.seed)
                   for c in exp.clients]
        rt = cls(engines, clients, policy=exp.policy,
                 duration=exp.duration, interval=exp.interval,
                 vocab=vocab, prompt_len=prompt_len,
                 max_new_tokens=max_new_tokens, seed=exp.seed,
                 time_scale=time_scale, slo=exp.slo, injections=injections,
                 rep=rep, profile=exp.resolved_profile(),
                 lengths=exp.resolved_lengths(), stats_mode=exp.stats_mode,
                 engine_factory=engine_factory, retry=exp.retry,
                 breaker=exp.breaker, control=exp.control,
                 clock=clock, sleep=sleep)
        # standby pool: engines exist (built and warm) but start drained
        # until a scale action activates them
        for s in exp.servers:
            if s.standby:
                h = rt.handles.get(s.server_id)
                if h is not None:
                    h.draining = True
                    h.accepting = False
        rt._rebuild_alive()
        return rt

    # ------------------------------------------------------------ internals
    def _rebuild_alive(self) -> None:
        self._alive = [h for h in self.handles.values()
                       if not h.draining and not h.failed]

    def _push_next(self, heap: list, cid: int) -> None:
        gen = self._gens.get(cid)
        if gen is None:
            return
        nxt = gen.next_arrival()
        if nxt is None or nxt[0] > self.duration:
            self._client_done(cid)
            return
        ptoks, mnew = gen.last_sizes       # sampled with the arrival
        heapq.heappush(heap, (nxt[0] * self.time_scale, cid, ptoks, mnew))

    def _client_done(self, cid: int) -> None:
        handle = self.assignment.pop(cid, None)
        if handle is not None:
            handle.disconnect(cid)
        self._gens.pop(cid, None)
        self.balancer.release(cid)

    def _admit(self, cid: int, t_arr: float, ptoks: int = 0,
               mnew: int = 0) -> bool:
        """Admit one arrival; False means the client was terminated
        (connection refused: a refused client never generates traffic).
        ``ptoks``/``mnew`` are the client-sampled token sizes (0 =
        unsized: the runtime's fixed prompt_len/max_new_tokens)."""
        gen = self._gens[cid]
        if cid not in self.assignment:
            handle = self.balancer.assign(gen, self._alive)
            if handle is None or not handle.connect(cid):
                self.balancer.release(cid)
                self._gens.pop(cid, None)
                self.dropped += 1
                return False
            self.assignment[cid] = handle
        self._submit(cid, t_arr, t_arr, ptoks, mnew, 0, 0.0)
        return True

    def _submit(self, cid: int, t_sub: float, t_created: float, ptoks: int,
                mnew: int, attempt: int, prev_delay: float) -> None:
        """Route and submit one attempt (primary or retry) at wall instant
        ``t_sub``, as the simulator routes: admission control first
        (sheds are an explicit disposition), then breaker-filtered
        routing, then the attempt's timeout deadline."""
        t_virt = t_sub / self.time_scale
        adm = self._admission
        if adm is not None and not adm.allow(t_virt, self._res_rng):
            self.shed += 1
            self.dropped += 1
            self.recorder.record_failure(t_sub, "shed")
            return
        pref = self.assignment.get(cid)
        alive = self._alive
        brk = self._breaker
        if brk is not None:
            allowed = {h.server_id: brk.allow(h.server_id, t_virt)
                       for h in alive}
            ok = [h for h in alive if allowed[h.server_id]]
            if ok:
                alive = ok
                if pref is not None and not allowed.get(pref.server_id, True):
                    pref = None
        handle = self.balancer.route(None, alive, pref)
        if handle is None or handle.failed:
            self.dropped += 1
            self.recorder.record_failure(t_sub, "failed")
            return
        rid = next(self._rid)
        n_prompt = ptoks if ptoks > 0 else self.prompt_len
        n_new = mnew if mnew > 0 else self.max_new_tokens
        prompt = self._rng.integers(0, self.vocab, size=n_prompt)
        self._meta[rid] = (cid, t_created, attempt, prev_delay, ptoks, mnew,
                           handle.server_id)
        handle.outstanding.add(rid)
        handle.engine.submit(prompt, n_new, rid)
        self.submitted += 1
        rp = self._retry
        if rp is not None:
            if attempt == 0 and self._retry_budget is not None:
                self._retry_budget.note_primary()
            heapq.heappush(self._deadlines,
                           (t_sub + rp.timeout * self.time_scale, rid))

    def _complete(self, handle: EngineServerHandle, comp, wall: float) -> None:
        meta = self._meta.pop(comp.req_id, None)
        handle.outstanding.discard(comp.req_id)
        if meta is None:
            return     # a failed server's request or a timed-out zombie:
                       # the work was real, the response is not
        cid, t_arr = meta[0], meta[1]
        rec = Request(comp.req_id, cid, t_arr, 0.0)
        rec.enqueued = t_arr
        rec.started = wall - comp.latency
        rec.completed = wall
        rec.server_id = handle.server_id
        self.recorder.record(rec)
        if self._breaker is not None:
            self._breaker.record(handle.server_id, True,
                                 wall / self.time_scale)
        handle.total_served += 1

    def _apply_injection(self, inj, now: float = 0.0) -> None:
        kind, p = inj.kind, inj.params
        if kind == "server_join":
            sid = p["server_id"]
            existing = self.handles.get(sid)
            if existing is not None and not existing.failed:
                raise ValueError(f"server_join for live server {sid}: "
                                 f"replacing it would orphan its in-flight "
                                 f"requests")
            engine = self._prepared.pop(sid, None)
            if engine is None:
                if self.engine_factory is None:
                    raise ValueError("server_join injection needs "
                                     "engine_factory")
                engine = self.engine_factory(sid)
            self.handles[sid] = EngineServerHandle(sid, engine)
            self._rebuild_alive()
        elif kind == "server_drain":
            h = self.handles.get(p["server_id"])
            if h is not None:
                h.accepting = False
                h.draining = True
                self._rebuild_alive()
        elif kind == "server_fail":
            h = self.handles.get(p["server_id"])
            if h is not None and not h.failed:
                h.failed = True
                h.accepting = False
                for rid in h.outstanding:
                    if self._meta.pop(rid, None) is not None:
                        self.dropped += 1
                        self.recorder.record_failure(now, "failed")
                        if self._breaker is not None:
                            self._breaker.record(h.server_id, False,
                                                 now / self.time_scale)
                h.outstanding.clear()
                self._rebuild_alive()
                for cid in list(h.connected):
                    h.disconnect(cid)
                    self._reassign(cid)
        elif kind == "set_policy":
            pol = p["policy"]
            self.balancer = POLICIES[pol]() if isinstance(pol, str) else pol
        elif kind == "set_admission":
            admit, rate = p.get("admit"), p.get("rate")
            if rate is None and (admit is None or admit >= 1.0):
                self._admission = None
            else:
                self._admission = AdmissionController(
                    admit=admit, rate=rate, burst=p.get("burst", 1.0))
        elif kind == "set_scale":
            self.scale_to(int(p["n"]))
        elif kind == "set_retry":
            pol = p["policy"]
            self._retry = pol
            self._retry_budget = (RetryBudget(pol.budget_ratio,
                                              pol.budget_burst)
                                  if pol is not None else None)
        elif kind == "set_breaker":
            spec = p["spec"]
            self._breaker = CircuitBreaker(spec) if spec is not None else None
        else:                                   # pre-filtered in __init__
            raise ValueError(f"unsupported engine injection: {kind!r}")

    def scale_to(self, n: int) -> None:
        """Elastic scale, as the simulator's ``scale_to``: activate the
        first ``n`` non-failed handles in server-id order and drain the
        rest (in-flight work completes, clients re-home)."""
        pool = [h for h in sorted(self.handles.values(),
                                  key=lambda h: h.server_id)
                if not h.failed]
        for h in pool[:n]:
            if h.draining:
                h.draining = False
                h.accepting = True
        for h in pool[n:]:
            if not h.draining:
                h.draining = True
                h.accepting = False
                for cid in list(h.connected):
                    h.disconnect(cid)
                    self._reassign(cid)
        self._rebuild_alive()

    def _check_deadlines(self, now: float) -> None:
        """Expire the attempt timeouts due by ``now``.  The engine-side
        request is not cancelled: it keeps its batch slot until it
        completes, and ``_complete`` then discards it (zombie work, the
        simulator's wasted-work semantics)."""
        while self._deadlines and self._deadlines[0][0] <= now:
            deadline, rid = heapq.heappop(self._deadlines)
            meta = self._meta.pop(rid, None)
            if meta is None:
                continue               # completed (or destroyed) in time
            cid, t_created, attempt, prev_delay, ptoks, mnew, sid = meta
            rp = self._retry
            if rp is None:
                continue               # policy removed mid-flight
            if self._breaker is not None:
                self._breaker.record(sid, False, deadline / self.time_scale)
            budget = self._retry_budget
            if (attempt < rp.max_retries and budget is not None
                    and budget.allow()):
                budget.note_retry()
                self.retries += 1
                delay = rp.delay(attempt + 1, prev_delay, self._res_rng)
                heapq.heappush(self._retry_q,
                               (deadline + delay * self.time_scale,
                                next(self._rseq), cid, t_created,
                                attempt + 1, delay, ptoks, mnew))
            else:
                self.timeouts += 1
                self.dropped += 1
                self.recorder.record_failure(deadline, "timeout")

    def _drain_retries(self, now: float) -> None:
        """Re-issue the backed-off retries due by ``now`` (they re-enter
        ``_submit``, so they pass admission control again)."""
        while self._retry_q and self._retry_q[0][0] <= now:
            due, _, cid, t_created, attempt, prev_delay, ptoks, mnew = \
                heapq.heappop(self._retry_q)
            self._submit(cid, due, t_created, ptoks, mnew, attempt,
                         prev_delay)

    def _control_step(self, now: float) -> None:
        """Closed-loop controller: tick at each control boundary due by
        ``now``, queue its actions for ``now + lag``, apply due actions."""
        loop = self._control
        spec = loop.spec
        scale = self.time_scale
        while (self._next_control <= now
               and self._next_control <= self.duration * scale):
            t_virt = self._next_control / scale
            admit = (self._admission.level
                     if self._admission is not None else 1.0)
            slo_wall = self.slo * scale if self.slo is not None else None
            # observe in the recorder's (wall) time base, gate the
            # cooldown in virtual time, as the simulator does
            obs = loop.observe(self.recorder, self._alive,
                               self._next_control, slo_wall, admit)
            for kind, params in loop.tick(obs, t_virt):
                due = self._next_control + spec.lag * scale
                self.control_log.append((t_virt + spec.lag, kind,
                                         dict(params)))
                heapq.heappush(self._pending_actions,
                               (due, next(self._rseq), kind, dict(params)))
            self._next_control += spec.interval * scale
        while self._pending_actions and self._pending_actions[0][0] <= now:
            due, _, kind, params = heapq.heappop(self._pending_actions)
            self._apply_injection(Injection(due, kind, params), now=due)

    def _reassign(self, cid: int) -> None:
        self.balancer.release(cid)
        self.assignment.pop(cid, None)
        gen = self._gens.get(cid)
        if gen is None:
            return
        handle = self.balancer.assign(gen, self._alive)
        if handle is None or not handle.connect(cid):
            self.balancer.release(cid)
            return
        self.assignment[cid] = handle

    def _drain_gauges(self, now: float) -> None:
        """Sample per-server gauges for every interval boundary that has
        elapsed (boundaries are wall instants; labels are virtual time)."""
        while self._next_sample <= now and \
                self._next_sample <= self.duration * self.time_scale:
            self.telemetry.sample_servers(
                self._next_sample / self.time_scale, self.handles.values())
            self._next_sample += self.interval * self.time_scale

    def _next_events(self, heap: list, inj_idx: int, end_wall: float) -> list:
        """Wall instants of the next due event of every kind: arrival,
        injection, gauge sample, attempt deadline, retry, lagged control
        action and control tick.  Only events that clear themselves
        belong here (the horizon does not: parking the clock on it would
        wedge a completion due just past it)."""
        targets = []
        if heap:
            targets.append(heap[0][0])
        if inj_idx < len(self._injections):
            targets.append(self._injections[inj_idx].at * self.time_scale)
        if self._next_sample <= end_wall:
            targets.append(self._next_sample)
        for q in (self._deadlines, self._retry_q, self._pending_actions):
            if q:
                targets.append(q[0][0])
        if self._next_control is not None and self._next_control <= end_wall:
            targets.append(self._next_control)
        return targets

    # ---------------------------------------------------------------- run
    def run(self) -> MetricsPipeline:
        heap: list = []
        for cid in list(self._gens):
            self._push_next(heap, cid)
        injections = self._injections
        inj_idx = 0
        self._next_sample = self.interval * self.time_scale
        self._next_control = (self._control.spec.interval * self.time_scale
                              if self._control is not None else None)
        end_wall = self.duration * self.time_scale
        t0 = self._clock()
        while True:
            now = self._clock() - t0
            while inj_idx < len(injections) and \
                    injections[inj_idx].at * self.time_scale <= now:
                self._apply_injection(injections[inj_idx],
                                      now=injections[inj_idx].at
                                      * self.time_scale)
                inj_idx += 1
            self._drain_gauges(now)
            if self._control is not None:
                self._control_step(now)
            self._check_deadlines(now)
            self._drain_retries(now)
            admitted = False
            while heap and heap[0][0] <= now:
                t_arr, cid, ptoks, mnew = heapq.heappop(heap)
                if self._admit(cid, t_arr, ptoks, mnew):
                    self._push_next(heap, cid)
                admitted = True
            # pending injections, retries and control actions keep the
            # loop alive (sleeping toward them) even after the last
            # request drains, as the simulator's horizon does
            if (not heap and not self._meta and not self._retry_q
                    and not self._pending_actions
                    and inj_idx >= len(injections)):
                break
            # park the next due event on the clock so engines skipping
            # ahead in virtual time cannot leap over it
            if hasattr(self._clock, "limit"):
                targets = self._next_events(heap, inj_idx, end_wall)
                self._clock.limit = t0 + min(targets) if targets else None
            stepped = False
            for handle in list(self.handles.values()):
                if handle.failed or handle.engine.idle():
                    continue
                completions = handle.engine.step()
                stepped = True
                if completions:
                    wall = self._clock() - t0
                    for comp in completions:
                        self._complete(handle, comp, wall)
            if not admitted and not stepped:
                # nothing in flight: sleep the whole gap to the next due
                # event (or the horizon); with work outstanding poll at 1ms
                now = self._clock() - t0
                wait = min([end_wall]
                           + self._next_events(heap, inj_idx, end_wall)) - now
                if self._meta:
                    wait = min(wait, 0.001)
                self._sleep(max(wait, 1e-6))
        # close out the idle tail: sample every remaining interval up to
        # the scenario horizon
        self._drain_gauges(end_wall)
        return self.telemetry


# ---------------------------------------------------------------------------
# One entry point
# ---------------------------------------------------------------------------
def run_scenario(scenario, backend: str = "vector", *, rep: int = 0,
                 vector_config=None, engines=None, engine_factory=None,
                 cache=None, **engine_kw):
    """Compile ``scenario`` and execute repetition ``rep`` on ``backend``:
    ``"vector"`` (the grid runtime; ``vector_config`` picks the device,
    the card by default; a ``repro_torch.cache.ResultCache`` in
    ``cache`` serves the cell warm when it holds it), ``"sim"`` (the
    event simulator, on the host) or ``"engine"`` (wall clock, on the
    supplied ``engines``).  Returns the finished runtime (telemetry under
    ``.telemetry``).

    The default backend differs from the reference's: ``"vector"`` here,
    ``"sim"`` in ``repro.core.runtime.run_scenario``.  The port's entry
    points run on the card unless the caller asks for the host, so
    ``run_scenario(sc)`` gives the card's vector rows, which are
    statistically equivalent to ``sim``'s, not equal to them; it raises
    where there is no card.  Pass ``backend="sim"`` for the reference's
    default (its rows bit-identical to the reference's)."""
    exp = scenario.compile()
    if backend == "sim":
        rt = SimulatorRuntime(exp, rep=rep)
    elif backend == "vector":
        from repro_torch.vector import VectorRuntime
        rt = VectorRuntime(exp, rep=rep, config=vector_config, cache=cache)
    elif backend == "engine":
        if engines is None:
            raise ValueError("backend='engine' needs engines=")
        rt = EngineRuntime.from_experiment(exp, engines, rep=rep,
                                           engine_factory=engine_factory,
                                           **engine_kw)
    else:
        raise ValueError(f"unknown backend: {backend!r}")
    rt.run()
    return rt
