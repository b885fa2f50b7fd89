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
  on the card, or ``StubEngine``) with the reference's
  ``ClientGenerator`` arrival processes, the ``Balancer``
  assign/route/release lifecycle and the ``LatencyRecorder`` /
  ``MetricsPipeline`` telemetry;
* ``VirtualClock`` lets that loop run in accelerated virtual time.

Not ported yet: the resilience and control features of
``repro_torch.control`` on ``EngineRuntime`` (retries, breakers,
admission control, the control loop, and the ``set_retry``,
``set_breaker``, ``set_admission`` and ``set_scale`` injections), which
raise ``NotImplementedError`` there.  The simulator runs them all.
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.balancer import POLICIES
from repro_torch.core.client import ClientConfig, ClientGenerator
from repro_torch.core.harness import Experiment, build_simulator
from repro_torch.core.profiles import FixedProfile
from repro_torch.core.request import Request
from repro_torch.core.stats import LatencyRecorder, MetricsPipeline

# injection kinds the wall-clock backend honors; speed scaling and
# hedging need simulator control over service execution and are
# reported as unsupported, as the reference does
_ENGINE_INJECTIONS = ("server_join", "server_drain", "server_fail",
                      "set_policy")
# injection kinds of repro_torch.control that EngineRuntime does not
# carry yet (the simulator does)
_NOT_PORTED = ("set_admission", "set_scale", "set_retry", "set_breaker")


class SimulatorRuntime:
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


class EngineRuntime:
    """Drive real engines with the harness's open-loop client machinery.

    Arrivals come lazily from ``ClientGenerator`` (the reference's RNG
    streams), connection assignment / request routing / departure go
    through the full ``Balancer`` lifecycle, completions are recorded by
    a ``LatencyRecorder`` and per-interval gauges feed the
    ``MetricsPipeline``.
    """

    def __init__(self, engines, clients: Sequence[ClientConfig], *,
                 policy: str = "round_robin", duration: float = 10.0,
                 prompt_len: int = 16, max_new_tokens: int = 4,
                 vocab: int = 256, seed: int = 0, time_scale: float = 1.0,
                 interval: float = 1.0, slo: Optional[float] = None,
                 injections: Sequence = (), rep: int = 0,
                 profile=None, lengths=None,
                 engine_factory: Optional[Callable[[int], object]] = None,
                 retry=None, breaker=None, control=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        for name, spec in (("retry", retry), ("breaker", breaker),
                           ("control", control)):
            if spec is not None:
                raise NotImplementedError(f"{name} (repro.control) is not "
                                          f"ported yet")
        for inj in injections:
            if inj.kind in _NOT_PORTED:
                raise NotImplementedError(f"injection {inj.kind!r} "
                                          f"(repro.control) is not ported "
                                          f"yet")
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
        self.recorder = LatencyRecorder(interval * time_scale)
        self.telemetry = MetricsPipeline(self.recorder, interval, slo=slo)
        self.dropped = 0
        self.submitted = 0             # requests handed to an engine
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
        # req_id -> (cid, t_created_wall, server_id)
        self._meta: dict[int, tuple] = {}
        self.slo = slo
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

        from repro_torch.core.scenario import Injection

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
                 lengths=exp.resolved_lengths(),
                 engine_factory=engine_factory, retry=exp.retry,
                 breaker=exp.breaker, control=exp.control,
                 clock=clock, sleep=sleep)
        # standby pool: engines exist but start drained
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
        self._submit(cid, t_arr, ptoks, mnew)
        return True

    def _submit(self, cid: int, t_sub: float, ptoks: int, mnew: int) -> None:
        """Route and submit one request at wall instant ``t_sub``."""
        handle = self.balancer.route(None, self._alive,
                                     self.assignment.get(cid))
        if handle is None or handle.failed:
            self.dropped += 1
            self.recorder.record_failure(t_sub, "failed")
            return
        rid = next(self._rid)
        n_prompt = ptoks if ptoks > 0 else self.prompt_len
        n_new = mnew if mnew > 0 else self.max_new_tokens
        prompt = self._rng.integers(0, self.vocab, size=n_prompt)
        self._meta[rid] = (cid, t_sub, handle.server_id)
        handle.outstanding.add(rid)
        handle.engine.submit(prompt, n_new, rid)
        self.submitted += 1

    def _complete(self, handle: EngineServerHandle, comp, wall: float) -> None:
        meta = self._meta.pop(comp.req_id, None)
        handle.outstanding.discard(comp.req_id)
        if meta is None:
            return     # a request of a failed server: the work was real,
                       # the response is not
        cid, t_arr = meta[0], meta[1]
        rec = Request(comp.req_id, cid, t_arr, 0.0)
        rec.enqueued = t_arr
        rec.started = wall - comp.latency
        rec.completed = wall
        rec.server_id = handle.server_id
        self.recorder.record(rec)
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
                h.outstanding.clear()
                self._rebuild_alive()
                for cid in list(h.connected):
                    h.disconnect(cid)
                    self._reassign(cid)
        elif kind == "set_policy":
            pol = p["policy"]
            self.balancer = POLICIES[pol]() if isinstance(pol, str) else pol
        else:                                   # pre-filtered in __init__
            raise ValueError(f"unsupported engine injection: {kind!r}")

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
        """Wall instants of the next arrival, injection and gauge sample."""
        targets = []
        if heap:
            targets.append(heap[0][0])
        if inj_idx < len(self._injections):
            targets.append(self._injections[inj_idx].at * self.time_scale)
        if self._next_sample <= end_wall:
            targets.append(self._next_sample)
        return targets

    # ---------------------------------------------------------------- run
    def run(self) -> MetricsPipeline:
        heap: list = []
        for cid in list(self._gens):
            self._push_next(heap, cid)
        injections = self._injections
        inj_idx = 0
        self._next_sample = self.interval * self.time_scale
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
            admitted = False
            while heap and heap[0][0] <= now:
                t_arr, cid, ptoks, mnew = heapq.heappop(heap)
                if self._admit(cid, t_arr, ptoks, mnew):
                    self._push_next(heap, cid)
                admitted = True
            # pending injections keep the loop alive (sleeping toward
            # them) even after the last request drains, as the
            # simulator's horizon does
            if not heap and not self._meta and inj_idx >= len(injections):
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
                 **engine_kw):
    """Compile ``scenario`` and execute repetition ``rep`` on ``backend``:
    ``"vector"`` (the grid runtime; ``vector_config`` picks the device,
    the card by default), ``"sim"`` (the event simulator, on the host) or
    ``"engine"`` (wall clock, on the supplied ``engines``).  Returns the
    finished runtime (telemetry under ``.telemetry``)."""
    exp = scenario.compile()
    if backend == "sim":
        rt = SimulatorRuntime(exp, rep=rep)
    elif backend == "vector":
        from repro_torch.vector import VectorRuntime
        rt = VectorRuntime(exp, rep=rep, config=vector_config)
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
