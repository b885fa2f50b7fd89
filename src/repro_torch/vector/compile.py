"""Lower an ``Experiment`` onto the vector runtime's array program.

``compile_experiment`` turns one compiled scenario point into a
``VectorProgram``: per-slot per-server offered-rate arrays (after a
scalar replay of the connection-level balancer assignment), capacity /
speed / liveness schedules, exact service-law moments for the CLT work
aggregation, and the batched-service token laws.  A program is built
ONCE per sweep point and shared by every repetition — repetitions
differ only in their RNG draws, which the runtime derives per cell.

Approximation contract (what makes this the statistically-equivalent
fast lane rather than a bit-identical replay):

* arrivals are slotted non-homogeneous Poisson (exact for the open-loop
  generators up to slot discretization);
* connection-level policies (round-robin, load-aware, least-
  connections) are replayed exactly as client->server rate assignment;
  request-level policies (jsq, p2c) become per-slot water-filling of
  the least-backlogged accepting servers — the fluid limit of JSQ;
* request hedging has no fluid analogue and is surfaced through
  ``unsupported`` (the scenario CLI prints the skip) instead of being
  silently dropped.

Copy of ``repro.vector.compile``, the closed-loop control pre-pass
(``_control_prepass``) included; ``program_from_numpy`` carries a
program compiled elsewhere (the JAX package's) into this runtime.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.control import BreakerSpec, ControlSpec, RetryPolicy
from repro_torch.core.harness import Experiment
from repro_torch.core.profiles import (BatchedService, FixedProfile,
                                       LogNormalProfile, TokenLengths)
from repro_torch.core.scenario import Injection

#: request-level policies (per-slot water-fill); everything else is
#: replayed as connection-level assignment
FREE_POLICIES = ("jsq", "p2c")


class VectorCompileError(ValueError):
    """The experiment uses a feature the vector backend cannot lower."""


def _schedule_rates(schedule, centers: np.ndarray) -> np.ndarray:
    r = np.asarray(schedule.rate_array(centers), float)
    return np.where(np.isnan(r), 0.0, r)


@dataclass
class VectorProgram:
    """Structure-of-arrays form of one experiment point."""
    dt: float
    n_slots: int
    duration: float
    interval: float
    slo: Optional[float]
    server_ids: list                    # column -> server_id
    workers: np.ndarray                 # [S] capacity slots per server
    speed: np.ndarray                   # [T, S] execution speed factor
    active: np.ndarray                  # [T, S] 1.0 while serving capacity
    accepting: np.ndarray               # [T, S] 1.0 while routable
    fail_slot: np.ndarray               # [S] failing slot index, -1 = never
    rate_conn: np.ndarray               # [T, S] connection-assigned QPS
    rate_free: np.ndarray               # [T] request-level-routed QPS
    # scalar service law (per-server: execution noise folds in)
    work_mean: np.ndarray               # [S] E[service work] seconds
    work_var: np.ndarray                # [S] Var[service work]
    noise_sigma: np.ndarray             # [S] log-sigma of execution noise
    profile: object = None              # per-request demand law (sampling)
    # batched continuous-batching law
    batched: bool = False
    service: object = None              # BatchedService when batched
    lengths: object = None              # TokenLengths when batched
    max_batch: int = 8
    prefill_mean: float = 0.0           # E[prefill seconds] per request
    prefill_var: float = 0.0
    new_mean: float = 1.0               # E[decode tokens] per request
    new_var: float = 0.0
    refused_clients: int = 0            # connects the balancer refused
    # admission control (fluid limit): per-slot admit fraction applied by
    # Poisson thinning (statistically exact for Poisson arrivals), and
    # the shed-rate timeline it implies.  None = fully open throughout.
    admit: Optional[np.ndarray] = None  # [T] admitted fraction
    shed_rate: Optional[np.ndarray] = None   # [T] shed QPS
    # actions the control pre-pass emitted: (t_applied, kind, params),
    # same shape as the event backends' ``control_log``
    control_actions: list = field(default_factory=list)
    unsupported: list = field(default_factory=list)

    @property
    def n_servers(self) -> int:
        return len(self.server_ids)


# ---------------------------------------------------------------------------
# Connection-assignment replay (scalar, once per point)
# ---------------------------------------------------------------------------
class _ReplayPolicy:
    """Replays the ``Balancer.assign`` criterion of the named policy
    over the scenario's connect/end/join/drain/fail timeline — a few
    dozen scalar steps per point, never per request."""

    def __init__(self, name: str):
        self.name = name
        self.rr = 0
        self.subscribed: dict[int, float] = {}       # sid -> offered QPS
        self.client_sub: dict[int, tuple] = {}       # cid -> (sid, qps)
        self.conn_count: dict[int, int] = {}         # sid -> live clients

    def assign(self, cid: int, qps: float, alive: list) -> Optional[int]:
        if not alive:
            return None
        if self.name == "load_aware":
            sid = min(alive, key=lambda s: self.subscribed.get(s, 0.0))
            self.subscribed[sid] = self.subscribed.get(sid, 0.0) + qps
            self.client_sub[cid] = (sid, qps)
        elif self.name == "least_connections":
            sid = min(alive, key=lambda s: self.conn_count.get(s, 0))
        else:                       # round_robin and the jsq/p2c stand-in
            sid = alive[self.rr % len(alive)]
            self.rr += 1
        self.conn_count[sid] = self.conn_count.get(sid, 0) + 1
        return sid

    def release(self, cid: int, sid: Optional[int]) -> None:
        sub = self.client_sub.pop(cid, None)
        if sub is not None:
            s, qps = sub
            self.subscribed[s] = max(0.0, self.subscribed.get(s, 0.0) - qps)
        if sid is not None and self.conn_count.get(sid, 0) > 0:
            self.conn_count[sid] -= 1


def compile_experiment(exp: Experiment, dt: float = 0.005) -> VectorProgram:
    if exp.legacy_mode:
        raise VectorCompileError("vector backend does not support "
                                 "legacy_mode (use the event engine)")
    n_slots = max(1, int(math.ceil(exp.duration / dt)))
    centers = (np.arange(n_slots) + 0.5) * dt

    # ---- server schedules --------------------------------------------------
    specs = list(exp.servers)
    server_ids = [s.server_id for s in specs]
    col = {sid: j for j, sid in enumerate(server_ids)}
    S = len(specs)
    workers = np.array([float(s.workers if s.workers else 1) for s in specs])
    speed = np.tile(np.array([float(s.speed) for s in specs]), (n_slots, 1))
    active = np.ones((n_slots, S))
    accepting = np.ones((n_slots, S))
    fail_slot = np.full(S, -1, dtype=np.int64)
    noise_sigma = np.array([float(s.service_noise) for s in specs])
    drain_slots: list[tuple] = []               # (slot, col) re-assert marks
    for j, s in enumerate(specs):
        if s.join_at > 0.0:
            k = min(int(s.join_at / dt), n_slots)
            active[:k, j] = 0.0
            accepting[:k, j] = 0.0
        if s.drain_at is not None:
            k = min(int(s.drain_at / dt), n_slots)
            accepting[k:, j] = 0.0
            drain_slots.append((k, j))
        if s.standby:
            # standby pool: no capacity and no routing until a scale
            # action activates the column
            active[:, j] = 0.0
            accepting[:, j] = 0.0

    unsupported = []
    policy_changes: list[tuple] = []            # (t, seq, policy-name)
    admission_changes: list[tuple] = []         # (t, seq, params)
    scale_changes: list[tuple] = []             # (t, seq, n)
    if exp.hedge_delay is not None:
        unsupported.append(Injection(0.0, "set_hedge",
                                     {"delay": exp.hedge_delay}))
    # retries and circuit breaking are per-request mechanisms with no
    # fluid analogue — surface them instead of silently ignoring
    if exp.retry is not None:
        unsupported.append(Injection(0.0, "set_retry",
                                     {"policy": exp.retry}))
    if exp.breaker is not None:
        unsupported.append(Injection(0.0, "set_breaker",
                                     {"spec": exp.breaker}))
    for inj in exp.injections:
        if inj.kind == "server_fail":
            j = col[inj.params["server_id"]]
            k = min(int(inj.at / dt), n_slots)
            active[k:, j] = 0.0
            accepting[k:, j] = 0.0
            fail_slot[j] = k if k < n_slots else -1
        elif inj.kind == "server_speed":
            j = col[inj.params["server_id"]]
            k = min(int(inj.at / dt), n_slots)
            speed[k:, j] *= float(inj.params["factor"])
        elif inj.kind == "server_drain":
            j = col[inj.params["server_id"]]
            k = min(int(inj.at / dt), n_slots)
            accepting[k:, j] = 0.0
            drain_slots.append((k, j))
        elif inj.kind == "set_policy":
            policy_changes.append((inj.at, inj.seq, inj.params["policy"]))
        elif inj.kind == "set_admission":
            admission_changes.append((inj.at, inj.seq, dict(inj.params)))
        elif inj.kind == "set_scale":
            scale_changes.append((inj.at, inj.seq, int(inj.params["n"])))
        else:           # set_hedge/set_retry/set_breaker, injected joins
            unsupported.append(inj)
    policy_changes.sort(key=lambda c: (c[0], c[1]))

    # ---- per-client offered rates ------------------------------------------
    # rate[c, t], plus each client's connect time and effective end
    clients = list(exp.clients)
    rates = np.zeros((len(clients), n_slots))
    ends = np.full(len(clients), exp.duration)
    for i, c in enumerate(clients):
        r = _schedule_rates(c.schedule, centers)
        end = min(c.end_time, exp.duration) if c.end_time is not None \
            else exp.duration
        masked = np.where((centers >= c.start_time) & (centers < end),
                          r, 0.0)
        if c.total_requests is not None:
            # fluid budget stop: zero the rate once the expected arrival
            # count crosses the client's request budget
            end = min(end, _budget_stop(masked, dt, c.total_requests))
            masked = np.where(centers < end, masked, 0.0)
        rates[i] = masked
        ends[i] = end

    # ---- closed-loop control: fluid pre-pass -------------------------------
    # Replays the controller against the fluid backlog model (offered
    # rate vs capacity), emitting the same set_admission/set_scale
    # actions the event backends would apply — lag and cooldown
    # included.  Latency percentiles have no cheap fluid analogue, so
    # the observation's p99/slo_frac are NaN; the shipped policies act
    # on utilization and queue depth, which the model does carry.
    control_actions: list = []
    if exp.control is not None:
        if getattr(exp.resolved_service(), "kind", "scalar") == "batched":
            unsupported.append(Injection(0.0, "control",
                                         {"spec": exp.control}))
        else:
            m0 = exp.resolved_profile().moments()[0]
            w_mean = m0 * np.exp(noise_sigma ** 2 / 2.0)
            adm_c, scale_c = _control_prepass(
                exp.control, rates.sum(axis=0), active, accepting, speed,
                workers, w_mean, specs, server_ids, fail_slot, drain_slots,
                admission_changes, scale_changes, dt, n_slots)
            admission_changes = admission_changes + adm_c
            scale_changes = scale_changes + scale_c
            control_actions = sorted(
                [(t, "set_admission", dict(p)) for t, _, p in adm_c]
                + [(t, "set_scale", {"n": n}) for t, _, n in scale_c],
                key=lambda a: a[0])

    # ---- scale timeline ----------------------------------------------------
    # apply chronologically so a scale-out cannot clobber a later drain
    # (each action re-asserts failures and still-future drain marks)
    scale_changes.sort(key=lambda c: (c[0], c[1]))
    for at, _seq, n in scale_changes:
        k = min(int(at / dt), n_slots)
        _apply_scale_action(active, accepting, k, n, specs, server_ids,
                            fail_slot, drain_slots, at)

    # ---- assignment replay -------------------------------------------------
    # chronological events; ties follow the simulator's scheduling order
    # (connects first, then joins/drains, then injections — and
    # same-kind injections at identical timestamps interleave in
    # declaration order via the compiled (at, seq) stamp)
    events: list[tuple] = []
    for i, c in enumerate(clients):
        events.append((c.start_time, 0, i, "connect", i))
        events.append((ends[i], 3, i, "end", i))
    for j, s in enumerate(specs):
        if s.join_at > 0.0:
            events.append((s.join_at, 1, j, "join", j))
        if s.drain_at is not None:
            events.append((s.drain_at, 1, j, "drain", j))
    for inj in exp.injections:
        if inj.kind == "server_fail":
            events.append((inj.at, 2, inj.seq, "fail",
                           col[inj.params["server_id"]]))
    for at, seq, pol in policy_changes:
        events.append((at, 2, seq, "policy", pol))
    for at, seq, n in scale_changes:
        events.append((at, 2, seq, "scale", n))
    events.sort(key=lambda e: (e[0], e[1], e[2]))

    if isinstance(exp.policy, str):
        policy = exp.policy
    else:                       # balancer instance: map back to its name
        policy = {"RoundRobin": "round_robin", "LoadAware": "load_aware",
                  "LeastConnections": "least_connections",
                  "JoinShortestQueue": "jsq", "PowerOfTwo": "p2c",
                  }.get(type(exp.policy).__name__, "round_robin")
    replay = _ReplayPolicy(policy)
    free_mode = policy in FREE_POLICIES

    rate_conn = np.zeros((n_slots, S))
    rate_free = np.zeros(n_slots)
    assignment: dict[int, int] = {}            # client idx -> server col
    seg_start: dict[int, float] = {}           # client idx -> segment start
    alive_cols: list[int] = [j for j, s in enumerate(specs)
                             if s.join_at == 0.0 and not s.standby]
    drained: set[int] = set()
    failed_cols: set[int] = set()
    refused = 0

    def slot_range(t0: float, t1: float) -> slice:
        a = np.searchsorted(centers, t0)
        b = np.searchsorted(centers, min(t1, exp.duration))
        return slice(int(a), int(b))

    def close_segment(i: int, t: float) -> None:
        t0 = seg_start.pop(i, None)
        if t0 is None:
            return
        sl = slot_range(t0, t)
        if free_mode or i not in assignment:
            rate_free[sl] += rates[i, sl]
        else:
            rate_conn[sl, assignment[i]] += rates[i, sl]

    def _rehome(i: int, t: float) -> None:
        """Close the client's segment and reassign it through the
        policy (the fallback keeps it pumping as request-routed)."""
        close_segment(i, t)
        replay.release(i, assignment.pop(i, None))
        c = clients[i]
        sid = replay.assign(i, c.schedule.rate(t), alive_cols)
        seg_start[i] = t
        if sid is not None:
            assignment[i] = sid

    live: set[int] = set()
    for t, _, _, kind, arg in events:
        if kind == "connect":
            i = arg
            c = clients[i]
            qps = c.schedule.rate(c.start_time)
            sid = replay.assign(i, qps, alive_cols)
            if sid is None:
                refused += 1
                continue
            assignment[i] = sid
            seg_start[i] = t
            live.add(i)
        elif kind == "end":
            i = arg
            if i not in live:
                continue
            close_segment(i, t)
            replay.release(i, assignment.pop(i, None))
            live.discard(i)
        elif kind == "join":
            j = arg
            if j not in alive_cols and j not in drained:
                alive_cols.append(j)
        elif kind == "drain":
            j = arg
            drained.add(j)
            if j in alive_cols:
                alive_cols.remove(j)
            # existing clients keep their assignment (sim semantics)
        elif kind == "fail":
            j = arg
            drained.add(j)
            failed_cols.add(j)
            if j in alive_cols:
                alive_cols.remove(j)
            # clients on the failed server re-home through the policy; a
            # client no accepting server will take keeps pumping as
            # request-routed (water-filled) traffic, like the sim's
            # per-request choose() fallback
            for i in sorted(i for i, s in assignment.items() if s == j):
                _rehome(i, t)
        elif kind == "scale":
            # mirror Simulator.scale_to: the first n existing, non-failed
            # servers (in server-id order) serve; the rest drain and hand
            # their clients back through the policy
            pool = [j for j in range(S)
                    if j not in failed_cols
                    and (specs[j].standby or specs[j].join_at <= t)]
            pool.sort(key=lambda j: server_ids[j])
            target = set(pool[:arg])
            for j in pool:
                if j in target and j not in alive_cols:
                    alive_cols.append(j)
                    drained.discard(j)
                elif j not in target and j in alive_cols:
                    alive_cols.remove(j)
                    drained.add(j)
                    for i in sorted(i for i, s_ in assignment.items()
                                    if s_ == j):
                        _rehome(i, t)
        elif kind == "policy":
            new_free = arg in FREE_POLICIES
            if new_free != free_mode:
                for i in list(live):
                    close_segment(i, t)
                    seg_start[i] = t
            free_mode = new_free
            replay.name = arg
    for i in list(live):
        close_segment(i, exp.duration)

    # ---- admission control: Poisson thinning -------------------------------
    # An admitted fraction f applied to a Poisson arrival stream IS a
    # Poisson stream at f*rate (thinning) — statistically exact for the
    # probabilistic controller; a token bucket's fluid limit is the rate
    # cap min(offered, R), i.e. f = min(1, R/offered) per slot.
    admit_arr = None
    shed_rate = None
    if admission_changes:
        offered_total = rate_conn.sum(axis=1) + rate_free
        admit_arr = np.ones(n_slots)
        for at, _seq, p in sorted(admission_changes,
                                  key=lambda c: (c[0], c[1])):
            k = min(int(at / dt), n_slots)
            a, r = p.get("admit"), p.get("rate")
            if r is not None:
                seg = offered_total[k:]
                admit_arr[k:] = np.where(seg > 0.0,
                                         np.minimum(1.0, r
                                                    / np.maximum(seg, 1e-300)),
                                         1.0)
            elif a is None or a >= 1.0:
                admit_arr[k:] = 1.0
            else:
                admit_arr[k:] = max(float(a), 0.0)
        if np.all(admit_arr >= 1.0 - 1e-12):
            admit_arr = None
        else:
            shed_rate = offered_total * (1.0 - admit_arr)
            rate_conn = rate_conn * admit_arr[:, None]
            rate_free = rate_free * admit_arr

    # ---- service laws ------------------------------------------------------
    service = exp.resolved_service()
    batched = getattr(service, "kind", "scalar") == "batched"
    prog = VectorProgram(
        dt=dt, n_slots=n_slots, duration=exp.duration,
        interval=exp.interval, slo=exp.slo, server_ids=server_ids,
        workers=workers, speed=speed, active=active, accepting=accepting,
        fail_slot=fail_slot, rate_conn=rate_conn, rate_free=rate_free,
        work_mean=np.ones(S), work_var=np.zeros(S),
        noise_sigma=noise_sigma, refused_clients=refused,
        admit=admit_arr, shed_rate=shed_rate,
        control_actions=control_actions, unsupported=unsupported)
    if batched:
        lengths = exp.resolved_lengths() or TokenLengths()
        (pm, pv), (nm, nv) = lengths.moments()
        # prefill seconds = max(tp * prompt, t_memory): moments over the
        # integer prompt pmf, floored at the weight-pass time
        pf_m, pf_v = _prefill_moments(service, lengths)
        prog.batched = True
        prog.service = service
        prog.lengths = lengths
        prog.max_batch = int(specs[0].max_batch or 8)
        prog.workers = np.array([float(s.max_batch or 8) for s in specs])
        prog.prefill_mean, prog.prefill_var = pf_m, pf_v
        prog.new_mean, prog.new_var = nm, nv
    else:
        profile = exp.resolved_profile()
        m, v = profile.moments()
        e2 = v + m * m
        # execution noise is multiplicative log-normal per server: fold
        # its moments into the per-server work law
        nf1 = np.exp(noise_sigma ** 2 / 2.0)
        nf2 = np.exp(2.0 * noise_sigma ** 2)
        prog.work_mean = m * nf1
        prog.work_var = np.maximum(e2 * nf2 - prog.work_mean ** 2, 0.0)
        prog.profile = profile
    return prog


def _apply_scale_action(active: np.ndarray, accepting: np.ndarray, k: int,
                        n: int, specs, server_ids, fail_slot: np.ndarray,
                        drain_slots, t: float) -> None:
    """Write one ``set_scale`` action into the capacity schedules at slot
    ``k``: the first ``n`` existing, non-failed servers (server-id order)
    serve from here; the rest stop accepting (their residual backlog
    still drains, matching ``server_drain`` semantics).  Failures and
    still-future drain marks are re-asserted so a scale-out cannot
    resurrect a dead server or erase a scheduled drain."""
    n_slots = active.shape[0]
    pool = [j for j in range(len(specs))
            if not (fail_slot[j] != -1 and fail_slot[j] <= k)
            and (specs[j].standby or specs[j].join_at <= t)]
    pool.sort(key=lambda j: server_ids[j])
    for j in pool[:n]:
        active[k:, j] = 1.0
        accepting[k:, j] = 1.0
    for j in pool[n:]:
        accepting[k:, j] = 0.0
    for j in range(len(specs)):
        fs = fail_slot[j]
        if fs != -1 and fs < n_slots:
            active[fs:, j] = 0.0
            accepting[fs:, j] = 0.0
    for kd, j in drain_slots:
        if kd >= k:
            accepting[kd:, j] = 0.0


def _control_prepass(spec, offered: np.ndarray, active: np.ndarray,
                     accepting: np.ndarray, speed: np.ndarray,
                     workers: np.ndarray, w_mean: np.ndarray, specs,
                     server_ids, fail_slot: np.ndarray, drain_slots,
                     inj_admissions, inj_scales, dt: float,
                     n_slots: int) -> tuple[list, list]:
    """Replay the controller against the fluid backlog model.

    Steps the total offered rate against fleet capacity slot by slot,
    maintaining a global backlog ``U`` (work-seconds); at each control
    interval it builds an ``Observation`` (util, queue depth, served
    count — p99/slo_frac are NaN in the fluid world) and lets the policy
    act, honoring cooldown and actuation lag.  Injected admission/scale
    timelines are applied inside the stepping so the controller sees
    their effects.  Returns the controller-emitted ``(t, seq, params)``
    admission changes and ``(t, seq, n)`` scale changes; control seqs
    start at 10**6, ordering them after compiled injections at identical
    timestamps (the event backends schedule lagged actions the same way).
    """
    import heapq as _heapq
    import itertools as _it

    from repro_torch.control import ControlLoop
    from repro_torch.control.policy import Observation

    loop = ControlLoop(spec)
    act2 = active.copy()
    acc2 = accepting.copy()
    ctrl_seq = _it.count(10 ** 6)
    pending: list = []                 # (slot, seq, kind, payload)
    for at, seq, p in inj_admissions:
        _heapq.heappush(pending, (min(int(at / dt), n_slots), seq,
                                  "set_admission", dict(p)))
    for at, seq, n in inj_scales:
        _heapq.heappush(pending, (min(int(at / dt), n_slots), seq,
                                  "set_scale", (n, at)))
    out_adm: list = []
    out_scale: list = []
    admit_p: Optional[float] = None    # probabilistic admit fraction
    rate_cap: Optional[float] = None   # token-bucket rate cap
    fleet_w = float(w_mean.mean()) if len(w_mean) else 1.0
    U = 0.0                            # backlog, work-seconds
    served_win = 0.0                   # served requests since last tick
    next_tick = spec.interval
    cap_w = workers * speed / np.maximum(w_mean, 1e-12)   # [T, S] req/s
    for k in range(n_slots):
        while pending and pending[0][0] <= k:
            _, _, kind, payload = _heapq.heappop(pending)
            if kind == "set_admission":
                a, r = payload.get("admit"), payload.get("rate")
                if r is not None:
                    admit_p, rate_cap = None, float(r)
                elif a is None or a >= 1.0:
                    admit_p, rate_cap = None, None
                else:
                    admit_p, rate_cap = max(float(a), 0.0), None
            else:
                n, at = payload
                _apply_scale_action(act2, acc2, k, n, specs, server_ids,
                                    fail_slot, drain_slots, at)
        off = float(offered[k])
        if rate_cap is not None:
            f = min(1.0, rate_cap / off) if off > 0.0 else 1.0
        elif admit_p is not None:
            f = admit_p
        else:
            f = 1.0
        lam = off * f
        cap = float((acc2[k] * cap_w[k]).sum())
        serve = min(cap, lam + U / dt)
        U = max(U + (lam - serve) * dt, 0.0)
        served_win += serve * dt
        t_end = (k + 1) * dt
        while next_tick <= t_end + 1e-12:
            nact = int(np.count_nonzero(acc2[min(k, n_slots - 1)]))
            util = 1.0 if U > 1e-9 else (min(lam / cap, 1.0)
                                         if cap > 0.0 else 1.0)
            obs = Observation(t=next_tick, n=int(round(served_win)),
                              qps=served_win / spec.interval,
                              p99=float("nan"), mean=float("nan"),
                              util=util, qdepth=U / max(fleet_w, 1e-12),
                              slo_frac=float("nan"), n_active=max(nact, 1),
                              admit=f)
            served_win = 0.0
            for kind, params in loop.tick(obs, next_tick):
                due = next_tick + spec.lag
                seq = next(ctrl_seq)
                k_due = min(int(due / dt), n_slots)
                if kind == "set_admission":
                    out_adm.append((due, seq, dict(params)))
                    _heapq.heappush(pending, (k_due, seq, "set_admission",
                                              dict(params)))
                elif kind == "set_scale":
                    n = int(params["n"])
                    out_scale.append((due, seq, n))
                    _heapq.heappush(pending, (k_due, seq, "set_scale",
                                              (n, due)))
            next_tick += spec.interval
    return out_adm, out_scale


def _budget_stop(rate: np.ndarray, dt: float, budget: int) -> float:
    """Absolute stop time of a budgeted client (expected-count crossing)."""
    cum = np.cumsum(rate) * dt
    idx = int(np.searchsorted(cum, float(budget)))
    if idx >= len(rate):
        return math.inf
    return (idx + 1) * dt


def _prefill_moments(service, lengths) -> tuple[float, float]:
    """Exact moments of ``prefill_time(prompt)`` over the clipped
    integer prompt law (shared pmf: ``TokenLengths.int_pmf``)."""
    ks, pmf = TokenLengths.int_pmf(lengths.prompt_median,
                                   lengths.prompt_sigma,
                                   lengths.prompt_max)
    pf = np.maximum(service.t_prefill_per_token * ks, service.t_memory)
    m = float(pmf @ pf)
    return m, max(float(pmf @ (pf * pf)) - m * m, 0.0)


def _profile_from_fields(d: Optional[dict]):
    if d is None:
        return None
    if "value" in d:
        return FixedProfile(**d)
    return LogNormalProfile(**d)


#: injection kind -> (params key, dataclass) of the specs an
#: ``unsupported`` record carries
_SPEC_PARAMS = {"set_retry": ("policy", RetryPolicy),
                "set_breaker": ("spec", BreakerSpec),
                "control": ("spec", ControlSpec)}


def _injection_from_fields(d: dict) -> Injection:
    d = dict(d)
    params = dict(d["params"])
    key, cls = _SPEC_PARAMS.get(d["kind"], (None, None))
    if isinstance(params.get(key), dict):
        spec = dict(params[key])
        if cls is ControlSpec:
            spec["params"] = tuple(tuple(p) for p in spec["params"])
        params[key] = cls(**spec)
    d["params"] = params
    return Injection(**d)


def program_from_numpy(fields: dict) -> VectorProgram:
    """Build a ``VectorProgram`` from another program's fields given as
    plain numbers, lists and NumPy arrays: ``profile``, ``service`` and
    ``lengths`` as dicts of their dataclass fields, ``unsupported`` as
    dicts of ``Injection`` fields (a ``RetryPolicy``, ``BreakerSpec`` or
    ``ControlSpec`` in their params as a dict of its fields),
    ``control_actions`` as ``(t, kind, params)`` tuples.  This carries a
    program compiled elsewhere (for example by the JAX package) into
    this runtime.  Fields this program does not have must be empty."""
    names = {f.name for f in dataclasses.fields(VectorProgram)}
    extra = {k: v for k, v in fields.items() if k not in names}
    if any(v for v in extra.values()):
        raise VectorCompileError(
            f"program fields not ported yet: {sorted(extra)}")
    kw = {k: v for k, v in fields.items() if k in names}
    kw["profile"] = _profile_from_fields(kw.get("profile"))
    if kw.get("service") is not None:
        kw["service"] = BatchedService(**{k: v for k, v in
                                          kw["service"].items()
                                          if k != "kind"})
    if kw.get("lengths") is not None:
        kw["lengths"] = TokenLengths(**kw["lengths"])
    kw["unsupported"] = [_injection_from_fields(d)
                         for d in kw.get("unsupported", ())]
    kw["control_actions"] = [(t, kind, dict(params)) for t, kind, params
                             in kw.get("control_actions", ())]
    kw["server_ids"] = list(kw["server_ids"])
    return VectorProgram(**kw)
