"""The port's control plane (``repro_torch.control``) against the JAX
package's (``repro.control``) on the same seeded inputs.

Both are NumPy only, so every decision must be equal and every random
draw must come from the same place in the same ``np.random.Generator``
stream: after each sequence the two generators' states are compared as
well as the outputs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.control as jctl  # noqa: E402
from repro.control import loop as jloop  # noqa: E402
from repro.control import resilience as jres  # noqa: E402
from repro.core import request as jreq  # noqa: E402
from repro.core import stats as jstats  # noqa: E402

import repro_torch.control as tctl  # noqa: E402
from repro_torch.control import loop as tloop  # noqa: E402
from repro_torch.control import resilience as tres  # noqa: E402
from repro_torch.core import request as treq  # noqa: E402
from repro_torch.core import stats as tstats  # noqa: E402


def _obs_fields(rng, admit=None) -> dict:
    """One seeded observation: util, queue depth and latencies over
    their ranges, NaN now and then (the fluid pre-pass's p99)."""
    nan = float("nan")
    return dict(
        t=float(rng.uniform(0, 60)), n=int(rng.integers(0, 5000)),
        qps=float(rng.uniform(0, 4000)),
        p99=nan if rng.random() < 0.2 else float(rng.uniform(0, 0.5)),
        mean=float(rng.uniform(0, 0.1)), util=float(rng.uniform(0, 1)),
        qdepth=nan if rng.random() < 0.1 else float(rng.uniform(0, 80)),
        slo_frac=nan if rng.random() < 0.2 else float(rng.uniform(0, 1)),
        n_active=int(rng.integers(0, 8)),
        admit=float(rng.uniform(0, 1)) if admit is None else admit)


def _obs_pair(fields):
    return jctl.Observation(**fields), tctl.Observation(**fields)


def _same_state(a: np.random.Generator, b: np.random.Generator) -> bool:
    return a.bit_generator.state == b.bit_generator.state


# ---------------------------------------------------------------------------
# Policies and specs
# ---------------------------------------------------------------------------
SPECS = [
    ("threshold_autoscaler", dict(interval=2.0, lag=1.0, cooldown=3.0,
                                  high=0.9, low=0.3)),
    ("threshold_autoscaler", dict(interval=1.0, lag=2.0, cooldown=4.0,
                                  high=0.85, low=0.35, metric="util",
                                  min_servers=2, max_servers=6)),
    ("admission_shedder", dict(interval=1.0, lag=2.0, cooldown=4.0,
                               target_qdepth=8.0)),
    ("admission_shedder", dict(target_qdepth=4.0, decrease=0.5,
                               increase=0.2, floor=0.1)),
]


@pytest.mark.parametrize("name,kw", SPECS)
def test_control_spec_equal_to_reference(name, kw):
    a = jctl.ControlSpec.make(name, **kw)
    b = tctl.ControlSpec.make(name, **kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert hash(a) == hash(b)
    pa, pb = a.build(), b.build()
    assert type(pa).__name__ == type(pb).__name__
    assert vars(pa) == vars(pb)
    assert sorted(jctl.CONTROLLERS) == sorted(tctl.CONTROLLERS)
    for mod in (jctl, tctl):
        with pytest.raises(ValueError, match="unknown controller"):
            mod.ControlSpec.make("no-such-controller")


AUTOSCALERS = [dict(high=0.8, low=0.3, min_servers=1, max_servers=4),
               dict(high=0.85, low=0.35, metric="util", min_servers=2,
                    max_servers=6),
               dict(high=0.1, low=0.0, metric="p99"),
               dict(high=20.0, low=2.0, metric="qdepth", step=2),
               dict(high=0.05, low=0.01, metric="slo_frac")]


@pytest.mark.parametrize("kw", AUTOSCALERS)
def test_threshold_autoscaler_equal_to_reference(kw):
    """Thresholds, the pool bounds and the NaN no-op, over 400 seeded
    observations."""
    a = jctl.ThresholdAutoscaler(**kw)
    b = tctl.ThresholdAutoscaler(**kw)
    rng = np.random.default_rng(11)
    acted = 0
    for _ in range(400):
        oa, ob = _obs_pair(_obs_fields(rng))
        got, want = b.update(ob), a.update(oa)
        assert got == want
        acted += bool(want)
    assert acted > 0


@pytest.mark.parametrize("kw", [
    dict(target_qdepth=4.0, decrease=0.5, increase=0.2, floor=0.1),
    dict(target_qdepth=8.0),
    dict(target_qdepth=1.0, decrease=0.9, increase=0.05, floor=0.3)])
def test_admission_shedder_aimd_equal_to_reference(kw):
    """AIMD over a closed loop: each policy's admit level feeds its own
    next observation, so any drift would compound."""
    a = jctl.AdmissionShedder(**kw)
    b = tctl.AdmissionShedder(**kw)
    rng = np.random.default_rng(5)
    admit_a = admit_b = 1.0
    levels = set()
    for _ in range(300):
        fields = _obs_fields(rng)
        oa = jctl.Observation(**dict(fields, admit=admit_a))
        ob = tctl.Observation(**dict(fields, admit=admit_b))
        want, got = a.update(oa), b.update(ob)
        assert got == want
        for _, params in want:
            admit_a = params["admit"]
        for _, params in got:
            admit_b = params["admit"]
        levels.add(admit_a)
    assert len(levels) > 3


@pytest.mark.parametrize("name,kw", SPECS)
def test_control_loop_cooldown_equal_to_reference(name, kw):
    spec = jctl.ControlSpec.make(name, **kw)
    la = jloop.ControlLoop(spec)
    lb = tloop.ControlLoop(tctl.ControlSpec.make(name, **kw))
    bare = spec.build()                 # the policy without the loop
    rng = np.random.default_rng(17)
    t, fired, suppressed = 0.0, 0, 0
    for _ in range(200):
        t += float(rng.uniform(0.2, 2.0))
        fields = _obs_fields(rng, admit=1.0)
        oa, ob = _obs_pair(fields)
        raw = bare.update(jctl.Observation(**fields))
        want, got = la.tick(oa, t), lb.tick(ob, t)
        assert got == want
        fired += bool(want)
        suppressed += bool(raw) and not want
    assert fired > 0
    assert (suppressed > 0) == (spec.cooldown > 0)


# ---------------------------------------------------------------------------
# Resilience primitives
# ---------------------------------------------------------------------------
RETRIES = [dict(backoff_base=0.1, backoff_cap=1.0, jitter="none"),
           dict(backoff_base=0.1, backoff_cap=1.0, jitter="full"),
           dict(backoff_base=0.05, backoff_cap=2.0, jitter="decorrelated"),
           dict(timeout=0.25, max_retries=3, backoff_base=0.0,
                backoff_cap=0.0, jitter="none", budget_ratio=1.0,
                budget_burst=10 ** 9),
           dict(timeout=0.25, max_retries=3, backoff_base=0.05,
                backoff_cap=1.0, jitter="decorrelated", budget_ratio=0.1,
                budget_burst=20),
           dict(timeout=0.3, max_retries=1, backoff_base=0.02,
                backoff_cap=0.2, jitter="full", budget_ratio=0.2,
                budget_burst=10)]


@pytest.mark.parametrize("kw", RETRIES)
def test_retry_delay_draws_equal_to_reference(kw):
    """Delays, their bounds, and the generator consumed draw for draw."""
    pa, pb = jres.RetryPolicy(**kw), tres.RetryPolicy(**kw)
    assert dataclasses.asdict(pa) == dataclasses.asdict(pb)
    ra, rb = np.random.default_rng(0), np.random.default_rng(0)
    prev_a = prev_b = 0.0
    for i in range(200):
        attempt = 1 + i % 6
        da = pa.delay(attempt, prev_a, ra)
        db = pb.delay(attempt, prev_b, rb)
        assert db == da
        assert 0.0 <= db <= pb.backoff_cap
        if pb.jitter == "decorrelated":
            assert db >= min(pb.backoff_base, pb.backoff_cap)
        prev_a, prev_b = da, db
        assert _same_state(ra, rb)


@pytest.mark.parametrize("bad", [dict(jitter="bogus"), dict(timeout=0.0)])
def test_retry_policy_validation_equal_to_reference(bad):
    for mod in (jres, tres):
        with pytest.raises(ValueError):
            mod.RetryPolicy(**bad)


@pytest.mark.parametrize("ratio,burst", [(0.1, 2), (1.0, 10 ** 9),
                                         (0.2, 10)])
def test_retry_budget_equal_to_reference(ratio, burst):
    a, b = jres.RetryBudget(ratio, burst), tres.RetryBudget(ratio, burst)
    rng = np.random.default_rng(3)
    for _ in range(2000):
        if rng.random() < 0.7:
            a.note_primary()
            b.note_primary()
        ok = a.allow()
        assert b.allow() == ok
        if ok and rng.random() < 0.8:
            a.note_retry()
            b.note_retry()
    assert (b.primaries, b.retries) == (a.primaries, a.retries)


@pytest.mark.parametrize("kw", [dict(admit=0.5), dict(admit=0.0),
                                dict(admit=1.0), dict(rate=10.0, burst=1.0),
                                dict(rate=20.0, burst=5.0),
                                dict(admit=0.6, rate=50.0, burst=3.0)])
def test_admission_controller_equal_to_reference(kw):
    """The token bucket (RNG-free) and the probabilistic draws, with
    the generator consumed alike."""
    a, b = jres.AdmissionController(**kw), tres.AdmissionController(**kw)
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    outs = []
    for t in range(3000):
        o = a.allow(t * 0.01, ra)
        assert b.allow(t * 0.01, rb) == o
        outs.append(o)
    assert _same_state(ra, rb)
    assert b.level == a.level
    if kw.get("admit") == 0.5:
        assert 0.4 < np.mean(outs) < 0.6
    for mod in (jres, tres):
        with pytest.raises(ValueError):
            mod.AdmissionController()


@pytest.mark.parametrize("spec", [
    dict(window=10, threshold=0.5, cooldown=2.0, min_samples=4),
    dict(window=20, threshold=0.5, cooldown=3.0, min_samples=5),
    dict()])
def test_circuit_breaker_state_machine_equal_to_reference(spec):
    """Closed -> open -> half-open probe -> closed or re-opened, per
    server, over a seeded stream of outcomes and admission checks."""
    a = jres.CircuitBreaker(jres.BreakerSpec(**spec))
    b = tres.CircuitBreaker(tres.BreakerSpec(**spec))
    rng = np.random.default_rng(23)
    t, seen = 0.0, set()
    for _ in range(3000):
        t += float(rng.uniform(0.0, 0.2))
        sid = int(rng.integers(0, 3))
        if rng.random() < 0.5:
            ok = bool(rng.random() < (0.2 if sid == 2 else 0.9))
            a.record(sid, ok, t)
            b.record(sid, ok, t)
        else:
            assert b.allow(sid, t) == a.allow(sid, t)
        assert b.state(sid) == a.state(sid)
        seen.add(a.state(sid))
    assert seen == {"closed", "open", "half_open"}
    assert tres.RESILIENCE_STREAM == jres.RESILIENCE_STREAM == 0xB0FF


# ---------------------------------------------------------------------------
# observe_runtime over both recorders
# ---------------------------------------------------------------------------
class _Srv:
    def __init__(self, busy, load, workers=None, max_batch=None):
        self.busy, self._load = busy, load
        self.workers, self.max_batch = workers, max_batch

    def load(self):
        return self._load


@pytest.mark.parametrize("mode", ["exact", "streaming"])
def test_observe_runtime_equal_to_reference(mode):
    """Windowed observations from each package's recorder, fed the same
    requests and failures, through each package's ``observe_runtime``."""
    rec_a = jstats.LatencyRecorder(1.0, mode=mode, seed=4, rep=1)
    rec_b = tstats.LatencyRecorder(1.0, mode=mode, seed=4, rep=1)
    servers = [_Srv(2, 5, workers=2), _Srv(1, 1, workers=4),
               _Srv(3, 9, max_batch=8), _Srv(0, 0)]
    prev_a, prev_b = {}, {}
    rng = np.random.default_rng(9)
    rid = 0
    for tick in range(1, 9):
        for _ in range(int(rng.integers(0, 300))):
            created = tick - 1 + float(rng.random())
            lat = float(rng.lognormal(-4.0, 1.0))
            for mod, rec in ((jreq, rec_a), (treq, rec_b)):
                r = mod.Request(rid, rid % 3, created, 0.0)
                r.enqueued = created
                r.started = created + lat / 3
                r.completed = created + lat
                rec.record(r)
            rid += 1
        for _ in range(int(rng.integers(0, 20))):
            t_fail = tick - 1 + float(rng.random())
            disp = ("shed", "timeout", "failed")[int(rng.integers(0, 3))]
            rec_a.record_failure(t_fail, disp)
            rec_b.record_failure(t_fail, disp)
        for slo in (0.05, None):
            pa, pb = dict(prev_a), dict(prev_b)
            oa = jloop.observe_runtime(rec_a, servers, float(tick), slo,
                                       0.8, pa)
            ob = tloop.observe_runtime(rec_b, servers, float(tick), slo,
                                       0.8, pb)
            da, db = dataclasses.asdict(oa), dataclasses.asdict(ob)
            assert da.keys() == db.keys()
            for k in da:
                assert (db[k] == da[k]
                        or (math.isnan(da[k]) and math.isnan(db[k]))), k
            assert pa == pb
        prev_a, prev_b = pa, pb
