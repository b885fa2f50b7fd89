"""The port's event simulator (the ``sim`` backend) against the JAX
package's, on the host.

* ``CalendarQueue``: the same pops, in the exact ``(t, seq)`` order,
  through ties, growth and events past the horizon.
* ``sim`` rows: every registered scenario (the seven canonical and the
  four chaos ones, with retry-storm's two modes, gray-failure with and
  without its breaker, flash-crowd-autoscale under both controllers)
  gives the reference's rows bit for bit: every recorded latency, every
  interval frame, the dispositions and the control log.
* The recorder's streaming mode, the legacy TailBench baseline and its
  TailBench++ equivalent, the opt-in bulk client generator and the
  batched servers, the same way.
* Welch's t-test and ``confidence95`` on known values.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import scenarios as jsc  # noqa: E402
from repro.core import events as jevents  # noqa: E402
from repro.core import harness as jharness  # noqa: E402
from repro.core import legacy as jlegacy  # noqa: E402
from repro.core import stats as jstats  # noqa: E402
from repro.core.runtime import run_scenario as jrun  # noqa: E402

from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.core import events as tevents  # noqa: E402
from repro_torch.core import harness as tharness  # noqa: E402
from repro_torch.core import legacy as tlegacy  # noqa: E402
from repro_torch.core import stats as tstats  # noqa: E402
from repro_torch.core.client import ClientConfig, ConstantQPS  # noqa: E402
from repro_torch.core.runtime import run_scenario as trun  # noqa: E402


# ---------------------------------------------------------------------------
# Calendar queue
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,horizon,n_buckets", [
    (0, 10.0, 256), (1, 1.0, 4), (2, 100.0, 16), (3, 5.0, 1)])
def test_calendar_queue_pops_equal_to_reference(seed, horizon, n_buckets):
    """Pushes at few distinct timestamps (many ties), some past the
    horizon, interleaved with pops (pushes behind the active bucket
    included), enough to grow a small bucket array."""
    a = jevents.CalendarQueue(horizon, n_buckets)
    b = tevents.CalendarQueue(horizon, n_buckets)
    rng = np.random.default_rng(seed)
    stamps = rng.uniform(0.0, horizon * 1.2, 40)
    seq, now, got, want = 0, 0.0, [], []
    for _ in range(6000):
        if rng.random() < 0.6:
            t = max(now, float(rng.choice(stamps)))
            if rng.random() < 0.3:
                t = now                      # a tie with the last pop
            item = (t, seq, int(rng.integers(0, 9)))
            seq += 1
            a.push(item)
            b.push(item)
        else:
            x, y = a.pop(), b.pop()
            want.append(x)
            got.append(y)
            if x is not None:
                now = x[0]
        assert len(a) == len(b)
    while len(a):
        want.append(a.pop())
        got.append(b.pop())
    assert b.pop() is None
    assert got == want
    popped = [x for x in want if x is not None]
    assert popped == sorted(popped, key=lambda e: (e[0], e[1]))
    assert b._nb == a._nb
    if n_buckets <= 16:                      # grown at least once
        assert b._nb > n_buckets


# ---------------------------------------------------------------------------
# sim rows, bit for bit
# ---------------------------------------------------------------------------
def _plain(x):
    """Frames as plain values; NaN as a string so that it compares."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _frames(rt) -> list:
    return [_plain(dataclasses.asdict(f)) for f in rt.telemetry.frames()]


def _assert_sim_equal(port, ref):
    assert port.recorder.all == ref.recorder.all
    assert _frames(port) == _frames(ref)
    for m in ("dropped", "shed", "timeouts", "retries"):
        assert getattr(port, m) == getattr(ref, m), m
    assert port.control_log == ref.control_log
    assert port.sim.events == ref.sim.events


CANONICAL = ["steady", "flash-crowd", "diurnal-fleet", "server-failure",
             "elastic-autoscale", "batched-serving", "churn-storm"]
CHAOS = [("retry-storm", {}), ("retry-storm", dict(mode="backoff")),
         ("correlated-failure", {}), ("gray-failure", {}),
         ("gray-failure", dict(breaker=True)),
         ("flash-crowd-autoscale", {}),
         ("flash-crowd-autoscale", dict(controller="admission_shedder",
                                        peak_qps=4000.0))]
CASES = [(n, {}) for n in CANONICAL] + CHAOS


def test_every_registered_scenario_is_covered():
    assert sorted({n for n, _ in CASES}) == tsc.names() == jsc.names()


@pytest.mark.parametrize("name,kw", CASES)
def test_sim_rows_bit_identical_to_reference(name, kw):
    port = trun(tsc.get(name, seed=3, **kw), "sim")
    ref = jrun(jsc.get(name, seed=3, **kw), "sim")
    _assert_sim_equal(port, ref)
    assert len(port.recorder.all) > 1000


def test_retry_storm_naive_counts():
    """The naive storm at full length: served, retries and timeouts."""
    rt = trun(tsc.get("retry-storm", seed=3), "sim")
    assert (len(rt.recorder.all), rt.retries, rt.timeouts) == \
        (16480, 116736, 38185)


@pytest.mark.parametrize("name,kw,rep", [
    ("server-failure", {}, 1), ("gray-failure", dict(breaker=True), 2),
    ("flash-crowd-autoscale", {}, 1)])
def test_sim_rep_streams_bit_identical_to_reference(name, kw, rep):
    """Another repetition: every RNG stream keyed by ``rep`` (clients,
    server noise, the resilience stream)."""
    port = trun(tsc.get(name, seed=5, duration=15.0, **kw), "sim", rep=rep)
    ref = jrun(jsc.get(name, seed=5, duration=15.0, **kw), "sim", rep=rep)
    _assert_sim_equal(port, ref)


# ---------------------------------------------------------------------------
# Streaming recorder
# ---------------------------------------------------------------------------
def _summaries(rec) -> list:
    out = [rec.overall()]
    for cid in rec.clients():
        out.append(rec.client(cid))
        out.extend(rec.intervals(cid).values())
    out.extend(rec.intervals().values())
    return [_plain(dataclasses.asdict(s)) for s in out]


@pytest.mark.parametrize("name,kw", [("steady", {}), ("flash-crowd", {}),
                                     ("retry-storm", {}),
                                     ("flash-crowd-autoscale", {})])
def test_streaming_mode_equal_to_reference(name, kw):
    """P² markers and the reservoirs (one RNG keyed ``(0x5EED, seed,
    rep)``) take the same draws: every summary and frame is equal."""
    kw = dict(kw, seed=3, duration=15.0, stats_mode="streaming")
    port = trun(tsc.get(name, **kw), "sim", rep=1)
    ref = jrun(jsc.get(name, **kw), "sim", rep=1)
    assert port.recorder.mode == "streaming"
    assert _summaries(port.recorder) == _summaries(ref.recorder)
    assert _frames(port) == _frames(ref)
    assert port.control_log == ref.control_log
    assert port.recorder._all.n == ref.recorder._all.n > 1000


@pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
def test_streaming_estimators_equal_to_reference(q):
    rng = np.random.default_rng(1)
    xs = rng.lognormal(-5.0, 1.0, 5000).tolist()
    pa, pb = jstats.P2Quantile(q), tstats.P2Quantile(q)
    ra = jstats.ReservoirSample(k=64, seed=3)
    rb = tstats.ReservoirSample(k=64, seed=3)
    sa = jstats.StreamingStat(reservoir_k=64, use_p2=True)
    sb = tstats.StreamingStat(reservoir_k=64, use_p2=True)
    for i, x in enumerate(xs):
        for o in (pa, pb, ra, rb, sa, sb):
            o.add(x)
        if i < 6:
            assert pb.value() == pa.value()
    assert pb.value() == pa.value()
    assert abs(pb.value() - np.percentile(xs, q * 100)) < \
        0.1 * np.percentile(xs, q * 100)
    assert rb.data == ra.data and rb.n == ra.n
    assert dataclasses.asdict(sb.summary()) == dataclasses.asdict(
        sa.summary())


# ---------------------------------------------------------------------------
# Legacy TailBench baseline (Fig. 4 / Table 4)
# ---------------------------------------------------------------------------
LEGACY = [dict(n_clients=4, qps_per_client=100.0, requests_per_client=400,
               duration=20.0, seed=2),
          dict(n_clients=2, qps_per_client=300.0, requests_per_client=1000,
               app="masstree", duration=10.0, seed=7, workers=2)]


@pytest.mark.parametrize("kw", LEGACY)
def test_legacy_and_plusplus_equal_to_reference(kw):
    """Both modes run bit for bit as the reference's, and the paper's
    equivalence holds: Welch's test finds no difference."""
    lp, lr = tlegacy.legacy_experiment(**kw), jlegacy.legacy_experiment(**kw)
    assert lp.legacy_mode and lp.legacy_requests_per_client == \
        kw["requests_per_client"]
    pp = tlegacy.plusplus_equivalent(lp)
    pr = jlegacy.plusplus_equivalent(lr)
    assert not pp.legacy_mode and pp.legacy_requests_per_client is None
    runs = []
    for port_exp, ref_exp in ((lp, lr), (pp, pr)):
        a, b = tharness.run(port_exp), jharness.run(ref_exp)
        assert a.recorder.all == b.recorder.all
        assert (a.dropped, a.completed_per_client) == \
            (b.dropped, b.completed_per_client)
        assert sum(a.completed_per_client.values()) == \
            kw["n_clients"] * kw["requests_per_client"]
        runs.append(a.recorder.all)
    w = tstats.welch_ttest(*runs)
    assert dataclasses.asdict(w) == dataclasses.asdict(
        jstats.welch_ttest(*runs))
    assert not w.significant


def test_legacy_rejects_late_clients_like_reference():
    """Legacy restrictions 1-3: the server waits for one client, refuses
    the later ones, and terminates when its clients are done."""
    clients = [ClientConfig(i, ConstantQPS(50), start_time=5.0 * i,
                            total_requests=100) for i in range(3)]
    exp = tharness.Experiment(clients=clients, duration=15.0, seed=3,
                              legacy_mode=True, legacy_expected_clients=1)
    from repro.core.client import ClientConfig as JC, ConstantQPS as JQ
    jclients = [JC(i, JQ(50), start_time=5.0 * i, total_requests=100)
                for i in range(3)]
    jexp = jharness.Experiment(clients=jclients, duration=15.0, seed=3,
                               legacy_mode=True, legacy_expected_clients=1)
    a, b = tharness.run(exp), jharness.run(jexp)
    assert a.recorder.all == b.recorder.all
    assert a.dropped == b.dropped >= 2
    assert a.completed_per_client == b.completed_per_client
    assert a.completed_per_client.get(1, 0) == 0


def test_vector_refuses_legacy_mode():
    from repro_torch.vector import VectorCompileError, compile_experiment
    exp = tlegacy.legacy_experiment(2, 50.0, requests_per_client=10,
                                    duration=2.0)
    with pytest.raises(VectorCompileError, match="legacy_mode"):
        compile_experiment(exp)


# ---------------------------------------------------------------------------
# Bulk clients and batched servers
# ---------------------------------------------------------------------------
def test_fast_clients_equal_to_reference():
    """The opt-in ``BatchedClientGenerator`` draws in chunks: its own
    stream, the reference's chunk for chunk."""
    def exp(mod, cc, q):
        return mod.Experiment(
            clients=[cc(i, q(400.0), total_requests=5000)
                     for i in range(3)],
            servers=tuple(mod.ServerSpec(i, workers=2) for i in range(2)),
            policy="jsq", duration=20.0, seed=9, fast_clients=True)
    from repro.core.client import ClientConfig as JC, ConstantQPS as JQ
    a = tharness.build_simulator(exp(tharness, ClientConfig, ConstantQPS))
    b = jharness.build_simulator(exp(jharness, JC, JQ))
    assert {type(g).__name__ for g in a.clients.values()} == \
        {"BatchedClientGenerator"}
    a.run()
    b.run()
    assert a.recorder.all == b.recorder.all
    assert len(a.recorder.all) == 15000


@pytest.mark.parametrize("kw", [{}, dict(qps=600.0, n_servers=4),
                                dict(max_batch=2, duration=20.0)])
def test_batched_sim_path_equal_to_reference(kw):
    """``batched-serving`` on continuous-batching servers: the
    ``BatchScheduler`` op sequence, token counts and occupancy gauges."""
    port = trun(tsc.get("batched-serving", seed=4, **kw), "sim")
    ref = jrun(jsc.get("batched-serving", seed=4, **kw), "sim")
    _assert_sim_equal(port, ref)
    servers = port.sim.servers.values()
    assert all(s._batched for s in servers)
    assert [s.tokens_done for s in servers] == \
        [s.tokens_done for s in ref.sim.servers.values()]
    assert sum(s.tokens_done for s in servers) > 0
    assert any(f["tokens_per_sec"] for f in _frames(port))


# ---------------------------------------------------------------------------
# Welch's t-test and confidence intervals
# ---------------------------------------------------------------------------
def test_t_sf_known_values():
    # two-sided 5 % critical values of Student's t
    for t, df in ((12.706204736, 1), (2.228138852, 10), (1.959963985, 1e9)):
        assert tstats.t_sf(t, df) == pytest.approx(0.05, abs=1e-6)
        assert tstats.t_sf(t, df) == jstats.t_sf(t, df)
    assert tstats.t_sf(0.0, 5.0) == pytest.approx(1.0)
    assert math.isnan(tstats.t_sf(1.0, 0.0))


@pytest.mark.parametrize("a,b", [
    ([2.1, 2.0, 1.9, 2.2, 2.05], [5.1, 5.3, 4.9, 5.2, 5.0]),
    ([1.0, 2.0, 3.0, 4.0], [2.0, 3.0, 4.0, 5.0, 6.0, 7.0]),
    ([1.0], [1.0, 2.0, 3.0]), ([], []), ([2.0, 2.0, 2.0], [2.0, 2.0]),
    ([2.0, 2.0], [3.0, 3.0])])
def test_welch_ttest_known_values(a, b):
    w, r = tstats.welch_ttest(a, b), jstats.welch_ttest(a, b)
    assert _plain(dataclasses.asdict(w)) == _plain(dataclasses.asdict(r))
    assert w.significant == r.significant
    if len(a) >= 2 and len(b) >= 2 and np.var(a) + np.var(b) > 0:
        va = np.var(a, ddof=1) / len(a)
        vb = np.var(b, ddof=1) / len(b)
        t = (np.mean(a) - np.mean(b)) / math.sqrt(va + vb)
        df = (va + vb) ** 2 / (va ** 2 / (len(a) - 1)
                               + vb ** 2 / (len(b) - 1))
        assert w.t_stat == pytest.approx(t, rel=1e-12)
        assert w.df == pytest.approx(df, rel=1e-12)
    if a == [1.0, 2.0, 3.0, 4.0]:
        # means 2.5 and 4.5, squared standard errors 5/12 and 7/12:
        # t = -2 exactly, df = 1 / ((5/12)^2 / 3 + (7/12)^2 / 5) = 7.941,
        # two-sided p = 0.080781 (Student's t CDF)
        assert w.t_stat == -2.0
        assert w.df == pytest.approx(7.9412, abs=1e-4)
        assert w.p_value == pytest.approx(0.0807815, abs=1e-6)


@pytest.mark.parametrize("xs,want", [
    ([], ("nan", "nan")), ([4.2], (4.2, "nan")),
    ([1.0, 2.0, 3.0], (2.0, 1.96 / math.sqrt(3.0))),
    ([10.0, 12.0, 14.0, 16.0], (13.0, 1.96 * math.sqrt(20.0 / 3.0) / 2.0))])
def test_confidence95_known_values(xs, want):
    got = tstats.confidence95(xs)
    assert _plain(got[0]) == _plain(jstats.confidence95(xs)[0])
    for g, w in zip(got, want):
        if w == "nan":
            assert math.isnan(g)
        else:
            assert g == pytest.approx(w, rel=1e-12)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000])
def test_pctl_equal_to_reference(n):
    xs = np.random.default_rng((11, n)).lognormal(-5.0, 1.0, n)
    for sample in (xs, list(xs), tuple(xs)):
        for q in (0.0, 50.0, 99.0, 99.9, 100.0):
            got, want = tstats.pctl(sample, q), jstats.pctl(sample, q)
            assert type(got) is float
            assert got == want or (math.isnan(got) and math.isnan(want))
            assert math.isnan(got) == (n == 0)
