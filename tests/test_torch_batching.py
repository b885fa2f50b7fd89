"""Batched serving on the port's engine backend (CPU) against the JAX
package's.

* ``BatchedStubEngine`` alone, stepped draw for draw against
  ``repro.serving.engine.BatchedStubEngine`` (noise on).
* ``batched-serving`` on stub engines in virtual time, through
  ``repro``'s ``build_stub_engines`` + ``EngineRuntime`` and through
  the port's: equal telemetry rows, ``overall()``, dispositions and
  attempts, at two offered loads, two ``max_batch`` and
  ``service_noise`` 0 and 1.
* The reference's batching checks (``tests/test_batching.py``) as the
  port's own: the batched stub fleet, ``sim`` against the stub engines
  within rel 0.10 (p50) and 0.15 (p99), noise reaching the stubs, the
  CLI with ``--backend engine --stub``.
* ``BatchedService``'s roofline members and ``from_arch``: with the
  TPU v5e's figures patched in, equal to the reference's field for
  field; with the H100's, ``phi3-mini-3.8b`` on one card streams its
  parameters in 2N / 3.35e12 s a step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import scenarios as jsc  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro.core.harness import Experiment as JExperiment  # noqa: E402
from repro.core.harness import ServerSpec as JServerSpec  # noqa: E402
from repro.core.profiles import BatchedService as JBatched  # noqa: E402
from repro.core.profiles import TokenLengths as JLengths  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serving.engine import BatchedStubEngine as JStub  # noqa: E402
from test_torch_engine_control import (_port, _ref,  # noqa: E402
                                       assert_engine_runs_equal)

from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.core.harness import Experiment, ServerSpec  # noqa: E402
from repro_torch.core.profiles import (BatchedService,  # noqa: E402
                                       TokenLengths)
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.scenarios import backends as tbackends  # noqa: E402
from repro_torch.serving.engine import BatchedStubEngine  # noqa: E402

SVC = dict(t_memory=1e-3, t_compute_per_seq=2e-4, t_prefill_per_token=1e-5)
PORT_SVC, REF_SVC = BatchedService("toy", **SVC), JBatched("toy", **SVC)
#: TPU v5e per chip (repro/launch/mesh.py)
V5E = dict(PEAK_FLOPS_BF16=197e12, HBM_BW=819e9)


def _batched(mod_sc, svc, lengths_cls, qps, max_batch, *, seed=9,
             duration=12.0):
    return mod_sc.get("batched-serving", seed=seed, duration=duration,
                      qps=qps, n_clients=2, n_servers=1,
                      max_batch=max_batch, service=svc,
                      lengths=lengths_cls(new_median=16, new_max=64))


def _with_noise(exp_cls, spec_cls, exp, noise: float):
    """The compiled experiment with ``service_noise`` on every server."""
    return exp_cls(
        clients=exp.clients, duration=exp.duration, seed=exp.seed,
        policy=exp.policy, service_model=exp.service_model,
        lengths=exp.lengths,
        servers=tuple(spec_cls(s.server_id, max_batch=s.max_batch,
                               service_noise=noise) for s in exp.servers))


class _Compiled:
    """A compiled experiment posing as a scenario for ``stub_run``."""

    def __init__(self, exp):
        self.exp = exp

    def compile(self):
        return self.exp


def test_batched_stub_engine_matches_jax_draws():
    pc, rc = trt.VirtualClock(), jrt.VirtualClock()
    port = BatchedStubEngine(PORT_SVC, max_batch=3, speed=1.3,
                             service_noise=0.4, seed=6, clock=pc)
    ref = JStub(REF_SVC, max_batch=3, speed=1.3, service_noise=0.4, seed=6,
                clock=rc)
    rng = np.random.default_rng(2)
    for i in range(7):
        prompt = np.zeros(int(rng.integers(1, 300)), np.int32)
        n_new = int(rng.integers(1, 9))
        port.submit(prompt, n_new, i)
        ref.submit(prompt, n_new, i)
    assert port.pending() == ref.pending() == 7
    got, want = [], []
    while not ref.idle():
        want += ref.step()
        got += port.step()
        assert (port.n_active(), port.pending(), port.idle()) == \
            (ref.n_active(), ref.pending(), ref.idle())
        assert pc.t == rc.t
    assert port.idle()
    assert [(c.req_id, c.ttft, c.latency) for c in got] == \
        [(c.req_id, c.ttft, c.latency) for c in want]
    assert sorted(c.req_id for c in got) == list(range(7))
    assert (port.busy_time, port.tokens_done, port.total_served) == \
        (ref.busy_time, ref.tokens_done, ref.total_served)
    assert port.serializes_ops is ref.serializes_ops is True


@pytest.mark.parametrize("noise", [0.0, 1.0])
@pytest.mark.parametrize("max_batch", [2, 4])
@pytest.mark.parametrize("qps", [40.0, 120.0])
def test_batched_serving_engine_run_equal_to_reference(qps, max_batch,
                                                       noise):
    port_exp = _batched(tsc, PORT_SVC, TokenLengths, qps, max_batch
                        ).compile()
    ref_exp = _batched(jsc, REF_SVC, JLengths, qps, max_batch).compile()
    if noise:
        port_exp = _with_noise(Experiment, ServerSpec, port_exp, noise)
        ref_exp = _with_noise(JExperiment, JServerSpec, ref_exp, noise)
    port, ref = _port(_Compiled(port_exp)), _ref(_Compiled(ref_exp))
    assert_engine_runs_equal(port, ref)
    assert port.submitted == port.telemetry.overall().n > 0
    engines = [h.engine for h in port.handles.values()]
    assert all(isinstance(e, BatchedStubEngine) for e in engines)
    assert [e.busy_time for e in engines] == \
        [h.engine.busy_time for h in ref.handles.values()]


# ---------------------------------------------------------------------------
# The reference's batching checks, as the port's own
# ---------------------------------------------------------------------------
def test_stub_fleet_is_batched_for_batched_experiments():
    sc = tsc.get("batched-serving", seed=1, n_servers=2, service=PORT_SVC)
    engines, factory = tbackends.build_stub_engines(sc.compile(),
                                                    trt.VirtualClock(), 0)
    assert all(isinstance(e, BatchedStubEngine) for e in engines.values())
    assert all(e.max_batch == 8 for e in engines.values())
    assert isinstance(factory(0), BatchedStubEngine)
    # a joining server without a spec gets the reference's default slots
    assert factory(9).max_batch == 8


@pytest.mark.parametrize("qps", [40.0, 120.0])
def test_sim_vs_stub_engine_latency_parity(qps):
    """Same scenario on both backends, the shared ``BatchScheduler``
    dynamics: the percentiles agree below and near the knee."""
    sc = _batched(tsc, PORT_SVC, TokenLengths, qps, 4)
    s_sim = trt.run_scenario(sc, "sim").telemetry.overall()
    s_eng = _port(sc).telemetry.overall()
    assert abs(s_sim.n - s_eng.n) <= max(10, 0.02 * s_sim.n)
    assert s_eng.p50 == pytest.approx(s_sim.p50, rel=0.10)
    assert s_eng.p99 == pytest.approx(s_sim.p99, rel=0.15)


def test_stub_engines_honor_service_noise():
    """``service_noise`` on a ``ServerSpec`` reaches the stub engines."""
    def total_busy(noise):
        sc = tsc.get("batched-serving", seed=3, duration=8.0, qps=40.0,
                     n_clients=2, n_servers=1, max_batch=4, service=PORT_SVC,
                     lengths=TokenLengths(new_median=8, new_max=16))
        exp = _with_noise(Experiment, ServerSpec, sc.compile(), noise)
        engines, _ = tbackends.build_stub_engines(exp, trt.VirtualClock(), 3)
        assert all(e.service_noise == noise for e in engines.values())
        rt = _port(_Compiled(exp))
        return sum(h.busy_time for h in rt.handles.values())

    quiet, noisy = total_busy(0.0), total_busy(1.0)
    assert quiet > 0
    assert noisy != quiet


@pytest.mark.parametrize("backend", ["sim", "engine"])
def test_batched_scenario_runs_via_cli_entry(backend, capsys):
    from repro_torch.scenarios.__main__ import main
    args = ["batched-serving", "--duration", "4", "--backend", backend]
    assert main(args + (["--stub"] if backend == "engine" else [])) == 0
    head = capsys.readouterr().out.splitlines()[0]
    assert head.startswith(f"scenario=batched-serving backend={backend} n=")
    assert head.endswith("device=host")


def test_batched_scenario_cli_report_equal_to_reference(capsys):
    """The engine backend's report of the port's CLI is the reference's
    (its first line without the port's ``device=`` field)."""
    from repro.scenarios.__main__ import main as jax_main

    from repro_torch.scenarios.__main__ import main
    args = ["batched-serving", "--duration", "4", "--backend", "engine",
            "--stub"]
    assert main(args) == 0
    port_out = capsys.readouterr().out.splitlines()
    assert jax_main(args) == 0
    ref_out = capsys.readouterr().out.splitlines()
    assert port_out[0] == ref_out[0] + " device=host"
    assert port_out[1:] == ref_out[1:]


# ---------------------------------------------------------------------------
# BatchedService's roofline members and from_arch
# ---------------------------------------------------------------------------
def test_roofline_members_equal_to_reference():
    batch = np.arange(0, 12)
    assert PORT_SVC.ridge_batch == REF_SVC.ridge_batch == pytest.approx(5.0)
    np.testing.assert_array_equal(PORT_SVC.step_time_array(batch),
                                  REF_SVC.step_time_array(batch))
    assert [PORT_SVC.service_rate(int(b)) for b in batch] == \
        [REF_SVC.service_rate(int(b)) for b in batch]
    assert PORT_SVC.step_time_array(batch)[8] == PORT_SVC.step_time(8)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mamba2-1.3b"])
def test_count_params_active_equal_to_reference(arch):
    cfg = get_config(arch)
    n = R.count_params(cfg)
    assert R.count_params(cfg, active=True) == n
    assert JR.count_params(jax_config(arch), active=True) == n


@pytest.mark.parametrize("arch,chips", [("phi3-mini-3.8b", 8),
                                        ("phi3-mini-3.8b", 1),
                                        ("mamba2-1.3b", 4)])
def test_from_arch_on_v5e_figures_equal_to_reference(monkeypatch, arch,
                                                     chips):
    for name, value in V5E.items():
        monkeypatch.setattr(mesh, name, value)
    port = BatchedService.from_arch(arch, chips=chips)
    ref = JBatched.from_arch(arch, chips=chips)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_from_arch_on_hopper_figures():
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW) == (989e12, 3.35e12)
    n = R.count_params(get_config("phi3-mini-3.8b"))
    svc = BatchedService.from_arch("phi3-mini-3.8b", chips=1)
    assert svc.name == "batched:phi3-mini-3.8b"
    assert svc.step_time(4) == svc.t_memory == 2.0 * n / 3.35e12
    assert svc.t_compute_per_seq == svc.t_prefill_per_token == \
        2.0 * n / 989e12
    # the serving breakdown's bound of a batch-4 decode step (PERF.md
    # section 5: 2.281 ms) counts the same bytes, every bf16 weight once
    assert svc.step_time(4) == pytest.approx(2.281e-3, rel=1e-3)
    assert svc.ridge_batch == pytest.approx(989e12 / 3.35e12)


def test_batched_serving_arch_builds_from_hopper_roofline():
    sc = tsc.get("batched-serving", arch="phi3-mini-3.8b")
    assert sc.service_model == BatchedService.from_arch("phi3-mini-3.8b")
    rt = _port(tsc.get("batched-serving", arch="phi3-mini-3.8b",
                       duration=3.0, qps=40.0))
    assert rt.telemetry.overall().n > 0
    # jamba, which the port registers now, builds on its active count;
    # a name neither package registers still raises
    arch = "jamba-1.5-large-398b"
    assert tsc.get("batched-serving", arch=arch).service_model == \
        BatchedService.from_arch(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        tsc.get("batched-serving", arch="no-such-arch")
