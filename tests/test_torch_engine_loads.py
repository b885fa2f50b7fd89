"""chip_smoke.py's engine-control loads on modeled replicas (CPU).

Step 6b of ``chip_smoke.py`` sizes its flash crowd and retry storm from a
saturation run of two real phi3 replicas, then gates the runs: the
autoscaler must scale out inside the burst and back in before the
horizon, the retry storm must retry.  Whether the gates hold depends on
how the loads sit against the fleet's dynamics, which a host of another
speed shifts.  Here the replicas are modeled without the model: an
``InferenceEngine``'s scheduler (prefill-priority continuous batching,
one prefill or one decode a step) whose every step costs host time on a
shared ``VirtualClock``, as one host thread stepping real replicas in
turn spends it.  The step costs span a fast host (25 ms a decode step),
a slow one (50 ms) and a slower one (75 ms), each step jittered from a
seeded stream; the saturation run, the loads and the gates are
chip_smoke's own functions.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core.runtime import EngineRuntime, VirtualClock
from repro_torch.scenarios import get
from repro_torch.serving.engine import Completion

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ModeledReplica:
    """An ``InferenceEngine``'s scheduler whose steps cost host time:
    ``step_s`` a step, times a jitter in [0.7, 1.6) drawn from ``rng``,
    advanced on the shared ``clock``."""

    def __init__(self, clock: VirtualClock, step_s: float, rng,
                 max_batch: int = 4):
        self.clock = clock
        self.step_s = step_s
        self.rng = rng
        self.max_batch = max_batch
        self.queue: list = []
        self.active: list = [None] * max_batch

    def submit(self, prompt, max_new_tokens: int, req_id: int) -> None:
        self.queue.append([req_id, self.clock(), max_new_tokens, 0, 0.0])

    def pending(self) -> int:
        return len(self.queue)

    def n_active(self) -> int:
        return sum(r is not None for r in self.active)

    def idle(self) -> bool:
        return not self.queue and self.n_active() == 0

    def step(self) -> list:
        self.clock.t += self.step_s * self.rng.uniform(0.7, 1.6)
        if self.queue and None in self.active:
            slot = self.active.index(None)
            req = self.queue.pop(0)
            req[4] = self.clock()
            self.active[slot] = req
            slots = [slot]
        else:
            slots = [i for i, r in enumerate(self.active) if r is not None]
        done = []
        for slot in slots:
            req = self.active[slot]
            req[3] += 1
            if req[3] >= req[2]:
                self.active[slot] = None
                done.append(Completion(req[0], [], ttft=req[4] - req[1],
                                       latency=self.clock() - req[1]))
        return done


@pytest.mark.parametrize("step_ms", [25.0, 50.0, 75.0])
def test_engine_control_gates_hold_on_modeled_replicas(step_ms):
    cs = _chip_smoke()
    rng = np.random.default_rng(int(step_ms))
    clock = VirtualClock()

    def make(sid=None):
        return ModeledReplica(clock, step_ms / 1e3, rng)

    sat = cs.fleet_saturation([make() for _ in range(cs.ENGINE_REPLICAS)],
                              vocab=100, clock=clock, sleep=clock.sleep)
    assert sat["served"] == cs.ENGINE_SATURATION
    # the fleet's rate follows the host's step: ~8 requests per 64 steps
    assert 0.7 < sat["rate_per_s"] * 64 * step_ms / 1e3 / 8 < 1.3
    for name, kw in cs.engine_runs(sat["rate_per_s"], sat["batch_s"]):
        scenario = get(name, seed=0, **kw)
        exp = scenario.compile()
        n_base = sum(1 for s in exp.servers if s.join_at == 0.0)
        rt = EngineRuntime.from_experiment(
            exp, [make() for _ in range(n_base)], engine_factory=make,
            vocab=100, prompt_len=cs.ENGINE_SHAPE["prompt_len"],
            max_new_tokens=cs.ENGINE_SHAPE["max_new_tokens"], clock=clock,
            sleep=clock.sleep)
        rt.run()
        assert cs.engine_run_fault(name, scenario, rt) is None, \
            (name, rt.control_log)
