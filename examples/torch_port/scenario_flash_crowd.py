"""Define-your-own-scenario recipe: a flash crowd, twice over.

Twin of ``examples/scenario_flash_crowd.py`` on the port's ``sim``
backend and ``StubEngine`` replicas on a ``VirtualClock`` (both on the
host): the same run, and the same output line for line.

Builds a custom flash-crowd ``Scenario`` from declarative events, runs it
on BOTH runtime backends — the virtual-time simulator and the wall-clock
``EngineRuntime`` over profile-timed ``StubEngine`` replicas — and prints
the per-interval telemetry side by side.  The same compiled scenario
drives both; only the execution substrate differs.

    PYTHONPATH=src python examples/torch_port/scenario_flash_crowd.py
"""
from repro_torch.core.harness import ServerSpec
from repro_torch.core.runtime import EngineRuntime, VirtualClock, run_scenario
from repro_torch.core.scenario import ClientArrival, FlashCrowd, Scenario
from repro_torch.scenarios.backends import build_stub_engines

# 1. Declare the scenario: steady 600 QPS, then a 12s viral spike that
#    triples the offered load (an SLO of 25ms makes violations visible).
sc = Scenario(
    name="my-flash-crowd",
    duration=40.0,
    servers=(ServerSpec(0, workers=2), ServerSpec(1, workers=2)),
    events=[
        ClientArrival(0.0, qps=200.0, count=3),          # the base tenants
        FlashCrowd(at=14.0, duration=12.0, peak_qps=1500.0, clients=6),
    ],
    app="xapian",
    policy="jsq",
    slo=0.025,
    seed=42,
)

# 2. Virtual-time backend: deterministic, instant.
sim_rt = run_scenario(sc, "sim")

# 3. Wall-clock backend: same compiled scenario against StubEngine
#    replicas on an accelerated virtual clock (build_stub_engines gives
#    one profile-timed stub per initial server, plus a join factory).
exp = sc.compile()
clock = VirtualClock()
engines, factory = build_stub_engines(exp, clock, seed=42)
eng_rt = EngineRuntime.from_experiment(exp, engines, engine_factory=factory,
                                       clock=clock, sleep=clock.sleep)
eng_rt.run()

print(f"{'t':>3} | {'sim n':>6} {'sim p99':>9} {'viol':>5} | "
      f"{'eng n':>6} {'eng p99':>9} {'viol':>5}")
eng_frames = {f.t: f for f in eng_rt.telemetry.frames()}
for f in sim_rt.telemetry.frames():
    g = eng_frames.get(f.t)
    gcol = (f"{g.n:6d} {g.p99*1e3:8.2f}ms {g.slo_violation_frac:5.2f}"
            if g else " " * 22)
    print(f"{f.t:3d} | {f.n:6d} {f.p99*1e3:8.2f}ms {f.slo_violation_frac:5.2f}"
          f" | {gcol}")

s1, s2 = sim_rt.telemetry.overall(), eng_rt.telemetry.overall()
print(f"\nsim:    n={s1.n}  p99={s1.p99*1e3:.2f}ms")
print(f"engine: n={s2.n}  p99={s2.p99*1e3:.2f}ms")
assert s1.n > 0 and s2.n > 0
