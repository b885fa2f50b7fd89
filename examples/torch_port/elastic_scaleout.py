"""Elastic scale-out + straggler mitigation under a diurnal load.

Twin of ``examples/elastic_scaleout.py`` on the port's event simulator
(``repro_torch.core``, on the host): the same run, and the same output
line for line.

A diurnal (sinusoidal) aggregate load runs against 2 servers; a third
joins at the peak and drains afterwards.  Hedged requests cap the tail
during the transition.  Reports per-interval p99 across the day.

    PYTHONPATH=src python examples/torch_port/elastic_scaleout.py
"""
from repro_torch.core.client import ClientConfig, DiurnalQPS
from repro_torch.core.harness import Experiment, ServerSpec, run

clients = [ClientConfig(i, DiurnalQPS(base=250, amplitude=200, period=40),
                        seed=i) for i in range(3)]
servers = (ServerSpec(0, workers=2, service_noise=0.5),
           ServerSpec(1, workers=2, service_noise=0.5),
           ServerSpec(2, workers=2, service_noise=0.5, join_at=15.0,
                      drain_at=35.0))
exp = Experiment(clients=clients, servers=servers, app="xapian",
                 policy="jsq", hedge_delay=0.02, duration=45.0, seed=7)
sim = run(exp)
print("t(s)  n      p99(ms)")
for ivl, s in sim.recorder.intervals().items():
    bar = "#" * int(min(s.p99 * 2e3, 60))
    print(f"{ivl:4d} {s.n:6d} {s.p99*1e3:8.2f} {bar}")
print(f"\nserver 2 (elastic) served {sim.servers[2].total_served} requests "
      f"between t=15s and t=35s")
assert sim.servers[2].total_served > 0
