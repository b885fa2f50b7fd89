"""Quickstart: the TailBench++ harness in 40 lines.

Twin of ``examples/quickstart.py`` on the port's event simulator
(``repro_torch.core``, on the host): the same run, and the same output
line for line.

Simulates the paper's headline scenario — dynamic clients against a
persistent multi-server deployment — and prints per-client tail latency.

    PYTHONPATH=src python examples/torch_port/quickstart.py
"""
from repro_torch.core.client import ClientConfig, ConstantQPS, PiecewiseQPS
from repro_torch.core.harness import Experiment, ServerSpec, run

# Three independent clients (Feature 3): different start times, budgets,
# and load shapes (Feature 4).  The server pool persists throughout
# (Features 1+2) behind a load-aware balancer.
clients = [
    ClientConfig(1, ConstantQPS(300), start_time=0.0, total_requests=4000),
    ClientConfig(2, PiecewiseQPS([(0, 100), (10, 500), (20, 100)]),
                 start_time=5.0),
    ClientConfig(3, ConstantQPS(200), start_time=12.0, total_requests=2000),
]

exp = Experiment(
    clients=clients,
    servers=(ServerSpec(0, workers=2), ServerSpec(1, workers=2)),
    app="xapian",                      # one of the 8 TailBench apps
    policy="load_aware",               # paper Fig. 8's better policy
    duration=30.0,
    seed=42,
)

sim = run(exp)
print(f"total requests: {sim.recorder.overall().n}   dropped: {sim.dropped}")
for cid in sim.recorder.clients():
    s = sim.recorder.client(cid)
    print(f"client {cid}: n={s.n:6d}  mean={s.mean*1e3:7.2f}ms  "
          f"p95={s.p95*1e3:7.2f}ms  p99={s.p99*1e3:7.2f}ms")
for sid, srv in sim.servers.items():
    print(f"server {sid}: served={srv.total_served}  "
          f"busy={srv.busy_time:.1f}s")
