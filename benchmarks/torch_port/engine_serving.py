"""End-to-end: the port's real engine served by the TailBench++ harness
(wall-clock).

Twin of ``benchmarks/engine_serving.py`` on the PyTorch/CUDA port: a
smoke-scale model (phi3-mini-3.8b-smoke, weights drawn from seed 0)
behind 2 ``InferenceEngine`` replicas; open-loop clients at two rates;
reports p50/p95/p99 wall-clock latency, and, beside the reference's
columns, the requests submitted, so a reader sees that every one was
served.  Validates that the harness <-> engine integration (Fig. 3's
data flow) actually runs.  Runs on the card (both attention kernels)
unless ``--device cpu``.

    PYTHONPATH=src:. python benchmarks/torch_port/engine_serving.py
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from benchmarks.torch_port.common import emit
from repro_torch.configs.base import get_config
from repro_torch.core.client import ClientConfig, ConstantQPS
from repro_torch.core.runtime import EngineRuntime
from repro_torch.device import resolve_device
from repro_torch.models import registry as R
from repro_torch.serving.engine import InferenceEngine

ARCH = "phi3-mini-3.8b-smoke"
QPS = (20, 60)


def run(device: str = "cuda") -> list[dict]:
    """The two rates' rows (milliseconds as numbers)."""
    dev = resolve_device(device)
    cfg = get_config(ARCH)
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    rows = []
    for qps in QPS:
        engines = [InferenceEngine(cfg, params, max_batch=4, max_len=64)
                   for _ in range(2)]
        # warm the kernels outside the timed window
        for e in engines:
            e.submit(np.arange(16), 2, -1)
            e.run_until_idle()
        clients = [ClientConfig(i, ConstantQPS(qps / 2), end_time=3.0, seed=i)
                   for i in range(2)]
        rt = EngineRuntime(engines, clients, policy="jsq", duration=3.0,
                           prompt_len=16, max_new_tokens=4,
                           vocab=cfg.vocab_size)
        rt.run()
        s = rt.telemetry.overall()
        rows.append({"qps": qps, "submitted": rt.submitted, "n": s.n,
                     "p50_ms": s.p50 * 1e3, "p95_ms": s.p95 * 1e3,
                     "p99_ms": s.p99 * 1e3})
    return rows


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.time()
    rows = run(args.device)
    emit("engine_serving",
         [dict(r, **{k: f"{r[k]:.1f}" for k in ("p50_ms", "p95_ms", "p99_ms")})
          for r in rows], t0, f"p99_ms={rows[-1]['p99_ms']:.1f}")
    return "ok"


if __name__ == "__main__":
    main()
