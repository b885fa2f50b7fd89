"""End-to-end driver: serve a real model of the port with batched requests.

Twin of ``examples/serve_e2e.py`` on the PyTorch/CUDA port.  Two
InferenceEngine replicas run a reduced phi3 config (weights drawn from
seed 0); TailBench++ open-loop clients drive them in wall-clock time
through a JSQ balancer.  This is the paper's client->LVS->server data
flow (Fig. 3) with real model inference as the service, on the card
(both attention kernels) unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_port/serve_e2e.py
    PYTHONPATH=src python examples/torch_port/serve_e2e.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.client import ClientConfig, ConstantQPS
from repro_torch.core.runtime import EngineRuntime
from repro_torch.device import resolve_device
from repro_torch.models import registry as R
from repro_torch.serving.engine import InferenceEngine

ARCH = "phi3-mini-3.8b-smoke"


def main(argv=None) -> EngineRuntime:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = resolve_device(ap.parse_args(argv).device)

    cfg = get_config(ARCH)
    params = R.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    engines = [InferenceEngine(cfg, params, max_batch=4, max_len=64)
               for _ in range(2)]

    print("warming the kernels...")
    for e in engines:
        e.submit(np.arange(16), 2, -1)
        e.run_until_idle()

    clients = [ClientConfig(0, ConstantQPS(15), end_time=4.0, seed=0),
               ClientConfig(1, ConstantQPS(15), end_time=4.0, seed=1)]
    print("serving 4s of open-loop traffic at 30 QPS across 2 replicas...")
    rt = EngineRuntime(engines, clients, policy="jsq", duration=4.0,
                       prompt_len=16, max_new_tokens=4, vocab=cfg.vocab_size)
    rt.run()
    s = rt.telemetry.overall()
    print(f"served n={s.n}  mean={s.mean*1e3:.1f}ms  p50={s.p50*1e3:.1f}ms  "
          f"p95={s.p95*1e3:.1f}ms  p99={s.p99*1e3:.1f}ms")
    for i, e in enumerate(engines):
        print(f"replica {i}: prefills={e.prefill_count} "
              f"decode_steps={e.decode_steps}")
    assert s.n > 0
    return rt


if __name__ == "__main__":
    main()
