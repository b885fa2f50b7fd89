"""Engine-fleet constructors shared by the scenario CLI and launch/serve.

Copy of ``repro.scenarios.backends``: one place constructs the engine
replicas (and the join factory) a compiled scenario's engine backend
needs — real ``InferenceEngine``s on the card (or the CPU when asked),
warmed, all sharing one copy of the weights, or ``StubEngine`` /
``BatchedStubEngine`` stand-ins on a virtual clock.
"""
from __future__ import annotations

from typing import Callable


def build_real_engines(arch: str, n: int, *, smoke: bool = False,
                       max_batch: int = 4, prompt_len: int = 16,
                       max_new_tokens: int = 4, seed: int = 0,
                       device: str = "cuda"):
    """-> (engines, factory, vocab_size): ``n`` warmed real engines plus a
    ``factory(server_id)`` for servers that join mid-scenario.  The
    weights are drawn once from ``seed`` on ``device`` and shared."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import registry as R
    from repro_torch.serving.engine import make_warmed_engine

    dev = resolve_device(device)
    cfg = get_config(arch + ("-smoke" if smoke else ""))
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))

    def factory(sid=None):
        return make_warmed_engine(cfg, params, max_batch=max_batch,
                                  prompt_len=prompt_len,
                                  max_new_tokens=max_new_tokens)
    return [factory() for _ in range(n)], factory, cfg.vocab_size


def run_experiment_on_real_engines(exp, *, arch: str, smoke: bool = False,
                                   max_batch: int = 4, prompt_len: int = 16,
                                   max_new_tokens: int = 4, seed: int = 0,
                                   time_scale: float = 1.0,
                                   device: str = "cuda"):
    """Run a compiled experiment wall-clock on warmed real engines and
    return the finished ``EngineRuntime``.  When the experiment samples
    per-request token sizes, the engines are sized for the
    distribution's maxima so no sampled prompt overflows the cache."""
    from repro_torch.core.runtime import EngineRuntime

    lengths = exp.resolved_lengths()
    if lengths is not None:
        prompt_len = max(prompt_len, getattr(lengths, "prompt_max", prompt_len))
        max_new_tokens = max(max_new_tokens,
                             getattr(lengths, "new_max", max_new_tokens))
    n_base = sum(1 for s in exp.servers if s.join_at == 0.0)
    engines, factory, vocab = build_real_engines(
        arch, n_base, smoke=smoke, max_batch=max_batch,
        prompt_len=prompt_len, max_new_tokens=max_new_tokens, seed=seed,
        device=device)
    rt = EngineRuntime.from_experiment(
        exp, engines, engine_factory=factory, vocab=vocab,
        prompt_len=prompt_len, max_new_tokens=max_new_tokens,
        time_scale=time_scale)
    rt.run()
    return rt


def build_stub_engines(exp, clock: Callable[[], float], seed: int = 0):
    """-> (engines, factory): one stub replica per initial server spec of
    the compiled experiment, honoring workers/max_batch and speed.

    A scalar experiment gets profile-timed ``StubEngine`` slots; an
    experiment with a batched ``service_model`` gets ``BatchedStubEngine``
    replicas running the ``BatchScheduler``/``BatchedService`` dynamics
    of the simulator's batched serve loop."""
    from repro_torch.serving.engine import BatchedStubEngine, StubEngine

    service = exp.resolved_service()
    batched = getattr(service, "kind", "scalar") == "batched"
    profile = exp.resolved_profile()
    specs = {s.server_id: s for s in exp.servers}

    def make(sid: int, workers: int, speed: float, max_batch, noise: float):
        if batched:
            return BatchedStubEngine(service, max_batch=max_batch or 8,
                                     speed=speed, service_noise=noise,
                                     seed=seed + sid, clock=clock)
        return StubEngine(profile, workers=workers, speed=speed,
                          service_noise=noise, seed=seed + sid, clock=clock)

    engines = {s.server_id: make(s.server_id, s.workers, s.speed, s.max_batch,
                                 s.service_noise)
               for s in exp.servers if s.join_at == 0.0}

    def factory(sid: int):
        spec = specs.get(sid)
        return make(sid,
                    spec.workers if spec else 1,
                    spec.speed if spec else 1.0,
                    spec.max_batch if spec else None,
                    spec.service_noise if spec else 0.0)
    return engines, factory
