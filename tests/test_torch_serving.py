"""The port's serving path on the CPU against the JAX package.

* ``InferenceEngine``: JAX's own ``phi3-mini-3.8b-smoke`` parameters
  (bf16, ``repro.models.registry.init_params``) carried across with
  ``param.from_numpy``; continuous batching over ragged prompts must give
  the greedy tokens of JAX's full forward (``repro.models.registry
  .lm_logits``, ``impl="ref"``, no cache) exactly, as the JAX package's
  own engine test demands of its engine.
* ``EngineRuntime`` with ``StubEngine`` replicas on a ``VirtualClock``:
  the same canonical scenario through ``repro.core.runtime`` and the
  port must give identical telemetry, row for row (both are NumPy draws
  and float arithmetic in the same order: equality, no tolerance).
* The entry points: ``python -m repro_torch.launch.serve --smoke
  --device cpu`` and ``python -m repro_torch.scenarios --backend
  engine``.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import scenarios as jsc  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.scenarios import backends as jbackends  # noqa: E402

from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.scenarios import backends as tbackends  # noqa: E402
from repro_torch.serving.engine import (InferenceEngine, StubEngine,  # noqa: E402
                                        _bucket, make_warmed_engine)

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ARCH = "phi3-mini-3.8b-smoke"


@pytest.fixture(scope="module")
def smoke_model():
    cfg = get_config(ARCH)
    jparams = JR.init_params(jax_config(ARCH), jax.random.PRNGKey(0))
    params = P.from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return cfg, jparams, params


def _jax_greedy(jparams, prompt, n_new: int, width: int = 64) -> list:
    """Full-forward greedy decode without a cache.  The sequence is
    right-padded to ``width`` so one jitted forward serves every step:
    under the causal mask the pad never reaches the logits at
    ``len - 1``."""
    jcfg = jax_config(ARCH)
    fwd = jax.jit(lambda p, t: JR.lm_logits(jcfg, p, {"tokens": t},
                                            impl="ref"))
    toks = [int(t) for t in prompt]
    out = []
    for _ in range(n_new):
        row = np.zeros((1, width), np.int32)
        row[0, :len(toks)] = toks
        logits = fwd(jparams, jnp.asarray(row))[0, len(toks) - 1]
        out.append(int(jnp.argmax(logits)))
        toks.append(out[-1])
    return out


def test_engine_greedy_matches_jax_full_forward(smoke_model):
    """Three ragged prompts on two slots: the third waits for a free slot
    and is prefilled into a reused one (continuous batching)."""
    cfg, jparams, params = smoke_model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (24, 9, 32)]
    eng = InferenceEngine(cfg, params, max_batch=2, max_len=96)
    for i, p in enumerate(prompts):
        eng.submit(p, 6, i)
    done = {c.req_id: c for c in eng.run_until_idle()}
    assert sorted(done) == [0, 1, 2]
    assert eng.prefill_count == 3 and eng.n_active() == 0
    assert eng.tokens_done == 3 * 6
    for i, p in enumerate(prompts):
        assert done[i].tokens == _jax_greedy(jparams, p, 6), i
        assert 0 <= done[i].ttft <= done[i].latency


def test_engine_batch_does_not_leak_between_slots(smoke_model):
    """A request decoded beside another gives the tokens it gives alone;
    inactive slots keep advancing their positions, as in the reference."""
    cfg, _, params = smoke_model
    rng = np.random.default_rng(3)
    short, long = (rng.integers(0, cfg.vocab_size, size=n) for n in (9, 37))
    eng = InferenceEngine(cfg, params, max_batch=3, max_len=96)
    eng.submit(short, 4, 0)
    eng.submit(long, 7, 1)
    together = {c.req_id: c.tokens for c in eng.run_until_idle()}
    assert eng.positions.tolist()[2] == eng.decode_steps  # never admitted
    for rid, p, n in ((0, short, 4), (1, long, 7)):
        alone = InferenceEngine(cfg, params, max_batch=1, max_len=96)
        alone.submit(p, n, rid)
        assert alone.run_until_idle()[0].tokens == together[rid], rid


def test_engine_cache_in_place_and_bucketed_prefill(smoke_model):
    cfg, _, params = smoke_model
    assert [_bucket(n) for n in (1, 32, 33, 4096, 4097)] == \
        [32, 32, 64, 4096, 8192]
    eng = make_warmed_engine(cfg, params, max_batch=2, prompt_len=20,
                             max_new_tokens=3)
    assert eng.max_len == 20 + 3 + 32
    assert eng.decode_steps == eng.prefill_count == eng.tokens_done == 0
    k = eng.cache["pos0"]["k"]
    assert k.dtype == torch.bfloat16
    ptr = k.data_ptr()
    eng.submit(np.arange(20) % cfg.vocab_size, 3, 7)
    eng.step()                                # prefill into slot 0
    pos = eng.cache["pos0"]["pos"][:, 0]
    # bucket 32 (of the 20-token prompt): pad slots carry positions >= 20,
    # beyond the bucket the slots stay empty (-1)
    assert pos[0, :32].tolist() == list(range(32))
    assert (pos[:, 32:] == -1).all()
    eng.run_until_idle()
    assert eng.cache["pos0"]["k"].data_ptr() == ptr   # updated in place


def test_engine_decodes_eagerly_on_cpu(smoke_model):
    """The decode step's CUDA graph needs a card: on the CPU the warmed
    engine captures nothing and every step runs eagerly."""
    cfg, _, params = smoke_model
    eng = make_warmed_engine(cfg, params, max_batch=2, prompt_len=20,
                             max_new_tokens=4)
    assert eng.decode_graph_captures == eng.decode_graph_replays == 0
    for i in range(3):
        eng.submit(np.arange(5 + 7 * i) % cfg.vocab_size, 4, i)
    assert len(eng.run_until_idle()) == 3 and eng.decode_steps > 0
    assert eng.decode_graph_captures == eng.decode_graph_replays == 0


def test_engine_tokens_and_positions_keep_their_storage(smoke_model):
    """``tokens`` and ``positions`` are written in place, never
    reassigned: the buffers a captured decode step reads and writes are
    those every decode step and admission use."""
    cfg, _, params = smoke_model
    eng = InferenceEngine(cfg, params, max_batch=2, max_len=96)
    ptrs = (eng.tokens.data_ptr(), eng.positions.data_ptr())
    for i, n in enumerate((24, 9, 32)):
        eng.submit(np.arange(n) % cfg.vocab_size, 5, i)
    steps = 0
    while not eng.idle():
        eng.step()
        steps += 1
        assert (eng.tokens.data_ptr(), eng.positions.data_ptr()) == ptrs
    assert eng.prefill_count == 3 and steps > eng.prefill_count


def test_engine_reset_counters_zeroes_graph_replays(smoke_model):
    """``reset_counters`` zeroes the replays with the other step
    counters; the captures (one an engine) are never reset."""
    cfg, _, params = smoke_model
    eng = InferenceEngine(cfg, params, max_batch=1, max_len=64)
    eng.decode_graph_replays, eng.decode_graph_captures = 7, 1
    eng.decode_steps = 7
    eng.reset_counters()
    assert eng.decode_graph_replays == eng.decode_steps == 0
    assert eng.decode_graph_captures == 1


def _stub_run(mod_rt, backends, scenario):
    clock = mod_rt.VirtualClock()
    exp = scenario.compile()
    engines, factory = backends.build_stub_engines(exp, clock, 0)
    rt = mod_rt.EngineRuntime.from_experiment(
        exp, engines, engine_factory=factory, clock=clock, sleep=clock.sleep)
    rt.run()
    return rt


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


@pytest.mark.parametrize("name", ["steady", "server-failure",
                                  "elastic-autoscale", "churn-storm"])
def test_stub_engine_runtime_telemetry_equals_jax(name):
    kw = dict(duration=12.0)
    jax_rt = _stub_run(jrt, jbackends, jsc.get(name, **kw))
    port_rt = _stub_run(trt, tbackends, tsc.get(name, **kw))
    assert port_rt.dropped == jax_rt.dropped
    assert [i.kind for i in port_rt.unsupported] == \
        [i.kind for i in jax_rt.unsupported]
    want, got = jax_rt.telemetry.to_rows(), port_rt.telemetry.to_rows()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) <= set(w)
        diff = {k: (g[k], w[k]) for k in g if not _same(g[k], w[k])}
        assert not diff, diff
    jo, po = jax_rt.telemetry.overall(), port_rt.telemetry.overall()
    assert (po.n, po.mean, po.p50, po.p95, po.p99) == \
        (jo.n, jo.mean, jo.p50, jo.p95, jo.p99)
    assert port_rt.submitted == po.n + sum(port_rt.recorder.failures.values())


def test_stub_engine_matches_jax_stub_draws():
    from repro.core.profiles import tailbench_profile as jprofile
    from repro.serving.engine import StubEngine as JStub
    from repro_torch.core.profiles import tailbench_profile

    jc, tc = jrt.VirtualClock(), trt.VirtualClock()
    js = JStub(jprofile("xapian"), workers=2, service_noise=0.3, seed=4,
               clock=jc)
    ts = StubEngine(tailbench_profile("xapian"), workers=2,
                    service_noise=0.3, seed=4, clock=tc)
    for i in range(5):
        js.submit(None, 1, i)
        ts.submit(None, 1, i)
    jd, td = [], []
    while not js.idle():
        jd += js.step()
        td += ts.step()
    assert [(c.req_id, c.ttft, c.latency) for c in td] == \
        [(c.req_id, c.ttft, c.latency) for c in jd]
    assert ts.busy_time == js.busy_time and tc.t == jc.t


def test_engine_runtime_control_features_raise():
    """The control features no longer raise: ``retry``, ``breaker``,
    ``control`` and the four control injections are accepted and
    recorded as the reference's ``EngineRuntime`` records them."""
    from repro.control import BreakerSpec as JBreaker
    from repro.control import ControlSpec as JControl
    from repro.control import RetryPolicy as JRetry
    from repro.core.scenario import Injection as JInjection

    from repro_torch.control import BreakerSpec, ControlSpec, RetryPolicy
    from repro_torch.core.scenario import Injection

    def build(mod_rt, backends, mod_sc, **kw):
        clock = mod_rt.VirtualClock()
        exp = mod_sc.get("steady", duration=2.0).compile()
        engines, _ = backends.build_stub_engines(exp, clock)
        return mod_rt.EngineRuntime(engines, exp.clients, clock=clock, **kw)

    ctl = dict(interval=1.0, lag=2.0, cooldown=4.0, high=0.8)
    port = build(trt, tbackends, tsc, retry=RetryPolicy(max_retries=2),
                 breaker=BreakerSpec(window=10),
                 control=ControlSpec.make("threshold_autoscaler", **ctl))
    ref = build(jrt, jbackends, jsc, retry=JRetry(max_retries=2),
                breaker=JBreaker(window=10),
                control=JControl.make("threshold_autoscaler", **ctl))
    assert vars(port._retry) == vars(ref._retry)
    assert vars(port._retry_budget) == vars(ref._retry_budget)
    assert vars(port._breaker.spec) == vars(ref._breaker.spec)
    assert vars(port._control.spec) == vars(ref._control.spec)
    assert vars(port._control.policy) == vars(ref._control.policy)
    assert port._admission is ref._admission is None
    params = {"set_retry": ({"policy": RetryPolicy()},
                            {"policy": JRetry()}),
              "set_breaker": ({"spec": BreakerSpec()},
                              {"spec": JBreaker()}),
              "set_admission": ({"admit": 0.5}, {"admit": 0.5}),
              "set_scale": ({"n": 1}, {"n": 1})}
    for kind, (p_params, r_params) in params.items():
        port = build(trt, tbackends, tsc,
                     injections=[Injection(1.0, kind, p_params)])
        ref = build(jrt, jbackends, jsc,
                    injections=[JInjection(1.0, kind, r_params)])
        assert [(i.at, i.kind) for i in port._injections] == \
            [(i.at, i.kind) for i in ref._injections] == [(1.0, kind)]
        assert port.unsupported == ref.unsupported == []


def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_launch_serve_smoke_on_cpu():
    out = _run("repro_torch.launch.serve", "--arch", "phi3-mini-3.8b",
               "--smoke", "--device", "cpu", "--duration", "2", "--qps", "6")
    line = [ln for ln in out.splitlines() if ln.startswith("serve: ")]
    rep = json.loads(line[-1][len("serve: "):])
    assert rep["n"] == rep["submitted"] > 0 and rep["dropped"] == 0
    assert rep["decode_steps"] > 0 and rep["tokens"] >= 4 * rep["n"]
    for key in ("p50_ms", "p99_ms", "ttft_p50_ms", "decode_step_ms",
                "tokens_per_s"):
        assert math.isfinite(rep[key]) and rep[key] > 0, key


def test_scenarios_cli_engine_backend_on_cpu():
    from repro_torch.scenarios.__main__ import main
    assert main(["server-failure", "--backend", "engine", "--stub",
                 "--duration", "6"]) == 0
    # steady offers 800 requests/s: a 50 ms horizon keeps the CPU run short
    assert main(["steady", "--backend", "engine", "--arch", "phi3-mini-3.8b",
                 "--smoke", "--device", "cpu", "--duration", "0.05"]) == 0


def test_port_sources_import_neither_jax_nor_repro():
    """Grep of every module of the port, of its benchmark twins and of
    chip_smoke.py."""
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)\b", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "benchmarks" / "torch_port").glob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    bad = {str(f.relative_to(ROOT)): pat.findall(f.read_text())
           for f in files}
    assert not {f: m for f, m in bad.items() if m}
