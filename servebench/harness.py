"""One run of a cell: the program under test, driven as a user drives it.

``setup`` draws the configuration's weights on the device from the seed
(``weights.py``), builds the cell's ``InferenceEngine`` replicas over
one copy of them with ``repro_torch.serving.engine.make_warmed_engine``
and warms every prefill bucket the mix reaches.  ``serve`` runs
``repro_torch.core.runtime.EngineRuntime`` over them with the mix's
clients, policy and sizes (``traffic.py``) for the window, then lets it
drain every admitted request, as the runtime does.  The benchmark's
spans sit around the calls into the program: ``StepLog`` wraps each
replica's ``step()`` (what the step did: the prompts it prefilled or
the live slots' cache lengths it decoded, host-clock start and end),
and ``ServeRuntime`` keeps each completion with its due time and counts
a request that an engine lost as unserved.  With a ``Tracer``,
``torch.profiler`` records the window's last fifth (``trace.py`` reduces
it).
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from servebench import traffic as TR
from servebench.e2e import Served
from servebench.weights import Weights

#: the traced slice runs from this share of the window to its close
TRACE_FROM = 0.8


def port_config(config: dict):
    """The program's config of ``config["arch"]``, checked against the
    sizes the configuration file states."""
    from repro_torch.configs.base import get_config
    cfg = get_config(config["arch"])
    have = {"hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.resolved_head_dim,
            "num_hidden_layers": cfg.num_layers,
            "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
            "sliding_window": cfg.sliding_window,
            "tie_word_embeddings": cfg.tie_embeddings}
    wrong = {k: (v, config[k]) for k, v in have.items() if config[k] != v}
    if wrong or cfg.resolved_pattern != ("attn",) or cfg.moe is not None:
        raise ValueError(f"{config['arch']}: the program's config differs "
                         f"from the file (program, file): {wrong}")
    return cfg


def weight_specs(cfg, dtype: torch.dtype) -> dict:
    """The program's parameter layout as ``{path: (shape, dtype, init,
    scale)}``, its bf16 leaves in ``dtype``."""
    from repro_torch.models import param as P
    from repro_torch.models import registry as R
    out = {}
    for path, s in P.leaves(R.model_specs(cfg)):
        dt = dtype if s.dtype == torch.bfloat16 else s.dtype
        out[path] = (tuple(s.shape), dt, s.init, s.scale)
    return out


class StepLog:
    """A replica as the runtime sees it, with what each ``step()`` did
    recorded: ``(replica, kind, start, end, info)``, times on the host
    clock from the window's start.  What a step did is read off the
    engine after it, not foreseen: the change in its ``prefill_count``
    and ``decode_steps``, and which requests gained a token.  A request
    that had none was prefilled (``kind`` "prefill", ``info`` the prompt
    lengths); one that had some was decoded (``kind`` "decode", ``info``
    the keys each live slot attended, its prompt and its tokens before
    the step).  A step that did both, or anything else these cannot
    account for, raises: the metrics that read the log would miscount."""

    def __init__(self, engine, sid: int, log: list, clock, tracer=None):
        self._engine = engine
        self._sid = sid
        self._log = log
        self._clock = clock
        self._tracer = tracer

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def step(self):
        eng = self._engine
        if eng.idle():
            return eng.step()
        reqs = [r for r in (*eng.queue, *eng.active) if r is not None]
        before = [len(r.tokens_out) for r in reqs]
        counters = (eng.prefill_count, eng.decode_steps)
        tr = self._tracer
        t0 = self._clock()
        if tr is not None and tr.on:
            with torch.profiler.record_function(
                    f"sb.step.{self._sid}.{len(self._log)}"):
                out = eng.step()
        else:
            out = eng.step()
        t1 = self._clock()
        grew = [(r, n) for r, n in zip(reqs, before)
                if len(r.tokens_out) != n]
        prefilled = tuple(len(r.prompt) for r, n in grew if n == 0)
        decoded = tuple(len(r.prompt) + n for r, n in grew if n)
        prefills = eng.prefill_count - counters[0]
        decodes = eng.decode_steps - counters[1]
        if (any(len(r.tokens_out) != n + 1 for r, n in grew)
                or (prefilled and decoded) or prefills != len(prefilled)
                or decodes != (1 if decoded else 0)):
            raise RuntimeError(
                f"replica {self._sid}: a step that the benchmark cannot "
                f"attribute: {prefills} prefills and {decodes} decode "
                f"steps counted, prompts {prefilled} prefilled and "
                f"{len(decoded)} requests decoded, tokens gained "
                f"{[len(r.tokens_out) - n for r, n in grew]}")
        kind = "prefill" if prefilled else "decode" if decoded else "none"
        self._log.append((self._sid, kind, t0, t1, prefilled or decoded))
        return out


class Tracer:
    """``torch.profiler`` over the window from ``start`` to its close:
    opened and closed between two passes of the runtime's loop.  Closing
    the profiler processes its events for seconds; it closes once every
    request has been handed to an engine, so that stall lands on the
    drain and on no request's lag.  ``warm`` opens and closes the
    profiler once in set-up, so that opening it in the window costs
    little."""

    def __init__(self, start: float, device: str):
        self.start = start
        self.device = device
        self.prof = None
        self.on = False
        self.window = None            # host seconds traced

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        p = self._profile()
        p.start()
        torch.ones(8, device=self.device).sum().item()
        p.stop()

    def tick(self, now: float, closed: bool) -> None:
        """Open at ``start``; close once the window has ``closed``."""
        if not self.on and self.prof is None and now >= self.start:
            self.prof = self._profile()
            self.prof.start()
            self.on = True
            self._t0 = time.perf_counter()
        elif self.on and closed:
            self.close()

    def close(self) -> None:
        if self.on:
            self.window = time.perf_counter() - self._t0
            self.prof.stop()
            self.on = False


def _runtime_class():
    from repro_torch.core.runtime import EngineRuntime

    class ServeRuntime(EngineRuntime):
        """``EngineRuntime`` that keeps each completion with its due
        time and the sizes it was submitted with."""

        def run(self):
            self.t0 = self._clock()
            self.served = {}
            self.lost = []
            return super().run()

        def _drain_gauges(self, now):
            # called once a pass of the loop, between engine steps; the
            # window has closed once every client has sent its last
            # request (``_client_done`` drops it from ``_gens``)
            closed = now >= self.duration and not self._gens
            if self.tracer is not None:
                self.tracer.tick(now, closed)
            if (closed and self._meta and all(
                    h.engine.idle() for h in self.handles.values())):
                # every request is submitted straight to an engine, so one
                # that no engine holds and none completed was lost there:
                # it counts as unserved, and the loop, which would wait
                # for it for ever, ends
                self.lost.extend(sorted(self._meta))
                self._meta.clear()
            super()._drain_gauges(now)

        def _complete(self, handle, comp, wall):
            meta = self._meta.get(comp.req_id)
            if meta is not None:
                self.served[comp.req_id] = (meta[1], wall, comp, meta[4],
                                            meta[5])
            super()._complete(handle, comp, wall)

    return ServeRuntime


@dataclass
class Setup:
    cell: object
    cfg: object                 # the program's ArchConfig
    weights: Weights
    engines: list
    device: str


def setup(cell, seed: int, device: str) -> Setup:
    from repro_torch.serving.engine import make_warmed_engine
    cfg = port_config(cell.config)
    dtype = getattr(torch, cell.config["torch_dtype"])
    w = Weights(weight_specs(cfg, dtype), seed, device)
    params = w.tree()
    tr = cell.traffic
    lens = tr["lengths"]
    pmax, nmax = int(lens["prompt_max"]), int(lens["new_max"])
    engines = [make_warmed_engine(cfg, params, max_batch=tr["max_batch"],
                                  prompt_len=pmax, max_new_tokens=nmax)
               for _ in range(tr["replicas"])]
    if engines[0].max_len != TR.max_len(tr):
        raise ValueError(f"engine cache length {engines[0].max_len}, "
                         f"mix {TR.max_len(tr)}")
    # every bucket this mix's prompt law reaches, out to its 1e-4
    # quantiles (a run's sizes are quantiles of that law)
    reached = TR.sizes(lens["prompt_median"], lens["prompt_sigma"], pmax,
                       10_000)
    warmed = set(TR.buckets(tr, [pmax]))
    eng = engines[0]
    for b in TR.buckets(tr, np.unique(reached)):
        if b not in warmed:
            eng.submit(np.arange(min(b, pmax)) % cfg.vocab_size, 2, -1)
            eng.run_until_idle()
    for e in engines:
        e.reset_counters()
    if device == "cuda":
        torch.cuda.synchronize()
    return Setup(cell, cfg, w, engines, device)


@dataclass
class Record:
    """What one window served, for the metrics and the check."""
    config: dict
    arrivals: list
    served: dict = field(default_factory=dict)   # rid -> Served
    tokens: dict = field(default_factory=dict)   # rid -> [token ids]
    sizes: dict = field(default_factory=dict)    # rid -> (prompt, new)
    steps: list = field(default_factory=list)    # StepLog entries
    engines: list = field(default_factory=list)  # counters per replica
    frames: list = field(default_factory=list)   # (t, total queue depth)
    lost: list = field(default_factory=list)     # rids no engine returned
    trace: dict | None = None


def serve(st: Setup, rate: float, seconds: float, seed: int,
          tracer: Tracer | None = None) -> Record:
    from repro_torch.core.client import ClientConfig, ConstantQPS
    tr = st.cell.traffic
    arrivals = TR.schedule(tr, rate, seconds, seed)
    n_cl = int(tr["clients"])
    for e in st.engines:
        e.reset_counters()
    clients = [ClientConfig(c, ConstantQPS(rate / n_cl)) for c in
               range(n_cl)]
    rt = _runtime_class()(
        [], clients, policy=tr["policy"], duration=seconds,
        vocab=st.cfg.vocab_size, seed=int(seed), interval=1.0)
    rt.tracer = tracer
    rt._gens = {c: TR.ScheduledClient([a for a in arrivals
                                       if a.client == c])
                for c in range(n_cl)}
    log: list = []

    def clock():
        return time.monotonic() - rt.t0

    from repro_torch.core.runtime import EngineServerHandle
    rt.handles = {i: EngineServerHandle(i, StepLog(e, i, log, clock,
                                                   tracer))
                  for i, e in enumerate(st.engines)}
    rt._rebuild_alive()
    rt.run()
    if tracer is not None:
        tracer.close()
    rec = Record(st.cell.config, arrivals, steps=log, lost=rt.lost)
    for rid, (due, wall, comp, ptoks, mnew) in rt.served.items():
        rec.served[rid] = Served(rid, due, wall, comp.ttft, comp.latency,
                                 len(comp.tokens))
        rec.tokens[rid] = list(comp.tokens)
        rec.sizes[rid] = (ptoks, mnew)
    rec.engines = [{"prefill_count": e.prefill_count,
                    "prefill_seconds": e.prefill_seconds,
                    "decode_steps": e.decode_steps,
                    "decode_seconds": e.decode_seconds}
                   for e in st.engines]
    rec.frames = [(f.t, sum(f.qdepth.values()))
                  for f in rt.telemetry.frames()]
    for e in st.engines:
        e.completed.clear()
    return rec


def free(st: Setup) -> None:
    """Drop the replicas (their caches) and keep the weights."""
    st.engines.clear()
    gc.collect()
    if st.device == "cuda":
        torch.cuda.empty_cache()
