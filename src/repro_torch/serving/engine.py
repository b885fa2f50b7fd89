"""Batched inference engine with continuous batching.

Copy of ``repro.serving.engine`` in PyTorch.  Slot-based: ``max_batch``
sequences decode together; free slots are refilled by prefilling queued
prompts (prompt lengths are bucket-padded, as the reference does to
bound its jit recompiles, except for models with Mamba or
sliding-window layers, which prefill at the prompt's exact length: a
Mamba state would absorb the pads, and a prompt padded past the window
would put pad tokens in the ring and drop real keys).  Step-driven so
the TailBench++
harness can drive it in real time: each ``step()`` performs one prefill
(if a request is waiting and a slot is free) or one batched decode
step, and returns completion events.

It serves token prompts: a model with a patch frontend (llava) is
served without an image prefix, as the reference's engine serves it, and
an encoder-decoder model (whisper), whose prefill needs its encoder's
input, is refused (the reference's engine fails at its first admission;
such a model runs through ``registry.prefill`` and ``decode_step``).

The engine runs where its parameters lie: on the card, prefill and
decode go through the CUDA attention kernels.  Its decode cache is
updated in place: a decode step writes every slot's new K/V into it,
and an admitted prompt's prefill cache is copied into its slot (the JAX
engine donates the cache to a jitted decode and scatters a new one).
Inactive slots keep decoding and advancing their positions, as in the
reference; their tokens are ignored.  Every ``step()`` ends by reading
the chosen tokens back to the host, so it returns only after the card
is done and latencies are real.

On one card (a CUDA device, parameters that are not DTensors) the decode
step is one CUDA graph: the model's decode step, the argmax into
``tokens`` and the position update, captured once an eager step has
initialised the libraries (``make_warmed_engine`` captures at the end of
its warm-up, an engine built directly at its second decode step) and
replayed at every later step, with the same kernels on the same buffers
as the eager step.  ``tokens``, ``positions`` and the cache are written
in place and never reassigned, so an admission between two replays is
seen by the next one.  On the CPU and under a mesh the step runs
eagerly.  ``decode_graph_captures`` counts the captures (never reset),
``decode_graph_replays`` the replays; the kernel wrappers' ``launches``
counters count calls issued to the card: a capture adds none, each
replay the launches recorded at its capture.

Given a ``repro_torch.core.spans.SpanLog`` in ``spans``, the engine
records its layer boundaries there: a ``submit`` event (``req_id``); a
``prefill`` span a prompt (``req_id``, ``L``, ``bucket``) holding
``prefill.enqueue`` (the model's prefill call); a ``decode`` span a step
(``rows``, the batch it computes, and ``live``, each live slot's
``(req_id, keys attended)``) holding ``decode.enqueue`` (the model's
decode step, the argmax and the position update, or the replay of their
CUDA graph).  A step span ends at the clock read that ends its step
counter, so the ``prefill`` and ``decode`` spans sum to
``prefill_seconds`` and ``decode_seconds``.

``StubEngine`` and ``BatchedStubEngine`` are the engine protocol without
a model: profile-timed slots, and the simulator's continuous-batching
op sequencer (``BatchScheduler``) on a wall or virtual clock.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN_SWA, MAMBA, ArchConfig
from repro_torch.core.profiles import BatchScheduler, apply_service_noise
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import param as P
from repro_torch.models import registry as R

#: the kernel wrappers a model step launches; each counts its calls in
#: attributes named ``*launches``
_KERNELS = (decode_attention, flash_attention, ssd_scan)


def _launch_counts() -> dict:
    return {(k, a): n for k in _KERNELS for a, n in vars(k).items()
            if a.endswith("launches")}


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray             # (L,) int32
    max_new_tokens: int
    submitted_at: float = 0.0
    prefilled_at: Optional[float] = None
    tokens_out: list = field(default_factory=list)


@dataclass
class Completion:
    req_id: int
    tokens: list
    ttft: float                    # time to first token (from submit)
    latency: float                 # total sojourn


class StubEngine:
    """Engine-protocol stand-in: no model, just timed service slots.

    Serves each request after a profile-sampled service time on one of
    ``workers`` parallel slots — the wall-clock analogue of the
    simulator's server.  Lets ``EngineRuntime`` and the scenario CLI
    exercise the real-time path without weights.  With a clock that
    exposes ``advance_to`` (``repro_torch.core.runtime.VirtualClock``),
    ``step()`` jumps virtual time to the next completion the way a real
    engine's blocking decode step consumes wall time.
    """

    def __init__(self, profile, *, workers: int = 1, speed: float = 1.0,
                 service_noise: float = 0.0, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.profile = profile
        self.max_batch = workers
        self.speed = speed
        self.service_noise = service_noise
        self.clock = clock
        self._rng = np.random.default_rng((9176, 0x57AB, seed))
        self.queue: deque[tuple] = deque()      # (req_id, submitted_at)
        self.active: dict[int, tuple] = {}      # req_id -> (finish, start, submit)
        self.total_served = 0
        self.busy_time = 0.0                    # accrued service seconds

    def submit(self, prompt, max_new_tokens: int, req_id: int) -> None:
        self.queue.append((req_id, self.clock()))

    def pending(self) -> int:
        return len(self.queue)

    def n_active(self) -> int:
        return len(self.active)

    def idle(self) -> bool:
        return not self.queue and not self.active

    def step(self) -> list[Completion]:
        now = self.clock()
        done = []
        for rid, (finish, start, submit) in list(self.active.items()):
            if finish <= now:
                del self.active[rid]
                done.append(Completion(rid, [], ttft=start - submit,
                                       latency=finish - submit))
                self.total_served += 1
        while self.queue and len(self.active) < self.max_batch:
            rid, submit = self.queue.popleft()
            dur = apply_service_noise(
                self.profile.sample(self._rng) / self.speed,
                self.service_noise, self._rng)
            self.busy_time += dur
            self.active[rid] = (now + dur, now, submit)
        if not done and self.active and hasattr(self.clock, "advance_to"):
            # mimic a blocking decode step: consume (virtual) time up to
            # the earliest in-flight completion
            self.clock.advance_to(min(f for f, _, _ in self.active.values()))
        return done


class BatchedStubEngine:
    """Engine-protocol stand-in with continuous-batching dynamics.

    Where ``StubEngine`` times each request on an independent slot, this
    drives the shared ``BatchScheduler`` op sequencer against a
    ``BatchedService`` cost model: the code the simulator's batched
    server runs in virtual time.  A decode step costs
    ``max(compute x batch, memory)`` and a prefill is proportional to
    the prompt, so throughput saturates with occupancy as
    ``InferenceEngine``'s does, and as the simulator predicts.

    With a clock exposing ``advance_to`` (``VirtualClock``), ``step()``
    consumes virtual time up to the in-flight op's end, the way a real
    engine's blocking decode step consumes wall time.
    """

    serializes_ops = True        # one op at a time: utilization is per
                                 # engine, not per batch slot

    def __init__(self, service, *, max_batch: int = 8, speed: float = 1.0,
                 service_noise: float = 0.0, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.service = service
        self.max_batch = max_batch
        self.speed = speed
        # per-op multiplicative log-normal noise, as the simulator's
        # batched server applies it
        self.service_noise = service_noise
        self.clock = clock
        self._rng = np.random.default_rng((9176, 0xBA7C, seed))
        self.core = BatchScheduler(service, max_batch)
        self._submit_at: dict[int, float] = {}
        self._prefilled: dict[int, float] = {}
        self._op_end: Optional[float] = None
        # the engine's own timeline: ops chain back to back on it even
        # when step() polls late (a shared VirtualClock advanced by a
        # sibling replica); otherwise every poll gap would be billed as
        # idle time and the replica would lose throughput
        self._t = clock()
        self.total_served = 0
        self.busy_time = 0.0                    # accrued op seconds

    @property
    def tokens_done(self) -> int:
        return self.core.tokens_done

    def submit(self, prompt, max_new_tokens: int, req_id: int) -> None:
        self._submit_at[req_id] = self.clock()
        self.core.submit(req_id, len(prompt), max_new_tokens)

    def pending(self) -> int:
        return self.core.pending()

    def n_active(self) -> int:
        return self.core.occupancy()

    def idle(self) -> bool:
        return self._op_end is None and self.core.idle()

    def step(self) -> list[Completion]:
        now = self.clock()
        done: list[Completion] = []
        # replay the engine's background execution up to ``now``: finish
        # due ops and chain the next one at the op boundary (never at the
        # poll instant), admitting only requests submitted by that
        # boundary, so op timing is the simulator's serve loop's
        while True:
            if self._op_end is not None:
                if self._op_end > now:
                    break
                end = self._op_end
                self._op_end = None
                self._t = end
                if self.core.op[0] == "prefill":
                    self._prefilled[self.core.op[1].key] = end
                for rid in self.core.finish_op():
                    sub = self._submit_at.pop(rid)
                    first = self._prefilled.pop(rid, end)
                    done.append(Completion(rid, [], ttft=first - sub,
                                           latency=end - sub))
                    self.total_served += 1
            t_op = self._t
            if not self.core.active and self.core.waiting:
                # idle engine: the next op starts when its head arrived
                t_op = max(t_op, self._submit_at[self.core.waiting[0].key])
            dur = self.core.start_op(
                ready=lambda rid: self._submit_at[rid] <= t_op)
            if dur is None:
                break
            dur = apply_service_noise(dur / self.speed, self.service_noise,
                                      self._rng)
            self.busy_time += dur
            self._t = t_op
            self._op_end = t_op + dur
        if not done and self._op_end is not None \
                and hasattr(self.clock, "advance_to"):
            # mimic a blocking engine op: consume (virtual) time up to
            # its end so the runtime's poll loop makes progress
            self.clock.advance_to(self._op_end)
        return done


def make_warmed_engine(cfg: ArchConfig, params, *, max_batch: int = 4,
                       prompt_len: int = 16,
                       max_new_tokens: int = 4) -> "InferenceEngine":
    """Build an InferenceEngine sized for the harness's request shape and
    run one request through it (prefill and decode, building the CUDA
    kernels on first use), so measured latency is serving, not set-up.
    Its counters start at zero after the warm-up."""
    eng = InferenceEngine(cfg, params, max_batch=max_batch,
                          max_len=prompt_len + max_new_tokens + 32)
    eng.submit(np.arange(prompt_len) % cfg.vocab_size, 2, -1)
    eng.run_until_idle()
    eng._maybe_capture()
    eng.reset_counters()
    return eng


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 4095) // 4096) * 4096


class InferenceEngine:
    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 max_len: int = 512,
                 clock: Callable[[], float] = time.monotonic):
        if cfg.enc_dec:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder model: its prefill needs "
                f"the encoder's input (batch['frames']), and the engine "
                f"serves token prompts only; run it through "
                f"registry.prefill and registry.decode_step")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.clock = clock
        self.device = params["final_norm"]["scale"].device
        # batched decode cache (leading dims: groups, batch); zeros and
        # empty (-1) positions, no random draw
        self.cache = P.init_tree(R.cache_specs(cfg, max_batch, max_len),
                                 torch.Generator(), self.device)
        self.positions = torch.zeros((max_batch,), dtype=torch.int32,
                                     device=self.device)
        self.tokens = torch.zeros((max_batch,), dtype=torch.int32,
                                  device=self.device)
        self.active: list[Optional[Request]] = [None] * max_batch
        self.queue: list[Request] = []
        # a mamba state or a sliding-window ring needs exact-length
        # prefill (no pads)
        self._exact_prefill = any(k in (MAMBA, ATTN_SWA)
                                  for k in cfg.resolved_pattern)
        self.completed: list[Completion] = []
        self.spans = None              # a SpanLog records the steps' spans
        # one CUDA graph a decode step on one card; captured after an
        # eager step has run
        self._graphable = self.device.type == "cuda" and not any(
            is_dtensor(t) for _, t in P.leaves(params))
        self._stepped = False
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches: dict = {}
        self.decode_graph_captures = 0
        self.reset_counters()

    def reset_counters(self) -> None:
        """Zero the step counters and timers (after a warm-up)."""
        self.decode_steps = 0
        self.decode_graph_replays = 0
        self.prefill_count = 0
        self.tokens_done = 0           # tokens generated for live requests
        self.decode_seconds = 0.0      # host clock, each step ends synced
        self.prefill_seconds = 0.0
        self.completed.clear()

    # ------------------------------------------------------------------ api
    def submit(self, prompt: np.ndarray, max_new_tokens: int, req_id: int):
        req = Request(req_id, np.asarray(prompt, np.int32), max_new_tokens,
                      submitted_at=self.clock())
        self.queue.append(req)
        if self.spans is not None:
            t = time.perf_counter()
            self.spans.add("submit", t, t, req_id=req_id)

    def pending(self) -> int:
        return len(self.queue)

    def n_active(self) -> int:
        return sum(r is not None for r in self.active)

    def idle(self) -> bool:
        return not self.queue and self.n_active() == 0

    def step(self) -> list[Completion]:
        """One scheduler iteration. Prefill-priority continuous batching."""
        done: list[Completion] = []
        if self.queue and None in self.active:
            self._admit(self.queue.pop(0), self.active.index(None))
        elif self.n_active():
            done = self._decode_once()
        return done

    def run_until_idle(self, max_steps: int = 100_000) -> list[Completion]:
        out = []
        for _ in range(max_steps):
            if self.idle():
                break
            out.extend(self.step())
        return out

    # ------------------------------------------------------------- internals
    def _admit(self, req: Request, slot: int):
        spans = self.spans
        t0 = time.perf_counter()
        L = len(req.prompt)
        bucket = L if self._exact_prefill else min(_bucket(L), self.max_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :L] = req.prompt           # right-pad; pads masked via positions
        logits, cache1, _ = R.prefill(
            self.cfg, self.params,
            {"tokens": torch.from_numpy(toks).to(self.device)}, self.max_len,
            lengths=torch.tensor([L], dtype=torch.int32, device=self.device))
        t1 = time.perf_counter() if spans is not None else 0.0
        first = int(torch.argmax(logits[0]))          # waits for the card
        for name, entry in cache1.items():
            for leaf, c in entry.items():
                self.cache[name][leaf][:, slot].copy_(c[:, 0])
        self.positions[slot] = L
        self.tokens[slot] = first
        req.tokens_out.append(first)
        req.prefilled_at = self.clock()
        self.active[slot] = req
        self.prefill_count += 1
        self.tokens_done += 1
        end = time.perf_counter()
        self.prefill_seconds += end - t0
        if spans is not None:
            p = spans.add("prefill", t0, end, req_id=req.req_id, L=L,
                          bucket=bucket)
            spans.add("prefill.enqueue", t0, t1, p)
        self._maybe_finish(slot)

    def _decode_step(self) -> None:
        """The model's decode step, the argmax into ``tokens`` and the
        position update, all in place (what the CUDA graph holds)."""
        logits, _ = R.decode_step(self.cfg, self.params, self.cache,
                                  self.tokens, self.positions)
        self.tokens.copy_(torch.argmax(logits, dim=-1))
        self.positions += 1

    def _maybe_capture(self) -> None:
        """Capture ``_decode_step`` as this engine's CUDA graph, once, on
        one card and after an eager step (cuBLAS and the kernels'
        libraries initialised).  The capture records and runs nothing:
        the launch counters are put back and each replay adds what it
        recorded."""
        if self._graph is not None or not (self._graphable
                                           and self._stepped):
            return
        kept = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(graph):
            self._decode_step()
        self._graph_launches = {key: n - kept[key]
                                for key, n in _launch_counts().items()}
        for (k, a), n in kept.items():
            setattr(k, a, n)
        self._graph = graph
        self.decode_graph_captures += 1

    def _decode_once(self) -> list[Completion]:
        spans = self.spans
        t0 = time.perf_counter()
        self._maybe_capture()
        if self._graph is None:
            self._decode_step()
            self._stepped = True
        else:
            self._graph.replay()          # on the current stream
            for (k, a), n in self._graph_launches.items():
                setattr(k, a, getattr(k, a) + n)
            self.decode_graph_replays += 1
        self.decode_steps += 1
        t1 = time.perf_counter() if spans is not None else 0.0
        toks = self.tokens.cpu().numpy()              # waits for the card
        end = time.perf_counter()
        self.decode_seconds += end - t0
        if spans is not None:
            # a live slot attended its prompt and every token it has
            d = spans.add("decode", t0, end, rows=self.max_batch,
                          live=[(r.req_id, len(r.prompt) + len(r.tokens_out))
                                for r in self.active if r is not None])
            spans.add("decode.enqueue", t0, t1, d)
        done = []
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            req.tokens_out.append(int(toks[slot]))
            self.tokens_done += 1
            c = self._maybe_finish(slot)
            if c:
                done.append(c)
        return done

    def _maybe_finish(self, slot: int) -> Optional[Completion]:
        req = self.active[slot]
        if req and len(req.tokens_out) >= req.max_new_tokens:
            now = self.clock()
            c = Completion(req.req_id, req.tokens_out,
                           ttft=req.prefilled_at - req.submitted_at,
                           latency=now - req.submitted_at)
            self.completed.append(c)
            self.active[slot] = None
            return c
        return None
