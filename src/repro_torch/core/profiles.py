"""Service-time profiles and the ServiceModel layer the vector runtime
costs requests with.

Trimmed copy of ``repro.core.profiles``:

* the eight TailBench applications as truncated log-normal service
  laws (``LogNormalProfile``), plus ``FixedProfile``;
* ``TokenLengths``, the per-request prompt / output token law;
* ``ScalarService`` (one worker slot per request) and
  ``BatchedService`` (continuous batching, one decode step costs
  ``max(t_compute_per_seq * batch, t_memory)`` seconds);
* ``apply_service_noise``, the execution-noise law of the simulator's
  servers and the stub engines;
* ``BatchScheduler``, the prefill-priority continuous-batching op
  sequencer the simulator's batched servers drive.

``BatchedService.from_arch`` calibrates the batched service from a
registered architecture's parameter count on the H100's datasheet
figures (``repro_torch.launch.mesh``), and ``arch_profile`` gives an
architecture's scalar serving profile from the roofline's decode step
(``launch.roofline.decode_step_time_fallback``: one card).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


def _phi(x: float) -> float:
    """Standard normal CDF."""
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


@dataclass(frozen=True)
class LogNormalProfile:
    """Median service time + heavy right tail (sigma in log space)."""
    name: str
    median: float                  # seconds
    sigma: float = 0.45
    max_factor: float = 30.0       # truncate the tail (bounded work)

    def sample(self, rng: np.random.Generator) -> float:
        x = self.median * math.exp(self.sigma * rng.standard_normal())
        return float(min(x, self.median * self.max_factor))

    def sample_batch(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Vectorized draw of the truncated law (bulk RNG stream)."""
        x = self.median * np.exp(self.sigma * rng.standard_normal(n))
        return np.minimum(x, self.median * self.max_factor)

    def moments(self) -> tuple[float, float]:
        """Exact (mean, variance) of the truncated law ``min(X, M)``."""
        m, s, M = self.median, self.sigma, self.median * self.max_factor
        if s == 0.0:
            return min(m, M), 0.0
        a = math.log(M / m) / s
        e1 = m * math.exp(s * s / 2.0) * _phi(a - s) + M * (1.0 - _phi(a))
        e2 = (m * m * math.exp(2.0 * s * s) * _phi(a - 2.0 * s)
              + M * M * (1.0 - _phi(a)))
        return e1, max(e2 - e1 * e1, 0.0)

    @property
    def mean(self) -> float:
        """Mean of the untruncated log-normal law."""
        return self.median * math.exp(self.sigma ** 2 / 2)


@dataclass(frozen=True)
class FixedProfile:
    name: str
    value: float

    def sample(self, rng) -> float:
        return self.value

    def sample_batch(self, rng, n: int) -> np.ndarray:
        return np.full(n, self.value)

    def moments(self) -> tuple[float, float]:
        return float(self.value), 0.0

    @property
    def mean(self) -> float:
        return self.value


# The eight TailBench applications (service-time scales from the paper:
# Table 1 range 10us-10s; relative ordering from Fig. 4's per-app axes).
TAILBENCH_APPS: dict[str, LogNormalProfile] = {
    "masstree": LogNormalProfile("masstree", 120e-6, 0.35),
    "silo": LogNormalProfile("silo", 300e-6, 0.40),
    "xapian": LogNormalProfile("xapian", 1.2e-3, 0.50),
    "img-dnn": LogNormalProfile("img-dnn", 1.5e-3, 0.35),
    "specjbb": LogNormalProfile("specjbb", 1.0e-3, 0.45),
    "shore": LogNormalProfile("shore", 4.0e-3, 0.70),
    "moses": LogNormalProfile("moses", 60e-3, 0.55),
    "sphinx": LogNormalProfile("sphinx", 1.0, 0.50),
}


def tailbench_profile(app: str) -> LogNormalProfile:
    return TAILBENCH_APPS[app]


def apply_service_noise(dur: float, sigma: float, rng) -> float:
    """Multiplicative log-normal execution noise; draws from ``rng`` only
    when ``sigma > 0`` (zero noise consumes no stream)."""
    if sigma > 0.0:
        dur *= float(np.exp(sigma * rng.standard_normal()))
    return dur


@dataclass(frozen=True)
class TokenLengths:
    """Per-request size distribution: log-normal prompt and output token
    counts (median + log-sigma), truncated to [1, max]."""
    prompt_median: float = 128.0
    prompt_sigma: float = 0.6
    new_median: float = 32.0
    new_sigma: float = 0.5
    prompt_max: int = 2048
    new_max: int = 512

    def sample(self, rng: np.random.Generator) -> tuple[int, int]:
        z1, z2 = rng.standard_normal(2)
        p = self.prompt_median * math.exp(self.prompt_sigma * z1)
        n = self.new_median * math.exp(self.new_sigma * z2)
        return (max(1, min(int(p), self.prompt_max)),
                max(1, min(int(n), self.new_max)))

    def sample_batch(self, rng: np.random.Generator,
                     n: int) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized size draws of the clipped-integer law
        ``max(1, min(int(x), max))``."""
        z = rng.standard_normal((2, n))
        p = self.prompt_median * np.exp(self.prompt_sigma * z[0])
        m = self.new_median * np.exp(self.new_sigma * z[1])
        return (np.clip(p.astype(np.int64), 1, self.prompt_max),
                np.clip(m.astype(np.int64), 1, self.new_max))

    @staticmethod
    def int_pmf(median: float, sigma: float,
                vmax: int) -> tuple[np.ndarray, np.ndarray]:
        """(support [1..vmax], pmf) of ``max(1, min(int(X), vmax))``
        for log-normal X, from CDF differences.  ``sigma == 0`` is a
        point mass."""
        ks = np.arange(1, vmax + 1, dtype=float)
        pmf = np.zeros(vmax)
        if sigma == 0.0:
            pmf[max(1, min(int(median), vmax)) - 1] = 1.0
            return ks, pmf
        # P(result <= k) = P(X < k+1) for k < vmax, 1 at vmax
        upper = np.array([_phi(math.log((k + 1.0) / median) / sigma)
                          for k in ks[:-1]] + [1.0])
        return ks, np.diff(np.concatenate([[0.0], upper]))

    @staticmethod
    def _int_moments(median: float, sigma: float,
                     vmax: int) -> tuple[float, float]:
        """Exact (mean, var) of the clipped integer law."""
        ks, pmf = TokenLengths.int_pmf(median, sigma, vmax)
        mean = float(pmf @ ks)
        return mean, max(float(pmf @ (ks * ks)) - mean * mean, 0.0)

    def moments(self) -> tuple[tuple[float, float], tuple[float, float]]:
        """((prompt mean, var), (new-token mean, var)) of the clipped
        integer laws."""
        return (self._int_moments(self.prompt_median, self.prompt_sigma,
                                  self.prompt_max),
                self._int_moments(self.new_median, self.new_sigma,
                                  self.new_max))

    @property
    def mean_new_tokens(self) -> float:
        """Mean of the untruncated log-normal output-token law."""
        return self.new_median * math.exp(self.new_sigma ** 2 / 2)


@dataclass(frozen=True)
class ScalarService:
    """One request = one worker slot for ``profile``-sampled seconds."""
    profile: object
    kind: str = field(default="scalar", init=False)

    def sample(self, rng) -> float:
        return self.profile.sample(rng)

    def sample_batch(self, rng, n: int):
        return self.profile.sample_batch(rng, n)

    def moments(self) -> tuple[float, float]:
        return self.profile.moments()

    @property
    def mean(self) -> float:
        return self.profile.mean

    @property
    def name(self) -> str:
        return getattr(self.profile, "name", "scalar")


@dataclass(frozen=True)
class BatchedService:
    """Continuous-batching service cost model.

    Per decode step the whole batch advances one token:
    ``step_time(b) = max(t_compute_per_seq * b, t_memory)``.  Prefill
    costs ``t_prefill_per_token * prompt_tokens`` seconds, floored at
    one weight pass (``t_memory``)."""
    name: str
    t_memory: float                      # s per decode step (streaming)
    t_compute_per_seq: float             # s per sequence per decode step
    t_prefill_per_token: float           # s per prompt token
    kind: str = field(default="batched", init=False)

    def step_time(self, batch: int) -> float:
        return max(self.t_compute_per_seq * max(batch, 1), self.t_memory)

    def prefill_time(self, prompt_tokens: int) -> float:
        return max(self.t_prefill_per_token * max(prompt_tokens, 1),
                   self.t_memory)

    def step_time_array(self, batch):
        """``step_time`` as an array op: the roofline step law the
        vector runtime applies per time slot."""
        return np.maximum(self.t_compute_per_seq * np.maximum(batch, 1),
                          self.t_memory)

    def prefill_time_array(self, prompt_tokens):
        return np.maximum(
            self.t_prefill_per_token * np.maximum(prompt_tokens, 1),
            self.t_memory)

    @property
    def ridge_batch(self) -> float:
        """Batch size where the step flips memory- to compute-bound."""
        return self.t_memory / self.t_compute_per_seq

    def service_rate(self, batch: int) -> float:
        """Tokens/sec the whole server sustains at occupancy ``batch``."""
        b = max(batch, 1)
        return b / self.step_time(b)

    @classmethod
    def from_arch(cls, arch: str, *, chips: int = 8) -> "BatchedService":
        """Calibrate from an architecture's roofline terms, as the
        reference does: memory = one pass over the active parameters (2
        bytes each) at the device memory rate, compute = 2*N_active
        FLOPs per token at the bf16 peak (prefill is compute-bound at
        the same per-token cost), spread over ``chips`` devices.  The
        rates are the H100's datasheet figures
        (``repro_torch.launch.mesh``), not the TPU v5e's."""
        from repro_torch.configs.base import get_config
        from repro_torch.launch import mesh
        from repro_torch.models import registry as R
        cfg = get_config(arch)
        n_active = R.count_params(cfg, active=True)
        t_mem = 2.0 * n_active / (chips * mesh.HBM_BW)
        t_comp = 2.0 * n_active / (chips * mesh.PEAK_FLOPS_BF16)
        return cls(f"batched:{arch}", t_mem, t_comp, t_comp)


def resolve_service_model(model, profile) -> "ScalarService | BatchedService":
    """``None`` means the scalar default wrapping the resolved profile."""
    if model is None:
        return ScalarService(profile)
    return model


# ---------------------------------------------------------------------------
# Shared continuous-batching op sequencer
# ---------------------------------------------------------------------------
@dataclass(slots=True)
class BatchItem:
    """One request inside a ``BatchScheduler`` (key is caller-opaque:
    a ``Request`` in the simulator, a req_id in the stub engine)."""
    key: object
    prompt_tokens: int
    remaining: int                       # new tokens still to emit


class BatchScheduler:
    """Prefill-priority continuous batching, one op at a time.

    Mirrors ``serving.engine.InferenceEngine.step()``: each op is either
    ONE prefill (a waiting request enters a free slot; its first token is
    emitted when the prefill finishes) or ONE batched decode step (every
    active sequence emits one token).  Requests whose token budget is
    exhausted complete at the end of the op that produced their last
    token.

    The class is clock-free: callers ask ``start_op`` for the next op's
    base duration (un-scaled by server speed/noise) and later apply it
    with ``finish_op``.  The simulator drives it from calendar-queue
    events; ``BatchedStubEngine`` drives it from a wall/virtual clock —
    identical dynamics by construction.
    """

    __slots__ = ("service", "max_batch", "waiting", "active", "tokens_done",
                 "op")

    def __init__(self, service: BatchedService, max_batch: int):
        self.service = service
        self.max_batch = max_batch
        self.waiting: deque[BatchItem] = deque()
        self.active: list[BatchItem] = []
        self.tokens_done = 0
        self.op: Optional[tuple] = None          # ("prefill", item) | ("decode",)

    # ---- submission / introspection ---------------------------------------
    def submit(self, key, prompt_tokens: int, max_new_tokens: int) -> None:
        self.waiting.append(BatchItem(key, max(int(prompt_tokens), 1),
                                      max(int(max_new_tokens), 1)))

    def pending(self) -> int:
        return len(self.waiting)

    def occupancy(self) -> int:
        """Sequences resident in the batch (incl. one mid-prefill)."""
        n = len(self.active)
        if self.op is not None and self.op[0] == "prefill":
            n += 1
        return n

    def idle(self) -> bool:
        return self.op is None and not self.waiting and not self.active

    # ---- op lifecycle ------------------------------------------------------
    def start_op(self, skip: Optional[Callable] = None,
                 ready: Optional[Callable] = None) -> Optional[float]:
        """Begin the next op; -> base duration in seconds, or None if
        there is nothing to do.  ``skip(key) -> bool`` drops waiting
        entries (hedge-cancelled twins) without admitting them;
        ``ready(key) -> bool`` holds back entries that have not arrived
        yet at the op's start instant (wall-clock replay) — a not-ready
        FIFO head falls through to a decode op, like the real engine
        seeing an empty queue."""
        if self.op is not None:       # survives python -O, unlike assert
            raise RuntimeError("previous op not finished")
        while self.waiting and len(self.active) < self.max_batch:
            item = self.waiting[0]
            if skip is not None and skip(item.key):
                self.waiting.popleft()
                continue
            if ready is not None and not ready(item.key):
                break
            self.waiting.popleft()
            self.op = ("prefill", item)
            return self.service.prefill_time(item.prompt_tokens)
        if self.active:
            self.op = ("decode", None)
            return self.service.step_time(len(self.active))
        return None

    def finish_op(self) -> list:
        """Apply the current op; -> keys of requests it completed."""
        kind, item = self.op
        self.op = None
        done = []
        if kind == "prefill":
            self.tokens_done += 1
            item.remaining -= 1
            if item.remaining <= 0:
                done.append(item.key)
            else:
                self.active.append(item)
        else:
            self.tokens_done += len(self.active)
            still = []
            for it in self.active:
                it.remaining -= 1
                if it.remaining <= 0:
                    done.append(it.key)
                else:
                    still.append(it)
            self.active = still
        return done

    def abort(self) -> list:
        """Drop every resident request (server failure); -> their keys.
        Waiting entries are the caller's to account for."""
        keys = [it.key for it in self.active]
        if self.op is not None and self.op[0] == "prefill":
            keys.append(self.op[1].key)
        self.active = []
        self.op = None
        return keys


def arch_profile(arch: str, *, tokens_out: int = 64,
                 step_time: float | None = None,
                 batch: int = 8) -> LogNormalProfile:
    """Serving profile for a registered architecture.

    ``step_time`` = per-decode-step seconds for the whole batch (by
    default ``launch.roofline.decode_step_time_fallback``: the active
    weights read once at one H100's HBM rate).  A request's demand ~
    tokens_out x step_time / batch with log-normal spread (sigma 0.6)
    over output lengths."""
    if step_time is None:
        from repro_torch.launch.roofline import decode_step_time_fallback
        step_time = decode_step_time_fallback(arch)
    median = tokens_out * step_time / batch
    return LogNormalProfile(f"arch:{arch}", median, 0.6)
