"""Service-time profiles and the ServiceModel layer the vector runtime
costs requests with.

Trimmed copy of ``repro.core.profiles``:

* the eight TailBench applications as truncated log-normal service
  laws (``LogNormalProfile``), plus ``FixedProfile``;
* ``TokenLengths``, the per-request prompt / output token law;
* ``ScalarService`` (one worker slot per request) and
  ``BatchedService`` (continuous batching, one decode step costs
  ``max(t_compute_per_seq * batch, t_memory)`` seconds).

``BatchedService`` has no ``from_arch`` here: calibrating it from a
model's roofline needs the model stack and the card's own figures,
which this package does not carry yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

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


@dataclass(frozen=True)
class FixedProfile:
    name: str
    value: float

    def sample_batch(self, rng, n: int) -> np.ndarray:
        return np.full(n, self.value)

    def moments(self) -> tuple[float, float]:
        return float(self.value), 0.0


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


@dataclass(frozen=True)
class ScalarService:
    """One request = one worker slot for ``profile``-sampled seconds."""
    profile: object
    kind: str = field(default="scalar", init=False)


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

    def prefill_time_array(self, prompt_tokens):
        return np.maximum(
            self.t_prefill_per_token * np.maximum(prompt_tokens, 1),
            self.t_memory)


def resolve_service_model(model, profile) -> "ScalarService | BatchedService":
    """``None`` means the scalar default wrapping the resolved profile."""
    if model is None:
        return ScalarService(profile)
    return model
