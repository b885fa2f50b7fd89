"""The traffic generator: one general reader of ``traffic/<mix>.json``.

A mix is open loop: ``clients`` independent clients, each sending
requests at ``rate / clients`` per second from t = 0, whether or not
earlier ones have finished.  Gaps follow the exponential law (Poisson
arrivals) and sizes the log-normal ``TokenLengths`` law of
``repro_torch.core.profiles`` (``max(1, min(int(median * exp(sigma *
z)), max))``), both copied here so that a change to the program cannot
move the yardstick.

What the seed changes is the order, not the work.  Each client's gaps
are the ``n`` quantiles ``(i + 0.5) / n`` of its exponential law, and
the run's prompt and answer sizes the quantiles of theirs, every seed
drawing a new permutation of each.  So every seed offers the same
number of requests, the same tokens and the same busy time, in another
order, and the runs of a cell differ by how the work is arranged, as
two runs of one deployment would, and not by how much of it there is.
``n`` is the largest count whose gaps add up to less than the window,
so every request is due inside it.

Prompt tokens are drawn as ``repro_torch.core.runtime.EngineRuntime``
draws them, ``default_rng(seed).integers(0, vocab, n)`` in submit order
(``prompts``): the reference draws them again from the seed and never
reads them off the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

#: domain-separation salts of the seed's streams
_GAP_STREAM, _PROMPT_STREAM, _NEW_STREAM = 0x6A9, 0x512E, 0x512F


@dataclass(frozen=True)
class Arrival:
    t: float              # due time, seconds from the window's start
    client: int
    prompt: int           # prompt tokens
    new: int              # tokens to generate


def _gaps(n: int, rate: float) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def _count(rate: float, seconds: float) -> int:
    n = max(int(rate * seconds), 0)
    while n > 0 and _gaps(n, rate).sum() >= seconds:
        n -= 1
    return n


def sizes(median: float, sigma: float, vmax: int, n: int) -> np.ndarray:
    """The ``n`` quantiles ``(j + 0.5) / n`` of the clipped integer
    log-normal law, ascending."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((j + 0.5) / n) for j in range(n)])
    x = median * np.exp(sigma * z)
    return np.clip(x.astype(np.int64), 1, vmax)


def schedule(traffic: dict, rate: float, seconds: float,
             seed: int) -> list[Arrival]:
    """Every arrival of one run, in due order (ties by client)."""
    clients = int(traffic["clients"])
    per_client = rate / clients
    n = _count(per_client, seconds)
    times = []
    for c in range(clients):
        rng = np.random.default_rng([seed, c, _GAP_STREAM])
        ts = np.cumsum(rng.permutation(_gaps(n, per_client)))
        times.extend((float(t), c) for t in ts)
    times.sort()
    lens = traffic["lengths"]
    m = len(times)
    prompt = np.random.default_rng([seed, _PROMPT_STREAM]).permutation(
        sizes(lens["prompt_median"], lens["prompt_sigma"],
              lens["prompt_max"], m))
    new = np.random.default_rng([seed, _NEW_STREAM]).permutation(
        sizes(lens["new_median"], lens["new_sigma"], lens["new_max"], m))
    return [Arrival(t, c, int(p), int(k))
            for (t, c), p, k in zip(times, prompt, new)]


def max_len(traffic: dict) -> int:
    """The engine's cache length: the longest prompt and answer, and the
    engine's 32 spare slots (``make_warmed_engine``)."""
    lens = traffic["lengths"]
    return int(lens["prompt_max"]) + int(lens["new_max"]) + 32


def prompts(seed: int, vocab: int, arrivals) -> list[np.ndarray]:
    """The prompt tokens of each arrival, drawn in submit order as the
    runtime draws them."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=a.prompt) for a in arrivals]


class ScheduledClient:
    """One client's arrivals in the shape ``EngineRuntime`` reads from a
    client generator: ``next_arrival() -> (t, demand) | None`` and the
    sizes of that arrival in ``last_sizes``."""

    def __init__(self, arrivals):
        self._todo = list(arrivals)[::-1]
        self.last_sizes = (0, 0)

    def next_arrival(self):
        if not self._todo:
            return None
        a = self._todo.pop()
        self.last_sizes = (a.prompt, a.new)
        return a.t, 0.0


def buckets(traffic: dict, reached) -> list[int]:
    """The prefill lengths the engine pads the ``reached`` prompt
    lengths to (a copy of its bucket rule: powers of two from 32, capped
    at its cache length), ascending."""
    cap = max_len(traffic)
    out = set()
    for n in reached:
        b = 32
        while b < n:
            b *= 2
        out.add(min(b, cap) if n <= 4096 else
                min(int(math.ceil(n / 4096)) * 4096, cap))
    return sorted(out)
