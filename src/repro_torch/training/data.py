"""Deterministic, resumable synthetic data pipeline.

Copy of ``repro.training.data`` (pure NumPy): the same counter-based
stream, so a batch of the port is bit-equal to the reference's batch of
the same config, seed and step.  One repair: the reference's
``Prefetcher`` drops a generated batch whenever its queue stays full for
0.5 s (a train step slower than that), so which batches a run trains on
depends on timing; here the batch is kept until it is queued.

Serves (tokens, targets) language-model batches from a counter-based PRNG:
``state`` is just the step index, so checkpoint/restore resumes the stream
bit-exactly (fault-tolerance test relies on this).  A host-side prefetch
thread hides generation latency behind the train step.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2          # token distribution skew (matches LM zipf)


class SyntheticLM:
    """Markov-ish synthetic token stream with Zipf-distributed vocabulary."""

    def __init__(self, cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.step = step
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self._p = p / p.sum()

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def from_state(cls, cfg: DataConfig, state: dict) -> "SyntheticLM":
        assert state["seed"] == cfg.seed, "data seed mismatch on restore"
        return cls(cfg, step=int(state["step"]))

    def next_batch(self) -> dict:
        rng = np.random.default_rng((self.cfg.seed, self.step))
        self.step += 1
        c = self.cfg
        toks = rng.choice(c.vocab_size, size=(c.batch, c.seq_len + 1), p=self._p)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class Prefetcher:
    """One-deep host prefetch (hides np generation behind device step)."""

    def __init__(self, it, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.is_set():
            batch = self._it.next_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:      # keep the batch: the stream's
                    continue            # next one is not this one

    def next_batch(self):
        return self._q.get()

    def close(self):
        self._stop.set()
