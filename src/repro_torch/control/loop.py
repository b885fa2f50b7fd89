"""The shared control loop: windowed observation + cooldown/lag gating.

Both event backends drive the same machinery: once per control interval
they call ``loop.observe(...)`` to build an ``Observation`` from their
``LatencyRecorder`` and live server handles, then ``loop.tick(obs,
now)`` to let the policy act.  The loop enforces the spec's cooldown
(actions within ``cooldown`` of the previous action are suppressed);
the *caller* applies returned actions at ``now + spec.lag`` through its
own scheduler, so actuation lag rides the backend's native event order
and stays deterministic.

Windowed statistics come straight from the recorder: in exact mode the
window is the raw latency slice recorded since the previous tick; in
streaming mode it is the bounded reservoir of the latest closed stats
interval (approximate, like every streaming statistic).  Shed/timed-out
/failed requests recorded via ``record_failure`` count into the
window's SLO-violation fraction — the controller sees honest numbers.

Copy of ``repro.control.loop``.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.control.policy import ControlSpec, Observation


def observe_runtime(recorder, servers, t: float, slo, admit: float,
                    prev: dict) -> Observation:
    """Build one control-window ``Observation``.

    ``servers`` is the backend's *alive* server collection (``SimServer``
    or ``EngineServerHandle`` both fit: ``busy``, ``load()``, and a
    ``workers``/``max_batch`` capacity).  ``prev`` is the loop's mutable
    window state: ``{"n": ..., "bad": ..., "t": ...}`` counters as of
    the previous tick, updated in place.
    """
    servers = list(servers)
    utils = []
    qdepth = 0
    for s in servers:
        cap = getattr(s, "workers", None)
        if cap is None:
            cap = getattr(s, "max_batch", None)
        if cap is None:
            cap = 1
        busy = s.busy if hasattr(s, "busy") else s.load()
        utils.append(min(busy / cap, 1.0) if cap else 0.0)
        qdepth += max(s.load() - busy, 0)
    util = sum(utils) / len(utils) if utils else 0.0

    bad_total = recorder.failed_total()
    bad = bad_total - prev.get("bad", 0)
    window = max(t - prev.get("t", 0.0), 1e-12)
    if recorder.mode == "exact":
        xs = recorder.all[prev.get("n", 0):]
        n = len(xs)
        prev["n"] = len(recorder.all)
        if xs:
            arr = np.asarray(xs, float)
            p99 = float(np.percentile(arr, 99))
            mean = float(arr.mean())
            slow = int(np.count_nonzero(arr > slo)) if slo is not None else 0
        else:
            p99 = mean = float("nan")
            slow = 0
    else:
        n_total = recorder._all.n
        n = n_total - prev.get("n", 0)
        prev["n"] = n_total
        ivl = int(t / recorder.interval) - 1
        stat = recorder._by_ivl.get(ivl)
        if stat is not None and stat.res.data:
            arr = np.asarray(stat.res.data, float)
            p99 = float(np.percentile(arr, 99))
            mean = float(arr.mean())
            frac = (float(np.count_nonzero(arr > slo)) / arr.size
                    if slo is not None else 0.0)
            slow = frac * n               # scale the reservoir estimate
        else:
            p99 = mean = float("nan")
            slow = 0
    prev["bad"] = bad_total
    prev["t"] = t
    if slo is None or (n + bad) == 0:
        slo_frac = float("nan")
    else:
        slo_frac = (slow + bad) / (n + bad)
    return Observation(t=t, n=n, qps=n / window, p99=p99, mean=mean,
                       util=util, qdepth=float(qdepth), slo_frac=slo_frac,
                       n_active=len(servers), admit=admit)


class ControlLoop:
    """Cooldown/window bookkeeping around one policy instance."""

    def __init__(self, spec: ControlSpec):
        self.spec = spec
        self.policy = spec.build()
        self._last_action = -math.inf
        self._prev: dict = {}

    def observe(self, recorder, servers, t: float, slo,
                admit: float) -> Observation:
        return observe_runtime(recorder, servers, t, slo, admit,
                               self._prev)

    def tick(self, obs: Observation, now: float) -> list:
        """Policy update gated by the cooldown.  Returns ``(kind,
        params)`` actions for the caller to apply at ``now + lag``."""
        actions = self.policy.update(obs)
        if not actions:
            return []
        if now - self._last_action < self.spec.cooldown:
            return []
        self._last_action = now
        return actions
