"""Smoothed (differentiable) counterparts of the vector runtime's hard
primitives — the ``VectorConfig.soft=True`` mode and the planner's
surrogate.

Port of ``repro.vector.soft``.  Every hard decision in the vector
dynamics is a kink or a step that kills gradients: the water-filling
``argmin`` over server backlogs, the ``rho < 0.999`` clip inside
Erlang-C, the queue/no-queue Bernoulli indicator, the horizon/failure
censoring mask, and the order-statistic quantile extraction.  This
module replaces each with a temperature-controlled relaxation that (a)
recovers the hard operator as ``tau -> 0`` and (b) keeps a usable
gradient near rho ~= 1 and the p99 rank.

Two array libraries, as in the reference:

* ``xp = np`` — the host terms of the soft vector runtime (the
  sampler's queue indicator, the censor keep-weights, Erlang-C and the
  smooth utilization ceiling) and the planner's hard twin.  These
  branches are the reference's NumPy code verbatim, so draws and
  keep-weights are bit-identical to ``repro``'s;
* ``xp = torch`` — the tensor uses: the planner's surrogate
  (differentiated with ``torch.autograd``) and the soft quantile head,
  on whatever device the tensors lie.
  ``torch.maximum``/``minimum`` split the gradient evenly at ties, as
  ``jnp.maximum``/``minimum`` do.

``soft_waterfill``, the scan step's smoothed water-fill, lives beside
the hard one in ``repro_torch.kernels.ref`` (the step's own layer, as
``repro.vector.runtime._make_waterfill`` picks it there) together with
the torch logistic and softplus, and is re-exported here.

Masked lanes (``_BIG`` backlogs, ``+inf`` quantile padding) fall out
EXACTLY: the sigmoids saturate to literal 0.0/1.0 there.  The quantile
surrogate anchors on ``repro_torch.kernels.ref``'s ``quantile_ranks`` /
``quantile_lerp`` — the exact kernel's rank plan — so soft and hard
heads interpolate between the same order statistics.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import abs_jnp as _abs
from repro_torch.kernels.ref import scalar_like as _like
from repro_torch.kernels.ref import soft_waterfill  # noqa: F401  (re-export)

_EPS = 1e-12
#: utilization ceiling shared with the hard Erlang-C clip
RHO_MAX = 0.999


def stable_sigmoid(xp, x):
    """Overflow-safe logistic; saturates to exact 0.0/1.0 so masked
    (``_BIG``) operands drop out bit-exactly."""
    if xp is np:
        z = np.exp(-np.abs(x))
        return np.where(x >= 0, 1.0 / (1.0 + z), z / (1.0 + z))
    return ref.stable_sigmoid(x)


def softplus(xp, x):
    """Overflow-safe ``log(1 + exp(x))`` (= x for large x, 0 for very
    negative x)."""
    if xp is np:
        return np.maximum(x, 0.0) + np.log1p(np.exp(-np.abs(x)))
    return ref.softplus(x)


def smooth_min(xp, a, b, tau):
    """Soft ``min(a, b)``: ``-tau * logsumexp(-[a, b]/tau)``, written in
    the overflow-safe two-operand form.  Always <= min(a, b); recovers
    it as ``tau -> 0``."""
    if xp is np:
        m = np.minimum(a, b)
        return m - tau * np.log1p(np.exp(-np.abs(a - b) / tau))
    if not torch.is_tensor(b):
        b = _like(a, b)
    m = torch.minimum(a, b)
    return m - tau * torch.log1p(torch.exp(-_abs(a - b) / tau))


def smooth_rho(xp, rho, tau, hi: float = RHO_MAX):
    """Utilization with the Erlang-C ceiling applied smoothly:
    ``smooth_min(rho, hi)`` keeps ``1 - rho`` >= ``1 - hi`` (so every
    downstream ``1/(1-rho)`` stays finite) while ``d rho/d x`` survives
    arbitrarily deep into overload, where the hard clip's is zero."""
    if xp is np:
        return np.maximum(smooth_min(np, rho, hi, tau * hi), 1e-9)
    s = smooth_min(torch, rho, hi, tau * hi)
    return torch.maximum(s, _like(s, 1e-9))


def _np_lgamma1p(c: np.ndarray) -> np.ndarray:
    """lgamma(c + 1) elementwise; dedup first — capacity arrays hold a
    handful of distinct values over [T, C, S] elements."""
    flat = np.asarray(c, float).ravel()
    vals, inv = np.unique(flat, return_inverse=True)
    table = np.array([math.lgamma(v + 1.0) for v in vals])
    return table[inv].reshape(np.shape(c))


def _torch_lgamma_reference(c: torch.Tensor) -> torch.Tensor:
    """The reference's tensor branch of ``soft_erlang_c`` takes
    ``lgamma(c)`` where its NumPy branch and its docstring take
    ``lgamma(c + 1)`` (``repro/vector/soft.py``, the jnp branch).  Its
    Erlang-C top term is therefore ``c`` times too large, and the
    planner's surrogate is built on that law.  The port reproduces it
    so the surrogate and the planner's trajectory match ``repro.plan``;
    a fix belongs to both packages at once (ROADMAP Queue C)."""
    return torch.lgamma(c)


def soft_erlang_c(xp, c, rho, cmax: int, tau):
    """Erlang-C delay probability with CONTINUOUS capacity ``c`` and a
    smooth utilization ceiling — the differentiable twin of
    ``_erlang_c``.

    The factorial becomes ``lgamma(c + 1)`` (exact at integers, smooth
    between; the tensor branch keeps the reference's ``lgamma(c)``, see
    ``_torch_lgamma_reference``), the truncated-sum membership ``k < c``
    a sigmoid gate at ``c - k - 0.5``, and ``rho`` passes through
    ``smooth_rho``."""
    rho_s = smooth_rho(xp, rho, tau)
    a = c * rho_s
    if xp is np:
        lg = _np_lgamma1p(c)
        top = np.exp(c * np.log(np.maximum(a, _EPS)) - lg)
    else:
        lg = _torch_lgamma_reference(c * 1.0)
        top = torch.exp(c * torch.log(torch.maximum(a, _like(a, _EPS))) - lg)
    term = xp.ones_like(a)
    ssum = xp.zeros_like(a)
    for k in range(cmax):
        gate = stable_sigmoid(xp, (c - k - 0.5) / tau)
        ssum = ssum + gate * term
        term = term * a / (k + 1.0)
    denom = (1.0 - rho_s) * ssum + top
    if xp is np:
        return top / np.maximum(denom, _EPS)
    return top / torch.maximum(denom, _like(denom, _EPS))


def censor_weight(xp, arrive_t, completion, horizon, fail_t, tau):
    """Smooth keep-weight for one sampled request — the relaxation of
    the recorder's hard censoring mask ``(completion <= horizon) &
    (arrive < fail) & (completion <= fail)``.  ``tau`` is in seconds (a
    few slot widths); ``fail_t = +inf`` saturates its sigmoids to exact
    1.0, so unfailed servers censor only at the horizon."""
    w = stable_sigmoid(xp, (horizon - completion) / tau)
    w = w * stable_sigmoid(xp, (fail_t - arrive_t) / tau)
    return w * stable_sigmoid(xp, (fail_t - completion) / tau)


def soft_quantiles(lat: torch.Tensor, weights: torch.Tensor, qs=None,
                   band_frac: float = 5e-4) -> torch.Tensor:
    """Differentiable weighted-quantile head: ``[C, K]`` latencies with
    per-sample keep-weights -> ``[C, len(qs)]``.

    ``quantile_ranks`` gives the (pos, lo, hi) order statistics
    np.percentile would select at the effective (weighted) count, a
    Gaussian kernel over fractional ranks turns each anchor into a soft
    order statistic, and ``quantile_lerp`` blends the two anchors with
    the exact path's interpolation.  The kernel bandwidth is
    ``max(0.5, band_frac * n_eff)`` ranks.  Pad slots must carry weight
    0.0 (their value may be ``+inf``); rows with no effective samples
    return NaN like the hard head.  The sort is stable, as
    ``jnp.argsort``."""
    if qs is None:
        qs = ref.VECTOR_QS
    order = torch.argsort(lat, dim=-1, stable=True)
    xs = torch.gather(lat, -1, order)
    ws = torch.gather(weights, -1, order)
    xs = torch.where(ws > 0.0, xs, xs.new_zeros(()))  # never 0 * inf
    cum = torch.cumsum(ws, dim=-1)
    n_eff = cum[..., -1]
    # each sample sits at the center of its own weight mass, 0-indexed:
    # unit weights give ranks 0..K-1 exactly
    r = cum - 0.5 * ws - 0.5
    pos, lo, hi = ref.quantile_ranks(n_eff, qs)
    bf = band_frac * n_eff
    band = torch.maximum(bf, _like(bf, 0.5))[..., None, None]

    def soft_os(rank):                         # [C, Q] -> [C, Q]
        d = (r[..., None, :] - rank[..., :, None]) / band
        k = torch.exp(-0.5 * d * d) * ws[..., None, :]
        num = (k * xs[..., None, :]).sum(dim=-1)
        den = k.sum(dim=-1)
        return num / torch.maximum(den, _like(den, _EPS))

    a = soft_os(lo.to(torch.float32))
    b = soft_os(hi.to(torch.float32))
    out = ref.quantile_lerp(a, b, pos - lo.to(torch.float32))
    return torch.where(n_eff[..., None] > 0.5, out,
                       out.new_full((), float("nan")))
