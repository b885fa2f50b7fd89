"""Plain PyTorch versions of the vector runtime's kernels.

These are the step math of ``repro.vector.runtime`` (``_waterfill``,
``_scalar_step``, ``_batched_step``) and the sort-based quantile head of
``repro.kernels.ref`` (``quantile_ranks``, ``quantile_lerp``,
``fused_quantiles``), written op for op in PyTorch on f32 tensors.
They run wherever the tensors lie: the CPU path of ``kernels.ops``
takes them, and on the card they are what each CUDA kernel is held
against.  Every operation is a separate PyTorch op, so nothing is
contracted into an FMA.

Shapes follow the scan: consts ``c``/``fail_slot`` ``[C, S]`` (and
``tm``/``tc``/``new_mean`` ``[C, 1]`` for the batched family), ``dt`` a
Python float; carry ``[C, S]`` lanes plus ``drops [C]``; per-slot xs
with a 0-d int slot index ``t`` first.

Every sum over server lanes runs left to right in lane order
(``_lane_sum``): that is the order of XLA's row reduction on the CPU
(for up to 32 lanes) and of the CUDA kernel, so the three agree bit for
bit.  It matters beyond the last ulp in one place: in a slot where no
lane accepts, every lane sits at ``_BIG`` and the water-fill's sums of S
copies of ``_BIG`` round, so the fill is not exactly 0 (the JAX
reference's behaviour, reproduced here).
"""
from __future__ import annotations

import torch

_BIG = 1e18
_EPS = 1e-12

#: the fixed quantile tuple the vector runtime extracts
VECTOR_QS = (50.0, 95.0, 99.0)


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (server-lane) axis, one f32 add per lane in
    lane order, starting from 0."""
    out = x.new_zeros(x.shape[:-1])
    for i in range(x.shape[-1]):
        out = out + x[..., i]
    return out


def waterfill(U_eff: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Distribute ``total`` [C] of work over the least-loaded lanes of
    ``U_eff`` [C, S] (masked lanes carry ``_BIG``): fill to a common
    level -> per-lane fill amounts [C, S].

    Sort-free: lane k proposes the level reached if exactly the lanes
    at-or-below it share the work, ``(total + sum_{U_i <= U_k} U_i) /
    |{U_i <= U_k}|``; every proposal upper-bounds the true level and the
    true active set attains it, so the level is the least proposal."""
    mine = U_eff[..., :, None]                    # proposing lane k
    other = U_eff[..., None, :]                   # every lane i
    le = other <= mine
    zero = other.new_zeros(())
    # counts are small integers: exact in any summation order
    cnt = torch.where(le, other.new_ones(()), zero).sum(dim=-1)
    wsum = _lane_sum(torch.where(le, other, zero))
    level = (total[..., None] + wsum) / torch.clamp(cnt, min=1.0)
    L = level.amin(dim=-1, keepdim=True)
    return torch.clamp(L - U_eff, min=0.0)


def scalar_step(consts: dict, carry: tuple, xs: tuple):
    """One slot of the scalar family -> (carry, ys).

    carry ``(U, Q [C,S], drops [C])``; xs ``(t, Nc, Wc, Nf [C], Wf [C],
    act, acc, spd)``; ys ``(wait_U, wait_free [C], n_served, drained,
    Q)``."""
    c, fail_slot, dt = consts["c"], consts["fail_slot"], consts["dt"]
    U, Q, drops = carry
    t, Nc, Wc, Nf, Wf, act, acc, spd = xs
    zero = U.new_zeros(())
    # failure instant: the resident queue and in-flight work vanish
    is_fail = fail_slot == t
    drops = drops + _lane_sum(torch.where(is_fail, Q, zero))
    U = torch.where(is_fail, zero, U)
    Q = torch.where(is_fail, zero, Q)
    # request-routed work: water-fill the accepting servers
    ok = acc.sum(dim=-1) > 0                  # 0/1 lanes: exact
    drops = drops + torch.where(ok, zero, Nf)
    Wf = torch.where(ok, Wf, zero)
    Nf = torch.where(ok, Nf, zero)
    big = U.new_full((), _BIG)
    U_eff = torch.where(acc > 0, U, big)
    w_free = waterfill(U_eff, Wf)
    share = w_free / torch.clamp(_lane_sum(w_free)[..., None], min=_EPS)
    n_free = Nf[..., None] * share
    W_arr = Wc + w_free
    N_arr = Nc + n_free
    # backlog wait an arrival inherits; request-routed arrivals inherit
    # the least backlog any accepting server offers
    wait_U = U / torch.clamp(c * spd, min=_EPS)
    wait_free = torch.where(acc > 0, wait_U, big).amin(dim=-1)
    # serve
    cw = c * spd * act * dt
    drained = torch.minimum(U + W_arr, cw)
    wpr = (U + W_arr) / torch.clamp(Q + N_arr, min=_EPS)   # work per request
    n_served = torch.minimum(Q + N_arr,
                             drained / torch.clamp(wpr, min=_EPS))
    U = U + W_arr - drained
    Q = Q + N_arr - n_served
    return (U, Q, drops), (wait_U, wait_free, n_served, drained, Q)


def batched_step(consts: dict, carry: tuple, xs: tuple):
    """One slot of the batched (roofline) family -> (carry, ys).

    carry ``(P, T, L [C,S], drops [C])``; xs ``(t, Nc, Wpc, Wtc, Nf,
    Wpf, Wtf [C], act, acc, spd)``; ys ``(wait_adm, st_hat, N_arr,
    n_served, busy_used, L, tok_served)``."""
    B, fail_slot, dt = consts["c"], consts["fail_slot"], consts["dt"]
    tm, tc, new_mean = consts["tm"], consts["tc"], consts["new_mean"]
    P, T, L, drops = carry
    t, Nc, Wpc, Wtc, Nf, Wpf, Wtf, act, acc, spd = xs
    zero = P.new_zeros(())
    one = P.new_ones(())
    is_fail = fail_slot == t
    drops = drops + _lane_sum(torch.where(is_fail, L, zero))
    P = torch.where(is_fail, zero, P)
    T = torch.where(is_fail, zero, T)
    L = torch.where(is_fail, zero, L)
    # free arrivals: water-fill by queue length (jsq over load())
    ok = acc.sum(dim=-1) > 0                  # 0/1 lanes: exact
    drops = drops + torch.where(ok, zero, Nf)
    Nf = torch.where(ok, Nf, zero)
    L_eff = torch.where(acc > 0, L, P.new_full((), _BIG))
    n_free = waterfill(L_eff, Nf)
    share = n_free / torch.clamp(_lane_sum(n_free)[..., None], min=_EPS)
    Wp_arr = Wpc + Wpf[..., None] * share
    Wt_arr = Wtc + Wtf[..., None] * share
    N_arr = Nc + n_free
    # roofline step law at the slot's occupancy; clip(x, lo, hi) is
    # min(max(x, lo), hi), as jnp.clip evaluates it
    b = torch.minimum(torch.maximum(L, one), B)
    st = torch.maximum(tc * b, tm)
    tok_rate = b / st
    avail = act * spd * dt
    p_served = torch.minimum(P + Wp_arr, avail)
    rem = avail - p_served
    tok_served = torch.minimum(T + Wt_arr, rem * tok_rate)
    dec_used = tok_served / torch.clamp(tok_rate, min=_EPS)
    busy_used = p_served + dec_used
    n_served = torch.minimum(L + N_arr, tok_served / new_mean)
    P = P + Wp_arr - p_served
    T = T + Wt_arr - tok_served
    L = L + N_arr - n_served
    # admission wait: drain-time share ahead of a new arrival
    D = (P + T * st / torch.clamp(b, min=1.0)) / torch.clamp(spd, min=_EPS)
    frac = (L - B) / torch.clamp(L, min=1.0)
    wait_adm = D * torch.minimum(torch.maximum(frac, zero), one)
    b_hat = torch.minimum(torch.maximum(L + 1.0, one), B)
    st_hat = torch.maximum(tc * b_hat, tm)
    return (P, T, L, drops), (wait_adm, st_hat, N_arr, n_served,
                              busy_used, L, tok_served)


def _scan(step, consts: dict, carry: tuple, xs: tuple):
    """Advance ``step`` over every slot of ``xs`` (each ``[T, ...]``,
    the int32 global slot index ``xs[0]`` first) -> (carry, ys stacked
    ``[T, ...]``)."""
    outs = None
    for k in range(xs[0].shape[0]):
        carry, ys = step(consts, carry, tuple(x[k] for x in xs))
        if outs is None:
            outs = tuple(y.new_empty((xs[0].shape[0],) + y.shape)
                         for y in ys)
        for buf, y in zip(outs, ys):
            buf[k] = y
    return carry, outs


def scalar_scan(consts: dict, carry: tuple, xs: tuple):
    """Plain version of the ``scalar_scan`` kernel: the scalar step in a
    Python loop over the slots of ``xs``."""
    return _scan(scalar_step, consts, carry, xs)


def batched_scan(consts: dict, carry: tuple, xs: tuple):
    """Plain version of the ``batched_scan`` kernel."""
    return _scan(batched_step, consts, carry, xs)


def quantile_ranks(n: torch.Tensor, qs=VECTOR_QS):
    """np.percentile's floor/ceil order statistics for each quantile of
    a ``[C]`` batch of sample counts -> (pos f32, lo i32, hi i32), each
    ``[C, Q]``.  The quantile constants enter as ``float(q / 100.0)``
    rounded to f32, exactly as the JAX oracle's weak-typed product."""
    nf = n.to(torch.float32)
    pos = torch.stack([float(q / 100.0) * (nf - 1.0) for q in qs], dim=-1)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    return pos, lo.to(torch.int32), hi.to(torch.int32)


def quantile_lerp(a, b, t):
    """numpy's percentile lerp: anchor on the nearer endpoint for
    t >= 0.5."""
    return torch.where(t >= 0.5, b - (b - a) * (1.0 - t), a + (b - a) * t)


def fused_quantiles(lat: torch.Tensor, counts: torch.Tensor,
                    qs=VECTOR_QS) -> torch.Tensor:
    """Plain version of the ``fused_quantiles`` kernel: a full sort.

    ``lat``: ``[C, K]`` f32, row ``i`` holds ``counts[i]`` samples then
    ``+inf`` padding; ``counts``: ``[C]`` int -> ``[C, len(qs)]`` f32
    exact-order-statistic quantiles, NaN where the count is 0."""
    x = torch.sort(lat.to(torch.float32), dim=-1).values
    pos, lo, hi = quantile_ranks(counts, qs)
    K = x.shape[-1]
    a = torch.gather(x, -1, torch.clamp(lo, 0, K - 1).to(torch.int64))
    b = torch.gather(x, -1, torch.clamp(hi, 0, K - 1).to(torch.int64))
    out = quantile_lerp(a, b, pos - lo.to(torch.float32))
    return torch.where(counts[:, None] > 0, out,
                       out.new_full((), float("nan")))
