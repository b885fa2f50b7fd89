"""Plain PyTorch versions of the port's kernels.

These are the step math of ``repro.vector.runtime`` (``_waterfill``,
``_scalar_step``, ``_batched_step``) and the sort-based quantile head of
``repro.kernels.ref`` (``quantile_ranks``, ``quantile_lerp``,
``fused_quantiles``), written op for op in PyTorch on f32 tensors.
They run wherever the tensors lie: the CPU path of ``kernels.ops``
takes them, and on the card they are what each CUDA kernel is held
against.  Every operation is a separate PyTorch op, so nothing is
contracted into an FMA.  The sections at the end are the plain versions
of the model kernels: attention (``repro.kernels.ref``'s attention
oracles) and the Mamba-2 SSD scan (``ssd_naive``, ``ssd_chunked``).

Shapes follow the scan: consts ``c``/``fail_slot`` ``[C, S]`` (and
``tm``/``tc``/``new_mean`` ``[C, 1]`` for the batched family), ``dt`` a
Python float, and in soft mode ``tau`` a Python float (the steps then
take ``soft_waterfill``, the reference's ``repro.vector.soft`` relaxation,
which ``repro_torch.vector.soft`` re-exports); carry ``[C, S]`` lanes plus
``drops [C]``; per-slot xs with a 0-d int slot index ``t`` first.

Every sum over server lanes runs left to right in lane order
(``_lane_sum``): that is the order of XLA's row reduction on the CPU
(for up to 32 lanes) and of the CUDA kernel, so the three agree bit for
bit.  It matters beyond the last ulp in one place: in a slot where no
lane accepts, every lane sits at ``_BIG`` and the water-fill's sums of S
copies of ``_BIG`` round, so the fill is not exactly 0 (the JAX
reference's behaviour, reproduced here).
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch.distributed.sharding import shard
from repro_torch.util import opt_flags

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


def scalar_like(x: torch.Tensor, v) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``x``'s dtype and device (a Python
    scalar takes ``x``'s dtype, as a weakly typed scalar does in jnp),
    filled on the device rather than copied from the host."""
    return x.new_full((), v)


def abs_jnp(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` whose derivative at 0 is 1, as ``jnp.abs``'s (``torch.abs``
    gives 0 there, which would zero a sigmoid's slope at its center)."""
    return torch.where(x >= 0, x, -x)


def stable_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Overflow-safe logistic; saturates to exact 0.0/1.0 so masked
    (``_BIG``) operands drop out bit-exactly."""
    z = torch.exp(-abs_jnp(x))
    return torch.where(x >= 0, 1.0 / (1.0 + z), z / (1.0 + z))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Overflow-safe ``log(1 + exp(x))`` (= x for large x, 0 for very
    negative x)."""
    return torch.maximum(x, scalar_like(x, 0.0)) \
        + torch.log1p(torch.exp(-abs_jnp(x)))


def soft_waterfill(U_eff: torch.Tensor, total: torch.Tensor,
                   tau: float) -> torch.Tensor:
    """Temperature-controlled relaxation of the water-fill: distribute
    ``total`` [C] over the least-loaded lanes of ``U_eff`` [C, S]
    (``repro.vector.soft.soft_waterfill``).

    The active-set membership test (``U_i <= U_k``) and the final
    ``relu(L - U)`` become sigmoids/softplus at a temperature scaled by
    the per-cell operand magnitude, and the level becomes a softmin
    over the lane proposals.  Fills are renormalized so the slot
    conserves work mass at any temperature.  Masked lanes (``_BIG``)
    saturate every sigmoid and contribute exact zeros."""
    zero = U_eff.new_zeros(())
    fin = U_eff < (_BIG * 0.5)
    n_fin = torch.where(fin, U_eff.new_ones(()), zero).sum(dim=-1)
    u_fin = torch.where(fin, U_eff, zero)
    u_sum = u_fin.sum(dim=-1)
    # operand magnitude: mean finite backlog + the incoming work itself
    scale = (u_sum + total) / torch.clamp(n_fin, min=1.0) + _EPS
    t = tau * scale
    mine = U_eff[..., :, None]
    other = U_eff[..., None, :]
    le = stable_sigmoid((mine - other) / t[..., None, None])
    cnt = le.sum(dim=-1)
    wsum = (le * u_fin[..., None, :]).sum(dim=-1)
    level = (total[..., None] + wsum) \
        / torch.maximum(cnt, scalar_like(cnt, 0.5))
    # softmin over lane proposals, anchored at the hard min for safety
    lmin = level.amin(dim=-1, keepdim=True)
    w_prop = torch.exp(-(level - lmin) / t[..., None])
    wp_sum = w_prop.sum(dim=-1, keepdim=True)
    L = (level * w_prop).sum(dim=-1, keepdim=True) \
        / torch.maximum(wp_sum, scalar_like(wp_sum, _EPS))
    fill = softplus((L - U_eff) / t[..., None]) * t[..., None]
    # conserve the slot's work mass exactly at any temperature
    fsum = fill.sum(dim=-1, keepdim=True)
    return fill * (total[..., None]
                   / torch.maximum(fsum, scalar_like(fsum, _EPS)))


def _waterfill_of(consts: dict):
    """The step's water-fill: the hard level-fill, or the soft mode's
    temperature-controlled relaxation when the consts carry ``tau``
    (``repro.vector.runtime._make_waterfill``)."""
    tau = consts.get("tau")
    if tau is None:
        return waterfill
    return functools.partial(soft_waterfill, tau=tau)


def scalar_step(consts: dict, carry: tuple, xs: tuple, wfill=None):
    """One slot of the scalar family -> (carry, ys).

    carry ``(U, Q [C,S], drops [C])``; xs ``(t, Nc, Wc, Nf [C], Wf [C],
    act, acc, spd)``; ys ``(wait_U, wait_free [C], n_served, drained,
    Q)``.  ``wfill`` is the consts' water-fill, when the caller (a scan)
    has picked it once for every slot."""
    wfill = wfill or _waterfill_of(consts)
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
    w_free = wfill(U_eff, Wf)
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


def batched_step(consts: dict, carry: tuple, xs: tuple, wfill=None):
    """One slot of the batched (roofline) family -> (carry, ys).

    carry ``(P, T, L [C,S], drops [C])``; xs ``(t, Nc, Wpc, Wtc, Nf,
    Wpf, Wtf [C], act, acc, spd)``; ys ``(wait_adm, st_hat, N_arr,
    n_served, busy_used, L, tok_served)``; ``wfill`` as in
    ``scalar_step``."""
    wfill = wfill or _waterfill_of(consts)
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
    n_free = wfill(L_eff, Nf)
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
    wfill = _waterfill_of(consts)
    outs = None
    for k in range(xs[0].shape[0]):
        carry, ys = step(consts, carry, tuple(x[k] for x in xs), wfill)
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


# ---------------------------------------------------------------------------
# Attention (plain versions of flash_attention.cu / decode_attention.cu)
# ---------------------------------------------------------------------------
#: the additive mask value of the reference: finite, so a row whose every
#: key is masked gets a uniform softmax (the mean of v), not NaN
NEG_INF = -1e30


def naive_attention(q, k, v, *, causal: bool, window=None,
                    q_offset: int = 0) -> torch.Tensor:
    """Materializing attention, op for op ``repro.kernels.ref
    .naive_attention``.  q ``(B, S, H, hd)``; k, v ``(B, T, KV, hd)``;
    query row ``i`` sits at position ``q_offset + i``, key ``j`` at
    ``j``.  Logits in f32, scaled after the product, masked by adding
    ``NEG_INF``; the probabilities are cast to ``v.dtype`` before P·V,
    whose output has ``v.dtype``."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qq = q.reshape(b, s, kv, g, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qq.float(), k.float())
    logits = logits * (hd ** -0.5)
    q_pos = torch.arange(s, device=q.device) + q_offset
    diff = q_pos[:, None] - torch.arange(t, device=q.device)[None, :]
    ok = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        ok &= diff >= 0
    if window is not None:
        ok &= diff < window
    logits = logits + torch.where(ok, 0.0, NEG_INF).to(torch.float32)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    chunk: int = 512) -> torch.Tensor:
    """Plain version of the ``flash_attention`` kernel: the reference's
    query-chunked attention (``repro.kernels.ref.chunked_attention``),
    ``naive_attention`` over query chunks of ``chunk`` rows, so the f32
    logits of one chunk, ``chunk x T`` per head, are live at a time.
    When autograd records, each chunk runs under a non-reentrant
    ``torch.utils.checkpoint``, as the reference's scan body runs under
    ``jax.checkpoint``: the backward keeps the inputs and recomputes one
    chunk's logits at a time, where it would otherwise keep every
    chunk's (the saved set would grow as S x T).  Outputs and gradients
    are the same bits either way.  Unlike the reference it takes any S
    (the last chunk may be short).  Under ``REPRO_OPTS=sp_naive_attn``
    the whole sequence is one ``naive_attention``, as the reference's
    option materialises it (no chunks, no checkpoint)."""
    s = q.shape[1]
    if s <= chunk or "sp_naive_attn" in opt_flags():
        return naive_attention(q, k, v, causal=causal, window=window)
    records = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    parts = []
    for i in range(0, s, chunk):
        qc = q[:, i:i + chunk]
        if records:
            parts.append(torch.utils.checkpoint.checkpoint(
                naive_attention, qc, k, v, causal=causal, window=window,
                q_offset=i, use_reentrant=False,
                preserve_rng_state=False))          # no random op inside
        else:
            parts.append(naive_attention(qc, k, v, causal=causal,
                                         window=window, q_offset=i))
    return torch.cat(parts, dim=1)


def decode_attention(q, k, v, *, lengths, key_positions=None, q_pos=None,
                     window=None, lse_only: bool = False, lse=None):
    """Plain version of the ``decode_attention`` kernel, op for op
    ``repro.kernels.ref.decode_attention``: one query token per row.
    q ``(B, H, hd)``; k, v ``(B, T, KV, hd)``; ``lengths`` ``(B,)``;
    ``key_positions`` ``(B, T)`` absolute position of each cache slot
    (-1 = empty; default ``arange(T)``); ``q_pos`` ``(B,)`` (default
    ``lengths - 1``).  Key ``j`` counts when ``0 <= pos_j < length`` and,
    with a window, ``pos_j > q_pos - window``.  The kernel's two rounds
    of a flash-decode across ranks: ``lse_only`` -> the f32 log-sum-exp
    of each head's scaled, masked logits ``(B, H)`` (-1e30 where no key
    counts); ``lse (B, H)`` given -> the f32 ``(B, H, hd)`` sum of
    ``exp(logit - lse)`` rounded to v's dtype times v, not rounded."""
    b, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qq = q.reshape(b, kvh, g, hd)
    logits = torch.einsum("bkgd,btkd->bkgt", qq.float(), k.float())
    logits = logits * (hd ** -0.5)
    if key_positions is None:
        key_positions = torch.arange(t, device=q.device).expand(b, t)
    valid = (key_positions < lengths[:, None]) & (key_positions >= 0)
    if window is not None:
        if q_pos is None:
            q_pos = torch.clamp(lengths - 1, min=0)
        valid &= key_positions > (q_pos[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    if lse_only:
        return torch.logsumexp(logits, dim=-1).reshape(b, h)
    if lse is not None:
        probs = torch.exp(logits - lse.reshape(b, kvh, g, 1)).to(v.dtype)
        out = torch.einsum("bkgt,btkd->bkgd", probs.float(), v.float())
        return out.reshape(b, h, hd)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v)
    return out.reshape(b, h, hd)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (plain versions of ssd_scan.cu)
# ---------------------------------------------------------------------------
#: the reference's pre-exp mask value (``repro.kernels.ref.ssd_chunked``)
SSD_MASK = -1e30


def _wide(x: torch.Tensor) -> torch.Tensor:
    """Widened to f32 (f64 stays f64: an f64 run is the yardstick of the
    f32 versions' rounding)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def ssd_naive(x, dt, A, B, C, h0=None):
    """Per-timestep recurrence oracle, op for op ``repro.kernels.ref
    .ssd_naive``.  x ``(b, s, h, p)``; dt ``(b, s, h)``; A ``(h,)``; B, C
    ``(b, s, 1, n)``; any float dtypes, widened to f32 -> (y ``(b, s, h,
    p)`` f32, final state ``(b, h, p, n)`` f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf = _wide(x), _wide(dt)
    Bf, Cf = _wide(B[:, :, 0]), _wide(C[:, :, 0])
    A = _wide(A)
    state = (xf.new_zeros((b, h, p, n)) if h0 is None else _wide(h0))
    ys = []
    for t in range(s):
        decay = torch.exp(A * dtf[:, t])                     # (b, h)
        state = state * decay[..., None, None]
        state = state + torch.einsum("bh,bhp,bn->bhpn", dtf[:, t],
                                     xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1), state


def ssd_chunked(x, dt, A, B, C, *, chunk: int, h0=None):
    """Plain version of the ``ssd_scan`` kernel: the chunked SSD of
    ``repro.kernels.ref.ssd_chunked``, op for op, one chunk at a time
    (the ``(b, h, p, n)`` state carried from chunk to chunk), in f32 on
    inputs of any float dtype.  Within a chunk of L steps:
    ``M[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s`` for ``t >= s`` (the
    mask applied before the exp, where ``s > t`` could overflow), ``y =
    M x + exp(cum_t) C_t . h``, ``h = exp(cum_L) h + sum_s exp(cum_L -
    cum_s) dt_s x_s (x) B_s``.  ``s`` must be a multiple of ``chunk``.
    Under ``REPRO_OPTS=ssd_shard_state`` each chunk's new state is
    constrained to ``("batch", "mamba_heads", None, None)``, as the
    reference constrains its scan carry: the identity off a mesh and on
    a rank's local shard (``kernels.ops`` scans each rank's heads)."""
    shard_state = "ssd_shard_state" in opt_flags()
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    L = chunk
    A = _wide(A)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    mask = torch.full((), SSD_MASK, dtype=A.dtype, device=x.device)
    hprev = (A.new_zeros((b, h, p, n)) if h0 is None else _wide(h0))
    ys = []
    for c0 in range(0, s, L):
        xc = _wide(x[:, c0:c0 + L])                          # (b, L, h, p)
        dtc = _wide(dt[:, c0:c0 + L])                        # (b, L, h)
        Bc = _wide(B[:, c0:c0 + L, 0])                       # (b, L, n)
        Cc = _wide(C[:, c0:c0 + L, 0])
        a = A * dtc
        cum = torch.cumsum(a, dim=1)                         # (b, L, h)
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # (b, t, s, h)
        decay = torch.exp(torch.where(causal[None, :, :, None], seg, mask))
        cb = torch.einsum("btn,bsn->bts", Cc, Bc)
        M = cb[..., None] * decay * dtc[:, None, :, :]       # (b, t, s, h)
        y = torch.einsum("btsh,bshp->bthp", M, xc)
        y = y + torch.einsum("blh,bln,bhpn->blhp", torch.exp(cum), Cc, hprev)
        w = torch.exp(cum[:, -1:, :] - cum) * dtc            # (b, L, h)
        upd = torch.einsum("blh,bln,blhp->bhpn", w, Bc, xc)
        hprev = hprev * torch.exp(cum[:, -1, :])[:, :, None, None] + upd
        if shard_state:
            hprev = shard(hprev, "batch", "mamba_heads", None, None)
        ys.append(y)
    return torch.cat(ys, dim=1), hprev


def _bf16_parts(v: torch.Tensor, parts: int) -> list:
    """``v`` rounded to f32, as ``parts`` bf16 terms in f64, each the bf16
    rounding of what the ones before it left (hi, lo, ...); in f32 the
    remainder ``v - hi`` is exact."""
    out, r = [], v.float()
    for _ in range(parts):
        p = r.bfloat16().float()
        out.append(p.double())
        r = r - p
    return out


def _parts_product(eq: str, a_parts: list, b_parts: list) -> torch.Tensor:
    """``einsum(eq)`` of two operands given as bf16 parts, in f64: the
    products of parts i and j for i + j < the larger part count."""
    k = max(len(a_parts), len(b_parts))
    return sum(torch.einsum(eq, a, b) for i, a in enumerate(a_parts)
               for j, b in enumerate(b_parts) if i + j < k)


def ssd_chunked_parts(x, dt, A, B, C, *, chunk: int, parts: int, h0=None):
    """The arithmetic of the ``ssd_scan`` CUDA kernel, emulated on the
    CPU to choose and check its numerics (it is not a plain version: the
    kernel is held against ``ssd_chunked``).  As the kernel schedules it:
    each chunk's own state from zero, passed on in chunk order, then the
    chunk's outputs.  Every tensor-core product is exact over bf16 parts
    of its operands (f64 here, the kernel's f32 accumulators rounded to
    f32 where it holds them): bf16 inputs are one exact part, f32 inputs
    three; the f32 operands ``M``, ``w x`` and the entering state are
    ``parts`` parts (the kernel: 2 beside bf16 inputs, 3 beside f32; 1 is
    a single bf16 rounding).  cum, the exps, ``M`` and the state passing
    are f32, as in the kernel.  Same shapes as ``ssd_chunked``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    L = chunk
    k_in = 1 if x.dtype == torch.bfloat16 else 3
    A = A.float()
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    mask = torch.full((), SSD_MASK)
    hcur = torch.zeros((b, h, p, n)) if h0 is None else h0.float()
    ys = []
    for c0 in range(0, s, L):
        xc = x[:, c0:c0 + L]
        dtc = dt[:, c0:c0 + L].float()
        xp, Bp, Cp = (_bf16_parts(v, k_in)
                      for v in (xc, B[:, c0:c0 + L, 0], C[:, c0:c0 + L, 0]))
        cum = torch.cumsum(A * dtc, dim=1)                    # (b, L, h)
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        decay = torch.exp(torch.where(causal[None, :, :, None], seg, mask))
        cb = _parts_product("btn,bsn->bts", Cp, Bp).float()
        M = cb[..., None] * decay * dtc[:, None, :, :]        # f32
        inter = _parts_product("btn,bhpn->bthp", Cp,
                               _bf16_parts(hcur, parts)).float()
        inter = inter * torch.exp(cum)[..., None]
        y = inter.double() + _parts_product("btsh,bshp->bthp",
                                            _bf16_parts(M, parts), xp)
        w = torch.exp(cum[:, -1:, :] - cum) * dtc             # (b, L, h)
        xw = xc.float() * w[..., None]
        upd = _parts_product("blhp,bln->bhpn", _bf16_parts(xw, parts),
                             Bp).float()
        hcur = hcur * torch.exp(cum[:, -1, :])[:, :, None, None] + upd
        ys.append(y.float())
    return torch.cat(ys, dim=1), hcur
