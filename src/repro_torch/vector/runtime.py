"""The vector execution engine on PyTorch: fixed-step queueing dynamics
for every grid cell at once, on the CUDA card.

Port of ``repro.vector.runtime``.  The whole grid's state ``(backlog,
queue length)`` with axes ``[cell, server]`` advances through
``n_slots`` fixed steps of width ``dt``:

* per-slot Poisson arrival counts and CLT-aggregated service work are
  pre-drawn per cell on the host with NumPy, from the cell's own seeded
  ``Generator`` — the same draws as the reference, bit for bit;
* the slot scan runs as ONE kernel launch per chunk on the card
  (``kernels.ops.scalar_scan`` / ``batched_scan``), and as a Python
  loop over the plain PyTorch step when the caller asks for the CPU;
* the stationary-wait terms (Erlang-C, episode age, pooled law) stay
  host-side NumPy, as in the reference;
* requests are sampled and censored on the host, and p50/p95/p99 of
  every cell of a chunk come from one fused quantile launch.

``VectorConfig.soft`` is the reference's differentiable mode: the scan
consts carry ``tau``, which sends the step to its plain PyTorch version
with the smoothed water-fill (``kernels.ref.soft_waterfill``) on the
grid's own device, the card included — the reference pins soft consts
to its jnp step too, and no kernel implements them.  The host terms
take the smoothed Erlang-C and utilization ceiling, the sampler a
smoothed queue indicator on the same draws, every sample a smooth
censor keep-weight, and the quantiles come from ``soft_quantiles`` over
the full weighted sample.  A soft grid runs one eager step per slot:
slow, and meant for diagnostics.

Device work is f32 (consts, carry and xs cast as the reference casts
them; ``fail_slot`` and the slot index int32) and outputs are widened to
f64 on the host.  Each chunk's outputs come back in one device-to-host
copy.  Cells group into geometric (T, S) shape buckets, and chunks are
double-buffered: chunk k+1's scan runs while the host finishes chunk k.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.vector import soft as _soft
from repro_torch.vector.compile import VectorProgram, compile_experiment

_BIG = 1e18
_EPS = 1e-12
#: offered load above which the stationary wait is diffusion-bounded
_NEAR_CRITICAL = 0.9


#: soft mode's temperature (relative) and its quantile head's bandwidth,
#: as a fraction of the effective count (the reference ``VectorConfig``'s
#: ``tau`` and ``band_frac`` defaults)
SOFT_TAU = 0.05
SOFT_BAND_FRAC = 5e-4


@dataclass
class VectorConfig:
    dt: float = 0.005               # slot width (seconds)
    samples: int = 32768            # latency-sample budget per cell
    max_slot_elems: int = 64_000_000   # chunk cells when T*C*S exceeds this
    pipeline: bool = True           # double-buffer chunks: the scan of
                                    # chunk k+1 overlaps host finishing
                                    # (sampling, quantiles) of chunk k
    device: str = "cuda"            # "cuda" (the card) or "cpu" (the
                                    # kernels' plain PyTorch versions)
    soft: bool = False              # differentiable mode: smoothed
                                    # water-filling / Erlang-C / censoring
                                    # and the soft quantile head (the
                                    # plain step, on ``device``)


# ---------------------------------------------------------------------------
# Per-cell result
# ---------------------------------------------------------------------------
@dataclass
class VectorResult:
    """Extracted results for one (point, rep) cell."""
    n: int
    mean: float
    p50: float
    p95: float
    p99: float
    dropped: int
    interval: float
    slo: Optional[float]
    server_ids: list
    samples: np.ndarray             # kept latency samples (uniform over
                                    # completed requests)
    sample_ivl: np.ndarray          # completion interval per kept sample
    n_ivl: np.ndarray               # [n_ivls] completions per interval
    util_ivl: np.ndarray            # [n_ivls, S] utilization
    occ_ivl: np.ndarray             # [n_ivls, S] occupancy
    qdepth_ivl: np.ndarray          # [n_ivls, S] queue depth at boundary
    tokens_ivl: Optional[np.ndarray] = None   # [n_ivls, S] tokens/sec
    shed_ivl: Optional[np.ndarray] = None     # [n_ivls] admission-shed
                                              # requests (fluid expectation)


# ---------------------------------------------------------------------------
# Host-side analytic terms (never enter the scan)
# ---------------------------------------------------------------------------
def _lgamma(c: np.ndarray) -> np.ndarray:
    """lgamma(c + 1) for small-integer capacity arrays via a lookup
    table."""
    hi = int(np.max(c)) + 1 if c.size else 1
    table = np.array([math.lgamma(k + 1.0) for k in range(hi + 1)])
    return table[np.clip(c.astype(np.int64), 0, hi)]


def _erlang_c(c, lgamma_c, rho, cmax: int):
    """Erlang-C delay probability (P(arrival must queue) in M/M/c),
    vectorized with per-server integer capacity ``c`` <= cmax."""
    rho = np.clip(rho, 1e-9, 0.999)
    a = c * rho
    top = np.exp(c * np.log(a) - lgamma_c)
    term = np.ones_like(a)
    ssum = np.zeros_like(a)
    for k in range(cmax):
        ssum = ssum + np.where(k < c, term, 0.0)
        term = term * a / (k + 1.0)
    denom = (1.0 - rho) * ssum + top
    return top / np.maximum(denom, _EPS)


def _episode_age(rho: np.ndarray, t_idx: np.ndarray, dt: float,
                 band: float = _NEAR_CRITICAL) -> np.ndarray:
    """Seconds since each lane's offered load last sat below ``band``
    (>= dt).  Lanes hot from t=0 age from the run start."""
    idx = t_idx.reshape((-1,) + (1,) * (rho.ndim - 1)).astype(float)
    last_low = np.maximum.accumulate(np.where(rho < band, idx, -1.0),
                                     axis=0)
    return np.maximum(idx - last_low, 1.0) * dt


# ---------------------------------------------------------------------------
# Grid execution
# ---------------------------------------------------------------------------
def _cell_rng(seed: int, stream: int) -> np.random.Generator:
    """The cell's private RNG: seeded by the sweep-derived (seed,
    stream), domain-separated from every scalar-path stream."""
    return np.random.default_rng((0x7EC7, int(seed), int(stream)))


def _draw_cell(prog: VectorProgram, rng: np.random.Generator) -> dict:
    """Pre-scan draws for one cell, in a FIXED order (the same numbers
    whether the cell runs alone or inside any grid)."""
    dt = prog.dt
    Nc = rng.poisson(prog.rate_conn * dt).astype(float)
    Nf = rng.poisson(prog.rate_free * dt).astype(float)
    if not prog.batched:
        # the scalar backlog is a pure fluid: expected work per slot;
        # stochastic queueing below saturation is carried by the
        # analytic stationary term
        m = prog.work_mean                            # [S]
        return {"Nc": Nc, "Wc": prog.rate_conn * dt * m, "Nf": Nf,
                "Wf": prog.rate_free * dt * float(m.mean())}
    zc = rng.standard_normal(Nc.shape)
    zf = rng.standard_normal(Nf.shape)
    zc2 = rng.standard_normal(Nc.shape)
    zf2 = rng.standard_normal(Nf.shape)
    pm, pv = prog.prefill_mean, prog.prefill_var
    nm, nv = prog.new_mean, prog.new_var
    Wpc = np.maximum(Nc * pm + np.sqrt(Nc * pv) * zc, 0.05 * Nc * pm)
    Wtc = np.maximum(Nc * nm + np.sqrt(Nc * nv) * zc2, 0.05 * Nc * nm)
    Wpf = np.maximum(Nf * pm + np.sqrt(Nf * pv) * zf, 0.05 * Nf * pm)
    Wtf = np.maximum(Nf * nm + np.sqrt(Nf * nv) * zf2, 0.05 * Nf * nm)
    return {"Nc": Nc, "Wpc": Wpc, "Wtc": Wtc, "Nf": Nf,
            "Wpf": Wpf, "Wtf": Wtf}


def _pad(a: np.ndarray, T: int, S: int) -> np.ndarray:
    """Zero-pad a per-cell [T_i(, S_i)] array to the group shape."""
    if a.ndim == 1:
        out = np.zeros(T)
        out[:a.shape[0]] = a
        return out
    out = np.zeros((T, S))
    out[:a.shape[0], :a.shape[1]] = a
    return out


#: geometric bucket resolution: sizes per octave (<= 1/quantum relative
#: padding waste; tiny dims stay exact)
_BUCKET_QUANTUM = 8


def _bucket_dim(n: int, quantum: int = _BUCKET_QUANTUM) -> int:
    """Round ``n`` up to the next geometric bucket so heterogeneous
    grids collapse onto a few pad shapes."""
    n = int(n)
    if n <= quantum:
        return n
    step = max(1, (1 << ((n - 1).bit_length() - 1)) // quantum)
    return -(-n // step) * step


def _plan_groups(programs: Sequence[VectorProgram]) -> list:
    """Group cell indices by (family, bucketed (T, S) shape).  Padding
    is masking, never truncation: a cell's draws use its true shape and
    extraction slices it back out."""
    groups: dict = {}
    for i, p in enumerate(programs):
        shape = (_bucket_dim(p.n_slots), _bucket_dim(p.n_servers))
        groups.setdefault((p.batched, shape), []).append(i)
    return [(batched, shape, idxs)
            for (batched, shape), idxs in sorted(groups.items())]


def run_cells(programs: Sequence[VectorProgram],
              seeds: Sequence[tuple],
              config: Optional[VectorConfig] = None,
              cache=None) -> list[VectorResult]:
    """Execute one cell per (program, (seed, stream)) pair — the whole
    grid as one batched array program per (family, shape bucket),
    chunked to bound scan memory, on ``config.device``.

    With a ``repro_torch.cache.ResultCache``, cached cells are filtered
    out BEFORE ``_plan_groups``: only cold cells enter the batched scan,
    so a re-run of a 117-cell grid with 3 edited points launches 3
    cells, and a grid whose every cell hits returns without touching the
    device.  Each cell's draws come from its own seeded Generator, so
    which cells happen to be cold can never change any cell's bits.
    Completed cells are stored as their chunk finishes.

    Chunks are double-buffered when ``cfg.pipeline``: chunk k+1's scan
    is launched before chunk k's host finishing runs.  Both orders give
    identical rows: a cell's numbers depend only on its own program,
    seed and config."""
    cfg = config or VectorConfig()
    results: list[Optional[VectorResult]] = [None] * len(programs)
    keys: list[Optional[str]] = [None] * len(programs)
    if cache is not None:
        cold = []
        for i, (p, s) in enumerate(zip(programs, seeds)):
            keys[i] = cache.cell_key(p, s, cfg)
            hit = cache.get_cell(keys[i]) if keys[i] is not None else None
            if hit is not None:
                results[i] = hit
            else:
                cold.append(i)
    else:
        cold = list(range(len(programs)))
    if not cold:
        return results  # type: ignore[return-value]

    device = resolve_device(cfg.device)
    cold_progs = [programs[i] for i in cold]
    chunks = []                     # (batched, shape, indices into cold)
    for batched, shape, idxs in _plan_groups(cold_progs):
        per_cell = max(shape[0] * shape[1], 1)
        chunk = max(1, cfg.max_slot_elems // per_cell)
        for lo in range(0, len(idxs), chunk):
            chunks.append((batched, shape, idxs[lo:lo + chunk]))

    def finish(state, part):
        for j, res in zip(part, _finish_family(state)):
            i = cold[j]
            results[i] = res
            if cache is not None and keys[i] is not None:
                cache.put_cell(keys[i], res)

    pending = None
    for batched, shape, part in chunks:
        state = _launch_family([cold_progs[j] for j in part],
                               [seeds[cold[j]] for j in part],
                               batched, cfg, shape, device)
        if not cfg.pipeline:
            finish(state, part)
            continue
        if pending is not None:
            finish(*pending)
        pending = (state, part)
    if pending is not None:
        finish(*pending)
    return results  # type: ignore[return-value]


def _to_device(arrays: list, dtype, device: torch.device) -> list:
    """Stack same-shape host arrays, cast, and move them in ONE copy ->
    contiguous per-array views on ``device``."""
    host = torch.from_numpy(np.ascontiguousarray(
        np.stack(arrays), dtype=dtype))
    return list(host.to(device).unbind(0))


def scan_inputs(progs: list, draws: list, batched: bool, shape: tuple,
                device: torch.device) -> tuple:
    """Assemble one (family, shape) chunk's scan inputs on ``device``:
    (consts, carry, xs) in the f32 / int32 layout the kernels take."""
    C = len(progs)
    T, S = shape

    def stack(key: str) -> np.ndarray:
        return np.stack([_pad(d[key], T, S) for d in draws], axis=1)

    def stackp(attr: str) -> np.ndarray:
        return np.stack([_pad(getattr(p, attr), T, S) for p in progs],
                        axis=1)

    c = np.stack([np.pad(p.workers, (0, S - p.n_servers)) for p in progs])
    fail = np.stack([np.pad(p.fail_slot, (0, S - p.n_servers),
                            constant_values=-1) for p in progs])
    consts = {"c": _to_device([c], np.float32, device)[0],
              "fail_slot": _to_device([fail], np.int32, device)[0],
              # f32 slot width, as the reference casts it
              "dt": float(np.float32(progs[0].dt))}
    t_idx = torch.arange(T, dtype=torch.int32, device=device)
    lanes = ("Nc", "Wc") if not batched else ("Nc", "Wpc", "Wtc")
    cells = ("Nf", "Wf") if not batched else ("Nf", "Wpf", "Wtf")
    lane_x = _to_device([stack(k) for k in lanes]
                        + [stackp("active"), stackp("accepting"),
                           stackp("speed")], np.float32, device)
    cell_x = _to_device([stack(k) for k in cells], np.float32, device)
    xs = (t_idx, *lane_x[:len(lanes)], *cell_x, *lane_x[len(lanes):])
    n_lanes = 2 if not batched else 3
    carry = tuple(torch.zeros((C, S), dtype=torch.float32, device=device)
                  for _ in range(n_lanes)) + (
        torch.zeros(C, dtype=torch.float32, device=device),)
    if batched:
        roof = _to_device(
            [np.array([[p.service.t_memory] for p in progs]),
             np.array([[p.service.t_compute_per_seq] for p in progs]),
             np.array([[p.new_mean] for p in progs])], np.float32, device)
        consts.update(tm=roof[0], tc=roof[1], new_mean=roof[2])
    return consts, carry, xs


def _launch_family(progs: list, seeds: list, batched: bool,
                   cfg: VectorConfig, shape: tuple,
                   device: torch.device) -> dict:
    """Draw, assemble and LAUNCH one (family, shape) chunk.

    On the card the scan and the device-to-host copy of its outputs are
    queued and this returns before they complete; the host-side
    analytic terms are computed meanwhile.  ``_finish_family`` waits."""
    C = len(progs)
    T, S = shape
    dt = progs[0].dt
    rngs = [_cell_rng(s, st) for s, st in seeds]
    draws = [_draw_cell(p, r) for p, r in zip(progs, rngs)]
    consts, carry, xs = scan_inputs(progs, draws, batched, shape, device)
    if cfg.soft:
        consts["tau"] = SOFT_TAU
    scan = ops.batched_scan if batched else ops.scalar_scan
    out_carry, ys = scan(consts, carry, xs)
    # ONE device->host copy for the whole chunk
    parts = list(ys) + list(out_carry)
    flat = torch.cat([p.reshape(-1) for p in parts])
    if device.type == "cuda":
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    else:
        host, done = flat, None
    state = {"progs": progs, "rngs": rngs, "draws": draws,
             "batched": batched, "cfg": cfg, "C": C, "device": device,
             "host": host, "done": done,
             "shapes": [tuple(p.shape) for p in parts], "n_ys": len(ys)}

    # ---- host-side analytic aux (overlaps the launched scan) -----------
    act = np.stack([_pad(p.active, T, S) for p in progs], axis=1)
    acc = np.stack([_pad(p.accepting, T, S) for p in progs], axis=1)
    spd = np.stack([_pad(p.speed, T, S) for p in progs], axis=1)
    c = np.stack([np.pad(p.workers, (0, S - p.n_servers)) for p in progs])
    t_idx = np.arange(T, dtype=np.int64)
    rate_c = np.stack([_pad(p.rate_conn, T, S) for p in progs], axis=1)
    rate_f = np.stack([_pad(p.rate_free, T, S) for p in progs], axis=1)
    aux: dict = {}
    if not batched:
        m_w = np.stack([np.pad(p.work_mean, (0, S - p.n_servers),
                               constant_values=1.0) for p in progs])
        v_w = np.stack([np.pad(p.work_var, (0, S - p.n_servers))
                        for p in progs])
        # ---- analytic stationary wait --------------------------------------
        # deterministic per-slot offered load, with request-routed rate
        # spread capacity-proportionally over the accepting servers
        cap_share = acc * (c * spd)
        share = cap_share / np.maximum(
            cap_share.sum(axis=-1, keepdims=True), _EPS)
        lam_w = (rate_c + rate_f[..., None] * share) * m_w[None]
        rho_det = np.where(act > 0,
                           lam_w / np.maximum(c * spd, _EPS), 0.0)
        lgamma_c = _lgamma(c)
        cmax = int(c.max()) if c.size else 1
        if cfg.soft:
            aux["pC"] = _soft.soft_erlang_c(np, c[None].astype(float),
                                            rho_det, cmax, SOFT_TAU)
            headroom = 1.0 - _soft.smooth_rho(np, rho_det, SOFT_TAU)
        else:
            aux["pC"] = _erlang_c(c[None], lgamma_c[None], rho_det, cmax)
            headroom = 1.0 - np.clip(rho_det, 0.0, 0.999)
        # conditional wait given queueing: residual service work over
        # the free capacity (exact Pollaczek-Khinchine mean for c=1),
        # bounded near/above criticality by the diffusion growth law
        e2 = v_w + m_w * m_w
        resid = e2 / np.maximum(2.0 * m_w, _EPS)
        w_stat = resid[None] / np.maximum(c[None] * spd * headroom, _EPS)
        lam_srv = rho_det * c[None] * spd / np.maximum(m_w[None], _EPS)
        # the diffusion clock runs from the start of the CURRENT
        # near-critical episode
        t_since = _episode_age(rho_det, t_idx, dt)
        growth = np.sqrt(2.0 / math.pi * lam_srv * e2[None] * t_since) \
            / np.maximum(c[None] * spd, _EPS)
        aux["w_cond"] = np.where(rho_det < _NEAR_CRITICAL, w_stat,
                                 np.minimum(w_stat, growth))
        # ---- pooled law for request-routed arrivals ------------------------
        # jsq/p2c pool the fleet: an arrival queues only when EVERY
        # accepting server is busy — Erlang-C over the pooled capacity
        m_bar = np.array([float(p.work_mean.mean()) for p in progs])
        e2_bar = np.array([float((p.work_var + p.work_mean ** 2).mean())
                           for p in progs])
        resid_bar = e2_bar / np.maximum(2.0 * m_bar, _EPS)
        cap_pool = (acc * c[None] * spd).sum(axis=-1)          # [T, C]
        work_rate = (rate_c * m_w[None]).sum(axis=-1) \
            + rate_f * m_bar[None]
        rho_pool = np.where(cap_pool > 0,
                            work_rate / np.maximum(cap_pool, _EPS), 0.0)
        c_pool = np.minimum(np.maximum((acc * c[None]).sum(axis=-1), 1.0),
                            64.0)
        if cfg.soft:
            aux["pC_free"] = _soft.soft_erlang_c(np, c_pool, rho_pool,
                                                 int(c_pool.max()),
                                                 SOFT_TAU)
            headroom_f = 1.0 - _soft.smooth_rho(np, rho_pool, SOFT_TAU)
        else:
            aux["pC_free"] = _erlang_c(c_pool, _lgamma(c_pool), rho_pool,
                                       int(c_pool.max()))
            headroom_f = 1.0 - np.clip(rho_pool, 0.0, 0.999)
        w_stat_f = resid_bar[None] / np.maximum(cap_pool * headroom_f,
                                                _EPS)
        lam_pool = rho_pool * cap_pool / np.maximum(m_bar[None], _EPS)
        t_since_f = _episode_age(rho_pool, t_idx, dt)
        growth_f = np.sqrt(2.0 / math.pi * lam_pool * e2_bar[None]
                           * t_since_f) / np.maximum(cap_pool, _EPS)
        aux["w_cond_free"] = np.where(rho_pool < _NEAR_CRITICAL, w_stat_f,
                                      np.minimum(w_stat_f, growth_f))
        aux["free_ok"] = (acc.sum(axis=-1) > 0).astype(float)
        aux["spd_free"] = np.where(
            acc.sum(axis=-1) > 0,
            (acc * c[None] * spd).sum(axis=-1)
            / np.maximum((acc * c[None]).sum(axis=-1), _EPS), 1.0)
    else:
        # a resident's wall-clock pace per own token stretches by the
        # prefill ops interleaved with decode — deterministic expected
        # prefill time-share
        share_even = acc / np.maximum(acc.sum(axis=-1, keepdims=True),
                                      _EPS)
        pf_mean = np.array([p.prefill_mean for p in progs])
        pf_share = np.clip((rate_c + rate_f[..., None] * share_even)
                           * pf_mean[None, :, None]
                           / np.maximum(spd, _EPS), 0.0, 0.8)
        aux["stretch"] = 1.0 / (1.0 - pf_share)
    state["aux"] = aux
    return state


def _fetch(state: dict) -> tuple:
    """Wait for a launched chunk's copy and widen host-side to f64 ->
    (carry, outs) as NumPy arrays."""
    if state["done"] is not None:
        state["done"].synchronize()
    flat = state["host"].numpy()
    arrays, off = [], 0
    for shape in state["shapes"]:
        n = int(np.prod(shape))
        arrays.append(flat[off:off + n].reshape(shape).astype(np.float64))
        off += n
    k = state["n_ys"]
    return tuple(arrays[k:]), tuple(arrays[:k])


def _finish_family(state: dict) -> list[VectorResult]:
    """Fetch a launched chunk's scan outputs and extract every cell's
    results (sampling, censoring, fused-grid percentiles)."""
    progs, rngs, draws = state["progs"], state["rngs"], state["draws"]
    batched, cfg, aux = state["batched"], state["cfg"], state["aux"]
    carry, outs = _fetch(state)
    cells = [_sample_cell(progs[i], rngs[i], i, batched, carry, outs, aux,
                          draws[i], cfg)
             for i in range(state["C"])]
    if cfg.soft:
        quants = _soft_grid_quantiles([cell["lat_all"] for cell in cells],
                                      [cell["w_all"] for cell in cells],
                                      state["device"])
    else:
        quants = _grid_quantiles([cell["lat"] for cell in cells],
                                 state["device"])
    return [_finish_cell(progs[i], batched, cells[i], quants[i])
            for i in range(state["C"])]


# ---------------------------------------------------------------------------
# Per-cell extraction: sampling, censoring, fused-grid percentiles
# ---------------------------------------------------------------------------
def _sample_cell(prog: VectorProgram, rng: np.random.Generator, i: int,
                 batched: bool, carry, outs, aux: dict, draws: dict,
                 cfg: VectorConfig) -> dict:
    """Draw this cell's request sample from the slot series (uniform over
    realized arrivals, event-engine censoring) — everything per-cell
    EXCEPT the percentiles, which `_grid_quantiles` computes for the
    whole chunk in one fused launch."""
    T, S = prog.n_slots, prog.n_servers
    dt = prog.dt
    if not batched:
        wait_U = outs[0][:T, i, :S]
        wait_free = outs[1][:T, i]
        n_served = outs[2][:T, i, :S]
        drained = outs[3][:T, i, :S]
        Qs = outs[4][:T, i, :S]
        pC = aux["pC"][:T, i, :S]
        w_cond = aux["w_cond"][:T, i, :S]
        pC_f = aux["pC_free"][:T, i]
        w_cond_f = aux["w_cond_free"][:T, i]
        free_ok = aux["free_ok"][:T, i]
        spd_f = aux["spd_free"][:T, i]
    else:
        wait_adm, st_hat, N_arr, n_served, drained, Qs, tok_served = \
            (o[:T, i, :S] for o in outs)
    drops = float(carry[-1][i])

    centers = (np.arange(T) + 0.5) * dt
    speed = prog.speed

    # ---- request sampling (uniform over realized arrivals) -----------------
    # scalar cells keep connection-routed and request-routed arrivals in
    # separate weight blocks: conn samples see their server's stationary
    # law, free samples the POOLED fleet law
    if not batched:
        w = np.concatenate([draws["Nc"].ravel(), draws["Nf"] * free_ok])
    else:
        w = N_arr.ravel()
    total = w.sum()
    K = int(min(cfg.samples, math.ceil(total))) if total > 0 else 0
    if K > 0:
        cum = np.cumsum(w)
        u = rng.random(K) * cum[-1]
        flat = np.searchsorted(cum, u, side="right")
        flat = np.minimum(flat, w.size - 1)
        if not batched:
            is_free = flat >= T * S
            ts = np.where(is_free, flat - T * S, flat // S)
            ss = np.where(is_free, 0, flat % S)
            demand = prog.profile.sample_batch(rng, K)
            if prog.noise_sigma.any():
                sig = np.where(is_free, float(prog.noise_sigma.mean()),
                               prog.noise_sigma[ss])
                demand = demand * np.exp(sig * rng.standard_normal(K))
            spd_i = np.where(is_free, spd_f[ts], speed[ts, ss])
            svc = demand / np.maximum(spd_i, _EPS)
            # wait = inherited backlog (always, PASTA) + the stationary
            # within-slot queue: Bernoulli(Erlang-C) x Exp(conditional)
            pC_i = np.where(is_free, pC_f[ts], pC[ts, ss])
            # Soft mode reuses the SAME uniform/exponential draws and
            # only smooths the indicator (reparameterization)
            u_q = rng.random(K)
            e_q = rng.standard_exponential(K)
            if cfg.soft:
                queued = _soft.stable_sigmoid(np, (pC_i - u_q) / SOFT_TAU)
            else:
                queued = u_q < pC_i
            station = queued * e_q \
                * np.where(is_free, w_cond_f[ts], w_cond[ts, ss])
            lat = np.where(is_free, wait_free[ts], wait_U[ts, ss]) \
                + station + svc
            # request-routed arrivals never target a dead server; conn
            # arrivals caught by their server's failure are lost
            fail_t = np.where(is_free | (prog.fail_slot[ss] < 0), np.inf,
                              prog.fail_slot[ss] * dt)
        else:
            ts, ss = np.divmod(flat, S)
            spd_i = speed[ts, ss]
            ptoks, ntoks = prog.lengths.sample_batch(rng, K)
            pf = prog.service.prefill_time_array(ptoks)
            stretch = aux["stretch"][:T, i, :S][ts, ss]
            lat = wait_adm[ts, ss] + \
                (pf + ntoks * st_hat[ts, ss] * stretch) \
                / np.maximum(spd_i, _EPS)
            fail_t = np.where(prog.fail_slot[ss] >= 0,
                              prog.fail_slot[ss] * dt, np.inf)
        completion = centers[ts] + lat
        # censor like the event engine's recorder: completions past the
        # horizon are never recorded, and a request caught on a failing
        # server (arrived in its fail slot, or completing after the fail
        # instant) is lost.  Soft mode additionally keeps the FULL
        # sample with smooth keep-weights for the soft quantile head
        # (the stored samples stay hard-censored for telemetry).
        if cfg.soft:
            lat_all = lat
            w_all = _soft.censor_weight(np, centers[ts], completion,
                                        prog.duration, fail_t,
                                        80.0 * dt * SOFT_TAU)
        keep = (completion <= prog.duration) & (centers[ts] < fail_t) \
            & (completion <= fail_t)
        lat = lat[keep]
        completion = completion[keep]
    else:
        lat = np.empty(0)
        completion = np.empty(0)
        lat_all = np.empty(0)
        w_all = np.empty(0)

    out = {"lat": lat, "completion": completion, "n_served": n_served,
           "drained": drained, "Qs": Qs, "drops": drops,
           "tok_served": tok_served if batched else None}
    if cfg.soft:
        out["lat_all"] = lat_all
        out["w_all"] = w_all
    return out


def _grid_quantiles(lats: list, device: torch.device) -> np.ndarray:
    """p50/p95/p99 for every cell of a chunk -> [C, 3] f64 (NaN rows
    when a cell has no samples): ONE fused launch over a [C, K]
    +inf-padded f32 matrix.  Means are NOT computed here: the row mean
    stays host-side f64 so it cannot depend on the pad width K."""
    mat, counts = _quantile_matrix(lats)
    if mat is None:
        return np.full((len(lats), 3), float("nan"))
    out = ops.fused_quantiles(torch.from_numpy(mat).to(device),
                              torch.from_numpy(counts).to(device))
    return out.cpu().numpy().astype(np.float64)


def _soft_grid_quantiles(lats: list, weights: list,
                         device: torch.device) -> np.ndarray:
    """Soft mode's head: p50/p95/p99 of every cell's full sample under
    its censor keep-weights -> [C, 3] f64, one ``soft_quantiles`` call
    over a [C, K] f32 matrix (+inf samples at zero weight past each
    cell's count)."""
    mat, _ = _quantile_matrix(lats)
    if mat is None:
        return np.full((len(lats), 3), float("nan"))
    wmat = np.zeros(mat.shape, np.float32)
    for i, w in enumerate(weights):
        wmat[i, :w.size] = w
    out = _soft.soft_quantiles(torch.from_numpy(mat).to(device),
                               torch.from_numpy(wmat).to(device),
                               band_frac=SOFT_BAND_FRAC)
    return out.cpu().numpy().astype(np.float64)


def _quantile_matrix(lats: list) -> tuple:
    """The fused launch's inputs: ([C, K] f32 samples, +inf past each
    count; [C] int32 counts), K the largest count; (None, counts) when
    no cell has a sample."""
    counts = np.array([lat.size for lat in lats], np.int32)
    K = int(counts.max()) if len(lats) else 0
    if K == 0:
        return None, counts
    mat = np.full((len(lats), K), np.inf, np.float32)
    for i, lat in enumerate(lats):
        mat[i, :lat.size] = lat
    return mat, counts


def _finish_cell(prog: VectorProgram, batched: bool, cell: dict,
                 q3) -> VectorResult:
    T, S = prog.n_slots, prog.n_servers
    dt = prog.dt
    speed = prog.speed
    lat = cell["lat"]
    completion = cell["completion"]
    n_served = cell["n_served"]
    drained = cell["drained"]
    Qs = cell["Qs"]
    tok_served = cell["tok_served"]
    drops = cell["drops"]

    n = int(round(float(n_served.sum())))
    if lat.size:
        p50, p95, p99 = (float(v) for v in q3)
        mean = float(lat.mean())
    else:
        p50 = p95 = p99 = mean = float("nan")

    # ---- interval series ---------------------------------------------------
    spi = max(1, int(round(prog.interval / dt)))     # slots per interval
    n_ivls = int(math.ceil(T / spi))
    pad_to = n_ivls * spi

    def ivl_sum(a):                                   # [T, S] -> [n_ivls, S]
        buf = np.zeros((pad_to, a.shape[1]))
        buf[:T] = a
        return buf.reshape(n_ivls, spi, a.shape[1]).sum(axis=1)

    n_ivl = ivl_sum(n_served).sum(axis=1)
    busy_seconds = (drained / np.maximum(speed, _EPS)) if not batched \
        else drained
    util_cap = prog.workers[None, :] * prog.interval if not batched \
        else np.full((1, S), prog.interval)
    util_ivl = np.minimum(ivl_sum(busy_seconds) / np.maximum(util_cap,
                                                             _EPS), 1.0)
    # queue depth / occupancy at interval boundaries (last slot of each)
    ends = np.minimum(np.arange(1, n_ivls + 1) * spi - 1, T - 1)
    qdepth_ivl = Qs[ends]
    if batched:
        occ_ivl = np.minimum(Qs[ends] / np.maximum(prog.workers[None, :],
                                                   1.0), 1.0)
        tokens_ivl = ivl_sum(tok_served) / prog.interval
    else:
        occ_ivl = util_ivl
        tokens_ivl = None
    sample_ivl = np.minimum(completion / prog.interval,
                            n_ivls - 1 + 1e-9).astype(np.int64) \
        if completion.size else np.empty(0, np.int64)

    # admission shedding (fluid expectation): sheds count into
    # ``dropped`` so they are never silently missing from totals
    if prog.shed_rate is not None:
        shed_slot = np.zeros(pad_to)
        shed_slot[:T] = prog.shed_rate * dt
        shed_ivl = shed_slot.reshape(n_ivls, spi).sum(axis=1)
        shed_total = float(shed_ivl.sum())
    else:
        shed_ivl = None
        shed_total = 0.0

    return VectorResult(
        n=n, mean=mean, p50=float(p50), p95=float(p95), p99=float(p99),
        dropped=int(round(drops + shed_total)) + prog.refused_clients,
        interval=prog.interval, slo=prog.slo, server_ids=prog.server_ids,
        samples=lat, sample_ivl=sample_ivl, n_ivl=n_ivl,
        util_ivl=util_ivl, occ_ivl=occ_ivl, qdepth_ivl=qdepth_ivl,
        tokens_ivl=tokens_ivl, shed_ivl=shed_ivl)


# ---------------------------------------------------------------------------
# Runtime adapter (single cell — scenario CLI)
# ---------------------------------------------------------------------------
class VectorRuntime:
    """``Runtime``-shaped adapter over one (experiment, rep) cell: the
    same numbers the grid path gives for the same (seed, stream).  A
    ``cache`` (``repro_torch.cache.ResultCache``) serves the cell warm
    when it holds it."""

    def __init__(self, experiment, rep: int = 0,
                 config: Optional[VectorConfig] = None, cache=None):
        self.experiment = experiment
        self.config = config or VectorConfig()
        self.cache = cache
        self.program = compile_experiment(experiment, dt=self.config.dt)
        self.seed = (experiment.seed, rep)
        self.unsupported = self.program.unsupported
        self.telemetry = None
        self.result: Optional[VectorResult] = None

    @property
    def dropped(self) -> int:
        return self.result.dropped if self.result is not None else 0

    @property
    def shed(self) -> int:
        r = self.result
        if r is None or r.shed_ivl is None:
            return 0
        return int(round(float(r.shed_ivl.sum())))

    @property
    def control_log(self) -> list:
        return self.program.control_actions

    def run(self):
        from repro_torch.vector.telemetry import VectorTelemetry
        self.result = run_cells([self.program], [self.seed],
                                self.config, cache=self.cache)[0]
        self.telemetry = VectorTelemetry(self.result)
        return self.telemetry
