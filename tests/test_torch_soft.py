"""The port's soft mode (``repro_torch.vector.soft`` and
``VectorConfig.soft``) against the JAX package's, on the CPU.

* NumPy branches (the soft runtime's host terms, the planner's hard
  twin) bit-equal to ``repro.vector.soft``'s on seeded inputs;
* torch branches in f32 against the jnp branches in f32 (rtol 1e-5;
  ``soft_quantiles`` 1e-5), including the reference's ``lgamma(c)`` in
  the tensor Erlang-C, pinned at c = 4, rho = 0.8 (0.855 where the
  textbook law reads 0.596);
* f64 gradients of every primitive against central differences, under
  the reference's own tolerances (``tests/test_plan.py``);
* the rank plan: ``soft_quantiles`` anchors on the port's own
  ``kernels.ref.quantile_ranks``; mass conservation of
  ``soft_waterfill`` at any temperature, and masked lanes exactly zero;
* soft grids on ``device="cpu"`` against JAX ``VectorConfig(
  backend="jax", soft=True)`` rows on the reference agreement test's
  non-heavy scenarios (``n`` identical, p50/p95/p99/mean within rtol
  1e-4), and the port's own soft-against-hard agreement within the
  reference's 0.12 (mean 0.05).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.scenarios import get as jax_get  # noqa: E402
from repro.sweep.spec import spawn_seed  # noqa: E402
from repro.vector import VectorConfig as JaxConfig  # noqa: E402
from repro.vector import compile_experiment as jax_compile  # noqa: E402
from repro.vector import run_cells as jax_run_cells  # noqa: E402
from repro.vector import soft as jsoft  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.scenarios import get  # noqa: E402
from repro_torch.vector import (VectorConfig, compile_experiment,  # noqa: E402
                                run_cells)
from repro_torch.vector import soft  # noqa: E402

_BIG = 1e18
F64 = torch.float64


def _fd_check(f, x0: float, eps: float = 1e-5, rtol: float = 5e-3,
              atol: float = 1e-8) -> float:
    """Central-difference check of the autograd derivative of scalar
    ``f`` at ``x0``, in float64 (the reference's ``_fd_check``)."""
    x = torch.tensor(x0, dtype=F64, requires_grad=True)
    g = float(torch.autograd.grad(f(x), [x])[0])
    with torch.no_grad():
        fd = (float(f(torch.tensor(x0 + eps, dtype=F64)))
              - float(f(torch.tensor(x0 - eps, dtype=F64)))) / (2.0 * eps)
    assert abs(g - fd) <= rtol * max(abs(fd), abs(g)) + atol, \
        f"grad {g:.8g} vs FD {fd:.8g} at x={x0}"
    return g


def _rng(k: int) -> np.random.Generator:
    return np.random.default_rng((0x50F7, k))


# ---------------------------------------------------------------------------
# NumPy branches: bit-equal to the reference's
# ---------------------------------------------------------------------------
def _np_cases():
    r = _rng(0)
    x = r.normal(scale=30.0, size=257)
    x[:3] = (0.0, 1e4, -1e4)
    a, b = r.uniform(0.0, 2.0, 257), r.uniform(0.0, 2.0, 257)
    rho = r.uniform(0.0, 1.5, (40, 3))
    c = r.integers(1, 9, (40, 3)).astype(float)
    arrive = r.uniform(0.0, 8.0, 500)
    completion = arrive + r.exponential(0.2, 500)
    fail = np.where(r.random(500) < 0.3, r.uniform(0, 8, 500), np.inf)
    return {
        "stable_sigmoid": lambda m: m.stable_sigmoid(np, x),
        "softplus": lambda m: m.softplus(np, x),
        "smooth_min": lambda m: m.smooth_min(np, a, b, 0.07),
        "smooth_rho": lambda m: m.smooth_rho(np, rho, 0.05),
        "soft_erlang_c": lambda m: m.soft_erlang_c(np, c, rho, 8, 0.05),
        "soft_erlang_c_hard_tau": lambda m: m.soft_erlang_c(np, c, rho, 8,
                                                            1e-4),
        "censor_weight": lambda m: m.censor_weight(np, arrive, completion,
                                                   8.0, fail, 0.02),
    }


@pytest.mark.parametrize("name", sorted(_np_cases()))
def test_numpy_branches_bit_equal_reference(name):
    case = _np_cases()[name]
    got, want = case(soft), case(jsoft)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want), name


def test_numpy_erlang_c_matches_textbook_at_integers():
    """tau -> 0 at integer capacity recovers the exact Erlang-C law."""
    def erlang_c_exact(c: int, rho: float) -> float:
        a = c * rho
        ssum = sum(a ** k / math.factorial(k) for k in range(c))
        top = a ** c / math.factorial(c)
        return top / ((1.0 - rho) * ssum + top)

    for c in (1, 2, 8):
        for rho in (0.3, 0.7, 0.9):
            got = float(soft.soft_erlang_c(np, np.asarray(float(c)),
                                           np.asarray(rho), 64, 1e-4))
            assert got == pytest.approx(erlang_c_exact(c, rho), rel=1e-3)


# ---------------------------------------------------------------------------
# Tensor branches: f32 against the jnp branches
# ---------------------------------------------------------------------------
def _pair(a: np.ndarray):
    a32 = np.asarray(a, np.float32)
    return torch.from_numpy(a32.copy()), jnp.asarray(a32)


def _tensor_cases():
    r = _rng(1)
    x = r.normal(scale=30.0, size=257)
    x[:3] = (0.0, 1e4, -1e4)
    a, b = r.uniform(0.0, 2.0, 257), r.uniform(0.0, 2.0, 257)
    rho = r.uniform(0.0, 1.5, (40, 3))
    c = r.uniform(1.0, 9.0, (40, 3))
    arrive = r.uniform(0.0, 8.0, 500)
    completion = arrive + r.exponential(0.2, 500)
    U = r.uniform(0.0, 0.05, (6, 5))
    U[1, 2] = U[3, 0] = U[3, 4] = _BIG
    U[4] = _BIG
    total = r.uniform(0.0, 0.1, 6)
    return {
        "stable_sigmoid": ((x,), lambda m, xp, v: m.stable_sigmoid(xp, v)),
        "softplus": ((x,), lambda m, xp, v: m.softplus(xp, v)),
        "smooth_min": ((a, b), lambda m, xp, u, v: m.smooth_min(xp, u, v,
                                                                 0.07)),
        "smooth_rho": ((rho,), lambda m, xp, v: m.smooth_rho(xp, v, 0.05)),
        "soft_erlang_c": ((c, rho), lambda m, xp, u, v:
                          m.soft_erlang_c(xp, u, v, 16, 0.05)),
        "censor_weight": ((arrive, completion), lambda m, xp, u, v:
                          m.censor_weight(xp, u, v, 8.0, 6.0, 0.02)),
        "soft_waterfill": ((U, total), lambda m, xp, u, v:
                           m.soft_waterfill(u, v, 0.05) if m is soft
                           else m.soft_waterfill(xp, u, v, 0.05)),
    }


@pytest.mark.parametrize("name", sorted(_tensor_cases()))
def test_tensor_branches_match_jnp_f32(name):
    inputs, fn = _tensor_cases()[name]
    pairs = [_pair(v) for v in inputs]
    got = fn(soft, torch, *(p[0] for p in pairs)).numpy()
    want = np.asarray(fn(jsoft, jnp, *(p[1] for p in pairs)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_erlang_c_keeps_the_reference_lgamma_fault():
    """The tensor branch reproduces the reference jnp branch's
    ``lgamma(c)`` (its top term c times too large); the NumPy branch
    keeps the textbook ``lgamma(c + 1)``.  At tau 1e-4: (c, rho) = (1,
    0.5) 0.5 on every branch; (4, 0.8) 0.855 vs the textbook 0.596;
    (8, 0.9) 0.950 vs 0.702."""
    for c, rho, fault, textbook in ((1.0, 0.5, 0.5000, 0.5000),
                                    (4.0, 0.8, 0.8553, 0.5964),
                                    (8.0, 0.9, 0.9495, 0.7015)):
        t = float(soft.soft_erlang_c(torch, torch.tensor(c),
                                     torch.tensor(rho), 64, 1e-4))
        j = float(jsoft.soft_erlang_c(jnp, jnp.asarray(c, jnp.float32),
                                      jnp.asarray(rho, jnp.float32), 64,
                                      1e-4))
        n = float(soft.soft_erlang_c(np, np.asarray(c), np.asarray(rho),
                                     64, 1e-4))
        assert t == pytest.approx(j, rel=1e-5)
        assert t == pytest.approx(fault, abs=1e-4)
        assert n == pytest.approx(textbook, abs=1e-4)


def test_soft_quantiles_match_jnp_f32():
    """Weighted soft quantiles with +inf pads at weight 0, ties and a
    row with no effective samples (NaN), against the jnp head."""
    r = _rng(2)
    lat = r.exponential(size=(4, 300)).astype(np.float32)
    lat[0, 100:120] = lat[0, 5]                   # a tie run
    w = r.uniform(0.0, 1.0, (4, 300)).astype(np.float32)
    lat[1, 250:] = np.inf
    w[1, 250:] = 0.0
    w[3] = 0.0
    for band in (5e-4, 2e-3, 0.05):
        got = soft.soft_quantiles(torch.from_numpy(lat),
                                  torch.from_numpy(w),
                                  band_frac=band).numpy()
        want = np.asarray(jsoft.soft_quantiles(jnp.asarray(lat),
                                               jnp.asarray(w),
                                               band_frac=band))
        assert np.isnan(got[3]).all() and np.isnan(want[3]).all()
        np.testing.assert_allclose(got[:3], want[:3], rtol=1e-5)


def test_soft_quantiles_forward_agreement_unit_weights():
    """Narrow-band soft quantiles on unit weights converge to
    np.percentile's linear interpolation (the hard head's law)."""
    lat = _rng(3).exponential(size=2048).astype(np.float32)
    qs = (50.0, 95.0, 99.0)
    got = soft.soft_quantiles(torch.from_numpy(lat)[None, :],
                              torch.ones((1, lat.size)), qs=qs,
                              band_frac=1e-6)[0].numpy()
    np.testing.assert_allclose(got, np.percentile(lat, qs), rtol=5e-3)


def test_soft_quantiles_reuses_exact_rank_plan(monkeypatch):
    """``soft_quantiles`` anchors on the port's ``kernels.ref
    .quantile_ranks`` — bit-identical (pos, lo, hi), not a lookalike —
    and sorts stably, as ``jnp.argsort``."""
    captured = {}
    real = ref.quantile_ranks

    def spy(n_eff, qs):
        out = real(n_eff, qs)
        captured["plan"] = tuple(o.clone() for o in out)
        return out

    monkeypatch.setattr(ref, "quantile_ranks", spy)
    lat = torch.linspace(0.0, 1.0, 512)[None, :]
    qs = (50.0, 95.0, 99.0)
    soft.soft_quantiles(lat, torch.ones_like(lat), qs=qs)
    assert "plan" in captured, "surrogate bypassed the exact rank plan"
    for got, want in zip(captured["plan"],
                         real(torch.tensor([512.0]), qs)):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# f64 gradients against central differences (the reference's tolerances)
# ---------------------------------------------------------------------------
def test_fd_smooth_min():
    for a0 in (0.3, 0.95, 1.05, 1.4):
        _fd_check(lambda a: soft.smooth_min(torch, a, 1.0, 0.1), a0)
    assert float(soft.smooth_min(torch, torch.tensor(0.9, dtype=F64), 1.0,
                                 0.1)) <= 0.9


def test_fd_smooth_rho_gradient_survives_saturation():
    for r0 in (0.5, 0.95, 1.0, 1.3):
        g = _fd_check(lambda r: soft.smooth_rho(torch, r, 0.05), r0)
        assert g > 0.0, f"zero slope at rho={r0}"
    assert float(soft.smooth_rho(torch, torch.tensor(5.0, dtype=F64),
                                 0.05)) <= soft.RHO_MAX + 1e-6


def test_fd_censor_weight():
    inf = torch.tensor(math.inf, dtype=F64)
    one = torch.tensor(1.0, dtype=F64)
    for c0 in (7.8, 8.0, 8.5):
        _fd_check(lambda c: soft.censor_weight(torch, one, c, 8.0, inf,
                                               0.1), c0)
    # unfailed server: the fail sigmoids saturate to exactly 1
    w_inf = float(soft.censor_weight(torch, one, torch.tensor(
        2.0, dtype=F64), 8.0, inf, 0.1))
    w_far = float(soft.stable_sigmoid(torch, torch.tensor(
        (8.0 - 2.0) / 0.1, dtype=F64)))
    assert w_inf == w_far


def test_fd_soft_waterfill_and_mass_conservation():
    U = torch.tensor([[0.2, 0.5, _BIG]], dtype=F64)
    for t0 in (0.1, 0.4, 1.5):
        _fd_check(lambda total: soft.soft_waterfill(
            U, total.reshape(1), 0.05)[0, 0], t0)
    # mass conservation holds at any temperature, and the masked lane
    # gets an exact zero
    for tau in (0.01, 0.05, 0.5):
        fill = soft.soft_waterfill(U, torch.tensor([0.7], dtype=F64), tau)
        assert float(fill.sum()) == pytest.approx(0.7, rel=1e-9)
        assert float(fill[0, 2]) == 0.0


def test_soft_waterfill_masked_lanes_exact_zero_f32():
    """f32 grid shapes: a masked lane never receives work, and a cell
    with every lane masked conserves nothing but stays finite."""
    r = _rng(4)
    U = torch.from_numpy(r.uniform(0.0, 0.05, (5, 4)).astype(np.float32))
    U[0, 1] = U[2, 3] = U[3, 0] = _BIG
    U[4] = _BIG
    total = torch.from_numpy(r.uniform(0.01, 0.1, 5).astype(np.float32))
    fill = soft.soft_waterfill(U, total, 0.05)
    assert torch.isfinite(fill).all()
    assert fill[0, 1] == 0.0 and fill[2, 3] == 0.0 and fill[3, 0] == 0.0
    np.testing.assert_allclose(fill[:4].sum(dim=1).numpy(),
                               total[:4].numpy(), rtol=1e-6)


def test_fd_soft_erlang_c():
    for c0 in (1.5, 3.4, 7.9):
        _fd_check(lambda c: soft.soft_erlang_c(
            torch, c, torch.tensor(0.8, dtype=F64), 64, 0.05), c0,
            rtol=1e-2)
    for r0 in (0.4, 0.9, 1.1):
        _fd_check(lambda r: soft.soft_erlang_c(
            torch, torch.tensor(4.0, dtype=F64), r, 64, 0.05), r0,
            rtol=1e-2)


def test_fd_soft_quantiles_shift_invariance():
    lat = np.sort(np.random.default_rng((0x9A71, 0, 1)).exponential(
        size=256))
    base = torch.tensor(lat, dtype=F64)[None, :]
    w = torch.ones_like(base)

    def p99(shift):
        return soft.soft_quantiles(base + shift, w, qs=(99.0,),
                                   band_frac=2e-3)[0, 0]

    # a uniform shift moves every quantile by exactly that shift
    g = _fd_check(p99, 0.0, rtol=1e-2)
    assert g == pytest.approx(1.0, rel=1e-3)


# ---------------------------------------------------------------------------
# Soft grids: the port on the CPU against JAX soft rows
# ---------------------------------------------------------------------------
#: the reference agreement test's durations for its non-heavy scenarios
#: (``tests/test_plan.py``), each at seed 3, one cell
AGREE_DUR = {"steady": 8.0, "flash-crowd": 9.0, "server-failure": 8.0,
             "batched-serving": 6.0, "retry-storm": 9.0,
             "gray-failure": 8.0}
#: the reference's soft-vs-hard quantile budget
AGREE_RTOL = 0.12
SEEDS = [(spawn_seed(3, 0, 0), 0)]
CPU_SOFT = VectorConfig(device="cpu", soft=True)


@functools.lru_cache(maxsize=None)
def _port_rows(name: str) -> tuple:
    prog = compile_experiment(get(name, duration=AGREE_DUR[name],
                                  seed=3).compile())
    return (run_cells([prog], SEEDS, CPU_SOFT)[0],
            run_cells([prog], SEEDS, VectorConfig(device="cpu"))[0])


@pytest.mark.parametrize("name", sorted(AGREE_DUR))
def test_soft_grid_matches_jax_soft_rows(name):
    prog = jax_compile(jax_get(name, duration=AGREE_DUR[name],
                               seed=3).compile())
    want = jax_run_cells([prog], SEEDS,
                         JaxConfig(backend="jax", soft=True))[0]
    got = _port_rows(name)[0]
    assert got.n == want.n and got.dropped == want.dropped
    for m in ("p50", "p95", "p99", "mean"):
        assert getattr(got, m) == pytest.approx(getattr(want, m),
                                                rel=1e-4), m


@pytest.mark.parametrize("name", sorted(AGREE_DUR))
def test_soft_hard_forward_agreement(name):
    """soft=True with tau=0.05 keeps the forward pass within the
    reference's budget of the exact runtime — SAME draws, so only the
    smoothing moves the quantiles."""
    s, h = _port_rows(name)
    assert s.n == h.n, "reparameterized draws must be shared"
    for m in ("p50", "p95", "p99"):
        hv, sv = getattr(h, m), getattr(s, m)
        assert abs(hv - sv) <= AGREE_RTOL * max(abs(hv), 1e-9), \
            f"{name} {m}: hard {hv:.6g} vs soft {sv:.6g}"
    assert abs(h.mean - s.mean) <= 0.05 * max(h.mean, 1e-9)


def test_soft_consts_take_the_plain_step_on_the_grid_device():
    """``ops`` sends soft consts to the plain step with the smoothed
    water-fill (no kernel launch, no raise); hard consts keep the hard
    step."""
    from repro_torch.kernels import vector_step
    from repro_torch.vector.runtime import _cell_rng, _draw_cell, scan_inputs
    prog = compile_experiment(get("steady", duration=1.0, n_servers=4,
                                  policy="jsq").compile())
    draws = [_draw_cell(prog, _cell_rng(*SEEDS[0]))]
    shape = (prog.n_slots, prog.n_servers)
    consts, carry, xs = scan_inputs([prog], draws, False, shape,
                                    torch.device("cpu"))
    # unequal starting backlogs, so the water-fill's choice matters
    carry = (torch.tensor([[0.0, 0.01, 0.02, 0.03]]),) + carry[1:]
    before = vector_step.scalar_scan.launches
    hard = ops.scalar_scan(consts, carry, xs)
    soft_out = ops.scalar_scan({**consts, "tau": 0.05}, carry, xs)
    want = ref.scalar_scan({**consts, "tau": 0.05}, carry, xs)
    assert vector_step.scalar_scan.launches == before
    for g, w in zip(soft_out[1], want[1]):
        assert torch.equal(g, w)
    # the smoothing moves the backlog, the hard step does not see tau
    assert not torch.equal(soft_out[1][0], hard[1][0])


# ---------------------------------------------------------------------------
# Soft mode's knobs: VectorConfig.tau and band_frac
# ---------------------------------------------------------------------------
#: temperatures and head bandwidths on either side of the defaults
#: (0.05, 5e-4)
KNOBS = [(0.02, 5e-4), (0.02, 2e-3), (0.2, 5e-4), (0.2, 2e-3)]


@pytest.mark.parametrize("tau,band_frac", KNOBS)
def test_soft_knobs_match_jax_soft_rows(tau, band_frac):
    """``steady`` at other temperatures and bandwidths against JAX
    ``VectorConfig(soft=True, tau=..., band_frac=...)`` rows, at the
    default case's tolerance."""
    name = "steady"
    prog = jax_compile(jax_get(name, duration=AGREE_DUR[name],
                               seed=3).compile())
    want = jax_run_cells([prog], SEEDS, JaxConfig(
        backend="jax", soft=True, tau=tau, band_frac=band_frac))[0]
    port = compile_experiment(get(name, duration=AGREE_DUR[name],
                                  seed=3).compile())
    got = run_cells([port], SEEDS, VectorConfig(
        device="cpu", soft=True, tau=tau, band_frac=band_frac))[0]
    assert got.n == want.n and got.dropped == want.dropped
    for m in ("p50", "p95", "p99", "mean"):
        assert getattr(got, m) == pytest.approx(getattr(want, m),
                                                rel=1e-4), m
    # the knobs reach the rows: they move away from the defaults'
    default = _port_rows(name)[0]
    assert (got.p50, got.p95, got.p99) != (default.p50, default.p95,
                                           default.p99)


def test_soft_defaults_are_the_reference_defaults():
    """The fields' defaults are the reference's, and a run that passes
    them explicitly gives the same bits."""
    assert (VectorConfig().tau, VectorConfig().band_frac) == \
        (JaxConfig().tau, JaxConfig().band_frac) == (0.05, 5e-4)
    prog = compile_experiment(get("steady", duration=AGREE_DUR["steady"],
                                  seed=3).compile())
    got = run_cells([prog], SEEDS, VectorConfig(
        device="cpu", soft=True, tau=0.05, band_frac=5e-4))[0]
    want = _port_rows("steady")[0]
    assert (got.n, got.mean, got.p50, got.p95, got.p99, got.dropped,
            got.samples.tobytes()) == \
        (want.n, want.mean, want.p50, want.p95, want.p99, want.dropped,
         want.samples.tobytes())


def test_soft_knobs_change_the_cache_key():
    """``tau`` and ``band_frac`` key a soft cell, as the reference's
    ``tests/test_cache.py`` shows; a hard cell ignores them."""
    from repro_torch.cache import ResultCache
    cache = ResultCache(cache_dir=None)
    prog = compile_experiment(get("steady", duration=2.0, seed=3).compile())
    seed = SEEDS[0]

    def key(**kw):
        return cache.cell_key(prog, seed, VectorConfig(device="cpu", **kw))
    base = key(soft=True)
    assert key(soft=True, tau=0.05, band_frac=5e-4) == base
    assert len({base, key(soft=True, tau=0.1),
                key(soft=True, band_frac=2e-3)}) == 3
    assert key(tau=0.1) == key(band_frac=2e-3) == key()
    sig = cache.vector_sig(VectorConfig(device="cpu", soft=True, tau=0.1,
                                        band_frac=2e-3))
    assert (sig["tau"], sig["band_frac"]) == (0.1, 2e-3)
