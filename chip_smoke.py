"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card, the vector grid runtime (the
canonical grids and the chaos grids, whose timelines the control
pre-pass shapes) and real-model serving of a dense attention model
(phi3-mini-3.8b) and of a Mamba-2 model (mamba2-1.3b):

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
3. holds every kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it: the vector kernels bit-equal (the
   scans at each grid's launch, ``SCAN_CASES``, and as a one-slot
   launch; the quantile head at each grid's first launch,
   ``QUANTILE_CASES``, and a synthetic edge case), the attention and SSD
   kernels within their stated tolerances;
4. runs four grids end to end through ``repro_torch.vector.run_cells``
   (the paper's Fig. 1 grid, a 16-server jsq grid, server-failure and
   batched-serving), checks that every vector kernel was launched and
   every row is finite, and holds three cells of each grid against the
   same cells run on the CPU;
4b. runs the chaos grids the same way (``CHAOS_GRIDS``: the flash crowd
   under the autoscaler and under the AIMD shedder, a correlated
   failure, a gray failure; full duration, 13 reps a point), each with
   ``scalar_scan`` and ``fused_quantiles`` launched once, three cells of
   each against the CPU, the control pre-pass's ``control_log`` read on
   the card and on the CPU, and ``flash-crowd-autoscale`` at seed 3 on
   the host's event simulator (``sim``) against the card's vector
   runtime within the reference's bounds (``SIM_N_REL``,
   ``SIM_SCALE_S``);
5. runs phi3-mini-3.8b at full width and a depth of 2 layers on the CPU
   (plain versions) and on the card (kernels), from the same seeded
   weights: a 128-token prompt and 8 greedy tokens, equal tokens and
   logits within ``F32_LOGIT_TOL`` with the weights in f32; the served
   bf16 weights, the card fed the CPU's tokens, within ``BF16_LOGIT_TOL``;
   then mamba2-1.3b the same way, with a 384-token prompt (the SSD scan
   pads it into a second chunk), within ``MAMBA_F32_LOGIT_TOL`` and
   ``MAMBA_BF16_LOGIT_TOL``;
6. serves phi3-mini-3.8b and then mamba2-1.3b at full width through
   ``repro_torch.launch.serve.main`` (2 replicas sharing one copy of the
   weights, open-loop clients, 10 s each), checks that every request
   completed with finite latencies and that the path's kernels were
   launched (both attention kernels for phi3, ``flash_attention`` once
   per layer and prefill, ``decode_attention`` once per layer and decode
   step; ``ssd_scan`` once per layer and prefill for mamba2; warm-ups
   included), and prints the serving metrics;
7. times each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events (median of
   repeated runs), and fails where a kernel's time reads under its
   bound (every SSD case, and every kernel of the kernels line);
8. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
   ...}`` line.

Any failed phase exits non-zero.  Without a CUDA device, or without the
rest of the repository beside it, the script fails before printing any
result.  The full record is also written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: H100 SXM published peaks (NVIDIA data sheet, 700 W): device memory
#: rate, f32 rate outside the tensor cores, dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: repeats of each timed call (the median is reported)
TIMED_RUNS = 10
#: grid rows on the card vs the same cells on the CPU (the tolerances of
#: tests/test_torch_vector_parity.py against the JAX reference)
ROW_RTOL = 1e-6
#: attention kernel vs plain version, relative to max|v|: in bf16 the
#: prefill kernel rounds the unnormalised probabilities to bf16 where the
#: plain version rounds the normalised ones, and each rounds its output
#: once (see tests/test_torch_cuda_kernels.py); the decode kernel rounds
#: where the plain version does
ATTN_TOL = 2.0 ** -7
#: full-width logits, card vs CPU, relative to max|logit|.  f32 weights:
#: only f32 sums taken in other orders differ, and the bf16 cache entries
#: they round into.  bf16 weights: every product rounds to bf16, in other
#: places on the two devices, and the logits are bf16 themselves (one
#: step is 2^-7 relative, 0.0078 at |logit| ~1.3), so greedy tokens can
#: split on a tie: the card is fed the CPU's tokens and only the logits
#: are held, to 4 such steps (the JAX package's own ref and Pallas paths
#: differ by 1.17e-2, 1.5 steps, on this model in bf16)
F32_LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 3e-2
#: the same for mamba2-1.3b at full width, 2 layers, a 384-token prompt.
#: f32: this random-weight model turns f32 noise into up to ~1e-3 of
#: max|logit| (on the CPU, weights perturbed by ~1 ulp move the logits by
#: up to 8.3e-4, the prefill's by 3e-4) and the decode's conv cache
#: rounds the f32 projections to bf16, where a sum order can tip a
#: rounding; the card read 7.142e-4 (H100 80GB HBM3, 700 W).
#: bf16: 4 logit rounding steps, as for phi3; the card read 4.831e-3
MAMBA_F32_LOGIT_TOL = 1e-3
MAMBA_BF16_LOGIT_TOL = 3e-2
#: SSD kernel vs plain version: both widen the same values to f32 and
#: differ only by the order of f32 sums and FMA contraction, whatever the
#: input dtype, so every case is held to the f32 rule of
#: tests/test_kernels.py, |k - p| <= SSD_TOL (1 + |p|), widened by
#: L 2^-24 max|p|: the f32 rounding of the chunk's cumulative sum of L
#: decays, which every exp(cum_t - cum_s) inherits (as
#: tests/test_torch_cuda_kernels.py does)
SSD_TOL = 2e-4
#: the serving runs of the main path (launch.serve flags); mamba2's
#: 512-token prompts cross the scan's chunk boundary (256)
SERVE_ARGS = ["--arch", "phi3-mini-3.8b", "--replicas", "2",
              "--max-batch", "4", "--prompt-len", "128", "--max-new", "32",
              "--clients", "2", "--qps", "2", "--duration", "10",
              "--policy", "jsq", "--seed", "0"]
MAMBA_SERVE_ARGS = ["--arch", "mamba2-1.3b", "--replicas", "2",
                    "--max-batch", "4", "--prompt-len", "512",
                    "--max-new", "32", "--clients", "2", "--qps", "2",
                    "--duration", "10", "--policy", "jsq", "--seed", "0"]
#: the decode cache length of that run (make_warmed_engine: prompt + new
#: tokens + 32) and the prefill bucket of its 128-token prompts
SERVE_MAX_LEN = 128 + 32 + 32
SERVE_BUCKET = 128


def ptxas_report(log: str) -> list:
    """One entry per kernel of a build log (``nvcc -Xptxas=-v``): its
    name with its template arguments (``flash_attention_tc_kernel<6>``),
    its registers, then its stack frame and spills."""
    out, name, spills = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            # the mangled name's length-prefixed identifiers
            mangled = m.group(1)
            idents = [mangled[d.end():d.end() + int(d.group())]
                      for d in re.finditer(r"\d+", mangled)]
            name = next((i for i in idents if i.endswith("kernel")),
                        mangled)
            targs = re.search(r"kernelI(.*?)EEv", mangled)
            if targs:
                args = re.sub(r"Li(\d+)E", r",\1", targs.group(1))
                args = re.sub(r"Lb([01])E", lambda b: ",true"
                              if b.group(1) == "1" else ",false", args)
                args = re.sub(r"\d+__nv_bfloat16", "bf16,", args)
                name += "<" + args.replace(",,", ",").strip(",") + ">"
        elif "spill" in ln:
            spills = ln.strip()
        elif "Used" in ln:
            out.append(f"{name}: {ln.split('info    :')[-1].strip()}; "
                       f"{spills}")
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def spawn_seed(base_seed: int, point: int, rep: int) -> int:
    """Per-(point, rep) seed, as ``repro.sweep.spec.spawn_seed`` derives
    it (SeedSequence spawn tree)."""
    ss = np.random.SeedSequence(base_seed, spawn_key=(point, rep))
    return int(ss.generate_state(1, np.uint32)[0])


def scenario_grid(name, points, **kw) -> tuple:
    """(name, programs, seeds): each point of a registered scenario x 13
    reps, every cell with its own sweep-derived seed."""
    from repro_torch.scenarios import get
    from repro_torch.vector import compile_experiment
    progs, seeds = [], []
    for i, over in enumerate(points):
        for rep in range(13):
            sc = get(name, seed=spawn_seed(1, i, rep), **kw, **over)
            progs.append(compile_experiment(sc.compile()))
            seeds.append((sc.seed, rep))
    return name, progs, seeds


def build_grids() -> list:
    """(name, programs, seeds) of the four main-path grids."""
    from repro_torch.core.client import ClientConfig, ConstantQPS
    from repro_torch.core.harness import Experiment, ServerSpec
    from repro_torch.vector import compile_experiment

    grids = []
    # the paper's Fig. 1 grid (benchmarks/bench_vector.py): 9 QPS points x
    # 13 reps, 15 s, three clients on one 6-worker xapian server
    progs, seeds = [], []
    for i, qps in enumerate((100, 250, 500, 1000, 2000, 3000, 4000, 4600,
                             5200)):
        for rep in range(13):
            exp = Experiment(
                clients=[ClientConfig(k, ConstantQPS(qps / 3))
                         for k in range(3)],
                servers=(ServerSpec(0, workers=6),), duration=15.0,
                app="xapian", seed=spawn_seed(1, i, rep))
            progs.append(compile_experiment(exp))
            seeds.append((exp.seed, rep))
    grids.append(("fig1", progs, seeds))

    # multi-server: 16 one-worker servers behind jsq (the water-fill over
    # servers), offered load up to ~0.94 of capacity
    grids.append(scenario_grid(
        "steady", [dict(qps=q) for q in (3000.0, 6000.0, 9000.0, 11000.0)],
        n_servers=16, policy="jsq", duration=15.0))
    grids.append(scenario_grid("server-failure", [{}]))
    grids.append(scenario_grid(
        "batched-serving", [dict(qps=q) for q in (300.0, 600.0)],
        n_servers=8))
    return grids


#: the chaos grids' points (``repro_torch.scenarios.chaos``, full
#: duration): the autoscaler and the AIMD shedder on the flash crowd
#: (T 9000, S 6, four standby columns), two servers failing in one slot
#: (T 8000, S 6), a server slowed 20x (T 6000, S 3)
CHAOS_GRIDS = [("flash-crowd-autoscale",
                [{}, dict(controller="admission_shedder", peak_qps=4000.0)]),
               ("correlated-failure", [{}]),
               ("gray-failure", [{}])]
#: the reference's bounds on the vector runtime against ``sim``
#: (tests/test_control.py: served mass, rel; the first scale-out, s)
SIM_N_REL = 0.05
SIM_SCALE_S = 2.0


def build_chaos_grids() -> list:
    """(name, programs, seeds) of the chaos grids: 2 x 13, 13, 13 cells."""
    return [scenario_grid(name, points) for name, points in CHAOS_GRIDS]


def scan_case(progs, seeds, device):
    """The first chunk's scan inputs exactly as ``run_cells`` builds them."""
    from repro_torch.vector import runtime as R
    batched, shape, idxs = R._plan_groups(progs)[0]
    group = [progs[i] for i in idxs]
    draws = [R._draw_cell(p, R._cell_rng(*seeds[i]))
             for p, i in zip(group, idxs)]
    return batched, group[0].n_slots, R.scan_inputs(group, draws, batched,
                                                     shape, device)


#: device cycles (~1 ms on an H100) the card spins before each timed
#: call, while the host queues it (see cuda_ms)
SPIN_CYCLES = 2_000_000
#: bytes written between timed calls: more than the 50 MB L2
FLUSH_BYTES = 64 << 20


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of ``fn()`` over ``runs`` calls, CUDA events,
    after one warm-up call.  Before each call the card spins for
    ``SPIN_CYCLES`` and then overwrites ``FLUSH_BYTES``, both outside the
    events: the host queues the call while the card is still busy, so
    the events time the card's work and not the host's launch (checks,
    allocations, ctypes), and the inputs come from device memory, not
    from the L2 that the previous call left warm, as on the main paths,
    where a layer's inputs were last touched one step of 7.6 GB of
    weights earlier."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def scan_bound(consts, carry, xs, new_carry, ys, per_lane_ops) -> tuple:
    """(bound ms, 'bytes' | 'operations') of one scan launch: each input
    read once and each output written once over the memory rate, against
    the f32 operations of the step over the f32 rate."""
    moved = nbytes(list(consts.values()) + list(carry) + list(xs)
                   + list(new_carry) + list(ys))
    T, C, S = xs[1].shape
    ops = T * C * S * per_lane_ops(S)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


#: the scan launches of the main path: (check key, grid of build_grids);
#: each is the grid's first chunk (server-failure's: T 9216, 13 cells of
#: 4 lanes, the one with fail slots)
SCAN_CASES = [("scalar_scan/fig1", "fig1"),
              ("scalar_scan/steady16", "steady"),
              ("scalar_scan/server-failure", "server-failure"),
              ("batched_scan/batched8", "batched-serving")]
#: repeats of a scan's plain version when it is timed (seconds a call)
PLAIN_SCAN_RUNS = 3


def check_scan(name, batched, n_real, inputs, time_plain=True) -> dict:
    """Kernel vs plain version of one scan on the card; returns the
    record (errors, times, bound).  ``time_plain=False`` leaves the plain
    version's time out (``plain_ms`` None)."""
    from repro_torch.kernels import ref, vector_step
    consts, carry, xs = inputs
    kern = vector_step.batched_scan if batched else vector_step.scalar_scan
    plain = ref.batched_scan if batched else ref.scalar_scan
    kc, ky = kern(consts, carry, xs)
    pc, py = plain(consts, carry, xs)
    torch.cuda.synchronize()
    # the kernel runs the plain version's f32 operations in the same
    # order (lane sums left to right, no FMA): every output bit-equal
    worst = 0.0
    for k, p in zip(list(ky) + list(kc), list(py) + list(pc)):
        diff = torch.where(k == p, 0.0, (k - p).abs())   # equal infs: 0
        worst = max(worst, diff.max().item())
        if not torch.equal(k, p):
            fail(f"{name}: kernel differs from the plain version "
                 f"(max abs {worst:.3e})")
    if not all(torch.isfinite(y[:n_real]).all() for y in ky):
        fail(f"{name}: kernel output not finite over the cells' slots")
    # per-slot entry point: a one-slot launch is the plain step's slot
    k1 = kern(consts, carry, tuple(x[:1] for x in xs))
    p1 = plain(consts, carry, tuple(x[:1] for x in xs))
    for k, p in zip(list(k1[0]) + list(k1[1]), list(p1[0]) + list(p1[1])):
        if not torch.equal(k, p):
            fail(f"{name}: one-slot launch differs from the plain step")
    per_lane = ((lambda S: 3 * S + 45) if batched
                else (lambda S: 3 * S + 30))
    bound_ms, bound_by = scan_bound(consts, carry, xs, kc, ky, per_lane)
    T, C, S = xs[1].shape
    ms = cuda_ms(lambda: kern(consts, carry, xs))
    return {"shape": {"T": T, "C": C, "S": S, "real_slots": n_real},
            "max_abs_err": worst, "ms": ms, "us_per_slot": ms * 1e3 / T,
            "plain_ms": (cuda_ms(lambda: plain(consts, carry, xs),
                                 PLAIN_SCAN_RUNS) if time_plain else None),
            "bound_ms": bound_ms, "bound_by": bound_by}


#: the quantile launches of the main path: (check key, grid of
#: build_grids); each is the grid's first launch, as run_cells makes it
QUANTILE_CASES = [("fused_quantiles/fig1", "fig1"),
                  ("fused_quantiles/steady16", "steady"),
                  ("fused_quantiles/server-failure", "server-failure"),
                  ("fused_quantiles/batched8", "batched-serving")]
#: the synthetic edge case at the Fig. 1 grid's width
QUANTILE_SYNTHETIC = "fused_quantiles/synthetic"


def quantile_case(progs, seeds, device) -> tuple:
    """The grid's first quantile launch exactly as ``run_cells`` makes it:
    the ``[C, K]`` matrix of that chunk's latencies and its counts, on
    the card, taken on their way to the kernel."""
    from repro_torch.kernels import ops
    from repro_torch.vector import VectorConfig, run_cells
    seen = []
    launch = ops.fused_quantiles

    def capture(lat, counts):
        if not seen:
            seen.append((lat.clone(), counts.clone()))
        return launch(lat, counts)
    ops.fused_quantiles = capture
    try:
        run_cells(progs, seeds, VectorConfig(device=device.type))
    finally:
        ops.fused_quantiles = launch
    return seen[0]


def synthetic_quantiles(device) -> tuple:
    """117 cells x 32768 samples (the Fig. 1 grid's width): ragged
    counts, a count of 0, a count of 1, and ties across a median."""
    C, K = 117, 32768
    g = np.random.default_rng(11)
    counts = np.concatenate([[0, 1, 2, K, K],
                             g.integers(1, K, C - 5)]).astype(np.int32)
    lat = np.full((C, K), np.inf, np.float32)
    for i, n in enumerate(counts):
        lat[i, :n] = g.gamma(2.0, 0.004, n)
    lat[4, :K // 2] = 0.0125                   # ties across the median
    return (torch.from_numpy(lat).to(device),
            torch.from_numpy(counts).to(device))


def quantile_bound(C: int, samples: int) -> tuple:
    """(bound ms, 'bytes' | 'operations') of the quantile head over
    ``samples`` values of ``C`` rows: each value read once, the counts
    read and the [C, 3] result written, against one compare of each
    value with each of the 6 ranks over the f32 rate."""
    moved = samples * 4 + C * 4 + C * 3 * 4
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, samples * 6 / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_quantiles(name, L, N, time_plain=True) -> dict:
    """Kernel vs plain version of the quantile head on the card,
    bit-equal (NaN rows where the count is 0); returns the record
    (times; the bound from the samples the counts hold, and the full
    matrix's).  ``time_plain=False`` leaves the plain and library times
    out (None)."""
    from repro_torch.kernels import ref, vector_quantiles
    C, K = L.shape
    k = vector_quantiles.fused_quantiles(L, N).cpu().numpy()
    p = ref.fused_quantiles(L, N).cpu().numpy()
    if not np.array_equal(k, p, equal_nan=True):
        bad = int((~((k == p) | (np.isnan(k) & np.isnan(p)))).any(1).sum())
        fail(f"{name}: fused_quantiles is not bit-equal to its plain "
             f"version ({bad} of {C} rows differ)")
    ok = ~np.isnan(p)
    err = float(np.abs(k - p)[ok].max()) if ok.any() else 0.0
    counts = N.cpu().numpy()
    if not (np.isnan(k).all(1) == (counts <= 0)).all():
        fail(f"{name}: fused_quantiles: NaN rows do not match the zero "
             f"counts")
    samples = int(np.minimum(np.maximum(counts, 0), K).sum())
    bound_ms, bound_by = quantile_bound(C, samples)
    idx = torch.stack([torch.clamp((float(q / 100.0) * (N - 1)).floor(), 0)
                       for q in (50.0, 95.0, 99.0)], -1).long()

    def library():
        torch.sort(L, dim=-1).values.gather(-1, idx)

    rec = {"shape": {"C": C, "K": K, "samples": samples},
           "max_abs_err": err,
           "ms": cuda_ms(lambda: vector_quantiles.fused_quantiles(L, N)),
           "plain_ms": (cuda_ms(lambda: ref.fused_quantiles(L, N))
                        if time_plain else None),
           "library_ms": cuda_ms(library) if time_plain else None,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "full_matrix_bound_ms": quantile_bound(C, C * K)[0]}
    if rec["ms"] < rec["bound_ms"]:
        fail(f"{name}: {rec['ms']:.5f} ms reads under its bound "
             f"{rec['bound_ms']:.5f} ms")
    return rec


def attention_bound(bytes_moved: int, flops: float, fl_rate: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / fl_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_time(fn):
    """CUDA-event time of a PyTorch yardstick call, or None (with the
    reason printed) when this PyTorch cannot make that call."""
    try:
        return cuda_ms(fn)
    except (RuntimeError, TypeError, ValueError) as e:
        print(f"  library call unavailable: {e}", flush=True)
        return None


#: (label, B, S = T, H, KV, hd, window): phi3's prefill at three prompt
#: buckets and the bucket the serving run uses, plus one GQA case with a
#: sliding window; all causal
FLASH_CASES = [
    ("phi3 S=32", 1, 32, 32, 32, 96, None),
    ("phi3 S=128 (served bucket)", 1, SERVE_BUCKET, 32, 32, 96, None),
    ("phi3 S=512", 1, 512, 32, 32, 96, None),
    ("phi3 S=2048", 1, 2048, 32, 32, 96, None),
    ("gqa+window S=1024", 1, 1024, 32, 8, 128, 256),
]


def check_flash(device, label, B, S, H, KV, hd, window) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device=device).manual_seed(S * 131 + KV)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device
                           ).to(torch.bfloat16)
    q, k, v = rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    plain = ref.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"flash_attention {label}: output not finite")
    err = (out.float() - plain.float()).abs().max().item()
    tol = ATTN_TOL * v.float().abs().max().item()
    if err > tol:
        fail(f"flash_attention {label}: |kernel - plain| {err:.3e} > "
             f"{tol:.3e}")
    i = torch.arange(S, device=device)
    ok = i[None, :] <= i[:, None]
    if window is not None:
        ok &= i[None, :] > i[:, None] - window
    pairs = int(ok.sum().item())                 # unmasked (query, key)
    bound_ms, bound_by = attention_bound(
        nbytes((q, k, v, out)), 4.0 * hd * pairs * H * B, BF16_OPS_PER_S)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window is None:
        def library():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
    else:
        def library():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=ok,
                                           enable_gqa=True)
    return {"shape": {"B": B, "S": S, "T": S, "H": H, "KV": KV, "hd": hd,
                      "causal": True, "window": window},
            "max_abs_err": err, "tol": tol,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                                     window=window)),
            "plain_ms": cuda_ms(lambda: ref.flash_attention(
                q, k, v, causal=True, window=window)),
            "library_ms": library_time(library),
            "bound_ms": bound_ms, "bound_by": bound_by}


#: (label, B, T, H, KV, hd, window, ring): the serving run's decode
#: (max batch 4, T = its cache length), one ring/window case, gemma3-12b's
#: decode shape (its 1024-slot sliding-window ring) and the served shape
#: at batch 1, as a lightly loaded replica runs it
DECODE_CASES = [
    ("phi3 serving B=4 T=192", 4, SERVE_MAX_LEN, 32, 32, 96, None, False),
    ("ring+window B=4 T=512", 4, 512, 32, 8, 128, 384, True),
    ("gemma3-12b B=4 T=1024 ring", 4, 1024, 16, 8, 256, 1024, True),
    ("phi3 B=1 T=192", 1, SERVE_MAX_LEN, 32, 32, 96, None, False),
]


def check_decode(device, label, B, T, H, KV, hd, window, ring) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    g = torch.Generator(device=device).manual_seed(T * 7 + KV)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device
                           ).to(torch.bfloat16)
    q, k, v = rnd(B, H, hd), rnd(B, T, KV, hd), rnd(B, T, KV, hd)
    # ragged rows: slot j holds position j (-1 past a row's prompt and
    # tokens, as an engine's cache does); the ring holds j + T in its
    # first r slots, the newest positions of a wrapped row
    lengths = torch.tensor([T, T - 41, T // 2 + 3, 5][:B], dtype=torch.int32,
                           device=device)
    pos = torch.arange(T, dtype=torch.int32, device=device).repeat(B, 1)
    pos = torch.where(pos < lengths[:, None], pos, torch.full_like(pos, -1))
    if ring:
        r = torch.tensor([37, 0, 100, 3][:B], dtype=torch.int32,
                         device=device)
        j = torch.arange(T, dtype=torch.int32, device=device)[None, :]
        pos = torch.where(j < r[:, None], j + T, j)
        lengths = T + r
    q_pos = lengths - 1
    kw = dict(lengths=lengths, key_positions=pos, q_pos=q_pos, window=window)
    out = da.decode_attention(q, k, v, **kw)
    plain = ref.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"decode_attention {label}: output not finite")
    err = (out.float() - plain.float()).abs().max().item()
    tol = ATTN_TOL * v.float().abs().max().item()
    if err > tol:
        fail(f"decode_attention {label}: |kernel - plain| {err:.3e} > "
             f"{tol:.3e}")
    valid = (pos >= 0) & (pos < lengths[:, None])
    if window is not None:
        valid &= pos > q_pos[:, None] - window
    keys = int(valid.sum().item())               # (row, key) pairs
    # the function needs each valid slot's key and value for every KV
    # head, and a row with no valid key every value (its mean)
    slot = KV * hd * k.element_size()
    empty = int((valid.sum(1) == 0).sum().item())
    small = nbytes((q, out, lengths, pos, q_pos))
    bound_ms, bound_by = attention_bound(
        small + 2 * slot * keys + slot * T * empty,
        4.0 * hd * keys * H, BF16_OPS_PER_S)
    # the older, full-cache form of the bound: every slot read once
    full_cache_bound_ms, _ = attention_bound(
        small + nbytes((k, v)), 4.0 * hd * keys * H, BF16_OPS_PER_S)
    qt = q[:, :, None, :]
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]

    def library():
        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                       enable_gqa=True)
    return {"shape": {"B": B, "T": T, "H": H, "KV": KV, "hd": hd,
                      "window": window, "ring": ring,
                      "lengths": lengths.tolist()},
            "max_abs_err": err, "tol": tol,
            "ms": cuda_ms(lambda: da.decode_attention(q, k, v, **kw)),
            "plain_ms": cuda_ms(lambda: ref.decode_attention(q, k, v, **kw)),
            "library_ms": library_time(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "full_cache_bound_ms": full_cache_bound_ms}


#: (label, b, s, h, p, n, chunk, dtype): mamba2-1.3b's prefill at the
#: serving run's 512-token prompt (two chunks), a 384-token prompt that
#: ops.ssd_scan pads into a second chunk, batch 4 at 2048 tokens, the
#: served shape in f32, and jamba-1.5-large's Mamba layer (128 heads of
#: 128, d_state 128) at the same prompt
SSD_CASES = [
    ("mamba2 s=512 (served)", 1, 512, 64, 64, 128, 256, "bf16"),
    ("mamba2 s=384 (padded)", 1, 384, 64, 64, 128, 256, "bf16"),
    ("mamba2 b=4 s=2048", 4, 2048, 64, 64, 128, 256, "bf16"),
    ("mamba2 s=512 f32", 1, 512, 64, 64, 128, 256, "f32"),
    ("jamba-1.5-large s=512 p=128", 1, 512, 128, 128, 128, 256, "bf16"),
]


def ssd_flops(b: int, s: int, h: int, p: int, n: int, L: int) -> tuple:
    """(C.B^T, the rest) flops of the chunked scan over the causal pairs
    t >= s only: per (batch row, chunk) C.B^T once (L (L + 1) N: B and C
    are one group, shared by the heads); per head M.x (L (L + 1) P) and
    C.h with the state update (4 L P N)."""
    chunks = -(-s // L)
    return (b * chunks * L * (L + 1) * n,
            b * chunks * h * (L * (L + 1) * p + 4 * L * p * n))


def ssd_op_time(b, s, h, p, n, L, dtype: str) -> float:
    """Seconds of those operations on the tensor cores (989 TFLOP/s),
    each product with an f32 operand counted twice, as its hi and lo
    bf16 parts: M.x, C.h and the state update always (M and the state
    are f32), C.B^T once for bf16 inputs (their products are exact in
    f32) and twice for f32 ones."""
    cb, rest = ssd_flops(b, s, h, p, n, L)
    return (cb * (1 if dtype == "bf16" else 2) + 2 * rest) / BF16_OPS_PER_S


def ssd_f32_core_time(b, s, h, p, n, L, dtype: str) -> float:
    """The older figure: C.B^T at the bf16 tensor-core rate for bf16
    inputs, everything else on the f32 CUDA cores (67 TFLOP/s)."""
    cb, rest = ssd_flops(b, s, h, p, n, L)
    cb_rate = BF16_OPS_PER_S if dtype == "bf16" else F32_OPS_PER_S
    return cb / cb_rate + rest / F32_OPS_PER_S


def ssd_bf16_state(x, dt, A, B, C, chunk: int):
    """The control of the SSD check: the plain version run a chunk at a
    time with the carried state rounded to bf16 between chunks (and at
    the end), what a kernel that kept its state in bf16 would give."""
    from repro_torch.kernels import ref
    ys, h = [], None
    for c0 in range(0, x.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        y, h = ref.ssd_chunked(x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl],
                               chunk=chunk, h0=h)
        h = h.bfloat16().float()
        ys.append(y)
    return torch.cat(ys, 1), h


def check_ssd(device, label, b, s, h, p, n, chunk, dtype) -> dict:
    """The SSD kernel (through ``ops.ssd_scan``, which pads s to the
    chunk) against its plain version on the same padded inputs, and the
    bf16-state control against the same bound, which it must exceed."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=device).manual_seed(s * 3 + b)
    et = torch.bfloat16 if dtype == "bf16" else torch.float32

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device)
    x = rnd(b, s, h, p).to(et)
    # the model's ranges: dt = softplus(. - 4.6), A = -exp(1.386) +- noise
    dt = torch.nn.functional.softplus(rnd(b, s, h) - 4.6 + 2.0 * rnd(b, s, h))
    A = -torch.exp(1.386 + 0.5 * rnd(h))
    B, C = rnd(b, s, 1, n).to(et), rnd(b, s, 1, n).to(et)
    pad = (-s) % chunk

    def padt(a):
        return torch.nn.functional.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])
    xp, dtp, Bp, Cp = (padt(a) for a in (x, dt, B, C))
    y, hN = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    py, ph = ref.ssd_chunked(xp, dtp, A, Bp, Cp, chunk=chunk)
    cy, ch = ssd_bf16_state(xp, dtp, A, Bp, Cp, chunk)
    py, cy = py[:, :s], cy[:, :s]
    torch.cuda.synchronize()
    if not (torch.isfinite(y).all() and torch.isfinite(hN).all()):
        fail(f"ssd_scan {label}: output not finite")
    err, used, control = {}, {}, {}
    for name, k, q, c in (("y", y, py, cy), ("hN", hN, ph, ch)):
        atol = SSD_TOL + chunk * 2.0 ** -24 * q.abs().max().item()
        # the largest share of its bound that an element uses (<= 1)
        used[name] = ((k - q).abs() / (atol + SSD_TOL * q.abs())).max().item()
        control[name] = ((c - q).abs()
                         / (atol + SSD_TOL * q.abs())).max().item()
        err[name] = (k - q).abs().max().item()
        if not used[name] <= 1.0:
            fail(f"ssd_scan {label}: |kernel - plain| of {name} exceeds "
                 f"{atol:.3e} + {SSD_TOL}|plain| (max abs {err[name]:.3e})")
    if not max(control.values()) > 1.0:
        fail(f"ssd_scan {label}: the bound does not tell a bf16 state from "
             f"the plain version ({control})")
    moved = nbytes((xp, dtp, A, Bp, Cp, y, hN))
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ssd_op_time(b, s, h, p, n, chunk, dtype)
    t_core = ssd_f32_core_time(b, s, h, p, n, chunk, dtype)
    rec = {"shape": {"b": b, "s": s, "h": h, "p": p, "n": n,
                     "chunk": chunk, "dtype": dtype, "padded_to": s + pad},
           "max_abs_err": max(err.values()), "max_abs_err_y": err["y"],
           "max_abs_err_hN": err["hN"], "rtol": SSD_TOL,
           "bound_used_y": used["y"], "bound_used_hN": used["hN"],
           "bf16_state_bound_used_y": control["y"],
           "bf16_state_bound_used_hN": control["hN"],
           "ms": cuda_ms(lambda: ops.ssd_scan(x, dt, A, B, C, chunk=chunk)),
           "plain_ms": cuda_ms(lambda: ref.ssd_chunked(xp, dtp, A, Bp, Cp,
                                                       chunk=chunk)),
           "library_ms": None,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "f32_core_bound_ms": max(t_bytes, t_core) * 1e3}
    if rec["ms"] < rec["bound_ms"]:
        fail(f"ssd_scan {label}: {rec['ms']:.5f} ms reads under its bound "
             f"{rec['bound_ms']:.5f} ms")
    return rec


def greedy(cfg, params, prompt, max_len: int, steps: int, forced=None):
    """Prefill ``prompt`` (1, S) and decode ``steps`` tokens greedily, or
    feeding ``forced`` tokens; -> (logits [steps + 1, V] f32 on the CPU,
    own argmax tokens)."""
    from repro_torch.models import registry as R
    logits, cache, pos = R.prefill(cfg, params, {"tokens": prompt}, max_len)
    out, toks = [logits.float().cpu()], [int(logits.argmax(-1)[0])]
    for i in range(steps):
        feed = toks[-1] if forced is None else forced[i]
        tok = torch.tensor([feed], dtype=torch.int32, device=prompt.device)
        logits, cache = R.decode_step(cfg, params, cache, tok, pos)
        pos = pos + 1
        out.append(logits.float().cpu())
        toks.append(int(logits.argmax(-1)[0]))
    return torch.cat(out), toks


def check_full_width(device, arch: str = "phi3-mini-3.8b",
                     prompt_len: int = 128, f32_tol: float = F32_LOGIT_TOL,
                     bf16_tol: float = BF16_LOGIT_TOL) -> dict:
    """``arch`` at full width, 2 layers: the same seeded weights on the
    CPU (plain versions) and on the card (kernels)."""
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    from repro_torch.models import param as P
    from repro_torch.models import registry as R
    cfg = replace(get_config(arch), num_layers=2)
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                           dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    steps, max_len = 8, prompt_len + 8 + 32
    rec = {"cfg": {"name": cfg.name, "num_layers": cfg.num_layers,
                   "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                   "params": R.count_params(cfg)},
           "prompt": prompt_len, "steps": steps}
    if cfg.mamba is not None:
        m = cfg.mamba
        rec["cfg"].update(heads=m.n_heads(cfg.d_model), head_dim=m.head_dim,
                          d_state=m.d_state, chunk=m.chunk)
    else:
        rec["cfg"].update(heads=cfg.num_heads,
                          head_dim=cfg.resolved_head_dim)

    def rel_steps(a, b):
        return ((a - b).abs().max(-1).values / b.abs().max(-1).values)

    def rel(a, b):
        return rel_steps(a, b).max().item()

    # f32 weights: greedy on each side, the tokens must be equal
    p32 = P.tree_map(lambda t: t.float(), params)
    t0 = time.perf_counter()
    cpu_l, cpu_t = greedy(cfg, p32, prompt, max_len, steps)
    cpu_s = time.perf_counter() - t0
    gpu_l, gpu_t = greedy(cfg, P.tree_map(lambda t: t.to(device), p32),
                          prompt.to(device), max_len, steps)
    err32 = rel(gpu_l, cpu_l)
    top2 = cpu_l.topk(2, dim=-1).values
    margin = ((top2[:, 0] - top2[:, 1]) / cpu_l.abs().max(-1).values).min()
    rec["f32"] = {"cpu_tokens": cpu_t, "card_tokens": gpu_t,
                  "logits_rel_err": err32, "tol": f32_tol,
                  "logits_rel_err_per_step": rel_steps(gpu_l,
                                                       cpu_l).tolist(),
                  "min_top2_gap_rel": margin.item(), "cpu_s": cpu_s}
    print(f"full width {arch} f32: tokens cpu {cpu_t} card {gpu_t}, logits "
          f"rel err {err32:.3e} (smallest top-2 gap {margin.item():.3e})",
          flush=True)
    if gpu_t != cpu_t:
        fail(f"full width {arch} f32: greedy tokens differ between card "
             f"and CPU")
    if not err32 <= f32_tol:
        fail(f"full width {arch} f32: logits rel err {err32:.3e} > "
             f"{f32_tol}")
    # the served bf16 weights: the card follows the CPU's tokens
    cpu_l, cpu_t = greedy(cfg, params, prompt, max_len, steps)
    gpu_l, gpu_t = greedy(cfg, P.tree_map(lambda t: t.to(device), params),
                          prompt.to(device), max_len, steps,
                          forced=cpu_t[:-1])
    err16 = rel(gpu_l, cpu_l)
    agree = sum(a == b for a, b in zip(cpu_t, gpu_t))
    rec["bf16"] = {"cpu_tokens": cpu_t, "card_argmax": gpu_t,
                   "argmax_agree": agree, "logits_rel_err": err16,
                   "logits_rel_err_per_step": rel_steps(gpu_l,
                                                        cpu_l).tolist(),
                   "tol": bf16_tol}
    print(f"full width {arch} bf16 (card fed the CPU's tokens): argmax "
          f"agrees at {agree} of {steps + 1} steps, logits rel err "
          f"{err16:.3e}", flush=True)
    if not err16 <= bf16_tol:
        fail(f"full width {arch} bf16: logits rel err {err16:.3e} > "
             f"{bf16_tol}")
    return rec


def run_serving(args=SERVE_ARGS) -> dict:
    """A serving main path, as a user starts it."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    report = serve.main(args)
    report["phase_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    if report["n"] < 1 or report["dropped"] or \
            report["n"] != report["submitted"]:
        fail(f"serving: {report['n']} of {report['submitted']} requests "
             f"completed, {report['dropped']} dropped")
    for key in ("p50_ms", "p95_ms", "p99_ms", "ttft_p50_ms", "ttft_p99_ms",
                "decode_step_ms", "tokens_per_s"):
        if not math.isfinite(report[key]) or report[key] <= 0:
            fail(f"serving: {key} = {report[key]!r}")
    return report


def run_grids(grids) -> tuple:
    """Runs every grid end to end on the card through ``run_cells``;
    returns ({name: rows}, {name: wall time and cells/s}) and prints one
    ``e2e`` line a grid (host clock until the rows are on the host)."""
    from repro_torch.vector import VectorConfig, run_cells
    results, e2e = {}, {}
    torch.cuda.synchronize()
    for name, progs, seeds in grids:
        t0 = time.perf_counter()
        rows = run_cells(progs, seeds, VectorConfig(device="cuda"))
        wall = time.perf_counter() - t0
        results[name] = rows
        e2e[name] = {"cells": len(rows), "wall_s": wall,
                     "cells_per_s": len(rows) / wall}
        print(f"e2e {name}: {len(rows)} cells in {wall:.3f} s "
              f"({len(rows) / wall:.1f} cells/s)", flush=True)
    return results, e2e


def rows_close(gpu, cpu) -> str:
    """'' when a card row matches its CPU row within the test
    tolerances, else what differs."""
    if gpu.dropped != cpu.dropped:
        return f"dropped {gpu.dropped} != {cpu.dropped}"
    if abs(gpu.n - cpu.n) > 1:
        return f"n {gpu.n} vs {cpu.n}"
    for m in ("mean", "p50", "p95", "p99"):
        a, b = getattr(gpu, m), getattr(cpu, m)
        if not math.isclose(a, b, rel_tol=ROW_RTOL):
            return f"{m} {a!r} vs {b!r}"
    for m in ("n_ivl", "util_ivl", "qdepth_ivl"):
        if not np.allclose(getattr(gpu, m), getattr(cpu, m),
                           rtol=ROW_RTOL, atol=1e-6):
            return f"{m} differs"
    return ""


def chaos_experiment(name: str, i: int):
    """The compiled scenario of cell ``i`` of a chaos grid."""
    from repro_torch.scenarios import get
    points = dict(CHAOS_GRIDS)[name]
    point, rep = divmod(i, 13)
    return get(name, seed=spawn_seed(1, point, rep),
               **points[point]).compile()


def check_chaos_control(chaos) -> dict:
    """The control pre-pass's actions, read through ``VectorRuntime`` on
    the card and on the CPU for three cells of each chaos grid: equal."""
    from repro_torch.vector import VectorConfig, VectorRuntime
    out = {}
    for name, progs, seeds in chaos:
        for i in (0, len(progs) // 2, len(progs) - 1):
            logs = []
            for device in ("cuda", "cpu"):
                rt = VectorRuntime(chaos_experiment(name, i),
                                   rep=seeds[i][1],
                                   config=VectorConfig(device=device))
                rt.run()
                logs.append(rt.control_log)
            if logs[0] != logs[1] or logs[0] != progs[i].control_actions:
                fail(f"{name} cell {i}: control_log on the card "
                     f"{logs[0]} != the CPU's {logs[1]}")
            out[f"{name}/{i}"] = logs[0]
        print(f"control_log {name}: card equal to CPU at 3 cells "
              f"({sum(len(v) for k, v in out.items() if k.startswith(name))}"
              f" actions)", flush=True)
    return out


def check_chaos_sim() -> dict:
    """``flash-crowd-autoscale`` at seed 3 on the host's event simulator
    and on the card's vector runtime: the control logs, served requests
    within ``SIM_N_REL`` and the first scale-out within ``SIM_SCALE_S``
    of each other (the reference's own bounds)."""
    from repro_torch.core.runtime import run_scenario
    from repro_torch.scenarios import get
    from repro_torch.vector import VectorConfig
    sc = get("flash-crowd-autoscale", seed=3)
    t0 = time.perf_counter()
    sim = run_scenario(sc, "sim")
    sim_wall = time.perf_counter() - t0
    vec = run_scenario(sc, "vector", vector_config=VectorConfig(
        device="cuda"))
    n_sim, n_vec = sim.telemetry.overall().n, vec.telemetry.overall().n
    print(f"sim control_log (host): {sim.control_log}", flush=True)
    print(f"vector control_log (card): {vec.control_log}", flush=True)
    print(f"sim vs vector flash-crowd-autoscale seed 3: served {n_sim} vs "
          f"{n_vec}; sim wall {sim_wall:.3f} s on the host", flush=True)
    if vec.unsupported:
        fail(f"flash-crowd-autoscale on the card: unsupported "
             f"{vec.unsupported}")
    if not math.isclose(n_vec, n_sim, rel_tol=SIM_N_REL):
        fail(f"sim vs vector: served {n_sim} vs {n_vec}, beyond rel "
             f"{SIM_N_REL}")
    ups = [(t, p) for t, k, p in sim.control_log if k == "set_scale"]
    vups = [(t, p) for t, k, p in vec.control_log if k == "set_scale"]
    if not ups or not vups or abs(ups[0][0] - vups[0][0]) > SIM_SCALE_S \
            or ups[0][1] != vups[0][1]:
        fail(f"sim vs vector: first set_scale {ups[:1]} vs {vups[:1]}")
    return {"sim_control_log": sim.control_log,
            "vector_control_log": vec.control_log, "sim_n": n_sim,
            "vector_n": n_vec, "sim_wall_s": sim_wall}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA GPU")
    from repro_torch.kernels import (_build, decode_attention,
                                     flash_attention, ssd_scan,
                                     vector_quantiles, vector_step)
    from repro_torch.vector import VectorConfig, run_cells

    # a float32 product on the card runs in full float32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "unknown"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs) or 'cached'})", flush=True)
    for name, log in logs.items():
        for line in ptxas_report(log):
            print(f"  {name}: {line}")

    device = torch.device("cuda")
    grids = build_grids()
    by_name = {name: (progs, seeds) for name, progs, seeds in grids}

    # ---- kernel checks at main-path shapes ---------------------------------
    record = {"card": card, "checks": {}}
    for key, grid in SCAN_CASES:
        batched, n_real, inputs = scan_case(*by_name[grid], device)
        rec = check_scan(key, batched, n_real, inputs)
        record["checks"][key] = rec
        print(f"check {key}: {json.dumps(rec)}", flush=True)
    for key, grid in QUANTILE_CASES:
        rec = check_quantiles(key, *quantile_case(*by_name[grid], device))
        record["checks"][key] = rec
        print(f"check {key}: {json.dumps(rec)}", flush=True)
    rec = check_quantiles(QUANTILE_SYNTHETIC, *synthetic_quantiles(device))
    record["checks"][QUANTILE_SYNTHETIC] = rec
    print(f"check {QUANTILE_SYNTHETIC}: {json.dumps(rec)}", flush=True)
    for case in FLASH_CASES:
        rec = check_flash(device, *case)
        record["checks"][f"flash_attention/{case[0]}"] = rec
        print(f"check flash_attention {case[0]}: {json.dumps(rec)}",
              flush=True)
    for case in DECODE_CASES:
        rec = check_decode(device, *case)
        record["checks"][f"decode_attention/{case[0]}"] = rec
        print(f"check decode_attention {case[0]}: {json.dumps(rec)}",
              flush=True)
    for case in SSD_CASES:
        rec = check_ssd(device, *case)
        record["checks"][f"ssd_scan/{case[0]}"] = rec
        print(f"check ssd_scan {case[0]}: {json.dumps(rec)}", flush=True)

    # ---- main path 1, the vector grid runtime, end to end ------------------
    vector_kernels = (vector_step.scalar_scan, vector_step.batched_scan,
                      vector_quantiles.fused_quantiles)
    attention_kernels = (flash_attention.flash_attention,
                         decode_attention.decode_attention)
    all_kernels = vector_kernels + attention_kernels + (ssd_scan.ssd_scan,)
    for k in all_kernels:
        k.launches = 0
    results, record["e2e"] = run_grids(grids)
    launches = {k.__name__: k.launches for k in vector_kernels}
    print(f"launches on the vector path: {launches}", flush=True)
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the vector path")
    for name, rows in results.items():
        for i, r in enumerate(rows):
            vals = (r.mean, r.p50, r.p95, r.p99)
            if r.n <= 0 or not all(math.isfinite(v) for v in vals):
                fail(f"{name} cell {i}: n={r.n} row {vals} not finite")

    # ---- main path 1b, the chaos grids (control pre-pass) on the card ------
    chaos = build_chaos_grids()
    record["e2e_chaos"], chaos_launches = {}, {}
    for grid in chaos:
        name = grid[0]
        for k in all_kernels:
            k.launches = 0
        rows, e2e = run_grids([grid])
        results[name] = rows[name]
        record["e2e_chaos"][name] = e2e[name]
        n = {k.__name__: k.launches for k in vector_kernels}
        chaos_launches[name] = n
        print(f"launches on the chaos grid {name}: {n}", flush=True)
        if n["scalar_scan"] != 1 or n["fused_quantiles"] != 1:
            fail(f"chaos grid {name}: scalar_scan and fused_quantiles "
                 f"must launch once each, got {n}")
        for i, r in enumerate(rows[name]):
            vals = (r.mean, r.p50, r.p95, r.p99)
            if r.n <= 0 or not all(math.isfinite(v) for v in vals):
                fail(f"{name} cell {i}: n={r.n} row {vals} not finite")
    for name in ("scalar_scan", "fused_quantiles"):
        launches[name] += sum(n[name] for n in chaos_launches.values())
    record["chaos_launches"] = chaos_launches
    record["chaos_sim"] = check_chaos_sim()

    # ---- three cells of each grid against the CPU --------------------------
    for name, progs, seeds in grids + chaos:
        pick = [0, len(progs) // 2, len(progs) - 1]
        cpu = run_cells([progs[i] for i in pick], [seeds[i] for i in pick],
                        VectorConfig(device="cpu"))
        same = 0
        for i, row in zip(pick, cpu):
            gpu = results[name][i]
            why = rows_close(gpu, row)
            if why:
                fail(f"{name} cell {i}: card vs CPU: {why}")
            same += (gpu.n, gpu.mean, gpu.p50, gpu.p95, gpu.p99) == \
                (row.n, row.mean, row.p50, row.p95, row.p99)
        print(f"cpu parity {name}: cells {pick} match "
              f"({same} of 3 bit-identical)", flush=True)
    record["chaos_control"] = check_chaos_control(chaos)

    # ---- full width, reduced depth: the card against the CPU ---------------
    record["full_width"] = check_full_width(device)
    record["full_width_mamba"] = check_full_width(
        device, "mamba2-1.3b", 384, MAMBA_F32_LOGIT_TOL, MAMBA_BF16_LOGIT_TOL)

    # ---- main path 2, serving phi3-mini-3.8b at full width -----------------
    for k in all_kernels:
        k.launches = 0
    torch.cuda.synchronize()
    record["serving"] = run_serving()
    serve_launches = {k.__name__: k.launches for k in attention_kernels}
    print(f"launches on the serving path: {serve_launches}", flush=True)
    for name, n in serve_launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the serving path")
    launches.update(serve_launches)
    r = record["serving"]
    from repro_torch.configs.base import get_config
    layers = get_config("phi3-mini-3.8b").num_layers
    replicas = int(SERVE_ARGS[SERVE_ARGS.index("--replicas") + 1])
    want = layers * (r["prefills"] + replicas)      # requests + warm-ups
    if serve_launches["flash_attention"] != want or r["prefills"] != r["n"]:
        fail(f"phi3 serving: flash_attention launched "
             f"{serve_launches['flash_attention']} times, expected {layers} "
             f"x ({r['prefills']} prefills + {replicas} warm-ups) = {want} "
             f"for {r['n']} requests")
    want = layers * (r["decode_steps"] + replicas)   # one per warm-up
    if serve_launches["decode_attention"] != want:
        fail(f"phi3 serving: decode_attention launched "
             f"{serve_launches['decode_attention']} times, expected "
             f"{layers} x ({r['decode_steps']} decode steps + {replicas} "
             f"warm-ups) = {want}")
    print(f"serving phi3-mini-3.8b: {r['n']} requests, p50 "
          f"{r['p50_ms']:.1f} ms, p95 {r['p95_ms']:.1f} ms, p99 "
          f"{r['p99_ms']:.1f} ms, TTFT p50 {r['ttft_p50_ms']:.1f} ms, "
          f"decode step {r['decode_step_ms']:.2f} ms, "
          f"{r['tokens_per_s']:.1f} tokens/s", flush=True)

    # ---- main path 3, serving mamba2-1.3b at full width --------------------
    for k in all_kernels:
        k.launches = 0
    torch.cuda.synchronize()
    record["serving_mamba"] = r = run_serving(MAMBA_SERVE_ARGS)
    mamba_launches = {k.__name__: k.launches for k in all_kernels}
    print(f"launches on the mamba2 serving path: {mamba_launches}",
          flush=True)
    layers = get_config("mamba2-1.3b").num_layers
    replicas = int(MAMBA_SERVE_ARGS[MAMBA_SERVE_ARGS.index("--replicas")
                                    + 1])
    want = layers * (r["prefills"] + replicas)      # requests + warm-ups
    n_ssd = mamba_launches["ssd_scan"]
    if n_ssd < 1 or n_ssd != want or r["prefills"] != r["n"]:
        fail(f"mamba2 serving: ssd_scan launched {n_ssd} times, expected "
             f"{layers} x ({r['prefills']} prefills + {replicas} warm-ups) "
             f"= {want} for {r['n']} requests")
    launches["ssd_scan"] = n_ssd
    print(f"serving mamba2-1.3b: {r['n']} requests, p50 "
          f"{r['p50_ms']:.1f} ms, p95 {r['p95_ms']:.1f} ms, p99 "
          f"{r['p99_ms']:.1f} ms, TTFT p50 {r['ttft_p50_ms']:.1f} ms, "
          f"prefill {r['prefill_ms']:.2f} ms, decode step "
          f"{r['decode_step_ms']:.2f} ms, {r['tokens_per_s']:.1f} tokens/s",
          flush=True)

    # ---- the kernels line ---------------------------------------------------
    src = "src/repro_torch/kernels/csrc/"
    checks = record["checks"]
    entries = []
    served_flash = f"flash_attention/{FLASH_CASES[1][0]}"
    served_decode = f"decode_attention/{DECODE_CASES[0][0]}"
    served_ssd = f"ssd_scan/{SSD_CASES[0][0]}"
    for name, route_src, replaces, key, err_keys in (
            ("scalar_scan", src + "vector_step.cu",
             "src/repro/kernels/vector_step.py:98", "scalar_scan/fig1",
             tuple(k for k, _ in SCAN_CASES if k.startswith("scalar"))),
            ("batched_scan", src + "vector_step.cu",
             "src/repro/kernels/vector_step.py:132",
             "batched_scan/batched8", ("batched_scan/batched8",)),
            ("fused_quantiles", src + "vector_quantiles.cu",
             "src/repro/kernels/vector_quantiles.py:57",
             "fused_quantiles/fig1",
             tuple(k for k, _ in QUANTILE_CASES) + (QUANTILE_SYNTHETIC,)),
            ("flash_attention", src + "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:84", served_flash,
             tuple(f"flash_attention/{c[0]}" for c in FLASH_CASES)),
            ("decode_attention", src + "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:62", served_decode,
             tuple(f"decode_attention/{c[0]}" for c in DECODE_CASES)),
            ("ssd_scan", src + "ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:66", served_ssd,
             tuple(f"ssd_scan/{c[0]}" for c in SSD_CASES))):
        c = checks[key]
        entries.append({
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(checks[k]["max_abs_err"] for k in err_keys),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c.get("library_ms")})
    for e in entries:
        if e["ms"] < e["bound_ms"]:
            fail(f"kernel {e['name']}: {e['ms']:.5f} ms reads under its "
                 f"bound {e['bound_ms']:.5f} ms")
    record["kernels"] = entries
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
