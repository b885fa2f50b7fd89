"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card, the vector grid runtime (the
canonical grids and the chaos grids, whose timelines the control
pre-pass shapes) and real-model serving of dense attention models
(phi3-mini-3.8b, gemma3-12b with its sliding-window layers, and
llava-next-mistral-7b), of an MoE model (deepseek-moe-16b), of a
Mamba-2 model (mamba2-1.3b) and of the hybrid jamba-1.5-large's
Mamba/attention/MoE layers, runs the encoder-decoder whisper-small, and
trains phi3-mini-3.8b and mamba2-1.3b at full width and depth:

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
4c. runs the sweep layer (``repro_torch.sweep.run_sweep``) on the card:
   the fig1 grid of ``benchmarks/torch_port/bench_vector.py`` (117 cells)
   and the flash crowd's 2 points x 13 reps, each in one ``scalar_scan``
   and one ``fused_quantiles`` launch with rows equal, bit for bit, to
   ``run_cells`` on the programs and seeds of the same declaration; then
   a ``steady`` sweep with a ``runtime`` axis over ``sim|vector`` under
   the process executor, started after the card is initialised (its
   workers come from a forkserver), whose frame must equal the serial
   one and whose vector rows must equal the CPU's;
4d. runs the planner (``repro_torch.plan.run_plan``) on bench_plan's
   FULL problem (steady/jsq at 2600 QPS, 12 s; 3 starts x 150 Adam
   steps through the surrogate, then the exact probe ladder) on the card
   and on the CPU: ``n_star``, the probe sequence and ``cell_evals``
   equal, verified values within ``PLAN_VALUE_RTOL``, the continuous
   capacity within ``PLAN_CAPACITY_TOL``, at most a tenth of the dense
   grid's 312 cells, and one ``scalar_scan`` and one ``fused_quantiles``
   launch a ladder grid; prints ``plan:`` lines with the walls;
4e. runs a soft ``steady`` grid (8 s, seed 3, ``SOFT_REPS`` cells) on the
   card and on the CPU: no kernel launched (soft consts take the plain
   step), rows equal within ``SOFT_RTOL``; prints a ``soft:`` line with
   the walls;
4f. runs the result cache (``repro_torch.cache``) on the card, in a
   scratch directory under ``build/`` removed at the end: the fig1 sweep
   cold through a fresh cache (one ``scalar_scan`` and one
   ``fused_quantiles`` launch, 117 cells and 117 rows stored, rows equal
   to 4c's uncached frame), warm through a new cache on the same
   directory (117 hits from disk, no miss, no vector-kernel launch, rows
   equal), with one QPS point edited (``CACHE_EDIT_QPS``: its 13 cells in
   one launch, the other 104 rows equal), three fig1 cells on the CPU
   through that directory (3 misses: the device is in the key), and
   bench_plan's smoke problem planned on the card twice through a
   directory of its own: cold (the ladder's grids launch) and warm
   (``cell_evals`` 0, no launch, the same ``n_star``, probes and
   verified values); prints ``cache:`` lines with the walls;
5. runs phi3-mini-3.8b at full width and a depth of 2 layers on the CPU
   (plain versions) and on the card (kernels), from the same seeded
   weights: a 128-token prompt and 8 greedy tokens, equal tokens and
   logits within ``F32_LOGIT_TOL`` with the weights in f32; the served
   bf16 weights, the card fed the CPU's tokens, within ``BF16_LOGIT_TOL``;
   then mamba2-1.3b the same way, with a 384-token prompt (the SSD scan
   pads it into a second chunk), within ``MAMBA_F32_LOGIT_TOL`` and
   ``MAMBA_BF16_LOGIT_TOL``; then gemma3-12b at 6 layers (one group: 5
   sliding-window layers and a global one) with an 1100-token prompt,
   past its 1024-token window, so the prefill fills the ring and the
   decode writes into the wrapped ring, and stablelm-3b,
   command-r-35b and the MoE models deepseek-moe-16b (64 experts, top-6,
   2 shared) and mixtral-8x22b (8 experts, top-2, sliding window) at 2
   layers with 128-token prompts (``FULL_WIDTH_CHECKS``: phi3's
   tolerances, the f32 one widened to ``GEMMA_F32_LOGIT_TOL`` for gemma3
   and ``DEEPSEEK_F32_LOGIT_TOL`` for deepseek); then the cut of
   jamba-1.5-large's pattern group that one card holds (``JAMBA_CUT``:
   attention with its dense MLP, then Mamba with the 16-expert MoE FFN,
   11.9 B parameters, drawn on the card) with a 384-token prompt,
   whisper-small at full depth (12 encoder and 12 decoder layers) over
   1500 seeded frames with a 64-token prompt, so that every decode step
   runs cross attention over all 1500 encoder positions, and
   llava-next-mistral-7b at 2 layers behind a 2880-patch image prefix
   (a 3008-long prefill; ``LLAVA_F32_LOGIT_TOL``); for an MoE model the
   share of router choices (layer, token, k) that the card and the CPU
   agree on is recorded; each model is freed before the next;
6. serves phi3-mini-3.8b and then mamba2-1.3b at full width through
   ``repro_torch.launch.serve.main`` (2 replicas sharing one copy of the
   weights, open-loop clients, 10 s each), checks that every request
   completed with finite latencies and that the path's kernels were
   launched (both attention kernels for phi3, ``flash_attention`` once
   per layer and prefill, ``decode_attention`` once per layer and decode
   step; ``ssd_scan`` once per layer and prefill for mamba2; warm-ups
   included), and prints the serving metrics;
6c. serves gemma3-12b at full width and full depth (48 layers, 11.8 B
   parameters in bf16) the same way, with 1100-token prompts
   (``GEMMA_SERVE_ARGS``): every request must complete, with
   ``flash_attention`` launched 48 times a prefill and
   ``decode_attention`` 48 times a decode step (warm-ups included);
6d. serves deepseek-moe-16b at full width and full depth (28 MoE
   layers, 16.9 B parameters, 33.8 GB in bf16) the same way, with
   serve-phi3's flags (``DEEPSEEK_SERVE_ARGS``): every request must
   complete, with ``flash_attention`` launched 28 times a prefill and
   ``decode_attention`` 28 times a decode step (warm-ups included); the
   card's peak memory after the weights' initialisation is recorded;
6e. serves llava-next-mistral-7b at full width and full depth (32
   layers, 7.2 B parameters) the same way, with serve-phi3's flags
   (``LLAVA_SERVE_ARGS``: token prompts, as the JAX package's engine
   serves this arch): ``flash_attention`` 32 times a prefill,
   ``decode_attention`` 32 times a decode step;
6f. runs the jamba cut on one ``InferenceEngine`` (max batch 4): 8
   prompts of 512 tokens (two scan chunks), 16 new tokens each; every
   request must complete, with ``ssd_scan`` and ``flash_attention``
   launched once a prefill and ``decode_attention`` once a decode step
   (the warm-up's included); prints the prefill and decode-step times
   and the card's peak memory after the weights' initialisation;
6b. drives the closed loop and the retry path on real phi3-mini-3.8b
   replicas at full width (``run_experiment_on_real_engines``, as
   ``launch.serve --scenario`` runs it): ``flash-crowd-autoscale`` with 2
   active and 4 standby replicas sharing one copy of the weights, whose
   autoscaler must scale above 2 replicas and back down, and
   ``retry-storm`` with jittered backoff, which must retry; the offered
   loads and the timeout are scaled to what 2 such replicas sustain,
   measured first in the same phase (a saturation run), and to their
   batch slots (``engine_runs``).  The autoscaler
   must scale out on a tick inside the burst and back down after it;
   every attempt must be served, retried, timed out or lost, with finite
   latencies and nothing left in flight, and both attention kernels must
   be launched;
6g. trains: phi3-mini-3.8b (batch 8 x 128 tokens) and mamba2-1.3b (8 x
   512, two scan chunks) at full width and 2 layers in f32, one loss and
   gradient (``launch.train``'s loss: remat on, chunked cross-entropy)
   on the CPU (plain versions) and on the card (the kernels' forward,
   the plain versions' backward), from step 5's seed at
   ``layer_std_specs``' scales (``TRAIN_AGREEMENT`` says why): the
   loss within ``TRAIN_LOSS_RTOL``, the gradients' global norm within
   ``TRAIN_GNORM_RTOL`` and every gradient leaf within
   ``TRAIN_GRAD_TOL`` of its max|g|, the path's kernel launched twice a
   layer (the forward and the remat recompute); then both at full depth
   in bf16 through ``repro_torch.launch.train.main`` (its defaults:
   batch 8, seq 128, mamba2 at 512; ``TRAIN_STEPS`` steps): a finite
   loss every step, the last below the first, the kernel twice a layer
   and step, with the step time, tokens/s and the card's peak memory
   printed; then, in a subprocess with deterministic algorithms
   (``CUBLAS_WORKSPACE_CONFIG=:4096:8``), ``examples/torch_port/
   train_lm.py`` to its assert and ``launch.train`` straight against
   checkpointed at step 3 and resumed (``RESUME_ARGS``), whose step-6
   checkpoints must hold equal bits (checkpoints under ``build/``,
   removed at the end); then ``benchmarks/torch_port/engine_serving.py``
   and ``examples/torch_port/serve_e2e.py`` on the card, every request
   served and both attention kernels launched;
7. runs the launch tooling where the port runs (``run_tooling``): the
   meta-device dry-run (``repro_torch.launch.dryrun.run_cell``) of
   phi3-mini-3.8b at ``train_4k``, ``prefill_32k`` and ``decode_32k``
   on the one-card mesh, with its roofline (``launch.roofline``); then
   the dry-run of step 6g's phi3 training shape (batch 8 x 128, bf16
   weights, bf16 ``m``, f32 ``v``) against the state ``launch.train``
   builds on the card (``init_params``, ``init_opt_state``, a
   ``SyntheticLM`` batch): the same leaves (path, shape, dtype), the
   same bytes, and a rise in ``torch.cuda.memory_allocated()`` above
   the dry-run's bytes by no more than the caching allocator's
   rounding (``_allocator_slack``), its temp estimate printed beside
   6g's peak; and
   the roofline's ``ideal_s`` at 6g's train step and step 6's phi3
   decode step over the measured steps (the roofline shares);
7b. runs the port's static analysis and then what its check rejects
   (``run_analysis``): ``python -m repro_torch.analysis --strict --json
   src/repro_torch`` in a subprocess (0 errors, 0 warnings; the
   suppressed count printed); ``check_scenario(sc, backend="vector")``
   for every registered scenario, which must reject exactly
   ``ANALYSIS_REJECTED`` (``churn-storm``, ``retry-storm``), each with a
   ``capability`` error; each of those through ``run_scenario(sc,
   "vector")`` on the card (one cell, rep 0), whose ``unsupported``
   kinds must be exactly the features check named
   (``skipped_kinds``), with one ``scalar_scan`` and one
   ``fused_quantiles`` launch a run and finite rows; the programs of the
   check-passed scenarios that steps 4 and 4b ran skip nothing; a
   ``legacy_mode`` declaration is rejected by check and refused by the
   compiler; the phase must end within ``ANALYSIS_BUDGET_S``;
8. times each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events (median of
   repeated runs), and fails where a kernel's time reads under its
   bound (every SSD case, and every kernel of the kernels line);
9. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
   ...}`` line.

Any failed phase exits non-zero.  Without a CUDA device, or without the
rest of the repository beside it, the script fails before printing any
result.  The full record is also written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
#: the same for gemma3-12b at full width, 6 layers (one pattern group),
#: an 1100-token prompt.  f32: the prefill's logits agree to 7.7e-6, but
#: every decode step reads bf16 K/V caches, which an f32 difference in
#: the last place can round apart, and this random-weight model turns
#: that into up to ~2e-3 of max|logit| (one group, so its matrices are
#: drawn at std 1 and each projection scales by sqrt(d_model)): the card
#: read 1.821e-3 with the kernels and 1.821e-3 with the plain versions on
#: the card, and the CPU against itself with every weight moved by one
#: f32 ulp 1.583e-3 (scripts/full_width_sensitivity.py; H100 80GB HBM3,
#: 700 W); tokens equal.  bf16: 4 logit rounding steps, as for phi3
GEMMA_F32_LOGIT_TOL = 3e-3
#: the same for deepseek-moe-16b at full width, 2 layers, a 128-token
#: prompt.  f32: the prefill's logits agree to 1.8e-6 and the card and
#: the CPU make the same router choice at every (layer, token, k), but one
#: decode step of 9 read 3.961e-3 (the others <= 5.0e-4): a bf16 K/V
#: cache entry rounded apart, in a model whose std-1/sqrt(2) matrices
#: make attention scores so large that one bf16 step moves the output;
#: the CPU against itself with every weight moved by one f32 ulp reads
#: 8.165e-3, the plain versions on the card 5.003e-4
#: (scripts/full_width_sensitivity.py --arch deepseek-moe-16b --layers 2
#: --prompt 128; H100 80GB HBM3, 700.00 W); tokens equal.  bf16: 4 logit
#: rounding steps, as for phi3 (the card read 1.515e-2)
DEEPSEEK_F32_LOGIT_TOL = 1e-2
#: whisper-small (full depth) and llava-next-mistral-7b (2 layers) run
#: on weights drawn at ``layer_std_specs``' scales.  At the reference's
#: draw (each stacked matrix at std 1/sqrt(its group count)) whisper's 24
#: layers are chaotic: the CPU against itself with every f32 weight one
#: ulp off reads 0.693-0.932 of max|logit| a step, the card 0.683-0.858
#: with the kernels and 0.634-0.894 with the plain versions
#: (scripts/full_width_sensitivity.py --check whisper-small
#: --reference-draw; H100 80GB HBM3, 700.00 W), and no bound can be
#: held; at the per-layer draw whisper's prefill
#: agrees to 7.7e-7 and its decode steps, which read bf16 caches, to
#: 7.50e-4 (plain versions on the card 7.37e-4, CPU one ulp off 7.13e-4:
#: scripts/full_width_sensitivity.py --check whisper-small), under
#: F32_LOGIT_TOL.  llava at the reference's draw (std 1/sqrt(2)) read
#: 1.911e-2 on one decode step of 9, with the kernels and with the plain
#: versions on the card alike (a bf16 K/V entry rounded apart under
#: attention scores that large; the CPU one ulp off 3.244e-4 there:
#: --reference-draw); at the per-layer draw every decode step
#: reads 6.8e-4-1.052e-3 with the kernels, 7.2e-4-9.85e-4 with the plain
#: versions on the card and 4.8e-4-8.05e-4 on the CPU one ulp off
#: (--check llava-next-mistral-7b): the bf16 caches' rounding, not a
#: kernel's, so its bound is 2e-3
LLAVA_F32_LOGIT_TOL = 2e-3
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
#: serve-phi3's flags for gemma3-12b, with prompts past its 1024-token
#: sliding window (the engine prefills them at their exact length)
GEMMA_PROMPT = 1100
GEMMA_SERVE_ARGS = ["--arch", "gemma3-12b", "--replicas", "2",
                    "--max-batch", "4", "--prompt-len", str(GEMMA_PROMPT),
                    "--max-new", "32", "--clients", "2", "--qps", "2",
                    "--duration", "10", "--policy", "jsq", "--seed", "0"]
#: gemma3-12b's decode cache length in that run (make_warmed_engine)
GEMMA_SERVE_MAX_LEN = GEMMA_PROMPT + 32 + 32
#: the cut of jamba-1.5-large-398b's pattern group that one card holds at
#: full width: its positions 4 and 5, attention with the dense MLP
#: (d_ff 24576), then Mamba (128 heads of 128, d_state 128) with the MoE
#: FFN (16 experts of d_ff 24576, top-2); 11,898,463,872 parameters,
#: 23.8 GB in bf16 (one group of 8 layers is 90.3 GB)
JAMBA_CUT = dict(num_layers=2, pattern=("attn", "mamba"), moe_positions=(1,))
#: whisper-small's encoder input: 1500 frames, its 30-second window
WHISPER_FRAMES = 1500
#: llava-next-mistral-7b's anyres image prefix: a 2x2 grid of 336-pixel
#: tiles and the base image, 5 x 576 patches
LLAVA_PATCHES = 5 * 576
#: the full-width checks of step 5 after phi3 and mamba2 (keyword
#: arguments of check_full_width).  gemma3's 6 layers are one pattern
#: group (5 sliding-window layers and a global one); its prompt is longer
#: than the window.  jamba's cut is drawn on the card (its 11.9 G draws
#: take ~80 s on the host's generator) and copied to the host; its f32
#: run keeps the expert banks in bf16 (moe_specs' dtype), which halves
#: the host's second copy; its 384-token prompt crosses the scan's
#: 256-step chunk.  whisper-small runs at full depth (12 encoder and 12
#: decoder layers) over 1500 frames, llava at 2 layers behind the
#: 2880-patch prefix (a 3008-long prefill), both on weights drawn at
#: ``layer_std_specs``' scales (see LLAVA_F32_LOGIT_TOL)
FULL_WIDTH_CHECKS = [
    dict(arch="gemma3-12b", layers=6, prompt_len=GEMMA_PROMPT,
         f32_tol=GEMMA_F32_LOGIT_TOL),
    dict(arch="stablelm-3b"),
    dict(arch="command-r-35b"),
    dict(arch="deepseek-moe-16b", f32_tol=DEEPSEEK_F32_LOGIT_TOL),
    dict(arch="mixtral-8x22b"),
    dict(arch="jamba-1.5-large-398b", prompt_len=384, over=JAMBA_CUT,
         draw_on_card=True, bf16_banks=True),
    dict(arch="whisper-small", layers=None, prompt_len=64,
         extra={"frames": (WHISPER_FRAMES, 128)}, layer_std=True),
    dict(arch="llava-next-mistral-7b", f32_tol=LLAVA_F32_LOGIT_TOL,
         extra={"patch_embeds": (LLAVA_PATCHES, 1024)}, layer_std=True)]
#: serve-phi3's flags for deepseek-moe-16b at full depth (step 6d)
DEEPSEEK_SERVE_ARGS = ["--arch", "deepseek-moe-16b", "--replicas", "2",
                       "--max-batch", "4", "--prompt-len", "128",
                       "--max-new", "32", "--clients", "2", "--qps", "2",
                       "--duration", "10", "--policy", "jsq", "--seed", "0"]
#: serve-phi3's flags for llava-next-mistral-7b at full depth (step 6e):
#: token prompts, as the JAX package's engine serves this arch
LLAVA_SERVE_ARGS = ["--arch", "llava-next-mistral-7b", "--replicas", "2",
                    "--max-batch", "4", "--prompt-len", "128",
                    "--max-new", "32", "--clients", "2", "--qps", "2",
                    "--duration", "10", "--policy", "jsq", "--seed", "0"]
#: the decode cache length of that run (make_warmed_engine: prompt + new
#: tokens + 32) and the prefill bucket of its 128-token prompts
SERVE_MAX_LEN = 128 + 32 + 32
SERVE_BUCKET = 128
#: step 6f: the jamba cut on one engine, ``JAMBA_ENGINE_REQUESTS``
#: prompts of ``JAMBA_ENGINE_PROMPT`` tokens (two scan chunks), each
#: generating ``JAMBA_ENGINE_NEW`` tokens, max batch 4; its decode cache
#: length (make_warmed_engine)
JAMBA_ENGINE_REQUESTS = 8
JAMBA_ENGINE_PROMPT = 512
JAMBA_ENGINE_NEW = 16
JAMBA_ENGINE_MAX_LEN = JAMBA_ENGINE_PROMPT + JAMBA_ENGINE_NEW + 32
#: the engine-control phase (step 6b): the closed loop and the retry path
#: on real phi3-mini-3.8b replicas at full width, the serving runs' shape
#: (max batch 4, 128-token prompts, 32 new tokens).  Its saturation run
#: offers ENGINE_SATURATION requests at 100 QPS to ENGINE_REPLICAS of them
#: behind jsq, and the loads of its two scenarios are scaled to what it
#: reads (engine_runs)
ENGINE_ARCH = "phi3-mini-3.8b"
ENGINE_SHAPE = dict(max_batch=4, prompt_len=128, max_new_tokens=32)
ENGINE_REPLICAS = 2
ENGINE_SLOTS = ENGINE_REPLICAS * ENGINE_SHAPE["max_batch"]
ENGINE_SATURATION = 24


def engine_runs(rate: float, batch_s: float) -> list:
    """(scenario, overrides) of the engine-control phase, scaled to the
    replicas' sustained ``rate`` (requests/s) and ``batch_s``, the latency
    of a request in a full batch that did not queue.

    One host thread steps the replicas in turn, so an opened replica adds
    batch slots, not throughput, and the autoscaler's utilization settles
    near the offered load over ``rate`` whatever the fleet's size.  The
    flash crowd's base is therefore 0.1x the rate, far under the 0.35
    scale-in threshold, and its burst adds 0.9x, which takes the offered
    load to the rate: the slots fill, the autoscaler opens standby
    replicas, and once the burst's backlog drains it closes them before
    the horizon.  The backoff retry storm offers 0.4x the rate and, in
    its 2.5 s burst, four times the fleet's batch slots, whose tail waits
    out a timeout of 2x ``batch_s`` on a fast host and a slow one alike.
    """
    return [("flash-crowd-autoscale",
             dict(duration=30.0, base_qps=0.1 * rate, peak_qps=0.9 * rate)),
            ("retry-storm",
             dict(duration=15.0, mode="backoff", qps=0.4 * rate,
                  burst_len=2.5, burst_qps=4 * ENGINE_SLOTS / 2.5,
                  timeout=2.0 * batch_s))]


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


def scenario_grid(name, points, **kw) -> tuple:
    """(name, programs, seeds): each point of a registered scenario x 13
    reps, every cell with its own sweep-derived seed."""
    from repro_torch.scenarios import get
    from repro_torch.sweep import spawn_seed
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
    from repro_torch.sweep import spawn_seed
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
#: the sweep phase's mixed frame: ``steady`` at these offered loads, 6 s,
#: 3 reps, a ``runtime`` axis over ``sim|vector``, 2 process workers
MIXED_QPS = (400.0, 1200.0)
#: the row metrics the sweep phase holds against ``run_cells``'s results
#: (where a sweep reads them: ``build_grid``'s fig1 reads no ``dropped``)
SWEEP_METRICS = ("n", "mean", "p50", "p95", "p99", "dropped")


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


#: (label, B, S, T, H, KV, hd, causal, window): phi3's prefill at three
#: prompt buckets and the bucket the serving run uses, one GQA case with a
#: sliding window, the served prefills of gemma3-12b (its sliding-window
#: and global layers at the 1100-token prompt), stablelm-3b,
#: command-r-35b and deepseek-moe-16b; whisper-small's encoder (over its
#: 1500 frames) and cross attention (step 5's 64-token decoder prompt over
#: them), both without a mask; llava's step-5 prefill behind its image
#: prefix, the jamba cut's attention layer at step 6f's prompt and phi3's
#: training batch (step 6g)
FLASH_CASES = [
    ("phi3 S=32", 1, 32, 32, 32, 32, 96, True, None),
    ("phi3 S=128 (served bucket)", 1, SERVE_BUCKET, SERVE_BUCKET, 32, 32, 96,
     True, None),
    ("phi3 S=512", 1, 512, 512, 32, 32, 96, True, None),
    ("phi3 S=2048", 1, 2048, 2048, 32, 32, 96, True, None),
    ("gqa+window S=1024", 1, 1024, 1024, 32, 8, 128, True, 256),
    ("gemma3-12b SWA S=1100", 1, GEMMA_PROMPT, GEMMA_PROMPT, 16, 8, 256,
     True, 1024),
    ("gemma3-12b global S=1100", 1, GEMMA_PROMPT, GEMMA_PROMPT, 16, 8, 256,
     True, None),
    ("stablelm-3b S=128", 1, 128, 128, 32, 32, 80, True, None),
    ("command-r-35b S=128", 1, 128, 128, 64, 8, 128, True, None),
    ("deepseek-moe-16b S=128 (served bucket)", 1, 128, 128, 16, 16, 128,
     True, None),
    ("whisper-small encoder S=T=1500", 1, WHISPER_FRAMES, WHISPER_FRAMES,
     12, 12, 64, False, None),
    ("whisper-small cross S=64 T=1500", 1, 64, WHISPER_FRAMES, 12, 12, 64,
     False, None),
    ("llava S=3008", 1, LLAVA_PATCHES + 128, LLAVA_PATCHES + 128, 32, 8,
     128, True, None),
    ("jamba S=512", 1, JAMBA_ENGINE_PROMPT, JAMBA_ENGINE_PROMPT, 64, 8, 128,
     True, None),
    ("phi3 training B=8 S=128", 8, 128, 128, 32, 32, 96, True, None),
]


def check_flash(device, label, B, S, T, H, KV, hd, causal, window) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device=device).manual_seed(S * 131 + KV)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device
                           ).to(torch.bfloat16)
    q, k, v = rnd(B, S, H, hd), rnd(B, T, KV, hd), rnd(B, T, KV, hd)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    plain = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"flash_attention {label}: output not finite")
    err = (out.float() - plain.float()).abs().max().item()
    tol = ATTN_TOL * v.float().abs().max().item()
    if err > tol:
        fail(f"flash_attention {label}: |kernel - plain| {err:.3e} > "
             f"{tol:.3e}")
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    ok = j <= i if causal else torch.ones((S, T), dtype=torch.bool,
                                          device=device)
    if window is not None:
        ok &= j > i - window
    pairs = int(ok.sum().item())                 # unmasked (query, key)
    bound_ms, bound_by = attention_bound(
        nbytes((q, k, v, out)), 4.0 * hd * pairs * H * B, BF16_OPS_PER_S)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window is None:
        def library():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)
    else:
        def library():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=ok,
                                           enable_gqa=True)
    return {"shape": {"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": hd,
                      "causal": causal, "window": window},
            "max_abs_err": err, "tol": tol,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                     window=window)),
            "plain_ms": cuda_ms(lambda: ref.flash_attention(
                q, k, v, causal=causal, window=window)),
            "library_ms": library_time(library),
            "bound_ms": bound_ms, "bound_by": bound_by}


#: (label, B, T, H, KV, hd, window, ring[, positions]): the serving run's
#: decode (max batch 4, T = its cache length), one ring/window case,
#: gemma3-12b's decode shapes (its 1024-slot sliding-window ring, and its
#: global layers' cache in the serving run), the served shape at batch 1,
#: as a lightly loaded replica runs it, deepseek-moe-16b's and
#: llava-next-mistral-7b's served decode, the jamba cut's at step 6f, and
#: whisper-small's cross attention at decode: over its 1500 encoder
#: positions with ``lengths`` only (``positions`` False: no key
#: positions, no query position)
DECODE_CASES = [
    ("phi3 serving B=4 T=192", 4, SERVE_MAX_LEN, 32, 32, 96, None, False),
    ("ring+window B=4 T=512", 4, 512, 32, 8, 128, 384, True),
    ("gemma3-12b B=4 T=1024 ring", 4, 1024, 16, 8, 256, 1024, True),
    ("phi3 B=1 T=192", 1, SERVE_MAX_LEN, 32, 32, 96, None, False),
    ("gemma3-12b global B=4 T=1164", 4, GEMMA_SERVE_MAX_LEN, 16, 8, 256,
     None, False),
    ("deepseek-moe-16b serving B=4 T=192", 4, SERVE_MAX_LEN, 16, 16, 128,
     None, False),
    ("whisper-small cross B=1 T=1500", 1, WHISPER_FRAMES, 12, 12, 64, None,
     False, False),
    ("llava serving B=4 T=192", 4, SERVE_MAX_LEN, 32, 8, 128, None, False),
    (f"jamba B=4 T={JAMBA_ENGINE_MAX_LEN}", 4, JAMBA_ENGINE_MAX_LEN, 64, 8,
     128, None, False),
]


def check_decode(device, label, B, T, H, KV, hd, window, ring,
                 positions=True) -> dict:
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
    if not positions:        # the kernel's defaults: slot j at position j
        kw = dict(lengths=lengths)
        pos = torch.arange(T, dtype=torch.int32, device=device).repeat(B, 1)
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
    small = nbytes((q, out, lengths) + ((pos, q_pos) if positions else ()))
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
                      "key_positions": positions,
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
#: served shape in f32, jamba-1.5-large's Mamba layer (128 heads of 128,
#: d_state 128) at the same prompt, and mamba2's training batch (step 6g)
SSD_CASES = [
    ("mamba2 s=512 (served)", 1, 512, 64, 64, 128, 256, "bf16"),
    ("mamba2 s=384 (padded)", 1, 384, 64, 64, 128, 256, "bf16"),
    ("mamba2 b=4 s=2048", 4, 2048, 64, 64, 128, 256, "bf16"),
    ("mamba2 s=512 f32", 1, 512, 64, 64, 128, 256, "f32"),
    ("jamba-1.5-large s=512 p=128", 1, 512, 128, 128, 128, 256, "bf16"),
    ("mamba2 training b=8 s=512", 8, 512, 64, 64, 128, 256, "bf16"),
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


def greedy(cfg, params, prompt, max_len: int, steps: int, forced=None,
           extra=None):
    """Prefill ``prompt`` (1, S), with the ``extra`` inputs of a model's
    frontend (frames, patch embeddings), and decode ``steps`` tokens
    greedily, or feeding ``forced`` tokens; -> (logits [steps + 1, V] f32
    on the CPU, own argmax tokens)."""
    from repro_torch.models import registry as R
    batch = {"tokens": prompt}
    batch.update({k: v.to(prompt.device) for k, v in (extra or {}).items()})
    logits, cache, pos = R.prefill(cfg, params, batch, max_len)
    out, toks = [logits.float().cpu()], [int(logits.argmax(-1)[0])]
    for i in range(steps):
        feed = toks[-1] if forced is None else forced[i]
        tok = torch.tensor([feed], dtype=torch.int32, device=prompt.device)
        logits, cache = R.decode_step(cfg, params, cache, tok, pos)
        pos = pos + 1
        out.append(logits.float().cpu())
        toks.append(int(logits.argmax(-1)[0]))
    return torch.cat(out), toks


def host_mem_total_gb() -> float:
    """The host's ``MemTotal`` (``/proc/meminfo``), GB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemTotal:"):
            return int(line.split()[1]) * 1024 / 1e9
    return math.nan


def f32_tree(tree, bf16_banks: bool = False, path: tuple = ()):
    """``tree`` in f32; with ``bf16_banks`` the routed expert banks (an
    MoE block's ``wi_0``, ``wi_1``, ``wo``) stay bf16, the dtype
    ``moe_specs`` gives them in any model, shared with ``tree`` (each
    product promotes them to f32 as it reads them)."""
    if isinstance(tree, dict):
        return {k: f32_tree(v, bf16_banks, path + (k,))
                for k, v in tree.items()}
    if bf16_banks and "moe" in path and "shared" not in path \
            and path[-1] in ("wi_0", "wi_1", "wo"):
        return tree
    return tree.float()


def layer_std_specs(tree, stacked: bool = False):
    """A model's spec tree with each stacked matrix of its layer groups
    drawn at the std ``init_tree`` gives one layer's matrix, 1 / sqrt of
    its first per-layer dim, in place of 1 / sqrt of the group count."""
    if isinstance(tree, dict):
        return {k: layer_std_specs(v, stacked or k in ("groups",
                                                       "enc_groups"))
                for k, v in tree.items()}
    if stacked and tree.init == "normal" and tree.scale is None:
        return dataclasses.replace(tree, scale=tree.shape[1] ** -0.5)
    return tree


def full_width_model(arch: str, layers=2, prompt_len: int = 128, over=None,
                     extra=None, draw_on_card: bool = False,
                     layer_std: bool = False):
    """Step 5's model and inputs: ``arch`` at full width, ``layers`` deep
    (None: the config's depth), with ``over`` replaced in its config; the
    bf16 weights of seed 0 on the host (drawn on the card and copied with
    ``draw_on_card``; with ``layer_std`` at ``layer_std_specs``' scales);
    a ``prompt_len``-token prompt of seed 1; the ``extra`` inputs {name:
    shape a row} drawn with numpy from seed 2.
    -> (cfg, params, prompt, extra tensors, decode cache length)."""
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    from repro_torch.models import param as P
    from repro_torch.models import registry as R
    kw = {} if layers is None else {"num_layers": layers}
    kw.update(over or {})
    cfg = replace(get_config(arch), **kw)
    gen = torch.Generator(device="cuda" if draw_on_card else "cpu")
    specs = R.model_specs(cfg)
    params = P.init_tree(layer_std_specs(specs) if layer_std else specs,
                         gen.manual_seed(0), device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                           dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    g = np.random.default_rng(2)
    inputs = {k: torch.from_numpy(g.standard_normal((1,) + tuple(shape))
                                  .astype(np.float32))
              for k, shape in (extra or {}).items()}
    seq = prompt_len + (inputs["patch_embeds"].shape[1]
                        if "patch_embeds" in inputs else 0)
    return cfg, params, prompt, inputs, seq + 8 + 32


def with_routes(fn):
    """-> (fn(), the top-k choices of every MoE router call fn made, on
    the CPU): two runs of one model fed the same tokens make their router
    calls in the same order."""
    from repro_torch.models import moe
    real, routes = moe._router, []

    def spy(cfg, p, x):
        out = real(cfg, p, x)
        routes.append(out[0].cpu())
        return out
    moe._router = spy
    try:
        return fn(), routes
    finally:
        moe._router = real


def routes_agree(a, b) -> float:
    """The share of (layer, token, k) router choices equal in two runs."""
    same = sum(int((x == y).sum()) for x, y in zip(a, b, strict=True))
    return same / sum(x.numel() for x in a)


def check_full_width(device, arch: str = "phi3-mini-3.8b",
                     prompt_len: int = 128, f32_tol: float = F32_LOGIT_TOL,
                     bf16_tol: float = BF16_LOGIT_TOL, layers=2, over=None,
                     extra=None, draw_on_card: bool = False,
                     bf16_banks: bool = False,
                     layer_std: bool = False) -> dict:
    """``arch`` at full width (``full_width_model``): the same seeded
    weights on the CPU (plain versions) and on the card (kernels)."""
    from repro_torch.models import param as P
    from repro_torch.models import registry as R
    t_phase = time.perf_counter()
    cfg, params, prompt, inputs, max_len = full_width_model(
        arch, layers, prompt_len, over, extra, draw_on_card, layer_std)
    steps = 8
    rec = {"cfg": {"name": cfg.name, "num_layers": cfg.num_layers,
                   "pattern": list(cfg.resolved_pattern),
                   "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                   "params": R.count_params(cfg)},
           "prompt": prompt_len, "steps": steps, "max_len": max_len,
           "inputs": {k: list(v.shape) for k, v in inputs.items()},
           "drawn_on": "card" if draw_on_card else "host",
           "layer_std": layer_std,
           "f32_expert_banks": "bf16" if bf16_banks else "f32",
           "host_mem_total_gb": host_mem_total_gb()}
    print(f"full width {arch}: host MemTotal "
          f"{rec['host_mem_total_gb']:.1f} GB, {cfg.num_layers} layers "
          f"{list(cfg.resolved_pattern)}, {rec['cfg']['params']:,} "
          f"parameters drawn on the {rec['drawn_on']}, inputs "
          f"{rec['inputs'] or 'tokens'}, f32 run with {rec['f32_expert_banks']}"
          f" expert banks", flush=True)
    if cfg.mamba is not None:
        m = cfg.mamba
        rec["cfg"].update(mamba_heads=m.n_heads(cfg.d_model),
                          mamba_head_dim=m.head_dim, d_state=m.d_state,
                          chunk=m.chunk)
    if any(k != "mamba" for k in cfg.resolved_pattern):
        rec["cfg"].update(heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                          head_dim=cfg.resolved_head_dim,
                          window=cfg.sliding_window)
    if cfg.enc_dec:
        rec["cfg"]["encoder_layers"] = cfg.num_encoder_layers
    if cfg.moe is not None:
        rec["cfg"].update(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                          shared=cfg.moe.num_shared_experts,
                          expert_d_ff=cfg.moe.expert_d_ff or cfg.d_ff,
                          active_params=R.count_params(cfg, active=True))

    def run(*args, **kw):
        """greedy(...) and, for an MoE model, its router choices."""
        kw["extra"] = inputs
        if cfg.moe is None:
            return greedy(*args, **kw), None
        return with_routes(lambda: greedy(*args, **kw))

    def agree(cpu_routes, card_routes, key):
        if cfg.moe is not None:
            rec[key]["routes_agree"] = routes_agree(cpu_routes, card_routes)
            print(f"full width {arch} {key}: card and CPU router choices "
                  f"agree on {rec[key]['routes_agree']:.6f} of (layer, "
                  f"token, k)", flush=True)

    def rel_steps(a, b):
        return ((a - b).abs().max(-1).values / b.abs().max(-1).values)

    def rel(a, b):
        return rel_steps(a, b).max().item()

    # f32 weights: greedy on each side, the tokens must be equal
    p32 = f32_tree(params, bf16_banks)
    t0 = time.perf_counter()
    (cpu_l, cpu_t), cpu_r = run(cfg, p32, prompt, max_len, steps)
    cpu_s = time.perf_counter() - t0
    (gpu_l, gpu_t), gpu_r = run(cfg, P.tree_map(lambda t: t.to(device), p32),
                                prompt.to(device), max_len, steps)
    del p32
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
    if gpu_t == cpu_t:
        agree(cpu_r, gpu_r, "f32")
    if gpu_t != cpu_t:
        fail(f"full width {arch} f32: greedy tokens differ between card "
             f"and CPU")
    if not err32 <= f32_tol:
        fail(f"full width {arch} f32: logits rel err {err32:.3e} > "
             f"{f32_tol}")
    # the served bf16 weights: the card follows the CPU's tokens
    t0 = time.perf_counter()
    (cpu_l, cpu_t), cpu_r = run(cfg, params, prompt, max_len, steps)
    cpu16_s = time.perf_counter() - t0
    (gpu_l, gpu_t), gpu_r = run(cfg, P.tree_map(lambda t: t.to(device),
                                                params),
                                prompt.to(device), max_len, steps,
                                forced=cpu_t[:-1])
    err16 = rel(gpu_l, cpu_l)
    same = sum(a == b for a, b in zip(cpu_t, gpu_t))
    rec["bf16"] = {"cpu_tokens": cpu_t, "card_argmax": gpu_t,
                   "argmax_agree": same, "logits_rel_err": err16,
                   "logits_rel_err_per_step": rel_steps(gpu_l,
                                                        cpu_l).tolist(),
                   "tol": bf16_tol, "cpu_s": cpu16_s}
    print(f"full width {arch} bf16 (card fed the CPU's tokens): argmax "
          f"agrees at {same} of {steps + 1} steps, logits rel err "
          f"{err16:.3e}", flush=True)
    agree(cpu_r, gpu_r, "bf16")
    if not err16 <= bf16_tol:
        fail(f"full width {arch} bf16: logits rel err {err16:.3e} > "
             f"{bf16_tol}")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"full width {arch}: {cfg.num_layers} layers, "
          f"{rec['cfg']['params']:,} "
          f"parameters, {rec['phase_s']:.1f} s (CPU greedy f32 "
          f"{cpu_s:.1f} s, bf16 {cpu16_s:.1f} s)", flush=True)
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


def check_attention_serving(args, report, launches) -> None:
    """A dense model's serving run (``launch.serve`` flags ``args``):
    ``flash_attention`` once per layer and prefill, ``decode_attention``
    once per layer and decode step, each warm-up (one prefill and one
    decode step a replica) included; every request prefilled once."""
    from repro_torch.configs.base import get_config
    arch = args[args.index("--arch") + 1]
    layers = get_config(arch).num_layers
    replicas = int(args[args.index("--replicas") + 1])
    r = report
    want = layers * (r["prefills"] + replicas)      # requests + warm-ups
    if launches["flash_attention"] != want or r["prefills"] != r["n"]:
        fail(f"{arch} serving: flash_attention launched "
             f"{launches['flash_attention']} times, expected {layers} "
             f"x ({r['prefills']} prefills + {replicas} warm-ups) = {want} "
             f"for {r['n']} requests")
    want = layers * (r["decode_steps"] + replicas)   # one per warm-up
    if launches["decode_attention"] != want:
        fail(f"{arch} serving: decode_attention launched "
             f"{launches['decode_attention']} times, expected "
             f"{layers} x ({r['decode_steps']} decode steps + {replicas} "
             f"warm-ups) = {want}")
    print(f"serving {arch}: {r['n']} requests, p50 "
          f"{r['p50_ms']:.1f} ms, p95 {r['p95_ms']:.1f} ms, p99 "
          f"{r['p99_ms']:.1f} ms, TTFT p50 {r['ttft_p50_ms']:.1f} ms, "
          f"prefill {r['prefill_ms']:.2f} ms, decode step "
          f"{r['decode_step_ms']:.2f} ms, {r['tokens_per_s']:.1f} tokens/s, "
          f"{r['phase_s']:.1f} s", flush=True)


def run_measured_serving(args, kernels) -> tuple:
    """A serving run at full width and full depth (``launch.serve`` flags
    ``args``: step 6d's deepseek-moe-16b, step 6e's llava), with the
    card's memory read right after the weights' initialisation
    (``init_params`` wrapped for the run): the peak while ``init_tree``
    drew them and what they hold.  -> (report, launches of ``kernels``)."""
    import gc

    from repro_torch.models import registry as R
    arch = args[args.index("--arch") + 1]
    gc.collect()
    torch.cuda.empty_cache()
    for k in kernels:
        k.launches = 0
    real, mem = R.init_params, {}
    held = torch.cuda.memory_allocated()

    def init_and_measure(*a, **kw):
        t0 = time.perf_counter()
        params = real(*a, **kw)
        torch.cuda.synchronize()
        mem.update(init_s=time.perf_counter() - t0,
                   held_before_gb=held / 1e9,
                   init_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   weights_gb=(torch.cuda.memory_allocated() - held) / 1e9)
        return params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    R.init_params = init_and_measure
    try:
        report = run_serving(args)
    finally:
        R.init_params = real
    report.update(mem)
    launches = {k.__name__: k.launches for k in kernels}
    print(f"launches on the {arch} serving path: {launches}", flush=True)
    print(f"serving {arch}: init {mem['init_s']:.1f} s, peak "
          f"{mem['init_peak_gb']:.2f} GB at init ({mem['held_before_gb']:.2f}"
          f" GB held before), weights {mem['weights_gb']:.2f} GB", flush=True)
    check_attention_serving(args, report, launches)
    return report, launches


def run_jamba_engine(kernels) -> tuple:
    """Step 6f: the jamba cut (``JAMBA_CUT``) at full width on one
    ``InferenceEngine`` (``make_warmed_engine``, max batch 4): weights of
    seed 0 drawn on the card, ``JAMBA_ENGINE_REQUESTS`` prompts of
    ``JAMBA_ENGINE_PROMPT`` tokens, ``JAMBA_ENGINE_NEW`` new tokens each.
    Every request must complete; ``ssd_scan`` (the Mamba layer) and
    ``flash_attention`` (the attention layer) launch once a prefill,
    ``decode_attention`` once a decode step, the warm-up's included.
    -> (record, launches of ``kernels``)."""
    import gc
    from dataclasses import replace

    from repro_torch.configs.base import MAMBA, get_config
    from repro_torch.models import registry as R
    from repro_torch.serving.engine import make_warmed_engine
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = replace(get_config("jamba-1.5-large-398b"), **JAMBA_CUT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = R.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    rec = {"init_s": time.perf_counter() - t0, "held_before_gb": held / 1e9,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "weights_gb": (torch.cuda.memory_allocated() - held) / 1e9,
           "params": R.count_params(cfg), "requests": JAMBA_ENGINE_REQUESTS,
           "prompt": JAMBA_ENGINE_PROMPT, "new_tokens": JAMBA_ENGINE_NEW,
           "max_len": JAMBA_ENGINE_MAX_LEN}
    for k in kernels:
        k.launches = 0
    eng = make_warmed_engine(cfg, params, max_batch=4,
                             prompt_len=JAMBA_ENGINE_PROMPT,
                             max_new_tokens=JAMBA_ENGINE_NEW)
    rng = np.random.default_rng(0)
    for i in range(JAMBA_ENGINE_REQUESTS):
        eng.submit(rng.integers(0, cfg.vocab_size, JAMBA_ENGINE_PROMPT),
                   JAMBA_ENGINE_NEW, i)
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    rec.update(launches=launches, prefills=eng.prefill_count,
               decode_steps=eng.decode_steps,
               prefill_ms=eng.prefill_seconds / eng.prefill_count * 1e3,
               decode_step_ms=eng.decode_seconds / eng.decode_steps * 1e3,
               tokens_per_s=eng.tokens_done / rec["wall_s"])
    print(f"jamba engine: {len(done)} of {JAMBA_ENGINE_REQUESTS} requests, "
          f"{eng.prefill_count} prefills of {JAMBA_ENGINE_PROMPT} tokens "
          f"{rec['prefill_ms']:.2f} ms, {eng.decode_steps} decode steps "
          f"{rec['decode_step_ms']:.2f} ms (batch 4), "
          f"{rec['tokens_per_s']:.1f} tokens/s; init {rec['init_s']:.1f} s, "
          f"peak {rec['init_peak_gb']:.2f} GB at init "
          f"({rec['held_before_gb']:.2f} GB held before), weights "
          f"{rec['weights_gb']:.2f} GB; launches {launches}", flush=True)
    if sorted(c.req_id for c in done) != list(range(JAMBA_ENGINE_REQUESTS)) \
            or any(len(c.tokens) != JAMBA_ENGINE_NEW
                   or not all(0 <= t < cfg.vocab_size for t in c.tokens)
                   for c in done):
        fail(f"jamba engine: {len(done)} of {JAMBA_ENGINE_REQUESTS} "
             f"requests completed with {JAMBA_ENGINE_NEW} valid tokens")
    mamba = sum(k == MAMBA for k in cfg.resolved_pattern) * cfg.n_groups
    attn = cfg.num_layers - mamba
    # the warm-up: one prefill and one decode step
    want = {"ssd_scan": mamba * (eng.prefill_count + 1),
            "flash_attention": attn * (eng.prefill_count + 1),
            "decode_attention": attn * (eng.decode_steps + 1)}
    if eng.prefill_count != JAMBA_ENGINE_REQUESTS or \
            {k: launches[k] for k in want} != want:
        fail(f"jamba engine: launches {launches}, expected {want} for "
             f"{eng.prefill_count} prefills and {eng.decode_steps} decode "
             f"steps")
    del eng, params
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"jamba engine: {rec['phase_s']:.1f} s", flush=True)
    return rec, launches


def fleet_saturation(engines, vocab: int, clock=time.monotonic,
                     sleep=time.sleep) -> dict:
    """What ``engines`` sustain under ``EngineRuntime`` behind jsq:
    ``ENGINE_SATURATION`` requests offered at 100 QPS (within a quarter of
    a second), drained by the fleet.  The rate is the requests served
    over the run's wall; ``batch_s`` the slowest latency of the first
    full batches (one per replica), which did not queue."""
    from repro_torch.core.client import ClientConfig, ConstantQPS
    from repro_torch.core.runtime import EngineRuntime
    rt = EngineRuntime(
        engines, [ClientConfig(0, ConstantQPS(100.0), seed=1,
                               total_requests=ENGINE_SATURATION)],
        policy="jsq", duration=60.0, vocab=vocab, seed=0,
        prompt_len=ENGINE_SHAPE["prompt_len"],
        max_new_tokens=ENGINE_SHAPE["max_new_tokens"], clock=clock,
        sleep=sleep)
    t0 = clock()
    rt.run()
    wall = clock() - t0
    s = rt.telemetry.overall()
    return {"requests": ENGINE_SATURATION, "served": s.n, "wall_s": wall,
            "rate_per_s": s.n / wall,
            "batch_s": max(rt.recorder.all[:ENGINE_SLOTS], default=math.nan),
            "p50_ms": s.p50 * 1e3, "p99_ms": s.p99 * 1e3}


def engine_capacity(card: str) -> dict:
    """``fleet_saturation`` of ``ENGINE_REPLICAS`` warmed full-width
    replicas on the card, with their decode step."""
    from repro_torch.scenarios.backends import build_real_engines
    engines, _, vocab = build_real_engines(
        ENGINE_ARCH, ENGINE_REPLICAS, seed=0, device="cuda", **ENGINE_SHAPE)
    rec = fleet_saturation(engines, vocab)
    torch.cuda.synchronize()
    rec["decode_step_ms"] = sum(e.decode_seconds for e in engines) \
        / max(sum(e.decode_steps for e in engines), 1) * 1e3
    print(f"engine control saturation: {card}: {rec['served']} of "
          f"{ENGINE_SATURATION} requests in {rec['wall_s']:.3f} s, "
          f"{rec['rate_per_s']:.3f} requests/s, first batches "
          f"{rec['batch_s'] * 1e3:.1f} ms, p50 {rec['p50_ms']:.1f} ms, p99 "
          f"{rec['p99_ms']:.1f} ms, decode step "
          f"{rec['decode_step_ms']:.2f} ms", flush=True)
    if rec["served"] != ENGINE_SATURATION or not all(
            math.isfinite(rec[k]) and rec[k] > 0
            for k in ("rate_per_s", "batch_s", "p99_ms")):
        fail(f"engine control saturation: {rec['served']} of "
             f"{ENGINE_SATURATION} served, {rec}")
    del engines
    torch.cuda.empty_cache()
    return rec


def scaled_out_in_burst(scenario, log) -> bool:
    """Whether the autoscaler decided a size above 2 on a tick inside
    the flash crowd's burst and a smaller one after it (``control_log``
    holds each action at the time it applies, its decision + lag)."""
    from repro_torch.core.scenario import FlashCrowd
    burst = next(e for e in scenario.events if isinstance(e, FlashCrowd))
    lag = scenario.control.lag
    sizes = [(t - lag, p["n"]) for t, k, p in log if k == "set_scale"]
    return any(n > 2 and burst.at <= t <= burst.at + burst.duration
               and any(n2 < n for _, n2 in sizes[i + 1:])
               for i, (t, n) in enumerate(sizes))


def engine_run_fault(name: str, scenario, rt) -> str | None:
    """The first check of step 6b that the finished run ``rt`` of
    ``scenario`` fails, or None: every attempt handed to a replica was
    served, retried, timed out or lost, with finite latencies, and
    nothing is left in flight; the flash crowd scaled out inside its
    burst and back in, the retry storm retried."""
    s = rt.telemetry.overall()
    fails = rt.recorder.failures
    if s.n < 1 or not all(math.isfinite(x) for x in rt.recorder.all):
        return f"{s.n} served, latencies not all finite"
    if rt.submitted != s.n + rt.retries + rt.timeouts + fails["failed"]:
        return (f"{rt.submitted} attempts but {s.n} served + {rt.retries} "
                f"retried + {rt.timeouts} timed out + {fails['failed']} "
                f"failed")
    if (fails["shed"], fails["timeout"]) != (rt.shed, rt.timeouts):
        return (f"failures {fails} against shed {rt.shed}, timeouts "
                f"{rt.timeouts}")
    if rt._meta or rt._retry_q or rt._pending_actions:
        return (f"{len(rt._meta)} attempts, {len(rt._retry_q)} retries and "
                f"{len(rt._pending_actions)} actions left in flight")
    if name == "flash-crowd-autoscale":
        if not scaled_out_in_burst(scenario, rt.control_log):
            return (f"the autoscaler must scale above 2 replicas on a tick "
                    f"inside the burst and back down, control_log "
                    f"{rt.control_log}")
    elif rt.retries < 1:
        return f"no request was retried (timeouts {rt.timeouts})"
    return None


def run_engine_control(card: str, kernels) -> tuple:
    """The closed loop and the retry path on real replicas: the fleet's
    saturation run, then each of ``engine_runs`` scaled to it through
    ``run_experiment_on_real_engines``, as ``launch.serve --scenario``
    runs it.  -> (record, launches of ``kernels`` over the scenarios)."""
    from repro_torch.scenarios import get
    from repro_torch.scenarios.backends import run_experiment_on_real_engines
    cap = engine_capacity(card)
    record = {"saturation": cap}
    launches = {k.__name__: 0 for k in kernels}
    for name, kw in engine_runs(cap["rate_per_s"], cap["batch_s"]):
        scenario = get(name, seed=0, **kw)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        rt = run_experiment_on_real_engines(
            scenario.compile(), arch=ENGINE_ARCH, seed=0, device="cuda",
            **ENGINE_SHAPE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {k.__name__: k.launches for k in kernels}
        s = rt.telemetry.overall()
        rec = {"kw": kw, "served": s.n, "submitted": rt.submitted,
               "dropped": rt.dropped, "shed": rt.shed,
               "timeouts": rt.timeouts, "retries": rt.retries,
               "failures": dict(rt.recorder.failures),
               "p50_ms": s.p50 * 1e3, "p99_ms": s.p99 * 1e3,
               "control_log": rt.control_log, "launches": n, "wall_s": wall}
        record[name] = rec
        print(f"engine control {name}: {card}: served {s.n}, shed "
              f"{rt.shed}, timeouts {rt.timeouts}, retries {rt.retries}, "
              f"p50 {s.p50 * 1e3:.1f} ms, p99 {s.p99 * 1e3:.1f} ms, "
              f"control_log {rt.control_log}, launches {n}, "
              f"{wall:.1f} s", flush=True)
        fault = engine_run_fault(name, scenario, rt)
        if fault:
            fail(f"engine control {name}: {fault}")
        for kname, count in n.items():
            if count < 1:
                fail(f"engine control {name}: kernel {kname} was not "
                     f"launched")
            launches[kname] += count
    return record, launches


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
    from repro_torch.sweep import spawn_seed
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


def sweep_rows_equal(name, frame, cells) -> None:
    """Every row of a vector sweep equals, metric by metric and bit for
    bit, the ``run_cells`` result of its cell."""
    if len(frame.rows) != len(cells):
        fail(f"sweep {name}: {len(frame.rows)} rows for {len(cells)} cells")
    for k, (row, res) in enumerate(zip(frame.rows, cells)):
        want = {m: getattr(res, m) for m in SWEEP_METRICS}
        got = {m: row.metrics[m] for m in SWEEP_METRICS if m in row.metrics}
        if any(got[m] != want[m] or type(got[m]) not in (int, float)
               for m in got):
            fail(f"sweep {name} row {k}: {got} != run_cells {want}")


def run_sweep_phase(results, vector_kernels) -> tuple:
    """The sweep layer on the card (step 4c); -> (record, the launches
    of its main-path sweeps, the uncached fig1 frame)."""
    from benchmarks.torch_port.bench_vector import build_grid, grid_programs
    from repro_torch.sweep import Axis, Sweep, run_sweep, scenario_factory
    from repro_torch.sweep.executor import mp_context
    from repro_torch.vector import VectorConfig, run_cells
    rec, total = {}, {k.__name__: 0 for k in vector_kernels}

    def timed_sweep(label, sweep, **kw):
        for k in vector_kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = run_sweep(sweep, progress=None, **kw).raise_errors()
        wall = time.perf_counter() - t0
        n = {k.__name__: k.launches for k in vector_kernels}
        if n["scalar_scan"] != 1 or n["fused_quantiles"] != 1 \
                or n["batched_scan"]:
            fail(f"sweep {label}: one scalar_scan and one fused_quantiles "
                 f"launch expected, got {n}")
        for name in total:
            total[name] += n[name]
        cells = sum(1 for r in frame.rows
                    if r.params.get("runtime", sweep.runtime) == "vector")
        print(f"e2e sweep {label}: {len(frame.rows)} rows ({cells} vector "
              f"cells) in {wall:.4f} s ({cells / wall:.1f} cells/s); "
              f"launches {n}", flush=True)
        return frame, {"rows": len(frame.rows), "vector_cells": cells,
                       "wall_s": wall, "cells_per_s": cells / wall,
                       "launches": n}

    # the fig1 grid of the bench twin, against run_cells on its programs
    sweep = build_grid(smoke=False, runtime="vector")
    frame, rec["fig1"] = timed_sweep("fig1", sweep)
    fig1 = frame
    # the layer in front of run_cells: the factory and compile_experiment
    t0 = time.perf_counter()
    progs, seeds = grid_programs(sweep)
    compile_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cells = run_cells(progs, seeds, VectorConfig(device="cuda"))
    cells_s = time.perf_counter() - t0
    sweep_rows_equal("fig1", frame, cells)
    rec["fig1"].update(compile_s=compile_s, run_cells_s=cells_s)
    print(f"sweep fig1: rows equal run_cells's bit for bit; factory + "
          f"compile_experiment {compile_s:.4f} s, run_cells {cells_s:.4f} s "
          f"({compile_s / len(progs) * 1e3:.3f} ms a cell)", flush=True)

    # the flash crowd's chaos grid, against the chaos phase's rows
    name, points = CHAOS_GRIDS[0]
    sweep = Sweep(name=name, factory=scenario_factory(name), mode="points",
                  points=tuple(points), reps=13, base_seed=1,
                  seeder="spawn", runtime="vector", metrics=SWEEP_METRICS)
    frame, rec[name] = timed_sweep(name, sweep)
    sweep_rows_equal(name, frame, results[name])
    print(f"sweep {name}: rows equal the chaos phase's bit for bit",
          flush=True)

    # a mixed sim|vector frame under the process executor, with the card
    # initialised: the workers must not fork this process
    sweep = Sweep(name="steady-mixed", factory=scenario_factory("steady"),
                  axes=(Axis("runtime", ("sim", "vector")),
                        Axis("qps", MIXED_QPS)),
                  fixed={"duration": 6.0}, reps=3, runtime="vector",
                  metrics=SWEEP_METRICS + ("shed",))
    if not torch.cuda.is_initialized():
        fail("sweep phase: CUDA is not initialised before the pool starts")
    method = mp_context().get_start_method()
    if method == "fork":
        fail("sweep phase: the process executor would fork a CUDA process")
    frame, rec["mixed"] = timed_sweep("steady-mixed (process)", sweep,
                                      executor="process", workers=2)
    serial = run_sweep(sweep, progress=None).raise_errors()
    cpu = run_sweep(sweep, progress=None,
                    vector_config=VectorConfig(device="cpu")).raise_errors()
    if [r.to_dict() for r in frame.rows] != \
            [r.to_dict() for r in serial.rows]:
        fail("sweep steady-mixed: the process frame differs from the "
             "serial one")
    for row, ref in zip(frame.rows, cpu.rows):
        why = ""
        if row.params["runtime"] == "sim" and row.to_dict() != ref.to_dict():
            why = "sim rows differ"
        for m, v in ref.metrics.items():
            g = row.metrics[m]
            if m == "n":
                bad = abs(g - v) > 1
            elif m in ("dropped", "shed"):
                bad = g != v
            else:
                bad = not math.isclose(g, v, rel_tol=ROW_RTOL)
            if bad:
                why = why or f"{m} {g!r} vs {v!r}"
        if why:
            fail(f"sweep steady-mixed {row.params} rep {row.rep}: card vs "
                 f"CPU: {why}")
    rec["mixed"].update(start_method=method)
    print(f"sweep steady-mixed: process frame ({method} workers) equals "
          f"the serial one; vector rows equal the CPU's", flush=True)
    return rec, total, fig1


#: the soft phase's grid: ``steady`` (8 s, seed 3, the reference
#: agreement test's operating point) x 13 reps, card against CPU
SOFT_REPS = 13
SOFT_RTOL = 1e-5
#: the plan phase's card-vs-CPU bounds: continuous capacity (servers),
#: verified values (relative), and the cell budget (the dense grid's
#: cells over the bench's required 10x)
PLAN_CAPACITY_TOL = 1e-2
PLAN_VALUE_RTOL = 1e-6


def run_plan_phase(vector_kernels) -> tuple:
    """bench_plan's FULL problem through ``run_plan`` on the card and on
    the CPU (step 4d); -> (record, the card run's launches)."""
    from benchmarks.torch_port.bench_plan import FULL, SEED, _overrides
    from repro_torch.plan import PlanSpec, run_plan
    from repro_torch.vector import VectorConfig
    spec = PlanSpec(scenario="steady", objective="p99", slo=FULL["slo"],
                    overrides=_overrides(FULL), steps=FULL["steps"],
                    starts=FULL["starts"], samples=FULL["samples"],
                    probe_reps=FULL["probe_reps"], reps=FULL["reps"],
                    seed=SEED)
    rec, runs = {}, {}
    for dev in ("cuda", "cpu"):
        for k in vector_kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[dev] = run_plan(spec, vector_config=VectorConfig(device=dev))
        wall = time.perf_counter() - t0
        r = runs[dev]
        rec[dev] = {"wall_s": wall, "capacity": r.params["capacity"],
                    "n_star": r.n_star, "cell_evals": r.cell_evals,
                    "probes": [(p["n"], p["meets"]) for p in r.probes],
                    "verified_mean": r.verified["mean"],
                    "launches": {k.__name__: k.launches
                                 for k in vector_kernels}}
        print(f"plan: {dev} wall {wall:.3f} s, capacity "
              f"{r.params['capacity']:.6f}, n_star {r.n_star}, probes "
              f"{rec[dev]['probes']}, {r.cell_evals} exact cells, p99 "
              f"{r.verified['mean']:.6g}, launches "
              f"{rec[dev]['launches']}", flush=True)
    gpu, cpu = runs["cuda"], runs["cpu"]
    grid_cells = FULL["n_grid"] * FULL["reps"]
    if gpu.n_star != cpu.n_star or \
            rec["cuda"]["probes"] != rec["cpu"]["probes"]:
        fail(f"plan: card n_star {gpu.n_star} probes "
             f"{rec['cuda']['probes']} vs CPU {cpu.n_star} "
             f"{rec['cpu']['probes']}")
    if not np.allclose(gpu.verified["values"], cpu.verified["values"],
                       rtol=PLAN_VALUE_RTOL, atol=0.0):
        fail(f"plan: verified values {gpu.verified['values']} vs CPU "
             f"{cpu.verified['values']}")
    gap = abs(gpu.params["capacity"] - cpu.params["capacity"])
    if gap > PLAN_CAPACITY_TOL:
        fail(f"plan: continuous capacity card vs CPU differs by {gap}")
    if gpu.cell_evals * 10 > grid_cells:
        fail(f"plan: {gpu.cell_evals} exact cells, more than "
             f"{grid_cells}/10")
    n = rec["cuda"]["launches"]
    want = len(gpu.probes) + 1          # one grid a probe + the final one
    if n["scalar_scan"] != want or n["fused_quantiles"] != want \
            or n["batched_scan"]:
        fail(f"plan: {want} scalar_scan and fused_quantiles launches "
             f"expected (one a ladder grid), got {n}")
    rec["capacity_gap"] = gap
    rec["cell_speedup"] = grid_cells / gpu.cell_evals
    print(f"plan: card equals CPU (n_star, probes, verified values; "
          f"capacity gap {gap:.3g}); {gpu.cell_evals} cells vs "
          f"{grid_cells} of the dense grid ({rec['cell_speedup']:.2f}x)",
          flush=True)
    return rec, n


#: the cache phase's partial re-run: this fig1 QPS point changes, the
#: other 8 stay (step 4f)
CACHE_EDIT_QPS = (4600, 4700)


def run_cache_phase(vector_kernels, cache_root: Path, fig1) -> tuple:
    """The result cache on the card (step 4f), in ``cache_root``: fig1
    cold, warm from disk and with one point edited, three fig1 cells on
    the CPU, and bench_plan's smoke problem planned cold then warm;
    -> (record, the launches of its cold runs)."""
    from benchmarks.torch_port.bench_vector import build_grid, grid_programs
    from repro_torch.cache import ResultCache, scan
    from repro_torch.plan import PlanSpec, run_plan
    from repro_torch.sweep import Axis, run_sweep
    from repro_torch.vector import VectorConfig, run_cells
    rec, total = {}, {k.__name__: 0 for k in vector_kernels}
    sweep_dir = str(cache_root / "sweep")

    def timed(fn):
        for k in vector_kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, \
            {k.__name__: k.launches for k in vector_kernels}

    def rows(frame) -> list:
        return [json.dumps(r.to_dict()) for r in frame.rows]

    def sweep_run(label, sweep):
        cache = ResultCache(cache_dir=sweep_dir)
        frame, wall, n = timed(lambda: run_sweep(
            sweep, progress=None, cache=cache).raise_errors())
        st = cache.stats.as_dict()
        rec[label] = {"wall_s": wall, "launches": n, "stats": st}
        print(f"cache: fig1 {label} {wall:.4f} s, {cache.stats}, "
              f"launches {n}", flush=True)
        return frame, st, n

    sweep = build_grid(smoke=False, runtime="vector")
    tasks = len(sweep.tasks())
    cold, st, n = sweep_run("cold", sweep)
    stored = scan(sweep_dir)["salts"][ResultCache(cache_dir=None).salt]
    rec["cold"]["stored"] = stored
    if n != {"scalar_scan": 1, "batched_scan": 0, "fused_quantiles": 1}:
        fail(f"cache: cold fig1 launched {n}, one scalar_scan and one "
             f"fused_quantiles expected")
    if (stored["cells"], stored["rows"]) != (tasks, tasks) or st["hits"]:
        fail(f"cache: cold fig1 stored {stored} with {st}, {tasks} cells "
             f"and {tasks} rows expected")
    if rows(cold) != rows(fig1):
        fail("cache: cold fig1 rows differ from step 4c's uncached frame")
    for name in total:
        total[name] += n[name]

    warm, st, n = sweep_run("warm", sweep)
    if (st["hits"], st["misses"]) != (tasks, 0) or any(n.values()):
        fail(f"cache: warm fig1 {st}, launches {n}: {tasks} hits, 0 misses "
             f"and no launch expected")
    if rows(warm) != rows(cold):
        fail("cache: warm fig1 rows differ from the cold run's")
    rec["warm_speedup"] = rec["cold"]["wall_s"] / rec["warm"]["wall_s"]

    old, new = CACHE_EDIT_QPS
    qps = sweep.axes[0].values
    edited = dataclasses.replace(sweep, axes=(Axis("qps", tuple(
        new if q == old else q for q in qps)),))
    point = qps.index(old)
    reps = sweep.reps
    part, st, n = sweep_run("partial", edited)
    if n != {"scalar_scan": 1, "batched_scan": 0, "fused_quantiles": 1} \
            or (st["hits"], st["misses"]) != (tasks - reps, 2 * reps):
        fail(f"cache: partial fig1 {st}, launches {n}: the edited point's "
             f"{reps} cells in one launch expected")
    kept = [k for k, r in enumerate(part.rows) if r.index != point]
    got, want = rows(part), rows(cold)
    if len(kept) != tasks - reps or \
            [got[k] for k in kept] != [want[k] for k in kept]:
        fail("cache: partial fig1: the unedited rows differ from the cold "
             "run's")
    for k, r in enumerate(part.rows):
        if r.index == point and (r.params["qps"] != new or not all(
                math.isfinite(v) for v in r.metrics.values())):
            fail(f"cache: partial fig1 row {k}: {r.params} {r.metrics}")
    for name in total:
        total[name] += n[name]

    progs, seeds = grid_programs(sweep)
    pick = [0, len(progs) // 2, len(progs) - 1]
    cache = ResultCache(cache_dir=sweep_dir)
    run_cells([progs[i] for i in pick], [seeds[i] for i in pick],
              VectorConfig(device="cpu"), cache=cache)
    rec["cpu_cells"] = cache.stats.as_dict()
    if (cache.stats.hits, cache.stats.misses) != (0, 3):
        fail(f"cache: three fig1 cells on the CPU: {cache.stats}, 3 misses "
             f"expected (the card's entries must not answer them)")
    print(f"cache: three fig1 cells on the CPU: {cache.stats}", flush=True)

    # the planner, cold then warm, on bench_plan's smoke problem (its
    # FULL problem runs uncached in step 4d)
    from benchmarks.torch_port.bench_plan import SEED, SMOKE, _overrides
    spec = PlanSpec(scenario="steady", objective="p99", slo=SMOKE["slo"],
                    overrides=_overrides(SMOKE), steps=SMOKE["steps"],
                    starts=SMOKE["starts"], samples=SMOKE["samples"],
                    probe_reps=SMOKE["probe_reps"], reps=SMOKE["reps"],
                    seed=SEED)
    plans = {}
    for label in ("cold", "warm"):
        cache = ResultCache(cache_dir=str(cache_root / "plan"))
        res, wall, n = timed(lambda: run_plan(
            spec, vector_config=VectorConfig(device="cuda"), cache=cache))
        plans[label] = res
        rec[f"plan_{label}"] = {"wall_s": wall, "launches": n,
                                "stats": cache.stats.as_dict(),
                                "cell_evals": res.cell_evals,
                                "n_star": res.n_star}
        print(f"cache: {label} plan {wall:.3f} s, n_star {res.n_star}, "
              f"probes {[(p['n'], p['meets']) for p in res.probes]}, "
              f"{res.cell_evals} exact cells, {cache.stats}, launches {n}",
              flush=True)
    cold_plan, warm_plan = plans["cold"], plans["warm"]
    n = rec["plan_cold"]["launches"]
    if cold_plan.cell_evals == 0 or n["scalar_scan"] == 0 or \
            n["fused_quantiles"] == 0:
        fail(f"cache: cold plan spent {cold_plan.cell_evals} cells and "
             f"launched {n}; the ladder's grids on the card expected")
    for name in total:
        total[name] += n[name]
    n = rec["plan_warm"]["launches"]
    if warm_plan.cell_evals != 0 or rec["plan_warm"]["stats"]["misses"] \
            or any(n.values()):
        fail(f"cache: warm plan spent {warm_plan.cell_evals} cells "
             f"({rec['plan_warm']['stats']}) and launched {n}; none "
             f"expected")
    if warm_plan.n_star != cold_plan.n_star or \
            json.dumps(warm_plan.probes) != json.dumps(cold_plan.probes) or \
            warm_plan.verified["values"] != cold_plan.verified["values"]:
        fail(f"cache: warm plan n_star {warm_plan.n_star} probes "
             f"{warm_plan.probes} differ from the cold run's "
             f"{cold_plan.n_star} {cold_plan.probes}")
    print(f"cache: fig1 cold {rec['cold']['wall_s']:.4f} s (stored "
          f"{stored['cells']} cells, {stored['bytes']} bytes), warm "
          f"{rec['warm']['wall_s']:.4f} s ({rec['warm_speedup']:.1f}x), "
          f"partial {rec['partial']['wall_s']:.4f} s; warm plan equals "
          f"the cold one", flush=True)
    return rec, total


def run_soft_phase(vector_kernels) -> dict:
    """A soft ``steady`` grid on the card against the CPU (step 4e): the
    plain step with the smoothed water-fill and the soft quantile head,
    no kernel launch."""
    from repro_torch.scenarios import get
    from repro_torch.sweep.spec import spawn_seed
    from repro_torch.vector import VectorConfig, compile_experiment, run_cells
    prog = compile_experiment(get("steady", duration=8.0, seed=3).compile())
    progs = [prog] * SOFT_REPS
    seeds = [(spawn_seed(3, 0, rep), rep) for rep in range(SOFT_REPS)]
    rec, rows = {}, {}
    for dev in ("cuda", "cpu"):
        for k in vector_kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows[dev] = run_cells(progs, seeds,
                              VectorConfig(device=dev, soft=True))
        rec[dev] = {"wall_s": time.perf_counter() - t0,
                    "launches": {k.__name__: k.launches
                                 for k in vector_kernels}}
    if any(rec["cuda"]["launches"].values()):
        fail(f"soft: a kernel was launched on soft consts: "
             f"{rec['cuda']['launches']}")
    worst = 0.0
    for i, (g, c) in enumerate(zip(rows["cuda"], rows["cpu"])):
        if g.n != c.n or g.dropped != c.dropped:
            fail(f"soft cell {i}: n/dropped {g.n}/{g.dropped} vs CPU "
                 f"{c.n}/{c.dropped}")
        for m in ("mean", "p50", "p95", "p99"):
            a, b = getattr(g, m), getattr(c, m)
            if not (math.isfinite(a) and math.isclose(a, b,
                                                      rel_tol=SOFT_RTOL)):
                fail(f"soft cell {i} {m}: card {a!r} vs CPU {b!r}")
            worst = max(worst, abs(a - b) / abs(b))
    rec["cells"] = SOFT_REPS
    rec["max_rel_diff"] = worst
    print(f"soft: steady 8 s x {SOFT_REPS} cells, card "
          f"{rec['cuda']['wall_s']:.3f} s, CPU {rec['cpu']['wall_s']:.3f} "
          f"s; rows equal within rtol "
          f"{SOFT_RTOL} (max {worst:.3g}); p99 {rows['cuda'][0].p99:.6g}",
          flush=True)
    return rec


# ---------------------------------------------------------------------------
# Step 6g: training
# ---------------------------------------------------------------------------
#: the train-step agreement: each arch at full width and 2 layers, f32,
#: a batch of TRAIN_BATCH rows of ``seq`` tokens (mamba2: two scan
#: chunks), one loss and gradient on the card (kernels) and on the CPU
#: (plain versions) from the same weights, drawn at ``layer_std_specs``'
#: scales, and batch.  At the reference's draw (each stacked matrix at
#: std 1/sqrt(2)) the backward is ill-conditioned: phi3's worst leaf
#: (norm1's scale) reads 6.389e-2 of its max|g| with the kernels,
#: 6.318e-2 with the plain versions on the card and 8.339e-2 for the CPU
#: against itself with every f32 weight one ulp off, the gradient norm
#: 1.730e-3, 1.633e-3 and 9.342e-3; mamba2's worst leaf 4.487e-3,
#: 6.475e-3 and 4.038e-3 (scripts/full_width_sensitivity.py --train ARCH
#: --reference-draw; H100 80GB HBM3, 700.00 W): the model's, not a
#: kernel's, and no bound near TRAIN_GRAD_TOL could be held
TRAIN_AGREEMENT = [("phi3-mini-3.8b", 128), ("mamba2-1.3b", 512)]
TRAIN_BATCH = 8
#: card vs CPU: the loss (relative), the gradients' global norm
#: (relative), every gradient leaf (relative to the leaf's max|g|)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
#: full-depth bf16 training through ``launch.train.main`` at its
#: defaults (batch 8, seq 128; mamba2 at 512 tokens), TRAIN_STEPS steps
TRAIN_RUNS = [("phi3-mini-3.8b", 128), ("mamba2-1.3b", 512)]
TRAIN_STEPS = 10
#: the resume check's run of ``launch.train`` (the model train_lm
#: trains), straight against checkpointed-and-resumed
RESUME_ARGS = ["--arch", "stablelm-3b", "--smoke", "--steps", "6",
               "--batch", "8", "--seq", "128", "--lr", "1e-3",
               "--ckpt-every", "3", "--log-every", "3"]


#: ``launch.train``'s log line of a step
STEP_LINE = re.compile(r"step +(\d+) loss=(\S+) acc=\S+ gnorm=(\S+) ")


class StampedLines(io.TextIOBase):
    """A text sink keeping each line written with the host clock's time
    when it arrived."""

    def __init__(self):
        self.lines = []

    def write(self, text: str) -> int:
        now = time.perf_counter()
        self.lines += [(now, ln) for ln in text.splitlines() if ln]
        return len(text)


def train_kernel(cfg) -> str:
    """The kernel on a model's training path (its layers are all of one
    kind here)."""
    return "ssd_scan" if cfg.mamba is not None else "flash_attention"


def train_loss_and_grads(cfg, params, batch) -> tuple:
    """The training loss of ``launch.train`` (``make_loss_fn``: remat on,
    chunked cross-entropy), its gradient at every leaf and their global
    norm -> (loss, norm, {path: grad})."""
    from repro_torch.models import param as P
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_step import make_loss_fn
    paths, flat = zip(*((p, t.requires_grad_(True))
                        for p, t in P.leaves(params)))
    loss, _ = make_loss_fn(cfg)(params, batch)
    grads = dict(zip(paths, torch.autograd.grad(loss, flat)))
    for t in flat:
        t.requires_grad_(False)
    return (float(loss.detach()), float(global_norm(P.unflatten(
        grads.items()))), grads)


def check_train_agreement(device, arch: str, seq: int, kernels) -> tuple:
    """One training loss and gradient of ``arch`` at full width, 2
    layers, f32 (step 5's seed, at ``layer_std_specs``' scales), on the
    CPU and on the card; -> (record, launches of ``kernels`` on the
    card)."""
    from repro_torch.models import param as P
    from repro_torch.training.data import DataConfig, SyntheticLM
    t_phase = time.perf_counter()
    cfg, params, *_ = full_width_model(arch, 2, layer_std=True)
    p32 = f32_tree(params)
    del params
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_BATCH, seq))
    batch = {k: torch.from_numpy(v) for k, v in data.next_batch().items()}
    t0 = time.perf_counter()
    cpu_loss, cpu_norm, cpu_g = train_loss_and_grads(cfg, p32, batch)
    cpu_s = time.perf_counter() - t0
    on_card = P.tree_map(lambda t: t.to(device), p32)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, norm, grads = train_loss_and_grads(
        cfg, on_card, {k: v.to(device) for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    kernel = train_kernel(cfg)
    want = {k: 0 for k in launches}
    want[kernel] = 2 * cfg.num_layers            # forward + remat recompute
    if launches != want:
        fail(f"train agreement {arch}: launches {launches}, expected "
             f"{want} (the forward and the remat recompute of each layer)")
    leaf = {}
    for path, g in cpu_g.items():
        scale = g.abs().max().item()
        leaf["/".join(path)] = ((grads[path].cpu() - g).abs().max().item()
                                / (scale if scale else 1.0))
    worst = max(leaf, key=leaf.get)
    rec = {"arch": arch, "layers": cfg.num_layers, "batch": TRAIN_BATCH,
           "seq": seq, "params": sum(t.numel() for _, t in P.leaves(p32)),
           "loss_cpu": cpu_loss, "loss_card": loss,
           "loss_rel": abs(loss - cpu_loss) / abs(cpu_loss),
           "grad_norm_cpu": cpu_norm, "grad_norm_card": norm,
           "grad_norm_rel": abs(norm - cpu_norm) / cpu_norm,
           "grad_rel_max": leaf[worst], "grad_rel_worst_leaf": worst,
           "grad_rel": leaf, "cpu_s": cpu_s, "card_s": card_s,
           "launches": launches,
           "tol": {"loss": TRAIN_LOSS_RTOL, "grad_norm": TRAIN_GNORM_RTOL,
                   "grad": TRAIN_GRAD_TOL}}
    print(f"train agreement {arch} ({cfg.num_layers} layers, f32, batch "
          f"{TRAIN_BATCH}x{seq}): loss card {loss:.7f} CPU {cpu_loss:.7f} "
          f"(rel {rec['loss_rel']:.3e}), grad norm rel "
          f"{rec['grad_norm_rel']:.3e}, worst leaf {worst} "
          f"{leaf[worst]:.3e}; card {card_s:.2f} s, CPU {cpu_s:.2f} s, "
          f"launches {launches}, {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    for key, got, tol in (("loss", rec["loss_rel"], TRAIN_LOSS_RTOL),
                          ("grad norm", rec["grad_norm_rel"],
                           TRAIN_GNORM_RTOL),
                          (f"gradient {worst}", leaf[worst], TRAIN_GRAD_TOL)):
        if not got <= tol:
            fail(f"train agreement {arch}: {key} card vs CPU {got:.3e} "
                 f"exceeds {tol}")
    del on_card, grads
    torch.cuda.empty_cache()
    return rec, launches


def run_training(arch: str, seq: int, kernels) -> tuple:
    """``launch.train.main`` on ``arch`` at full width and full depth in
    bf16, TRAIN_STEPS steps at its default batch: a finite loss every
    step and the last below the first, the path's kernel launched twice
    a layer and step; -> (record, launches of ``kernels``)."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log = StampedLines()
    argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--seq", str(seq),
            "--log-every", "1"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        train.main(argv)
    wall = time.perf_counter() - t0
    # each step's line is printed after its loss is read back (a sync)
    steps, last = [], t0
    for at, line in log.lines:
        m = STEP_LINE.match(line)
        if m:
            steps.append({"step": int(m[1]), "loss": float(m[2]),
                          "grad_norm": float(m[3]), "s": at - last})
            last = at
    launches = {k.__name__: k.launches for k in kernels}
    step_s = statistics.median(s["s"] for s in steps[1:])
    batch = 8                                    # launch.train's default
    rec = {"arch": arch, "layers": cfg.num_layers, "batch": batch,
           "seq": seq, "steps": steps, "step_ms": step_s * 1e3,
           "first_step_ms": steps[0]["s"] * 1e3,
           "tokens_per_s": batch * seq / step_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "wall_s": wall, "launches": launches}
    losses = [s["loss"] for s in steps]
    print(f"training {arch}: {cfg.num_layers} layers bf16, batch "
          f"{batch}x{seq}, losses {[round(x, 4) for x in losses]}, step "
          f"{rec['step_ms']:.1f} ms (median of steps 2-{TRAIN_STEPS}; the "
          f"first {rec['first_step_ms']:.1f} ms with init), "
          f"{rec['tokens_per_s']:.0f} tokens/s, peak {rec['peak_gb']:.2f} "
          f"GB, launches {launches}, {wall:.1f} s", flush=True)
    if len(steps) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"training {arch}: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training {arch}: the loss did not fall ({losses})")
    want = {k: 0 for k in launches}
    want[train_kernel(cfg)] = 2 * cfg.num_layers * TRAIN_STEPS
    if launches != want:
        fail(f"training {arch}: launches {launches}, expected {want} (the "
             f"forward and the remat recompute of each layer and step)")
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def train_resume_check(root: str) -> None:
    """Run in a subprocess with deterministic algorithms (the caller sets
    them): ``examples/torch_port/train_lm.py`` to its assert, then
    ``launch.train`` straight against checkpointed at step 3 and
    resumed, whose step-6 checkpoints must hold equal bits; prints one
    JSON line."""
    import importlib.util

    from repro_torch.launch import train
    spec = importlib.util.spec_from_file_location(
        "train_lm", ROOT / "examples" / "torch_port" / "train_lm.py")
    train_lm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_lm)
    t0 = time.perf_counter()
    loss = train_lm.main(["--ckpt-dir", str(Path(root) / "train_lm")])
    train_lm_s = time.perf_counter() - t0
    straight, resumed = Path(root) / "straight", Path(root) / "resumed"
    t0 = time.perf_counter()
    train.main(RESUME_ARGS + ["--ckpt-dir", str(straight)])
    resumed.mkdir()
    shutil.copytree(straight / "step_00000003", resumed / "step_00000003")
    train.main(RESUME_ARGS + ["--ckpt-dir", str(resumed), "--resume"])
    resume_s = time.perf_counter() - t0
    with np.load(straight / "step_00000006" / "arrays.npz") as a, \
            np.load(resumed / "step_00000006" / "arrays.npz") as b:
        differ = sorted(k for k in a.files
                        if not np.array_equal(a[k], b[k]))
        n = len(a.files)
    print(json.dumps({"train_lm_loss": loss, "train_lm_s": train_lm_s,
                      "resume_arrays": n, "resume_differ": differ,
                      "resume_s": resume_s}))


def run_train_resume(root: Path) -> dict:
    """``train_resume_check`` in a subprocess with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and
    ``torch.use_deterministic_algorithms(True)``: without them the
    embedding's index backward accumulates with atomics, in another
    order each run."""
    import os
    code = ("import sys, torch\n"
            "torch.use_deterministic_algorithms(True)\n"
            "import chip_smoke\n"
            "chip_smoke.train_resume_check(sys.argv[1])\n")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code, str(root)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        fail(f"train resume check: exit {out.returncode}\n"
             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    rec["wall_s"] = time.perf_counter() - t0
    print(f"train_lm (stablelm-3b-smoke, 200 steps with a resume at 60): "
          f"final loss {rec['train_lm_loss']:.4f} in "
          f"{rec['train_lm_s']:.1f} s; launch.train straight vs resumed at "
          f"step 3: {rec['resume_arrays'] - len(rec['resume_differ'])} of "
          f"{rec['resume_arrays']} arrays bit-equal at step 6; "
          f"{rec['wall_s']:.1f} s", flush=True)
    if rec["resume_differ"]:
        fail(f"train resume: arrays differ at step 6: "
             f"{rec['resume_differ'][:8]}")
    return rec


def run_card_twins(kernels) -> tuple:
    """``benchmarks/torch_port/engine_serving.py`` and
    ``examples/torch_port/serve_e2e.py`` on the card: every request
    served, both attention kernels launched; -> (record, launches)."""
    import importlib.util

    from benchmarks.torch_port import engine_serving
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    rows = engine_serving.run("cuda")
    rec = {"engine_serving": rows,
           "engine_serving_s": time.perf_counter() - t0}
    spec = importlib.util.spec_from_file_location(
        "serve_e2e", ROOT / "examples" / "torch_port" / "serve_e2e.py")
    serve_e2e = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_e2e)
    t0 = time.perf_counter()
    rt = serve_e2e.main(["--device", "cuda"])
    s = rt.telemetry.overall()
    rec["serve_e2e"] = {"n": s.n, "submitted": rt.submitted,
                        "p50_ms": s.p50 * 1e3, "p99_ms": s.p99 * 1e3,
                        "wall_s": time.perf_counter() - t0}
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"card twins: engine_serving {rows}; serve_e2e {rec['serve_e2e']};"
          f" launches {launches}", flush=True)
    for r in rows + [rec["serve_e2e"]]:
        if r["n"] < 1 or r["n"] != r["submitted"]:
            fail(f"card twins: {r['n']} of {r['submitted']} requests served")
    for name in ("flash_attention", "decode_attention"):
        if launches[name] < 1:
            fail(f"card twins: kernel {name} was not launched")
    return rec, launches


# ---------------------------------------------------------------------------
# Step 7: the launch tooling on the card
# ---------------------------------------------------------------------------
TOOLING_ARCH = "phi3-mini-3.8b"
TOOLING_CELLS = ("train_4k", "prefill_32k", "decode_32k")


def _allocator_slack(nbytes: int) -> int:
    """Most bytes the CUDA caching allocator can count above a request of
    ``nbytes`` in ``memory_allocated()``: requests round up to 512 B;
    a block of the large pool (over 1 MiB) is split only when more than
    1 MiB of it would be left, so up to 1 MiB more can stay with it."""
    return 511 + (1 << 20 if nbytes > 1 << 20 else 0)


def _leaf_meta(trees) -> dict:
    """(argument index, key path) -> (shape, dtype) of every leaf."""
    from repro_torch.models.param import leaves
    return {(i, path): (tuple(t.shape), t.dtype)
            for i, tree in enumerate(trees) for path, t in leaves(tree)}


def run_tooling(record: dict, card: str) -> dict:
    """Step 7: the dry-run of phi3's shape cells, the argument-bytes
    check against the card, and the measured roofline shares of 6g's
    train step and step 6's decode step."""
    import gc

    from repro_torch.configs.base import ShapeCell, get_config
    from repro_torch.launch import dryrun, mesh, roofline
    from repro_torch.models.param import leaves
    from repro_torch.models.registry import count_params, init_params
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    t_phase = time.perf_counter()
    out = {"cells": {}}
    for shape in TOOLING_CELLS:
        t0 = time.perf_counter()
        r = dryrun.run_cell(TOOLING_ARCH, shape, save=False)
        a = roofline.analyze(r)
        mem = r["memory"]
        rec = {"flops": r["flops"], "bytes_accessed": r["bytes_accessed"],
               "args_gib": mem["argument_size_in_bytes"] / 2**30,
               "temp_gib": mem["temp_size_in_bytes"] / 2**30,
               "fits_80gb": (mem["argument_size_in_bytes"]
                             + mem["temp_size_in_bytes"]) < 80e9,
               "dominant": a.dominant,
               "roofline_fraction": a.roofline_fraction,
               "s": time.perf_counter() - t0}
        out["cells"][shape] = rec
        print(f"dryrun {TOOLING_ARCH} {shape} (meta, one card): flops "
              f"{rec['flops']:.4e}, bytes {rec['bytes_accessed']:.4e}, args "
              f"{rec['args_gib']:.2f} GiB, temp {rec['temp_gib']:.2f} GiB, "
              f"fits 80 GB {rec['fits_80gb']}, dominant {rec['dominant']}, "
              f"roofline {rec['roofline_fraction']:.4f}, {rec['s']:.1f} s",
              flush=True)
        for key in ("flops", "bytes_accessed"):
            if not rec[key] > 0:
                fail(f"dryrun {shape}: {key} = {rec[key]}")

    # ---- 6g's training shape: the dry-run's arguments against the state
    # ---- that launch.train builds on the card --------------------------------
    cfg = get_config(TOOLING_ARCH)
    one_card = dryrun.MESHES["card"]
    train_cell = ShapeCell("train_6g", "train", 128, TRAIN_BATCH)
    step, args, specs = dryrun.build_cell(cfg, train_cell, one_card, "sp")
    arg_bytes = dryrun.argument_bytes(args, specs, one_card)
    counts = dryrun.count_step(step, args)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    # as launch.train does: its params, optimizer state and batch
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = init_opt_state(params, OptConfig())
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  batch=TRAIN_BATCH, seq_len=128))
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in data.next_batch().items()}
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - before
    real = _leaf_meta((params, opt, batch))
    want = _leaf_meta(args)
    real_bytes = sum(t.numel() * t.element_size() for trees in
                     (params, opt, batch) for _, t in leaves(trees))
    slack = sum(_allocator_slack(t.numel() * t.element_size())
                for trees in (params, opt, batch) for _, t in leaves(trees))
    del params, opt, batch
    torch.cuda.empty_cache()
    peak_gb = record["training"][TOOLING_ARCH]["peak_gb"]
    out["train_6g"] = {"arg_bytes": arg_bytes, "state_bytes": real_bytes,
                       "leaves": len(real), "allocated_rise": rise,
                       "over": rise - arg_bytes, "slack_limit": slack,
                       "temp_bytes": counts["temp_size_in_bytes"],
                       "flops": counts["flops"], "peak_gb_6g": peak_gb}
    print(f"dryrun {TOOLING_ARCH} 6g train (batch {TRAIN_BATCH}x128): "
          f"{len(want)} argument leaves against launch.train's "
          f"{len(real)}; argument bytes {arg_bytes} against the state's "
          f"{real_bytes} and the card's rise in memory_allocated {rise} "
          f"(over by {rise - arg_bytes}, allocator limit {slack}); temp "
          f"estimate {counts['temp_size_in_bytes'] / 1e9:.2f} GB, args + "
          f"temp {(arg_bytes + counts['temp_size_in_bytes']) / 1e9:.2f} GB "
          f"beside 6g's max_memory_allocated {peak_gb:.2f} GB", flush=True)
    if real != want:
        diff = sorted(set(real.items()) ^ set(want.items()), key=str)[:8]
        fail(f"dryrun: argument leaves differ from launch.train's state "
             f"(path, shape, dtype): {diff}")
    if real_bytes != arg_bytes:
        fail(f"dryrun: argument bytes {arg_bytes} vs the state's "
             f"{real_bytes}")
    if not 0 <= rise - arg_bytes <= slack:
        fail(f"dryrun: argument bytes {arg_bytes} vs the card's rise "
             f"{rise}: {rise - arg_bytes} outside [0, {slack}]")

    # ---- roofline shares of the measured steps ------------------------------
    def ideal(cell, arg_b, flops, n_params) -> float:
        return roofline.Roofline(
            TOOLING_ARCH, cell.name, flops / mesh.PEAK_FLOPS_BF16, 0.0, 0.0,
            roofline.model_flops(cfg, cell, n_params, 1), flops,
            arg_b).ideal_s

    train_ideal = ideal(train_cell, arg_bytes, counts["flops"],
                        count_params(cfg))
    train_s = record["training"][TOOLING_ARCH]["step_ms"] / 1e3
    decode_cell = ShapeCell("serve_decode", "decode", SERVE_MAX_LEN,
                            int(SERVE_ARGS[SERVE_ARGS.index("--max-batch")
                                           + 1]))
    dstep, dargs, dspecs = dryrun.build_cell(cfg, decode_cell, one_card, "tp")
    decode_args = dryrun.argument_bytes(dargs, dspecs, one_card)
    decode_ideal = ideal(decode_cell, decode_args, 0.0,
                         count_params(cfg, active=True))
    decode_s = record["serving"]["decode_step_ms"] / 1e3
    out["shares"] = {
        "train": {"ideal_ms": train_ideal * 1e3, "step_ms": train_s * 1e3,
                  "share": train_ideal / train_s},
        "decode": {"ideal_ms": decode_ideal * 1e3, "arg_bytes": decode_args,
                   "step_ms": decode_s * 1e3,
                   "share": decode_ideal / decode_s}}
    for key, what in (("train", f"6g train step, batch {TRAIN_BATCH}x128, "
                                f"median"),
                      ("decode", f"step 6 decode step, batch "
                                 f"{decode_cell.global_batch}, cache "
                                 f"{SERVE_MAX_LEN}, mean")):
        v = out["shares"][key]
        print(f"roofline share {TOOLING_ARCH} {what}: ideal "
              f"{v['ideal_ms']:.3f} ms over measured {v['step_ms']:.3f} ms "
              f"= {v['share']:.4f} ({card})", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"tooling: {out['wall_s']:.1f} s", flush=True)
    return out


#: the registered scenarios that ``check`` rejects on ``vector``
ANALYSIS_REJECTED = {"churn-storm", "retry-storm"}
#: step 7b's budget: one lint subprocess and two one-cell grids
ANALYSIS_BUDGET_S = 15.0


def run_analysis(card: str, grids, chaos, vector_kernels) -> tuple:
    """Step 7b: the port's static analysis, then the scenarios its check
    rejects on ``vector`` run on the card.  -> (record, launches)."""
    import os

    from repro_torch.analysis.check import (check_scenario, has_errors,
                                            skipped_kinds, unsupported_on)
    from repro_torch.core.legacy import legacy_experiment
    from repro_torch.core.runtime import run_scenario
    from repro_torch.scenarios import get, names
    from repro_torch.vector.compile import (VectorCompileError,
                                            compile_experiment)
    t_phase = time.perf_counter()
    out = {}

    # (a) the lint over the port's tree, strict, as a user runs it
    t0 = time.perf_counter()
    lint = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict", "--json",
         "src/repro_torch"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if lint.returncode != 0:
        fail(f"analysis lint --strict: rc {lint.returncode}\n"
             f"{lint.stdout[-2000:]}{lint.stderr[-2000:]}")
    summary = json.loads(lint.stdout)["summary"]
    if summary["errors"] or summary["warnings"]:
        fail(f"analysis lint --strict: {summary}")
    out["lint"] = dict(summary, s=time.perf_counter() - t0)
    print(f"analysis lint src/repro_torch --strict: {summary['errors']} "
          f"errors, {summary['warnings']} warnings, {summary['suppressed']} "
          f"suppressed ({out['lint']['s']:.2f} s)", flush=True)

    # (b) check on the vector backend: exactly the expected rejections
    features, passed = {}, set()
    for name in names():
        found = check_scenario(get(name), backend="vector")
        if not has_errors(found):
            passed.add(name)
            continue
        if not any(f.rule == "capability" and f.severity == "error"
                   for f in found):
            fail(f"check {name} on vector: errors without a capability "
                 f"error: {[f.format() for f in found]}")
        features[name] = sorted(f for f, _ in unsupported_on(
            get(name).compile(), "vector"))
    if set(features) != ANALYSIS_REJECTED:
        fail(f"check on vector rejects {sorted(features)}, expected "
             f"{sorted(ANALYSIS_REJECTED)}")
    out["check_rejected"] = features
    print(f"analysis check --backend vector: rejects {features}", flush=True)

    # (c) each rejected scenario on the card: the runtime skips exactly
    # what check named, through one scan and one quantile launch
    out["runs"], launches = {}, {k.__name__: 0 for k in vector_kernels}
    for name in sorted(features):
        for k in vector_kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt = run_scenario(get(name), "vector")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {k.__name__: k.launches for k in vector_kernels}
        skipped = sorted({i.kind for i in rt.unsupported})
        want = sorted(skipped_kinds(features[name]))
        if skipped != want:
            fail(f"{name} on the card skips {skipped}; check named "
                 f"{features[name]} (kinds {want})")
        if n["scalar_scan"] != 1 or n["fused_quantiles"] != 1 \
                or n["batched_scan"] != 0:
            fail(f"{name} on the card: launches {n}, expected one "
                 f"scalar_scan and one fused_quantiles")
        r = rt.result
        row = (r.mean, r.p50, r.p95, r.p99)
        if r.n <= 0 or not all(math.isfinite(v) for v in row) or \
                not all(np.isfinite(r.n_ivl)):
            fail(f"{name} on the card: n={r.n} row {row} not finite")
        for key, count in n.items():
            launches[key] += count
        prog = rt.program
        out["runs"][name] = {"skipped": skipped, "launches": n,
                             "slots": prog.n_slots,
                             "servers": int(prog.speed.shape[1]),
                             "cells": 1, "wall_s": wall, "n": r.n,
                             "p99_ms": r.p99 * 1e3}
        print(f"analysis run {name} (vector, card): 1 cell, T "
              f"{prog.n_slots} x S {prog.speed.shape[1]}, {wall:.3f} s, "
              f"skipped {skipped}, launches {n}, n={r.n}, p99 "
              f"{r.p99 * 1e3:.2f} ms ({card})", flush=True)

    # the scenarios check passes that steps 4 and 4b ran on the card:
    # every program of their grids skipped nothing
    ran = {}
    for name, progs, _ in grids + chaos:
        if name in passed:
            bad = [p.unsupported for p in progs if p.unsupported]
            if bad:
                fail(f"{name}: check passed it on vector, yet its card "
                     f"grid skipped {bad[0]}")
            ran[name] = len(progs)
    out["passed_ran_clean"] = ran
    print(f"analysis: check-passed grids run on the card skip nothing: "
          f"{ran}", flush=True)

    # (d) a legacy-mode declaration: rejected by check, refused by the
    # compiler
    legacy = legacy_experiment(2, 50.0, requests_per_client=20,
                               duration=5.0)
    found = check_scenario(legacy, backend="vector")
    if not has_errors(found) or "legacy_mode" not in found[0].message:
        fail(f"check passed a legacy_mode declaration on vector: "
             f"{[f.format() for f in found]}")
    try:
        compile_experiment(legacy)
    except VectorCompileError as e:
        out["legacy"] = str(e)
    else:
        fail("compile_experiment accepted a legacy_mode declaration")
    print(f"analysis legacy_mode: check rejects it on vector, the compiler "
          f"refuses it ({out['legacy']})", flush=True)

    out["wall_s"] = time.perf_counter() - t_phase
    print(f"analysis: {out['wall_s']:.2f} s ({card})", flush=True)
    if out["wall_s"] > ANALYSIS_BUDGET_S:
        fail(f"analysis phase took {out['wall_s']:.1f} s, over its "
             f"{ANALYSIS_BUDGET_S:.0f} s budget")
    return out, launches


def main() -> int:
    t_start = time.perf_counter()
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

    # ---- main path 1c, the sweep layer: vector sweeps as one grid ----------
    record["sweep"], sweep_launches, fig1 = run_sweep_phase(results,
                                                            vector_kernels)
    for name in ("scalar_scan", "fused_quantiles"):
        launches[name] += sweep_launches[name]
    record["sweep_launches"] = sweep_launches

    # ---- main path 1d, the planner: surrogate and exact ladder -------------
    record["plan"], plan_launches = run_plan_phase(vector_kernels)
    for name in ("scalar_scan", "fused_quantiles"):
        launches[name] += plan_launches[name]

    # ---- 1e, soft mode: the plain step on the card --------------------------
    record["soft"] = run_soft_phase(vector_kernels)

    # ---- main path 1f, the result cache: warm runs launch nothing -----------
    (ROOT / "build").mkdir(exist_ok=True)
    cache_root = Path(tempfile.mkdtemp(prefix="chip_smoke_cache.",
                                       dir=ROOT / "build"))
    try:
        record["cache"], cache_launches = run_cache_phase(
            vector_kernels, cache_root, fig1)
    finally:
        shutil.rmtree(cache_root, ignore_errors=True)
    for name in ("scalar_scan", "fused_quantiles"):
        launches[name] += cache_launches[name]

    # ---- full width, reduced depth: the card against the CPU ---------------
    record["full_width"] = check_full_width(device)
    record["full_width_mamba"] = check_full_width(
        device, "mamba2-1.3b", 384, MAMBA_F32_LOGIT_TOL, MAMBA_BF16_LOGIT_TOL)
    for chk in FULL_WIDTH_CHECKS:
        record[f"full_width_{chk['arch']}"] = check_full_width(device, **chk)
        torch.cuda.empty_cache()

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
    check_attention_serving(SERVE_ARGS, record["serving"], serve_launches)

    # ---- main path 3, serving mamba2-1.3b at full width --------------------
    for k in all_kernels:
        k.launches = 0
    torch.cuda.synchronize()
    record["serving_mamba"] = r = run_serving(MAMBA_SERVE_ARGS)
    mamba_launches = {k.__name__: k.launches for k in all_kernels}
    print(f"launches on the mamba2 serving path: {mamba_launches}",
          flush=True)
    from repro_torch.configs.base import get_config
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

    # ---- main path 3b, serving gemma3-12b at full width and depth ----------
    for k in all_kernels:
        k.launches = 0
    torch.cuda.synchronize()
    record["serving_gemma3"] = run_serving(GEMMA_SERVE_ARGS)
    gemma_launches = {k.__name__: k.launches for k in all_kernels}
    print(f"launches on the gemma3-12b serving path: {gemma_launches}",
          flush=True)
    check_attention_serving(GEMMA_SERVE_ARGS, record["serving_gemma3"],
                            gemma_launches)
    for k in attention_kernels:
        launches[k.__name__] += gemma_launches[k.__name__]
    record["serving_gemma3_launches"] = gemma_launches
    torch.cuda.empty_cache()

    # ---- main path 3c, serving deepseek-moe-16b at full width and depth ----
    record["serving_deepseek"], ds_launches = run_measured_serving(
        DEEPSEEK_SERVE_ARGS, all_kernels)
    for k in attention_kernels:
        launches[k.__name__] += ds_launches[k.__name__]
    record["serving_deepseek_launches"] = ds_launches
    torch.cuda.empty_cache()

    # ---- main path 3d, serving llava-next-mistral-7b at full depth ---------
    record["serving_llava"], llava_launches = run_measured_serving(
        LLAVA_SERVE_ARGS, all_kernels)
    for k in attention_kernels:
        launches[k.__name__] += llava_launches[k.__name__]
    record["serving_llava_launches"] = llava_launches
    torch.cuda.empty_cache()

    # ---- main path 3e, the jamba cut on one engine --------------------------
    record["jamba_engine"], jamba_launches = run_jamba_engine(all_kernels)
    for name in ("flash_attention", "decode_attention", "ssd_scan"):
        launches[name] += jamba_launches[name]

    # ---- main path 4, control on real phi3 replicas at full width ----------
    record["engine_control"], ec_launches = run_engine_control(
        card, attention_kernels)
    for name, n in ec_launches.items():
        launches[name] += n
    record["engine_control_launches"] = ec_launches

    # ---- main path 5 (step 6g), training at full width ---------------------
    record["train_agreement"] = {}
    for arch, seq in TRAIN_AGREEMENT:
        rec, n = check_train_agreement(device, arch, seq, all_kernels)
        record["train_agreement"][arch] = rec
        for name, count in n.items():
            launches[name] += count
    record["training"] = {}
    for arch, seq in TRAIN_RUNS:
        rec, n = run_training(arch, seq, all_kernels)
        record["training"][arch] = rec
        for name, count in n.items():
            launches[name] += count
    resume_root = Path(tempfile.mkdtemp(prefix="chip_smoke_train.",
                                        dir=ROOT / "build"))
    try:
        record["train_resume"] = run_train_resume(resume_root)
    finally:
        shutil.rmtree(resume_root, ignore_errors=True)
    record["card_twins"], twin_launches = run_card_twins(all_kernels)
    for name, count in twin_launches.items():
        launches[name] += count

    # ---- step 7, the launch tooling on the card -----------------------------
    record["tooling"] = run_tooling(record, card)

    # ---- step 7b, static analysis, then check's rejections on the card ----
    record["analysis"], analysis_launches = run_analysis(
        card, grids, chaos, vector_kernels)
    for name, count in analysis_launches.items():
        launches[name] += count

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
    record["wall_s"] = time.perf_counter() - t_start
    print(f"chip_smoke: {record['wall_s']:.1f} s", flush=True)
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
