"""How accurate a model's f32 train step is: the gradient of one step
run in f32 against the same step in f64, on the CPU.

    PYTHONPATH=src python3 scripts/grad_conditioning.py \
        [--arch whisper-small-smoke] [--seed 0]

Draws the model's weights (seed ``--seed``, f32) and a batch of 2 rows
of 32 tokens (24 frames for an encoder-decoder), runs the loss and its
backward once in f32 and once in f64 (the loss head, as the train
step's, in f32 either way), and prints the loss and the
gradient norm of each, each leaf's gradient error relative to its norm
(the largest and the smallest), and for every attention call, in order:
its largest score, the share of its rows whose softmax puts more than
0.99 on one key, and the relative error of the gradient reaching its
q, k, v and output.  The gradient of q and k passes through the
softmax's backward, P (dP - sum(P dP)), which cancels where P is nearly
one-hot.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.training.train_step import make_loss_fn  # noqa: E402


def step(cfg, params, batch, dtype, calls):
    """The loss and the leaves' gradients in ``dtype``; ``calls`` takes
    each attention call's (q, k, v, output), their gradients kept."""
    calls.clear()
    params = P.tree_map(lambda t: t.to(dtype).clone().requires_grad_(True)
                        if t.dtype == torch.float32 else t, params)
    batch = {k: t.to(dtype) if t.is_floating_point() else t
             for k, t in batch.items()}
    loss, _ = make_loss_fn(cfg, remat=False)(params, batch)
    loss.backward()
    grads = {path: t.grad.double() for path, t in P.leaves(params)
             if t.grad is not None}
    return float(loss.detach()), grads


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm()) if b.norm() else 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="whisper-small-smoke")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg = get_config(args.arch)
    params = P.tree_map(
        lambda t: t.float() if t.is_floating_point() else t,
        P.init_tree(R.model_specs(cfg),
                    torch.Generator().manual_seed(args.seed)))
    r = np.random.default_rng(args.seed + 1)
    tokens = r.integers(0, cfg.vocab_size, (2, 33)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]).int(),
             "targets": torch.from_numpy(tokens[:, 1:]).int()}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(r.normal(
            size=(2, 24, R.FRONTEND_DIMS["frame"])).astype(np.float32))
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        for t in (q, k, v):
            t.retain_grad()
        o = real(q, k, v, **kw)
        o.retain_grad()
        calls.append((q, k, v, o))
        return o
    ops.flash_attention = spy
    try:
        l32, g32 = step(cfg, params, batch, torch.float32, calls)
        c32 = [[(t.detach().double(), t.grad.double()) for t in c]
               for c in calls]
        l64, g64 = step(cfg, params, batch, torch.float64, calls)
        c64 = [[(t.detach().double(), t.grad.double()) for t in c]
               for c in calls]
    finally:
        ops.flash_attention = real
    n32 = float(torch.sqrt(sum((g ** 2).sum() for g in g32.values())))
    n64 = float(torch.sqrt(sum((g ** 2).sum() for g in g64.values())))
    print(f"{args.arch} seed {args.seed}: loss f32 {l32!r} f64 {l64!r} "
          f"(relative {abs(l32 - l64) / abs(l64):.3e}); gradient norm f32 "
          f"{n32!r} f64 {n64!r} (relative {abs(n32 - n64) / n64:.3e})")
    errs = sorted(((rel(g32[p], g64[p]), p) for p in g64), reverse=True)
    print("leaves by the f32 gradient's error, relative to the leaf's norm:")
    for i, (e, p) in enumerate(errs):
        if i < 5 or i >= len(errs) - 3:
            print(f"  {e:.3e}  {'/'.join(p)}")
        elif i == 5:
            print("  ...")
    print("attention calls in forward order (the backward runs them "
          "last to first):")
    for i, (a, b) in enumerate(zip(c32, c64)):
        q, k = b[0][0], b[1][0]
        g = q.shape[2] // k.shape[2]
        s = torch.einsum("bqhd,bkhd->bhqk", q,
                         k.repeat_interleave(g, dim=2)) * q.shape[-1] ** -0.5
        top = torch.softmax(s, dim=-1).max(dim=-1).values
        grads = ", ".join(f"{n} {rel(x[1], y[1]):.2e}"
                          for n, x, y in zip("qkvo", a, b))
        print(f"  {i}: q {tuple(q.shape)} k {tuple(k.shape)}, largest score "
              f"{float(s.abs().max()):.1f}, rows over 0.99 on one key "
              f"{float((top > 0.99).double().mean()):.3f}; gradient error "
              f"{grads}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
