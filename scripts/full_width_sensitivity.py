"""How far a full-width model's f32 logits move, card against CPU, and
why: the kernels, the card, or the model itself.

    python3 scripts/full_width_sensitivity.py [--arch gemma3-12b]
        [--layers N] [--prompt N]
    python3 scripts/full_width_sensitivity.py --check whisper-small
        [--reference-draw]
    python3 scripts/full_width_sensitivity.py --train phi3-mini-3.8b
        [--reference-draw]

Builds ``--arch`` at full width and ``--layers`` deep (default: one
pattern group of gemma3-12b, 6 layers, with chip_smoke's 1100-token
prompt) from the seeded weights of chip_smoke's step 5, or, with
``--check``, the model of one of step 5's ``FULL_WIDTH_CHECKS`` as that
check builds it (its depth or cut, its draw, its frontend's inputs, its
f32 tree; with ``--reference-draw`` at ``init_params``' scales where
the check draws at ``layer_std_specs``'), in f32, runs the CPU's greedy
prefill and 8 decode steps, and prints, for every step, max|logit
difference| / max|logit| of:

* the card with the CUDA kernels (``card_kernels``), fed the CPU's
  tokens, as chip_smoke's check runs it;
* the card with the kernels' plain versions (``card_plain``): the same
  arithmetic as the CPU's, in the card's own sum orders;
* the CPU against itself with every f32 weight matrix moved by one ulp,
  with a random sign (``cpu_weights_1ulp``): the model's own
  conditioning.

Where the first two agree and the third is as large, the gap is the
model's, not a kernel's.  ``--train`` does the same for chip_smoke step
6g's train-step agreement (``TRAIN_AGREEMENT``: the arch at full width,
2 layers, f32, its batch, its draw; ``--reference-draw`` as above): the
loss, the gradients' global norm and every gradient leaf (relative to
the leaf's max|g|), CPU against card.  The record goes to
``chiprun_out/full_width_sensitivity_<arch>.json``.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

STEPS = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--prompt", type=int, default=1100)
    ap.add_argument("--check", default=None,
                    help="an arch of chip_smoke's FULL_WIDTH_CHECKS")
    ap.add_argument("--train", default=None,
                    help="an arch of chip_smoke's TRAIN_AGREEMENT")
    ap.add_argument("--reference-draw", action="store_true",
                    help="with --check or --train: the weights at "
                         "init_params' scales, not the check's layer_std "
                         "ones")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("this script needs a CUDA GPU", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.models import param as P

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    if args.train:
        return train_sensitivity(args.train, dev, t0, args.reference_draw)
    if args.check:
        chk = next(c for c in cs.FULL_WIDTH_CHECKS
                   if c["arch"] == args.check)
        kw = {k: v for k, v in chk.items()
              if k not in ("arch", "f32_tol", "bf16_tol", "bf16_banks")}
        if args.reference_draw:
            kw["layer_std"] = False
        cfg, params, prompt, inputs, max_len = cs.full_width_model(
            chk["arch"], **kw)
        p32 = cs.f32_tree(params, chk.get("bf16_banks", False))
        del params
    else:
        cfg, params, prompt, inputs, max_len = cs.full_width_model(
            args.arch, args.layers, args.prompt)
        p32 = cs.f32_tree(params)
    run = functools.partial(cs.greedy, extra=inputs)
    cpu_l, cpu_t = run(cfg, p32, prompt, max_len, STEPS)

    def per_step(logits):
        return ((logits - cpu_l).abs().max(-1).values
                / cpu_l.abs().max(-1).values).tolist()

    rec = {"arch": cfg.name, "layers": cfg.num_layers,
           "prompt": prompt.shape[1], "check": args.check,
           "reference_draw": args.reference_draw,
           "device": torch.cuda.get_device_name(0),
           "max_abs_logit": cpu_l.abs().max(-1).values.tolist()}
    on_card = P.tree_map(lambda t: t.to(dev), p32)
    gl, _ = run(cfg, on_card, prompt.to(dev), max_len, STEPS,
                forced=cpu_t[:-1])
    rec["card_kernels"] = per_step(gl)
    on_cuda = ops._on_cuda
    ops._on_cuda = lambda x: False           # the plain versions, on the card
    try:
        gl, _ = run(cfg, on_card, prompt.to(dev), max_len, STEPS,
                    forced=cpu_t[:-1])
    finally:
        ops._on_cuda = on_cuda
    rec["card_plain"] = per_step(gl)
    del on_card
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(7)

    def nudge(t):
        if t.dim() < 2:
            return t
        sign = torch.randint(0, 2, t.shape, generator=g).float() * 2 - 1
        return torch.nextafter(t, t + sign * torch.inf)
    gl, _ = run(cfg, P.tree_map(nudge, p32), prompt, max_len, STEPS,
                forced=cpu_t[:-1])
    rec["cpu_weights_1ulp"] = per_step(gl)
    rec["seconds"] = time.perf_counter() - t0
    for key in ("card_kernels", "card_plain", "cpu_weights_1ulp"):
        print(f"{cfg.name} {key}: prefill {rec[key][0]:.3e}, decode max "
              f"{max(rec[key][1:]):.3e}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = args.check or args.arch
    if args.reference_draw:
        name += "_reference_draw"
    (out / f"full_width_sensitivity_{name}.json").write_text(
        json.dumps(rec, indent=1))
    return 0


def train_sensitivity(arch: str, dev, t0: float,
                      reference_draw: bool) -> int:
    """The train-step counterpart of ``main`` (``--train``), on the
    check's draw (``layer_std_specs``) or the reference's."""
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.models import param as P
    from repro_torch.training.data import DataConfig, SyntheticLM
    seq = dict(cs.TRAIN_AGREEMENT)[arch]
    cfg, params, *_ = cs.full_width_model(arch, 2,
                                          layer_std=not reference_draw)
    p32 = cs.f32_tree(params)
    del params
    data = SyntheticLM(DataConfig(cfg.vocab_size, cs.TRAIN_BATCH, seq))
    batch = {k: torch.from_numpy(v) for k, v in data.next_batch().items()}
    loss, norm, grads = cs.train_loss_and_grads(cfg, p32, batch)

    def gaps(run):
        l2, n2, g2 = run
        leaf = {}
        for path, g in grads.items():
            scale = g.abs().max().item()
            leaf["/".join(path)] = ((g2[path].cpu() - g).abs().max().item()
                                    / (scale if scale else 1.0))
        return {"loss_rel": abs(l2 - loss) / abs(loss),
                "grad_norm_rel": abs(n2 - norm) / norm,
                "grad_rel_max": max(leaf.values()), "grad_rel": leaf}
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "seq": seq,
           "batch": cs.TRAIN_BATCH, "device": torch.cuda.get_device_name(0),
           "reference_draw": reference_draw, "loss": loss,
           "grad_norm": norm}
    on_card = P.tree_map(lambda t: t.to(dev), p32)
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    rec["card_kernels"] = gaps(cs.train_loss_and_grads(cfg, on_card,
                                                       card_batch))
    on_cuda = ops._on_cuda
    ops._on_cuda = lambda x: False           # the plain versions, on the card
    try:
        rec["card_plain"] = gaps(cs.train_loss_and_grads(cfg, on_card,
                                                         card_batch))
    finally:
        ops._on_cuda = on_cuda
    del on_card
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(7)

    def nudge(t):
        if t.dim() < 2:
            return t
        sign = torch.randint(0, 2, t.shape, generator=g).float() * 2 - 1
        return torch.nextafter(t, t + sign * torch.inf)
    rec["cpu_weights_1ulp"] = gaps(cs.train_loss_and_grads(
        cfg, P.tree_map(nudge, p32), batch))
    rec["seconds"] = time.perf_counter() - t0
    for key in ("card_kernels", "card_plain", "cpu_weights_1ulp"):
        r = rec[key]
        worst = max(r["grad_rel"], key=r["grad_rel"].get)
        print(f"{cfg.name} train {key}: loss {r['loss_rel']:.3e}, grad norm "
              f"{r['grad_norm_rel']:.3e}, worst leaf {worst} "
              f"{r['grad_rel_max']:.3e}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = arch + ("_reference_draw" if reference_draw else "")
    (out / f"full_width_sensitivity_train_{name}.json").write_text(
        json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
