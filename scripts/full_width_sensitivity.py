"""How far a full-width model's f32 logits move, card against CPU, and
why: the kernels, the card, or the model itself.

    python3 scripts/full_width_sensitivity.py [--arch gemma3-12b]
        [--layers N] [--prompt N]

Builds ``--arch`` at full width and ``--layers`` deep (default: one
pattern group of gemma3-12b, 6 layers, with chip_smoke's 1100-token
prompt) from the seeded weights of chip_smoke's step 5, in f32, runs
the CPU's greedy prefill and 8 decode steps, and prints, for every step,
max|logit difference| / max|logit| of:

* the card with the CUDA kernels (``card_kernels``), fed the CPU's
  tokens, as chip_smoke's check runs it;
* the card with the kernels' plain versions (``card_plain``): the same
  arithmetic as the CPU's, in the card's own sum orders;
* the CPU against itself with every f32 weight matrix moved by one ulp,
  with a random sign (``cpu_weights_1ulp``): the model's own
  conditioning.

Where the first two agree and the third is as large, the gap is the
model's, not a kernel's.  The record goes to
``chiprun_out/full_width_sensitivity_<arch>.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("this script needs a CUDA GPU", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import param as P
    from repro_torch.models import registry as R

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = replace(get_config(args.arch), num_layers=args.layers)
    p32 = P.tree_map(lambda t: t.float(), R.init_params(
        cfg, torch.Generator().manual_seed(0)))
    prompt = torch.randint(0, cfg.vocab_size, (1, args.prompt),
                           dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    max_len = args.prompt + STEPS + 32
    cpu_l, cpu_t = cs.greedy(cfg, p32, prompt, max_len, STEPS)

    def per_step(logits):
        return ((logits - cpu_l).abs().max(-1).values
                / cpu_l.abs().max(-1).values).tolist()

    rec = {"arch": cfg.name, "layers": cfg.num_layers, "prompt": args.prompt,
           "device": torch.cuda.get_device_name(0),
           "max_abs_logit": cpu_l.abs().max(-1).values.tolist()}
    on_card = P.tree_map(lambda t: t.to(dev), p32)
    gl, _ = cs.greedy(cfg, on_card, prompt.to(dev), max_len, STEPS,
                      forced=cpu_t[:-1])
    rec["card_kernels"] = per_step(gl)
    on_cuda = ops._on_cuda
    ops._on_cuda = lambda x: False           # the plain versions, on the card
    try:
        gl, _ = cs.greedy(cfg, on_card, prompt.to(dev), max_len, STEPS,
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
    gl, _ = cs.greedy(cfg, P.tree_map(nudge, p32), prompt, max_len, STEPS,
                      forced=cpu_t[:-1])
    rec["cpu_weights_1ulp"] = per_step(gl)
    rec["seconds"] = time.perf_counter() - t0
    for key in ("card_kernels", "card_plain", "cpu_weights_1ulp"):
        print(f"{cfg.name} {key}: prefill {rec[key][0]:.3e}, decode max "
              f"{max(rec[key][1:]):.3e}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"full_width_sensitivity_{args.arch}.json").write_text(
        json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
