"""Training launcher: real steps on one device, fault-tolerant.

Twin of ``repro.launch.train``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ck \\
      --ckpt-every 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --steps 10 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --smoke --steps 20 --device cpu

--resume restores params/opt/data state from the latest checkpoint (the
restart path a cluster scheduler takes after preemption).  Runs on the
card unless ``--device cpu`` (the kernels' plain versions); weights are
drawn from ``--seed`` on that device.  One device only, as the
reference's launcher (which imports the mesh helpers but builds no
mesh); a sharded train step is ``make_train_step`` on DTensors under
``distributed.sharding.mesh_context``.  An
encoder-decoder model (whisper-small) is refused: the synthetic batch
has no encoder input (``frames``), where the reference fails too.

A checkpoint records the data stream at the next batch the loop takes.
The reference records ``data.state()``, which its prefetch thread has
already moved past the batches it holds, so its resume may skip up to
two batches; here a resumed run equals a straight one bit for bit.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models import registry as R
from repro_torch.training.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def main(argv=None) -> float:
    """Train; -> the last step's loss."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (cpu = the kernels' plain "
                         "PyTorch versions)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    name = args.arch + ("-smoke" if args.smoke else "")
    cfg = get_config(name)
    if cfg.enc_dec:
        ap.error(f"{name} is an encoder-decoder model: its forward needs the "
                 f"encoder's input (batch['frames']), and the synthetic LM "
                 f"stream has tokens only")
    device = resolve_device(args.device)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                        total_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                      seq_len=args.seq, seed=args.seed)

    params = R.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(args.seed))
    opt = init_opt_state(params, opt_cfg)
    data = SyntheticLM(dcfg)
    start_step = 0

    ckpt = store.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir and store.latest_step(args.ckpt_dir) is not None:
        tree, start_step, extra = store.restore({"params": params, "opt": opt},
                                                args.ckpt_dir)
        params, opt = tree["params"], tree["opt"]
        data = SyntheticLM.from_state(dcfg, extra["data"])
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    # the stream's position of the next batch the loop takes: the
    # prefetcher runs ahead of it, so its own ``data.state()`` does not
    # say which batches were trained on
    next_data = data.state()
    pf = Prefetcher(data)
    t0 = time.time()
    tokens_done = 0
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pf.next_batch().items()}
            next_data = dict(next_data, step=next_data["step"] + 1)
            params, opt, metrics = step_fn(params, opt, batch)
            tokens_done += args.batch * args.seq
            if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
                loss = float(metrics["loss"])         # waits for the step
                dt = time.time() - t0
                print(f"step {step+1:5d} loss={loss:.4f} "
                      f"acc={float(metrics['acc']):.3f} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"tok/s={tokens_done/dt:.0f}")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save({"params": params, "opt": opt}, step + 1,
                          extra={"data": next_data})
    finally:
        pf.close()
        if ckpt:
            ckpt.wait()
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
