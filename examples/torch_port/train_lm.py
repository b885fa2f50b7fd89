"""Train a reduced LM for a few hundred steps with checkpoint/restart.

Twin of ``examples/train_lm.py`` on the PyTorch/CUDA port.  The
reference's docstring names the mamba2 family at width 512, but its
``ARGS`` train ``stablelm-3b --smoke``; this twin follows the code:
stablelm-3b's smoke config on the synthetic Zipf stream, on the card
unless ``--device cpu``.  It stops at step 60 and resumes from the
checkpoint to demonstrate fault tolerance.

    PYTHONPATH=src python examples/torch_port/train_lm.py
    PYTHONPATH=src python examples/torch_port/train_lm.py --device cpu
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.launch import train


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    args = ap.parse_args(argv)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    common = ["--arch", "stablelm-3b", "--smoke", "--batch", "8", "--seq",
              "128", "--lr", "1e-3", "--ckpt-dir", args.ckpt_dir,
              "--ckpt-every", "30", "--log-every", "20", "--device",
              args.device]

    print("=== phase 1: train to step 60, checkpointing every 30 ===")
    train.main(common + ["--steps", "60"])

    print("=== phase 2: 'crash' and resume from the latest checkpoint ===")
    loss = train.main(common + ["--steps", "200", "--resume"])
    print(f"final loss {loss:.4f}")
    assert loss < 7.0
    return loss


if __name__ == "__main__":
    main()
