"""The port's checkpoint store and training launcher on the CPU:
checkpoints cross between ``repro.checkpoint.store`` and
``repro_torch.checkpoint.store`` with equal bits (bf16 leaves included,
stored as their raw ``uint16`` bits), the reference's store tests
twinned (partial writes ignored, ``AsyncCheckpointer`` GC, a restart
that resumes the exact trajectory), and ``repro_torch.launch.train
--device cpu``: a run checkpointed and resumed equals a straight run,
bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402

from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tstep  # noqa: E402

ARCH = "phi3-mini-3.8b-smoke"


def _jax_tree():
    """phi3-smoke's bf16 params and a default AdamW state (bf16 m, f32 v)
    with non-zero moments and step 7."""
    params = JR.init_params(jax_config(ARCH), jax.random.PRNGKey(0))
    cfg = jopt.OptConfig()
    opt = jopt.init_opt_state(params, cfg)
    r = np.random.default_rng(0)
    opt["m"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.normal(size=a.shape), a.dtype), opt["m"])
    opt["v"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.random(size=a.shape), a.dtype), opt["v"])
    opt["step"] = jnp.asarray(7, jnp.int32)
    return {"params": params, "opt": opt}


def _port(tree):
    return P.from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _zeros_like(tree):
    return P.tree_map(torch.zeros_like, tree)


def _assert_trees_bit_equal(a: dict, b: dict) -> None:
    pa, pb = list(P.leaves(a)), list(P.leaves(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jtree = _jax_tree()
    jstore.save(jtree, str(tmp_path), 7, extra={"data": {"step": 7,
                                                         "seed": 0}})
    want = _port(jtree)
    got, step, extra = store.restore(_zeros_like(want), str(tmp_path))
    assert step == 7 and extra == {"data": {"step": 7, "seed": 0}}
    assert got["params"]["embed"]["tokens"].dtype == torch.bfloat16
    _assert_trees_bit_equal(got, want)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jtree = _jax_tree()
    store.save(_port(jtree), str(tmp_path), 3, extra={"k": 1})
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json")
                          .read_text())
    assert manifest["dtypes"]["params/embed/tokens"] == "bfloat16"
    assert "opt/v/embed/tokens" not in manifest["dtypes"]
    like = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    got, step, extra = jstore.restore(like, str(tmp_path))
    assert step == 3 and extra == {"k": 1}
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype, path
        assert a.shape == b.shape, path
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path


def test_checkpoint_partial_write_ignored(tmp_path):
    d = str(tmp_path)
    store.save({"x": torch.ones(3)}, d, 1)
    # simulate a crashed write: tmp dir without manifest
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    os.makedirs(os.path.join(d, "step_00000003"))  # no manifest
    assert store.latest_step(d) == 1
    assert store.steps(str(tmp_path / "missing")) == []
    with pytest.raises(FileNotFoundError):
        store.restore({"x": torch.zeros(3)}, str(tmp_path / "empty"))


def test_async_checkpointer_gc(tmp_path):
    d = str(tmp_path)
    ck = store.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3, 4):
        ck.save({"x": torch.full((4,), float(s))}, s)
    ck.wait()
    assert store.steps(d) == [3, 4]
    tree, s, _ = store.restore({"x": torch.zeros(4)}, d)
    assert s == 4
    assert torch.equal(tree["x"], torch.full((4,), 4.0))


def test_async_checkpointer_snapshots_at_save(tmp_path):
    """The snapshot is taken when ``save`` is called: a parameter
    updated in place right after is not what is written."""
    x = torch.zeros(1000)
    ck = store.AsyncCheckpointer(str(tmp_path))
    ck.save({"x": x}, 1)
    x.add_(1.0)
    ck.wait()
    tree, _, _ = store.restore({"x": torch.ones(1000)}, str(tmp_path))
    assert torch.equal(tree["x"], torch.zeros(1000))


def test_checkpoint_restart_bitexact(tmp_path):
    """Kill/restart mid-training resumes the exact trajectory."""
    cfg = get_config(ARCH)
    opt_cfg = topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    step = tstep.make_train_step(cfg, opt_cfg)
    dcfg = tdata.DataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=64)
    data = tdata.SyntheticLM(dcfg)
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    opt = topt.init_opt_state(params, opt_cfg)

    def batch(stream):
        return {k: torch.from_numpy(v) for k, v in stream.next_batch().items()}
    d = str(tmp_path)
    # run 3 steps, checkpoint, run 2 more
    for _ in range(3):
        params, opt, _ = step(params, opt, batch(data))
    store.save({"params": params, "opt": opt}, d, 3,
               extra={"data": data.state()})
    like = P.tree_map(lambda t: t.detach().clone(),
                      {"params": params, "opt": opt})
    for _ in range(2):
        params, opt, _ = step(params, opt, batch(data))
    # "crash": rebuild everything from the checkpoint
    tree, step_no, extra = store.restore(like, d)
    assert step_no == 3
    data2 = tdata.SyntheticLM.from_state(dcfg, extra["data"])
    r_params, r_opt = tree["params"], tree["opt"]
    for _ in range(2):
        r_params, r_opt, _ = step(r_params, r_opt, batch(data2))
    _assert_trees_bit_equal({"params": params, "opt": opt},
                            {"params": r_params, "opt": r_opt})


def _load(directory: str, step: int) -> dict:
    with np.load(os.path.join(directory, f"step_{step:08d}",
                              "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_launch_train_resume_equals_a_straight_run(tmp_path, capsys):
    """``launch.train --device cpu``: 6 steps straight, checkpointing
    every 3, against a run resumed from the straight run's step-3
    checkpoint; the two step-6 checkpoints hold equal bits."""
    args = ["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
            "--steps", "6", "--batch", "2", "--seq", "32", "--lr", "1e-3",
            "--ckpt-every", "3", "--log-every", "3"]
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    loss = train.main(args + ["--ckpt-dir", straight])
    logged = [ln.split()[1] for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("step ")]
    assert logged == ["3", "6"] and np.isfinite(loss)
    assert store.steps(straight) == [3, 6]
    os.makedirs(resumed)
    shutil.copytree(os.path.join(straight, "step_00000003"),
                    os.path.join(resumed, "step_00000003"))
    loss2 = train.main(args + ["--ckpt-dir", resumed, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert "step     6 loss=" in out
    assert loss2 == loss
    a, b = _load(straight, 6), _load(resumed, 6)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    manifest = json.loads(open(os.path.join(resumed, "step_00000006",
                                            "manifest.json")).read())
    assert manifest["extra"] == {"data": {"step": 6, "seed": 0}}


def test_launch_train_refuses_encoder_decoder(capsys):
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", "whisper-small", "--smoke", "--device", "cpu",
                    "--steps", "1"])
    assert e.value.code == 2
    assert "encoder-decoder" in capsys.readouterr().err


def test_train_lm_example_twin_on_cpu(tmp_path):
    """``examples/torch_port/train_lm.py --device cpu``: train to step
    60, resume from the checkpoint to 200, its own ``loss < 7.0``."""
    import subprocess
    import sys
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        os.pardir))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "examples", "torch_port",
                                      "train_lm.py"),
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "resumed from step 60" in lines
    assert float(lines[-1].split()[-1]) < 7.0
    # every 30 steps, the newest 3 kept
    assert store.steps(str(tmp_path / "ck")) == [120, 150, 180]
