"""Whole runs of the smoke cell on the CPU through the benchmark's own
path (set-up, the window through ``EngineRuntime``, the check, the
result line), with the timed path sound, broken underneath, and
replaced by the fp8 control; and, where a card exists, the real cells.

The smoke cell's limit (``tests/data/cells``, 0.03) was set from its
readings on seeds 1-12 (CPU, bf16): the program's widest gap 0 to
0.0160, the fp8 control's 0.0484 to 0.2695."""
import json
import subprocess
import sys

import pytest
import torch

import smoke
from servebench import check as C
from servebench import harness, spec


def test_a_sound_run_is_correct_and_prints_its_line():
    out = smoke.run(seed=2 ** 31 + 5)
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] > 10
    assert set(out["metrics"]) == {"ttft_p90_ms", "latency_p90_ms",
                                   "tpot_ms", "setup_s"}
    assert list(out)[-1] == "check"
    assert out["check"]["max_logit_gap"]["limit"] == 0.03


def test_a_traced_run_reports_per_layer_metrics():
    out = smoke.run(seed=3, seconds=1.5, trace=1)
    assert out["correct"] is True
    names = {m["name"] for m in spec.benchmark()["per_layer"]}
    # the CPU run has no device trace: those metrics are left out
    assert {"gen_lag_p90_ms", "prefill_ms", "decode_step_ms"} <= set(
        out["metrics"]) <= names
    assert "flash_attention_roofline" not in out["metrics"]
    assert "busy_s" in out["device"] and "breakdown" in out


def _decode_fault(kind):
    from repro_torch.models import registry as R
    plain = R.decode_step

    def broken(cfg, params, cache, tokens, positions, **kw):
        if kind == "state_unchanged":
            saved = {n: {k: t.clone() for k, t in e.items()}
                     for n, e in cache.items()}
        logits, cache = plain(cfg, params, cache, tokens, positions, **kw)
        if kind == "state_unchanged":
            for n, e in saved.items():
                for k, t in e.items():
                    cache[n][k].copy_(t)
        elif kind == "half_batch":
            # every other slot left out: half of the batch, and one of
            # the slots a second concurrent request takes
            logits = logits.clone()
            logits[1::2] = 0.0
        elif kind == "token_altered":
            logits = logits.roll(1, dims=-1)
        return logits, cache
    return broken


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "token_altered"])
def test_a_broken_timed_path_is_not_correct(kind, monkeypatch):
    from repro_torch.models import registry as R
    monkeypatch.setattr(R, "decode_step", _decode_fault(kind))
    # at the smoke rate a CPU replica mostly serves one request at a
    # time; the same requests offered six times as fast share decode
    # steps, so a fault in half of the batch reaches the sampled ones
    out = smoke.run(seed=11, seconds=0.25, load=6.0)
    assert out["failed"] == 0
    assert out["correct"] is False
    assert out["check"]["max_logit_gap"]["value"] > 0.03


@pytest.mark.parametrize("seed", [1, 5, 12])
def test_the_fp8_control_is_not_correct(seed):
    cell = smoke.cell()
    st = harness.setup(cell, seed, "cpu")
    rec = harness.serve(st, cell.rate, 1.5, seed)
    got = C.compare(cell.config, st.weights.tree(), rec, seed,
                    C.sample(rec, seed, cell.check["tokens"]), "cpu",
                    control=True)
    assert got["max_logit_gap"] <= cell.check["max_logit_gap"]
    assert got["control_max_logit_gap"] > cell.check["max_logit_gap"]
    # the control's reading, put through the verdict in the program's place
    assert C.decide(cell, rec, got)[0] is True
    ctrl = dict(got, max_logit_gap=got["control_max_logit_gap"])
    assert C.decide(cell, rec, ctrl)[0] is False


def test_the_step_log_records_what_each_step_did():
    cell = smoke.cell()
    st = harness.setup(cell, 4, "cpu")
    rec = harness.serve(st, cell.rate, 1.5, 4)
    kinds = [k for _, k, _, _, _ in rec.steps]
    assert set(kinds) == {"prefill", "decode"}
    prefilled = sorted(n for _, k, _, _, info in rec.steps
                       if k == "prefill" for n in info)
    assert prefilled == sorted(a.prompt for a in rec.arrivals)
    n_prefill = sum(e["prefill_count"] for e in rec.engines)
    n_decode = sum(e["decode_steps"] for e in rec.engines)
    assert kinds.count("prefill") == n_prefill
    assert kinds.count("decode") == n_decode
    # every served token after the first came from one decode step
    assert sum(len(info) for _, k, _, _, info in rec.steps
               if k == "decode") == sum(
        len(t) - 1 for t in rec.tokens.values())


def test_the_step_log_refuses_a_step_it_cannot_attribute(monkeypatch):
    from repro_torch.serving.engine import InferenceEngine
    plain = InferenceEngine.step

    def prefill_and_decode(self):
        # an engine that admits a prompt and decodes in the same step
        if self.queue and None in self.active and self.n_active():
            self._admit(self.queue.pop(0), self.active.index(None))
            return self._decode_once()
        return plain(self)

    monkeypatch.setattr(InferenceEngine, "step", prefill_and_decode)
    cell = smoke.cell()
    st = harness.setup(cell, 6, "cpu")
    with pytest.raises(RuntimeError, match="cannot attribute"):
        harness.serve(st, cell.rate, 1.5, 6)


def test_a_request_the_engine_loses_counts_as_unserved():
    # 3 s of the smoke mix asks one token of some requests: the engine
    # finishes those at their prefill and its step() never returns them
    cell = smoke.cell()
    st = harness.setup(cell, 7, "cpu")
    rec = harness.serve(st, cell.rate, 3.0, 7)
    ones = {i for i, a in enumerate(rec.arrivals) if a.new == 1}
    assert ones and set(rec.lost) == ones
    ok, numbers = C.decide(cell, rec, {"max_logit_gap": 0.0,
                                       "tokens_compared": 10 ** 6})
    assert ok is False and numbers["unserved"]["value"] == len(ones)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(spec.HERE / "run.py"),
                        "--workload", "phi3-mini-3.8b.docqa", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=spec.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_each_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, str(spec.HERE / "run.py"),
                        "--workload", cell, "--seed", str(2 ** 31 + 3),
                        "--seconds", "10", "--trace", "0"],
                       capture_output=True, text=True, cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
