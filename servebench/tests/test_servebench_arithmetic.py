"""The end-to-end arithmetic, the traffic law and the operation and
byte counts, against hand counts and the program's own rules."""
import math

import numpy as np
import pytest

from servebench import counts, e2e, harness, spec
from servebench import traffic as TR
from servebench.e2e import Served


def test_ttft_counts_from_the_due_time():
    # due at 1.0, reached the engine at 1.3 (0.3 late), first token 0.2
    # after that, last 0.9 after it; the runtime saw it done at 2.2
    r = Served(0, due=1.0, done=2.2, ttft=0.2, latency=0.9, tokens=4)
    assert e2e.lag(r) == pytest.approx(0.3)
    assert e2e.ttft_from_due(r) == pytest.approx(0.5)
    assert e2e.latency(r) == pytest.approx(1.2)


def test_tpot_is_the_whole_windows_decode_time_over_its_tokens():
    rs = [Served(0, 0, 1, ttft=0.1, latency=0.5, tokens=5),   # 0.4 / 4
          Served(1, 0, 1, ttft=0.1, latency=2.1, tokens=11),  # 2.0 / 10
          Served(2, 0, 1, ttft=0.3, latency=0.3, tokens=1)]   # no decode
    assert e2e.tpot(rs) == pytest.approx(2.4 / 14)
    # not the mean of per-request means (0.1 and 0.2)
    assert e2e.tpot(rs) != pytest.approx(0.15)


@pytest.mark.parametrize("n", [1, 2, 7, 10, 101])
def test_p90_interpolates_as_numpy(n):
    xs = np.random.default_rng(n).exponential(size=n)
    assert e2e.percentile(xs, 0.9) == pytest.approx(np.percentile(xs, 90))


def test_end_to_end_metrics_in_ms():
    rs = [Served(i, due=i * 0.1, done=i * 0.1 + 0.2 + i * 0.01, ttft=0.05,
                 latency=0.2, tokens=3) for i in range(20)]
    out = e2e.end_to_end(rs)
    lat = [0.2 + i * 0.01 for i in range(20)]
    assert out["latency_p90_ms"] == pytest.approx(
        1e3 * np.percentile(lat, 90))
    assert out["ttft_p90_ms"] == pytest.approx(
        1e3 * np.percentile([0.05 + i * 0.01 for i in range(20)], 90))
    assert out["tpot_ms"] == pytest.approx(1e3 * 0.15 / 2)


@pytest.mark.parametrize("mix", ["docqa", "longchat"])
def test_every_seed_offers_the_same_work_in_another_order(mix):
    t = spec.load_cell(f"phi3-mini-3.8b.{mix}").traffic
    a = TR.schedule(t, 3.0, 45.0, 2 ** 31 + 11)
    b = TR.schedule(t, 3.0, 45.0, 5)
    assert len(a) == len(b) > 100
    assert [x.t for x in a] != [x.t for x in b]
    for f in ("prompt", "new"):
        assert sorted(getattr(x, f) for x in a) == sorted(
            getattr(x, f) for x in b)
    for c in range(t["clients"]):
        ga = np.diff([0.0] + [x.t for x in a if x.client == c])
        gb = np.diff([0.0] + [x.t for x in b if x.client == c])
        np.testing.assert_allclose(np.sort(ga), np.sort(gb))
    assert all(0 < x.t < 45.0 for x in a)
    assert all(x.new >= 2 for x in a)
    lens = t["lengths"]
    assert max(x.prompt for x in a) <= lens["prompt_max"]
    assert max(x.prompt + x.new for x in a) + 32 <= TR.max_len(t)
    assert a == TR.schedule(t, 3.0, 45.0, 2 ** 31 + 11)


def test_prompts_are_drawn_as_the_runtime_draws_them():
    t = spec.load_cell("phi3-mini-3.8b.docqa").traffic
    arr = TR.schedule(t, 2.0, 5.0, 77)
    rng = np.random.default_rng(77)
    for a, p in zip(arr, TR.prompts(77, 32064, arr)):
        np.testing.assert_array_equal(p, rng.integers(0, 32064,
                                                      size=a.prompt))


def test_bucket_rule_is_the_engines():
    from repro_torch.serving.engine import _bucket
    t = {"lengths": {"prompt_max": 3968, "new_max": 48}}
    cap = TR.max_len(t)
    for n in [1, 31, 32, 33, 100, 1024, 1025, 2047, 2049, 3968]:
        assert TR.buckets(t, [n]) == [min(_bucket(n), cap)]


def _smoke(arch="phi3-mini-3.8b"):
    from repro_torch.configs.base import get_config
    c = get_config(arch + "-smoke")
    return {"hidden_size": c.d_model, "intermediate_size": c.d_ff,
            "num_attention_heads": c.num_heads,
            "num_key_value_heads": c.num_kv_heads,
            "head_dim": c.resolved_head_dim,
            "num_hidden_layers": c.num_layers, "vocab_size": c.vocab_size}


def test_product_params_are_the_programs_product_leaves():
    from repro_torch.configs.base import get_config
    from repro_torch.models import param as P
    from repro_torch.models import registry as R
    for arch in ("phi3-mini-3.8b", "llava-next-mistral-7b"):
        cfg = get_config(arch)
        n = sum(math.prod(s.shape) for path, s in P.leaves(R.model_specs(cfg))
                if path[0] in ("groups", "unembed") and s.init == "normal")
        file = spec.load_cell(
            f"{arch}.docqa").config
        assert counts.product_params(file) == n
        assert R.count_params(cfg) == file["bytes"]["parameters"]
        assert file["bytes"]["weights_bf16"] == 2 * R.count_params(cfg)
        assert file["bytes"]["kv_cache_per_token"] == (
            2 * 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim)


def test_counts_against_hand_counts_at_smoke_shapes():
    c = _smoke()          # d 64, H 4, KV 2, hd 16, d_ff 128, L 2, V 256
    assert (c["num_attention_heads"], c["num_key_value_heads"],
            c["head_dim"]) == (4, 2, 16)
    layer = 64 * (4 + 2 + 2) * 16 + 4 * 16 * 64 + 3 * 64 * 128
    assert counts.product_params(c) == 2 * layer + 256 * 64
    # a 3-token prompt: products at 3 positions, logits at 1, and
    # 3 * 4 / 2 = 6 causal pairs a head and layer at 4 * hd FLOPs
    assert counts.prefill_flops(c, 3) == (2 * 2 * layer * 3 + 2 * 256 * 64
                                          + 4 * 4 * 16 * 6 * 2)
    assert counts.decode_flops(c, 10) == (2 * (2 * layer + 256 * 64)
                                          + 4 * 4 * 16 * 10 * 2)
    # q (3 x 4 x 16), k and v (3 x 2 x 16), out (3 x 4 x 16) in bf16
    assert counts.flash_call(c, 3) == (2 * 3 * 16 * (8 + 4),
                                       4.0 * 16 * 4 * 6)
    # slots of 5 and 7 keys: K and V (KV 2 x hd 16) of 12 keys, q and out
    assert counts.decode_call(c, (5, 7)) == (
        2 * (2 * 2 * 16 * 12 + 2 * 4 * 16 * 2), 4.0 * 16 * 4 * 12)
    assert counts.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert counts.bound_s(0.0, 989e12) == pytest.approx(1.0)


def test_config_files_are_the_programs_configs():
    for name in ("phi3-mini-3.8b", "llava-next-mistral-7b"):
        cell = spec.load_cell(f"{name}.docqa")
        harness.port_config(cell.config)
        for bad in (dict(cell.config, head_dim=64),
                    dict(cell.config, sliding_window=2047)):
            with pytest.raises(ValueError):
                harness.port_config(bad)


def test_prefill_readers_count_every_prompt_a_step_prefilled():
    from types import SimpleNamespace
    mfu = spec.metric_reader("prefill_mfu")
    roofline = spec.metric_reader("flash_attention_roofline")
    cfg = spec.load_cell("phi3-mini-3.8b.docqa").config
    steps = [(0, "prefill", 0.0, 0.1, (100, 300)), (1, "prefill", 0.1,
                                                   0.2, (50,)),
             (0, "decode", 0.2, 0.3, (101, 301))]
    rec = SimpleNamespace(config=cfg, steps=steps, engines=[
        {"prefill_seconds": 2.0, "decode_seconds": 1.0}])
    flops = sum(counts.prefill_flops(cfg, n) for n in (100, 300, 50))
    assert mfu(rec) == pytest.approx(
        100.0 * flops / 2.0 / counts.PEAK_FLOPS_BF16)
    rec.trace = {"kernel_s": {"flash_attention_tc_kernel<6>": 0.5},
                 "steps": steps}
    two = [counts.flash_call(cfg, n) for n in (100, 300)]
    bound = 32 * (counts.bound_s(sum(b for b, _ in two),
                                 sum(f for _, f in two))
                  + counts.bound_s(*counts.flash_call(cfg, 50)))
    assert roofline(rec) == pytest.approx(100.0 * bound / 0.5)
