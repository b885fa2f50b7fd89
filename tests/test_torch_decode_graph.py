"""The engine's decode step as one CUDA graph, on the card, against the
eager step.

Every test here needs an NVIDIA GPU with the CUDA toolkit (``nvcc``) and
skips without one.  Run them on the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_decode_graph.py

A small config of each family the engine serves on one card, at the
head widths its attention kernel sees at full size: dense MHA at head
dim 96, GQA at 128, sliding-window rings (wrapped by prompts past the
window), MoE dispatch, Mamba and the Mamba/attention/MoE hybrid.  A
warmed engine (captured at the end of its warm-up) serves ragged
prompts with an idle slot throughout and slots reused by admissions
between two replays.  Before every decode step an eager
``registry.decode_step`` runs on copies of the engine's cache, tokens
and positions; after the replay the tokens, the positions and every
cache leaf must be bit-equal to the eager step's (the same kernels on
the same shapes and operands), and the replay must add to
``decode_attention.launches`` what the eager step added.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import decode_attention as D
from repro_torch.models import param as P
from repro_torch.models import registry as R
from repro_torch.serving.engine import InferenceEngine, make_warmed_engine

#: family -> (smoke arch, fields replaced)
FAMILIES = {
    "mha_hd96": ("phi3-mini-3.8b-smoke",
                 dict(num_heads=4, num_kv_heads=4, head_dim=96)),
    "gqa_hd128": ("llava-next-mistral-7b-smoke",
                  dict(num_heads=8, num_kv_heads=2, head_dim=128)),
    "swa_ring": ("gemma3-12b-smoke", dict(head_dim=128)),
    "moe_dispatch": ("deepseek-moe-16b-smoke", dict(head_dim=128)),
    "mamba": ("mamba2-1.3b-smoke", {}),
    "hybrid": ("jamba-1.5-large-398b-smoke", dict(head_dim=128)),
}
MAX_BATCH = 4
PROMPT_MAX, NEW_MAX = 40, 26
#: (decode steps done before the request is submitted, prompt, new
#: tokens): at most three requests at once, so slot 3 stays idle; the
#: last two take the slots of the first to finish
REQUESTS = ((0, 37, 26), (0, 5, 6), (0, 21, 12), (6, 29, 10), (12, 40, 8))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the decode step's graph and its "
                    "kernels run only there)")
    return torch.device("cuda")


def _model(family: str, device):
    arch, fields = FAMILIES[family]
    cfg = replace(get_config(arch), **fields)
    params = R.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    return cfg, params


def _eager_step(cfg, params, eng):
    """The eager decode step on copies of the engine's state -> (tokens,
    positions, cache)."""
    cache = P.tree_map(torch.clone, eng.cache)
    tokens, positions = eng.tokens.clone(), eng.positions.clone()
    logits, _ = R.decode_step(cfg, params, cache, tokens, positions)
    return torch.argmax(logits, dim=-1).to(torch.int32), positions + 1, cache


@pytest.mark.gpu
@pytest.mark.parametrize("family", list(FAMILIES))
def test_replayed_decode_step_is_the_eager_step(cuda, family):
    cfg, params = _model(family, cuda)
    eng = make_warmed_engine(cfg, params, max_batch=MAX_BATCH,
                             prompt_len=PROMPT_MAX, max_new_tokens=NEW_MAX)
    assert eng.decode_graph_captures == 1 and eng.decode_graph_replays == 0
    rng = np.random.default_rng(7)
    todo = list(enumerate(REQUESTS))
    done, steps = [], 0
    while todo or not eng.idle():
        while todo and eng.decode_steps >= todo[0][1][0]:
            rid, (_, n, new) = todo.pop(0)
            eng.submit(rng.integers(0, cfg.vocab_size, n), new, rid)
        decodes = not (eng.queue and None in eng.active) and eng.n_active()
        if decodes:
            n0 = D.decode_attention.launches
            tokens, positions, cache = _eager_step(cfg, params, eng)
            n1 = D.decode_attention.launches
        done += eng.step()
        if not decodes:
            continue
        steps += 1
        assert eng.active[MAX_BATCH - 1] is None
        assert torch.equal(eng.tokens, tokens), steps
        assert torch.equal(eng.positions, positions), steps
        want = dict(P.leaves(cache))
        for path, leaf in P.leaves(eng.cache):
            assert torch.equal(leaf, want[path]), (steps, path)
        assert D.decode_attention.launches - n1 == n1 - n0, steps
    assert sorted(c.req_id for c in done) == list(range(len(REQUESTS)))
    assert [len(c.tokens) for c in sorted(done, key=lambda c: c.req_id)] \
        == [new for _, _, new in REQUESTS]
    assert eng.prefill_count == len(REQUESTS)
    assert steps >= 24 and eng.decode_steps == steps
    assert eng.decode_graph_replays == eng.decode_steps
    assert eng.decode_graph_captures == 1


@pytest.mark.gpu
def test_engine_built_directly_captures_at_its_second_decode_step(cuda):
    cfg, params = _model("mha_hd96", cuda)
    eng = InferenceEngine(cfg, params, max_batch=2, max_len=64)
    eng.submit(np.arange(9) % cfg.vocab_size, 4, 0)
    eng.step()                                     # the prefill
    eng.step()                                     # eager
    assert (eng.decode_graph_captures, eng.decode_graph_replays) == (0, 0)
    tokens, positions, _ = _eager_step(cfg, params, eng)
    eng.step()                                     # captured, replayed
    assert (eng.decode_graph_captures, eng.decode_graph_replays) == (1, 1)
    assert torch.equal(eng.tokens, tokens)
    assert torch.equal(eng.positions, positions)
    assert len(eng.run_until_idle()) == 1
    assert eng.decode_graph_replays == eng.decode_steps - 1 == 2


@pytest.mark.gpu
def test_profiler_names_the_replayed_kernels(cuda):
    """The benchmark's traced runs sum device time by kernel name: the
    kernels inside a replay must reach ``torch.profiler`` as themselves."""
    cfg, params = _model("mha_hd96", cuda)
    eng = make_warmed_engine(cfg, params, max_batch=2, prompt_len=16,
                             max_new_tokens=8)
    eng.submit(np.arange(16) % cfg.vocab_size, 8, 0)
    eng.step()                                     # the prefill
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng.run_until_idle()
        torch.cuda.synchronize()
    assert eng.decode_graph_replays == eng.decode_steps == 7
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if str(e.device_type()).endswith("CUDA")]
    for kernel in ("decode_logits_kernel", "decode_pv_kernel"):
        assert sum(kernel in n for n in names) == \
            cfg.num_layers * eng.decode_steps, kernel
