"""The plain reference against the program on the smoke configs: the
program's prefill of a prompt and its decode steps through the cache
give the logits the reference's one full pass gives, in f32."""
import pytest
import torch

from servebench import harness
from servebench.reference import model as M
from servebench.weights import Weights


def _setup(arch):
    from repro_torch.configs.base import get_config
    cfg = get_config(arch + "-smoke")
    file = {"hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.resolved_head_dim,
            "num_hidden_layers": cfg.num_layers,
            "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": 1e-6}
    w = Weights(harness.weight_specs(cfg, torch.float32), 5, "cpu")
    return cfg, file, w.tree()


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "llava-next-mistral-7b"])
def test_reference_matches_the_program(arch):
    from repro_torch.models import registry as R
    cfg, file, params = _setup(arch)
    g = torch.Generator().manual_seed(3)
    L, steps, bucket = 21, 6, 32
    prompt = torch.randint(0, cfg.vocab_size, (L,), generator=g)
    toks = torch.zeros((1, bucket), dtype=torch.int64)
    toks[0, :L] = prompt                       # padded, as the engine does
    logits, cache, _ = R.prefill(cfg, params, {"tokens": toks}, 64,
                                 lengths=torch.tensor([L]))
    got, seq = [logits[0]], prompt.tolist()
    nxt = torch.randint(0, cfg.vocab_size, (steps,), generator=g)
    for i in range(steps):
        seq.append(int(nxt[i]))
        lg, cache = R.decode_step(cfg, params, cache, nxt[i:i + 1],
                                  torch.tensor([L + i], dtype=torch.int32))
        got.append(lg[0])
    ref = M.logits(file, params, torch.tensor(seq), L - 1)
    got = torch.stack(got).float()
    # the program's decode cache holds K/V in bf16: a bf16 step of them
    tol = 2e-2 * ref.abs().max()
    assert (got - ref).abs().max() <= tol
    assert (got[:1] - ref[:1]).abs().max() <= 1e-4 * ref.abs().max()


def test_gaps_read_the_chosen_tokens_distance_below_the_best():
    ref = torch.tensor([[0.0, 2.0, 1.5], [3.0, -1.0, 2.0]])
    assert M.gaps(ref, torch.tensor([1, 2])).tolist() == [0.0, 1.0]


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3, 3, 101)[None, :]
    q = M._fp8(x, dim=-1)
    rel = ((q - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert 0 < rel.max() <= 2 ** -4 + 1e-6
