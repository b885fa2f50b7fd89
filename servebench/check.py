"""Is what the timed path served correct?

After the window: every request due in it has to have been served, with
the sizes it was sent with.  Then a sample of the served requests, drawn
from the seed and always holding the longest one, until it holds
``check.tokens`` served tokens, is compared with the plain f32
reference (``reference/model.py``): the reference reads each prompt,
drawn again from the seed, with the tokens the program served after it,
and the number compared is the widest gap by which a served token's
logit lies below the reference's best logit at its position (greedy
decoding serves the best token; bf16 rounding may serve a near-tie).
``check.max_logit_gap`` is its limit, set from the program's readings
over a dozen seeds and the fp8 control's (``tools/limits.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from servebench import traffic as TR
from servebench.reference import model as M

_SAMPLE_STREAM = 0xC4EC


def sample(record, seed: int, tokens: int) -> list[int]:
    """Request ids to compare: the longest served one (prompt and
    answer), then others in an order drawn from the seed, until the
    served tokens reach ``tokens``."""
    rids = sorted(record.served)
    if not rids:
        return []
    arr = record.arrivals
    longest = max(rids, key=lambda r: (arr[r].prompt + arr[r].new, -r))
    rest = [r for r in rids if r != longest]
    order = np.random.default_rng([seed, _SAMPLE_STREAM]).permutation(
        len(rest))
    out, n = [longest], len(record.tokens[longest])
    for i in order:
        if n >= tokens:
            break
        out.append(rest[i])
        n += len(record.tokens[rest[i]])
    return out


def compare(config: dict, params: dict, record, seed: int, rids,
            device, control: bool = False) -> dict:
    """The widest gap over the sampled requests' served tokens; with
    ``control``, also the widest gap of the token the fp8 reference puts
    first at each of those positions."""
    prompts = TR.prompts(seed, config["vocab_size"], record.arrivals)
    worst = ctrl = 0.0
    n = 0
    for rid in rids:
        served = torch.tensor(record.tokens[rid], device=device)
        prompt = torch.from_numpy(prompts[rid]).to(device)
        seq = torch.cat([prompt, served[:-1]])
        start = prompt.numel() - 1
        ref = M.logits(config, params, seq, start)
        worst = max(worst, float(M.gaps(ref, served).max()))
        n += served.numel()
        if control:
            low = M.logits(config, params, seq, start, quant="fp8")
            ctrl = max(ctrl, float(M.gaps(ref, low.argmax(-1)).max()))
        del ref
    out = {"max_logit_gap": worst, "tokens_compared": n}
    if control:
        out["control_max_logit_gap"] = ctrl
    return out


def verdict(cell, params: dict, record, seed: int,
            device) -> tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit"}}) in the order printed."""
    got = compare(cell.config, params, record, seed,
                  sample(record, seed, cell.check["tokens"]), device)
    return decide(cell, record, got)


def decide(cell, record, got: dict) -> tuple[bool, dict]:
    """The verdict on a run's record and the comparison's reading
    ``got`` (``max_logit_gap``, ``tokens_compared``): the program's, or
    the control's put in its place (``tools/limits.py``)."""
    lim = cell.check
    arr = record.arrivals
    unserved = sum(1 for r in range(len(arr)) if r not in record.served)
    wrong_size = sum(1 for r, (p, k) in record.sizes.items()
                     if r >= len(arr) or (p, k) != (arr[r].prompt, arr[r].new)
                     or len(record.tokens[r]) != arr[r].new)
    numbers = {
        "unserved": {"value": unserved, "limit": 0},
        "wrong_sizes": {"value": wrong_size, "limit": 0},
        "tokens_compared": {"value": got["tokens_compared"],
                            "limit": lim["tokens"]},
        "max_logit_gap": {"value": got["max_logit_gap"],
                          "limit": lim["max_logit_gap"]},
    }
    ok = (unserved == 0 and wrong_size == 0 and len(arr) > 0
          and got["tokens_compared"] >= lim["tokens"]
          and got["max_logit_gap"] <= lim["max_logit_gap"])
    return ok, numbers
