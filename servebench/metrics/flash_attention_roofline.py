"""Kernel flash_attention (kernels/flash_attention.py,
csrc/flash_attention.cu): over the traced slice's prefills, the sum of
each call's bound (the larger of its bytes over the memory rate and its
FLOPs over the bf16 rate, counted from the prompts' own lengths, one
call a layer; a step that prefills several prompts is one call over
them all) over the device time of the flash kernels, in %."""
from servebench import counts


def read(record):
    tr = record.trace
    if tr is None:
        return None
    t = sum(s for n, s in tr["kernel_s"].items() if "flash_attention" in n)
    lens = [info for _, kind, _, _, info in tr["steps"] if kind == "prefill"]
    if not t or not lens:
        return None
    layers = record.config["num_hidden_layers"]
    bound = 0.0
    for step in lens:
        calls = [counts.flash_call(record.config, n) for n in step]
        bound += layers * counts.bound_s(sum(c[0] for c in calls),
                                         sum(c[1] for c in calls))
    return 100.0 * bound / t
