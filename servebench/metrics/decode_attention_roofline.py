"""Kernel decode_attention (kernels/decode_attention.py,
csrc/decode_attention.cu, three launches a call): over the traced
slice's decode steps, the sum of each call's bound for the live slots
(their cached keys and values read once, one call a layer) over the
device time of the three decode kernels, in %."""
from servebench import counts

KERNELS = ("decode_logits", "decode_pv", "decode_combine")


def read(record):
    tr = record.trace
    if tr is None:
        return None
    t = sum(s for n, s in tr["kernel_s"].items()
            if any(k in n for k in KERNELS))
    keys = [info for _, kind, _, _, info in tr["steps"] if kind == "decode"]
    if not t or not keys:
        return None
    layers = record.config["num_hidden_layers"]
    bound = sum(layers * counts.bound_s(*counts.decode_call(record.config,
                                                             k))
                for k in keys)
    return 100.0 * bound / t
