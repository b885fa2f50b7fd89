"""Model step, decode (models/registry.decode_step): the useful FLOPs of
the live slots' decode tokens (the products and attention over each
slot's cache) over the replicas' decode seconds, as a share of the
bf16 peak, in %."""
from servebench import counts


def read(record):
    secs = sum(e["decode_seconds"] for e in record.engines)
    keys = [info for _, kind, _, _, info in record.steps
            if kind == "decode"]
    if not secs or not keys:
        return None
    flops = sum(counts.decode_flops(record.config, k)
                for step in keys for k in step)
    return 100.0 * flops / secs / counts.PEAK_FLOPS_BF16
