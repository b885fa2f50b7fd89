"""Model step, prefill (models/registry.prefill -> transformer ->
layers, attention): the useful FLOPs of the run's prefills (each
prompt's own length, not its padded bucket: the products and causal
attention) over the replicas' prefill seconds, as a share of the bf16
peak, in %."""
from servebench import counts


def read(record):
    secs = sum(e["prefill_seconds"] for e in record.engines)
    lens = [info for _, kind, _, _, info in record.steps
            if kind == "prefill"]
    if not secs or not lens:
        return None
    flops = sum(counts.prefill_flops(record.config, n)
                for step in lens for n in step)
    return 100.0 * flops / secs / counts.PEAK_FLOPS_BF16
