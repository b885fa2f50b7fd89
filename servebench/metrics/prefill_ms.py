"""Engine scheduler (serving/engine.py): host milliseconds a prefill,
``prefill_seconds / prefill_count`` over every replica (each prefill
ends with its first token read back)."""


def read(record):
    n = sum(e["prefill_count"] for e in record.engines)
    s = sum(e["prefill_seconds"] for e in record.engines)
    return 1e3 * s / n if n else None
