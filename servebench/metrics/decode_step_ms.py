"""Engine scheduler (serving/engine.py): host milliseconds a decode
step, ``decode_seconds / decode_steps`` over every replica (each step
ends with its tokens read back)."""


def read(record):
    n = sum(e["decode_steps"] for e in record.engines)
    s = sum(e["decode_seconds"] for e in record.engines)
    return 1e3 * s / n if n else None
