"""Load generator and runtime loop (core/client.py, core/balancer.py,
core/runtime.py): the 90th percentile of how late each request reached
its engine after it was due (the runtime recorder's latency less the
engine's own), in ms."""
from servebench import e2e


def read(record):
    lags = [e2e.lag(r) for r in record.served.values()]
    return 1e3 * e2e.percentile(lags, 0.9) if lags else None
