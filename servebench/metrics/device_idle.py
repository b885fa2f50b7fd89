"""Device: the share of the traced slice in which no operation ran on
the card (torch.profiler's device activity), in %."""


def read(record):
    tr = record.trace
    if tr is None or not tr["busy_s"] or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
