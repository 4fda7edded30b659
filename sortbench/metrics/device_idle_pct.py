"""Share (%) of the profiled calls' host interval in which no operation ran
on the device (busy time is the union of the operations' intervals)."""


def read(p):
    if p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
