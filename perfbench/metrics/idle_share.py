"""idle_share: percent of the traced window in which no operation ran on the
device: 100 (1 - busy / window), both from the same profiler trace (busy:
the union of the device's activity intervals)."""


def read(obs):
    tr = obs.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
