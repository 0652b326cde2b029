"""device_idle_pct.*: the share of the traced window's seconds (host clock)
in which no kernel, copy or set ran on the device, in %."""


def read(w):
    t = w.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
