"""h2d_ms.*: the device time a call of host-to-device copies (``Memcpy HtoD``
in the traced window), in ms."""


def read(w):
    return None if w.trace is None else 1e3 * w.trace["htod_s"]
