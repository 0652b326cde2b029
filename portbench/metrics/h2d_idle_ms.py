"""h2d_idle_ms.*: the device's idle ms a step while the host was in the span
``train.h2d``, copying and casting the host batch, from the third traced
pass (``phases.py``)."""

from portbench import phases


def read(w):
    return phases.idle_ms(w, "train.h2d")
