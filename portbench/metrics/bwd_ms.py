"""bwd_ms.*: the device ms a step launched in the span ``train.backward``
(the backward pass with remat's recompute), from the third traced pass
(``phases.py``); silent as ``fwd_ms``."""

from portbench import phases


def read(w):
    return phases.device_ms(w, "train.backward")
