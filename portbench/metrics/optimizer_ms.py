"""optimizer_ms.*: the device ms a step launched in the span ``train.update``
(the gradients' all-reduce, norms and clip, AdamW and the EMA), from the
third traced pass (``phases.py``); silent as ``fwd_ms``."""

from portbench import phases


def read(w):
    return phases.device_ms(w, "train.update")
