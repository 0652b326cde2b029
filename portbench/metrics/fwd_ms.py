"""fwd_ms.*: the device ms a step of the kernels, copies and sets launched
while the program was in the span ``train.forward`` (the target, the context
encoder, the predictor and the loss), from the third traced pass
(``phases.py``); nothing where the program records no spans or over 1% of
that pass's device time found no launch."""

from portbench import phases


def read(w):
    return phases.device_ms(w, "train.forward")
