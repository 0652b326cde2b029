"""setup_s: process start to the first timed call, in seconds (host clock):
building the program, making the weights and inputs, the kernels' build where
a checkout has none yet, and the warm-up calls."""


def read(w):
    return w.setup_s
