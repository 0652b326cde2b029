"""h2d_host_gbps.*: the host bytes the program handed to the device (its
counter ``h2d_bytes``) over the host seconds of the spans ``train.h2d``, in
GB/s (1e9 bytes), from the third traced pass (``phases.py``)."""

from portbench import phases


def read(w):
    return phases.h2d_host_gbps(w)
