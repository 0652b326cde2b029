"""launch_idle_ms.*: the device's idle ms a step while the host was in the
spans ``train.forward``, ``train.backward`` or ``train.update``, dispatching
the step's work, from the third traced pass (``phases.py``)."""

from portbench import phases


def read(w):
    return phases.idle_ms(w, *phases.LAUNCH_PHASES)
