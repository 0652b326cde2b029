"""train_step_ms_p90: the 90th percentile of the window's train steps, each
timed by the host's clock from its start to its own sync, in ms (numpy's
linear interpolation between order statistics)."""

import numpy as np


def read(w):
    return float(np.percentile(np.asarray(w.call_s) * 1e3, 90))
