"""mfu.*: the model FLOPs of the window's calls (``flops.py``) over the
window's seconds (untraced), as a share of the device's peak bf16 rate
(``peaks.json``), in %."""


def read(w):
    if not w.peaks:
        return None
    return 100.0 * sum(w.flops) / w.window_s / w.peaks["bf16_flops_per_s"]
