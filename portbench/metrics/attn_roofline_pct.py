"""attn_roofline_pct.*: the least time of a call's attention work
(``flops.py``, at the device's peaks) over the device time a call of the
kernels of the class ``attention`` in ``kernels.json``, from the traced
window, in %. Nothing where the program's launch counts differ from the calls
the model makes, or no such kernel ran."""


def read(w):
    t = w.trace
    if t is None or not t["launches_ok"] or t["attn_least_s"] is None:
        return None
    spent = t["classes"].get("attention", 0.0)
    return 100.0 * t["attn_least_s"] / spent if spent > 0 else None
