"""K1 (fast) or K5 (exact): the least time of the window's chaining
launches (vgbench/work) over their device time in the trace, in %."""


def read(record):
    t = record["kernel_s"].get("chain", 0.0)
    w = record["work"].get("chain", {})
    if t <= 0 or not w.get("launches"):
        return None
    return 100.0 * w["bound_s"] / t
