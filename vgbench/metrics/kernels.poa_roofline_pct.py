"""K6/K8 (abPOA) or K7/K9 (rspoa): the least time of the window's POA
launches (vgbench/work) over their device time in the trace, in %."""


def read(record):
    t = record["kernel_s"].get("poa", 0.0)
    w = record["work"].get("poa", {})
    if t <= 0 or not w.get("launches"):
        return None
    return 100.0 * w["bound_s"] / t
