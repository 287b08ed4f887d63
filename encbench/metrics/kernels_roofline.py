"""The five hand-written kernels' (csrc/*.cu) share of their roofline in
the traced segment: the sum of every launch's bound (encbench.roofline,
from the launch's shapes) over the sum of their device time, in %."""


def read(record):
    t = record.get("trace") or {}
    if not t.get("ours_device_s") or not t.get("bound_s"):
        return None
    return 100.0 * t["bound_s"] / t["ours_device_s"]
