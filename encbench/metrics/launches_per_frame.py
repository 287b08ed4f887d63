"""Device kernels the profiler saw in the traced segment, a coded picture
of that segment."""


def read(record):
    t = record.get("trace") or {}
    if not t.get("pictures") or not t.get("kernels"):
        return None
    return t["kernels"] / t["pictures"]
