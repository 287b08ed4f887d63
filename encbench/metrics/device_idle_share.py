"""Share of the traced segment in which no operation ran on the device:
1 - (union of the device's operation intervals) / (segment), in %."""


def read(record):
    t = record.get("trace") or {}
    if not t.get("window_s") or "busy_s" not in t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
