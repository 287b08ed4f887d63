"""Per-layer metric readers: one module a metric, each with
``read(record) -> float | None``. The record of a traced run holds
``pictures`` (coded in the timed window), ``stages`` (seconds of each
stage scope over that window, every scope ending in a device
synchronise) and ``trace`` (encbench.trace.read_profile of the traced
segment, with ``bound_s``, the hand-written kernels' summed bounds).
A reader that finds nothing to read returns None."""


def stage_ms_per_picture(record, names):
    stages = record.get("stages") or {}
    if not record.get("pictures") or not any(n in stages for n in names):
        return None
    return 1e3 * sum(stages.get(n, 0.0) for n in names) / record["pictures"]
