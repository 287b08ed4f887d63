"""Motion search (engine/me.py): stage motion, ms a coded picture."""
from encbench.metrics import stage_ms_per_picture


def read(record):
    return stage_ms_per_picture(record, ("motion",))
