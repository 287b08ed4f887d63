"""Lookahead and slice-type search (engine/lookahead.py): stages lookahead
+ slicetype, ms a coded picture."""
from encbench.metrics import stage_ms_per_picture


def read(record):
    return stage_ms_per_picture(record, ("lookahead", "slicetype"))
