"""Intra analysis (models/intra_frame.py): stage analysis, ms a coded
picture."""
from encbench.metrics import stage_ms_per_picture


def read(record):
    return stage_ms_per_picture(record, ("analysis",))
