"""Residual (models/inter_residual.py, models/residual.py): stage
tpu_residual, ms a coded picture."""
from encbench.metrics import stage_ms_per_picture


def read(record):
    return stage_ms_per_picture(record, ("tpu_residual",))
