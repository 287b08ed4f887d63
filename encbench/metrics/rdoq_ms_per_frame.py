"""RDOQ (models/residual._rdoq_x64, every call: the inter residual, its
RQT quadrants and the RD passes): stage rdoq, ms a coded picture."""
from encbench.metrics import stage_ms_per_picture


def read(record):
    return stage_ms_per_picture(record, ("rdoq",))
