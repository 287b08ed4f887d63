"""RD passes (models/rdo.py, models/intra_rdo.py): stages rd_adopt +
rd_promote, ms a coded picture."""
from encbench.metrics import stage_ms_per_picture


def read(record):
    return stage_ms_per_picture(record, ("rd_adopt", "rd_promote"))
