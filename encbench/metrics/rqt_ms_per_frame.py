"""The explicit inter RQT (models/inter_residual: the 16 and 32 classes'
quadrant chains and _rqt_split, tu-inter-depth 2): stage rqt, ms a coded
picture."""
from encbench.metrics import stage_ms_per_picture


def read(record):
    return stage_ms_per_picture(record, ("rqt",))
