"""Writer (native/slice_writer.cpp via the finalize stage), ms a coded
picture."""
from encbench.metrics import stage_ms_per_picture


def read(record):
    return stage_ms_per_picture(record, ("finalize",))
