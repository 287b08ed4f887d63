"""The dense integer search (engine/me._motion_fused stage 1: kernel 5's
full sweep with its mv cost, every reference): stage me.dense, ms a coded
picture."""
from encbench.metrics import stage_ms_per_picture


def read(record):
    return stage_ms_per_picture(record, ("me.dense",))
