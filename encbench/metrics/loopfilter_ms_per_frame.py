"""Loop filter (models/loopfilter.py, hevc/sao.py): stages loopfilter +
sao_analyze, ms a coded picture."""
from encbench.metrics import stage_ms_per_picture


def read(record):
    return stage_ms_per_picture(record, ("loopfilter", "sao_analyze"))
