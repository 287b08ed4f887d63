"""Each per-layer reader on a traced run's record, and the roofline's
arithmetic."""
import json
import os

import pytest
import torch

from encbench import roofline, spec

RECORD = os.path.join(os.path.dirname(__file__), "traced_record.json")


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


@pytest.mark.parametrize("name", spec.all_readers())
def test_reader_reads_the_record(name, record):
    v = spec.reader(name)(record)
    assert v is not None and v > 0
    if name.endswith("_share"):
        assert v < 100


@pytest.mark.parametrize("name", spec.all_readers())
def test_reader_without_its_source_returns_nothing(name):
    assert spec.reader(name)({"pictures": 0, "stages": {}, "trace": {}}) \
        is None


def test_stage_readers_divide_by_pictures(record):
    st = record["stages"]
    want = 1e3 * (st["rd_adopt"] + st["rd_promote"]) / record["pictures"]
    assert spec.reader("rd_ms_per_frame")(record) == pytest.approx(want)


def test_kernel5_argmin_at_the_calibrated_sad4_rate():
    cur = torch.zeros(544, 960, dtype=torch.int16)
    ref = torch.zeros(602, 1018, dtype=torch.int16)
    nbytes, ops = roofline.sad_sweep_argmin(cur, ref, torch.zeros(59 * 59),
                                           8, 29)
    bound_ms = roofline.bound_s(nbytes, ops) * 1e3
    # chip_smoke.py's sad4 bound of this launch is 0.03050 ms (the argmin's
    # compares add a little); its measured 0.07683 ms reads about 40%
    assert bound_ms == pytest.approx(0.03050, rel=0.03)
    assert 0.35 < bound_ms / 0.07683 < 0.45
