"""The slower cell's files: its configuration states x265's slower as the
port runs it, its options restore x265's table where the port's departs,
`reduced` names the two cuts, the cell runs the crowd mix on one chip
past the lookahead and a whole mini-GOP, and every per-layer metric it
lists reads a slower traced run's record."""
import json
import os

import pytest

from encbench import spec
from x265_tpu_torch.api.params import check_params

from encbench.tests.test_bench_slow import FIELDS

CELL = "slower_1080p.crowd"
NEW = "rqt_ms_per_frame"


def test_slower_config_states_the_preset_as_run():
    cfg = spec._load("configs", "slower_1080p")
    # the Encoder applies check_params: rc-lookahead 40 clamps to 32, the
    # coerced tools go off
    p = check_params(spec.params(cfg))
    assert cfg["preset"] == "slower"
    for k, v in {**cfg["implied"], **cfg["options"]}.items():
        assert getattr(p, FIELDS[k]) == v, k
    # x265's slower (presets table): ref 5, psy-rdoq 1.0, 4 merge
    # candidates; the port's table gives ref 5, psy-rdoq 0.0 and 5
    assert (p.ref, p.psy_rdoq, p.max_merge) == (4, 1.0, 4)
    assert {"ref", "psy-rdoq", "max-merge"} <= set(cfg["options"])
    assert sorted(cfg["reduced"]) == ["rc-lookahead", "ref"]
    assert set(cfg["reduced_why"]) == set(cfg["reduced"])
    assert (p.rect, p.amp, p.weightb, p.tu_intra_depth) == \
        (False, False, False, 1)
    b = {c["name"]: c for c in spec.benchmark()["configs"]}["slower_1080p"]
    assert (b["source"], b["reduced"]) == (cfg["source"], cfg["reduced"])


def test_slower_cell_runs_the_crowd_mix_on_one_chip():
    c = spec.load_cell(CELL)
    implied = c["config_spec"]["implied"]
    assert c["traffic"] == "crowd" and "start" not in c.get("window", {})
    wu = c["warmup"]
    # past the lookahead and the B pictures, and one whole mini-GOP out
    assert wu["pictures"] >= implied["rc-lookahead"] + implied["bframes"]
    assert wu["min_aus"] >= implied["bframes"] + 1
    assert c["trace"]["pictures"] >= 2 * (implied["bframes"] + 1)
    assert spec.chips(CELL) == 1
    assert NEW in spec.metric_names(CELL, "per_layer", ())
    for other in ("medium_1080p.crowd", "live_1080p.cuts",
                  "slow_1080p.crowd"):
        assert NEW not in spec.metric_names(other, "per_layer", ())
    # every metric the slow cell reports, the slower cell reports too
    assert set(spec.metric_names("slow_1080p.crowd", "per_layer", ())) < \
        set(spec.metric_names(CELL, "per_layer", ()))
    assert "kbps" in spec.metric_names(CELL, "end_to_end", ())


@pytest.mark.parametrize("name", spec.metric_names(CELL, "per_layer", ()))
def test_slower_cell_readers_read_a_slower_record(name):
    """Every per-layer metric the slower cell lists reads a slower traced
    run's record (traced_record_slower.json)."""
    with open(os.path.join(os.path.dirname(__file__),
                           "traced_record_slower.json")) as f:
        rec = json.load(f)
    v = spec.reader(name)(rec)
    assert v is not None and v > 0
    if name.endswith(("_share", "_roofline")):
        assert v < 100
