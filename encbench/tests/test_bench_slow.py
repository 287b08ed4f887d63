"""The slow cell's files: its configuration states what the port's slow
preset gives and where its options restore x265's table, its two readers find nothing in a record without their
stage, and its plain reference loads nothing of the port."""
import json
import os
import subprocess
import sys

import pytest

from encbench import guard, spec

NEW = ("rdoq_ms_per_frame", "dense_search_ms_per_frame")
STAGE = {"rdoq_ms_per_frame": "rdoq", "dense_search_ms_per_frame": "me.dense"}
# the configuration's x265 option names -> the port's Param fields
FIELDS = {"bframes": "bframes", "b-adapt": "b_adapt",
          "b-pyramid": "b_pyramid", "rc-lookahead": "rc_lookahead",
          "ref": "ref", "rd": "rd_level", "rdoq-level": "rdoq_level",
          "subme": "sub_me", "me": "me_method", "merange": "me_range",
          "tu-inter-depth": "tu_inter_depth",
          "tu-intra-depth": "tu_intra_depth", "aq-mode": "aq_mode",
          "cutree": "cu_tree", "weightp": "weightp", "deblock": "deblock",
          "sao": "sao", "keyint": "keyint", "scenecut": "scenecut",
          "ctu": "ctu_size", "max-merge": "max_merge",
          "psy-rdoq": "psy_rdoq", "bitrate": "bitrate"}


def test_slow_config_states_the_ports_preset():
    cfg = spec._load("configs", "slow_1080p")
    p = spec.params(cfg)
    assert cfg["preset"] == "slow" and cfg["reduced"] == []
    for k, v in {**cfg["implied"], **cfg["options"]}.items():
        assert getattr(p, FIELDS[k]) == v, k
    # x265's slow (presets table): psy-rdoq 1.0, tu-inter-depth 1 (the
    # explicit inter RQT from slower), 3 merge candidates
    assert set(cfg["departures"]) >= {"psy-rdoq", "tu-inter-depth",
                                      "max-merge"}
    assert (p.psy_rdoq, p.tu_inter_depth, p.max_merge) == (1.0, 1, 3)


def test_slow_cell_runs_the_crowd_mix_on_one_chip():
    c = spec.load_cell("slow_1080p.crowd")
    assert c["traffic"] == "crowd" and "start" not in c.get("window", {})
    wu = c["warmup"]
    assert wu["pictures"] >= c["config_spec"]["implied"]["rc-lookahead"] \
        + c["config_spec"]["implied"]["bframes"] and wu["min_aus"] >= 8
    assert spec.chips("slow_1080p.crowd") == 1
    for n in NEW:
        assert spec.metric_names("slow_1080p.crowd", "per_layer", ()) \
            .count(n) == 1
        assert n not in spec.metric_names("medium_1080p.crowd",
                                          "per_layer", ())


@pytest.mark.parametrize("name", NEW)
def test_new_reader_needs_its_stage(name):
    with open(os.path.join(os.path.dirname(__file__),
                           "traced_record.json")) as f:
        medium = json.load(f)
    assert spec.reader(name)(medium) is None
    rec = dict(medium, stages=dict(medium["stages"], **{STAGE[name]: 2.5}))
    assert spec.reader(name)(rec) == pytest.approx(
        2.5e3 / medium["pictures"])


def test_slow_reference_loads_nothing_of_the_port():
    assert guard.reference_imports_port() == []
    code = ("import sys; import encbench.reference.rdoq, "
            "encbench.reference.rqt, encbench.reference.dense; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'x265_tpu_torch', 'x265_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize(
    "name", spec.metric_names("slow_1080p.crowd", "per_layer", ()))
def test_slow_cell_readers_read_a_slow_record(name):
    """Every per-layer metric the slow cell lists reads a slow traced
    run's record (traced_record_slow.json)."""
    with open(os.path.join(os.path.dirname(__file__),
                           "traced_record_slow.json")) as f:
        rec = json.load(f)
    v = spec.reader(name)(rec)
    assert v is not None and v > 0
    if name.endswith(("_share", "_roofline")):
        assert v < 100
