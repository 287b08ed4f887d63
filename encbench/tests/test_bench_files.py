"""Every configuration, mix and cell file loads, and BENCHMARK.json names
only what the harness finds by name."""
import json
import os

import pytest

from encbench import frames, spec

HERE = spec.HERE


def names(kind):
    return sorted(f[:-5] for f in os.listdir(os.path.join(HERE, kind))
                  if f.endswith(".json"))


@pytest.mark.parametrize("cell", names("cells"))
def test_cell_loads(cell):
    c = spec.load_cell(cell)
    assert c["config_spec"]["width"] % 8 == 0
    want = {"unparsed_aus", "recon_mismatch", "analysis_gap"}
    if "vbv-maxrate" in c["config_spec"]["options"]:
        want.add("vbv_underflows")
    assert set(c["limits"]) == want
    assert min(c["check"].values()) >= 1
    assert set(c["check"]) == {"pictures", "rate_pictures", "analysis_sample"}
    assert frames.feed(c["traffic_spec"])


@pytest.mark.parametrize("config", names("configs"))
def test_config_builds_params(config):
    cfg = spec._load("configs", config)
    p = spec.params(cfg)
    assert (p.width, p.height) == (cfg["width"], cfg["height"])
    a = cfg["analysis"]
    assert (p.psy_rd, p.fast_intra) == (a["psy_rd"], a["fast_intra"])
    assert p.bit_depth == cfg["bit_depth"]


def test_benchmark_json_names_what_exists():
    b = spec.benchmark()
    assert b, "BENCHMARK.json is missing"
    cells = set(names("cells"))
    for w in b["workloads"]:
        c = spec.load_cell(w["name"])
        assert w["name"] in cells
        assert (w["config"], w["traffic"]) == (c["config"], c["traffic"])
        assert w["chips"] == 1
    for c in b["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
    readers = set(spec.all_readers())
    for m in b["per_layer"]:
        assert m["name"] in readers
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    from encbench.run import E2E_UNITS
    for m in b["end_to_end"]:
        assert E2E_UNITS[m["name"]] == m["unit"]
    assert json.dumps(b)
