"""Finds a cell's files by name: ``cells/<workload>.json`` names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); ``BENCHMARK.json`` beside this package says
which metrics the cell reports, and ``metrics/<name>.py`` reads each
per-layer one."""
from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(kind, name):
    path = os.path.join(HERE, kind, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str) -> dict:
    """The cell with its configuration and mix filled in."""
    cell = _load("cells", workload)
    cell["name"] = workload
    cell["config_spec"] = _load("configs", cell["config"])
    cell["traffic_spec"] = _load("traffic", cell["traffic"])
    return cell


def benchmark() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def metric_names(workload: str, kind: str, default):
    """Names of the cell's metrics of one kind (end_to_end, per_layer),
    as BENCHMARK.json lists them; `default` where it is absent."""
    b = benchmark()
    if kind not in b:
        return list(default)
    return [m["name"] for m in b[kind] if applies(m, workload)]


def units(kind: str) -> dict:
    return {m["name"]: m["unit"] for m in benchmark().get(kind, [])}


def chips(workload: str) -> int:
    for w in benchmark().get("workloads", []):
        if w["name"] == workload:
            return int(w["chips"])
    return 1


def reader(metric: str):
    """metrics/<metric>.py's read(record) -> value or None."""
    return importlib.import_module(f"encbench.metrics.{metric}").read


def all_readers():
    d = os.path.join(HERE, "metrics")
    return sorted(f[:-3] for f in os.listdir(d)
                  if f.endswith(".py") and not f.startswith("_"))


def params(config: dict, width=None, height=None):
    """The port's Param for a configuration, as its CLI builds it: the
    preset and tune, then each option through param_parse."""
    from x265_tpu_torch.api.params import param_default_preset, param_parse
    p = param_default_preset(config["preset"], config.get("tune"))
    for k, v in config["options"].items():
        param_parse(p, k, str(v))
    p.width = width or config["width"]
    p.height = height or config["height"]
    p.fps_num, p.fps_den = config["fps"], 1
    return p
