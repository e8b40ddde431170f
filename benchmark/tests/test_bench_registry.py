"""Every cell, configuration, traffic mix, driver and metric of
``BENCHMARK.json`` is found by name, and a new cell, configuration and
metric run as new files alone."""
from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path

import pytest

from benchmark import run
from benchmark.tests import tiny

HERE = Path(run.__file__).resolve().parent
SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_are_found_by_name(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    wl, cfg, traffic = run.cell_spec(cell)
    assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert cfg["name"] == wl["config"]
    assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    assert all(isinstance(v, (int, float)) for v in wl["limits"].values())


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_are_found_by_name(config):
    cfg = json.loads((HERE.parent / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    assert cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"]


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_are_found_by_name(metric):
    reader = run.load_module("metrics", metric["name"])
    assert reader.read({"e2e": [], "trace": None}) is None
    for cell in metric["workloads"]:
        units = run.cell_metrics(cell, "per_layer")
        assert units[metric["name"]] == metric["unit"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_units_come_from_the_spec(cell):
    units = run.cell_metrics(cell, "end_to_end")
    assert units["setup_s"] == "s" and len(units) >= 2
    assert units == {m["name"]: m["unit"] for m in SPEC["end_to_end"]
                     if cell in m.get("workloads", [cell])}


def test_a_cell_config_and_metric_added_as_files_alone(tmp_path):
    """New files, and new entries in ``BENCHMARK.json``: no file that is
    there changes."""
    copy = tmp_path / "benchmark"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append(dict(spec["workloads"][0], name="tiny-serve"))
    for m in spec["end_to_end"]:
        if "lv60-serve-songs" in m.get("workloads", []):
            m["workloads"].append("tiny-serve")
    spec["per_layer"].append({
        "name": "requests_traced", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "serving pipeline",
        "moves": "serve_rtfx", "workloads": ["tiny-serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cfg = json.loads((copy / "configs" / "lv60-amt.json").read_text())
    cfg.update(tiny.TINY, name="lv60-amt-tiny", num_conv_pos_embeddings=16)
    (copy / "configs" / "lv60-amt-tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((copy / "traffic" / "serve-songs.json").read_text())
    traffic.update(tiny.SERVE)
    (copy / "traffic" / "serve-songs-tiny.json").write_text(json.dumps(traffic))
    wl = json.loads((copy / "workloads" / "lv60-serve-songs.json").read_text())
    wl.update(config="lv60-amt-tiny", traffic="serve-songs-tiny")
    (copy / "workloads" / "tiny-serve.json").write_text(json.dumps(wl))
    (copy / "metrics" / "requests_traced.py").write_text(
        'def read(rec):\n    return len(rec["traced"])\n')
    module = importlib.util.spec_from_file_location("copied_run",
                                                    copy / "run.py")
    copied = importlib.util.module_from_spec(module)
    module.loader.exec_module(copied)
    result, checks, _ = copied.run_cell("tiny-serve", tiny.SEED, 0.5, 0,
                                        device="cpu")
    assert result["attempted"] > 0 and [c[0] for c in checks] == list(
        wl["limits"])
    assert result["metrics"]["serve_rtfx"]["unit"] == "audio_s/s"
    rec = {"traced": [1, 2], "e2e": ["serve_rtfx"], "trace": None}
    assert copied.read_metrics(rec, "tiny-serve")["requests_traced"] == (
        2, "count")
