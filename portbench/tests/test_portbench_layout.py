"""The harness is driven by data: a cell, a configuration or a metric
dropped in as a new file is found by its name, and BENCHMARK.json keeps
to the contract's names, units and keys."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

CHECKOUT = Path(__file__).resolve().parents[2]
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def copy(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(harness.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def test_new_files_found_by_name(copy):
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    cfg = json.loads((copy / "configs" / "msp_ecorr_8k.json").read_text())
    cfg["toas"]["nepoch"] = 256
    (copy / "configs" / "msp_ecorr_16k.json").write_text(json.dumps(cfg))
    cell = json.loads((copy / "cells" / "msp_ecorr_8k.dense.json")
                      .read_text())
    cell["config"] = "msp_ecorr_16k"
    (copy / "cells" / "msp_ecorr_16k.dense.json").write_text(
        json.dumps(cell))
    (copy / "metrics" / "fits_in_window.py").write_text(
        "def read(run):\n    return run.counters['fits']\n")
    got = harness.load_cell("msp_ecorr_16k.dense", root=copy)
    assert got["config"]["toas"]["nepoch"] == 256
    assert got["config"]["name"] == "msp_ecorr_16k"
    read = harness.metric_reader("fits_in_window", root=copy)
    run = harness.Run(cell="x", ntoa=1, shape={}, full_cov=False,
                      counters={"fits": 7})
    assert read(run) == 7
    assert all(p.read_bytes() == b for p, b in before.items())


def test_every_cell_config_and_metric_has_its_file():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["why"] == w["why"]
    for c in BENCH["configs"]:
        assert (CHECKOUT / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text, text


def test_manifest_keys_and_bounds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    assert "setup_s" in e2e
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cell_metrics_follow_the_manifest():
    e2e = harness.cell_metrics(BENCH, "msp_ecorr_8k.dense", False)
    assert {m["name"] for m in e2e} == {"fit_toas_per_s", "setup_s"}
    layer = {m["name"] for m in harness.cell_metrics(
        BENCH, "msp_ecorr_8k.dense", True)}
    assert "factor_roofline" in layer and "gram_roofline" not in layer
