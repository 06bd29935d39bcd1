"""BENCHMARK.json against the contract it is written to: the names and
units use only the allowed characters, every configuration, traffic mix,
limit and metric reader is found by name (a reader by the name's stem), and every cell that reports a
per-layer metric also reports the end-to-end metric it moves."""
import json
import re
from pathlib import Path

import pytest

from h100_bench.harness import cell_metrics, reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["h100_bench"]
    assert all(_line(w) for w in MANIFEST["command"])
    assert MANIFEST["command"][1].startswith("h100_bench/")
    assert 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells at this run length fits in 43,200 s
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in MANIFEST["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_configurations():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("h100_bench/configs/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] == []
        assert _line(c["source"]) and _line(c["why"])
        assert (ROOT / conf["yaml"]).exists()


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_by_name(cell):
    w = {x["name"]: x for x in MANIFEST["workloads"]}[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and _line(w["why"])
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert traffic["loop"] in ("train", "sliding_window_eval")
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
    e2e = [m["name"] for m in cell_metrics(MANIFEST, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = cell_metrics(MANIFEST, cell, True)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_end_to_end_metrics():
    names = [m["name"] for m in MANIFEST["end_to_end"]]
    assert "setup_s" in names
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_per_layer_metrics():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= set(CELLS)
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(layers) >= 5


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_each_metric_has_its_reader(metric):
    module = reader(metric)
    assert callable(module.read)
    stem = Path(module.__file__).stem
    assert metric == stem or metric.startswith(stem + ".")


def test_every_reader_reads_some_metric():
    used = {Path(reader(m["name"]).__file__).name for m in METRICS}
    assert used == {f.name for f in (BENCH / "metrics").glob("*.py")}
