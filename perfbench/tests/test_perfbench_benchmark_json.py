"""`BENCHMARK.json` keeps to the benchmark's contract, and every name in it
is found as a file under `perfbench/`."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert B["command"] == ["python3", "perfbench/run.py"] and B["paths"] == ["perfbench"]
    assert 1 <= B["run_seconds"] <= 51
    n = len(B["workloads"])
    assert 1 <= len(B["configs"]) <= 24 and 1 <= n <= 24
    assert 1 <= len(B["end_to_end"]) <= 16 and 1 <= len(B["per_layer"]) <= 128
    # a full check of 24 cells fits its time
    assert 2 + 14 * 24 * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, n // 4)


def test_names_units_and_texts_use_the_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group if group in ("configs", "workloads") else "metric", e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and not (group == "per_layer" and k == "source"):
                    assert TEXT.match(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in B["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert all(TEXT.match(word) for word in B["command"])


def test_entries_have_just_their_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_configs_files_state_what_the_cells_run():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert c["name"] in used
        f = ROOT / c["file"]
        assert f.is_relative_to(ROOT / "perfbench") and f == ROOT / "perfbench" / "configs" / f"{c['name']}.json"
        cfg = json.loads(f.read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) <= set(cfg["source_values"])
    assert len({c["source"] for c in B["configs"]}) == len(B["configs"])


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    from perfbench import harness
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in B["end_to_end"])
    for w in B["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "perfbench" / "drivers" / f"{cell.traffic['driver']}.py").exists()
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in B["end_to_end"] + B["per_layer"]])
def test_every_metric_has_its_reader_and_its_cells_report_what_it_moves(metric):
    assert (ROOT / "perfbench" / "metrics" / f"{metric}.py").exists()
    e2e = {m["name"]: m for m in B["end_to_end"]}
    cells = {w["name"] for w in B["workloads"]}
    m = next(m for m in B["end_to_end"] + B["per_layer"] if m["name"] == metric)
    assert set(m.get("workloads", cells)) <= cells
    if "moves" in m:
        moved = e2e[m["moves"]]
        assert "workloads" in m
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    layers = {}
    for p in B["per_layer"]:
        layers.setdefault(p["layer"].lower(), set()).add(p["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_shares_of_a_peak_are_per_cent():
    for m in B["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"] or "share" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
