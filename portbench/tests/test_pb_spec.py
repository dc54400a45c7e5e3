"""Cells, configurations, mixes and metrics are found by name, and a
throwaway cell added as files is picked up without an edit."""

import json
import shutil

import pytest

from portbench import spec

ROOT = spec.ROOT


def test_every_cell_resolves():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert spec.driver(cell.traffic["kind"]).Driver
        assert set(cell.limits), f"{w['name']} has no limits"
        for name in spec.metric_readers(cell):
            assert any(m["name"] == name for m in bench["per_layer"])


def test_per_layer_metrics_name_their_cells_and_layer():
    bench = spec.load_benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_a_throwaway_cell_added_as_files_is_found(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    mix = json.loads((ROOT / "portbench" / "traffic" / "train-dpo.json").read_text())
    mix["check_steps"] = 4
    (tmp_path / "portbench" / "traffic" / "zz-mix.json").write_text(json.dumps(mix))
    (tmp_path / "portbench" / "metrics" / "zz_metric.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx['units'] else None\n")
    (tmp_path / "portbench" / "limits" / "cogvideox-5b.zz-mix.json").write_text(
        json.dumps({"loss_rel": {"limit": 0.5}}))
    bench["workloads"].append({"name": "cogvideox-5b.zz-mix", "config": "cogvideox-5b",
                               "traffic": "zz-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "zz_metric", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "train_pair_ms",
                               "workloads": ["cogvideox-5b.zz-mix"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_pair_ms":
            m["workloads"].append("cogvideox-5b.zz-mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("cogvideox-5b.zz-mix", root=tmp_path)
    assert cell.traffic["check_steps"] == 4
    assert cell.limits == {"loss_rel": {"limit": 0.5}}
    readers = spec.metric_readers(cell)
    assert list(readers) == ["zz_metric"]
    assert readers["zz_metric"]({"units": 1}) == 42.0


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell("no-such-cell")
