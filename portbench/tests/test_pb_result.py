"""The form of a run's result and the command's refusals."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import spec
from portbench.harness import run_cell
from portbench.tests.tiny import tiny_cell

ROOT = spec.ROOT


def test_result_fields_and_order():
    cell = tiny_cell("cogvideox-5b.train-dpo")
    out = run_cell(cell, 2**31 + 77, 0.05, False, "cpu", time.perf_counter(), log=lambda m: None)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    json.loads(json.dumps(out))
    e2e = {m["name"]: m["unit"] for m in cell.end_to_end}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == e2e
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 3
    assert out["attempted"] >= 1 and out["failed"] == 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
        spec.metric_readers(cell)


def _run(args, cwd, tmp_path):
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-B", "-m", "portbench.run", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_no_card_exits_without_a_result(tmp_path):
    res = _run(["--workload", "cogvideox-5b.train-dpo", "--seed", "3", "--seconds", "1",
                "--trace", "0"], ROOT, tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_benchmark_files_alone_exit_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(["--workload", "cogvideox-5b.train-dpo", "--seed", "3", "--seconds", "1",
                "--trace", "0"], tmp_path, tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_unknown_workload_is_refused(tmp_path):
    res = _run(["--workload", "no-such-cell", "--seed", "3", "--seconds", "1"], ROOT, tmp_path)
    assert res.returncode == 2 and res.stdout.strip() == ""
