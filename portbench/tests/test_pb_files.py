"""Every file of the benchmark is a plain regular file, and a run writes
nothing into ``portbench/``."""

import os
import shutil
import stat
import subprocess
import sys

import pytest

from portbench import spec

ROOT = spec.ROOT
BENCH = ROOT / "portbench"


def _walk(top):
    for dirpath, dirnames, filenames in os.walk(top, followlinks=False):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in dirnames + filenames:
            yield os.path.join(dirpath, name)


def test_every_entry_is_a_regular_file_or_a_directory():
    assert stat.S_ISREG(os.lstat(ROOT / "BENCHMARK.json").st_mode)
    bad = []
    for path in _walk(BENCH):
        mode = os.lstat(path).st_mode
        if not (stat.S_ISREG(mode) or stat.S_ISDIR(mode)):
            bad.append(path)
    assert not bad, f"not regular files: {bad}"


def test_git_records_only_plain_file_modes():
    if shutil.which("git") is None or not (ROOT / ".git").exists():
        pytest.skip("no git repository here")
    out = subprocess.run(["git", "ls-files", "-s", "portbench", "BENCHMARK.json"], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    modes = {line.split()[0] for line in out.splitlines() if line.strip()}
    assert modes <= {"100644", "100755"}, f"git modes {modes}: no link or submodule allowed"


def test_paths_hold_only_the_benchmark():
    bench = spec.load_benchmark()
    assert bench["paths"] == ["portbench"]
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/")
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])


def _listing():
    return sorted(p for p in _walk(BENCH))


def test_a_run_writes_nothing_into_the_benchmark(tmp_path):
    before = _listing()
    code = (
        "import time, sys\n"
        "sys.path.insert(0, {root!r})\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "from portbench.harness import run_cell\n"
        "out = run_cell(tiny_cell('cogvideox-5b.train-dpo'), 5, 0.05, True, 'cpu', "
        "time.perf_counter(), log=lambda m: None)\n"
        "print(sorted(out))\n"
    ).format(root=str(ROOT))
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path))
    res = subprocess.run([sys.executable, "-B", "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert _listing() == before
