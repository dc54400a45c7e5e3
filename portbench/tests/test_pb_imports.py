"""Nothing the benchmark runs loads JAX or the JAX package, by top-level
module name compared whole, and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from portbench import harness, spec

BENCH = spec.ROOT / "portbench"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _sources(top):
    return [p for p in sorted(top.rglob("*.py")) if "__pycache__" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    found = {(str(p), m) for p in _sources(BENCH) for m in _imports(p)
             if m.split(".")[0] in harness.FORBIDDEN}
    assert not found


def test_top_level_names_compare_whole():
    assert "videogpa_torch".split(".")[0] not in harness.FORBIDDEN
    sys.modules.setdefault("videogpa_tpu_lookalike_for_test", sys)
    try:
        assert "videogpa_tpu_lookalike_for_test" not in harness.forbidden_modules()
    finally:
        del sys.modules["videogpa_tpu_lookalike_for_test"]


def test_reference_imports_nothing_of_the_port():
    allowed = {"contextlib", "math", "typing", "numpy", "torch", "__future__", "portbench"}
    for p in _sources(BENCH / "reference"):
        for m in _imports(p):
            top = m.split(".")[0]
            assert top in allowed, f"{p.name} imports {m}"
            if top == "portbench":
                assert m.startswith("portbench.reference"), f"{p.name} imports {m}"


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import time, sys\n"
        "sys.path.insert(0, {root!r})\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "from portbench.harness import run_cell, forbidden_modules\n"
        "run_cell(tiny_cell('cogvideox-5b.train-dpo'), 9, 0.05, False, 'cpu', "
        "time.perf_counter(), log=lambda m: None)\n"
        "print('FOUND', forbidden_modules())\n"
    ).format(root=str(spec.ROOT))
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path))
    res = subprocess.run([sys.executable, "-B", "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FOUND []" in res.stdout
