"""The check fails what it has to: the control (the reference in float8 in
the program's place) and every planted fault, each driven through a whole
run at a size the CPU holds; a sound run passes. The port computes in
float32 here, so a sound run agrees with the reference to rounding."""

import time

import pytest
import torch

from portbench import faults, spec
from portbench.drivers import train_dpo
from portbench.harness import run_cell
from portbench.tests.tiny import program_in_f32, tiny_cell

CELL = "cogvideox-5b.train-dpo"
SEED = 2**31 + 5


def _run(cell, seed=SEED):
    with program_in_f32():
        return run_cell(cell, seed, 0.05, False, "cpu", time.perf_counter(), log=lambda m: None)


def test_a_sound_run_is_correct():
    out = _run(tiny_cell(CELL))
    assert out["correct"], out["checks"]


def test_the_control_is_not_correct():
    cell = tiny_cell(CELL)
    drv = spec.driver(cell.traffic["kind"]).Driver(cell.config, cell.traffic, SEED, "cpu")
    checks = drv.check(drv.control_outputs())
    failed = [k for k, v in checks.items() if v > cell.limits[k]["limit"]]
    assert failed, checks


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_every_planted_fault_is_caught(fault):
    cell = tiny_cell(CELL)
    with faults.planted(fault):
        out = _run(cell)
    assert not out["correct"], out["checks"]


def test_the_reference_runs_with_tf32_off(monkeypatch):
    """Whatever the program set, the reference's products run in full
    float32, and the settings are as they were afterwards."""
    seen = []
    forward = train_dpo.ref_dit.dit_forward

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return forward(*a, **k)

    monkeypatch.setattr(train_dpo.ref_dit, "dit_forward", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cell = tiny_cell(CELL)
    drv = spec.driver(cell.traffic["kind"]).Driver(cell.config, cell.traffic, SEED, "cpu")
    drv.reference()
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
