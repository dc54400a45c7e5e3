"""Readings that set a cell's limits, on the card at the cell's own size,
each held against one float32 reference a seed as a run's check would hold
the program: the sound program (``sound``), the control (``control``: the
plain reference in float8 in the program's place) and each planted fault of
``portbench.faults``.

    python3 -B -m portbench.control --workload NAME --seeds 1,2,3 --read sound,control,half_batch

One JSON line a seed and reading on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Dict, List

import torch

from portbench import faults, spec


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(cell: spec.Cell, seed: int, what: List[str], device) -> Dict[str, dict]:
    """The check's numbers of each reading in ``what`` on one seed, all
    against one float32 reference."""
    Driver = spec.driver(cell.traffic["kind"]).Driver
    drv = Driver(cell.config, cell.traffic, seed, device)
    want = drv.reference()
    out = {}
    for w in what:
        if w == "control":
            out[w] = drv.check(drv.control_outputs(), want)
        else:
            # the program's set-up drives the checked steps
            run = Driver(cell.config, cell.traffic, seed, device)
            if w == "sound":
                run.setup()
            else:
                with faults.planted(w):
                    run.setup()
            run.release()
            out[w] = run.check(want=want)
            del run
        _free()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--read", default="sound,control",
                   help=f"comma-separated: sound, control, {', '.join(faults.READINGS)}")
    args = p.parse_args(argv)
    cell = spec.find_cell(args.workload)
    what = [w for w in args.read.split(",") if w]
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        for w, checks in readings(cell, seed, what, "cuda").items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": w,
                              "checks": checks}), flush=True)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0}), flush=True)
        _free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
