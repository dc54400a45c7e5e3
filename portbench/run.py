"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -B -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``videogpa_torch``. ``-B`` keeps the
run from writing bytecode into the checkout. The last line of standard
output is the result as one JSON object; progress and the device's name and
power limit go to standard error, ending with each number compared beside
its limit. Exits 2 on bad arguments, 3 without enough cards, 4 without the
port, 5 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import spec  # noqa: E402


def log(msg: str) -> None:
    print(f"{time.perf_counter() - T0:9.1f} {msg}", file=sys.stderr, flush=True)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = spec.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    # libraries that would load JAX on their own are kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = spec.find_cell(args.workload)
    except (KeyError, OSError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import videogpa_torch
    except ImportError as e:
        print(f"portbench: the port is not in this checkout: {e}", file=sys.stderr)
        return 4
    if Path(videogpa_torch.__file__).resolve().parent.parent != spec.ROOT:
        print(f"portbench: measures the port of this checkout, not {videogpa_torch.__file__}",
              file=sys.stderr)
        return 4
    torch.set_num_threads(4)
    log(f"{args.workload} seed {args.seed} trace {args.trace}: {card_line()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    from portbench.harness import forbidden_modules, run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0, log=log)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 5
    log(f"correct {result['correct']}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
