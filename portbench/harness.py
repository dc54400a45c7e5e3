"""One run of one cell: set-up, the measured window, the device trace when
asked, then the check against the plain reference once the program's state
is freed. Device-agnostic so that the tests can drive it on the CPU; the
command (``portbench.run``) insists on the card.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from typing import Dict

import torch

from portbench import peaks, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "videogpa_tpu")
GIB = float(1 << 30)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(name: str):
    from torch.profiler import record_function

    return record_function(name)


def run_cell(cell: spec.Cell, seed: int, seconds: float, with_trace: bool, device,
             t0: float, log=print) -> Dict[str, object]:
    """Run ``cell`` once; returns the result's fields (``correct``,
    ``metrics``, ``checks``, ...). ``t0`` is the process's start on the
    host clock, from which ``setup_s`` counts."""
    device = torch.device(device)
    driver = spec.driver(cell.traffic["kind"]).Driver(cell.config, cell.traffic, seed, device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    driver.setup()
    _sync(device)
    setup_s = time.perf_counter() - t0
    launches0 = _launches()
    log(f"set-up {setup_s:.3f} s; window of {seconds} s begins")

    units = done = 0
    with trace.traced(with_trace) as prof:
        with trace.window_span():
            start = time.perf_counter()
            while True:
                with _span(f"portbench.{driver.unit_name}"):
                    units += driver.unit(done)
                _sync(device)
                done += 1
                wall = time.perf_counter() - start
                if wall >= seconds and driver.can_stop(done):
                    break
    launches = {k: v - launches0.get(k, 0) for k, v in _launches().items()}
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    summary = trace.summarize(trace.events(prof)) if prof is not None else None
    work = driver.work()
    failed = driver.failed()
    log(f"window {wall:.6f} s: {done} {driver.unit_name}s' calls, {units} {driver.unit_name}s; "
        f"launches {launches}, expected {driver.expected_launches(units)}")

    metrics: Dict[str, Dict[str, object]] = {}
    e2e = {m["name"]: m for m in cell.end_to_end}
    values = {"setup_s": setup_s, "peak_mem_gib": memory_peak / GIB,
              driver.time_metric: 1e3 * wall / units}
    if with_trace:
        name = torch.cuda.get_device_name(device) if on_card else ""
        ctx = {"kind": cell.traffic["kind"], "units": units, "wall_s": wall, "work": work,
               "peak": peaks.peak(name), "trace": summary}
        units_of = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, read in spec.metric_readers(cell).items():
            v = read(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": units_of[name]}
    else:
        for name, m in e2e.items():
            if name in values:
                metrics[name] = {"value": values[name], "unit": m["unit"]}

    driver.release()
    del prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = driver.check()
    log(f"check against the plain reference in {time.perf_counter() - t_check:.1f} s: "
        f"{json.dumps(driver.details)}")
    checks = {}
    correct = failed == 0
    for name, value in readings.items():
        limit = cell.limits.get(name, {}).get("limit")
        ok = limit is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    out = {"correct": bool(correct), "attempted": done, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else device.type,
                      "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                      "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if summary is not None:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
        log(f"trace: groups {summary['group_s']} counts {summary['group_counts']}")
    out["checks"] = checks  # last: each number compared, beside its limit
    return out


def _launches() -> Dict[str, int]:
    from portbench.program import attention_launches

    return attention_launches()
