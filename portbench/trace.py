"""The device trace of a window (``torch.profiler``) reduced to what the
per-layer metrics read: device time by kernel group, the busy time as the
union of every device operation's interval, the idle gaps between them and
what the host was doing in each.

The kernel groups are a frozen copy of the classification the port's smoke
run uses (``chip_smoke.py::_kernel_group``), so the benchmark keeps its own
yardstick when that file changes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "portbench.window"


def kernel_group(name: str) -> str:
    """``attention_fwd``, ``attention_bwd``, ``gemm``, ``conv`` or ``other``."""
    if "flash_attn" in name or "attn_f32_kernel" in name:
        return "attention_bwd" if "bwd" in name else "attention_fwd"
    low = name.lower()
    if any(tag in low for tag in ("conv", "fprop", "dgrad", "wgrad", "cudnn")):
        return "conv"
    if any(tag in low for tag in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "gemm"
    return "other"


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by the (start, end) intervals."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the device and the host inside the block when ``enabled``;
    yields the profiler (or None)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def window_span():
    """The host span that marks the measured window inside a trace."""
    from torch.profiler import record_function

    return record_function(WINDOW_SPAN)


def events(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, on the device, start, end) of every event of a finished
    ``torch.profiler`` run, times in microseconds, read straight from the
    profiler's results (building its event tree takes minutes at a
    window's size). The device's copies of host annotations
    (``record_function`` spans) are not device operations and are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == cuda
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        if on_device and (annotation or e.name().startswith("portbench.")):
            continue
        start = e.start_ns() / 1e3
        out.append((e.name(), on_device, start, start + e.duration_ns() / 1e3))
    return out


def summarize(evts: List[Tuple[str, bool, float, float]],
              top: int = 10) -> Optional[Dict[str, object]]:
    """Device time by group, busy and window seconds, the top device
    operations and the longest idle gaps of the traced window (``events``),
    or None when the trace holds no device operation (the profiler saw no
    device)."""
    window = [e for e in evts if e[0] == WINDOW_SPAN and not e[1]]
    if not window:
        return None
    lo, hi = window[0][2], window[0][3]
    device, host = [], []
    for name, on_device, s, t in evts:
        if t <= lo or s >= hi:
            continue
        if on_device:
            device.append((max(s, lo), min(t, hi), name))
        elif name != WINDOW_SPAN:
            host.append((s, t, name))
    if not device:
        return None
    groups: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for s, t, name in device:
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + (t - s) / 1e6
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
        counts[g] = counts.get(g, 0) + 1
    spans = [(s, t) for s, t, _ in device]
    busy = union_length(spans) / 1e6
    idle = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:top]
    named_gaps = []
    for s, t in idle:
        mid = 0.5 * (s + t)
        covering = [h for h in host if h[0] <= mid <= h[1]]
        what = min(covering, key=lambda h: h[1] - h[0])[2] if covering else "no host span"
        named_gaps.append([what, (t - s) / 1e6])
    return {
        "window_s": (hi - lo) / 1e6, "busy_s": busy, "group_s": groups, "group_counts": counts,
        "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": named_gaps,
    }
