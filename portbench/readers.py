"""What the per-layer metrics of ``metrics/`` compute from a window.

Each reader gets ``ctx``: ``kind`` (the traffic's), ``units`` (steps or
pairs completed in the window), ``wall_s`` (the window on the host clock),
``work`` (operations and bytes of one unit, ``portbench.flops``), ``peak``
(``portbench.peaks``, None on a card it does not list) and ``trace``
(``portbench.trace.summarize``, None without a device trace). A reader that
finds nothing to read returns None and the metric is left out.
"""

from __future__ import annotations

from typing import Iterable, Optional

ATTENTION = ("attention_fwd", "attention_bwd")
GEMM = ("gemm",)


def _ready(ctx: dict, kind: str, need_trace: bool = True) -> bool:
    return (ctx["kind"] == kind and ctx["units"] > 0
            and (ctx["trace"] is not None or not need_trace))


def mfu(ctx: dict, kind: str) -> Optional[float]:
    """Model operations of the window over the window times the bf16 peak, %."""
    if not _ready(ctx, kind, need_trace=False) or ctx["peak"] is None:
        return None
    ops = ctx["units"] * ctx["work"]["model_flops"]
    return 100.0 * ops / (ctx["wall_s"] * ctx["peak"]["bf16_flops"])


def roofline(ctx: dict, kind: str, key: str, groups: Iterable[str]) -> Optional[float]:
    """The least time of the window's ``key`` work (operations over the bf16
    peak or bytes over the memory bandwidth, the larger) over the device time
    of the kernels in ``groups``, %."""
    if not _ready(ctx, kind) or ctx["peak"] is None:
        return None
    spent = sum(ctx["trace"]["group_s"].get(g, 0.0) for g in groups)
    if spent <= 0.0:
        return None
    work, peak = ctx["work"], ctx["peak"]
    least = ctx["units"] * max(work[key + "_flops"] / peak["bf16_flops"],
                               work[key + "_bytes"] / peak["hbm_bytes_per_s"])
    return 100.0 * least / spent


def other_ms(ctx: dict, kind: str) -> Optional[float]:
    """Device ms of kernels that are neither attention nor GEMM, a unit."""
    if not _ready(ctx, kind):
        return None
    groups = ctx["trace"]["group_s"]
    other = sum(s for g, s in groups.items() if g not in ATTENTION + GEMM)
    return 1e3 * other / ctx["units"]


def idle_pct(ctx: dict, kind: str) -> Optional[float]:
    """Share of the traced window in which no device operation runs, %."""
    if not _ready(ctx, kind):
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
