"""What a metric's reader (`metrics/<metric>.py`, a `read(ctx)` that gives a
number or None) reads: the Context of one run, and shared arithmetic.

A reader that finds nothing to read returns None, and the run's line then
leaves that metric out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from .devtrace import DeviceTrace
from .sites import Enzyme
from .work import bound_seconds, stage1_work


@dataclass
class Context:
    config: dict
    traffic: dict
    enzyme: Enzyme
    setup_s: float
    window_s: float
    job_s: List[float]                  # wall of every job of the window
    reports: List[dict]                 # discover reports of the jobs that returned
    device_kind: str
    trace: Optional[DeviceTrace] = None
    n_targets: int = 0                  # the reference's distinct targets
    site_counts: List[int] = field(default_factory=list)  # reference rows per job


def report_mean(ctx: Context, key: str) -> Optional[float]:
    vals = [float(r[key]) for r in ctx.reports if key in r]
    return sum(vals) / len(vals) if vals else None


def idle_share(ctx: Context) -> Optional[float]:
    """Percent of the window in which no device operation ran."""
    if ctx.trace is None or ctx.trace.busy_s <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window_s)


def nearest_rank(values: List[float], q: float) -> Optional[float]:
    """The q-quantile by nearest rank: a value of the sample."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def roofline(ctx: Context, kernel: str) -> Optional[float]:
    """Percent of stage 1's bound, summed over the window's jobs, in the
    device time of the kernels named `kernel`."""
    if ctx.trace is None or not ctx.site_counts or ctx.n_targets <= 0:
        return None
    spent = ctx.trace.seconds_of(kernel)
    if spent <= 0:
        return None
    bound = 0.0
    for guides in ctx.site_counts:
        ops, moved = stage1_work(guides, ctx.n_targets, len(ctx.enzyme.compared),
                                 ctx.enzyme.length)
        b = bound_seconds(ops, moved, ctx.device_kind)
        if b is None:
            return None
        bound += b
    return 100.0 * bound / spent
