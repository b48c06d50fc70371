"""What the readers of the program's spans and counters read: the `spans`
(seconds by span name) and `counts` that each discover report carries
(flashfry_tpu_torch/trace.py). A report without them gives nothing."""

from __future__ import annotations

from typing import Optional


def span_mean(ctx, name: str) -> Optional[float]:
    """The span's seconds, mean per job over the reports that carry it."""
    vals = [float(r["spans"][name]) for r in ctx.reports
            if name in r.get("spans", {})]
    return sum(vals) / len(vals) if vals else None


def count_rate(ctx, count: str, span: str) -> Optional[float]:
    """The counter summed over the window's jobs, per second of the span
    summed over them, over the reports that carry both."""
    both = [r for r in ctx.reports
            if count in r.get("counts", {}) and span in r.get("spans", {})]
    seconds = sum(float(r["spans"][span]) for r in both)
    if seconds <= 0:
        return None
    return sum(float(r["counts"][count]) for r in both) / seconds
