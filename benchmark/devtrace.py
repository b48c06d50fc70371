"""The traced run's device trace, reduced to what the metrics read.

torch.profiler traces the window (`--trace 1`) with a `window` span around
it and one span per job, named after the job. From its Chrome trace:

  busy_s      the union of the device's kernel, copy and memset intervals
              inside the window span;
  kernel_s    seconds of device work summed by name;
  idle_s      the window's idle device time by what the host was doing:
              each job's report phases laid end to end from the job's
              start (load, guide_sites, plane_build, counter, scan,
              collect, write; the rest of the job is `other`), and
              `harness` between jobs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"
PHASES = (("load", "load_s"), ("guide_sites", "guide_sites_s"),
          ("plane_build", "upload_expand_s"), ("counter", "counter_s"),
          ("scan", "scan_s"), ("collect", "collect_s"), ("write", "write_s"))


@dataclass
class DeviceTrace:
    busy_s: float
    kernel_s: Dict[str, float]
    idle_s: Dict[str, float] = field(default_factory=dict)

    def seconds_of(self, part: str) -> float:
        """Device seconds of the operations whose name holds `part`."""
        return sum(s for name, s in self.kernel_s.items() if part in name)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _segments(lo: float, hi: float, jobs: Sequence[Tuple[float, float, Optional[dict]]]
              ) -> List[Tuple[float, float, str]]:
    """The window [lo, hi) cut into labelled host phases (microseconds)."""
    segs, t = [], lo
    for start, end, report in sorted(jobs, key=lambda j: j[0]):
        if start > t:
            segs.append((t, start, "harness"))
        t = start
        if report is not None:
            for label, key in PHASES:
                d = 1e6 * float(report.get(key, 0.0))
                if d > 0:
                    segs.append((t, min(t + d, end), label))
                    t = min(t + d, end)
        if end > t:
            segs.append((t, end, "other"))
        t = max(t, end)
    if hi > t:
        segs.append((t, hi, "harness"))
    return segs


def reduce_events(events: Sequence[dict], reports: Dict[str, Optional[dict]]
                  ) -> Optional[DeviceTrace]:
    """Chrome-trace events -> DeviceTrace; None without a window span.
    reports: each job span's name -> its discover report (None if it
    raised)."""
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        return None
    lo = float(window[0]["ts"])
    hi = lo + float(window[0]["dur"])
    busy, kernel_s = [], {}
    jobs = []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                busy.append((a, b))
                kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + (b - a) / 1e6
        elif e.get("cat") == "user_annotation" and e.get("name") in reports:
            jobs.append((a, b, reports[e["name"]]))
    merged = _union(busy)
    idle: Dict[str, float] = {}
    segs = _segments(lo, hi, jobs)
    gaps, t = [], lo
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    i = 0
    for a, b in gaps:
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s0, s1, label = segs[j]
            overlap = min(b, s1) - max(a, s0)
            if overlap > 0:
                idle[label] = idle.get(label, 0.0) + overlap / 1e6
            j += 1
    return DeviceTrace(busy_s=sum(b - a for a, b in merged) / 1e6,
                       kernel_s=kernel_s, idle_s=idle)


def reduce_profile(prof, path: str, reports: Dict[str, Optional[dict]]
                   ) -> Optional[DeviceTrace]:
    """Export a finished torch.profiler run to `path` and reduce it."""
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    return reduce_events(events, reports)


def top(items: Dict[str, float], n: int = 10, width: int = 120) -> List[list]:
    """The n largest items, names cut to `width` characters."""
    return [[k[:width], v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]
