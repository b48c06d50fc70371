"""Spans and counters of one discover call.

A Recorder, opened with `recording()` and held in a context variable, sums
what `span` and `count` report while it is open:

  spans[name]    seconds on time.perf_counter, summed over every entry (a
                 span entered once per slab sums its slabs);
  calls[name]    how many times the span was entered;
  counts[name]   what `count` added, and what `count_at_close` reads
                 when the recorder closes;
  top[name]      the seconds of the entries made while no other span was
                 open (the call's top-level spans);
  seconds        once it closes, its seconds from open to close.

cli.run opens the call's recorder around the parse and the command, so a
discover report carries `spans`, `counts`, `top_spans` (the recorder's
top) and `call_seconds` (its seconds): call_seconds less the top-level
spans is the call's time in no span.

Span names are dotted paths, a child under its layer (`plane_build.split`
under `plane_build`). A layer's self time (`Recorder.self_s`) is its span
less the spans that closed while it was the innermost open one. While
torch.profiler records, a span also opens `record_function("ff." + name)`,
so it lies in the profiler's trace beside the card's kernels and copies,
on the same clock, inside whatever span its caller opened. With no
recorder open and no profiler recording, a span only reads the clock for
its own `seconds`, and `count` does nothing. Tracing has no switch of its
own: it is on where a profiler records.

The spans and counters, and the benchmark metric that reads each
(benchmark/metrics/<metric>.py, a mean per job of the window):

  cli.parse            cli.run: build_parser and       cli_s.job
                       parse_args
  cli.prepare          cli: discover's argument        cli_s.job
                       checks and resolve_device (and
                       joining the process group)
  load                 cli: load_database              report load_s
  guide_sites          cli: find_target_sites          report guide_sites_s,
                                                       guide_sites_s.job
  plane_build          cli: building the scanner       report upload_expand_s,
                       (default_scanner, or the        plane_build_s.job
                       multi-process scanner);
                       engine.discover: default_scanner
                       when it is handed no scanner
  plane_build.split    ops/scan: the host copy of a    plane_split_s.job
                       piece's raw words into a
                       staging buffer (pinned on a
                       card), with the first-touch
                       reads of the memory-mapped
                       targets
  plane_build.upload   ops/scan: the enqueue of a      plane_upload_s.job
                       piece's host-to-device copy,
                       and the host's wait for a free
                       staging buffer (its copy of
                       two pieces before)
  plane_build.expand   ops/scan: the launch of the     plane_expand_s.job
                       expand kernel (csrc/planes.cu)
                       on a piece, the PAD_CODE fill
                       past the last target, and the
                       resident build's closing wait
                       for the card (the sharded build
                       makes none); streaming, on the
                       copy stream, the launches only
  prologue             engine.discover: GC filter,     prologue_s.job
                       guide objects, sort, guide words
  scan                 engine.discover: counter, scan  report scan_s (scan less
                       and collect (and the numpy      counter and collect),
                       backend's bin mask)             scan_s.job
  counter              engine.discover:                report counter_s,
                       pruned_comparisons_device       counter_s.job
  collect              engine._collect_hits            report collect_s,
                                                       collect_s.job,
                                                       collect_us_per_hit.job
  collect.native       engine._assign_hits: the cap    none
                       rule and the accepted hits'
                       lists (native.collect_hits, or
                       its numpy formulation)
  collect.assign       engine._assign_hits: each       none
                       guide's set_ots_arrays
  write                cli: write_output               report write_s,
                                                       write_s.job,
                                                       write_mbps.job
  release              cli: the end of the call: the   release_s.job
                       scanner (planes, staging), the
                       guides and the database (its
                       memory maps) dropped; leaving
                       the process group
  report               cli: the report and its JSON    cli_s.job
                       log line; run's closing line
  (none of the above)  call_seconds less the top-level unspanned_s.job
                       spans
  count plane_build.h2d_bytes   bytes the plane build  plane_upload_gbps.job
                       uploads: 8 per target           (with plane_build.upload:
                                                       bytes over the host's
                                                       blocked seconds, not the
                                                       link's rate)
  count plane_build.kernel_slabs   the pieces the      none
                       expand kernel expanded (a CPU
                       build launches none, and counts
                       none)
  count plane_build.card_us   the card's microseconds  plane_card_s.job
                       of every build on a card,
                       resident, sharded or streamed:
                       per piece, CUDA events on the
                       upload stream just before its
                       upload and just after its
                       expand launch, summed (the
                       card's waits for the host's
                       copy and the PAD fill fall
                       outside); read when the
                       recorder closes (CPU builds
                       count none)
  count collect.hits   hits handed to _assign_hits     collect_us_per_hit.job
  count collect.accepted   hits kept under the         none
                       overflow cap
  count collect.coords   positions copied out for the  none
                       accepted hits
  count write.bytes    the output file's size          write_mbps.job
  count write.rows     the output's rows (one a guide) none

Every plane build is ops/scan.fill_planes, in pieces of SLAB targets:
the sharded scanner's (parallel/mesh.py) plane_build.* spans and its byte
and card counts sum over the shards. A streaming scanner builds no planes
in its constructor: its plane_build.* spans and counts fall inside `scan`,
once per slab of every scan.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

PREFIX = "ff."  # program spans in the profiler's trace


class Recorder:
    """Seconds and entries by span name, and counts, of one call."""

    def __init__(self) -> None:
        self.spans: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}
        self.child_s: Dict[str, float] = {}  # seconds of spans closed inside
        self.top: Dict[str, float] = {}      # seconds of spans closed at top level
        self.seconds = 0.0                   # open to close, once it closes
        self._open: List[str] = []
        self._at_close: List[Tuple[str, Callable[[], int]]] = []

    def self_s(self, name: str) -> float:
        """The span's seconds less its children's."""
        return self.spans.get(name, 0.0) - self.child_s.get(name, 0.0)


_RECORDER: contextvars.ContextVar[Optional[Recorder]] = contextvars.ContextVar(
    "flashfry_tpu_torch_recorder", default=None)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Open a Recorder for the spans and counts inside the block. If the
    block ends without raising, count_at_close's reads are made last."""
    rec = Recorder()
    token = _RECORDER.set(rec)
    t0 = time.perf_counter()
    try:
        yield rec
        for name, read in rec._at_close:
            rec.counts[name] = rec.counts.get(name, 0) + int(read())
    finally:
        rec.seconds = time.perf_counter() - t0
        _RECORDER.reset(token)


def current() -> Optional[Recorder]:
    """The open Recorder, or None."""
    return _RECORDER.get()


def _profiling() -> bool:
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False))


class span:
    """`with span(name) as s:` times the block; s.seconds is its duration
    once it closes."""

    __slots__ = ("name", "seconds", "_rec", "_rf", "_t0")

    def __init__(self, name: str) -> None:
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "span":
        self._rec = _RECORDER.get()
        self._rf = None
        if _profiling():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        if self._rec is not None:
            self._rec._open.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        rec = self._rec
        if rec is not None:
            rec._open.pop()
            rec.spans[self.name] = rec.spans.get(self.name, 0.0) + self.seconds
            rec.calls[self.name] = rec.calls.get(self.name, 0) + 1
            if rec._open:
                parent = rec._open[-1]
                rec.child_s[parent] = rec.child_s.get(parent, 0.0) + self.seconds
            else:
                rec.top[self.name] = rec.top.get(self.name, 0.0) + self.seconds
        return False


def count(name: str, n: int) -> None:
    """Add n to the open recorder's counts[name]."""
    rec = _RECORDER.get()
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + int(n)


def count_at_close(name: str, read: Callable[[], int]) -> None:
    """Add read() to the open recorder's counts[name] when it closes: a
    count that is known only once the card is done (a CUDA event's time),
    read after every wait the call makes. Nothing without a recorder."""
    rec = _RECORDER.get()
    if rec is not None:
        rec._at_close.append((name, read))
