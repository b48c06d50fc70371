"""Whether the window's jobs wrote what FlashFry's rules give.

As each job of the window returns, `keep` takes from its output what the
check needs: every row's first seven columns, and the whole of the rows
in the job's sample. Once the window has closed, each job is held to the
reference (reference.py), which works from the genome and the job's
records alone:

  jobs_failed         jobs that raised, or wrote no file, another header,
                      or a line of other than nine columns;
  row_count_gap       over the jobs, |rows written - rows of the reference|;
  site_rows_wrong     rows, in order, whose contig, start, stop, target,
                      context or orientation differ: every row of every job
                      (site finding and row order);
  sampled_rows_wrong  sampled rows that differ from the reference's row in
                      any byte (the index, the scan's hits and mismatch
                      counts, the overflow cap, target and position order,
                      the written text).

The sample of each job, drawn from the seed, is `check_rows_per_job` rows
at random, the row with the largest otCount, up to
`check_overflow_rows_per_job` rows marked OVERFLOW, and the rows at the
edges of 2048-row guide blocks, whether the blocks are cut from the rows
in order or dealt round-robin: the first and last row of each block,
ragged last ones included. The output is exact, so every limit is 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .reference import HEADER, ReferenceGenome, job_sites, row, site_columns
from .sites import Enzyme

HEADER_BYTES = HEADER.encode()
BLOCK_ROWS = 2048   # the most guide rows one stage-1 block holds

LIMITS = {"jobs_failed": 0, "row_count_gap": 0, "site_rows_wrong": 0,
          "sampled_rows_wrong": 0}


def records_of(job, genome: np.ndarray) -> List[np.ndarray]:
    g = genome.view(np.uint8)
    return [g[s:s + n] for s, n in zip(job.starts.tolist(), job.lengths.tolist())]


@dataclass
class Kept:
    """What the check needs of one job's output."""
    job: object
    raised: bool
    heads: Optional[List[bytes]] = None   # each row's first seven columns; None:
                                          # no output, or not the format
    sampled: Dict[int, str] = field(default_factory=dict)   # row index -> row


def _edges(n_rows: int) -> Set[int]:
    """The first and last row of each BLOCK_ROWS-row block of n_rows rows,
    cut in order, and of ceil(n_rows / BLOCK_ROWS) blocks dealt
    round-robin (the first and last that many rows)."""
    k = min(-(-n_rows // BLOCK_ROWS), n_rows)
    out = set(range(k)) | set(range(n_rows - k, n_rows))
    for b in range(0, n_rows, BLOCK_ROWS):
        out.update((b, min(b + BLOCK_ROWS, n_rows) - 1))
    return out


def _numbers(a: np.ndarray, lo: np.ndarray, hi: np.ndarray, digits: int = 9) -> np.ndarray:
    """The whole numbers written in a[lo:hi] of each row, -1 where the
    field is empty, longer than `digits` or not all digits."""
    size = hi - lo
    value = np.zeros(lo.shape, dtype=np.int64)
    bad = (size < 1) | (size > digits)
    for j in range(digits):
        inside = j < size
        d = a[np.where(inside, hi - 1 - j, 0)].astype(np.int64) - ord("0")
        bad |= inside & ((d < 0) | (d > 9))
        value += np.where(inside, d, 0) * 10 ** j
    return np.where(bad, -1, value)


def keep(job, written: Optional[bytes], raised: bool, traffic: dict,
         rng: np.random.Generator) -> Kept:
    """What the check needs of one job's output, with the job's sample
    drawn from rng. The output is cut at its newlines and tabs in numpy,
    so that little of the window goes to it."""
    if raised or written is None or not written.startswith(HEADER_BYTES) \
            or not written.endswith(b"\n"):
        return Kept(job, raised)
    a = np.frombuffer(written, dtype=np.uint8)
    cuts = np.flatnonzero(a < 11)                # tabs (9) and newlines (10)
    at_end = a[cuts] == 10
    ends, tabs = cuts[at_end], cuts[~at_end]     # each line's newline, the header's first
    if (np.diff(np.searchsorted(tabs, ends), prepend=0) != 8).any():
        return Kept(job, raised)                 # a line of other than nine columns
    tabs = tabs.reshape(-1, 8)[1:]
    starts = (ends[:-1] + 1).tolist()
    n = len(starts)
    heads = [written[s:e] for s, e in zip(starts, tabs[:, 6].tolist())]
    k = min(int(traffic["check_rows_per_job"]), n)
    picked = set(rng.choice(n, size=k, replace=False).tolist()) | _edges(n)
    counts = _numbers(a, tabs[:, 6] + 1, tabs[:, 7])
    if n and counts.max() >= 0:
        picked.add(int(np.argmax(counts)))
    overflowed = np.flatnonzero((tabs[:, 5] - tabs[:, 4] == 9)
                                & (a[tabs[:, 4] + 1] == ord("O"))).tolist()
    k_over = min(int(traffic["check_overflow_rows_per_job"]), len(overflowed))
    if k_over:
        picked.update(np.asarray(overflowed)[
            rng.choice(len(overflowed), size=k_over, replace=False)].tolist())
    return Kept(job, raised, heads,
                {i: written[starts[i]:ends[i + 1] + 1].decode("ascii", "replace")
                 for i in sorted(picked)})


def check_jobs(kept: Sequence[Kept], genome: np.ndarray, enzyme: Enzyme,
               ref: ReferenceGenome, max_mm: int, cap: int, flank: int
               ) -> Tuple[Dict[str, int], Dict[str, object]]:
    """kept: what `keep` took of every job of the window, in order.
    Returns the compared numbers, and counts of what was read with the
    reference's rows of each job (`site_counts`)."""
    got = dict.fromkeys(LIMITS, 0)
    info = {"jobs_checked": 0, "rows_checked": 0, "rows_sampled": 0,
            "site_counts": []}
    for k in kept:
        if k.heads is None:
            got["jobs_failed"] += 1
            continue
        info["jobs_checked"] += 1
        sites = job_sites(records_of(k.job, genome), enzyme, flank)
        info["site_counts"].append(len(sites))
        got["row_count_gap"] += abs(len(k.heads) - len(sites))
        n = min(len(k.heads), len(sites))
        info["rows_checked"] += n
        for i in range(n):
            cols = k.heads[i].decode("ascii", "replace").split("\t")
            want = site_columns(sites[i], k.job.record_names).split("\t")
            orient = "FWD" if sites[i].forward else "RVS"
            if len(cols) != 7 or cols[:5] != want or cols[6] != orient:
                got["site_rows_wrong"] += 1
        for i, written in k.sampled.items():
            if i >= n:
                continue
            info["rows_sampled"] += 1
            if written != row(sites[i], k.job.record_names, ref, max_mm, cap):
                got["sampled_rows_wrong"] += 1
    return got, info
