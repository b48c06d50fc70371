"""The one traffic generator: a mix file's parameters -> discover jobs.

A mix (`traffic/<mix>.json`) is data. Its `kind` says how a job's FASTA
records are cut from the benchmark's own genome:

  sites    records each holding a site drawn by genomic position
           (uniformly over every PAM site on either strand, as FlashFry's
           runtime sweep draws real genomic guides), written with
           `record_flank` bases of genome on each side; records are drawn
           until the guide sites inside them (the drawn site and any other
           the flanks take in) reach `sites_per_job`, so every job holds
           the same work to within one record;
  regions  `records_per_job` records of `region_bp` bases each, at
           uniform positions of the genome that hold no N.

Every job is a new draw; a run's pool holds `max_jobs_per_s` jobs for
every second of its window (and one more), after `warmup_jobs` jobs that
only set-up runs. `check_rows_per_job` and `check_overflow_rows_per_job`
size the correctness sample (check.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from .genome import ACGT
from .sites import Enzyme

KINDS = ("sites", "regions")


@dataclass
class Job:
    name: str
    record_names: List[str]
    starts: np.ndarray      # int64 genome start of each record
    lengths: np.ndarray     # int64 length of each record
    fasta: bytes


def pool_size(traffic: dict, seconds: float) -> int:
    return int(math.ceil(seconds * float(traffic["max_jobs_per_s"]))) + 1


def _fasta(names: List[str], genome: np.ndarray, starts: np.ndarray,
           lengths: np.ndarray) -> bytes:
    """One FASTA record per (name, start, length), a line each, laid out in
    one array: every record of a job has one length and every name one
    width."""
    n, w = int(lengths[0]), len(names[0])
    if not (lengths == n).all() or any(len(x) != w for x in names):
        raise ValueError("a job's records must share one length and one name width")
    rec = np.empty((len(names), w + n + 3), dtype=np.uint8)
    rec[:, 0] = ord(">")
    rec[:, 1:w + 1] = np.frombuffer("".join(names).encode(), np.uint8).reshape(-1, w)
    rec[:, w + 1] = rec[:, -1] = ord("\n")
    rec[:, w + 2:w + 2 + n] = ACGT[genome[starts[:, None] + np.arange(n)[None, :]]]
    return rec.tobytes()


def _site_pool(genome: np.ndarray, sites: Tuple[torch.Tensor, torch.Tensor],
               enzyme: Enzyme, flank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every site start whose record (flank + window + flank) fits the
    genome, and the number of sites of either strand that record holds."""
    n, L = genome.shape[0], enzyme.length
    every = torch.cat(sites)
    every = every[(every >= flank) & (every + L + flank <= n)]
    held = sum(torch.searchsorted(s, every + flank, right=True)
               - torch.searchsorted(s, every - flank) for s in sites)
    return every, held


def make_jobs(traffic: dict, genome: np.ndarray,
              sites: Tuple[torch.Tensor, torch.Tensor], enzyme: Enzyme,
              rng: np.random.Generator, count: int, prefix: str) -> List[Job]:
    """`count` jobs of the mix, drawn from rng in order."""
    kind = traffic["kind"]
    if kind not in KINDS:
        raise ValueError("traffic kind %r: expected one of %s" % (kind, KINDS))
    n = genome.shape[0]
    if kind == "sites":
        flank, want = int(traffic["record_flank"]), int(traffic["sites_per_job"])
        pool, held = _site_pool(genome, sites, enzyme, flank)
        if pool.numel() < want:
            raise ValueError("the genome holds %d usable sites, a job needs %d"
                             % (pool.numel(), want))
    jobs = []
    for j in range(count):
        name = "%s%d" % (prefix, j)
        if kind == "sites":
            pick = torch.from_numpy(rng.choice(pool.numel(), size=want, replace=False))
            pick = pick.to(pool.device)
            # the shortest prefix of the draw whose records hold `want` sites
            per_job = int(torch.searchsorted(torch.cumsum(held[pick], 0),
                                             torch.tensor([want], device=pool.device))) + 1
            starts = pool[pick[:per_job]].cpu().numpy() - flank
            lengths = np.full(per_job, enzyme.length + 2 * flank, dtype=np.int64)
        else:
            per_job, size = int(traffic["records_per_job"]), int(traffic["region_bp"])
            starts = np.empty(per_job, dtype=np.int64)
            for r in range(per_job):
                while True:
                    s = int(rng.integers(0, n - size + 1))
                    if int(genome[s:s + size].max()) <= 3:
                        break
                starts[r] = s
            lengths = np.full(per_job, size, dtype=np.int64)
        digits = len(str(max(per_job - 1, 0)))
        names = ["%s_%0*d" % (name, digits, r) for r in range(per_job)]
        jobs.append(Job(name, names, starts.astype(np.int64), lengths,
                        _fasta(names, genome, starts, lengths)))
    return jobs
