"""Off-target discovery on one device (PyTorch).

Counterpart of flashfry_tpu/engine.py. The host steps are the port's own
copies of that module's: ScanStats, the bin-pruning mask and host
comparison counter, the numpy XOR/popcount scan (`backend="numpy"`, the
host oracle) and the overflow-cap hit collection (_collect_hits, native
C++). What runs on the device is the logged comparison counter
(pruned_comparisons_device) and the scan (ops.scan.DeviceScanner, resident
or streaming the database in slabs, or parallel.mesh.ShardedScanner over
several devices or processes).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from .bitcoding import STRING_MASK
from .database import Database
from .discovery import DiscoveredSites
from .targetio import GuideWithOffTargets
from .trace import count, span
from .utils import gc_content

from .device import resolve_device
from .ops.scan import DeviceScanner
from .parallel.mesh import ShardedScanner, pick_devices

__all__ = ["ScanStats", "default_scanner", "discover", "pruned_comparisons",
           "pruned_comparisons_device"]

BACKENDS = ("torch", "numpy")


@dataclass
class ScanStats:
    """Counters mirroring the reference's Traverser counters
    (reference/traverser/Traverser.scala:66-74), plus phase timings for the
    discover epilogue, each the seconds of its span (trace.py):
    scan_seconds covers the whole scan+collect+counter span; collect/counter
    break out the host aggregation and the pruned-comparisons bookkeeping
    so a slow run is attributable."""
    all_targets: int = 0
    all_targets_and_positions: int = 0  # targets weighted by genomic positions
    all_comparisons: int = 0          # FlashFry-equivalent comparisons (after pruning)
    dense_comparisons: int = 0        # raw guide x target comparisons performed
    scan_seconds: float = 0.0
    collect_seconds: float = 0.0      # _collect_hits (cap rule + CSR assembly)
    counter_seconds: float = 0.0      # pruned_comparisons_device bookkeeping


def bin_guide_mask(db: Database, guide_longs: np.ndarray, max_mismatch: int) -> np.ndarray:
    """(num_bins, G) bool — can bin b contain a <=max_mismatch hit for guide g?

    One-shot vectorized version of OrderedBinTraversalFactory's precompute
    (OrderedBinTraversalFactory.scala:146-173).
    """
    enc = db.bit_encoding()
    w = db.bin_width
    num_bins = db.num_bins
    # bin b's sequence as an integer occupies the same bit positions for all
    # bins: replicate binToLongComparitor vectorized.
    mask = enc.comp_bitmask_for_bin(w)
    p = db.pack
    if p.five_prime_pam:
        shift = np.uint64(2 * (p.total_scan_length - (w + p.pam_length)))
    else:
        shift = np.uint64(2 * (p.total_scan_length - w))
    bins = (np.arange(num_bins, dtype=np.uint64) << shift) & STRING_MASK
    g = np.asarray(guide_longs, dtype=np.uint64)
    mm = enc.mismatches_cross(bins, g & mask)
    return mm <= max_mismatch


def pruned_comparisons(db: Database, guide_longs: np.ndarray,
                       max_mismatch: int, guide_chunk: int = 4096) -> int:
    """FlashFry-equivalent comparison count: each guide is compared only
    against the targets of bins whose prefix is within max_mismatch of the
    guide's (Traverser.scala:66-74 counts post-pruning comparisons; the
    pruning predicate is OrderedBinTraversalFactory.scala:146-173 /
    LinearTraversal.scala:82-97 — both traversals prune). Equals the sum the
    masked numpy scan accumulates; computed here in O(bins x G) host time,
    chunked over guides so a 10^5-guide batch never materializes a
    (4^w x G) mask at once."""
    counts = db.bin_target_counts().astype(np.int64)
    g = np.asarray(guide_longs, dtype=np.uint64)
    total = 0
    for lo in range(0, g.shape[0], guide_chunk):
        m = bin_guide_mask(db, g[lo:lo + guide_chunk], max_mismatch)
        total += int(counts @ m.sum(axis=1, dtype=np.int64))
    return total


def _scan_numpy(db: Database, guide_longs: np.ndarray, max_mismatch: int,
                stats: ScanStats, bin_mask: Optional[np.ndarray],
                chunk: int = 1 << 20):
    """Host scan: vectorized XOR+popcount over (G, chunk) tiles.

    Yields (target_idx int64[:], guide_idx int64[:], mm int8[:]) per chunk,
    target-major sorted (global scan order).
    """
    import logging
    logger = logging.getLogger("flashfry_tpu_torch.engine")
    enc = db.bit_encoding()
    g = np.asarray(guide_longs, dtype=np.uint64)
    n = db.num_targets
    targets = db.targets
    tgt_bins = None
    if bin_mask is not None:
        # per-target bin index, to mask pruned (guide, target) pairs
        tgt_bins = np.repeat(np.arange(db.num_bins), db.bin_target_counts())
    t0 = time.perf_counter()
    for chunk_i, lo in enumerate(range(0, n, chunk)):
        hi = min(n, lo + chunk)
        if chunk_i and chunk_i % 64 == 0:
            # progress-line parity (SeekTraverser.scala:93-99)
            logger.info("Comparing the %sth chunk of %s targets; executed %s "
                        "comparisons so far (%.1fs)", format(chunk_i, ","),
                        format(hi - lo, ","), format(stats.all_comparisons, ","),
                        time.perf_counter() - t0)
        stats.all_targets_and_positions += int(db.pos_offsets[hi] - db.pos_offsets[lo])
        sub_mask = None
        if bin_mask is not None:
            sub_mask = bin_mask[tgt_bins[lo:hi]]  # (T, G)
            if not sub_mask.any():
                continue
        mm = enc.mismatches_cross(targets[lo:hi], g)  # (T, G): targets major
        stats.dense_comparisons += (hi - lo) * g.shape[0]
        hits = mm <= max_mismatch
        if sub_mask is not None:
            stats.all_comparisons += int(sub_mask.sum())
            hits &= sub_mask
        else:
            stats.all_comparisons += (hi - lo) * g.shape[0]
        stats.all_targets += hi - lo
        t_idx, g_idx = np.nonzero(hits)
        if t_idx.size:
            yield t_idx + lo, g_idx, mm[t_idx, g_idx].astype(np.int8)


def _collect_hits(db: Database, guides: List[GuideWithOffTargets],
                  hit_iter, stats: Optional[ScanStats] = None) -> None:
    """Apply hits to guides with the reference's overflow-cap rule: accept a
    hit iff current_total < cap before adding (ResultsAggregator.updateOT ->
    CRISPRSiteOT.addOT, crispr/CRISPRSiteOT.scala:41-46).

    Fully vectorized: hits arrive in global target order per guide (each
    guide lives in exactly one scan guide-block, and blocks stream their
    triplets target-major), so a stable sort by guide index groups each
    guide's hits in acceptance order; the cap is then an exclusive-cumsum
    threshold over per-hit position counts, and the accepted coordinate
    lists are one ragged gather from the database CSR arrays.
    """
    t_chunks, g_chunks = [], []
    for t_idx, g_idx, _mm in hit_iter:
        t_chunks.append(np.asarray(t_idx, dtype=np.int64))
        g_chunks.append(np.asarray(g_idx, dtype=np.int64))
    if not t_chunks:
        return
    # post-scan host aggregation (the scan wait is above)
    with span("collect") as sp:
        _assign_hits(db, guides, np.concatenate(t_chunks), np.concatenate(g_chunks))
    if stats is not None:
        stats.collect_seconds += sp.seconds


def _assign_hits(db: Database, guides: List[GuideWithOffTargets],
                 t: np.ndarray, g: np.ndarray) -> None:
    """_collect_hits' aggregation of the hits (t, g), in scan order. The
    spans: collect.native (the cap rule and the lists of the accepted hits)
    and collect.assign (handing each guide its lists); the counters:
    collect.hits, collect.accepted and collect.coords (the positions copied
    out)."""
    n_guides = len(guides)

    # native one-pass collect: counting-scatter by guide + cap rule + CSR
    # assembly reading the (possibly memory-mapped) database arrays in
    # place — the numpy formulation builds ~15 full-size temporaries and two
    # argsorts, which costs ~25 s at 18.7M hits on hosts with slow
    # first-touch page faults (the numpy path remains the oracle; tests pin
    # equality)
    from . import native as _native
    with span("collect.native"):
        caps = np.fromiter((gu.overflow_cap for gu in guides),
                           np.int64, n_guides)
        r = _native.collect_hits(t, g, db.pos_offsets, db.positions,
                                 db.targets, caps)
        if r is None:
            r = _collect_numpy(db, t, g, caps)
    hit_start, out_longs, coord_offsets, out_coords = r
    count("collect.hits", t.shape[0])
    count("collect.accepted", out_longs.shape[0])
    count("collect.coords", out_coords.shape[0])
    with span("collect.assign"):
        for gi in range(n_guides):
            s, e = int(hit_start[gi]), int(hit_start[gi + 1])
            if s == e:
                continue
            offs = coord_offsets[s:e + 1] - coord_offsets[s]
            guides[gi].set_ots_arrays(
                out_longs[s:e],
                out_coords[coord_offsets[s]:coord_offsets[e]], offs)


def _collect_numpy(db: Database, t: np.ndarray, g: np.ndarray,
                   caps: np.ndarray):
    """native.collect_hits in numpy: (hit_start (G+1), out_longs (H),
    coord_offsets (H+1), out_coords (C)) of the accepted hits, guide by
    guide in scan order."""
    n_guides = caps.shape[0]
    order = np.argsort(g, kind="stable")
    t = t[order]
    g = g[order]
    # Gather per-target offsets/positions through the UNIQUE sorted target
    # set: db.pos_offsets/db.positions are memory-mapped (3 GB each at hg38
    # scale) and random fancy-indexing pays a ~4 KB page fault per element;
    # ascending gathers ride readahead instead (~10 s -> <1 s at 145k hits).
    u, inv = np.unique(t, return_inverse=True)
    off_lo = np.asarray(db.pos_offsets[u], dtype=np.int64)
    off_hi = np.asarray(db.pos_offsets[u + 1], dtype=np.int64)
    lens_u = off_hi - off_lo

    # per-guide hit segments
    seg = np.searchsorted(g, np.arange(n_guides + 1, dtype=np.int64))
    pos_counts = lens_u[inv]
    cum = np.cumsum(pos_counts)
    excl = cum - pos_counts                       # positions before this hit
    seg_base = np.zeros(n_guides, dtype=np.int64)
    nonempty = seg[:-1] < seg[1:]
    seg_base[nonempty] = excl[seg[:-1][nonempty]]
    within_excl = excl - seg_base[g]              # guide-local exclusive cumsum

    accept = (caps[g] <= 0) | (within_excl < caps[g])
    t_acc = t[accept]
    g_acc = g[accept]

    # each unique target's position list, gathered ONCE in ascending order
    pool_off = np.zeros(u.shape[0] + 1, dtype=np.int64)
    np.cumsum(lens_u, out=pool_off[1:])
    flat_u = (np.arange(int(pool_off[-1]), dtype=np.int64)
              - np.repeat(pool_off[:-1], lens_u)
              + np.repeat(off_lo, lens_u))
    pool = np.asarray(db.positions[flat_u])

    # ragged assembly of the accepted hits' lists from the in-RAM pool
    inv_acc = inv[accept]
    counts = pos_counts[accept]
    out_off = np.zeros(t_acc.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=out_off[1:])
    total = int(out_off[-1])
    flat = (np.arange(total, dtype=np.int64)
            - np.repeat(out_off[:-1], counts)
            + np.repeat(pool_off[inv_acc], counts))
    coords = pool[flat]

    seg_a = np.searchsorted(g_acc, np.arange(n_guides + 1, dtype=np.int64))
    return seg_a, db.targets[t_acc], out_off, coords


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pruned_comparisons_device(db: Database, guide_longs: np.ndarray,
                              max_mismatch: int,
                              device: Union[str, torch.device],
                              guide_chunk: int = 4096) -> int:
    """pruned_comparisons on a device: the FlashFry
    comparison count after bin pruning, as (Gc, 4w) x (4w, 4^w) int8
    products of guide-prefix and bin one-hots (torch._int_mm), thresholded
    at <= max_mismatch and weighted by each bin's target count. Exact:
    match counts are int32 and every sum is int64.

    _int_mm wants more than 16 rows and a depth and width that are
    multiples of 8, so 4w (28 at the default width 7) is zero-padded to a
    multiple of 8, the guide rows to a multiple of 32 and the bins to a
    multiple of 8 (padded bins carry a target count of 0; padded guide rows
    are dropped before the sum)."""
    dev = resolve_device(device)
    w = db.bin_width
    num_bins = db.num_bins
    p = db.pack
    if p.five_prime_pam:
        shift = 2 * (p.total_scan_length - (w + p.pam_length))
    else:
        shift = 2 * (p.total_scan_length - w)
    k = _pad_to(4 * w, 8)
    b_rows = _pad_to(num_bins, 8)
    digits = ((np.arange(num_bins, dtype=np.int64)[None, :]
               >> (2 * (w - 1 - np.arange(w))[:, None])) & 3)       # (w, B)
    bins_oh = np.zeros((b_rows, k), dtype=np.int8)
    bins_oh[:num_bins, :4 * w] = (digits[:, None, :] ==
                                  np.arange(4)[None, :, None]
                                  ).reshape(4 * w, num_bins).T
    bins_T = torch.from_numpy(bins_oh).to(dev).t()                 # (k, B')
    cnt = np.zeros(b_rows, dtype=np.int64)
    cnt[:num_bins] = db.bin_target_counts()
    cnt_d = torch.from_numpy(cnt).to(dev)

    g = np.asarray(guide_longs, dtype=np.uint64)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, g.shape[0], guide_chunk):
        gc = g[lo:lo + guide_chunk]
        gd = ((gc[None, :] >> (np.uint64(shift)
                               + 2 * (w - 1 - np.arange(w, dtype=np.uint64))[:, None]))
              & np.uint64(3)).astype(np.int64)                      # (w, Gc)
        g_oh = np.zeros((max(32, _pad_to(gc.shape[0], 32)), k), dtype=np.int8)
        g_oh[:gc.shape[0], :4 * w] = (gd[:, None, :] ==
                                      np.arange(4)[None, :, None]
                                      ).reshape(4 * w, -1).T
        matches = torch._int_mm(torch.from_numpy(g_oh).to(dev), bins_T)
        ok = (w - matches[:gc.shape[0]]) <= max_mismatch           # (Gc, B')
        total += (ok.sum(dim=0, dtype=torch.int64) * cnt_d).sum()
    return int(total)


def default_scanner(db: Database, device: torch.device
                    ) -> Union[DeviceScanner, ShardedScanner]:
    """The scanner discover builds for `device`: a ShardedScanner over every
    visible card for a bare "cuda" when there are several (as flashfry_tpu
    shards over every device of its platform), else a DeviceScanner."""
    if (device.type == "cuda" and device.index is None
            and torch.cuda.device_count() > 1):
        return ShardedScanner(db, devices=pick_devices("cuda"))
    return DeviceScanner(db, device)


def _check_scanner(scanner: Union[DeviceScanner, ShardedScanner], db: Database,
                   device: torch.device) -> None:
    """A scanner built from a different database would silently
    scan the wrong genome: identity or a cheap content fingerprint (ends and
    total position count, O(1) even on memory-mapped arrays) must match. A
    DeviceScanner must live on `device`, a ShardedScanner on devices of its
    type."""
    sdb = scanner.db
    same = sdb is db or (
        sdb.num_targets == db.num_targets
        and int(sdb.pos_offsets[-1]) == int(db.pos_offsets[-1])
        and (db.num_targets == 0
             or (sdb.targets[0] == db.targets[0]
                 and sdb.targets[-1] == db.targets[-1])))
    if not same:
        raise ValueError("scanner was built from a different database")
    if isinstance(scanner, ShardedScanner):
        if scanner.device_type != device.type:
            raise ValueError("sharded scanner lives on %s devices, discover "
                             "was asked for %s" % (scanner.device_type, device))
    elif scanner.device != device:
        raise ValueError("scanner lives on %s, discover was asked "
                         "for %s" % (scanner.device, device))


def discover(db: Database, guide_sites: DiscoveredSites,
             max_mismatch: int = 4,
             maximum_off_targets: int = 2000,
             min_gc: float = 0.0, max_gc: float = 1.0,
             force_linear: bool = False,
             backend: str = "torch",
             stats: Optional[ScanStats] = None,
             device: Union[str, torch.device] = "cuda",
             scanner: Optional[Union[DeviceScanner, ShardedScanner]] = None
             ) -> List[GuideWithOffTargets]:
    """Run the discover phase; returns guides in output order.

    backend "torch" scans on `device` (a missing card raises); "numpy" is
    the host scan of flashfry_tpu's numpy backend (bin-pruned XOR/popcount,
    _scan_numpy), which ignores device and scanner. scanner: a
    DeviceScanner of this database, resident (repeat calls skip the upload)
    or streaming, or a ShardedScanner (parallel/mesh.py; its
    MultiHostScanner yields every process's hits); one built from another
    database raises ValueError. Without one, discover builds
    default_scanner(db, device): a ShardedScanner over every card for a
    bare "cuda" on a machine with several, else a DeviceScanner, which
    streams when the planes do not fit in the card's free memory."""
    if backend not in BACKENDS:
        raise ValueError("backend must be one of %s, got %r"
                         % (", ".join(BACKENDS), backend))
    dev = None
    if backend == "torch":
        dev = resolve_device(device)
        if scanner is not None:
            _check_scanner(scanner, db, dev)
    if stats is None:
        stats = ScanStats()

    # host prologue of flashfry_tpu.engine.discover: GC filter, guide
    # objects, stable sort by start (CRISPRSiteOT.compare)
    with span("prologue"):
        bases = guide_sites.bases()
        contexts = (guide_sites.contexts if guide_sites.contexts is not None
                    else [None] * len(guide_sites))
        contig_names = [""] + guide_sites.contig_names
        guides: List[GuideWithOffTargets] = []
        for i in range(len(guide_sites)):
            gc = gc_content(bases[i])
            if gc < min_gc or gc > max_gc:
                continue
            guides.append(GuideWithOffTargets(
                contig=contig_names[int(guide_sites.contig_ids[i])],
                start=int(guide_sites.positions[i]),
                bases=bases[i],
                forward_strand=bool(guide_sites.forward[i]),
                sequence_context=contexts[i],
                long_encoding=int(guide_sites.sequences[i] & STRING_MASK
                                  | (np.uint64(1) << np.uint64(48))),
                overflow_cap=maximum_off_targets,
            ))
        guides.sort(key=lambda g: g.start)
        guide_longs = np.array([g.long_encoding for g in guides], dtype=np.uint64)
    if not guides:
        return guides

    if dev is None:
        # the numpy backend: traversal pruning pays only on the host scan
        with span("scan") as sp:
            bmask = (None if force_linear
                     else bin_guide_mask(db, guide_longs, max_mismatch))
            _collect_hits(db, guides, _scan_numpy(db, guide_longs, max_mismatch,
                                                  stats, bmask), stats)
        stats.scan_seconds = sp.seconds
        return guides

    with span("scan") as sp:
        if not force_linear:
            # the logged count carries the reference's post-pruning semantics
            # (Traverser.scala:66-74); the dense scan only tracks its own work
            with span("counter") as cnt:
                stats.all_comparisons = pruned_comparisons_device(
                    db, guide_longs, max_mismatch, dev)
            stats.counter_seconds = cnt.seconds
        if scanner is None:
            with span("plane_build"):
                scanner = default_scanner(db, dev)
        _collect_hits(db, guides, scanner.scan(guide_longs, max_mismatch,
                                               None, stats), stats)
        if force_linear:
            # --forceLinear skips the bin mask on the host path; mirror it
            stats.all_comparisons = stats.dense_comparisons
    stats.scan_seconds = sp.seconds
    return guides
