"""Mismatch scan of a database on one device, resident or streamed.

Counterpart of flashfry_tpu/ops/scan.py. The database lives on the device
as plane-major base codes, a (32, N) int8 tensor (row i = base i of every
target, rows >= L zero, padding columns PAD_CODE): resident, the whole
database at once; streaming, when its planes exceed the device memory
budget, one target slab at a time (DeviceScanner). A guide block is
scanned over those codes in three steps:

  1. stage 1 (ops.scan_kernel.stage1, the CUDA kernel on a card): one launch
     over the resident array, or over one slab, gives a hit byte per target;
  2. the hit columns, from torch.nonzero, ascending (every real column,
     without stage 1, when max_mismatch >= the active positions);
  3. stage 2, per batch of at most COL_BATCH hit columns: gather their codes,
     recount exact mismatches with an int8 one-hot product against the
     guides, keep mm <= max_mismatch, and emit (target, guide, mm) in
     row-major order of the (columns, guides) mask.

Step 1 is launch_block, steps 2 and 3 are collect_block: a sharded scan
(parallel/mesh.py) launches stage 1 on every shard before it collects any.
Row-major order over ascending columns is target-major within each guide,
and streaming scans its slabs in ascending order, outside the guide
blocks: per guide, hits arrive in global target order, the order FlashFry
applies them in. The 2000-position overflow cap of engine._collect_hits
depends on it. PyTorch's shapes are dynamic, so the compaction counts
first and allocates exactly: there are no fixed column or triplet caps, no
escalation, no retries and no host fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import logging
import warnings
from typing import Iterator, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..bitcoding import STRING_MASK
from ..database import Database
from ..device import resolve_device
from ..standards import ParameterPack
from ..trace import count, count_at_close, current, span
from .scan_kernel import (CODE_ROWS, K_COLS, K_POSITIONS, MAX_GUIDE_ROWS,
                          OH_ROWS, codes_onehot, guide_block_layout, stage1)

logger = logging.getLogger("flashfry_tpu_torch.scan")

_PAD_MM = 127        # mismatch count of guide padding rows (never a hit)
COL_BATCH = 16384    # hit columns recounted per stage-2 batch
SLAB = 1 << 22       # targets uploaded and expanded per step of the plane build
SLAB_GRANULE = 1 << 12  # a streaming slab's width is a multiple of this many
                        # targets: 64 of K1's 64-target m-tiles
HIT_COL_BYTES = 1 + 8   # per column one stage-1 launch scans: its hit byte, and
                        # the int64 index torch.nonzero gives a hit column
                        # (every column can hit)
DEFAULT_CAP = 1 << 12   # the JAX scan's stage-1 hit targets per chunk (the
                        # experiment tool's gather size)


# host-side preparation, as in flashfry_tpu/ops/scan.py

def split_words(longs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint64 -> (lo32, hi16) as int32 arrays (sequence bits only)."""
    seq = np.asarray(longs, dtype=np.uint64) & STRING_MASK
    lo = (seq & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (seq >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi


PAD_CODE = 4  # padding-column base code: matches no one-hot row, never hits


def plane_codes(longs: np.ndarray, L: int, n_pad: Optional[int] = None) -> np.ndarray:
    """Packed int64 targets -> (32, N_pad) int8 plane-major base codes.

    Row i holds base i (0..3) of every target; rows >= L are zero. Padding
    COLUMNS (targets beyond n) hold PAD_CODE everywhere: their one-hot
    expansion is all-zero, so they can never reach the stage-1 threshold —
    which lets the fused scan skip a whole per-chunk validity-mask pass.
    This is the HBM-resident database layout (see module docstring)."""
    seq = np.asarray(longs, dtype=np.uint64) & STRING_MASK
    n = seq.shape[0]
    if n_pad is None:
        n_pad = n
    out = np.zeros((CODE_ROWS, n_pad), dtype=np.int8)
    for i in range(L):
        s = np.uint64(2 * (L - 1 - i))
        out[i, :n] = ((seq >> s) & np.uint64(3)).astype(np.int8)
    out[:, n:] = PAD_CODE
    return out


def guide_onehot_matrix(guide_longs: np.ndarray, pack: ParameterPack,
                        pad_to: int = 128) -> Tuple[np.ndarray, np.ndarray, int]:
    """(G_pad, 4L) float32 one-hot guide matrix, masked positions zeroed.

    Returns (onehot, n_active_adj, G) where n_active_adj[g] is |active|
    for real guides and _PAD_MM for padding rows (so padding never 'hits').
    """
    L = pack.total_scan_length
    active = pack.comparison_mask_positions()
    g = np.asarray(guide_longs, dtype=np.uint64) & STRING_MASK
    G = g.shape[0]
    Gp = max(pad_to, int(np.ceil(G / pad_to)) * pad_to)
    onehot = np.zeros((Gp, 4 * L), dtype=np.float32)
    for i in active:
        shift = np.uint64(2 * (L - 1 - i))
        codes = ((g >> shift) & np.uint64(3)).astype(np.int64)
        onehot[np.arange(G), 4 * i + codes] = 1.0
    n_active = np.full(Gp, _PAD_MM, dtype=np.float32)
    n_active[:G] = len(active)
    return onehot, n_active, G


def interleaved_blocks(n_guides: int, block: int):
    """Deal guide indices round-robin into ceil(n/block) blocks.

    Guide batches often arrive SEQUENCE-SORTED (library FASTAs decoded from
    a sorted database, bench samples), which packs whole repeat families —
    hundreds of near-identical guides — into single contiguous blocks: that
    block's stage-1 hit-column and triplet counts explode while every other
    block idles (measured: a 100k-guide hg38-scale library run escalated
    col_cap to 2^20 and OOM'd HBM on the 4 GB stage-2 matrix). Round-robin
    dealing spreads any sorted hot cluster evenly across blocks. Per-guide
    output order is unaffected: each guide lives in exactly one block and
    yields its hits target-major; the collector re-groups by guide index.
    """
    n_blocks = max(1, -(-max(n_guides, 1) // block))
    return [np.arange(b, n_guides, n_blocks, dtype=np.int64)
            for b in range(n_blocks)]


def expand_codes_plain(buf: torch.Tensor, words: torch.Tensor, start: int,
                       L: int) -> None:
    """Plain PyTorch expand on any device: fill columns [start, start +
    len(words)) of buf (32, n_pad) int8 in place from the packed int64 words
    of those targets, as they lie in the database: row i < L gets base i,
    (w >> 2 (L - 1 - i)) & 3, rows >= L get 0. The count in bits 48..63 is
    never read (the largest shift is 46). Temporaries are (len(words),)
    int64 per row."""
    cols = buf[:, start:start + words.shape[0]]
    for i in range(L):
        cols[i] = (words >> (2 * (L - 1 - i))) & 3
    cols[L:] = 0


def expand_codes(buf: torch.Tensor, words: torch.Tensor, start: int,
                 L: int) -> None:
    """expand_codes_plain's function: columns [start, start + len(words)) of
    buf from the int64 words on buf's device.

    CPU tensors run expand_codes_plain. CUDA tensors launch the kernel of
    csrc/planes.cu on the current stream (counted in the open recorder's
    plane_build.kernel_slabs); anything it does not take raises, on either
    device: buf must be (32, >= start + n) int8 with contiguous rows, words
    (n,) int64 contiguous on buf's device, and 1 <= L <= K_POSITIONS. n = 0
    launches nothing."""
    n = words.shape[0]
    if buf.dtype != torch.int8 or buf.dim() != 2 or buf.shape[0] != CODE_ROWS \
            or buf.stride(1) != 1:
        raise ValueError("expand_codes fills a (%d, N) int8 buffer with "
                         "contiguous rows, got %s %s"
                         % (CODE_ROWS, buf.dtype, tuple(buf.shape)))
    if words.dtype != torch.int64 or words.dim() != 1 or not words.is_contiguous():
        raise ValueError("expand_codes takes contiguous (n,) int64 words, got "
                         "%s %s" % (words.dtype, tuple(words.shape)))
    if words.device != buf.device:
        raise ValueError("words on %s but buffer on %s" % (words.device, buf.device))
    if not (0 <= start and start + n <= buf.shape[1] and 1 <= L <= K_POSITIONS):
        raise ValueError("columns [%d, %d) of a %d-column buffer at L = %d"
                         % (start, start + n, buf.shape[1], L))
    if buf.device.type == "cpu":
        expand_codes_plain(buf, words, start, L)
        return
    if n == 0:
        return
    from ._build import planes_library
    p = ctypes.c_void_p
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = planes_library().ff_expand_launch(
            p(words.data_ptr()), n, L, p(buf.data_ptr()), buf.stride(0), start,
            p(stream))
    if err != 0:
        raise RuntimeError("ff_expand_launch failed: cudaError %d" % err)
    count("plane_build.kernel_slabs", 1)


def stage_words(dst: torch.Tensor, targets: np.ndarray) -> None:
    """Copy packed uint64 target words into the int64 tensor dst (a pinned
    staging buffer on a card) as they are: no mask, no shift, no cast. Any
    array works, a memory-mapped database included; torch copies with its
    CPU threads."""
    src = np.asarray(targets, dtype=np.uint64).view(np.int64)
    with warnings.catch_warnings():
        # a read-only memmap: torch warns that the tensor could be written,
        # and it is only read
        warnings.simplefilter("ignore", UserWarning)
        dst.copy_(torch.from_numpy(src))


class WordStaging:
    """The host side of every plane build: two int64 staging buffers of
    `size` words (pinned on a card, and reused: torch's caching host
    allocator keeps them across builds) that take turns, and their uploads
    to `device`. On a card the uploads go on `stream` (by default the
    device's current stream, whichever device is current) and each buffer's
    `copied` event is recorded on that stream, so the host's wait before it
    refills a buffer waits for that buffer's last upload."""

    def __init__(self, size: int, device: torch.device,
                 stream: Optional[torch.cuda.Stream] = None):
        self.device = device
        cuda = device.type == "cuda"
        self.stream = (stream or torch.cuda.current_stream(device)) if cuda else None
        self.host = [torch.empty(size, dtype=torch.int64, pin_memory=cuda)
                     for _ in range(2)]
        self.copied = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self.turn = 0

    def upload(self, targets: np.ndarray) -> Tuple[torch.Tensor,
                                                   Optional[torch.cuda.Event]]:
        """Copy targets (at most `size` of them) raw into the next staging
        buffer, once its last upload is done, and enqueue their upload
        without waiting. Returns (words, start): words are the targets as
        int64 on the device; start, on a card while a recorder is open, is a
        timing event recorded on the stream just before the copy (else
        None). The spans: plane_build.split (the host copy) and .upload (the
        wait for the buffer and the enqueue); the counter
        plane_build.h2d_bytes."""
        b, self.turn = self.turn, self.turn ^ 1
        n = targets.shape[0]
        host = self.host[b][:n]
        if self.copied:
            with span("plane_build.upload"):
                self.copied[b].synchronize()
        with span("plane_build.split"):
            stage_words(host, targets)
        count("plane_build.h2d_bytes", 8 * n)
        with span("plane_build.upload"):
            if not self.copied:
                return host, None
            with torch.cuda.stream(self.stream):
                words = torch.empty(n, dtype=torch.int64, device=self.device)
                start = None
                if current() is not None:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()  # after the allocation: only the copy
                words.copy_(host, non_blocking=True)
            self.copied[b].record(self.stream)
        return words, start


def card_us(pieces: List[Tuple[torch.cuda.Event, torch.cuda.Event]]) -> int:
    """The card's time in a plane build's timed pieces, summed, in whole
    microseconds; waits for the last piece."""
    pieces[-1][1].synchronize()
    return round(1000 * sum(a.elapsed_time(b) for a, b in pieces))


def fill_planes(buf: torch.Tensor, targets: np.ndarray, L: int,
                staging: WordStaging) -> None:
    """Fill the (32, width) int8 planes buf from packed uint64 targets: the
    one plane build of the resident scanner, of every shard and of every
    streamed slab.

    Columns [0, n) piece by piece, SLAB targets a piece: staging.upload
    copies the piece's raw words into a staging buffer and uploads them as
    8 bytes a target without waiting for the card, and expand_codes turns
    them into codes, so no (L, n) temporary is ever built and the next
    piece is copied while the card uploads and expands the one before. Then
    PAD_CODE into columns [n, width) only: the expand writes every row of
    its columns, so no byte of buf is written twice. All of it runs on
    staging's stream; the caller waits for the card. The spans:
    plane_build.split, .upload and .expand (trace.py). On a card while a
    recorder is open, each piece's card time, from staging's event before
    its copy to one recorded after its expand launch, is summed into
    plane_build.card_us when the recorder closes, after every wait of the
    call."""
    n = targets.shape[0]
    if buf.shape[1] < n:
        raise ValueError("%d targets in a %d-column buffer" % (n, buf.shape[1]))
    pieces = []
    stream = staging.stream
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        for a in range(0, n, SLAB):
            words, start = staging.upload(targets[a:a + SLAB])
            with span("plane_build.expand"):
                expand_codes(buf, words, a, L)
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                pieces.append((start, end))
        if n < buf.shape[1]:
            with span("plane_build.expand"):
                buf[:, n:] = PAD_CODE
    if pieces:
        count_at_close("plane_build.card_us", functools.partial(card_us, pieces))


def device_plane_codes(targets: np.ndarray, L: int, n_pad: int,
                       device: Union[str, torch.device]) -> torch.Tensor:
    """Packed uint64 targets -> (32, n_pad) int8 plane codes on device, by
    fill_planes into a new buffer through new staging on the device's
    current stream. The caller waits for the card."""
    dev = resolve_device(device)
    buf = torch.empty((CODE_ROWS, n_pad), dtype=torch.int8, device=dev)
    fill_planes(buf, targets, L, WordStaging(min(SLAB, max(targets.shape[0], 1)), dev))
    return buf


def recount(codes: torch.Tensor, cols: torch.Tensor, guide_i8: torch.Tensor,
            n_active: torch.Tensor) -> torch.Tensor:
    """Exact mismatch counts (len(cols), G) int32 of the given target
    columns against a guide block: |active| - <onehot(g), onehot(t)>,
    clamped to _PAD_MM (guide padding rows carry n_active = _PAD_MM)."""
    sel = codes[:, cols].t()                                  # (n, 32)
    n = sel.shape[0]
    pad = -n % 32  # _int_mm wants > 16 rows: pad with PAD_CODE targets
    if pad:
        sel = F.pad(sel, (0, 0, 0, pad), value=PAD_CODE)
    matches = torch._int_mm(codes_onehot(sel), guide_i8.t())[:n]
    return torch.clamp_max(n_active[None, :] - matches, _PAD_MM)


def guide_block_rows(n_guides: int) -> int:
    """Rows of each guide block of a scan of n_guides guides: 128, doubled
    until one block holds them all or MAX_GUIDE_ROWS is reached."""
    block = 128
    while block < n_guides and block < MAX_GUIDE_ROWS:
        block *= 2
    return block


def scan_reserve_bytes(cols: int) -> int:
    """Device bytes the scan of one guide block of MAX_GUIDE_ROWS rows
    needs beside the code planes, when one stage-1 launch scans `cols`
    target columns:
      - HIT_COL_BYTES per column: the stage-1 hit bytes and their indices;
      - one stage-2 batch of COL_BATCH columns: the gathered codes, their
        padding and one-hot (recount), per (column, guide) pair three int32
        counts (the product, the difference, the clamped counts) and the
        mask, and per hit pair (every pair can hit) two int64 indices, the
        gathered int32 count and its int8 copy;
      - the guide tensors: the float32 one-hot upload, the block layout,
        the compacted guides and stage1's check of them, the n_active row;
      - one plane-build piece of SLAB targets: its int64 words."""
    pair = 3 * 4 + 1 + 2 * 8 + 4 + 1
    batch = COL_BATCH * (2 * CODE_ROWS + OH_ROWS + MAX_GUIDE_ROWS * pair)
    guides = MAX_GUIDE_ROWS * (4 * 4 * K_POSITIONS + OH_ROWS + 2 * K_COLS + 4)
    build = SLAB * 8
    return cols * HIT_COL_BYTES + batch + guides + build


def default_budget_bytes(device: torch.device, n: int) -> int:
    """The code planes' share of the card's free memory for a database of
    n targets: free memory less scan_reserve_bytes for the columns one
    stage-1 launch scans. That is n when the planes fit resident; when they
    do not, a slab of budget // (2 * CODE_ROWS) targets, so the budget is
    solved from free - reserve(slab) = 2 * CODE_ROWS * slab."""
    free, _total = torch.cuda.mem_get_info(device)
    resident = free - scan_reserve_bytes(n)
    if CODE_ROWS * n <= resident:
        return resident
    two_slabs = 2 * CODE_ROWS
    return (free - scan_reserve_bytes(0)) * two_slabs // (two_slabs + HIT_COL_BYTES)


class DeviceScanner:
    """Holds one database on one device and scans guide batches against it.

    Resident (mode "resident", one slab) when its (32, N) int8 planes fit
    in `budget` bytes: repeat scans reuse the uploaded planes. Otherwise it
    streams (mode "streaming", self.codes None): every scan() uploads the
    database in `slabs` target slabs of slab_n targets, two of which fit in
    the budget, and scans them in ascending order, the guide blocks inside.

    budget: bytes for the code planes alone. None means, on a card, its
    free memory less the reserve one guide block's scan needs
    (default_budget_bytes), and on the CPU no limit. A budget below two
    slabs of SLAB_GRANULE targets raises ValueError, as long as the planes
    do not fit it. Resident or streamed, the planes are built by
    fill_planes.

    COST CONTRACT of the streaming mode, as flashfry_tpu's: every scan()
    call uploads the whole database again (the slabs cycle through the same
    two buffers), and copies its packed words into pinned staging on the
    host again (fill_planes, the resident build's own routine). On a card
    the next slab's upload and expand are enqueued on a copy stream before
    the current slab's guide blocks run, so they can overlap the scan; the
    host copy does not. For a max_mismatch sweep do not call scan() per mm
    value: one scan at the largest mm yields every lower-mm hit with its
    exact count in the mm column (an mm <= k hit set is a filter of the
    mm <= k + 1 set).
    """

    def __init__(self, db: Database, device: Union[str, torch.device],
                 budget: Optional[int] = None):
        self.device = resolve_device(device)
        self.db = db
        self.L = db.pack.total_scan_length
        self.n = db.num_targets
        self.mode, self.slabs = "resident", 1
        n_pad = max(self.n, 1)  # the kernel takes any width
        if budget is None and self.device.type == "cuda":
            budget = default_budget_bytes(self.device, n_pad)
        if budget is not None and CODE_ROWS * n_pad > budget:
            self._plan_streaming(budget)
            return
        self.codes = device_plane_codes(db.targets, self.L, n_pad, self.device)
        if self.device.type == "cuda":
            with span("plane_build.expand"):
                torch.cuda.synchronize(self.device)

    def _plan_streaming(self, budget: int) -> None:
        """Streaming mode: the widest slab, a multiple of SLAB_GRANULE
        targets, of which two fit in the budget."""
        slab_n = budget // (2 * CODE_ROWS) // SLAB_GRANULE * SLAB_GRANULE
        if slab_n == 0:
            raise ValueError(
                "a budget of %d bytes holds neither the database's %d bytes "
                "of code planes nor two slabs of %d targets (%d bytes)"
                % (budget, CODE_ROWS * max(self.n, 1), SLAB_GRANULE,
                   2 * CODE_ROWS * SLAB_GRANULE))
        self.codes = None
        self.mode, self.slab_n = "streaming", slab_n
        self.slabs = -(-self.n // slab_n)
        logger.info("database planes need %d bytes, the budget is %d: "
                    "streaming %d slabs of %d targets", CODE_ROWS * self.n,
                    budget, self.slabs, slab_n)

    def scan(self, guide_longs: np.ndarray, max_mismatch: int,
             bin_mask: Optional[np.ndarray] = None,
             stats=None) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (target_idx int64, guide_idx int64, mm int8) batches; within
        each guide, hits arrive in global target order.

        The dense scan finds exactly the hits of FlashFry's pruned traversal
        (bin pruning is lossless), so bin_mask is accepted for interface
        parity and ignored. Guides run in blocks of 128 up to
        MAX_GUIDE_ROWS rows, dealt round-robin (interleaved_blocks) so a
        sorted repeat family does not land in one block. Streaming, the
        blocks run inside each slab and stats count the first slab only,
        which adds the whole database per block."""
        g_all = np.asarray(guide_longs, dtype=np.uint64)
        block = guide_block_rows(g_all.shape[0])
        blocks = [idx for idx in interleaved_blocks(g_all.shape[0], block)
                  if idx.size]
        if self.codes is not None:
            for idx in blocks:
                yield from self._scan_block(self.codes, 0, self.n, g_all[idx],
                                            idx, max_mismatch, stats, block)
            return
        for t_lo, codes, n_valid in self.stream_slabs():
            for idx in blocks:
                yield from self._scan_block(codes, t_lo, n_valid, g_all[idx],
                                            idx, max_mismatch,
                                            stats if t_lo == 0 else None, block)

    def stream_slabs(self):
        """Yield (t_lo, codes, n_valid) per slab, ascending: codes is one of
        two (32, slab_n) buffers holding targets [t_lo, t_lo + n_valid) and
        PAD_CODE past them. The caller enqueues all of a slab's work on the
        current stream before it asks for the next slab.

        On a card, fill_planes builds slab i + 1 on a copy stream before
        slab i is handed out, its raw words copied on the host into
        WordStaging's two pinned int64 buffers piece by piece, and three
        event orders hold: the current stream waits for a slab's `ready`
        event before it scans it; the copy stream waits for buffer b's
        `done` event (slab i's work) before it overwrites b with slab i + 2;
        the host waits for a staging buffer's `copied` event, recorded on
        the copy stream, before it copies into that buffer again. The
        buffers live until the generator ends, which first waits for the
        card. On the CPU the same loop runs without streams or events. A
        slab's steps are fill_planes' spans and counts (trace.py); on a card
        the upload and expand spans time their enqueue on the copy
        stream."""
        dev, L, slab_n = self.device, self.L, self.slab_n
        cuda = dev.type == "cuda"
        bufs = [torch.empty((CODE_ROWS, slab_n), dtype=torch.int8, device=dev)
                for _ in range(2)]
        if cuda:
            compute = torch.cuda.current_stream(dev)
            copy = torch.cuda.Stream(dev)
            ready, done = ([torch.cuda.Event() for _ in range(2)] for _ in range(2))
        staging = WordStaging(min(SLAB, slab_n), dev, copy if cuda else None)

        def load(t_lo: int) -> None:
            b = (t_lo // slab_n) % 2
            if cuda:
                copy.wait_event(done[b])
            fill_planes(bufs[b], self.db.targets[t_lo:t_lo + slab_n], L, staging)
            if cuda:
                ready[b].record(copy)

        try:
            starts = range(0, self.n, slab_n)
            if starts:
                load(0)
            for i, t_lo in enumerate(starts):
                b = i % 2
                if i + 1 < len(starts):
                    load(starts[i + 1])
                if cuda:
                    compute.wait_event(ready[b])
                yield t_lo, bufs[b], min(slab_n, self.n - t_lo)
                if cuda:
                    done[b].record(compute)
        finally:
            if cuda:
                torch.cuda.synchronize(dev)

    def _scan_block(self, codes: torch.Tensor, base: int, n_valid: int,
                    guide_longs: np.ndarray, idx: np.ndarray,
                    max_mismatch: int, stats, pad_to: int):
        """Scan one guide block over codes, whose first n_valid columns hold
        targets base..base + n_valid - 1; yields global target indices."""
        if stats is not None:
            stats.all_targets += self.n
            stats.all_targets_and_positions += int(self.db.pos_offsets[-1])
            stats.dense_comparisons += self.n * guide_longs.shape[0]
        yield from collect_block(
            codes, launch_block(codes, guide_longs, self.db.pack, max_mismatch,
                                pad_to),
            base, n_valid, idx, max_mismatch)


class Launched(NamedTuple):
    """One guide block's stage 1 over one codes tensor, enqueued on its
    device: the block-layout guides, their active counts (_PAD_MM for the
    padding rows) and the hit bytes, or None when every real column is a
    hit column."""
    guide_i8: torch.Tensor
    n_active: torch.Tensor
    hits: Optional[torch.Tensor]


def launch_block(codes: torch.Tensor, guide_longs: np.ndarray,
                 pack: ParameterPack, max_mismatch: int,
                 pad_to: int) -> Launched:
    """The launch half of one guide block's scan over codes: upload the
    guides to codes' device in block layout, padded to pad_to rows, and
    enqueue stage 1. It reads nothing back but stage1's guide check, so the
    caller can launch on every shard before it collects any."""
    guide_oh, n_active, _G = guide_onehot_matrix(guide_longs, pack, pad_to=pad_to)
    dev = codes.device
    guide_i8 = guide_block_layout(torch.from_numpy(guide_oh).to(dev),
                                  pack.total_scan_length)
    n_act = torch.from_numpy(n_active).to(dev, torch.int32)
    thr = len(pack.comparison_mask_positions()) - max_mismatch
    # thr <= 0: every real target is within max_mismatch of every guide, even
    # one that matches no active position, which stage 1 cannot pass
    hits = stage1(codes, guide_i8, thr) if thr > 0 else None
    return Launched(guide_i8, n_act, hits)


def collect_block(codes: torch.Tensor, launched: Launched, base: int,
                  n_valid: int, idx: np.ndarray, max_mismatch: int):
    """The collect half: the hit columns (torch.nonzero, ascending; every
    one of the first n_valid columns when stage 1 was skipped), then stage 2
    per COL_BATCH columns. codes' first n_valid columns hold targets base..
    base + n_valid - 1 and idx maps the block's rows to guide indices;
    yields (global target int64, guide int64, mm int8) in row-major order
    of each batch's (columns, guides) mask."""
    guide_i8, n_act, hits = launched
    if hits is None:
        cols = torch.arange(n_valid, device=codes.device)
    else:
        cols = torch.nonzero(hits).squeeze(1)
    for lo in range(0, cols.shape[0], COL_BATCH):
        c = cols[lo:lo + COL_BATCH]
        mm = recount(codes, c, guide_i8, n_act)               # (n, G)
        r, g = torch.nonzero(mm <= max_mismatch, as_tuple=True)
        if r.shape[0] == 0:
            continue
        yield (c[r].cpu().numpy() + base, idx[g.cpu().numpy()],
               mm[r, g].to(torch.int8).cpu().numpy())
