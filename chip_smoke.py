#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flashfry_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one NVIDIA Hopper card, the
CUDA toolkit (nvcc) and PyTorch built for CUDA. JAX is not needed. Phases,
each of which fails the run on any mismatch:

  1. device facts (nvidia-smi name and power limit, torch's device name);
  2. build of the CUDA kernels from csrc/, one nvcc per source, all started
     together (timed, with ptxas report);
  3. kernel vs its plain PyTorch version, bitwise, for all six enzymes,
     every thr from 1 to the active positions, guide blocks of 1, 15, 16,
     17, 100, 128 and 2048 rows and 512 super rows, a ragged N and padding
     columns, one counted launch per call;
  4. 20 Mbp repeat-rich genome: the port's discover CLI output on the card
     is byte-identical to the port's own `--backend numpy` CLI (the host
     XOR/popcount scan, which the CPU tests hold byte for byte to
     flashfry_tpu's numpy backend) at mm=3, mm=4, with overflowing guides,
     and with enough guides for one 2048-row guide block;
  5. the main path at real size: a 400 Mbp repeat-rich genome (~48M
     targets), 1000 position-sampled guides (1059 guide sites, one
     2048-row block) at mm=4 through the port's discover CLI, phase
     seconds, the comparison counter against the host counter, the scan of
     the CLI's own guides against the numpy oracle on a 2M-target slice, a
     32-guide byte check against the numpy CLI, stage-1 launches > 0, and
     stage-1 kernel vs plain, bitwise and timed, with its bound and library
     call, at the main path's shape (the CLI's 2048-row guide block x the
     whole database) and at 1024 rows;
  6. stage-1 variants at the experiment tool's size: the port's tool
     (`flashfry_tpu_torch.tools.experiment_stage1`) runs all twelve keys of
     the JAX tool on (32, 2^23) codes x 1024 guides and the (128, 2^23)
     one-hot (launches of every variant kernel > 0); then each kernel and
     mode (K1 and its 512 super rows, X1, X2, X3, X4 and its 512 super rows,
     X5 at two tiles, X6 in three modes) bitwise against its plain version
     and timed beside it, X6 dot at 512 guides, and X6 copy's bytes/s.

Beside each kernel's time the script computes its bound, the larger of its
int8 operations (the one-hot product over the columns it needs: 2 x 96 x G
x N for K1, whose guides have no base past position 23; 2 x 128 x G x N,
as the TPU kernel computes it, for X1-X6, with K1's 128-column figure
beside its own as bound_ms_128) over the H100's published 1,979 TOP/s and
the bytes the function needs (each input read once, each output written
once) over 3.35 TB/s, and times the library call: torch._int_mm of a
pre-built (N, 128) one-hot ((N, 96) for K1; built before timing) by the
guides, then the epilogue, in the plain version's column chunks; for X6
copy, whose output is one-hot row 0, a clone of that row. For K1 it also
times the launcher alone on pre-compacted guides (kernel_only_ms), so that
the wrapper's own cost per call shows.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits 1 and prints no result. It imports neither JAX nor flashfry_tpu.

profile_main_path(), not run by main(), breaks the 400 Mbp discover CLI
down further (repeat runs at mm 3/4/5, the plane build split, a
torch.profiler pass):

    python3 -c 'import chip_smoke; chip_smoke.profile_main_path()'
"""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from flashfry_tpu_torch import cli, engine  # noqa: E402
from flashfry_tpu_torch.bitcoding import BitEncoding  # noqa: E402
from flashfry_tpu_torch.ops import _build  # noqa: E402
from flashfry_tpu_torch.ops.scan import (  # noqa: E402
    PAD_CODE, SLAB, DeviceScanner, expand_codes, guide_block_rows,
    guide_onehot_matrix, split_words)
from flashfry_tpu_torch.ops import stage1_variants as sv  # noqa: E402
from flashfry_tpu_torch.ops.scan_kernel import (  # noqa: E402
    _REF_ELEMS, K_COLS, OH_ROWS, codes_onehot_compact, compact_guides,
    guide_block_layout, launch, stage1, stage1_reference)
from flashfry_tpu_torch.tools import experiment_stage1 as tool  # noqa: E402
from flashfry_tpu_torch.tools.experiment_stage1 import max_abs_err  # noqa: E402

ENZYMES = ("spcas9ngg", "spcas9", "spcas9nag", "spcas919", "spcas9ngg19",
           "cpf1")
WORK = os.path.join(ROOT, "_smoke_work")
DEVICE = "cuda"
SMALL_MB, MAIN_MB, MAIN_GUIDES = 20, 400, 1000
STAGE1_TPU = "flashfry_tpu/ops/scan_kernel.py:79"
# phase 3's guide blocks: rows around the kernel's 16-row m-tile, the
# discover blocks, and the tool's paired rows
PHASE3_ROWS = (1, 15, 16, 17, 100, 128, "512 super rows", 2048)
VARIANT_CHUNK, VARIANT_GUIDES = tool.CHUNK, tool.GUIDES  # the tool's own size
KERNEL_LIBS = ("stage1", "stage1_variants")
VARIANTS_SRC = "flashfry_tpu_torch/csrc/stage1_variants.cu"
# variant kernel -> (the TPU kernel it replaces, the tool's keys it runs;
# the first key's times are the kernel's in the kernels line)
VARIANT_KERNELS = {
    "v1_gloop": ("tools/experiment_stage1.py:47", ("1",)),
    "v3_int16": ("tools/experiment_stage1.py:74", ("3",)),
    "v4_concat_onehot": ("tools/experiment_stage1.py:96", ("4",)),
    "v6_bf16out": ("tools/experiment_stage1.py:118", ("bf", "g2bf")),
    "v5_tile": ("tools/experiment_stage1.py:143", ("5a", "5b")),
    "expanded": ("tools/experiment_stage1.py:164", ("e_full", "e_dot", "e_copy")),
}
# H100 SXM published dense peaks at 700 W: int8 tensor-core operations/s and
# device-memory bytes/s
PEAK_INT8_OPS, PEAK_BYTES = 1.979e15, 3.35e12
ORACLE_SLICE = 2_000_000  # targets cross-checked against the numpy oracle
# a kernel's numbers in the kernels line, per tool key; K1 adds
# bound_ms_128 (its bound counted over the 128 block-layout columns, as the
# TPU kernel counts it) and kernel_only_ms (the launcher on pre-compacted
# guides, without the wrapper's checks and compaction)
TIMED_FIELDS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
K1_FIELDS = TIMED_FIELDS + ("bound_ms_128", "kernel_only_ms")


def say(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card, from CUDA events over
    reps calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    return tool.seconds_per_call(fn, torch.device(DEVICE), reps) * 1e3


def bound(read: int, written: int, ops: int = 0) -> dict:
    """The least time the card could take: the larger of ops int8
    operations over the int8 peak and the bytes the function must read and
    write, each once, over the memory rate."""
    ops_ms = ops / PEAK_INT8_OPS * 1e3
    bytes_ms = (read + written) / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def product_bound(src: torch.Tensor, g_rows: int, width: int = OH_ROWS) -> dict:
    """bound of one byte per column of src from its one-hot product with
    g_rows guide rows of `width` columns: 2 x width x g_rows x N int8
    operations; the part of src the product needs (width / 128 of its rows:
    all of a one-hot, the 24 code rows of K1's 96 columns) and the guides
    read, N bytes written. X1-X6 take the 128 columns the TPU kernel
    multiplies; K1 the 96 it multiplies."""
    n = src.shape[1]
    return bound(src.numel() * width // OH_ROWS + g_rows * width, n,
                 2 * width * g_rows * n)


def k1_bound(codes: torch.Tensor, g_rows: int) -> dict:
    """K1's bound from its 96 columns, and bound_ms_128 from the 128 the
    TPU kernel counts."""
    return {**product_bound(codes, g_rows, K_COLS),
            "bound_ms_128": product_bound(codes, g_rows)["bound_ms"]}


def k1_kernel_only_ms(codes: torch.Tensor, compacted: torch.Tensor, thr: int,
                      want: torch.Tensor, reps: int = 10) -> float:
    """K1's launcher on guides compacted beforehand (compact_guides),
    without stage1's checks and compaction, which stage1 pays on every call
    (one wait for the device among them); its bytes must equal want's."""
    fn = _build.stage1_library().ff_stage1_launch

    def call():
        return launch(stage1, fn, codes, compacted, thr, check_guides=False)

    max_abs_err(call().view(torch.bool), want, "K1 launcher")
    return cuda_ms(call, reps)


def prebuilt_onehot(src: torch.Tensor, onehot_T) -> torch.Tensor:
    """(N_pad, width) int8 one-hot of src's columns (width 128, or 96 for
    K1's compact layout), built slab by slab before any library call is
    timed; N_pad rounds N up to 32 with zero rows, as torch._int_mm on the
    card wants."""
    n = src.shape[1]
    width = onehot_T(src[:, :1].t()).shape[1]
    oh = torch.zeros((-(-n // 32) * 32, width), dtype=torch.int8, device=src.device)
    for lo in range(0, n, SLAB):
        part = onehot_T(src[:, lo:lo + SLAB].t())
        oh[lo:lo + part.shape[0]] = part
    return oh


def library_ms(oh: torch.Tensor, guides: torch.Tensor, epilogue, want: torch.Tensor,
               reps: int = 3) -> float:
    """One library call of the same function: torch._int_mm of the
    pre-built one-hot by the (width, G) guides, then the epilogue, in the
    plain version's column chunks. Its bytes must equal want's (the plain
    version's output)."""
    G = guides.shape[0]
    chunk = max(32, (_REF_ELEMS // G) // 32 * 32)
    guides_T = guides.t()
    out = torch.empty(oh.shape[0], dtype=torch.int8, device=oh.device)

    def call():
        for lo in range(0, oh.shape[0], chunk):
            m = torch._int_mm(oh[lo:lo + chunk], guides_T)
            out[lo:lo + m.shape[0]] = epilogue(m)

    ms = cuda_ms(call, reps)
    max_abs_err(out[:want.numel()], want.reshape(-1).to(torch.int8), "library call")
    return ms


def write_fasta(path: str, name: str, codes: np.ndarray, width: int = 100) -> None:
    """int8 base codes (0..3) -> one-record FASTA with `width`-base lines."""
    n = codes.shape[0]
    rows = -(-n // width)
    padded = np.zeros(rows * width, dtype=np.int8)
    padded[:n] = codes
    body = np.empty((rows, width + 1), dtype=np.uint8)
    body[:, :width] = np.frombuffer(b"ACGT", dtype=np.uint8)[padded].reshape(rows, width)
    body[:, width] = ord("\n")
    tail = n - (rows - 1) * width
    with open(path, "wb") as fh:
        fh.write((">%s\n" % name).encode())
        fh.write(body[:-1].tobytes())
        fh.write(body[-1, :tail].tobytes() + b"\n")


def write_guides(path: str, db, longs: np.ndarray) -> None:
    seqs, _ = db.bit_encoding().decode_batch(np.asarray(longs, dtype=np.uint64))
    with open(path, "w") as fh:
        fh.write("".join(">g%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))


# bench.py's repeat-rich genome, position-sampled guides, scan collector and
# numpy oracle slice, kept here so the smoke needs nothing outside the port

def synthesize_genome(genome_mb: int, rng) -> np.ndarray:
    """Synthetic genome with an hg38-like repeat landscape (int8 codes).

    A uniform-random genome gives every guide ~135 mm<=4 off-targets and the
    2000-position overflow cap never trips; real hg38 is ~50% repetitive and
    FlashFry's 65/109 s baselines were paid against guides with thousands of
    OTs and live overflow (reference crispr/CRISPRSiteOT.scala:41-62). On a
    uniform base genome we overlay:

      * ~5% covered by repeat families — unit 300-5000 bp, copy number
        log-uniform 10-1000, every copy independently mutated at 1.5%/base,
        so sibling copies sit 0-5+ mismatches apart within any 23-mer window
        (SINE/LINE-like diverged families -> a heavy mm<=4 OT-count tail);
      * 3 high-copy "Alu-like" families — unit 300 bp, thousands of copies,
        20% of copies exact — guides landing in them see >2000 OT genomic
        positions (exact copies stack positions on one target, the database
        keeps up to 32767 per target) and OVERFLOW, exercising the cap
        machinery end-to-end.
    """
    n = genome_mb * 1_000_000
    genome = rng.integers(0, 4, size=n, dtype=np.int8)

    def place(unit: np.ndarray, copies: int, exact_frac: float) -> int:
        m = unit.shape[0]
        pos = rng.integers(0, n - m, size=copies)
        exact = rng.random(copies) < exact_frac
        for p, ex in zip(pos.tolist(), exact.tolist()):
            c = unit
            if not ex:
                c = unit.copy()
                nm = rng.binomial(m, 0.015)
                if nm:
                    s = rng.integers(0, m, size=nm)
                    c[s] = (c[s] + rng.integers(1, 4, size=nm)) % 4
            genome[p:p + m] = c
        return m * copies

    placed = 0
    for _ in range(3):
        unit = rng.integers(0, 4, size=300, dtype=np.int8)
        copies = max(2500, int(rng.integers(5000, 20001) * genome_mb / 3000))
        placed += place(unit, copies, 0.2)
    target = int(0.05 * n)
    while placed < target:
        m = int(rng.integers(300, 5001))
        copies = int(np.exp(rng.uniform(np.log(10), np.log(1000))))
        unit = rng.integers(0, 4, size=m, dtype=np.int8)
        placed += place(unit, copies, 0.0)
    say("  repeat overlay: %.1f%% of genome placed as repeat copies"
        % (100.0 * placed / n))
    return genome


def sample_guides(db, n_guides: int, rng) -> np.ndarray:
    """Sample guide sequences BY GENOMIC POSITION: a target is drawn with
    probability proportional to its genomic occurrence count, as the
    paper's sweep draws real genomic guides (run_timing_collection.py).
    Repeat-family guides therefore appear at their genomic frequency —
    including the heavy-OT-tail members that overflow the 2000-position
    cap. Returns n_guides DISTINCT target longs."""
    total = int(db.pos_offsets[-1])
    offs = np.asarray(db.pos_offsets)
    idx = np.zeros(0, dtype=np.int64)
    while idx.size < n_guides:
        ks = rng.integers(0, total, size=2 * n_guides)
        cand = np.searchsorted(offs, ks, side="right") - 1
        idx = np.unique(np.concatenate([idx, cand]))
    # unique() sorts; shuffle deterministically then trim so the selection
    # is not biased toward low target indices
    rng.shuffle(idx)
    return db.targets[np.sort(idx[:n_guides])]


def collect_hits(scanner, guide_longs, max_mm):
    """Run one full scan; returns (t_idx, g_idx, mm) concatenated arrays."""
    ts, gs, ms = [], [], []
    for t, g, m in scanner.scan(guide_longs, max_mm):
        ts.append(np.asarray(t)); gs.append(np.asarray(g)); ms.append(np.asarray(m))
    if not ts:
        z = np.zeros(0, np.int64)
        return z, z, z.astype(np.int8)
    return np.concatenate(ts), np.concatenate(gs), np.concatenate(ms)


def oracle_slice_check(db, guide_longs, max_mm, t_idx, g_idx, mm):
    """Exact numpy oracle over a fixed 2M-target slice: the device scan's
    hits restricted to the slice must match exactly (ids and mm counts)."""
    n = db.num_targets
    lo = min(n // 2, max(0, n - ORACLE_SLICE))
    hi = min(n, lo + ORACLE_SLICE)
    enc = BitEncoding(db.pack)
    mm_o = enc.mismatches_cross(db.targets[lo:hi], guide_longs)  # (T, G)
    to, go = np.nonzero(mm_o <= max_mm)
    sel = (t_idx >= lo) & (t_idx < hi)
    got = np.stack([t_idx[sel] - lo, g_idx[sel], mm[sel].astype(np.int64)])
    want = np.stack([to, go, mm_o[to, go].astype(np.int64)])
    got = got[:, np.lexsort(got[::-1])]
    want = want[:, np.lexsort(want[::-1])]
    assert got.shape == want.shape and (got == want).all(), \
        "device scan diverges from numpy oracle on slice [%d, %d)" % (lo, hi)
    return int(to.size)


def byte_check(db_path: str, fasta: str, tag: str, extra=()) -> dict:
    """Port CLI on the card vs the port's numpy CLI: the output files must be
    equal."""
    base = ["discover", "--fasta", fasta, "--database", db_path,
            "--positionOutput", *extra]
    mine = os.path.join(WORK, tag + ".torch.out")
    ref = os.path.join(WORK, tag + ".numpy.out")
    report = cli.run(base + ["--output", mine, "--device", DEVICE])
    cli.run(base + ["--output", ref, "--backend", "numpy"])
    if not filecmp.cmp(mine, ref, shallow=False):
        raise AssertionError("%s: port output differs from the numpy CLI" % tag)
    say("  %s: byte-identical, %d bytes, %d guides (%d-row guide block), "
        "%d overflowed" % (tag, os.path.getsize(mine), report["guides"],
                           guide_block_rows(report["guides"]),
                           report["overflowed_guides"]))
    return report


def index_genome(genome_mb: int, seed: int, tag: str):
    """Repeat-rich synthetic genome -> FASTA -> the port's index CLI."""
    t = time.perf_counter()
    codes = synthesize_genome(genome_mb, np.random.default_rng(seed))
    fa = os.path.join(WORK, tag + ".fa")
    write_fasta(fa, "chrS", codes)
    del codes
    t_gen = time.perf_counter() - t
    db_path = os.path.join(WORK, tag + ".db")
    t = time.perf_counter()
    cli.run(["index", "--reference", fa, "--database", db_path,
             "--enzyme", "spcas9ngg"])
    t_index = time.perf_counter() - t
    return db_path, t_gen, t_index


def main_path_inputs():
    """Phase 5's database and guides: the 400 Mbp genome indexed by the
    port's CLI, MAIN_GUIDES position-sampled guides written as a FASTA, and
    the guide sites the discover CLI finds in it, as the longs it scans (in
    its order: stable by start)."""
    db_path, t_gen, t_index = index_genome(MAIN_MB, 2024, "g400")
    db = cli.load_database(db_path)
    longs = sample_guides(db, MAIN_GUIDES, np.random.default_rng(7))
    fasta = os.path.join(WORK, "g400_guides.fa")
    write_guides(fasta, db, longs)
    gsites = cli.find_target_sites(cli.iterate_fasta(fasta), db.pack)
    scanned = np.asarray(gsites.sequences, dtype=np.uint64)[
        np.argsort(gsites.positions, kind="stable")]
    return db_path, db, fasta, longs, scanned, t_gen, t_index


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(smi.splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    say("phase 1 device: %s, torch %s, CUDA %s, numpy %s, %d device(s)"
        % (kind, torch.__version__, torch.version.cuda, np.__version__,
           torch.cuda.device_count()))
    return {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}


def timed_build(name: str):
    t = time.perf_counter()
    return _build.build(name), time.perf_counter() - t


def phase_build() -> None:
    fresh = {n: not _build.library_path(n).exists() for n in KERNEL_LIBS}
    t = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_LIBS)) as ex:  # one nvcc per source
        built = {n: f.result() for n, f in
                 [(n, ex.submit(timed_build, n)) for n in KERNEL_LIBS]}
    _build.stage1_library()
    _build.stage1_variants_library()
    say("phase 2 build: %d libraries in %.2fs" % (len(built), time.perf_counter() - t))
    for name, (path, secs) in built.items():
        say("  %s in %.2fs (%s)" % (os.path.relpath(path, ROOT), secs,
                                    "compiled" if fresh[name] else "cached"))
        for line in open(str(path) + ".log").read().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                say("  ptxas: " + line.strip())


def phase3_guides(picks: np.ndarray, rows, pack, L: int) -> torch.Tensor:
    """Phase 3's (G, 128) block-layout guides on the card: rows - rows // 16
    of picks padded to `rows`, or "512 super rows", the paired rows of a
    1024-row block (two 1s per position, the tool's "g2")."""
    n = 1024 if rows == "512 super rows" else rows
    oh, _, _ = guide_onehot_matrix(picks[:n - n // 16], pack, pad_to=n)
    gi8 = guide_block_layout(torch.from_numpy(oh).to(DEVICE), L)
    return sv.super_rows(gi8) if rows == "512 super rows" else gi8


def phase_kernel_vs_plain() -> int:
    """stage1 == stage1_reference on the card for all six enzymes, every
    PHASE3_ROWS and every thr from 1 to the active positions, on a ragged
    width with a PAD_CODE tail; returns the largest error."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=300_000, dtype=np.int8)
    fa = os.path.join(WORK, "small.fa")
    write_fasta(fa, "chrK", genome)
    n_cmp, err = 0, 0
    launches = stage1.launches
    for enzyme in ENZYMES:
        db_path = os.path.join(WORK, "small_%s.db" % enzyme)
        cli.run(["index", "--reference", fa, "--database", db_path,
                 "--enzyme", enzyme])
        db = cli.load_database(db_path)
        n, L = db.num_targets, db.pack.total_scan_length
        n_act = len(db.pack.comparison_mask_positions())
        scanner = DeviceScanner(db, DEVICE)
        # ragged width (not a multiple of the kernel's 64-target warp tile)
        # with 1001 PAD_CODE columns after the real targets
        extra = 1001 + (1 if (n + 1001) % 64 == 0 else 0)
        codes = torch.cat([scanner.codes[:, :n],
                           torch.full((32, extra), PAD_CODE, dtype=torch.int8,
                                      device=DEVICE)], dim=1).contiguous()
        picks = db.targets[rng.integers(0, n, size=2048)].astype(np.uint64)
        for j in range(picks.shape[0]):  # 0..6 random substitutions
            for pos in rng.integers(0, L, size=int(rng.integers(0, 7))):
                picks[j] ^= np.uint64(int(rng.integers(1, 4))) << np.uint64(2 * int(pos))
        for rows in PHASE3_ROWS:
            gi8 = phase3_guides(picks, rows, db.pack, L)
            sums = []
            for thr in range(1, n_act + 1):
                got = stage1(codes, gi8, thr)
                want = stage1_reference(codes, gi8, thr)
                err = max(err, max_abs_err(got, want, "stage1 %s G=%s thr=%d"
                                           % (enzyme, rows, thr)))
                if bool(got[n:].any()):
                    raise AssertionError("a padding column hit (%s)" % enzyme)
                sums.append(int(got.sum()))
                n_cmp += 1
            if not any(0 < h < n for h in sums):
                raise AssertionError("%s, G=%s: no thr at which some but not "
                                     "all targets hit (%s)" % (enzyme, rows, sums))
        say("  %s: N=%d (L=%d), G=%s, thr 1..%d: kernel == plain"
            % (enzyme, codes.shape[1], L, "/".join(map(str, PHASE3_ROWS)), n_act))
    if stage1.launches - launches != n_cmp:
        raise AssertionError("%d stage-1 launches for %d compares"
                             % (stage1.launches - launches, n_cmp))
    say("phase 3 kernel vs plain: %d bitwise-equal compares, one launch each"
        % n_cmp)
    return err


def phase_byte_identity() -> None:
    db_path, t_gen, t_index = index_genome(SMALL_MB, 2024, "g20")
    db = cli.load_database(db_path)
    say("phase 4 byte identity: %d Mbp, %d targets (genome %.1fs, index %.1fs)"
        % (SMALL_MB, db.num_targets, t_gen, t_index))
    fasta = os.path.join(WORK, "g20_guides.fa")
    write_guides(fasta, db, sample_guides(db, 200, np.random.default_rng(3)))
    byte_check(db_path, fasta, "g20_mm3", ("--maxMismatch", "3"))
    byte_check(db_path, fasta, "g20_mm4", ("--maxMismatch", "4"))
    r = byte_check(db_path, fasta, "g20_mm4_cap5",
                   ("--maxMismatch", "4", "--maximumOffTargets", "5"))
    if r["overflowed_guides"] == 0:
        raise AssertionError("no guide overflowed --maximumOffTargets 5")
    # enough guides for one 2048-row guide block, the main path's shape
    fasta = os.path.join(WORK, "g20_guides_2048.fa")
    write_guides(fasta, db, sample_guides(db, 1100, np.random.default_rng(7)))
    r = byte_check(db_path, fasta, "g20_mm4_2048", ("--maxMismatch", "4"))
    if guide_block_rows(r["guides"]) != 2048 or r["guides"] > 2048:
        raise AssertionError("%d guides are not one 2048-row block" % r["guides"])
    # --maxMismatch = the active positions on phase 3's 300 kb databases: the
    # scan skips stage 1 and recounts every real column on the card, so a
    # target that matches the guide at no active position is still reported
    for enzyme in ("spcas9ngg", "cpf1"):
        small = os.path.join(WORK, "small_%s.db" % enzyme)
        sdb = cli.load_database(small)
        fasta = os.path.join(WORK, "small_%s_guide.fa" % enzyme)
        write_guides(fasta, sdb, sdb.targets[sdb.num_targets // 2:][:1])
        n_act = len(sdb.pack.comparison_mask_positions())
        launches = stage1.launches
        r = byte_check(small, fasta, "small_%s_mm%d" % (enzyme, n_act),
                       ("--maxMismatch", str(n_act), "--maximumOffTargets", "1000000"))
        if r["guides"] != 1 or r["overflowed_guides"] or stage1.launches != launches:
            raise AssertionError("%s at mm=%d: %d guides, %d overflowed, %d "
                                 "stage-1 launches (want 1, 0, 0)"
                                 % (enzyme, n_act, r["guides"], r["overflowed_guides"],
                                    stage1.launches - launches))


def phase_main_path() -> dict:
    db_path, db, fasta, longs, scanned, t_gen, t_index = main_path_inputs()
    rows = guide_block_rows(scanned.shape[0])
    say("phase 5 main path: %d Mbp, %d targets, genome %.1fs, index %.1fs; "
        "%d guide sites in one %d-row guide block"
        % (MAIN_MB, db.num_targets, t_gen, t_index, scanned.shape[0], rows))
    if rows != 2048 or scanned.shape[0] > rows:
        raise AssertionError("the main path is not one 2048-row guide block")
    out = os.path.join(WORK, "g400_mm4.out")

    stage1.launches = 0
    t = time.perf_counter()
    report = cli.run(["discover", "--fasta", fasta, "--database", db_path,
                      "--output", out, "--positionOutput", "--maxMismatch", "4",
                      "--device", DEVICE])
    wall = time.perf_counter() - t
    launches = stage1.launches
    if launches == 0:
        raise AssertionError("the main path launched no stage-1 kernel")
    say("  discover CLI: %.4fs wall; index %.4fs, load %.4fs, guide sites "
        "%.4fs, plane upload+expand %.4fs, pruned counter %.4fs, scan %.4fs, "
        "collect %.4fs, write %.4fs; %d guides, %d overflowed, %d stage-1 "
        "launches" % (wall, t_index, report["load_s"], report["guide_sites_s"],
                      report["upload_expand_s"], report["counter_s"],
                      report["scan_s"], report["collect_s"], report["write_s"],
                      report["guides"], report["overflowed_guides"], launches))
    if report["guides"] != scanned.shape[0]:
        raise AssertionError("the CLI scanned %d guides, not %d"
                             % (report["guides"], scanned.shape[0]))

    want = engine.pruned_comparisons(db, scanned, 4)
    if report["all_comparisons"] != want:
        raise AssertionError("device counter %d != host pruned_comparisons %d"
                             % (report["all_comparisons"], want))
    say("  comparison counter: %d == host pruned_comparisons" % want)

    # the scan of the CLI's own guides, as it scans them
    scanner = DeviceScanner(db, DEVICE)
    t = time.perf_counter()
    t_idx, g_idx, mm = collect_hits(scanner, scanned, 4)
    t_scan = time.perf_counter() - t
    t = time.perf_counter()
    n_slice = oracle_slice_check(db, scanned, 4, t_idx, g_idx, mm)
    say("  DeviceScanner.scan of the CLI's %d guides: %d hits in %.4fs; "
        "oracle slice of %d targets matches (%d hits, %.1fs)"
        % (scanned.shape[0], t_idx.size, t_scan, ORACLE_SLICE, n_slice,
           time.perf_counter() - t))

    sub = os.path.join(WORK, "g400_guides32.fa")
    write_guides(sub, db, longs[:32])
    byte_check(db_path, sub, "g400_mm4_32g", ("--maxMismatch", "4"))

    # stage 1 over the whole database: the CLI's 2048-row guide block (the
    # main path's launch), then 1024 rows of it
    thr = max(len(db.pack.comparison_mask_positions()) - 4, 1)
    L = db.pack.total_scan_length
    timed, blocks, err, nums = {}, {}, 0, {}
    for g_rows, g in ((rows, scanned), (1024, scanned[:1024])):
        oh, _, _ = guide_onehot_matrix(g, db.pack, pad_to=g_rows)
        gi8 = guide_block_layout(torch.from_numpy(oh).to(DEVICE), L)
        got = stage1(scanner.codes, gi8, thr)
        ref = stage1_reference(scanner.codes, gi8, thr)
        err = max(err, max_abs_err(got, ref, "stage1 %d rows x the database"
                                   % g_rows))
        blocks[g_rows] = (gi8, ref)
        # in turns: plain, kernel, kernel, plain
        p1 = cuda_ms(lambda: stage1_reference(scanner.codes, gi8, thr), 3)
        k1 = cuda_ms(lambda: stage1(scanner.codes, gi8, thr), 10)
        k2 = cuda_ms(lambda: stage1(scanner.codes, gi8, thr), 10)
        p2 = cuda_ms(lambda: stage1_reference(scanner.codes, gi8, thr), 3)
        bare = k1_kernel_only_ms(scanner.codes, compact_guides(gi8), thr, ref)
        timed[g_rows] = ((k1 + k2) / 2, (p1 + p2) / 2, bare)
        say("  stage1 at (32, %d) x (%d, 128)%s: kernel %.3f ms (%.3f, %.3f), "
            "launcher alone %.3f ms, plain %.3f ms (%.3f, %.3f), %d hit bytes, "
            "bitwise equal"
            % (scanner.codes.shape[1], g_rows,
               " [main path]" if g_rows == rows else "", timed[g_rows][0], k1,
               k2, bare, timed[g_rows][1], p1, p2, int(got.sum())))
    oh = prebuilt_onehot(scanner.codes, codes_onehot_compact)
    for g_rows, (gi8, ref) in blocks.items():
        lib = library_ms(oh, compact_guides(gi8), lambda m: m.amax(dim=1) >= thr, ref)
        b = k1_bound(scanner.codes, g_rows)
        nums[g_rows] = {"ms": timed[g_rows][0], "plain_ms": timed[g_rows][1],
                        **b, "library_ms": lib, "kernel_only_ms": timed[g_rows][2]}
        say("  stage1 at %d rows: bound %.3f ms (%s; %.3f ms over 128 "
            "columns), library call %.3f ms"
            % (g_rows, b["bound_ms"], b["bound_by"], b["bound_ms_128"], lib))
    del oh, blocks
    return {"name": "stage1", "route": "cuda",
            "source": "flashfry_tpu_torch/csrc/stage1.cu",
            "replaces": STAGE1_TPU, "launches": launches,
            "max_abs_err": err, **nums.pop(rows),
            "variants": {"rows_%d" % r: v for r, v in nums.items()}}


def phase_variants():
    """Phase 6: the port's experiment tool at its own size on all twelve
    keys, then each kernel against its plain version, its bound and its
    library call. Returns the kernels-line entries of X1-X6 and the times
    of every key."""
    kernels = (stage1, *sv.KERNELS)
    for k in kernels:
        k.launches = 0
    t = time.perf_counter()
    inp, results = tool.run(device=DEVICE, chunk=VARIANT_CHUNK, G=VARIANT_GUIDES,
                            variants_spec=",".join(tool.ORDER))
    launches = {k.__name__: k.launches for k in kernels}
    say("phase 6 stage-1 variants: the tool ran %d lines in %.1fs; kernel "
        "launches %s" % (len(results), time.perf_counter() - t, json.dumps(launches)))
    for name, n in launches.items():
        if n == 0:
            raise AssertionError("the tool launched no %s kernel" % name)

    vs = tool.variants(inp, [r["key"] for r in results if "key" in r])
    n, G = inp.codes.shape[1], inp.guide_i8.shape[0]
    timed = {}
    for layout, onehot_T in tool.ONEHOT_T.items():
        group = [v for v in vs if v.layout == layout]
        oh = prebuilt_onehot(group[0].src, onehot_T)
        for v in group:
            err = max_abs_err(v.kernel(), v.plain(), v.name)
            # in turns: plain, kernel, kernel, plain; then the library call
            p1 = cuda_ms(v.plain, 5)
            k1 = cuda_ms(v.kernel, 10)
            k2 = cuda_ms(v.kernel, 10)
            p2 = cuda_ms(v.plain, 5)
            if v.rows is None:
                # e_copy: row 0 of the one-hot, N bytes read and N written
                b = bound(n, n)
                lib = cuda_ms(lambda: v.src[:1].clone(), 10)
                max_abs_err(v.src[:1].clone(), v.plain(), "library call")
            elif v.layout == "compact":
                b = {**k1_bound(v.src, v.rows.shape[0]),
                     "kernel_only_ms": k1_kernel_only_ms(v.src, v.rows, inp.thr,
                                                         v.plain())}
                lib = library_ms(oh, v.rows, v.epilogue, v.plain())
            else:
                b = product_bound(v.src, v.rows.shape[0])
                lib = library_ms(oh, v.rows, v.epilogue, v.plain())
            timed[v.key] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                            "max_abs_err": err, **b, "library_ms": lib}
            say("  %-32s kernel %.3f ms (%.3f, %.3f), plain %.3f ms (%.3f, "
                "%.3f), library %.3f ms, bound %.3f ms (%s), %.3g cmp/s, bitwise "
                "equal" % (v.name, timed[v.key]["ms"], k1, k2,
                           timed[v.key]["plain_ms"], p1, p2, lib, b["bound_ms"],
                           b["bound_by"], v.work / timed[v.key]["ms"] * 1e3))
        del oh

    # dot's guide loop has to scale with G (nvcc kept it); the bytes/s of
    # copy, which reads every row of the one-hot, as the TPU kernel did
    oh, thr = inp.expanded_onehot(), inp.thr
    half = inp.guide_i8[:G // 2].contiguous()
    max_abs_err(sv.expanded(oh, half, thr, "dot"),
                sv.expanded_reference(oh, half, thr, "dot"), "dot, G/2")
    dot_half = cuda_ms(lambda: sv.expanded(oh, half, thr, "dot"), 10)
    copy_bytes = (oh.numel() + n) / (timed["e_copy"]["ms"] / 1e3)
    say("  expanded dot at G=%d: %.3f ms vs %.3f ms at G=%d (ratio %.3f); "
        "expanded copy %.1f GB/s (%d bytes read + %d written)"
        % (G // 2, dot_half, timed["e_dot"]["ms"], G,
           timed["e_dot"]["ms"] / dot_half, copy_bytes / 1e9, oh.numel(), n))

    entries = []
    for name, (replaces, ks) in VARIANT_KERNELS.items():
        e = {"name": name, "route": "cuda", "source": VARIANTS_SRC,
             "replaces": replaces, "launches": launches[name],
             **{f: timed[ks[0]][f] for f in TIMED_FIELDS},
             "max_abs_err": max(timed[k]["max_abs_err"] for k in ks)}
        if len(ks) > 1:
            e["variants"] = {k: {f: timed[k][f] for f in TIMED_FIELDS} for k in ks}
        entries.append(e)
    return entries, timed


def profile_main_path(reps: int = 3, trace_dir: str = "") -> None:
    """Where the time of the 400 Mbp discover CLI goes. Not part of main().

    Runs the discover CLI of phase 5 `reps` times at mm 3, 4 and 5 (wall
    and the CLI's report), splits the plane build into host split_words,
    host-to-device copy and on-device expand, and runs one mm=5 call under
    torch.profiler: its wall, device time, the device's idle share and the
    top operators. With trace_dir, the profiler's Chrome trace goes there."""
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA card")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        phase_device()
        db_path, db, fasta, _longs, _scanned, _t_gen, t_index = main_path_inputs()
        say("profile: %d Mbp, %d targets, index %.4fs"
            % (MAIN_MB, db.num_targets, t_index))
        base = ["discover", "--fasta", fasta, "--database", db_path,
                "--output", os.path.join(WORK, "p.out"), "--positionOutput",
                "--device", DEVICE]
        for mm in (3, 4, 5):
            for rep in range(reps):
                t = time.perf_counter()
                r = cli.run(base + ["--maxMismatch", str(mm)])
                say("mm=%d rep=%d wall=%.4f %s"
                    % (mm, rep, time.perf_counter() - t, json.dumps(r)))

        n, L = db.num_targets, db.pack.total_scan_length
        buf = torch.full((32, n), PAD_CODE, dtype=torch.int8, device=DEVICE)
        t_split = t_h2d = t_expand = 0.0
        for lo in range(0, n, SLAB):
            t = time.perf_counter()
            w_lo, w_hi = split_words(db.targets[lo:lo + SLAB])
            t_split += time.perf_counter() - t
            t = time.perf_counter()
            d_lo = torch.from_numpy(w_lo).to(DEVICE)
            d_hi = torch.from_numpy(w_hi).to(DEVICE)
            torch.cuda.synchronize()
            t_h2d += time.perf_counter() - t
            t = time.perf_counter()
            expand_codes(buf, d_lo, d_hi, lo, L)
            torch.cuda.synchronize()
            t_expand += time.perf_counter() - t
        say("plane build split: split_words %.4fs, H2D %.4fs, expand %.4fs"
            % (t_split, t_h2d, t_expand))
        del buf

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            cli.run(base + ["--maxMismatch", "5"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        events = prof.key_averages()
        device_s = sum(e.self_device_time_total for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)) / 1e6
        say("profiled mm=5 call: wall %.4fs, device time %.4fs, device idle "
            "share %.4f" % (wall, device_s, 1 - device_s / wall))
        say(events.table(sort_by="self_device_time_total", row_limit=15))
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(trace_dir, "trace_discover_400mbp_mm5.json"))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "one CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        device = phase_device()
        phase_build()
        err = phase_kernel_vs_plain()
        phase_byte_identity()
        kernel = phase_main_path()
        variant_kernels, timed = phase_variants()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err,
                                timed["0"]["max_abs_err"], timed["g2"]["max_abs_err"])
    # K1 at the tool's shape: its 1024 guide rows and 512 super rows
    kernel["variants"].update(
        {k: {f: timed[k][f] for f in K1_FIELDS} for k in ("0", "g2")})
    say("total %.1fs" % (time.perf_counter() - t0))
    print(json.dumps({"kernels": [kernel] + variant_kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
