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
     17, 100, 127, 128, 129, 256, 257, 1152 and 2048 rows and 512 super
     rows, a ragged N and padding columns, one counted launch per call;
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
     whole database), at 1152 rows (the CLI's guides in a block padded to a
     multiple of 128 rows) and at 1024 rows; the CLI's plane build spans
     (the host copy of the raw words into pinned staging, the upload, the
     expand) and one expand-kernel launch per slab;
  5a. the plane build's expand kernel (csrc/planes.cu) bitwise against its
     plain version and timed beside it and its byte bound (8 B read and 32
     B written a target), at the build's slab of 4,194,304 targets, over
     the whole database in one launch (equal to the CLI build's resident
     planes), and at a slab in an odd width from an odd column;
  5b. the same database streamed through the card in target slabs, at
     bench.py's certification budget (CODE_ROWS x N / 2 bytes of planes,
     >= 3 slabs): every slab the double-buffered build hands out equals the
     resident planes' columns, with PAD_CODE past the last target; the
     streaming scan of the CLI's guides at mm=4 gives phase 5's resident
     hits per guide in order, with one stage-1 launch per slab and guide
     block; engine.discover on the streaming scanner writes phase 5's CLI
     bytes with as many launches; stage-1 kernel vs plain, bitwise and
     timed, on the last (partial) slab at the slab's shape; the streaming
     seconds beside the resident scan and plane-build seconds, and the
     streaming build's spans and kernel launches;
  5c. the port's `random` (1000 targets, seed 1) and `extract` (phase 3's
     SpCas9-NGG database) CLIs, their output read back and checked;
  5d. the same database sharded: (a) a virtual 2 db x 2 guides mesh on
     cuda:0 (parallel/mesh.py): each shard's planes (2 x 23.9M targets,
     once per (shard, guide sub-block)) equal the resident planes' columns,
     with PAD_CODE past them; ShardedScanner.scan of the CLI's guides at
     mm=4 gives phase 5's resident hits per guide in order, with one K1
     launch per (shard, sub-block): 4 for the one 2048-row block, split
     into 2 x 1024 rows; engine.discover on it writes phase 5's CLI bytes
     with as many launches; K1 against its plain version on one shard at
     the shard's shape, timed; its seconds beside the resident scan's;
     (b) two processes of the port's discover CLI (`--coordinator
     localhost:PORT --numProcesses 2 --processId {0,1}`, both on cuda:0,
     parallel/multihost.py, a gloo group): both exit 0, process 0 writes
     phase 5's CLI bytes and process 1 nothing, each report says
     multihost, one shard of half the targets and K1 launches; their wall
     seconds and gathered bytes;
  6. stage-1 variants at the experiment tool's size: the port's tool
     (`flashfry_tpu_torch.tools.experiment_stage1`) runs all twelve keys of
     the JAX tool on (32, 2^23) codes x 1024 guides and the (128, 2^23)
     one-hot (launches of every variant kernel > 0); then each kernel and
     mode (K1 and its 512 super rows, X1, X2, X3, X4 and its 512 super rows,
     X5 at two tiles, X6 in three modes) bitwise against its plain version
     and timed beside it, X6 dot at 512 guides, and X6 copy's bytes/s;
     then X4 (its wgmma kernel with the targets as M) bitwise against its
     plain version on a ragged 2^20-target slice with a PAD_CODE tail at 1,
     15, 16, 17, 100, 127, 128, 129, 1024, 1025 and 2048 guide rows and 512
     super rows, each at the
     thresholds -2^31, -257, -1, 0, 1, 16, 32, 33, 256, 257 and 2^31-1, one
     counted launch per call; and X1, X2, X3, X5 and X6 full/dot (the wgmma
     kernel) on the same slice, at 1, 63, 64, 65, 100, 127, 128, 129, 1024,
     1025 and 2048 guide rows and the same thresholds (X2 at the int16
     edges -2^15, -257, -1, 0, 1, 16, 32, 33, 256, 257 and 2^15-1), X3 on
     block-layout guides, X5 at target tiles 1, 100, 2048, 8192 and one
     past the slice, X6 on its expanded one-hot and on random 0/1 bytes;
  7. scoring: (a) the descriptor kernel K5 (`scoring/device.py`,
     csrc/descriptors.cu) bitwise against its plain version on off-targets
     with 0..9 planted mismatches, N of 1, 1000, 65,537 and 2^24, a 20-mer
     and a 19-mer enzyme, 1 and 1059 guides, and at 65,537 off-targets with
     0 and all L positions active, one counted launch per call, timed at
     2^24 beside the plain version and its bound; (b) the port's
     `score` CLI on phase 5's own discover output: five metrics on the card
     (`--backend device`), then `--backend numpy` and `--backend native`,
     the three files byte-identical, K5 launches > 0 on the first and 0 on
     the others; eleven metrics with a seeded BED, device against numpy;
     and K5 against plain at the shape that run gave it.

Beside each kernel's time the script computes its bound, the larger of its
int8 operations (the one-hot product over the columns it needs: 2 x 96 x G
x N for K1, whose guides have no base past position 23; 2 x 128 x G x N, as
the TPU kernel computes it, for X1-X6, with K1's 128-column figure beside
its own as bound_ms_128) over the H100's published 1,979 TOP/s and the
bytes the function needs (each input read once, each output written once)
over 3.35 TB/s, and times the library call: torch._int_mm of a pre-built
(N, 128) one-hot ((N, 96) for K1; built before timing) by the guides, then
the epilogue, in the plain version's column chunks; for X6 copy, whose
output is one-hot row 0, a clone of that row. For K1 it also times the
launcher alone on pre-compacted guides (kernel_only_ms), so that the
wrapper's own cost per call shows; so it does for X1, X2, X3, X4, X5 and X6
full/dot, whose wrappers check the guides' 0/1 bytes on every call (X3's
also permutes its guides to interleaved order, and its launcher alone is
X5's at t_tile 4096 on guides permuted beforehand). X6 copy is the tool's
read-rate probe: its bound is of the N bytes its output needs, while the
kernel, like the TPU kernel, reads the whole one-hot by design (its entry
says so and carries the bytes/s). K5's bound is its bytes (12 read and 8
written per off-target, and the guide codes); no single PyTorch call
computes it, so its library_ms is null; nor does one compute the expand's,
whose bound is its bytes too.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits 1 and prints no result. It imports neither JAX nor flashfry_tpu.

profile_main_path(), not run by main(), breaks the 400 Mbp discover CLI
down further (repeat runs at mm 3/4/5, the plane build's host copy,
upload and expand apart, a torch.profiler pass), and profile_streaming() the streaming scan of phase
5b (repeat scans beside the resident build and scan, its host copy apart,
a torch.profiler pass):

    python3 -c 'import chip_smoke; chip_smoke.profile_main_path()'
    python3 -c 'import chip_smoke; chip_smoke.profile_streaming()'

multi_card(), not run by main() either, runs phase 5d on a machine with
several cards: discover on one card and sharded over all of them,
the two scans in turns, K1 on each card, and the CLI in one process per
card (and in two processes of half the cards each):

    python3 -c 'import chip_smoke; chip_smoke.multi_card()'
"""

from __future__ import annotations

import contextlib
import filecmp
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from flashfry_tpu_torch import cli, engine, trace  # noqa: E402
from flashfry_tpu_torch.bitcoding import BitEncoding  # noqa: E402
from flashfry_tpu_torch.ops import _build  # noqa: E402
from flashfry_tpu_torch.ops.scan import (  # noqa: E402
    PAD_CODE, SLAB, DeviceScanner, expand_codes, expand_codes_plain,
    guide_block_rows, guide_onehot_matrix, interleaved_blocks, stage_words)
from flashfry_tpu_torch.ops import stage1_variants as sv  # noqa: E402
from flashfry_tpu_torch.parallel.mesh import ShardedScanner, make_mesh  # noqa: E402
from flashfry_tpu_torch.ops.scan_kernel import (  # noqa: E402
    _REF_ELEMS, CODE_ROWS, K_COLS, OH_ROWS, codes_onehot, codes_onehot_compact,
    compact_guides, guide_block_layout, launch, stage1, stage1_reference)
from flashfry_tpu_torch.scoring.device import (  # noqa: E402
    descriptors, descriptors_plain)
from flashfry_tpu_torch.standards import name_to_parameter_pack  # noqa: E402
from flashfry_tpu_torch.tools import experiment_stage1 as tool  # noqa: E402
from flashfry_tpu_torch.tools.experiment_stage1 import max_abs_err  # noqa: E402

ENZYMES = ("spcas9ngg", "spcas9", "spcas9nag", "spcas919", "spcas9ngg19",
           "cpf1")
WORK = os.path.join(ROOT, "_smoke_work")
DEVICE = "cuda"
SMALL_MB, MAIN_MB, MAIN_GUIDES = 20, 400, 1000
STAGE1_TPU = "flashfry_tpu/ops/scan_kernel.py:79"
# phase 3's guide blocks: rows around compact_guides' 16-row padding and the
# kernel's 128-row n-tile, the discover blocks (1152: 1059 guides padded to a
# multiple of 128 rows, 9 n-tiles), and the tool's paired rows
PHASE3_ROWS = (1, 15, 16, 17, 100, 127, 128, 129, 256, 257, "512 super rows", 1152,
               2048)
# K1's design, named in its kernels-line entry
K1_DESIGN = ("wgmma m64n128k32 s8 x s8 -> s32: targets as M (A, one-hot words "
             "built in registers from the code bytes), the whole guide block "
             "(<= 2048 x 96 B) staged once per block in shared memory as N (B), "
             "max and >= thr folded in registers; 4 warpgroups, one block per SM")
VARIANT_CHUNK, VARIANT_GUIDES = tool.CHUNK, tool.GUIDES  # the tool's own size
KERNEL_LIBS = ("stage1", "stage1_variants", "descriptors", "planes")
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
# phase 7: the descriptor kernel's sizes, enzymes (L = 23 and 22) and guide
# counts, and the score CLI's metric sets (bench.py's five and all eleven)
DESC_TPU = "flashfry_tpu/scoring/device.py:38"
# phase 5a: the plane build's expand kernel, which replaces an XLA function
# of the JAX package (no Pallas kernel), and its design
EXPAND_XLA = "flashfry_tpu/ops/scan.py:508"
EXPAND_DESIGN = ("one block of 256 threads per 1024 consecutive targets: each "
                 "thread packs the codes of 4 targets per row into a shared "
                 "word, then stores each row as aligned 4-byte words (a funnel "
                 "shift across two shared words) and its head and tail bytes")
DESC_N = (1, 1000, 65_537, 1 << 24)
DESC_ENZYMES = ("spcas9ngg", "spcas919")
DESC_GUIDES = (1, 1059)
FIVE_METRICS = "doench2016cfd,hsu2013,jostandsantos,minot,dangerous"
ELEVEN_METRICS = FIVE_METRICS + (",doench2014ontarget,moreno2015,bedannotator,"
                                 "reciprocalofftargets,folding,rank")
K1_FIELDS = TIMED_FIELDS + ("bound_ms_128", "kernel_only_ms")
# the wgmma kernels' tool keys, also timed through their launcher alone:
# (wrapper, launcher, the launcher's arguments after thr: t_tile or mode);
# X3's launcher takes its guides permuted to interleaved order
LAUNCHER_ONLY = {"1": (sv.v1_gloop, "ff_v1_gloop_launch", ()),
                 "3": (sv.v3_int16, "ff_v3_int16_launch", ()),
                 "4": (sv.v4_concat_onehot, "ff_v5_tile_launch", (sv.X3_T_TILE,)),
                 "5a": (sv.v5_tile, "ff_v5_tile_launch", (2048,)),
                 "5b": (sv.v5_tile, "ff_v5_tile_launch", (8192,)),
                 "e_full": (sv.expanded, "ff_expanded_launch", (sv.MODES["full"],)),
                 "e_dot": (sv.expanded, "ff_expanded_launch", (sv.MODES["dot"],)),
                 "bf": (sv.v6_bf16out, "ff_v6_bf16out_launch", ()),
                 "g2bf": (sv.v6_bf16out, "ff_v6_bf16out_launch", ())}
# X4's design, named in its kernels-line entry
X4_DESIGN = ("wgmma m64n128k32 s8 x s8 -> s32 over K = 128 (block layout): "
             "targets as M (A, one-hot words built in registers from 8 code "
             "bytes per lane per target by __vcmpeq4), <= 1024 guide rows a "
             "stage in shared memory as N (B), stages' bytes OR-ed, max and "
             ">= thr folded in registers; 4 warpgroups, one block per SM")
# X4's edge cases (phase 6): guide rows around its 128-row n-tile, the
# earlier design's 16-row m-tile and its 1024-row stage, the tool's paired
# rows; int32 thresholds around bf16's exact range and the counts' 0..32;
# the targets of the slice
X4_ROWS = (1, 15, 16, 17, 100, 127, 128, 129, 1024, 1025, 2048, "512 super rows")
THR_EDGES = (-2 ** 31, -257, -1, 0, 1, 16, 32, 33, 256, 257, 2 ** 31 - 1)
X4_EDGE_N = 1 << 20
# X1's, X2's, X3's, X5's and X6's edge cases (phase 6, the same slice): guide
# rows around the wgmma kernel's 64-row m-tile, X1's 128-row tile and the
# kernel's 1024-row stage; X5's target tiles around its 128-target B tile
# ("n+1": one tile longer than the slice); X2's thresholds at the int16
# edges, around the counts' 0..32
WGMMA_ROWS = (1, 63, 64, 65, 100, 127, 128, 129, 1024, 1025, 2048)
X5_TILES = (1, 100, 2048, 8192, "n+1")
INT16_THR_EDGES = (-2 ** 15, -257, -1, 0, 1, 16, 32, 33, 256, 257, 2 ** 15 - 1)


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


def kernel_only_ms(wrapper, fn, src: torch.Tensor, guides: torch.Tensor, thr: int,
                   want: torch.Tensor, *extra, reps: int = 10) -> float:
    """The launcher fn alone, without the wrapper's checks (the 0/1 guide
    check waits for the device once per call); its bytes must equal
    want's."""

    def call():
        return launch(wrapper, fn, src, guides, thr, *extra, check_guides=False)

    max_abs_err(call().view(want.dtype).reshape(want.shape), want, "%s launcher" % wrapper.__name__)
    return cuda_ms(call, reps)


def k1_kernel_only_ms(codes: torch.Tensor, compacted: torch.Tensor, thr: int,
                      want: torch.Tensor, reps: int = 10) -> float:
    """K1's launcher on guides compacted beforehand (compact_guides),
    without stage1's checks and compaction, which stage1 pays on every call."""
    return kernel_only_ms(stage1, _build.stage1_library().ff_stage1_launch, codes, compacted,
                          thr, want, reps=reps)


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
    _build.descriptors_library()
    _build.planes_library()
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
        # ragged width (not a multiple of the kernel's 64-target m-tile)
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
    spans, counts = report["spans"], report["counts"]
    slabs = -(-db.num_targets // SLAB)
    plane = {k: v for k, v in counts.items() if k.startswith("plane_build.")}
    card_us = plane.pop("plane_build.card_us", 0)
    if plane != {"plane_build.h2d_bytes": 8 * db.num_targets,
                 "plane_build.kernel_slabs": slabs} \
            or (card_us > 0) != (DEVICE != "cpu") \
            or card_us > 1e6 * spans["plane_build"]:
        raise AssertionError("plane build counts %s for %d targets in %d slabs"
                             % (counts, db.num_targets, slabs))
    say("  plane build: host copy into pinned staging %.4fs, upload %.4fs, "
        "expand %.4fs, on the card %.4fs (%d kernel slabs, %d bytes up)"
        % (spans["plane_build.split"], spans["plane_build.upload"],
           spans["plane_build.expand"], card_us / 1e6,
           counts["plane_build.kernel_slabs"], counts["plane_build.h2d_bytes"]))

    want = engine.pruned_comparisons(db, scanned, 4)
    if report["all_comparisons"] != want:
        raise AssertionError("device counter %d != host pruned_comparisons %d"
                             % (report["all_comparisons"], want))
    say("  comparison counter: %d == host pruned_comparisons" % want)

    # the scan of the CLI's own guides, as it scans them
    with trace.recording() as built, trace.span("plane_build"):
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
    # main path's launch), its guides in 1152 rows (a block padded to a
    # multiple of 128 rows), then 1024 rows of it
    thr = max(len(db.pack.comparison_mask_positions()) - 4, 1)
    L = db.pack.total_scan_length
    timed, blocks, err, nums = {}, {}, 0, {}
    for g_rows, g in ((rows, scanned), (1152, scanned), (1024, scanned[:1024])):
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
    entry = {"name": "stage1", "route": "cuda", "design": K1_DESIGN,
             "source": "flashfry_tpu_torch/csrc/stage1.cu",
             "replaces": STAGE1_TPU, "launches": launches,
             "max_abs_err": err, **nums.pop(rows),
             "variants": {"rows_%d" % r: v for r, v in nums.items()}}
    main = {"db": db, "db_path": db_path, "fasta": fasta, "scanned": scanned, "out": out,
            "cli_s": wall,
            "resident": scanner, "hits": (t_idx, g_idx, mm), "scan_s": t_scan,
            "build_s": built.spans["plane_build"],
            "expand_launches": counts["plane_build.kernel_slabs"]}
    return entry, main


def expand_timed(words: torch.Tensor, width: int, start: int, L: int,
                 want=None) -> dict:
    """The expand kernel against expand_codes_plain, bitwise, into
    columns [start, start + len(words)) of a PAD_CODE-filled (32, width)
    buffer (and, with want, the kernel's columns against want too), then
    both timed in turns beside the kernel's byte bound: 8 bytes read and 32
    written a target."""
    n = words.shape[0]
    got = torch.full((CODE_ROWS, width), PAD_CODE, dtype=torch.int8, device=DEVICE)
    ref = got.clone()
    expand_codes(got, words, start, L)
    expand_codes_plain(ref, words, start, L)
    err = max_abs_err(got, ref, "expand at (32, %d) from %d" % (width, start))
    if want is not None and not torch.equal(got[:, start:start + n], want):
        raise AssertionError("the expand kernel's planes differ from the build's")
    del ref
    p1 = cuda_ms(lambda: expand_codes_plain(got, words, start, L), 3)
    k1 = cuda_ms(lambda: expand_codes(got, words, start, L), 20)
    k2 = cuda_ms(lambda: expand_codes(got, words, start, L), 20)
    p2 = cuda_ms(lambda: expand_codes_plain(got, words, start, L), 3)
    return {"shape": [CODE_ROWS, width], "n": n, "start": start,
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            **bound(8 * n, CODE_ROWS * n), "library_ms": None,
            "max_abs_err": err, "runs_ms": [p1, k1, k2, p2]}


def phase_planes(main: dict) -> dict:
    """Phase 5a: the plane build's expand kernel (csrc/planes.cu) against
    its plain version, bitwise and timed with its byte bound, at the
    build's slab (SLAB targets) and over the whole database in one launch
    (there also equal to the resident planes the CLI's build made); then a
    slab at an odd width and offset. Returns its kernels-line entry."""
    db, resident = main["db"], main["resident"]
    n, L = db.num_targets, db.pack.total_scan_length
    words = torch.from_numpy(np.asarray(db.targets).view(np.int64)).to(DEVICE)
    slab = expand_timed(words[:SLAB], SLAB, 0, L, resident.codes[:, :SLAB])
    whole = expand_timed(words, n, 0, L, resident.codes)
    odd = expand_timed(words[:SLAB], SLAB + 7, 3, L, resident.codes[:, :SLAB])
    del words
    for what, t in (("slab", slab), ("whole database", whole),
                    ("odd width and offset", odd)):
        p1, k1, k2, p2 = t.pop("runs_ms")
        say("phase 5a expand, %s: (32, %d) from %d, %d targets: kernel %.4f ms "
            "(%.4f, %.4f), %.1f%% of its bound %.4f ms (%s); plain %.3f ms "
            "(%.3f, %.3f); bitwise equal"
            % (what, t["shape"][1], t["start"], t["n"], t["ms"], k1, k2,
               100 * t["bound_ms"] / t["ms"], t["bound_ms"], t["bound_by"],
               t["plain_ms"], p1, p2))
    err = max(t.pop("max_abs_err") for t in (slab, whole, odd))
    return {"name": "expand", "route": "cuda", "design": EXPAND_DESIGN,
            "source": "flashfry_tpu_torch/csrc/planes.cu",
            "replaces": "none (XLA: %s _expand_codes_jit)" % EXPAND_XLA,
            "launches": main["expand_launches"], "max_abs_err": err, **slab,
            "variants": {"database": whole, "odd_width": odd}}


def per_guide(hits):
    """(t_idx, g_idx, mm) in scan order -> the same rows, stably grouped by
    guide: each guide's hits in the order the scan gave them."""
    order = np.argsort(hits[1], kind="stable")
    return [np.asarray(a)[order] for a in hits]


def phase_streaming(kernel: dict, main: dict) -> None:
    """Phase 5b: phase 5's database streamed through the card in slabs at
    bench.py's certification budget, CODE_ROWS * n // 2 bytes of planes.
    Each slab the double-buffered build hands out equals the resident
    planes' columns (PAD_CODE past the last target); the scan of the CLI's
    guides gives phase 5's resident hits per guide in order, with one K1
    launch per slab and guide block; engine.discover on the streaming
    scanner writes phase 5's CLI bytes; K1 against its plain version on the
    last (partial) slab, timed at the slab's shape."""
    db, scanned, resident = main["db"], main["scanned"], main["resident"]
    n = db.num_targets
    stream = DeviceScanner(db, DEVICE, budget=CODE_ROWS * n // 2)
    if stream.mode != "streaming" or stream.slabs < 3:
        raise AssertionError("budget %d gave %s in %d slabs"
                             % (CODE_ROWS * n // 2, stream.mode, stream.slabs))
    blocks = len(interleaved_blocks(scanned.shape[0],
                                    guide_block_rows(scanned.shape[0])))
    say("phase 5b streaming: budget %d bytes for %d bytes of planes: %d slabs "
        "of %d targets, %d guide block(s)"
        % (CODE_ROWS * n // 2, CODE_ROWS * n, stream.slabs, stream.slab_n, blocks))
    for t_lo, codes, n_valid in stream.stream_slabs():
        if not (torch.equal(codes[:, :n_valid], resident.codes[:, t_lo:t_lo + n_valid])
                and bool((codes[:, n_valid:] == PAD_CODE).all())):
            raise AssertionError("slab at %d differs from the resident planes" % t_lo)
        last = codes
    say("  each of the %d slabs the copy stream built equals the resident "
        "planes' columns" % stream.slabs)

    stage1.launches = 0
    t = time.perf_counter()
    with trace.recording() as rec:
        hits = collect_hits(stream, scanned, 4)
    t_stream = time.perf_counter() - t
    launches = stage1.launches
    pieces = sum(-(-min(stream.slab_n, n - lo) // SLAB)
                 for lo in range(0, n, stream.slab_n))
    plane = dict(rec.counts)
    card_us = plane.pop("plane_build.card_us", 0)
    if plane != {"plane_build.h2d_bytes": 8 * n,
                 "plane_build.kernel_slabs": pieces} \
            or (card_us > 0) != (DEVICE != "cpu") or card_us > 1e6 * t_stream:
        raise AssertionError("streaming plane build counts %s, want %d bytes, "
                             "%d kernel slabs and the card's time"
                             % (rec.counts, 8 * n, pieces))
    say("  streaming plane build: host copy into pinned staging %.4fs, upload "
        "enqueue and staging waits %.4fs, expand enqueue %.4fs, on the card "
        "%.4fs, %d kernel slabs"
        % (rec.spans["plane_build.split"], rec.spans["plane_build.upload"],
           rec.spans["plane_build.expand"], card_us / 1e6, pieces))
    want = per_guide(main["hits"])
    if launches != stream.slabs * blocks:
        raise AssertionError("%d stage-1 launches streaming %d slabs x %d blocks"
                             % (launches, stream.slabs, blocks))
    if not all(np.array_equal(a, b) for a, b in zip(per_guide(hits), want)):
        raise AssertionError("the streaming scan's hits differ from the resident scan's")
    say("  DeviceScanner.scan streaming the CLI's %d guides at mm=4: %.4fs, "
        "%d hits == the resident scan's per guide in order; %d stage-1 "
        "launches; resident scan %.4fs + planes build %.4fs = %.4fs"
        % (scanned.shape[0], t_stream, hits[0].size, launches, main["scan_s"],
           main["build_s"], main["scan_s"] + main["build_s"]))

    sites = cli.find_target_sites(cli.iterate_fasta(main["fasta"]), db.pack,
                                  flanking_sequence=6, capture_context=True)
    stage1.launches = 0
    t = time.perf_counter()
    guides = engine.discover(db, sites, max_mismatch=4, device=DEVICE,
                             scanner=stream)
    t_discover = time.perf_counter() - t
    discover_launches = stage1.launches
    out = os.path.join(WORK, "g400_mm4_stream.out")
    cli.write_output(out, guides, db.bit_encoding(), db.bit_position(),
                     models=(), write_ots=True, write_positions=True)
    if discover_launches != stream.slabs * blocks:
        raise AssertionError("%d stage-1 launches in the streaming discover"
                             % discover_launches)
    if not filecmp.cmp(out, main["out"], shallow=False):
        raise AssertionError("streaming discover output differs from phase 5's CLI")
    say("  engine.discover on the streaming scanner: %.4fs, %d stage-1 "
        "launches, %d bytes identical to phase 5's CLI output"
        % (t_discover, discover_launches, os.path.getsize(out)))

    # K1 on the last slab (partial: PAD_CODE past its targets), as streaming
    # launches it: the CLI's guide block over the whole slab width
    thr = len(db.pack.comparison_mask_positions()) - 4
    oh, _, _ = guide_onehot_matrix(scanned, db.pack,
                                   pad_to=guide_block_rows(scanned.shape[0]))
    gi8 = guide_block_layout(torch.from_numpy(oh).to(DEVICE), db.pack.total_scan_length)
    ref = stage1_reference(last, gi8, thr)
    err = max_abs_err(stage1(last, gi8, thr), ref, "stage1 on the last slab")
    p1 = cuda_ms(lambda: stage1_reference(last, gi8, thr), 3)
    k1 = cuda_ms(lambda: stage1(last, gi8, thr), 10)
    k2 = cuda_ms(lambda: stage1(last, gi8, thr), 10)
    p2 = cuda_ms(lambda: stage1_reference(last, gi8, thr), 3)
    lib = library_ms(prebuilt_onehot(last, codes_onehot_compact), compact_guides(gi8),
                     lambda m: m.amax(dim=1) >= thr, ref)
    b = k1_bound(last, gi8.shape[0])
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
    kernel["variants"]["streaming_slab"] = {
        "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, **b, "library_ms": lib,
        "kernel_only_ms": k1_kernel_only_ms(last, compact_guides(gi8), thr, ref),
        "launches": launches, "slabs": stream.slabs, "slab_n": stream.slab_n,
        "scan_s": t_stream, "discover_s": t_discover,
        "stream_split_s": rec.spans["plane_build.split"],
        "stream_upload_s": rec.spans["plane_build.upload"],
        "stream_expand_s": rec.spans["plane_build.expand"],
        "stream_card_s": card_us / 1e6,
        "resident_scan_s": main["scan_s"], "resident_build_s": main["build_s"]}
    say("  stage1 at the slab's (32, %d) x (%d, 128): kernel %.3f ms (%.3f, "
        "%.3f), plain %.3f ms, library %.3f ms, bound %.3f ms (%s), bitwise equal"
        % (stream.slab_n, gi8.shape[0], (k1 + k2) / 2, k1, k2, (p1 + p2) / 2, lib,
           b["bound_ms"], b["bound_by"]))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_discover(db_path: str, fasta: str, tag: str, extra=(),
                     visible=(None, None), timeout: float = 300) -> tuple:
    """The port's discover CLI in len(visible) processes on DEVICE
    (`--coordinator localhost:PORT --numProcesses N --processId i`),
    process i seeing the cards visible[i] names (CUDA_VISIBLE_DEVICES;
    None: every card), each with its own --output path in WORK; all must
    exit 0 within `timeout` seconds (all are killed past it). Returns the
    output paths, the reports (the CLI logs its report as JSON) and the
    processes' wall seconds."""
    coordinator = "localhost:%d" % free_port()
    n = len(visible)
    outs = [os.path.join(WORK, "%s.p%d.out" % (tag, pid)) for pid in range(n)]
    t = time.perf_counter()
    procs = []
    for pid, cards in enumerate(visible):
        env = dict(os.environ, PYTHONPATH=ROOT)
        if cards is not None:
            env["CUDA_VISIBLE_DEVICES"] = cards
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "flashfry_tpu_torch", "discover", "--fasta", fasta,
             "--database", db_path, "--output", outs[pid], "--positionOutput", *extra,
             "--device", DEVICE, "--coordinator", coordinator, "--numProcesses", str(n),
             "--processId", str(pid)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        done = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t
    reports = []
    for pid, (p, (_out, err)) in enumerate(zip(procs, done)):
        if p.returncode != 0:
            raise AssertionError("discover process %d exited %d:\n%s"
                                 % (pid, p.returncode, err[-3000:]))
        reports.append(json.loads(re.search(r"discover report: (\{.*\})", err).group(1)))
    return outs, reports, wall


def phase_sharded(kernel: dict, main: dict) -> None:
    """Phase 5d: phase 5's database sharded. (a) On a virtual 2 x 2 mesh of
    one card: each (shard, sub-block)'s planes equal the resident planes'
    columns; the scan of the CLI's guides gives phase 5's resident hits per
    guide in order with one K1 launch per (shard, sub-block); engine.discover
    on it writes phase 5's CLI bytes; K1 against its plain version on one
    shard, timed at the shard's shape. (b) The discover CLI in two processes
    on the card: process 0 writes phase 5's CLI bytes, process 1 nothing."""
    db, scanned, resident = main["db"], main["scanned"], main["resident"]
    n = db.num_targets
    card = "cuda:0" if DEVICE == "cuda" else DEVICE
    t = time.perf_counter()
    sharded = ShardedScanner(db, mesh=make_mesh([card] * 4))
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    D, Gx, shard_n = sharded.D, sharded.Gx, sharded.shard_n
    say("phase 5d sharded: a virtual %d db x %d guides mesh on %s, %d targets per "
        "shard, %d bytes of planes per (shard, sub-block), built in %.4fs"
        % (D, Gx, card, shard_n, CODE_ROWS * shard_n, t_build))
    if (D, Gx) != (2, 2):
        raise AssertionError("4 devices gave a %d x %d mesh" % (D, Gx))
    for (s, q), planes in sharded.planes.items():
        lo, nv = s * shard_n, sharded.shard_valid(s)
        if not (torch.equal(planes[:, :nv], resident.codes[:, lo:lo + nv])
                and bool((planes[:, nv:] == PAD_CODE).all())):
            raise AssertionError("shard (%d, %d) differs from the resident planes" % (s, q))
    say("  each of the %d (shard, sub-block) planes equals the resident planes' "
        "columns, PAD_CODE past them" % len(sharded.planes))

    block = sharded.block_rows(scanned.shape[0])
    sub = block // Gx
    idx = interleaved_blocks(scanned.shape[0], block)
    want_launches = D * sum(1 for b in idx for q in range(Gx) if b[q * sub:(q + 1) * sub].size)
    if (len(idx), block, want_launches) != (1, 2048, 4):
        raise AssertionError("%d guides gave %d blocks of %d rows, %d launches"
                             % (scanned.shape[0], len(idx), block, want_launches))
    stage1.launches = 0
    t = time.perf_counter()
    hits = collect_hits(sharded, scanned, 4)
    t_scan = time.perf_counter() - t
    launches = stage1.launches
    if launches != want_launches:
        raise AssertionError("%d stage-1 launches in the sharded scan, not %d"
                             % (launches, want_launches))
    if not all(np.array_equal(a, b) for a, b in zip(per_guide(hits), per_guide(main["hits"]))):
        raise AssertionError("the sharded scan's hits differ from the resident scan's")
    say("  ShardedScanner.scan of the CLI's %d guides at mm=4 (one %d-row block, "
        "%d x %d-row sub-blocks): %.4fs, %d hits == the resident scan's per guide in "
        "order; %d stage-1 launches; resident scan %.4fs + planes build %.4fs"
        % (scanned.shape[0], block, Gx, sub, t_scan, hits[0].size, launches,
           main["scan_s"], main["build_s"]))

    sites = cli.find_target_sites(cli.iterate_fasta(main["fasta"]), db.pack,
                                  flanking_sequence=6, capture_context=True)
    stage1.launches = 0
    t = time.perf_counter()
    guides = engine.discover(db, sites, max_mismatch=4, device=DEVICE, scanner=sharded)
    t_discover = time.perf_counter() - t
    discover_launches = stage1.launches
    out = os.path.join(WORK, "g400_mm4_sharded.out")
    cli.write_output(out, guides, db.bit_encoding(), db.bit_position(),
                     models=(), write_ots=True, write_positions=True)
    if discover_launches != want_launches:
        raise AssertionError("%d stage-1 launches in the sharded discover" % discover_launches)
    if not filecmp.cmp(out, main["out"], shallow=False):
        raise AssertionError("sharded discover output differs from phase 5's CLI")
    say("  engine.discover on the sharded scanner: %.4fs, %d stage-1 launches, %d "
        "bytes identical to phase 5's CLI output"
        % (t_discover, discover_launches, os.path.getsize(out)))

    # K1 on shard 0, as the sharded scan launches it: sub-block 0's rows
    thr = len(db.pack.comparison_mask_positions()) - 4
    codes = sharded.planes[0, 0]
    oh, _, _ = guide_onehot_matrix(scanned[idx[0][:sub]], db.pack, pad_to=sub)
    gi8 = guide_block_layout(torch.from_numpy(oh).to(codes.device), db.pack.total_scan_length)
    ref = stage1_reference(codes, gi8, thr)
    err = max_abs_err(stage1(codes, gi8, thr), ref, "stage1 on shard 0")
    p1 = cuda_ms(lambda: stage1_reference(codes, gi8, thr), 3)
    k1 = cuda_ms(lambda: stage1(codes, gi8, thr), 10)
    k2 = cuda_ms(lambda: stage1(codes, gi8, thr), 10)
    p2 = cuda_ms(lambda: stage1_reference(codes, gi8, thr), 3)
    lib = library_ms(prebuilt_onehot(codes, codes_onehot_compact), compact_guides(gi8),
                     lambda m: m.amax(dim=1) >= thr, ref)
    b = k1_bound(codes, gi8.shape[0])
    entry = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, **b, "library_ms": lib,
             "kernel_only_ms": k1_kernel_only_ms(codes, compact_guides(gi8), thr, ref),
             "launches": launches, "mesh": [D, Gx], "shard_n": shard_n,
             "build_s": t_build, "scan_s": t_scan, "discover_s": t_discover,
             "resident_scan_s": main["scan_s"], "resident_build_s": main["build_s"]}
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
    kernel["variants"]["sharded_shard"] = entry
    say("  stage1 at the shard's (32, %d) x (%d, 128): kernel %.3f ms (%.3f, %.3f), "
        "plain %.3f ms, library %.3f ms, bound %.3f ms (%s), bitwise equal"
        % (shard_n, gi8.shape[0], entry["ms"], k1, k2, entry["plain_ms"], lib,
           b["bound_ms"], b["bound_by"]))
    del sharded, codes, gi8, ref

    outs, reports, wall = process_discover(main["db_path"], main["fasta"], "g400_mh",
                                           ("--maxMismatch", "4"))
    if not filecmp.cmp(outs[0], main["out"], shallow=False):
        raise AssertionError("process 0's output differs from phase 5's CLI")
    if os.path.exists(outs[1]):
        raise AssertionError("process 1 wrote an output")
    for pid, r in enumerate(reports):
        if ((r["scan_mode"], r["shards"], r["shard_n"], r["process"])
                != ("multihost", [2, 1], -(-n // 2), pid)
                or r["stage1_launches"] < (DEVICE == "cuda")):
            raise AssertionError("process %d's report: %s" % (pid, json.dumps(r)))
        say("  discover process %d: scan %.4fs, planes of its shard %.4fs, counter "
            "%.4fs, collect %.4fs, write %.4fs; %d stage-1 launches; gathered %d bytes "
            "in %d calls" % (pid, r["scan_s"], r["upload_expand_s"], r["counter_s"],
                             r["collect_s"], r["write_s"], r["stage1_launches"],
                             r["gathered_bytes"], r["gather_calls"]))
    say("  two discover processes on %s: %.4fs wall, their start included (phase "
        "5's CLI in process: %.4fs); process 0 wrote %d bytes identical to phase 5's "
        "CLI output, process 1 none"
        % (card, wall, main["cli_s"], os.path.getsize(outs[0])))
    entry["two_processes"] = {"wall_s": wall, "scan_s": [r["scan_s"] for r in reports],
                              "launches": [r["stage1_launches"] for r in reports],
                              "gathered_bytes": reports[0]["gathered_bytes"],
                              "gather_calls": reports[0]["gather_calls"]}


def phase_host_commands() -> None:
    """The port's random and extract commands on the card's machine:
    1000 random SpCas9-NGG targets from seed 1, and every target of phase
    3's SpCas9-NGG database, read back and checked."""
    rnd = os.path.join(WORK, "random.fa")
    cli.run(["random", "--outputFile", rnd, "--enzyme", "spcas9ngg",
             "--randomCount", "1000", "--seed", "1"])
    lines = open(rnd).read().splitlines()
    seqs = lines[1::2]
    if (len(seqs) != 1000 or len(set(seqs)) != 1000
            or any(len(q) != 23 or not q.endswith("GG") for q in seqs)):
        raise AssertionError("random did not write 1000 distinct NGG targets")
    db_path = os.path.join(WORK, "small_spcas9ngg.db")
    ext = os.path.join(WORK, "extract.fa")
    cli.run(["extract", "--binaryOTFile", db_path, "--outputFile", ext])
    db = cli.load_database(db_path)
    want, _ = db.bit_encoding().decode_batch(db.targets)
    got = open(ext).read().splitlines()[1::2]
    if got != list(want):
        raise AssertionError("extract did not write the database's %d targets"
                             % db.num_targets)
    say("phase 5c host commands: random wrote 1000 distinct targets, extract "
        "the %d targets of %s" % (db.num_targets, os.path.basename(db_path)))


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
            if v.key in LAUNCHER_ONLY:
                wrapper, fn, extra = LAUNCHER_ONLY[v.key]
                fn = getattr(_build.stage1_variants_library(), fn)
                rows = sv.interleaved_from_block(v.rows) if v.key == "4" else v.rows
                b["kernel_only_ms"] = kernel_only_ms(wrapper, fn, v.src, rows, inp.thr,
                                                     v.plain(), *extra)
            timed[v.key] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                            "max_abs_err": err, **b, "library_ms": lib}
            say("  %-32s kernel %.3f ms (%.3f, %.3f), plain %.3f ms (%.3f, "
                "%.3f), library %.3f ms, bound %.3f ms (%s), %.3g cmp/s, bitwise "
                "equal%s" % (v.name, timed[v.key]["ms"], k1, k2,
                             timed[v.key]["plain_ms"], p1, p2, lib, b["bound_ms"],
                             b["bound_by"], v.work / timed[v.key]["ms"] * 1e3,
                             "; launcher alone %.3f ms" % b["kernel_only_ms"]
                             if "kernel_only_ms" in b else ""))
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
    x4_edges(inp.codes)
    wgmma_edges(inp.codes)

    entries = []
    for name, (replaces, ks) in VARIANT_KERNELS.items():
        e = {"name": name, "route": "cuda", "source": VARIANTS_SRC,
             "replaces": replaces, "launches": launches[name],
             **{f: timed[ks[0]][f] for f in TIMED_FIELDS + ("kernel_only_ms",)
                if f in timed[ks[0]]},
             "max_abs_err": max(timed[k]["max_abs_err"] for k in ks)}
        if name == "v6_bf16out":
            e["design"] = X4_DESIGN
        if len(ks) > 1:
            e["variants"] = {k: {f: timed[k][f] for f in TIMED_FIELDS + ("kernel_only_ms",)
                                 if f in timed[k]} for k in ks}
        if "e_copy" in ks:
            # the tool's read-rate probe: its output needs only one-hot row 0,
            # and the kernel, like the TPU kernel, reads every row by design
            e["variants"]["e_copy"].update(
                role="read-rate probe", bytes_read=oh.numel(), bytes_written=n,
                bytes_per_s=copy_bytes,
                bound_note="bound_ms is of the %d bytes the output needs (row 0 "
                           "read, N written); the kernel reads all %d bytes of "
                           "the one-hot by design, as the TPU kernel did"
                           % (2 * n, oh.numel()))
        entries.append(e)
    return entries, timed


def x4_edge_guides(codes: torch.Tensor, n_real: int, rows, seed: int,
                   onehot_T=codes_onehot) -> torch.Tensor:
    """(G, 128) 0/1 guides on codes' device, in block layout (onehot_T =
    codes_onehot) or interleaved (sv.interleaved_onehot): one-hots of all 32
    code rows of random target columns among the first n_real with 0..6
    substitutions, every fourth row random 0/1 bytes (1s in columns 24..31
    too), the last G // 16 rows zero padding; or "512 super rows", the
    paired rows of such a 1024-row block."""
    n = 1024 if rows == "512 super rows" else rows
    dev = codes.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    cols = torch.randint(0, n_real, (n,), generator=gen, device=dev)
    sel = codes[:, cols].t().long()
    k = torch.randint(0, 7, (n, 1), generator=gen, device=dev)
    sub = torch.rand((n, 32), generator=gen, device=dev).argsort(dim=1) < k
    delta = torch.randint(1, 4, (n, 32), generator=gen, device=dev)
    guides = onehot_T(torch.where(sub, (sel + delta) % 4, sel).to(torch.int8))
    dense = (torch.rand((n, OH_ROWS), generator=gen, device=dev) < 0.25).to(torch.int8)
    guides[3::4] = dense[3::4]
    guides[n - n // 16:] = 0
    return sv.super_rows(guides) if rows == "512 super rows" else guides.contiguous()


def x4_edge_compares(codes: torch.Tensor, n_real: int, rows) -> int:
    """X4 == its plain version on codes (real targets first, then PAD_CODE
    columns) with x4_edge_guides(rows) at every THR_EDGES: every byte 1 at
    thr <= 0, none past 32, one counted launch per call. Returns the number
    of thresholds at which some but not all real targets hit."""
    guides = x4_edge_guides(codes, n_real, rows, seed=rows if isinstance(rows, int) else 512)
    launches, partial = sv.v6_bf16out.launches, 0
    for thr in THR_EDGES:
        got = sv.v6_bf16out(codes, guides, thr)
        max_abs_err(got, sv.v6_bf16out_reference(codes, guides, thr),
                    "v6_bf16out G=%s thr=%d" % (rows, thr))
        hits = int(got.sum())
        if (thr <= 0 and hits != codes.shape[1]) or (thr > 32 and hits):
            raise AssertionError("v6_bf16out G=%s thr=%d: %d of %d bytes set"
                                 % (rows, thr, hits, codes.shape[1]))
        partial += 0 < hits < n_real
    if sv.v6_bf16out.launches - launches != len(THR_EDGES) * (DEVICE == "cuda"):
        raise AssertionError("v6_bf16out G=%s: %d launches for %d calls"
                             % (rows, sv.v6_bf16out.launches - launches, len(THR_EDGES)))
    return partial


def x4_edges(codes: torch.Tensor) -> int:
    """Phase 6's X4 edge cases on the first X4_EDGE_N columns of codes with
    1001 PAD_CODE columns after them; returns the number of compares."""
    n_real = min(X4_EDGE_N, codes.shape[1])
    src = torch.cat([codes[:, :n_real],
                     torch.full((codes.shape[0], 1001), PAD_CODE, dtype=torch.int8,
                                device=codes.device)], dim=1).contiguous()
    partial = sum(x4_edge_compares(src, n_real, rows) for rows in X4_ROWS)
    if not partial:
        raise AssertionError("v6_bf16out: no threshold at which some but not all hit")
    n_cmp = len(X4_ROWS) * len(THR_EDGES)
    say("  v6_bf16out edges: (32, %d) with a PAD_CODE tail, G=%s, thr %s: %d "
        "bitwise-equal compares, one launch each"
        % (src.shape[1], "/".join(map(str, X4_ROWS)),
           "/".join(map(str, THR_EDGES)), n_cmp))
    return n_cmp


def wgmma_edge_compares(codes: torch.Tensor, n_real: int, rows: int) -> int:
    """X1 and X2, X3, X5 (at every X5_TILES) and X6 full and dot == their
    plain versions on codes (real targets first, then PAD_CODE columns)
    and, for X6, on two one-hots of them, expand_onehot's and random 0/1
    bytes with several 1s per group of four rows, with interleaved
    x4_edge_guides(rows) (X3: in block layout) at every THR_EDGES (X2 at
    INT16_THR_EDGES): every byte 1 at thr <= 0, none past the largest
    count (X1 with fewer than 128 rows: every byte -1 >= thr), one counted
    launch per call. Returns the number of (thr, input) pairs at which some
    but not all real targets hit."""
    guides = x4_edge_guides(codes, n_real, rows, seed=rows, onehot_T=sv.interleaved_onehot)
    blk = x4_edge_guides(codes, n_real, rows, seed=rows)
    n = codes.shape[1]
    gen = torch.Generator(device=codes.device).manual_seed(rows)
    dense = (torch.rand((OH_ROWS, n), generator=gen, device=codes.device) < 0.4).to(torch.int8)
    onehots = {"expand_onehot": sv.expand_onehot(codes, 23), "random 0/1": dense}
    tiles = [n + 1 if t == "n+1" else t for t in X5_TILES]
    kernels = (sv.v1_gloop, sv.v3_int16, sv.v4_concat_onehot, sv.v5_tile, sv.expanded)
    before = [k.launches for k in kernels]
    partial = 0

    def held(got, want, what, thr, top, floor=0):
        max_abs_err(got, want, "%s G=%d thr=%d" % (what, rows, thr))
        hits = int(got.sum())
        if (thr <= floor and hits != n) or (thr > top and hits):
            raise AssertionError("%s G=%d thr=%d: %d of %d bytes set" % (what, rows, thr, hits, n))
        return 0 < int(got[0, :n_real].sum()) < n_real

    # X1 reads only whole 128-row tiles; with none every byte is -1 >= thr
    x1_floor, x1_top = (0, 32) if rows >= sv.G_TILE else (-1, -1)
    for thr in THR_EDGES:
        partial += held(sv.v1_gloop(codes, guides, thr), sv.v1_gloop_reference(codes, guides, thr),
                        "v1_gloop", thr, x1_top, x1_floor)
        partial += held(sv.v4_concat_onehot(codes, blk, thr),
                        sv.v4_concat_onehot_reference(codes, blk, thr), "v4_concat_onehot",
                        thr, 32)
        want = sv.v5_tile_reference(codes, guides, thr)
        for t in tiles:
            partial += held(sv.v5_tile(codes, guides, thr, t), want, "v5_tile t_tile=%d" % t,
                            thr, 32)
        for name, oh in onehots.items():
            partial += held(sv.expanded(oh, guides, thr, "full"),
                            sv.expanded_reference(oh, guides, thr, "full"),
                            "expanded full on %s" % name, thr, OH_ROWS)
    for thr in INT16_THR_EDGES:
        partial += held(sv.v3_int16(codes, guides, thr), sv.v3_int16_reference(codes, guides, thr),
                        "v3_int16", thr, 32)
    for name, oh in onehots.items():
        max_abs_err(sv.expanded(oh, guides, 0, "dot"), sv.expanded_reference(oh, guides, 0, "dot"),
                    "expanded dot on %s G=%d" % (name, rows))
    calls = (len(THR_EDGES), len(INT16_THR_EDGES), len(THR_EDGES),
             len(THR_EDGES) * len(tiles), len(THR_EDGES) * 2 + 2)
    got = tuple(k.launches - b for k, b in zip(kernels, before))
    if got != tuple(c * (DEVICE == "cuda") for c in calls):
        raise AssertionError("G=%d: %s launches for %s calls" % (rows, got, calls))
    return partial


def wgmma_edges(codes: torch.Tensor) -> int:
    """Phase 6's X1, X2, X3, X5 and X6 edge cases on x4_edges' slice;
    returns the number of compares."""
    n_real = min(X4_EDGE_N, codes.shape[1])
    src = torch.cat([codes[:, :n_real],
                     torch.full((codes.shape[0], 1001), PAD_CODE, dtype=torch.int8,
                                device=codes.device)], dim=1).contiguous()
    partial = sum(wgmma_edge_compares(src, n_real, rows) for rows in WGMMA_ROWS)
    if not partial:
        raise AssertionError("v1_gloop/v3_int16/v4_concat_onehot/v5_tile/expanded: no "
                             "threshold at which some but not all hit")
    n_cmp = len(WGMMA_ROWS) * (len(THR_EDGES) * (len(X5_TILES) + 4) + len(INT16_THR_EDGES) + 2)
    say("  v1_gloop, v3_int16, v4_concat_onehot, v5_tile and expanded edges: (32, %d) with a "
        "PAD_CODE tail and two one-hots of it, G=%s, t_tile %s, thr %s (v3_int16: %s): %d "
        "bitwise-equal compares, one launch each"
        % (src.shape[1], "/".join(map(str, WGMMA_ROWS)), "/".join(map(str, X5_TILES)),
           "/".join(map(str, THR_EDGES)), "/".join(map(str, INT16_THR_EDGES)), n_cmp))
    return n_cmp


def planted_off_targets(n: int, g: int, enzyme: str, seed: int, device=None):
    """n off-targets of g random guides of `enzyme`, made on `device` from a
    seed and grouped by guide, as the score batch gives them: each is its
    guide with k substitutions (k uniform in 0..9) at distinct random active
    positions and a random PAM dinucleotide, so the mismatch counts 0, 1, 6,
    7 and beyond and the overflow bit all occur.
    Returns the descriptor pass's inputs (lo, hi, gi int32 (n,), gcodes (g,
    L) int8), the active position count, and k."""
    device = torch.device(device or DEVICE)
    pack = name_to_parameter_pack(enzyme)
    L, act_n = pack.total_scan_length, len(pack.comparison_mask_positions())
    gen = torch.Generator(device=device).manual_seed(seed)

    def randint(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=dtype)

    shifts = 2 * (L - 1 - torch.arange(L, device=device))
    glongs = randint(0, 1 << (2 * L), (g,))
    gcodes = ((glongs[:, None] >> shifts) & 3).to(torch.int8).contiguous()
    gi = randint(0, g, (n,), torch.int32).sort().values
    k = randint(0, 10, (n,))
    seq = torch.empty(n, dtype=torch.int64, device=device)
    for a in range(0, n, 1 << 21):
        b = min(n, a + (1 << 21))
        # the first k positions of a random order of the active positions
        order = torch.rand((b - a, act_n), generator=gen, device=device).argsort(dim=1)
        first_k = torch.arange(act_n, device=device)[None, :] < k[a:b, None]
        planted = torch.zeros_like(first_k).scatter_(1, order, first_k)
        flip = (randint(1, 4, (b - a, act_n)) * planted) << shifts[:act_n]
        seq[a:b] = glongs[gi[a:b].long()] ^ flip.sum(dim=1)
    seq = (seq & ~15) | randint(0, 16, (n,))
    words = seq.view(torch.int32).view(n, 2)  # little-endian: low word first
    return (words[:, 0].contiguous(), words[:, 1].contiguous(), gi, gcodes,
            act_n, k)


def descriptors_equal(inputs, what: str, planted: bool = True) -> int:
    """One counted launch of K5 on `inputs` (planted_off_targets' result):
    both words equal the plain version's, and the count and overflow bits
    say what was planted; with planted=False (act_n other than the
    enzyme's active positions) act_n = 0 gives no mismatch and more active
    positions count at least what was planted. Returns the largest error
    (0)."""
    lo, hi, gi, gcodes, act_n, k = inputs
    launches = descriptors.launches
    got = descriptors(lo, hi, gi, gcodes, act_n)
    torch.cuda.synchronize()
    want = descriptors_plain(lo, hi, gi, gcodes, act_n)
    err = 0
    for j, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError("%s w%d: kernel %s %s != plain %s %s"
                                 % (what, j, tuple(a.shape), a.dtype,
                                    tuple(b.shape), b.dtype))
        err = max(err, int((a.long() - b.long()).abs().max()) if a.numel() else 0)
        if err:
            raise AssertionError("%s w%d: kernel != plain in %d of %d words"
                                 % (what, j, int((a != b).sum()), a.numel()))
    k = k.to(torch.int32)
    count = (got[0] >> 27) & 7
    if not planted:
        says = (not bool(got[0].any()) and torch.equal(got[1], (lo & 15) << 27)
                if act_n == 0 else bool((count >= k.clamp(max=7)).all()))
    else:
        says = (torch.equal(count, k.clamp(max=7))
                and torch.equal((got[0] >> 30) & 1, (k > 6).to(torch.int32))
                and torch.equal((got[1] >> 27) & 15, lo & 15))
    if not says:
        raise AssertionError("%s: the words do not say what was planted" % what)
    if descriptors.launches - launches != (DEVICE == "cuda"):
        raise AssertionError("%s: %d launches for one call"
                             % (what, descriptors.launches - launches))
    return err


def descriptors_timed(inputs) -> dict:
    """K5 and its plain version on `inputs`, in turns (plain, kernel,
    kernel, plain), beside the bound of its bytes: lo, hi, gi and the guide
    codes read once, w0 and w1 written once. runs_ms holds the four runs."""
    lo, hi, gi, gcodes, act_n, _k = inputs
    p1 = cuda_ms(lambda: descriptors_plain(lo, hi, gi, gcodes, act_n), 3)
    k1 = cuda_ms(lambda: descriptors(lo, hi, gi, gcodes, act_n), 20)
    k2 = cuda_ms(lambda: descriptors(lo, hi, gi, gcodes, act_n), 20)
    p2 = cuda_ms(lambda: descriptors_plain(lo, hi, gi, gcodes, act_n), 3)
    n = lo.shape[0]
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            **bound(12 * n + gcodes.numel(), 8 * n), "library_ms": None,
            "shape": "N=%d, G=%d, L=%d" % (n, gcodes.shape[0], gcodes.shape[1]),
            "runs_ms": [p1, k1, k2, p2]}


def phase_descriptors() -> dict:
    """Phase 7a: K5 against its plain version at every DESC_N x
    DESC_ENZYMES x DESC_GUIDES, then timed at the largest. Returns K5's
    kernels-line entry without its main-path numbers."""
    err, n_cmp, timed, ungrouped = 0, 0, None, None
    for enzyme in DESC_ENZYMES:
        for g in DESC_GUIDES:
            for n in DESC_N:
                inputs = planted_off_targets(n, g, enzyme, seed=n + g)
                err = max(err, descriptors_equal(
                    inputs, "descriptors %s N=%d G=%d" % (enzyme, n, g)))
                n_cmp += 1
                if (enzyme, g, n) == (DESC_ENZYMES[0], DESC_GUIDES[-1], DESC_N[-1]):
                    timed = descriptors_timed(inputs)
                    # the same rows in random order: neighbouring threads
                    # then read different guide rows
                    perm = torch.randperm(n, device=inputs[0].device)
                    lo, hi, gi, gcodes, act_n, k = inputs
                    shuffled = (lo[perm], hi[perm], gi[perm], gcodes, act_n, k[perm])
                    descriptors_equal(shuffled, "descriptors, ungrouped")
                    n_cmp += 1
                    ungrouped = descriptors_timed(shuffled)
                    del perm, lo, hi, gi, k, shuffled
                del inputs
        # no active position, and every position (the PAM's too)
        inputs = planted_off_targets(65_537, DESC_GUIDES[-1], enzyme, seed=3)
        L = inputs[3].shape[1]
        for act_n in (0, L):
            err = max(err, descriptors_equal(
                inputs[:4] + (act_n,) + inputs[5:],
                "descriptors %s act_n=%d" % (enzyme, act_n), planted=False))
            n_cmp += 1
        del inputs
        say("  %s: N=%s, G=%s; act_n 0 and %d at N=65537: kernel == plain"
            % (enzyme, "/".join(map(str, DESC_N)), "/".join(map(str, DESC_GUIDES)), L))
    launches = descriptors.launches
    empty = planted_off_targets(0, 1, DESC_ENZYMES[0], seed=0)
    if descriptors(*empty[:5])[0].numel() or descriptors.launches != launches:
        raise AssertionError("N=0 launched the descriptor kernel")
    p1, k1, k2, p2 = timed["runs_ms"]
    say("phase 7a descriptors: %d bitwise-equal compares, one launch each; at %s "
        "kernel %.4f ms (%.4f, %.4f), plain %.3f ms (%.3f, %.3f), bound %.4f ms "
        "(%s), no library call; rows in random order: kernel %.4f ms, plain "
        "%.3f ms" % (n_cmp, timed["shape"], timed["ms"], k1, k2,
                     timed["plain_ms"], p1, p2, timed["bound_ms"],
                     timed["bound_by"], ungrouped["ms"], ungrouped["plain_ms"]))
    return {"name": "descriptors", "route": "cuda",
            "source": "flashfry_tpu_torch/csrc/descriptors.cu",
            "replaces": DESC_TPU, "launches": 0, "max_abs_err": err, **timed,
            "variants": {"ungrouped": ungrouped}}


def phase_score(kernel: dict) -> None:
    """Phase 7b: the port's score CLI on phase 5's discover output, on the
    card and on both host backends, byte for byte; fills K5's main-path
    launches and its numbers at the main path's shape into `kernel`."""
    db_path = os.path.join(WORK, "g400.db")
    base = ["score", "--input", os.path.join(WORK, "g400_mm4.out"),
            "--database", db_path]
    bed = os.path.join(WORK, "g400_regions.bed")
    rng = np.random.default_rng(5)
    starts = np.sort(rng.integers(0, MAIN_MB * 1_000_000, size=50_000))
    widths = rng.integers(100, 5_000, size=50_000)
    with open(bed, "w") as fh:
        fh.write("".join("chrS\t%d\t%d\tI%d\n" % (a, a + w, j)
                         for j, (a, w) in enumerate(zip(starts.tolist(), widths.tolist()))))

    def run(tag, metrics, backend, extra=()):
        out = os.path.join(WORK, "g400_%s.%s.scored" % (tag, backend))
        descriptors.launches = 0
        t = time.perf_counter()
        report = cli.run(base + ["--output", out, "--scoringMetrics", metrics,
                                 "--backend", backend, "--device", DEVICE, *extra])
        wall = time.perf_counter() - t
        launched = descriptors.launches
        say("  score %s --backend %s: %.4fs wall (parse %.4fs, write %.4fs, models "
            "%s); %d guides, %d off-targets, %d K5 launches"
            % (tag, backend, wall, report["parse_s"], report["write_s"],
               json.dumps({k: round(v, 4) for k, v in report["model_s"].items()}),
               report["guides"], report["off_targets"], launched))
        if (launched > 0) != (backend == "device"):
            raise AssertionError("--backend %s launched K5 %d times" % (backend, launched))
        return out, report, launched, wall

    say("phase 7b score: phase 5's discover output, %d bytes"
        % os.path.getsize(base[2]))
    # three rounds in turns, so that each backend's seconds show their spread
    walls = {"device": [], "numpy": [], "native": []}
    for rnd in range(3):
        for backend in walls:
            out, rep, launched, wall = run("five", FIVE_METRICS, backend)
            walls[backend].append(wall)
            if backend == "device":
                mine, report = out, rep
                if rnd == 0:
                    kernel["launches"] = launched
            elif not filecmp.cmp(mine, out, shallow=False):
                raise AssertionError("score --backend device differs from "
                                     "--backend %s" % backend)
    say("  five metrics: device, numpy and native byte-identical in 3 rounds, %d "
        "bytes; %d off-targets reached K5; wall seconds %s"
        % (os.path.getsize(mine), report["off_targets"],
           json.dumps({b: [round(w, 4) for w in ws] for b, ws in walls.items()})))
    extra = ("--inputAnnotationBed", "regions:" + bed)
    mine = run("eleven", ELEVEN_METRICS, "device", extra)[0]
    ref = run("eleven", ELEVEN_METRICS, "numpy", extra)[0]
    if not filecmp.cmp(mine, ref, shallow=False):
        raise AssertionError("eleven metrics: --backend device differs from numpy")
    with open(mine) as fh:
        if "regions" not in fh.readline().split("\t"):
            raise AssertionError("the BED column is missing from the scored header")
    say("  eleven metrics: device and numpy byte-identical, %d bytes"
        % os.path.getsize(mine))

    # K5 at the shape the score run gave it
    inputs = planted_off_targets(report["off_targets"], report["guides"],
                                 "spcas9ngg", seed=11)
    kernel["max_abs_err"] = max(kernel["max_abs_err"],
                                descriptors_equal(inputs, "descriptors, main path"))
    at_main = descriptors_timed(inputs)
    kernel["variants"]["main_path"] = at_main
    say("  K5 at the main path's %s: kernel %.4f ms, plain %.3f ms, bound %.5f ms"
        % (at_main["shape"], at_main["ms"], at_main["plain_ms"], at_main["bound_ms"]))


def profile_main_path(reps: int = 3, trace_dir: str = "") -> None:
    """Where the time of the 400 Mbp discover CLI goes. Not part of main().

    Runs the discover CLI of phase 5 `reps` times at mm 3, 4 and 5 (wall
    and the CLI's report), splits the plane build into the host copy into
    pinned staging, the host-to-device copy and the expand kernel, each
    waited for, and runs one mm=5 call under
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
        host = torch.empty(SLAB, dtype=torch.int64, pin_memory=True)
        t_copy = t_h2d = t_expand = 0.0
        for lo in range(0, n, SLAB):
            m = min(SLAB, n - lo)
            t = time.perf_counter()
            stage_words(host[:m], db.targets[lo:lo + m])
            t_copy += time.perf_counter() - t
            t = time.perf_counter()
            words = host[:m].to(DEVICE, non_blocking=True)
            torch.cuda.synchronize()
            t_h2d += time.perf_counter() - t
            t = time.perf_counter()
            expand_codes(buf, words, lo, L)
            torch.cuda.synchronize()
            t_expand += time.perf_counter() - t
        say("plane build apart: host copy into pinned staging %.4fs, H2D %.4fs, "
            "expand %.4fs" % (t_copy, t_h2d, t_expand))
        del buf, host

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            cli.run(base + ["--maxMismatch", "5"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        profile_table(prof, wall, "mm=5 call")
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(trace_dir, "trace_discover_400mbp_mm5.json"))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


def profile_table(prof, wall: float, what: str) -> None:
    """A torch.profiler pass's device time, the device's idle share over
    wall seconds, and its top operators by device and by host time."""
    events = prof.key_averages()
    device_s = sum(e.self_device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)) / 1e6
    say("profiled %s: wall %.4fs, device time %.4fs, device idle share %.4f"
        % (what, wall, device_s, 1 - device_s / wall))
    say(events.table(sort_by="self_device_time_total", row_limit=12))
    say(events.table(sort_by="self_cpu_time_total", row_limit=12))


def profile_streaming(reps: int = 3) -> None:
    """Where the time of phase 5b's streaming scan goes. Not part of main().

    On phase 5's database and the CLI's guides at mm=4: the resident plane
    build and scan, then `reps` streaming scans at phase 5b's budget (the
    first also allocates the pinned staging buffers), each wall beside the
    other; the host step of one scan apart (the copy of each slab's raw
    words into pinned staging); and one streaming scan under
    torch.profiler."""
    if not torch.cuda.is_available():
        raise SystemExit("profile_streaming needs a CUDA card")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        phase_device()
        _db_path, db, _fasta, _longs, scanned, _t_gen, _t_index = main_path_inputs()
        n = db.num_targets
        t = time.perf_counter()
        resident = DeviceScanner(db, DEVICE)
        t_build = time.perf_counter() - t
        walls = []
        for _ in range(reps):
            t = time.perf_counter()
            collect_hits(resident, scanned, 4)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        say("resident: planes build %.4fs, scans %s" % (t_build, walls))
        del resident
        stream = DeviceScanner(db, DEVICE, budget=CODE_ROWS * n // 2)
        walls = []
        for _ in range(reps):
            t = time.perf_counter()
            collect_hits(stream, scanned, 4)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        say("streaming: %d slabs of %d targets, scans %s"
            % (stream.slabs, stream.slab_n, walls))

        t = time.perf_counter()
        host = torch.empty(stream.slab_n, dtype=torch.int64, pin_memory=True)
        t_pin = time.perf_counter() - t
        t_copy = 0.0
        for lo in range(0, n, stream.slab_n):
            m = min(stream.slab_n, n - lo)
            t = time.perf_counter()
            stage_words(host[:m], db.targets[lo:lo + m])
            t_copy += time.perf_counter() - t
        say("host step of one streaming scan: copy into pinned staging %.4fs; "
            "one staging buffer allocated in %.4fs" % (t_copy, t_pin))
        del host

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            collect_hits(stream, scanned, 4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        profile_table(prof, wall, "streaming scan")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


def multi_card(reps: int = 3) -> None:
    """Phase 5d on a machine with several cards. Not part of main(), which
    needs one card:

        python3 -c 'import chip_smoke; chip_smoke.multi_card()'

    On phase 5's database and guides at mm = 4: engine.discover on one card
    ("cuda:0", resident) and on every card ("cuda", which shards over them),
    in turns, and the discover CLI with `--device cuda`, byte for byte; the
    resident scan on cuda:0
    and the ShardedScanner over every card, `reps` times each in turns, hits
    per guide in order; K1 against its plain version on each (shard,
    sub-block)'s card, timed there; then the CLI in one process per card
    (CUDA_VISIBLE_DEVICES) and, with four cards or more, in two processes
    of half the cards each, process 0's bytes against the one-card CLI's.
    Prints seconds, launches and gathered bytes; fails on any mismatch."""
    cards = torch.cuda.device_count() if DEVICE == "cuda" else 4
    if DEVICE == "cuda" and cards < 2:
        raise SystemExit("multi_card needs two or more CUDA cards, found %d" % cards)
    first = "cuda:0" if DEVICE == "cuda" else DEVICE
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        phase_device()
        phase_build()
        db_path, db, fasta, _longs, scanned, _t_gen, t_index = main_path_inputs()
        say("multi_card: %d cards; %d Mbp, %d targets, index %.4fs; %d guide sites"
            % (cards, MAIN_MB, db.num_targets, t_index, scanned.shape[0]))
        sites = cli.find_target_sites(cli.iterate_fasta(fasta), db.pack,
                                      flanking_sequence=6, capture_context=True)
        outs = {first: os.path.join(WORK, "one.out"), DEVICE: os.path.join(WORK, "every.out")}
        for dev in (first, DEVICE, DEVICE, first):
            stage1.launches = 0
            t = time.perf_counter()
            guides = engine.discover(db, sites, max_mismatch=4, device=dev)
            wall = time.perf_counter() - t
            cli.write_output(outs[dev], guides, db.bit_encoding(), db.bit_position(),
                             models=(), write_ots=True, write_positions=True)
            say("  engine.discover on %s, its scanner built inside: %.4fs, %d stage-1 "
                "launches" % (dev, wall, stage1.launches))
        if not filecmp.cmp(outs[first], outs[DEVICE], shallow=False):
            raise AssertionError("the sharded discover's output differs from one card's")
        cli_out = os.path.join(WORK, "cli.out")
        t = time.perf_counter()
        r = cli.run(["discover", "--fasta", fasta, "--database", db_path, "--positionOutput",
                     "--maxMismatch", "4", "--output", cli_out, "--device", DEVICE])
        wall = time.perf_counter() - t
        if DEVICE == "cuda" and (r["scan_mode"] != "sharded" or r["stage1_launches"] < 1):
            raise AssertionError("--device %s: %s" % (DEVICE, json.dumps(r)))
        if not filecmp.cmp(outs[first], cli_out, shallow=False):
            raise AssertionError("the discover CLI's output differs from one card's")
        say("  discover CLI --device %s: %.4fs wall; %s" % (DEVICE, wall, json.dumps(r)))
        say("  %s, every card and the CLI wrote the same %d bytes"
            % (first, os.path.getsize(outs[first])))

        resident = DeviceScanner(db, first)
        t = time.perf_counter()
        sharded = ShardedScanner(db, mesh=make_mesh(
            [torch.device("cuda", i) for i in range(cards)] if DEVICE == "cuda"
            else [DEVICE] * cards))
        for dev in {dev for row in sharded.mesh for dev in row}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        say("  ShardedScanner over a %d x %d mesh: planes of %d targets per shard "
            "built in %.4fs" % (sharded.D, sharded.Gx, sharded.shard_n,
                                time.perf_counter() - t))
        want = per_guide(collect_hits(resident, scanned, 4))
        times = {"resident": [], "sharded": []}
        launches = {}
        for _ in range(reps):
            for name in ("resident", "sharded", "sharded", "resident"):
                stage1.launches = 0
                t = time.perf_counter()
                hits = collect_hits(resident if name == "resident" else sharded, scanned, 4)
                times[name].append(time.perf_counter() - t)
                launches[name] = stage1.launches
                if not all(np.array_equal(a, b) for a, b in zip(per_guide(hits), want)):
                    raise AssertionError("the %s scan's hits differ" % name)
        say("  scans of the CLI's guides, in turns, hits per guide equal: resident "
            "on %s %s s; sharded %s s; stage-1 launches per scan %s"
            % (first, json.dumps(times["resident"]), json.dumps(times["sharded"]),
               json.dumps(launches)))

        thr = len(db.pack.comparison_mask_positions()) - 4
        block = sharded.block_rows(scanned.shape[0])
        sub = block // sharded.Gx
        idx = interleaved_blocks(scanned.shape[0], block)[0]
        for (s, q), planes in sharded.planes.items():
            rows = idx[q * sub:(q + 1) * sub]
            if not rows.size:
                continue
            oh, _, _ = guide_onehot_matrix(scanned[rows], db.pack, pad_to=sub)
            gi8 = guide_block_layout(torch.from_numpy(oh).to(planes.device),
                                     db.pack.total_scan_length)
            max_abs_err(stage1(planes, gi8, thr), stage1_reference(planes, gi8, thr),
                        "stage1 on shard (%d, %d)" % (s, q))
            with (torch.cuda.device(planes.device) if DEVICE == "cuda"
                  else contextlib.nullcontext()):
                ms = cuda_ms(lambda: stage1(planes, gi8, thr), 10)
            say("  stage1 on shard (%d, %d), %s, (32, %d) x (%d, 128): %.3f ms, "
                "bitwise equal to plain" % (s, q, planes.device, sharded.shard_n, sub, ms))
        del sharded, resident

        layouts = [tuple(str(i) for i in range(cards))]
        if cards >= 4 and cards % 2 == 0:
            half = cards // 2
            layouts.append((",".join(map(str, range(half))),
                            ",".join(map(str, range(half, cards)))))
        for visible in layouts:
            files, reports, wall = process_discover(db_path, fasta, "mc%d" % len(visible),
                                                    ("--maxMismatch", "4"), visible)
            if not filecmp.cmp(files[0], outs[first], shallow=False):
                raise AssertionError("process 0's output differs from one card's")
            if any(os.path.exists(f) for f in files[1:]):
                raise AssertionError("a process other than 0 wrote an output")
            for pid, r in enumerate(reports):
                if DEVICE == "cuda" and (r["scan_mode"] != "multihost"
                                         or r["shards"][0] * r["shards"][1] != cards
                                         or r["stage1_launches"] < 1):
                    raise AssertionError("process %d's report: %s" % (pid, json.dumps(r)))
            say("  %d discover processes (cards %s): %.4fs wall; process 0 wrote the "
                "one-card bytes; mesh %s; scan s %s; planes s %s; gathered %d bytes in "
                "%d calls; stage-1 launches %s"
                % (len(visible), "/".join(visible), wall, reports[0]["shards"],
                   json.dumps([r["scan_s"] for r in reports]),
                   json.dumps([r["upload_expand_s"] for r in reports]),
                   reports[0]["gathered_bytes"], reports[0]["gather_calls"],
                   [r["stage1_launches"] for r in reports]))
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
        kernel, main_path = phase_main_path()
        planes_kernel = phase_planes(main_path)
        phase_streaming(kernel, main_path)
        phase_sharded(kernel, main_path)
        del main_path
        phase_host_commands()
        variant_kernels, timed = phase_variants()
        desc_kernel = phase_descriptors()
        phase_score(desc_kernel)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err,
                                timed["0"]["max_abs_err"], timed["g2"]["max_abs_err"])
    # K1 at the tool's shape: its 1024 guide rows and 512 super rows
    kernel["variants"].update(
        {k: {f: timed[k][f] for f in K1_FIELDS} for k in ("0", "g2")})
    say("total %.1fs" % (time.perf_counter() - t0))
    print(json.dumps({"kernels": [kernel] + variant_kernels + [desc_kernel,
                                                              planes_kernel]}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
