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
     max_mismatch 0..5, 128 and 2048 guide rows, a ragged N and padding;
  4. 20 Mbp repeat-rich genome: the port's discover CLI output is
     byte-identical to `python -m flashfry_tpu ... --backend numpy` at mm=3,
     mm=4, with overflowing guides, and with enough guides for one
     2048-row guide block;
  5. the main path at real size: a 400 Mbp repeat-rich genome (~48M
     targets), 1000 position-sampled guides (1059 guide sites, one
     2048-row block) at mm=4 through the port's discover CLI, phase
     seconds, the comparison counter against the host counter, the scan of
     the CLI's own guides against the numpy oracle on a 2M-target slice, a
     32-guide byte check against the numpy CLI, stage-1 launches > 0, and
     stage-1 kernel vs plain, bitwise and timed, at the main path's shape
     (the CLI's 2048-row guide block x the whole database) and at 1024 rows;
  6. stage-1 variants at the experiment tool's size: the port's tool
     (`flashfry_tpu_torch.tools.experiment_stage1`) runs its default
     variants on (32, 2^23) codes x 1024 guides and the (128, 2^23) one-hot
     (launches of every variant kernel > 0); then each kernel and mode (K1,
     X2, X3, X5 at two tiles, X6 in three modes) bitwise against its plain
     version and timed beside it, X6 dot at 512 guides, and X6 copy's
     bytes/s.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits 1 and prints no result.

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

import bench  # noqa: E402  (repeat-rich genome, position-sampled guides, oracle slice)
from flashfry_tpu_torch import _numpy_compat  # noqa: E402,F401  (load_database)
from flashfry_tpu_torch import cli, engine  # noqa: E402
from flashfry_tpu_torch.ops import _build  # noqa: E402
from flashfry_tpu_torch.ops.scan import (  # noqa: E402
    PAD_CODE, SLAB, DeviceScanner, expand_codes, guide_block_rows,
    guide_onehot_matrix, split_words)
from flashfry_tpu_torch.ops import stage1_variants as sv  # noqa: E402
from flashfry_tpu_torch.ops.scan_kernel import (  # noqa: E402
    guide_block_layout, stage1, stage1_reference)
from flashfry_tpu_torch.tools import experiment_stage1 as tool  # noqa: E402
from flashfry_tpu_torch.tools.experiment_stage1 import max_abs_err  # noqa: E402

ENZYMES = ("spcas9ngg", "spcas9", "spcas9nag", "spcas919", "spcas9ngg19",
           "cpf1")
WORK = os.path.join(ROOT, "_smoke_work")
DEVICE = "cuda"
SMALL_MB, MAIN_MB, MAIN_GUIDES = 20, 400, 1000
STAGE1_TPU = "flashfry_tpu/ops/scan_kernel.py:79"
VARIANT_CHUNK, VARIANT_GUIDES = tool.CHUNK, tool.GUIDES  # the tool's own size
KERNEL_LIBS = ("stage1", "stage1_variants")
VARIANTS_SRC = "flashfry_tpu_torch/csrc/stage1_variants.cu"
# variant kernel -> (the TPU kernel it replaces, the tool's keys it runs;
# the first key's times are the kernel's in the kernels line)
VARIANT_KERNELS = {
    "v3_int16": ("tools/experiment_stage1.py:74", ("3",)),
    "v4_concat_onehot": ("tools/experiment_stage1.py:96", ("4",)),
    "v5_tile": ("tools/experiment_stage1.py:143", ("5a", "5b")),
    "expanded": ("tools/experiment_stage1.py:164", ("e_full", "e_dot", "e_copy")),
}


def say(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card, from CUDA events over
    reps calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    return tool.seconds_per_call(fn, torch.device(DEVICE), reps) * 1e3


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


# flashfry_tpu's own CLI, with the numpy >= 2.1 shim its database loader needs
REFERENCE_CLI = ("import sys, flashfry_tpu_torch._numpy_compat, "
                 "flashfry_tpu.cli as c; sys.exit(c.main(sys.argv[1:]))")


def numpy_cli(args) -> None:
    """flashfry_tpu's own CLI, numpy backend, in a child process."""
    env = {k: v for k, v in os.environ.items() if k != "FLASHFRY_TPU_PLATFORM"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", REFERENCE_CLI, *args,
                           "--backend", "numpy"],
                          cwd=ROOT, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("numpy CLI failed (exit %d):\n%s"
                           % (proc.returncode, proc.stderr[-4000:]))


def byte_check(db_path: str, fasta: str, tag: str, extra=()) -> dict:
    """Port CLI on the card vs the numpy CLI: the output files must be equal."""
    base = ["discover", "--fasta", fasta, "--database", db_path,
            "--positionOutput", *extra]
    mine = os.path.join(WORK, tag + ".torch.out")
    ref = os.path.join(WORK, tag + ".numpy.out")
    report = cli.run(base + ["--output", mine, "--device", DEVICE])
    numpy_cli(base + ["--output", ref])
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
    codes = bench.synthesize_genome(genome_mb, np.random.default_rng(seed))
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
    longs = bench.sample_guides(db, MAIN_GUIDES, np.random.default_rng(7))
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


def phase_kernel_vs_plain() -> int:
    """stage1 == stage1_reference on the card; returns the largest error."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=300_000, dtype=np.int8)
    fa = os.path.join(WORK, "small.fa")
    write_fasta(fa, "chrK", genome)
    n_cmp, err = 0, 0
    for enzyme in ENZYMES:
        db_path = os.path.join(WORK, "small_%s.db" % enzyme)
        cli.run(["index", "--reference", fa, "--database", db_path,
                 "--enzyme", enzyme])
        db = cli.load_database(db_path)
        n, L = db.num_targets, db.pack.total_scan_length
        scanner = DeviceScanner(db, DEVICE)
        # ragged width (not a multiple of the 256-thread block) with 1001
        # PAD_CODE columns after the real targets
        extra = 1001 + (1 if (n + 1001) % 256 == 0 else 0)
        codes = torch.cat([scanner.codes[:, :n],
                           torch.full((32, extra), PAD_CODE, dtype=torch.int8,
                                      device=DEVICE)], dim=1).contiguous()
        picks = db.targets[rng.integers(0, n, size=2048)].astype(np.uint64)
        for j in range(picks.shape[0]):  # 0..6 random substitutions
            for pos in rng.integers(0, L, size=int(rng.integers(0, 7))):
                picks[j] ^= np.uint64(int(rng.integers(1, 4))) << np.uint64(2 * int(pos))
        hits_seen = 0
        for G, n_real in ((128, 100), (2048, 2000)):
            oh, _, _ = guide_onehot_matrix(picks[:n_real], db.pack, pad_to=G)
            gi8 = guide_block_layout(torch.from_numpy(oh).to(DEVICE), L)
            n_act = len(db.pack.comparison_mask_positions())
            for mm in range(6):
                thr = max(n_act - mm, 1)
                got = stage1(codes, gi8, thr)
                want = stage1_reference(codes, gi8, thr)
                err = max(err, max_abs_err(got, want, "stage1 %s G=%d mm=%d"
                                           % (enzyme, G, mm)))
                if bool(got[n:].any()):
                    raise AssertionError("a padding column hit (%s)" % enzyme)
                hits_seen += int(got.sum())
                n_cmp += 1
        if hits_seen == 0:
            raise AssertionError("no stage-1 hits for %s: vacuous compare" % enzyme)
        say("  %s: N=%d (L=%d), G=128/2048, mm 0..5: kernel == plain, %d hit "
            "bytes in all" % (enzyme, codes.shape[1], L, hits_seen))
    say("phase 3 kernel vs plain: %d bitwise-equal compares" % n_cmp)
    return err


def phase_byte_identity() -> None:
    db_path, t_gen, t_index = index_genome(SMALL_MB, 2024, "g20")
    db = cli.load_database(db_path)
    say("phase 4 byte identity: %d Mbp, %d targets (genome %.1fs, index %.1fs)"
        % (SMALL_MB, db.num_targets, t_gen, t_index))
    fasta = os.path.join(WORK, "g20_guides.fa")
    write_guides(fasta, db, bench.sample_guides(db, 200, np.random.default_rng(3)))
    byte_check(db_path, fasta, "g20_mm3", ("--maxMismatch", "3"))
    byte_check(db_path, fasta, "g20_mm4", ("--maxMismatch", "4"))
    r = byte_check(db_path, fasta, "g20_mm4_cap5",
                   ("--maxMismatch", "4", "--maximumOffTargets", "5"))
    if r["overflowed_guides"] == 0:
        raise AssertionError("no guide overflowed --maximumOffTargets 5")
    # enough guides for one 2048-row guide block, the main path's shape
    fasta = os.path.join(WORK, "g20_guides_2048.fa")
    write_guides(fasta, db, bench.sample_guides(db, 1100, np.random.default_rng(7)))
    r = byte_check(db_path, fasta, "g20_mm4_2048", ("--maxMismatch", "4"))
    if guide_block_rows(r["guides"]) != 2048 or r["guides"] > 2048:
        raise AssertionError("%d guides are not one 2048-row block" % r["guides"])


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
    t_idx, g_idx, mm = bench.collect_hits(scanner, scanned, 4)
    t_scan = time.perf_counter() - t
    t = time.perf_counter()
    n_slice = bench.oracle_slice_check(db, scanned, 4, t_idx, g_idx, mm)
    say("  DeviceScanner.scan of the CLI's %d guides: %d hits in %.4fs; "
        "oracle slice of %d targets matches (%d hits, %.1fs)"
        % (scanned.shape[0], t_idx.size, t_scan, bench.ORACLE_SLICE, n_slice,
           time.perf_counter() - t))

    sub = os.path.join(WORK, "g400_guides32.fa")
    write_guides(sub, db, longs[:32])
    byte_check(db_path, sub, "g400_mm4_32g", ("--maxMismatch", "4"))

    # stage 1 over the whole database: the CLI's 2048-row guide block (the
    # main path's launch), then 1024 rows of it
    thr = max(len(db.pack.comparison_mask_positions()) - 4, 1)
    L = db.pack.total_scan_length
    timed, err = {}, 0
    for g_rows, g in ((rows, scanned), (1024, scanned[:1024])):
        oh, _, _ = guide_onehot_matrix(g, db.pack, pad_to=g_rows)
        gi8 = guide_block_layout(torch.from_numpy(oh).to(DEVICE), L)
        got = stage1(scanner.codes, gi8, thr)
        ref = stage1_reference(scanner.codes, gi8, thr)
        err = max(err, max_abs_err(got, ref, "stage1 %d rows x the database"
                                   % g_rows))
        # in turns: plain, kernel, kernel, plain
        p1 = cuda_ms(lambda: stage1_reference(scanner.codes, gi8, thr), 3)
        k1 = cuda_ms(lambda: stage1(scanner.codes, gi8, thr), 10)
        k2 = cuda_ms(lambda: stage1(scanner.codes, gi8, thr), 10)
        p2 = cuda_ms(lambda: stage1_reference(scanner.codes, gi8, thr), 3)
        timed[g_rows] = ((k1 + k2) / 2, (p1 + p2) / 2)
        say("  stage1 at (32, %d) x (%d, 128)%s: kernel %.3f ms (%.3f, %.3f), "
            "plain %.3f ms (%.3f, %.3f), %d hit bytes, bitwise equal"
            % (scanner.codes.shape[1], g_rows,
               " [main path]" if g_rows == rows else "", timed[g_rows][0], k1,
               k2, timed[g_rows][1], p1, p2, int(got.sum())))
    k_ms, p_ms = timed[rows]
    return {"name": "stage1", "route": "cuda",
            "source": "flashfry_tpu_torch/csrc/stage1.cu",
            "replaces": STAGE1_TPU, "launches": launches,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}


def phase_variants() -> list:
    """Phase 6: the port's experiment tool at its own size, then each
    kernel against its plain version. Returns the kernels-line entries of
    X2, X3, X5 and X6."""
    for k in sv.KERNELS:
        k.launches = 0
    t = time.perf_counter()
    inp, results = tool.run(device=DEVICE, chunk=VARIANT_CHUNK, G=VARIANT_GUIDES)
    launches = {k.__name__: k.launches for k in sv.KERNELS}
    say("phase 6 stage-1 variants: the tool ran %d lines in %.1fs; kernel "
        "launches %s" % (len(results), time.perf_counter() - t, json.dumps(launches)))
    for name, n in launches.items():
        if n == 0:
            raise AssertionError("the tool launched no %s kernel" % name)

    keys = [r["key"] for r in results if "key" in r]
    n, G = inp.codes.shape[1], inp.guide_i8.shape[0]
    timed = {}
    for v in tool.variants(inp, keys):
        err = max_abs_err(v.kernel(), v.plain(), v.name)
        # in turns: plain, kernel, kernel, plain
        p1 = cuda_ms(v.plain, 3)
        k1 = cuda_ms(v.kernel, 10)
        k2 = cuda_ms(v.kernel, 10)
        p2 = cuda_ms(v.plain, 3)
        timed[v.key] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                        "max_abs_err": err}
        say("  %-24s kernel %.3f ms (%.3f, %.3f), plain %.3f ms (%.3f, %.3f), "
            "%.3g cmp/s, bitwise equal" % (v.name, timed[v.key]["ms"], k1, k2,
                                           timed[v.key]["plain_ms"], p1, p2,
                                           v.work / timed[v.key]["ms"] * 1e3))

    # dot's guide loop has to scale with G (nvcc kept it); copy's bytes/s
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
             "max_abs_err": max(timed[k]["max_abs_err"] for k in ks),
             "ms": timed[ks[0]]["ms"], "plain_ms": timed[ks[0]]["plain_ms"]}
        if len(ks) > 1:
            e["variants"] = {k: {"ms": timed[k]["ms"], "plain_ms": timed[k]["plain_ms"]}
                             for k in ks}
        entries.append(e)
    return entries


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
        variant_kernels = phase_variants()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
    say("total %.1fs" % (time.perf_counter() - t0))
    print(json.dumps({"kernels": [kernel] + variant_kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
