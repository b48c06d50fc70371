"""Stage-1 kernel variants, timed on one device.

    python -m flashfry_tpu_torch.tools.experiment_stage1 [--device cuda|cpu]
        [--variants 0,3,4,5a,5b,e_full,e_dot,e_copy]

The port's counterpart of tools/experiment_stage1.py, at that tool's size:
SpCas9-NGG (L = 23, 20 active positions) at max_mismatch 4 (thr = 16),
2^23 random targets as (32, 2^23) int8 plane codes, 1024 random guides and,
for the e_* variants, the (128, 2^23) int8 pre-expanded one-hot. Inputs come
from numpy's generator seeded with 0 in the JAX tool's order, so both tools
see the same targets, guides and gather columns.

Every stage-1 variant of the JAX tool's VARIANTS (the default set and "g2",
"g2bf", "bf", "1") runs through a hand-written CUDA kernel on a CUDA device
("0" and "g2" through csrc/stage1.cu, the others through
csrc/stage1_variants.cu) and through its plain PyTorch version on the CPU.
One line per variant, in the JAX tool's format: seconds per chunk, target-
guide comparisons per second, and the first call's seconds (the kernel's
build on a fresh checkout), with times from CUDA events over 48 launches
(the JAX tool's K = 16 calls in each of 3 dispatches). The gather section
at the end is plain torch on both devices.

Where it differs from the JAX tool:
- The input is not varied per launch (`a0 ^ i`): eager torch hoists
  nothing, and XOR would turn the e_* one-hot into other bytes.
- On a CUDA device each variant's first output is held bitwise against its
  plain version. A variant that fails to build, launch or match raises, and
  the tool exits non-zero (the JAX tool printed FAILED and went on).
- "0" and "g2" get the block-layout guides stage 1 takes; the JAX tool
  handed "0" the interleaved matrix, which the MXU times the same.
- An unknown name raises.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..bitcoding import BitEncoding
from ..device import resolve_device
from ..ops import stage1_variants as sv
from ..ops.scan import (DEFAULT_CAP, guide_onehot_matrix, plane_codes,
                        split_words)
from ..ops.scan_kernel import (codes_onehot, codes_onehot_compact,
                               compact_guides, guide_block_layout, stage1,
                               stage1_reference)
from ..standards import Cas9NGGParameterPack

VARIANTS = "0,3,4,5a,5b,e_full,e_dot,e_copy"   # the JAX tool's default
CHUNK = 1 << 23
GUIDES = 1024
MAX_MM = 4
REPS = 48
# the JAX tool's order of execution
ORDER = ("0", "g2", "g2bf", "bf", "1", "3", "4", "5a", "5b",
         "e_full", "e_dot", "e_copy")


@dataclass
class Inputs:
    """One run's data, on `device`."""
    device: torch.device
    L: int
    thr: int
    targets: np.ndarray          # (chunk,) packed uint64 targets
    cols: np.ndarray             # (DEFAULT_CAP,) sorted gather columns
    codes: torch.Tensor          # (32, chunk) int8 plane codes
    guide_i8: torch.Tensor       # (G, 128) int8, interleaved (column 4i+b)
    guide_blk: torch.Tensor      # (G, 128) int8, block layout (column 32b+i)
    onehot: Optional[torch.Tensor] = None   # (128, chunk), built on first use

    def expanded_onehot(self) -> torch.Tensor:
        if self.onehot is None:
            self.onehot = sv.expand_onehot(self.codes, self.L)
        return self.onehot


def make_inputs(device, chunk: int = CHUNK, G: int = GUIDES) -> Inputs:
    """The JAX tool's inputs: random guides, random targets and the gather
    columns, drawn in its order from one generator seeded with 0."""
    device = resolve_device(device)
    pack = Cas9NGGParameterPack
    L = pack.total_scan_length
    n_act = len(pack.comparison_mask_positions())
    rng = np.random.default_rng(0)
    codes_g = rng.integers(0, 4, size=(G, L))
    seqs = ["".join("ACGT"[c] for c in row) for row in codes_g]
    longs = BitEncoding(pack).encode_batch(seqs)
    guide_oh, _, _ = guide_onehot_matrix(longs, pack, pad_to=G)
    targets = rng.integers(0, 2 ** 46, size=chunk, dtype=np.uint64)
    cols = np.sort(rng.choice(chunk, size=min(DEFAULT_CAP, chunk), replace=False))
    oh = torch.from_numpy(guide_oh).to(device)
    return Inputs(device=device, L=L, thr=max(n_act - MAX_MM, 1),
                  targets=targets, cols=cols,
                  codes=torch.from_numpy(plane_codes(targets, L)).to(device),
                  guide_i8=sv.interleaved_guides(oh, L),
                  guide_blk=guide_block_layout(oh, L))


# the (T, 128) int8 one-hot of T target columns that a kernel of each
# layout computes from its source's columns (K1's "compact": (T, 96), the
# positions it multiplies); the expanded one-hot is its own
ONEHOT_T = {"block": codes_onehot, "compact": codes_onehot_compact,
            "interleaved": sv.interleaved_onehot, "expanded": lambda s: s}


@dataclass
class Variant:
    key: str
    name: str
    kernel: Callable[[], torch.Tensor]   # the wrapper: kernel on CUDA
    plain: Callable[[], torch.Tensor]    # its plain PyTorch version
    work: int                            # target-guide comparisons
    # the same function as one int8 product: the (32 or 128, N) tensor the
    # kernel reads, the ONEHOT_T layout of its columns, the (g, 128) guide
    # rows it reads ((g16, 96) compacted for K1), and the epilogue on the
    # (T, g) int32 counts. e_copy
    # takes no product: its output is row 0 of src (rows, epilogue None)
    src: torch.Tensor
    layout: str
    rows: Optional[torch.Tensor]
    epilogue: Optional[Callable[[torch.Tensor], torch.Tensor]]


def parse_variants(spec: str) -> List[str]:
    """'0,3,e_full' -> keys in the JAX tool's order of execution; raises on
    an unknown name."""
    which = [w for w in spec.split(",") if w]
    for w in which:
        if w not in ORDER:
            raise ValueError("unknown variant %r (known: %s)" % (w, ", ".join(ORDER)))
    return [k for k in ORDER if k in which]


def variants(inp: Inputs, keys: List[str]) -> List[Variant]:
    """The stage-1 variants named by keys, in that order."""
    codes, gi8, blk, thr = inp.codes, inp.guide_i8, inp.guide_blk, inp.thr
    work = codes.shape[1] * gi8.shape[0]
    # "g2" and "g2bf" pair the guides: half the rows, the same logical work
    # counted
    if {"g2", "g2bf"} & set(keys):
        sup = sv.super_rows(blk)
    thr_bf = torch.tensor(thr, dtype=torch.bfloat16, device=codes.device)

    def hit(m):
        return m.amax(dim=1) >= thr

    def hit_bf(m):
        return m.to(torch.bfloat16).amax(dim=1) >= thr_bf

    out = []
    for k in keys:
        if k == "0":
            v = Variant(k, "v0 stage1 (K1)", lambda: stage1(codes, blk, thr),
                        lambda: stage1_reference(codes, blk, thr), work,
                        codes, "compact", compact_guides(blk), hit)
        elif k == "g2":
            v = Variant(k, "group2 (%d super rows)" % sup.shape[0],
                        lambda: stage1(codes, sup, thr),
                        lambda: stage1_reference(codes, sup, thr), work,
                        codes, "compact", compact_guides(sup), hit)
        elif k == "g2bf":
            v = Variant(k, "group2 + bf16 epilogue (%d super rows)" % sup.shape[0],
                        lambda: sv.v6_bf16out(codes, sup, thr),
                        lambda: sv.v6_bf16out_reference(codes, sup, thr), work,
                        codes, "block", sup, hit_bf)
        elif k == "bf":
            v = Variant(k, "v6 bf16 epilogue", lambda: sv.v6_bf16out(codes, blk, thr),
                        lambda: sv.v6_bf16out_reference(codes, blk, thr), work,
                        codes, "block", blk, hit_bf)
        elif k == "1":
            v = Variant(k, "v1 g-loop 128", lambda: sv.v1_gloop(codes, gi8, thr),
                        lambda: sv.v1_gloop_reference(codes, gi8, thr), work,
                        codes, "interleaved",
                        gi8[:gi8.shape[0] // sv.G_TILE * sv.G_TILE], hit)
        elif k == "3":
            v = Variant(k, "v3 int16 acc", lambda: sv.v3_int16(codes, gi8, thr),
                        lambda: sv.v3_int16_reference(codes, gi8, thr), work,
                        codes, "interleaved", gi8, hit)
        elif k == "4":
            v = Variant(k, "v4 concat one-hot",
                        lambda: sv.v4_concat_onehot(codes, blk, thr),
                        lambda: sv.v4_concat_onehot_reference(codes, blk, thr), work,
                        codes, "block", blk, hit)
        elif k in ("5a", "5b"):
            tile = 2048 if k == "5a" else 8192
            v = Variant(k, "v%s tile %d" % (k, tile),
                        lambda t=tile: sv.v5_tile(codes, gi8, thr, t),
                        lambda: sv.v5_tile_reference(codes, gi8, thr), work,
                        codes, "interleaved", gi8, hit)
        else:
            mode, oh = k[2:], inp.expanded_onehot()
            rows, epilogue = {"full": (gi8, hit),
                              "dot": (gi8, lambda m: m[:, 0].to(torch.int8)),
                              "copy": (None, None)}[mode]
            v = Variant(k, "expanded " + mode,
                        lambda m=mode: sv.expanded(oh, gi8, thr, m),
                        lambda m=mode: sv.expanded_reference(oh, gi8, thr, m), work,
                        oh, "expanded", rows, epilogue)
        out.append(v)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seconds_per_call(fn: Callable, device: torch.device, reps: int) -> float:
    """Mean seconds of fn over reps back-to-back calls: CUDA events on a
    CUDA device, the host clock on the CPU."""
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps


def bench(name: str, fn: Callable, work: int, device: torch.device,
          reps: int) -> dict:
    """First call (build included), then reps timed calls; prints the JAX
    tool's line and returns the first call's output with the times."""
    t = time.perf_counter()
    first = fn()
    _sync(device)
    build_s = time.perf_counter() - t
    dt = seconds_per_call(fn, device, reps)
    print("%-36s %.4fs/chunk  %.3g cmp/s  (build %.1fs)"
          % (name, dt, work / dt, build_s), flush=True)
    return {"name": name, "s": dt, "build_s": build_s, "out": first}


def max_abs_err(got: torch.Tensor, want: torch.Tensor, what: str) -> int:
    """Largest |kernel - plain| over two integer outputs; raises unless 0."""
    if got.shape != want.shape:
        raise AssertionError("%s: kernel shape %s != plain %s"
                             % (what, tuple(got.shape), tuple(want.shape)))
    err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError("%s: kernel != plain in %d of %d bytes"
                             % (what, int((got != want).sum()), got.numel()))
    return err


def unpack_words(words: torch.Tensor, cols: torch.Tensor, L: int) -> torch.Tensor:
    """(2, N) int32 split words -> (L, len(cols)) int32 base codes of the
    columns cols. `>>` is arithmetic, but bits s and s + 1 of lo come out
    the same for every s <= 30."""
    lo32, hi32 = words[:, cols]
    rows = []
    for i in range(L):
        s = 2 * (L - 1 - i)
        rows.append((lo32 >> s) & 3 if s < 32 else (hi32 >> (s - 32)) & 3)
    return torch.stack(rows)


def gather_section(inp: Inputs, reps: int) -> List[dict]:
    """The JAX tool's stage-2 gather alternatives, plain torch: codes
    columns, split-word columns, and split-word columns unpacked to a
    one-hot. The unpacked codes must equal the codes' columns."""
    dev, L = inp.device, inp.L
    cols = torch.from_numpy(inp.cols.astype(np.int64)).to(dev)
    cap = cols.shape[0]
    words = torch.from_numpy(np.stack(split_words(inp.targets))).to(dev)
    if not torch.equal(unpack_words(words, cols, L),
                       inp.codes[:L, cols].to(torch.int32)):
        raise AssertionError("unpacked split words != plane codes")
    bases = torch.arange(4, dtype=torch.int32, device=dev)[None, :, None]
    return [
        bench("gather (32,N)[:,cols]",
              lambda: inp.codes[:, cols].to(torch.int32).sum(), cap * 32, dev, reps),
        bench("gather (2,N)[:,cols]", lambda: words[:, cols].sum(), cap * 2, dev, reps),
        bench("gather+unpack (2,N)",
              lambda: (unpack_words(words, cols, L)[:, None, :] == bases)
              .to(torch.int32).sum(), cap * 32, dev, reps),
    ]


def run(device="cuda", chunk: int = CHUNK, G: int = GUIDES,
        variants_spec: str = VARIANTS, reps: int = REPS):
    """Build the inputs, time every named variant (reps calls after a first
    one) and the gather section. On a CUDA device each variant's first
    output must equal its plain version's. Returns (inputs, results), one
    result dict per line printed."""
    keys = parse_variants(variants_spec)
    inp = make_inputs(device, chunk, G)
    dev = inp.device
    print("device %s: codes (32, %d), %d guides, thr %d, variants %s"
          % (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
             chunk, G, inp.thr, ",".join(keys)), flush=True)
    results = []
    for v in variants(inp, keys):
        r = bench(v.name, v.kernel, v.work, dev, reps)
        if dev.type == "cuda":
            r["max_abs_err"] = max_abs_err(r["out"], v.plain(), v.name)
        r["key"] = v.key
        results.append(r)
    results += gather_section(inp, reps)
    return inp, results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m flashfry_tpu_torch.tools.experiment_stage1",
        description="Time the stage-1 kernel variants on one device.")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; no card is an error) or cpu (the "
                        "plain versions)")
    p.add_argument("--variants", default=VARIANTS,
                   help="comma-separated names of the JAX tool's VARIANTS, "
                        "any of %s (default %%(default)s)" % ",".join(ORDER))
    args = p.parse_args(argv)
    run(device=args.device, variants_spec=args.variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
