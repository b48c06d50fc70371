"""The experiment tool's stage-1 variants X1-X6 on torch.

Counterparts of six Pallas kernels of tools/experiment_stage1.py, each a
variant of stage 1 (ops/scan_kernel.py) that the tool times against it:

  v1_gloop         make_v1_gloop (X1): interleaved guides in 128-row tiles,
                   hit = max(-1, m of the whole tiles) >= thr; rows past the
                   last whole tile are ignored, as the TPU kernel's
                   range(g_rows // 128) ignores them
  v3_int16         make_v3_int16 (X2): interleaved guides, int16 match
                   counts, hit = any(m >= int16(thr))
  v4_concat_onehot make_v4_concat_onehot (X3): block-layout guides,
                   hit = max(m) >= thr
  v6_bf16out       make_v6_bf16out (X4): block-layout guides, bf16 match
                   counts, hit = max(m) >= bfloat16(thr)
  v5_tile          make_v5_tile (X5): interleaved guides, hit = max(m) >=
                   thr, at a target tile of t_tile
  expanded         make_expanded (X6): a pre-expanded (128, N) one-hot in
                   place of the codes; mode "full" = the hit byte, "dot" =
                   guide 0's match count, "copy" = one-hot row 0

Every output is (1, N) int8, as the TPU kernels' are. "Interleaved" guides
have column 4i+b = base b at position i (`interleaved_guides`), "block
layout" column 32b+i (`scan_kernel.guide_block_layout`).

Each wrapper takes a CPU tensor to its plain PyTorch version `*_reference`,
and a CUDA tensor to its hand-written kernel in csrc/stage1_variants.cu (its
header gives the design: X4 on the int8 tensor cores, the others on the
CUDA cores), or raises; `<wrapper>.launches` counts kernel launches. Input checks, the chunked plain matmul and the launch are
scan_kernel's, shared with stage 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .scan_kernel import (CODE_ROWS, OH_ROWS, check_inputs, codes_onehot,
                          launch, matches_reference, stage1_reference)

MODES = {"full": 0, "dot": 1, "copy": 2}  # expanded's modes, as the launcher numbers them
G_TILE = 128  # v1_gloop's guide tile, the TPU kernel's g_tile
_INT16 = (-(1 << 15), (1 << 15) - 1)
_INT32 = (-(1 << 31), (1 << 31) - 1)


def interleaved_guides(guide_oh: torch.Tensor, L: int) -> torch.Tensor:
    """(G, 4L) guide one-hot (column 4i+b) -> (G, 128) int8, zero from
    column 4L, contiguous, on guide_oh's device: the tool's `guide_i8`."""
    return F.pad(guide_oh.to(torch.int8), (0, OH_ROWS - 4 * L)).contiguous()


def super_rows(guide_blk: torch.Tensor) -> torch.Tensor:
    """(G, 128) guides -> (G // 2, 128), row j the max of rows 2j and 2j+1:
    the tool's paired guides of "g2" and "g2bf"."""
    return torch.maximum(guide_blk[0::2], guide_blk[1::2]).contiguous()


def expand_onehot(codes: torch.Tensor, L: int) -> torch.Tensor:
    """(32, N) int8 codes -> (128, N) int8 one-hot on codes' device: row
    4i+b = (code_i == b) for i < L, rows from 4L zero (the tool's `oh_np`).

    What it returns is what `expanded` takes: 0/1 bytes with at most one 1
    in each group of four rows, so the kernel's mask arithmetic equals the
    int8 product. `expanded` does not check that at each launch, since
    reading the whole one-hot again would double the bytes its "copy" mode
    measures."""
    if codes.dtype != torch.int8 or codes.dim() != 2 or codes.shape[0] != CODE_ROWS:
        raise ValueError("codes must be (%d, N) int8, got %s %s"
                         % (CODE_ROWS, codes.dtype, tuple(codes.shape)))
    if not 1 <= L <= CODE_ROWS:
        raise ValueError("L must be in [1, %d], got %d" % (CODE_ROWS, L))
    oh = torch.zeros((OH_ROWS, codes.shape[1]), dtype=torch.int8,
                     device=codes.device)
    bases = torch.arange(4, dtype=torch.int8, device=codes.device).view(4, 1)
    for i in range(L):
        oh[4 * i:4 * i + 4] = codes[i] == bases
    return oh


def interleaved_onehot(codes_T: torch.Tensor) -> torch.Tensor:
    """(T, 32) codes -> (T, 128) int8, column 4i+b = (code_i == b): the TPU
    kernels' `repeat(codes, 4) == iota & 3`, rows >= L included."""
    bases = torch.arange(4, dtype=codes_T.dtype, device=codes_T.device)
    return (codes_T.unsqueeze(2) == bases).reshape(codes_T.shape[0], OH_ROWS).to(torch.int8)


def _reference(src, guide_i8, onehot_T, epilogue) -> torch.Tensor:
    """matches_reference with an int8 epilogue, shaped (1, N)."""
    return matches_reference(src, guide_i8, onehot_T, epilogue, torch.int8).unsqueeze(0)


def _max_hit(thr: int):
    return lambda m: (m.amax(dim=1) >= thr).to(torch.int8)


def v1_gloop_reference(codes: torch.Tensor, guide_i8: torch.Tensor,
                       thr: int) -> torch.Tensor:
    """X1 on any device: X5's function over the first G // G_TILE * G_TILE
    guide rows; with no whole tile the running max stays -1."""
    rows = guide_i8.shape[0] // G_TILE * G_TILE
    if rows == 0:
        return torch.full((1, codes.shape[1]), int(-1 >= thr), dtype=torch.int8,
                          device=codes.device)
    return _reference(codes, guide_i8[:rows], interleaved_onehot, _max_hit(thr))


def v3_int16_reference(codes: torch.Tensor, guide_i8: torch.Tensor,
                       thr: int) -> torch.Tensor:
    """X2 on any device. The counts are at most 32, so int32 counts cast
    to int16 are the TPU kernel's int16 accumulator."""
    return _reference(codes, guide_i8, interleaved_onehot,
                      lambda m: (m.to(torch.int16) >= thr).any(dim=1).to(torch.int8))


def v4_concat_onehot_reference(codes: torch.Tensor, guide_blk: torch.Tensor,
                               thr: int) -> torch.Tensor:
    """X3 on any device (block-layout guides): K1's plain version, as int8."""
    return stage1_reference(codes, guide_blk, thr).to(torch.int8).unsqueeze(0)


def v6_bf16out_reference(codes: torch.Tensor, guide_blk: torch.Tensor,
                         thr: int) -> torch.Tensor:
    """X4 on any device (block-layout guides): the counts as bf16 (exact,
    at most 32), their bf16 max, compared with thr rounded to bf16."""
    thr_bf = torch.tensor(thr, dtype=torch.bfloat16, device=codes.device)
    return _reference(codes, guide_blk, codes_onehot,
                      lambda m: (m.to(torch.bfloat16).amax(dim=1) >= thr_bf)
                      .to(torch.int8))


def v5_tile_reference(codes: torch.Tensor, guide_i8: torch.Tensor,
                      thr: int) -> torch.Tensor:
    """X5 on any device; its answer does not depend on the target tile."""
    return _reference(codes, guide_i8, interleaved_onehot, _max_hit(thr))


def expanded_reference(onehot: torch.Tensor, guide_i8: torch.Tensor, thr: int,
                       mode: str) -> torch.Tensor:
    """X6 on any device."""
    if mode == "copy":
        return onehot[:1].clone()
    epilogue = _max_hit(thr) if mode == "full" else lambda m: m[:, 0].to(torch.int8)
    return _reference(onehot, guide_i8, lambda s: s, epilogue)


def _check_thr(thr: int, what: str, bounds=_INT32) -> None:
    if not bounds[0] <= thr <= bounds[1]:
        raise ValueError("%s threshold %d is outside [%d, %d]" % (what, thr, *bounds))


def _library():
    from ._build import stage1_variants_library
    return stage1_variants_library()


def v1_gloop(codes: torch.Tensor, guide_i8: torch.Tensor, thr: int) -> torch.Tensor:
    """X1: (32, N) int8 codes, (G, 128) int8 0/1 interleaved guides ->
    (1, N) int8 hit bytes over the first G // 128 * 128 guide rows."""
    check_inputs(codes, guide_i8, "v1_gloop")
    _check_thr(thr, "v1_gloop")
    if codes.device.type == "cpu":
        return v1_gloop_reference(codes, guide_i8, thr)
    return launch(v1_gloop, _library().ff_v1_gloop_launch, codes, guide_i8,
                  thr).unsqueeze(0)


def v3_int16(codes: torch.Tensor, guide_i8: torch.Tensor, thr: int) -> torch.Tensor:
    """X2: (32, N) int8 codes, (G, 128) int8 0/1 interleaved guides ->
    (1, N) int8 hit bytes, thr in int16 range."""
    check_inputs(codes, guide_i8, "v3_int16")
    _check_thr(thr, "v3_int16", _INT16)
    if codes.device.type == "cpu":
        return v3_int16_reference(codes, guide_i8, thr)
    return launch(v3_int16, _library().ff_v3_int16_launch, codes, guide_i8,
                  thr).unsqueeze(0)


def v4_concat_onehot(codes: torch.Tensor, guide_blk: torch.Tensor,
                     thr: int) -> torch.Tensor:
    """X3: (32, N) int8 codes, (G, 128) int8 0/1 block-layout guides ->
    (1, N) int8 hit bytes."""
    check_inputs(codes, guide_blk, "v4_concat_onehot")
    _check_thr(thr, "v4_concat_onehot")
    if codes.device.type == "cpu":
        return v4_concat_onehot_reference(codes, guide_blk, thr)
    return launch(v4_concat_onehot, _library().ff_v4_concat_onehot_launch,
                  codes, guide_blk, thr).unsqueeze(0)


def v6_bf16out(codes: torch.Tensor, guide_blk: torch.Tensor,
               thr: int) -> torch.Tensor:
    """X4: (32, N) int8 codes, (G, 128) int8 0/1 block-layout guides (or
    super rows, the max of two guides' rows) -> (1, N) int8 hit bytes. The
    kernel multiplies on the int8 tensor cores and takes the byte as
    any(count >= thr), which is the bf16 test for every int32 thr."""
    check_inputs(codes, guide_blk, "v6_bf16out")
    _check_thr(thr, "v6_bf16out")
    if codes.device.type == "cpu":
        return v6_bf16out_reference(codes, guide_blk, thr)
    return launch(v6_bf16out, _library().ff_v6_bf16out_launch, codes, guide_blk,
                  thr).unsqueeze(0)


def v5_tile(codes: torch.Tensor, guide_i8: torch.Tensor, thr: int,
            t_tile: int) -> torch.Tensor:
    """X5: (32, N) int8 codes, (G, 128) int8 0/1 interleaved guides ->
    (1, N) int8 hit bytes; the kernel runs one block per t_tile targets."""
    check_inputs(codes, guide_i8, "v5_tile")
    _check_thr(thr, "v5_tile")
    if not 1 <= t_tile <= _INT32[1]:
        raise ValueError("t_tile must be in [1, %d], got %d" % (_INT32[1], t_tile))
    if codes.device.type == "cpu":
        return v5_tile_reference(codes, guide_i8, thr)
    return launch(v5_tile, _library().ff_v5_tile_launch, codes, guide_i8, thr,
                  t_tile).unsqueeze(0)


def expanded(onehot: torch.Tensor, guide_i8: torch.Tensor, thr: int,
             mode: str) -> torch.Tensor:
    """X6: (128, N) int8 one-hot as `expand_onehot` builds it (not checked
    here), (G, 128) int8 0/1 interleaved guides -> (1, N) int8: the hit byte
    ("full"), guide 0's match count ("dot"), or one-hot row 0 ("copy",
    which reads no guide)."""
    check_inputs(onehot, guide_i8, "expanded", rows=OH_ROWS)
    _check_thr(thr, "expanded")
    if mode not in MODES:
        raise ValueError("mode must be one of %s, got %r" % (", ".join(MODES), mode))
    if onehot.device.type == "cpu":
        return expanded_reference(onehot, guide_i8, thr, mode)
    return launch(expanded, _library().ff_expanded_launch, onehot, guide_i8, thr,
                  MODES[mode], check_guides=mode != "copy").unsqueeze(0)


v1_gloop.launches = 0
v3_int16.launches = 0
v4_concat_onehot.launches = 0
v6_bf16out.launches = 0
v5_tile.launches = 0
expanded.launches = 0
KERNELS = (v1_gloop, v3_int16, v4_concat_onehot, v6_bf16out, v5_tile, expanded)
