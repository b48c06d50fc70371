"""Stage 1 of the off-target scan: one hit byte per target.

Counterpart of flashfry_tpu/ops/scan_kernel.py (`stage1_pallas`). For a
guide block and every target column of the resident (32, N) int8 plane
codes it answers "does any guide come within max_mismatch of this target",
as `max_g <onehot(g), onehot(t)> >= thr` with `thr = n_active - max_mm`,
which must be at least 1 (with max_mm >= n_active every target is within
reach, and the scan skips stage 1).

`stage1` is the wrapper: a CPU tensor goes to the plain PyTorch version
`stage1_reference`; a CUDA tensor launches the hand-written int8
`wgmma` kernel in `csrc/stage1.cu` (its header says what bounds it on
Hopper and how the design answers that) on the guides `compact_guides`
makes, or raises. `stage1.launches` counts kernel launches.
`matches_reference`, `check_inputs` and `launch` serve the stage-1
variants of ops/stage1_variants.py as well.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

CODE_ROWS = 32          # plane-major code rows (L <= 24, padded to 32)
OH_ROWS = 4 * CODE_ROWS  # one-hot width in block layout (column b*32+i)
MAX_GUIDE_ROWS = 2048   # largest guide block the kernel takes
K_POSITIONS = 24        # positions the kernel multiplies (every enzyme's L <= 24)
K_COLS = 4 * K_POSITIONS  # its K: compacted guide columns
M_TILE = 16             # compact_guides pads the guide rows to a multiple of this
# column 4i+b of the compacted guides is block column b*32+i
_COMPACT_COLS = [b * CODE_ROWS + i for i in range(K_POSITIONS) for b in range(4)]

# stage1_reference's (targets x guides) int32 scratch stays under this many
# elements per chunk (256 MB)
_REF_ELEMS = 1 << 26


def guide_block_layout(guide_oh: torch.Tensor, L: int) -> torch.Tensor:
    """(G, 4L) one-hot (column 4i+b) -> (G, 128) int8 in block layout
    (column b*32+i), contiguous."""
    G = guide_oh.shape[0]
    g = guide_oh.reshape(G, L, 4).transpose(1, 2)             # (G, 4, L)
    g = F.pad(g, (0, CODE_ROWS - L))
    return g.reshape(G, OH_ROWS).to(torch.int8).contiguous()


def codes_onehot(codes_T: torch.Tensor) -> torch.Tensor:
    """(T, 32) int8 codes, one target per row -> (T, 128) int8 one-hot in
    block layout. PAD_CODE rows come out all-zero."""
    return torch.cat([codes_T == b for b in range(4)], dim=1).to(torch.int8)


def codes_onehot_compact(codes_T: torch.Tensor) -> torch.Tensor:
    """(T, 32) int8 codes -> (T, 96) int8, column 4i+b = (code_i == b) for
    i < K_POSITIONS: the target operand (wgmma's A) csrc/stage1.cu builds
    in registers, whose product with compact_guides' rows is the
    block-layout product."""
    c = codes_T[:, :K_POSITIONS]
    bases = torch.arange(4, dtype=c.dtype, device=c.device)
    return (c.unsqueeze(2) == bases).reshape(c.shape[0], K_COLS).to(torch.int8)


def matches_reference(src: torch.Tensor, guide_i8: torch.Tensor, onehot_T,
                      epilogue, dtype: torch.dtype) -> torch.Tensor:
    """(N,) dtype: epilogue of the (T, G) int32 match counts
    <onehot(t), guide g> of each chunk of src's target columns, on any
    device. onehot_T turns a (T, rows) slice of src into (T, 128) int8.
    Chunked over targets so the counts never exceed _REF_ELEMS elements."""
    n = src.shape[1]
    G = guide_i8.shape[0]
    out = torch.empty(n, dtype=dtype, device=src.device)
    chunk = max(32, (_REF_ELEMS // max(G, 1)) // 32 * 32)
    # _int_mm on a card wants a width that is a multiple of 8: pad with
    # all-zero guides, whose counts are cut off before the epilogue
    guides_T = F.pad(guide_i8, (0, 0, 0, -G % 8)).t()        # (128, G8)
    for lo in range(0, n, chunk):
        oh = onehot_T(src[:, lo:lo + chunk].t())              # (T, 128)
        t = oh.shape[0]
        pad = -t % 32  # _int_mm wants > 16 rows: pad with all-zero rows
        if pad:
            oh = F.pad(oh, (0, 0, 0, pad))
        matches = torch._int_mm(oh.contiguous(), guides_T)    # (T, G8) int32
        out[lo:lo + t] = epilogue(matches[:t, :G])
    return out


def stage1_reference(codes: torch.Tensor, guide_i8: torch.Tensor,
                     thr: int) -> torch.Tensor:
    """Plain PyTorch stage 1 on any device: (32, N) int8 codes, (G, 128)
    int8 guides -> (N,) bool."""
    return matches_reference(codes, guide_i8, codes_onehot,
                             lambda m: m.amax(dim=1) >= thr, torch.bool)


def check_inputs(src: torch.Tensor, guide_i8: torch.Tensor, what: str,
                 rows: int = CODE_ROWS) -> None:
    """Raise on what a stage-1 kernel does not take: src must be (rows, N)
    int8, the guides (1..MAX_GUIDE_ROWS, 128) int8, both contiguous, on one
    device, and that device the CPU or a CUDA card."""
    if src.dtype != torch.int8 or guide_i8.dtype != torch.int8:
        raise TypeError("%s takes int8 inputs and guides, got %s and %s"
                        % (what, src.dtype, guide_i8.dtype))
    if src.dim() != 2 or src.shape[0] != rows:
        raise ValueError("%s input must be (%d, N), got %s"
                         % (what, rows, tuple(src.shape)))
    if guide_i8.dim() != 2 or guide_i8.shape[1] != OH_ROWS:
        raise ValueError("guides must be (G, %d), got %s"
                         % (OH_ROWS, tuple(guide_i8.shape)))
    if not 1 <= guide_i8.shape[0] <= MAX_GUIDE_ROWS:
        raise ValueError("guide rows must be in [1, %d], got %d"
                         % (MAX_GUIDE_ROWS, guide_i8.shape[0]))
    if not (src.is_contiguous() and guide_i8.is_contiguous()):
        raise ValueError("%s takes contiguous inputs and guides" % what)
    if src.device != guide_i8.device:
        raise ValueError("input on %s but guides on %s"
                         % (src.device, guide_i8.device))
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError("%s runs on cpu or cuda, not %s" % (what, src.device))


def launch(wrapper, fn, src: torch.Tensor, guide_i8: torch.Tensor, thr: int,
           *extra, check_guides: bool = True) -> torch.Tensor:
    """Run the ctypes launcher fn(src, n, guides, g_rows, thr, *extra, out,
    stream) on the current stream into a new (N,) int8 output, and count
    the launch in wrapper.launches. Raises on guides that are not 16-byte
    aligned or (with check_guides) not 0/1, and on a failed launch."""
    if guide_i8.data_ptr() % 16:
        raise ValueError("guides must be 16-byte aligned")
    if check_guides and bool(((guide_i8 != 0) & (guide_i8 != 1)).any()):
        raise ValueError("guide one-hot must hold only 0 and 1")
    n = src.shape[1]
    out = torch.empty(n, dtype=torch.int8, device=src.device)
    if n == 0:
        return out
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(ctypes.c_void_p(src.data_ptr()), n,
                 ctypes.c_void_p(guide_i8.data_ptr()), guide_i8.shape[0],
                 int(thr), *extra, ctypes.c_void_p(out.data_ptr()),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("%s failed: cudaError %d" % (fn.__name__, err))
    wrapper.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _compact_index(device: torch.device) -> torch.Tensor:
    """_COMPACT_COLS as an index tensor on device, built once per device."""
    return torch.tensor(_COMPACT_COLS, device=device)


def compact_guides(guide_i8: torch.Tensor) -> torch.Tensor:
    """(G, 128) block-layout guides -> (G16, 96) int8, contiguous, on the
    same device: column 4i+b = block column b*32+i for i < K_POSITIONS,
    rows zero-padded up to G16, the next multiple of M_TILE. This is the
    guide operand (wgmma's B) of csrc/stage1.cu: block columns i >=
    K_POSITIONS must be zero (stage1 checks), so the product of the
    compacted guides with the interleaved target one-hot
    (codes_onehot_compact) equals the block-layout product."""
    G = guide_i8.shape[0]
    cols = guide_i8.index_select(1, _compact_index(guide_i8.device))
    return F.pad(cols, (0, 0, 0, -G % M_TILE)).contiguous()


def stage1(codes: torch.Tensor, guide_i8: torch.Tensor, thr: int) -> torch.Tensor:
    """(32, N) int8 codes, (G, 128) int8 0/1 guides -> (N,) bool hit bytes,
    for thr >= 1.

    CPU tensors run stage1_reference. CUDA tensors launch the kernel of
    csrc/stage1.cu on the current stream (and count it in
    stage1.launches); anything the kernel does not take raises, on either
    device: thr < 1, a guide byte other than 0 and 1, and a non-zero guide
    column at a position i >= K_POSITIONS. Both guide checks are one
    reduction with one wait for the device: the compacted guides hold only
    0 and 1, and as many non-zero bytes as the whole block."""
    check_inputs(codes, guide_i8, "stage1")
    if thr < 1:
        raise ValueError("stage1 takes thr >= 1, got %d" % thr)
    a = compact_guides(guide_i8)
    bad = ((a != 0) & (a != 1)).any() | ((a != 0).sum() != (guide_i8 != 0).sum())
    if bool(bad):
        raise ValueError("stage1 takes 0/1 guides with bases at positions "
                         "0..%d only" % (K_POSITIONS - 1))
    if codes.device.type == "cpu":
        return stage1_reference(codes, guide_i8, thr)
    from ._build import stage1_library
    return launch(stage1, stage1_library().ff_stage1_launch, codes, a, thr,
                  check_guides=False).view(torch.bool)


stage1.launches = 0
