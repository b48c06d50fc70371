"""flashfry_tpu_torch.ops.scan_kernel (stage 1) against flashfry_tpu's.

The port's plain stage 1 must give exactly the hit bytes of the Pallas
kernel (run in interpret mode, as tests/test_scan_jax.py runs it) and of
the jnp stage 1 inside make_fused_scan(use_pallas=False), for every enzyme,
max_mismatch 0..5, PAD_CODE columns and guide padding rows. A numpy model
of the CUDA kernel (csrc/stage1.cu: its register A words, descriptor reads
of the staged guides, accumulator map and fold) must give the plain
version's bytes. All quantities are integers, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flashfry_tpu.ops import scan_kernel as jax_kernel
from flashfry_tpu.ops.scan import (PAD_CODE, _fused_scan_jit,
                                   guide_onehot_matrix, parse_trip_buffer,
                                   plane_codes)
from flashfry_tpu.standards import (Cas9NAGParameterPack,
                                    Cas9NGG19ParameterPack,
                                    Cas9NGGParameterPack, Cas9ParameterPack,
                                    Cas9ParameterPack19bp, Cpf1ParameterPack)
from flashfry_tpu_torch.ops import scan_kernel as tk

# grouped by |active| (20, then 19): stage1_pallas caches 8 compiled
# thresholds, so each group compiles its six max_mismatch values once
PACKS = [Cas9NGGParameterPack, Cas9ParameterPack, Cas9NAGParameterPack,
         Cpf1ParameterPack, Cas9ParameterPack19bp, Cas9NGG19ParameterPack]
N_PAD = 4096    # one T_TILE: the Pallas grid needs a T_TILE multiple
N_REAL = 3000   # columns N_REAL.. hold PAD_CODE
G_REAL = 100    # real guides; rows 100..127 are padding


def make_case(pack, seed):
    """Random targets as (32, N_PAD) plane codes, and a 128-row guide
    one-hot of G_REAL guides copied from targets with 0..6 substitutions
    (so every max_mismatch from 0 to 5 has hits)."""
    rng = np.random.default_rng(seed)
    L = pack.total_scan_length
    targets = rng.integers(0, 1 << (2 * L), size=N_REAL, dtype=np.uint64)
    codes = plane_codes(targets, L, N_PAD)
    guides = targets[rng.integers(0, N_REAL, size=G_REAL)].copy()
    for j in range(G_REAL):
        for pos in rng.integers(0, L, size=j % 7):
            guides[j] ^= np.uint64(int(rng.integers(1, 4))) << np.uint64(2 * int(pos))
    oh, n_active, _ = guide_onehot_matrix(guides, pack, pad_to=128)
    return codes, oh, n_active


def torch_stage1(codes, oh, L, thr):
    gi8 = tk.guide_block_layout(torch.from_numpy(oh), L)
    return tk.stage1_reference(torch.from_numpy(codes), gi8, thr).numpy()


@pytest.mark.parametrize("pack", PACKS, ids=lambda p: p.name)
def test_stage1_reference_equals_pallas_interpret(pack):
    codes, oh, _ = make_case(pack, seed=len(pack.name))
    L = pack.total_scan_length
    n_act = len(pack.comparison_mask_positions())
    gi8_jax = jax_kernel.guide_block_layout(jnp.asarray(oh), L)
    n_hits = []
    for mm in range(6):
        with pltpu.force_tpu_interpret_mode():
            f = jax_kernel.stage1_pallas(n_act, mm, N_PAD, 128)
            want = np.asarray(f(jnp.asarray(codes), gi8_jax))
        got = torch_stage1(codes, oh, L, max(n_act - mm, 1))
        assert got.dtype == np.bool_ and got.shape == (N_PAD,)
        assert np.array_equal(got, want), (pack.name, mm)
        assert not got[N_REAL:].any(), "a PAD_CODE column hit"
        n_hits.append(int(got.sum()))
    assert n_hits[0] > 0 and n_hits[5] > n_hits[0], n_hits


# one max_mismatch per (L, |active|) group, so the group shares one compile
# of the jitted fused scan (_fused_scan_jit caches it)
FUSED_MM = {23: 2, 24: 5, 22: 3}


@pytest.mark.parametrize("i", range(len(PACKS)), ids=[p.name for p in PACKS])
def test_stage1_reference_equals_jnp_fused_stage1(i):
    """Stage 2 is exact, so the targets that own a triplet of the jnp fused
    scan (make_fused_scan, use_pallas=False) are exactly its stage-1 hit
    columns (thr = n_active - mm >= 1)."""
    pack = PACKS[i]
    codes, oh, n_active = make_case(pack, seed=100 + i)
    L = pack.total_scan_length
    mm = FUSED_MM[L]
    n_act = len(pack.comparison_mask_positions())
    fused = _fused_scan_jit(L, n_act, mm, N_PAD, 128, 1, N_PAD, 1 << 17,
                            use_pallas=False)
    buf = np.asarray(fused(jnp.asarray(codes), jnp.asarray(oh),
                           jnp.asarray(n_active)))
    t_idx, _g, _m, count, overflow = parse_trip_buffer(buf)
    assert overflow == 0 and count > 0
    want = np.zeros(N_PAD, dtype=bool)
    want[t_idx] = True
    got = torch_stage1(codes, oh, L, max(n_act - mm, 1))
    assert np.array_equal(got, want), (pack.name, mm)


@pytest.mark.parametrize("L", [22, 23, 24])
def test_guide_block_layout_matches_jax(L):
    rng = np.random.default_rng(L)
    oh = (rng.random((256, 4 * L)) < 0.25).astype(np.float32)
    want = np.asarray(jax_kernel.guide_block_layout(jnp.asarray(oh), L))
    got = tk.guide_block_layout(torch.from_numpy(oh), L)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert np.array_equal(got.numpy(), want)


def test_stage1_wrapper_rejects_what_the_kernel_does_not_take():
    codes = torch.full((32, 4096), PAD_CODE, dtype=torch.int8)
    guides = torch.zeros((128, 128), dtype=torch.int8)
    bad = [
        (codes.to(torch.int32), guides, TypeError),
        (codes, guides.to(torch.float32), TypeError),
        (codes[:31], guides, ValueError),
        (codes.reshape(-1), guides, ValueError),
        (codes, guides[:, :127], ValueError),
        (codes, torch.zeros((0, 128), dtype=torch.int8), ValueError),
        (codes, torch.zeros((4096, 128), dtype=torch.int8), ValueError),
        (codes[:, ::2], guides, ValueError),
        (codes, torch.zeros((128, 256), dtype=torch.int8)[:, ::2], ValueError),
    ]
    for c, g, exc in bad:
        with pytest.raises(exc):
            tk.stage1(c, g, 20)


@pytest.mark.parametrize("case", ["thr=0", "thr=-3", "position 24", "position 31",
                                  "byte 2", "byte -1"])
def test_stage1_rejects_thr_below_one_and_bases_past_position_23(case):
    """The kernel multiplies positions 0..23 (K = 96) of 0/1 guides and
    takes thr >= 1; the wrapper refuses the rest on every device."""
    codes = torch.full((32, 4096), PAD_CODE, dtype=torch.int8)
    guides = torch.zeros((128, 128), dtype=torch.int8)
    thr = 16
    if case.startswith("thr"):
        thr = int(case[4:])
    elif case.startswith("byte"):
        guides[5, 2 * 32 + 3] = int(case.split()[1])   # base 2 at position 3
    else:
        guides[5, 2 * 32 + int(case.split()[1])] = 1   # base 2 at that position
    with pytest.raises(ValueError):
        tk.stage1(codes, guides, thr)


def interleaved_target_onehot(codes):
    """(32, N) codes -> (N, 96) int8, column 4i+b = (code_i == b) for
    i < 24: the target operand (wgmma's A) csrc/stage1.cu builds in
    registers."""
    c = codes[:tk.K_POSITIONS].t()
    bases = torch.arange(4, dtype=torch.int8)
    return (c[:, :, None] == bases).reshape(c.shape[0], tk.K_COLS).to(torch.int8)


@pytest.mark.parametrize("G", [1, 17, 128])
@pytest.mark.parametrize("pack", PACKS, ids=lambda p: p.name)
def test_compacted_product_equals_stage1_reference(pack, G):
    """The kernel's K layout on the CPU: the int8 product of the
    interleaved target one-hot and the (G16, 96) compacted guides gives,
    after the max and >= thr, exactly stage1_reference's bytes, for every
    thr from 1 to |active|; at 128 rows also on the 64 super rows (two 1s
    per position) of the experiment tool's "g2"."""
    codes, oh, _ = make_case(pack, seed=200 + G)
    L = pack.total_scan_length
    n_act = len(pack.comparison_mask_positions())
    c = torch.from_numpy(codes)
    gi8 = tk.guide_block_layout(torch.from_numpy(oh[:G]), L)
    blocks = [gi8]
    if G == 128:
        blocks.append(torch.maximum(gi8[0::2], gi8[1::2]).contiguous())
    x = interleaved_target_onehot(c)
    assert torch.equal(tk.codes_onehot_compact(c.t().contiguous()), x)
    for g in blocks:
        a = tk.compact_guides(g)
        g16 = -(-g.shape[0] // tk.M_TILE) * tk.M_TILE
        assert a.dtype == torch.int8 and a.is_contiguous()
        assert a.shape == (g16, tk.K_COLS) and not bool(a[g.shape[0]:].any())
        assert int(a.sum()) == int(g.sum())
        counts = torch._int_mm(x, a.t().contiguous())          # (N, G16)
        n_hits = []
        for thr in range(1, n_act + 1):
            want = tk.stage1_reference(c, g, thr)
            assert torch.equal(counts.amax(dim=1) >= thr, want), (g.shape, thr)
            assert torch.equal(tk.stage1(c, g, thr), want)
            n_hits.append(int(want.sum()))
        assert n_hits[0] > n_hits[-1] > 0, n_hits


def test_stage1_on_cpu_runs_the_plain_version_and_launches_nothing():
    pack = Cas9NGGParameterPack
    codes, oh, _ = make_case(pack, seed=7)
    gi8 = tk.guide_block_layout(torch.from_numpy(oh), 23)
    c = torch.from_numpy(codes)
    for thr in (16, 20):
        assert torch.equal(tk.stage1(c, gi8, thr),
                           tk.stage1_reference(c, gi8, thr))
    assert tk.stage1.launches == 0



# ---------------------------------------------------------------------------
# numpy model of csrc/stage1.cu: wgmma m64n128k32 with the targets as M (A,
# from registers) and the guides as N (B, chunk-major in shared memory)
# ---------------------------------------------------------------------------

K1_M = 64                       # targets per warpgroup m-tile
K1_N = 128                      # guide rows per wgmma n-tile
K1_STEPS = tk.K_COLS // 32      # k-steps of 32 bytes
K1_ACC = K1_N // 2              # accumulators a thread holds
MODEL_ROWS = (16, 48, 112, 128, 144, 256, 1040, 1152, 2048)
MODEL_N = 4001                  # N_REAL targets, then PAD_CODE; not a multiple of 64


def onehot4(code):
    """One position's A word: byte b = (code == b); PAD_CODE gives 0."""
    c = np.asarray(code).astype(np.uint8).astype(np.uint32)
    return np.where(c < 4, np.uint32(1) << (np.uint32(8) * np.minimum(c, 3)), 0).astype(np.uint32)


def k1_a_words(codes):
    """The A words every thread builds, (m_tiles, 4 warps, 32 lanes,
    K1_STEPS, 4) uint32: lane l = 4g + t of warp w holds in a[s][v + 2h] the
    one-hot of position 8s + 4h + t of target 64m + 16w + g + 8v (its code
    bytes c[v][2s + h], read at code row t + 4q); targets past n read
    PAD_CODE."""
    n = codes.shape[1]
    m, w, lane, s, r = np.meshgrid(np.arange(-(-n // K1_M)), np.arange(4), np.arange(32),
                                   np.arange(K1_STEPS), np.arange(4), indexing="ij")
    g, t, v, h = lane >> 2, lane & 3, r & 1, r >> 1
    col = K1_M * m + 16 * w + g + 8 * v
    q = 2 * s + h
    code = np.where(col < n, codes[t + 4 * q, np.minimum(col, n - 1)], PAD_CODE)
    return onehot4(code)


def k1_a_owner():
    """(row, k) of the 64 x 32 A tile that byte b of a[r] of lane l of warp
    w holds in the register form of wgmma (wgmma_s8.cuh, mma_s8_rs):
    a[r] is row 16w + g + 8(r & 1), k 16(r >> 1) + 4t + b."""
    w, lane, r, b = np.meshgrid(np.arange(4), np.arange(32), np.arange(4), np.arange(4),
                                indexing="ij")
    return 16 * w + (lane >> 2) + 8 * (r & 1), 16 * (r >> 1) + 4 * (lane & 3) + b


def k1_a_tiles(words):
    """(m_tiles, 64, 96) int32: the A operand the words stand for."""
    row, k = k1_a_owner()
    a = np.zeros((words.shape[0], K1_M, tk.K_COLS), dtype=np.int32)
    byte = (words[:, :, :, :, :, None] >> (np.uint32(8) * np.arange(4, dtype=np.uint32))) & 0xFF
    for s in range(K1_STEPS):
        a[:, row, 32 * s + k] = byte[:, :, :, s].astype(np.int32)
    return a


def desc_read(smem, start, lbo, sbo, rows):
    """The (rows, 32) s8 k-step operand a no-swizzle K-major descriptor
    describes: 8-row x 16-byte core matrices, rows 16 bytes apart, the two
    K halves lbo bytes apart, 8-row groups sbo bytes apart."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return smem[start + (r % 8) * 16 + (r // 8) * sbo + (k // 16) * lbo + k % 16]


def k1_stage_guides(compacted):
    """Shared memory as the kernel stages it: thread q copies 16-byte chunk
    q of the (g_rows, 96) guides, row r = q / 6's chunk c, to (c * rows + r)
    * 16; rows up to the 128-row n-tile are zero. -> (smem, rows)."""
    g_rows = compacted.shape[0]
    rows = -(-g_rows // K1_N) * K1_N
    smem = np.zeros(rows * tk.K_COLS, dtype=np.int8)
    src = compacted.reshape(-1)
    chunks = tk.K_COLS // 16
    for q in range(rows * chunks):
        r, c = divmod(q, chunks)
        if r < g_rows:
            smem[(c * rows + r) * 16:(c * rows + r) * 16 + 16] = src[16 * q:16 * q + 16]
    return smem, rows


def k1_b_tiles(smem, rows):
    """(n_tiles, 128, 96): the B operand the descriptors of n-tile j and
    k-step s read (start (2s * rows + 128j) * 16 bytes, lbo 16 * rows, sbo
    128)."""
    return np.stack([np.concatenate([desc_read(smem, (2 * s * rows + K1_N * j) * 16,
                                               16 * rows, 128, K1_N)
                                     for s in range(K1_STEPS)], axis=1)
                     for j in range(rows // K1_N)]).astype(np.int32)


def k1_acc_owner():
    """(target row, guide column) of the m64n128 tile that accumulator k of
    lane l of warp w holds: d[4j + 2v1 + v0] = (16w + g + 8v1, 8j + 2t + v0)."""
    w, lane, k = np.meshgrid(np.arange(4), np.arange(32), np.arange(K1_ACC), indexing="ij")
    return 16 * w + (lane >> 2) + 8 * ((k >> 1) & 1), 8 * (k >> 2) + 2 * (lane & 3) + (k & 1)


def k1_model(codes, compacted):
    """The kernel on the CPU: returns bytes(thr), the (n,) int8 output it
    writes at thr. Per m-tile and n-tile the accumulators d[w, l, k] are
    the counts of the A tile times the B tile; each thread folds d[4j],
    d[4j+1] (target row g) and d[4j+2], d[4j+3] (row g + 8) into running
    maxima from 0 over every n-tile (__vimax3_s32), takes the max over the
    four lanes t of its g (two __shfl_xor_sync), and lane t = 0 writes
    target 64m + 16w + g, lane t = 1 target + 8, where it is < n."""
    n = codes.shape[1]
    A = k1_a_tiles(k1_a_words(codes))                            # (M, 64, 96)
    smem, rows = k1_stage_guides(compacted)
    B = k1_b_tiles(smem, rows)                                   # (J, 128, 96)
    counts = np.einsum("mak,jbk->mjab", A, B)                    # (M, J, 64, 128)
    row, col = k1_acc_owner()
    d = counts[:, :, row, col]                                   # (M, J, 4, 32, 64)
    run = np.stack([np.maximum(d[..., 0::4], d[..., 1::4]).max(axis=(1, 4)),
                    np.maximum(d[..., 2::4], d[..., 3::4]).max(axis=(1, 4))], axis=-1)
    run = np.maximum(run, 0)                                     # (M, 4, 32, 2)
    lanes = run.reshape(run.shape[0], 4, 8, 4, 2)                # (M, w, g, t, v)
    shuffled = np.broadcast_to(lanes.max(axis=3, keepdims=True), lanes.shape)
    m, w, g, t = np.meshgrid(np.arange(run.shape[0]), np.arange(4), np.arange(8),
                             np.arange(4), indexing="ij")
    target = K1_M * m + 16 * w + g + 8 * t
    writes = (t < 2) & (target < n)
    value = np.take_along_axis(shuffled, np.minimum(t, 1)[..., None], axis=-1)[..., 0]
    assert np.array_equal(np.sort(target[writes]), np.arange(n)), "a target written twice or never"

    def bytes_at(thr):
        out = np.zeros(n, dtype=np.int8)
        out[target[writes]] = value[writes] >= thr
        return out

    return bytes_at


def test_k1_a_fragment_and_accumulators_cover_the_tiles_once():
    """Every byte of the 64 x 32 A k-step tile is held by exactly one
    (warp, lane, register, byte), and every (target, guide) of the m64n128
    tile by exactly one accumulator; a warp holds targets 16w..16w+15, and
    a lane's accumulators are its two targets only."""
    row, k = k1_a_owner()
    seen = np.zeros((K1_M, 32), dtype=int)
    np.add.at(seen, (row, k), 1)
    assert (seen == 1).all()
    row, col = k1_acc_owner()
    seen = np.zeros((K1_M, K1_N), dtype=int)
    np.add.at(seen, (row, col), 1)
    assert (seen == 1).all()
    for w in range(4):
        assert set(row[w].ravel()) == set(range(16 * w, 16 * w + 16))
        for lane in range(32):
            assert set(row[w, lane]) == {16 * w + lane // 4, 16 * w + lane // 4 + 8}


def test_k1_descriptor_reads_the_chunk_major_guides():
    """The staged guides read back through the n-tile descriptors are the
    compacted rows, then zero rows up to the n-tile."""
    rng = np.random.default_rng(11)
    for g_rows in (16, 144, 2048):
        g = rng.integers(-128, 128, size=(g_rows, tk.K_COLS)).astype(np.int8)
        smem, rows = k1_stage_guides(g)
        assert rows % K1_N == 0 and rows - g_rows < K1_N
        B = k1_b_tiles(smem, rows).reshape(rows, tk.K_COLS)
        assert np.array_equal(B[:g_rows], g) and not B[g_rows:].any()


@pytest.mark.parametrize("g_rows", MODEL_ROWS)
@pytest.mark.parametrize("pack", PACKS, ids=lambda p: p.name)
def test_k1_model_equals_stage1_reference(pack, g_rows):
    """The model of the kernel's A words, descriptor reads, accumulator map
    and fold gives exactly stage1_reference's bytes (tolerance: none, bytes
    equal) for every thr from 1 to |active|, on a ragged n with a PAD_CODE
    tail, at guide rows around the 128-row n-tile and the discover blocks,
    with zero padding rows (g_rows // 16 of them)."""
    rng = np.random.default_rng(g_rows)
    L = pack.total_scan_length
    n_act = len(pack.comparison_mask_positions())
    targets = rng.integers(0, 1 << (2 * L), size=N_REAL, dtype=np.uint64)
    codes = plane_codes(targets, L, MODEL_N)
    guides = targets[rng.integers(0, N_REAL, size=g_rows - g_rows // 16)].copy()
    for j in range(guides.shape[0]):
        for pos in rng.integers(0, L, size=j % 7):
            guides[j] ^= np.uint64(int(rng.integers(1, 4))) << np.uint64(2 * int(pos))
    oh, _, _ = guide_onehot_matrix(guides, pack, pad_to=g_rows)
    gi8 = tk.guide_block_layout(torch.from_numpy(oh), L)
    compacted = tk.compact_guides(gi8)
    assert compacted.shape == (g_rows, tk.K_COLS)
    model = k1_model(codes, compacted.numpy())
    c = torch.from_numpy(codes)
    partial = 0
    for thr in range(1, n_act + 1):
        want = tk.stage1_reference(c, gi8, thr).numpy().view(np.int8)
        got = model(thr)
        assert np.array_equal(got, want), (pack.name, g_rows, thr)
        partial += 0 < int(want.sum()) < N_REAL
    assert partial and not model(1)[N_REAL:].any()
