"""flashfry_tpu_torch.ops.scan_kernel (stage 1) against flashfry_tpu's.

The port's plain stage 1 must give exactly the hit bytes of the Pallas
kernel (run in interpret mode, as tests/test_scan_jax.py runs it) and of
the jnp stage 1 inside make_fused_scan(use_pallas=False), for every enzyme,
max_mismatch 0..5, PAD_CODE columns and guide padding rows. All quantities
are integers, so every comparison is exact.
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
    i < 24: the B operand csrc/stage1.cu builds in registers."""
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

