"""flashfry_tpu_torch's stage-1 variants and experiment tool against the
Pallas kernels of tools/experiment_stage1.py.

Each plain version (reached through its wrapper, which takes CPU tensors
there) must give exactly the bytes of its Pallas maker run in interpret
mode: X1 make_v1_gloop (with its dropped tail rows and its G < 128 case),
X2 make_v3_int16, X3 make_v4_concat_onehot, X4 make_v6_bf16out (on G guide
rows and on G/2 super rows), X5 make_v5_tile at 2048 and 8192, X6
make_expanded in its three modes. Two enzymes, max_mismatch 0..5, PAD_CODE
columns and guide padding rows; every value is an integer (X4's bf16 counts
are exact), so every comparison is exact (tolerance 0). Two identities the
wgmma X4 kernel rests on are held on the plain version: its byte is the OR
of the bytes of row chunks zero-padded to its 128-row n-tile, and it equals
the integer any(count >= thr) at every int32 threshold. Numpy models of the
card's kernels (the wgmma kernel of X1, X2, X3, X5 and X6; X4's) are held
to the plain versions and, for X4, to its Pallas maker.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flashfry_tpu.bitcoding import BitEncoding
from flashfry_tpu.ops.scan import PAD_CODE, guide_onehot_matrix, plane_codes
from flashfry_tpu.standards import Cas9NGGParameterPack, Cpf1ParameterPack
from flashfry_tpu_torch.ops import stage1_variants as sv
from flashfry_tpu_torch.ops.scan_kernel import (codes_onehot, guide_block_layout,
                                                matches_reference)
from flashfry_tpu_torch.tools import experiment_stage1 as tool
from tools import experiment_stage1 as X

PACKS = [Cas9NGGParameterPack, Cpf1ParameterPack]
N_PAD = 16384   # a multiple of every maker's target tile (2048..8192)
N_REAL = 12000  # columns N_REAL.. hold PAD_CODE
G = 128
G_REAL = 100    # real guides; rows 100..127 are padding


def make_case(pack, seed):
    """Random targets as (32, N_PAD) plane codes, and a G-row guide one-hot
    of G_REAL guides copied from targets with 0..6 substitutions (so every
    max_mismatch from 0 to 5 has hits)."""
    rng = np.random.default_rng(seed)
    L = pack.total_scan_length
    targets = rng.integers(0, 1 << (2 * L), size=N_REAL, dtype=np.uint64)
    codes = plane_codes(targets, L, N_PAD)
    guides = targets[rng.integers(0, N_REAL, size=G_REAL)].copy()
    for j in range(G_REAL):
        for pos in rng.integers(0, L, size=j % 7):
            guides[j] ^= np.uint64(int(rng.integers(1, 4))) << np.uint64(2 * int(pos))
    oh, _, _ = guide_onehot_matrix(guides, pack, pad_to=G)
    return codes, oh


def tool_guides(oh, L):
    """The JAX tool's guide_i8 and guide_i8_blk, built as its main() does."""
    n = oh.shape[0]
    guide_i8 = jnp.zeros((n, 128), jnp.int8).at[:, :4 * L].set(
        jnp.asarray(oh, jnp.int8))
    perm = np.zeros((128, 128), dtype=np.int8)
    for i in range(32):
        for b in range(4):
            perm[4 * i + b, b * 32 + i] = 1
    guide_i8_blk = jnp.asarray(np.asarray(guide_i8) @ perm, jnp.int8)
    return np.asarray(guide_i8), np.asarray(guide_i8_blk)


def tool_onehot(codes, L):
    """The JAX tool's oh_np, built as its main() does."""
    oh_np = np.zeros((128, codes.shape[1]), dtype=np.int8)
    for i in range(L):
        for b in range(4):
            oh_np[4 * i + b] = codes[i] == b
    return oh_np


def pallas(make, src, guides):
    """make() builds the pallas_call; it has to be built in interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(make()(jnp.asarray(src), jnp.asarray(guides)))


# variant -> (JAX maker of thr, guide layout, input, port wrapper)
HIT_VARIANTS = {
    "X1_v1_gloop": (lambda thr: X.make_v1_gloop(thr, N_PAD, G), "i8", "codes",
                    lambda c, g, thr: sv.v1_gloop(c, g, thr)),
    "X2_v3_int16": (lambda thr: X.make_v3_int16(thr, N_PAD, G), "i8", "codes",
                    lambda c, g, thr: sv.v3_int16(c, g, thr)),
    "X3_v4_concat_onehot": (lambda thr: X.make_v4_concat_onehot(thr, N_PAD, G),
                            "blk", "codes",
                            lambda c, g, thr: sv.v4_concat_onehot(c, g, thr)),
    "X4_v6_bf16out": (lambda thr: X.make_v6_bf16out(thr, N_PAD, G), "blk",
                      "codes", lambda c, g, thr: sv.v6_bf16out(c, g, thr)),
    "X4_v6_bf16out_super_rows": (lambda thr: X.make_v6_bf16out(thr, N_PAD, G // 2),
                                 "sup", "codes",
                                 lambda c, g, thr: sv.v6_bf16out(c, g, thr)),
    "X5_v5_tile_2048": (lambda thr: X.make_v5_tile(thr, N_PAD, G, 2048), "i8",
                        "codes", lambda c, g, thr: sv.v5_tile(c, g, thr, 2048)),
    "X5_v5_tile_8192": (lambda thr: X.make_v5_tile(thr, N_PAD, G, 8192), "i8",
                        "codes", lambda c, g, thr: sv.v5_tile(c, g, thr, 8192)),
    "X6_expanded_full": (lambda thr: X.make_expanded(thr, N_PAD, G, 4096, "full"),
                         "i8", "onehot",
                         lambda o, g, thr: sv.expanded(o, g, thr, "full")),
}


def super_rows(blk):
    """The tools' "g2" pairing: row j = max of guide rows 2j and 2j+1."""
    if isinstance(blk, torch.Tensor):
        return sv.super_rows(blk)
    return np.asarray(jnp.maximum(jnp.asarray(blk)[0::2], jnp.asarray(blk)[1::2]))


def port_inputs(codes, oh, L):
    c = torch.from_numpy(codes)
    g = torch.from_numpy(oh)
    blk = guide_block_layout(g, L)
    return {"codes": c, "onehot": sv.expand_onehot(c, L),
            "i8": sv.interleaved_guides(g, L), "blk": blk, "sup": super_rows(blk)}


@pytest.mark.parametrize("pack", PACKS, ids=lambda p: p.name)
@pytest.mark.parametrize("variant", list(HIT_VARIANTS))
def test_plain_hit_bytes_equal_pallas_interpret(variant, pack):
    maker, layout, src, port = HIT_VARIANTS[variant]
    codes, oh = make_case(pack, seed=len(pack.name) + len(variant))
    L = pack.total_scan_length
    n_act = len(pack.comparison_mask_positions())
    mine = port_inputs(codes, oh, L)
    guide_i8, guide_blk = tool_guides(oh, L)
    jax_src = codes if src == "codes" else tool_onehot(codes, L)
    jax_guides = {"i8": guide_i8, "blk": guide_blk,
                  "sup": super_rows(guide_blk)}[layout]
    launches = [k.launches for k in sv.KERNELS]
    n_hits = []
    for mm in range(6):
        thr = max(n_act - mm, 1)
        want = pallas(lambda: maker(thr), jax_src, jax_guides)
        got = port(mine[src], mine[layout], thr)
        assert got.dtype == torch.int8 and got.shape == (1, N_PAD)
        assert np.array_equal(got.numpy(), want), (variant, pack.name, mm)
        assert not got[0, N_REAL:].any(), "a PAD_CODE column hit"
        n_hits.append(int(got.sum()))
    assert n_hits[0] > 0 and n_hits[5] > n_hits[0], n_hits
    assert [k.launches for k in sv.KERNELS] == launches  # CPU: no kernel


@pytest.mark.parametrize("pack", PACKS, ids=lambda p: p.name)
@pytest.mark.parametrize("mode", ["dot", "copy"])
def test_expanded_dot_and_copy_equal_pallas_interpret(mode, pack):
    codes, oh = make_case(pack, seed=3)
    L = pack.total_scan_length
    thr = len(pack.comparison_mask_positions()) - 4
    mine = port_inputs(codes, oh, L)
    want = pallas(lambda: X.make_expanded(thr, N_PAD, G, 4096, mode),
                  tool_onehot(codes, L), tool_guides(oh, L)[0])
    got = sv.expanded(mine["onehot"], mine["i8"], thr, mode)
    assert got.dtype == torch.int8 and got.shape == (1, N_PAD)
    assert np.array_equal(got.numpy(), want), (mode, pack.name)
    assert not got[0, N_REAL:].any()
    # dot: guide 0's match counts, among them a full match; copy: row 0
    assert int(got.max()) == (len(pack.comparison_mask_positions())
                              if mode == "dot" else 1)


@pytest.mark.parametrize("pack", PACKS, ids=lambda p: p.name)
def test_layouts_equal_the_tools(pack):
    codes, oh = make_case(pack, seed=11)
    L = pack.total_scan_length
    guide_i8, guide_blk = tool_guides(oh, L)
    mine = port_inputs(codes, oh, L)
    assert mine["i8"].dtype == torch.int8 and mine["i8"].is_contiguous()
    assert np.array_equal(mine["i8"].numpy(), guide_i8)
    assert np.array_equal(mine["blk"].numpy(), guide_blk)
    onehot = mine["onehot"]
    assert onehot.dtype == torch.int8 and onehot.shape == (128, N_PAD)
    assert np.array_equal(onehot.numpy(), tool_onehot(codes, L))
    # what `expanded` takes: 0/1 bytes, at most one 1 per group of 4 rows,
    # none in PAD_CODE columns
    assert set(np.unique(onehot.numpy())) <= {0, 1}
    assert int(onehot.view(32, 4, N_PAD).sum(dim=1).max()) == 1
    assert not onehot[:, N_REAL:].any()


def test_wrappers_reject_what_the_kernels_do_not_take():
    codes = torch.full((32, 4096), PAD_CODE, dtype=torch.int8)
    onehot = torch.zeros((128, 4096), dtype=torch.int8)
    guides = torch.zeros((128, 128), dtype=torch.int8)
    calls = [lambda c, g: sv.v1_gloop(c, g, 16),
             lambda c, g: sv.v3_int16(c, g, 16),
             lambda c, g: sv.v4_concat_onehot(c, g, 16),
             lambda c, g: sv.v6_bf16out(c, g, 16),
             lambda c, g: sv.v5_tile(c, g, 16, 2048)]
    bad = [
        (codes.to(torch.int32), guides, TypeError),
        (codes, guides.to(torch.float32), TypeError),
        (codes[:31], guides, ValueError),
        (onehot, guides, ValueError),
        (codes.reshape(-1), guides, ValueError),
        (codes, guides[:, :127], ValueError),
        (codes, torch.zeros((0, 128), dtype=torch.int8), ValueError),
        (codes, torch.zeros((4096, 128), dtype=torch.int8), ValueError),
        (codes[:, ::2], guides, ValueError),
        (codes, torch.zeros((128, 256), dtype=torch.int8)[:, ::2], ValueError),
        (codes.to("meta"), guides.to("meta"), ValueError),
    ]
    for call in calls:
        for c, g, exc in bad:
            with pytest.raises(exc):
                call(c, g)
    for c, g, exc in [(codes, guides, ValueError), (onehot[:, ::2], guides, ValueError),
                      (onehot.to(torch.int32), guides, TypeError),
                      (onehot, guides[:, :64], ValueError)]:
        with pytest.raises(exc):
            sv.expanded(c, g, 16, "full")
    with pytest.raises(ValueError):
        sv.v3_int16(codes, guides, 1 << 15)       # int16 threshold
    for call in (sv.v1_gloop, sv.v4_concat_onehot, sv.v6_bf16out):
        with pytest.raises(ValueError):
            call(codes, guides, 1 << 31)
    for t_tile in (0, -1):
        with pytest.raises(ValueError):
            sv.v5_tile(codes, guides, 16, t_tile)
    with pytest.raises(ValueError):
        sv.expanded(onehot, guides, 16, "max")
    with pytest.raises(ValueError):
        sv.expand_onehot(onehot, 23)
    with pytest.raises(ValueError):
        sv.expand_onehot(codes, 33)


def test_tool_runs_its_default_variants_and_gather_section_on_cpu(capsys):
    launches = [k.launches for k in sv.KERNELS]
    inp, results = tool.run(device="cpu", chunk=N_PAD, G=G, reps=1)
    out = capsys.readouterr().out.splitlines()
    keys = [r.get("key") for r in results]
    assert keys == tool.VARIANTS.split(",") + [None] * 3
    assert len(out) == 1 + len(results) and "s/chunk" in out[-1]
    for r in results:
        assert r["s"] > 0 and r["build_s"] >= 0
    # the tool's inputs: Cas9NGG at max_mismatch 4, the gather's columns
    assert inp.thr == 16 and inp.codes.shape == (32, N_PAD)
    assert inp.cols.shape == (4096,) and np.all(np.diff(inp.cols) > 0)
    # each variant's output is its plain version's
    by_key = {r["key"]: r["out"] for r in results if "key" in r}
    for v in tool.variants(inp, list(by_key)):
        assert torch.equal(by_key[v.key].view(-1).to(torch.int8),
                           v.plain().view(-1).to(torch.int8)), v.key
    assert int(by_key["e_copy"].sum()) == int((inp.codes[0] == 0).sum())
    # gather+unpack: one base per position per gathered column
    assert int(results[-1]["out"]) == inp.L * 4096
    assert [k.launches for k in sv.KERNELS] == launches


@pytest.mark.parametrize("G_rows", [192, 64])
def test_v1_gloop_reads_only_whole_guide_tiles(G_rows):
    """X1 at G = 192: rows 128..191 hold exact copies of targets, and the TPU
    kernel never reads them; at G = 64 it reads no row, so its max stays -1
    and every byte is -1 >= thr (thr = -1 then hits everywhere)."""
    pack = Cas9NGGParameterPack
    L = pack.total_scan_length
    codes, oh = make_case(pack, seed=G_rows)
    rng = np.random.default_rng(G_rows)
    real = codes[:L, :N_REAL].astype(np.uint64)
    longs = sum(real[i] << np.uint64(2 * (L - 1 - i)) for i in range(L))
    tail = longs[rng.integers(0, N_REAL, size=64)]
    tail_oh, _, _ = guide_onehot_matrix(tail, pack, pad_to=64)
    oh = np.concatenate([oh, tail_oh])[:G_rows]
    mine = port_inputs(codes, oh, L)
    jax_i8 = tool_guides(oh, L)[0]
    for thr in (16, 0, -1):
        want = pallas(lambda: X.make_v1_gloop(thr, N_PAD, G_rows), codes, jax_i8)
        got = sv.v1_gloop(mine["codes"], mine["i8"], thr)
        assert np.array_equal(got.numpy(), want), (G_rows, thr)
        every_row = sv.v5_tile_reference(mine["codes"], mine["i8"], thr)
        if G_rows == 64:
            assert bool((got == int(-1 >= thr)).all()), thr
            if thr == 0:
                assert bool(every_row.all()) and not bool(got.any())
        elif thr == 16:
            # the tail's exact copies hit; X1 does not see them
            assert int(every_row.sum()) >= int(got.sum()) + 60


@pytest.mark.parametrize("key", ["1", "bf", "g2bf"])
def test_tool_x1_x4_keys_equal_the_pallas_makers_on_the_jax_tools_inputs(key):
    """The port's tool on the CPU vs the JAX tool's own inputs (drawn as its
    main() draws them) through its makers in interpret mode."""
    chunk, G_tool = 8192, 256
    inp = tool.make_inputs("cpu", chunk=chunk, G=G_tool)
    pack = Cas9NGGParameterPack
    L = pack.total_scan_length
    rng = np.random.default_rng(0)
    codes_g = rng.integers(0, 4, size=(G_tool, L))
    longs = BitEncoding(pack).encode_batch(
        ["".join("ACGT"[c] for c in row) for row in codes_g])
    guide_oh, _, _ = guide_onehot_matrix(longs, pack, pad_to=G_tool)
    targets = rng.integers(0, 2 ** 46, size=chunk, dtype=np.uint64)
    codes = plane_codes(targets, L)
    guide_i8, guide_blk = tool_guides(guide_oh, L)
    make, guides = {
        "1": (lambda: X.make_v1_gloop(16, chunk, G_tool), guide_i8),
        "bf": (lambda: X.make_v6_bf16out(16, chunk, G_tool), guide_blk),
        "g2bf": (lambda: X.make_v6_bf16out(16, chunk, G_tool // 2),
                 super_rows(guide_blk)),
    }[key]
    want = pallas(make, codes, guides)
    (v,) = tool.variants(inp, [key])
    got = v.kernel()
    assert np.array_equal(got.numpy(), want), key
    assert torch.equal(got, v.plain()) and v.work == chunk * G_tool
    # random guides: X1 and X4 equal X3; the super rows hit far more often
    x3 = sv.v4_concat_onehot(inp.codes, inp.guide_blk, inp.thr)
    if key == "g2bf":
        assert int(got.sum()) > int(x3.sum())
    else:
        assert torch.equal(got, x3)


def test_tool_main_runs_every_key_on_cpu(capsys, monkeypatch):
    """`--variants` takes all twelve keys of the JAX tool; main() runs them
    (here at a small size)."""
    sizes, run = {}, tool.run

    def small_run(device, variants_spec):
        sizes["keys"] = tool.parse_variants(variants_spec)
        return run(device=device, chunk=4096, G=128, variants_spec=variants_spec,
                   reps=1)

    monkeypatch.setattr(tool, "run", small_run)
    assert tool.main(["--device", "cpu", "--variants", ",".join(tool.ORDER)]) == 0
    assert sizes["keys"] == list(tool.ORDER)
    out = capsys.readouterr().out
    for name in ("v1 g-loop 128", "v6 bf16 epilogue", "group2 + bf16 epilogue"):
        assert name in out


def test_tool_rejects_unknown_variants_and_a_missing_card(monkeypatch):
    with pytest.raises(ValueError, match="unknown variant"):
        tool.parse_variants("3,7")
    assert tool.parse_variants("e_copy,0,g2") == ["0", "g2", "e_copy"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.run(device="cuda", chunk=4096, G=8)


@pytest.mark.parametrize("key", tool.ORDER)
def test_tool_variant_equals_its_product_form(key):
    """Each variant's src, layout, guide rows and epilogue (what a library
    call of the same function takes) give its plain version's bytes: the
    one-hot of src's columns times the rows, then the epilogue; e_copy is
    row 0 of src."""
    inp = tool.make_inputs("cpu", chunk=4096, G=192)
    (v,) = tool.variants(inp, [key])
    want = v.plain().reshape(-1).to(torch.int8)
    if v.rows is None:
        got = v.src[:1].clone().reshape(-1)
    else:
        oh = tool.ONEHOT_T[v.layout](v.src.t()).contiguous()
        got = v.epilogue(torch._int_mm(oh, v.rows.t().contiguous())).to(torch.int8)
    assert v.src.shape[1] == 4096 and torch.equal(got, want), key
    # X1 reads the one whole 128-row tile of 192 rows; g2 and g2bf 96 super rows
    if v.rows is not None:
        assert v.rows.shape[0] == {"1": 128, "g2": 96, "g2bf": 96}.get(key, 192)


def test_tool_group2_runs_stage1_on_super_rows():
    inp = tool.make_inputs("cpu", chunk=4096, G=64)
    (v,) = tool.variants(inp, ["g2"])
    assert v.name == "group2 (32 super rows)" and v.work == 4096 * 64
    assert torch.equal(v.kernel(), v.plain())


THR_EDGES = (-2 ** 31, -257, -1, 0, 1, 16, 32, 33, 256, 257, 2 ** 31 - 1)


def x4_case(rows, seed):
    """(32, N_PAD) Cas9NGG codes and `rows` block-layout 0/1 guide rows: a
    third exact one-hots of target columns (all 32 positions, so counts
    reach 32), a third those with 1..6 substitutions, a third random 0/1
    bytes (1s in any column, 24..31 included)."""
    rng = np.random.default_rng(seed)
    L = Cas9NGGParameterPack.total_scan_length
    targets = rng.integers(0, 1 << (2 * L), size=N_REAL, dtype=np.uint64)
    codes = torch.from_numpy(plane_codes(targets, L, N_PAD))
    sel = codes[:, torch.from_numpy(rng.integers(0, N_REAL, size=rows))].t().clone()
    for j in range(rows // 3, rows):
        pos = torch.from_numpy(rng.choice(32, size=1 + j % 6, replace=False))
        sel[j, pos] = (sel[j, pos] + int(rng.integers(1, 4))) % 4
    guides = codes_onehot(sel)
    dense = torch.from_numpy((rng.random((rows, 128)) < 0.25).astype(np.int8))
    guides[2 * rows // 3:] = dense[2 * rows // 3:]
    return codes, guides.contiguous()


# rows of the block, whether they are paired into super rows, the chunks
X4_CHUNKS = {
    "2048 as 1024+1024": (2048, False, (1024, 1024)),
    "2048 as 1024+1008+16": (2048, False, (1024, 1008, 16)),
    "1025 as 1024+1": (1025, False, (1024, 1)),
    "512 super rows as 256+256": (1024, True, (256, 256)),
}


@pytest.mark.parametrize("case", list(X4_CHUNKS))
def test_v6_bf16out_is_the_or_over_zero_padded_row_chunks(case):
    """What X4's kernel does with more rows than it stages at once: the OR
    of the bytes over row chunks, each zero-padded to a multiple of the
    128-row n-tile, is the byte over all rows, at every threshold edge."""
    rows, pair, chunks = X4_CHUNKS[case]
    codes, guides = x4_case(rows, seed=rows + len(chunks))
    if pair:
        guides = sv.super_rows(guides)
    assert sum(chunks) == guides.shape[0]
    bounds = np.cumsum((0,) + chunks)
    hits = []
    for thr in (-1, 0, 1, 16, 20, 32, 33):
        want = sv.v6_bf16out(codes, guides, thr)
        got = torch.zeros_like(want)
        for a, b in zip(bounds[:-1], bounds[1:]):
            part = torch.nn.functional.pad(guides[a:b], (0, 0, 0, -(b - a) % 128))
            got |= sv.v6_bf16out(codes, part.contiguous(), thr)
        assert torch.equal(got, want), (case, thr)
        hits.append(int(want[0, :N_REAL].sum()))
    assert hits[:2] == [N_REAL] * 2 and hits[-1] == 0
    assert any(0 < h < N_REAL for h in hits), hits


@pytest.mark.parametrize("thr", THR_EDGES)
def test_v6_bf16out_is_integer_any_count_at_least_thr(thr):
    """X4's bf16 byte, max_g bf16(count_g) >= bf16(thr), is the integer
    any_g(count_g >= thr) for every int32 thr: counts are at most 32 and
    exact in bf16, and bf16 rounding keeps order. Every byte is 1 at
    thr <= 0 (PAD_CODE columns count 0) and 0 past 32."""
    codes, guides = x4_case(300, seed=5)
    for g in (guides, sv.super_rows(guides)):
        got = sv.v6_bf16out(codes, g, thr)
        want = matches_reference(codes, g, codes_onehot,
                                 lambda m: (m >= thr).any(dim=1), torch.int8)
        assert torch.equal(got, want.unsqueeze(0)), thr
        if thr <= 0:
            assert bool(got.all())
        elif thr > 32:
            assert not bool(got.any())
        else:
            assert bool(got[0, :N_REAL].any()) and not bool(got[0, N_REAL:].any())


# ---------------------------------------------------------------------------
# A numpy model of the wgmma kernel of X1, X2, X3, X5 and X6
# (csrc/stage1_variants.cu wgmma_kernel, csrc/wgmma_s8.cuh), step by step
# as the card runs it: the guide stages and B tiles laid out chunk-major in
# shared memory and read back through the no-swizzle K-major descriptor
# (lbo, sbo), the m64n128k32 accumulators held by (warp, lane, register),
# the running-max epilogue folded across lanes and warps, X5's __vcmpeq4
# words, X6's 4x4 __byte_perm transpose, the t_tile work pieces and the OR
# over 1024-row stages. Composed, it must give the plain versions' bytes
# (which the tests above hold to the Pallas makers).

WG_N, WG_M_TILE, WG_STAGE, WG_K_STEPS, WG_ACC = 128, 64, 1024, 4, 64


def _bytes_of(w):
    """uint32 words -> (..., 4) uint8, little-endian as the card stores them."""
    w = np.ascontiguousarray(w, dtype="<u4")
    return w.view(np.uint8).reshape(w.shape + (4,))


def _word_of(b):
    return np.ascontiguousarray(b, dtype=np.uint8).view("<u4")[..., 0]


def byte_perm(x, y, sel):
    """__byte_perm(x, y, sel): result byte i is byte (sel >> 4i) & 7 of the
    eight bytes x (0..3), y (4..7)."""
    x, y, sel = np.broadcast_arrays(np.asarray(x, np.uint32), np.asarray(y, np.uint32),
                                    np.asarray(sel, np.uint32))
    src = np.concatenate([_bytes_of(x), _bytes_of(y)], axis=-1)
    idx = np.stack([(sel >> np.uint32(4 * i)) & np.uint32(7) for i in range(4)], axis=-1)
    return _word_of(np.take_along_axis(src, idx.astype(np.intp), axis=-1))


def vcmpeq4(a, b):
    """__vcmpeq4: 0xFF in each byte where a's and b's bytes are equal."""
    a, b = np.broadcast_arrays(np.asarray(a, np.uint32), np.asarray(b, np.uint32))
    return _word_of(np.where(_bytes_of(a) == _bytes_of(b), 0xFF, 0).astype(np.uint8))


def desc_read(smem, start, lbo, sbo, rows):
    """The (rows, 32) s8 k-step operand a no-swizzle K-major descriptor
    describes: 8-row x 16-byte core matrices, rows 16 bytes apart, the two
    K halves lbo bytes apart, 8-row groups sbo bytes apart."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return smem[..., start + (r % 8) * 16 + (r // 8) * sbo + (k // 16) * lbo + k % 16]


def chunk_major(rows_bytes, rows_pad):
    """(rows, 128) bytes -> shared memory as the kernel writes them: row r's
    16-byte chunk c at (c * rows_pad + r) * 16, padding rows zero."""
    smem = np.zeros(rows_pad * 128, dtype=np.int8)
    r, c = np.divmod(np.arange(rows_bytes.shape[0] * 8), 8)
    for b in range(16):
        smem[(c * rows_pad + r) * 16 + b] = rows_bytes[r, 16 * c + b]
    return smem


def operand(smem, rows_pad, m_tiles):
    """(64 * m_tiles, 128) matrix that the descriptors of every m-tile and
    k-step read from a chunk-major smem of rows_pad rows."""
    return np.concatenate([
        np.concatenate([desc_read(smem, (2 * s * rows_pad + WG_M_TILE * m) * 16,
                                  rows_pad * 16, 128, WG_M_TILE)
                        for s in range(WG_K_STEPS)], axis=-1)
        for m in range(m_tiles)], axis=-2)


def pieces(n, t_tile):
    """The kernel's work pieces as (lo, hi): 128 targets of a t_tile unit
    each, the last unit holding only those it needs."""
    per_unit = -(-min(t_tile, n) // WG_N)
    units = -(-n // t_tile)
    count = (units - 1) * per_unit + -(-(n - (units - 1) * t_tile) // WG_N)
    p = np.arange(count)
    unit = p // per_unit
    lo = unit * t_tile + (p - unit * per_unit) * WG_N
    hi = np.minimum(np.minimum(lo + WG_N, unit * t_tile + t_tile), n)
    return lo, hi


def transpose_slots(lane):
    """X6's store order: slot s of lane l stores target (s + rot) & 3 of its
    four, rot = (l >> 1) & 3."""
    return (np.arange(4)[None, :] + ((lane[:, None] >> 1) & 3)) & 3


def load_words(src, rows, lo, hi, aligned, past):
    """The words each thread reads from its rows[q]: targets 4l..4l+3 of
    the piece (l its lane), as one word on the aligned path, else byte by
    byte with `past` for targets at or past hi. -> [(P, 128) uint32]."""
    n = src.shape[1]
    lane = np.arange(WG_N) & 31
    col0 = lo[:, None] + 4 * lane                                   # (P, 128)
    vec = aligned & (col0 + 4 <= hi[:, None])
    cols = col0[..., None] + np.arange(4)                            # (P, 128, 4)
    keep = vec[..., None] | (cols < hi[:, None, None])
    words = []
    for q in range(rows.shape[0]):
        got = src.view(np.uint8)[rows[q][None, :, None], np.minimum(cols, n - 1)]
        words.append(_word_of(np.where(keep, got, np.uint8(past))))
    return words


def store_chunk(smem, c, k, w):
    """Each thread stores words w[0..3] as target 4l + k's 16-byte chunk c."""
    lane = np.arange(WG_N) & 31
    for p in range(4):
        for b in range(4):
            smem[:, (c * WG_N + 4 * lane + k) * 16 + 4 * p + b] = _bytes_of(w[p])[..., b]


def b_tiles_from_codes(codes, lo, hi):
    """X5's B tiles: thread j builds target lo + j, position i's word byte
    b = (code_i == b) by __vcmpeq4; PAD_CODE and targets past hi give zero
    bytes."""
    n = codes.shape[1]
    tid = np.arange(WG_N)
    col = lo[:, None] + tid
    ok = col < hi[:, None]
    code = np.where(ok[:, None, :], codes[:, np.minimum(col, n - 1)].transpose(1, 0, 2)
                    .astype(np.uint8), PAD_CODE).astype(np.uint32)  # (P, 32, 128)
    smem = np.zeros((lo.size, WG_N * 128), dtype=np.uint8)
    for c in range(8):
        for q in range(4):
            w = vcmpeq4(code[:, 4 * c + q] * np.uint32(0x01010101), 0x03020100) \
                & np.uint32(0x01010101)
            for b in range(4):
                smem[:, (c * WG_N + tid) * 16 + 4 * q + b] = _bytes_of(w)[..., b]
    return smem.view(np.int8)


def b_tiles_from_onehot(oh, lo, hi, aligned):
    """X6's B tiles: for chunks c = 2w, 2w+1, lane l of warp w reads one
    word of targets 4l..4l+3 from each of rows 16c..16c+15, transposes each
    position's 4x4 bytes with __byte_perm and stores one 16-byte chunk per
    target."""
    tid = np.arange(WG_N)
    lane, warp = tid & 31, tid >> 5
    smem = np.zeros((lo.size, WG_N * 128), dtype=np.uint8)
    slots = transpose_slots(lane)
    for h in range(2):
        c = 2 * warp + h
        r = load_words(oh, np.stack([16 * c + q for q in range(16)]), lo, hi, aligned, 0)
        for s in range(4):
            k = slots[:, s]
            sel = (k | (4 + k) << 4).astype(np.uint32)
            w = [byte_perm(byte_perm(r[4 * p], r[4 * p + 1], sel),
                           byte_perm(r[4 * p + 2], r[4 * p + 3], sel), 0x5410)
                 for p in range(4)]
            store_chunk(smem, c, k, w)
    return smem.view(np.int8)


def acc_owner():
    """(row, column) of the m64n128 tile that register k of lane l of warp w
    holds, as (4, 32, 64) index arrays: g = l / 4, t = l % 4, j = k / 4;
    d[4j + 2v1 + v0] = (16w + g + 8v1, 8j + 2t + v0)."""
    w, l, k = np.meshgrid(np.arange(4), np.arange(32), np.arange(WG_ACC), indexing="ij")
    row = 16 * w + (l >> 2) + 8 * ((k >> 1) & 1)
    col = 8 * (k >> 2) + 2 * (l & 3) + (k & 1)
    return row, col


def wgmma_model(src, guides, thrs, mode, t_tile=WG_N, source="codes"):
    """Bytes of the wgmma kernel on the CPU: {thr: (n,) int8} for mode
    "full" (at each thr), or {None: (n,) int8} for "dot". source names the
    B tile's build: "codes" (X1, X2, X3, X5) or "onehot" (X6)."""
    n, G = src.shape[1], guides.shape[0]
    lo, hi = pieces(n, t_tile)
    if source == "codes":
        b_smem = b_tiles_from_codes(src, lo, hi)
    else:
        b_smem = b_tiles_from_onehot(src, lo, hi, aligned=n % 4 == 0)
    B = operand(b_smem, WG_N, WG_N // WG_M_TILE).astype(np.float32)  # (P, 128, 128)
    row, col = acc_owner()
    keys = thrs if mode == "full" else [None]
    out = {key: np.zeros(n, dtype=np.int8) for key in keys}
    tid = np.arange(WG_N)
    cols = lo[:, None] + tid
    written = cols < hi[:, None]
    for r0 in range(0, G, WG_STAGE):
        rows = min(WG_STAGE, G - r0)
        rows64 = -(-rows // WG_M_TILE) * WG_M_TILE
        A = operand(chunk_major(guides[r0:r0 + rows], rows64), rows64,
                    rows64 // WG_M_TILE).astype(np.float32)
        counts = np.matmul(A, B.transpose(0, 2, 1)).astype(np.int32)  # (P, rows64, 128)
        # d[p, m, w, l, k]: register k of lane l of warp w after m-tile m
        # (k-step 0 overwrites, the others add)
        d = counts.reshape(lo.size, rows64 // WG_M_TILE, WG_M_TILE, WG_N)[:, :, row, col]
        for key in keys:
            if mode == "dot":
                # warp 0's lanes g = 0 write guide 0's counts at m = 0 of stage 0
                first = np.zeros((lo.size, WG_N), dtype=np.int8)
                k = np.arange(WG_ACC)
                sel = (k >> 1) & 1 == 0
                first[:, col[0, :4][:, sel].ravel()] = \
                    d[:, 0, 0, :4][:, :, sel].reshape(lo.size, -1).astype(np.int8)
                byte = first if r0 == 0 else out[key][np.minimum(cols, n - 1)]
            else:
                # run[2j+v] = max(0, over m-tiles: d[4j+v], d[4j+2+v]), the
                # __vimax3_s32 of each m-tile
                run = np.stack([np.maximum(d[..., 0::4], d[..., 2::4]).max(axis=1),
                                np.maximum(d[..., 1::4], d[..., 3::4]).max(axis=1)], axis=-1)
                run = np.maximum(run.reshape(lo.size, 4, 32, WG_ACC // 2), 0)
                bits = np.zeros((lo.size, 4, 32), dtype=np.uint32)
                for k in range(WG_ACC // 2):
                    bits |= (run[..., k] >= key).astype(np.uint32) << np.uint32(k)
                # OR over g (the shuffles), lanes g = 0 store s_fold[w][t]
                s_fold = np.bitwise_or.reduce(bits.reshape(lo.size, 4, 8, 4), axis=2)
                lc = (tid >> 1) & 3
                bit = 2 * (tid >> 3) + (tid & 1)
                any_ = np.bitwise_or.reduce(s_fold[:, :, lc], axis=1)
                hit = ((any_ >> bit.astype(np.uint32)) & np.uint32(1)).astype(np.int8)
                prev = out[key][np.minimum(cols, n - 1)] if r0 else 0
                byte = prev | hit
            out[key][cols[written]] = byte[written]
    return out


def wg_guides(rows, codes, n_real, seed, onehot_T=sv.interleaved_onehot):
    """(rows, 128) 0/1 guides, interleaved (onehot_T = interleaved_onehot)
    or in block layout (codes_onehot): a third exact one-hots of target
    columns (all 32 positions), a third with 1..6 substitutions, a third
    random 0/1 bytes."""
    rng = np.random.default_rng(seed)
    sel = codes[:, rng.integers(0, n_real, size=rows)].T.astype(np.int64)
    for j in range(rows // 3, rows):
        pos = rng.choice(32, size=1 + j % 6, replace=False)
        sel[j, pos] = (sel[j, pos] + int(rng.integers(1, 4))) % 4
    guides = onehot_T(torch.from_numpy(sel)).numpy()
    dense = (rng.random((rows, 128)) < 0.25).astype(np.int8)
    guides[2 * rows // 3:] = dense[2 * rows // 3:]
    return np.ascontiguousarray(guides)


def wg_codes(n, seed):
    """(32, n) Cas9NGG codes, the last n // 7 columns PAD_CODE."""
    rng = np.random.default_rng(seed)
    L = Cas9NGGParameterPack.total_scan_length
    n_real = n - n // 7
    targets = rng.integers(0, 1 << (2 * L), size=n_real, dtype=np.uint64)
    return plane_codes(targets, L, n), n_real


WG_ROWS = (1, 63, 64, 65, 1025)


def test_wgmma_accumulator_mapping_covers_the_tile_once():
    row, col = acc_owner()
    seen = np.zeros((WG_M_TILE, WG_N), dtype=int)
    np.add.at(seen, (row, col), 1)
    assert (seen == 1).all()
    # a warp holds rows 16w..16w+15 only; lanes of one t hold the same columns
    assert all(set(row[w].ravel()) == set(range(16 * w, 16 * w + 16)) for w in range(4))
    assert all((col[:, l] == col[0, l & 3]).all() for l in range(32))


def test_wgmma_descriptor_reads_what_chunk_major_wrote():
    rng = np.random.default_rng(1)
    rows = rng.integers(-128, 128, size=(192, 128)).astype(np.int8)
    assert np.array_equal(operand(chunk_major(rows, 192), 192, 3), rows)
    # the same smem read with lbo and sbo swapped is another matrix
    smem = chunk_major(rows, 192)
    swapped = desc_read(smem, 0, 128, 192 * 16, 64)
    assert np.array_equal(desc_read(smem, 0, 192 * 16, 128, 64), rows[:64, :32])
    assert not np.array_equal(swapped, rows[:64, :32])


def test_wgmma_byte_perm_transpose_and_conflict_free_stores():
    """X6's 4x4 transpose gives each target's word, and the rotated store
    order puts the 8 lanes of each store phase on 8 different 16-byte bank
    groups."""
    rng = np.random.default_rng(2)
    r = rng.integers(0, 1 << 32, size=(4, 1000), dtype=np.uint64).astype(np.uint32)
    for k in range(4):
        sel = np.uint32(k | (4 + k) << 4)
        w = byte_perm(byte_perm(r[0], r[1], sel), byte_perm(r[2], r[3], sel), 0x5410)
        want = np.stack([_bytes_of(r[b])[:, k] for b in range(4)], axis=-1)
        assert np.array_equal(_bytes_of(w), want), k
    lane = np.arange(32)
    slots = transpose_slots(lane)
    assert (np.sort(slots, axis=1) == np.arange(4)).all()
    for s in range(4):
        unit = 4 * lane + slots[:, s]  # 16-byte units the lanes store
        for phase in range(4):
            assert len(set(unit[8 * phase:8 * phase + 8] % 8)) == 8, (s, phase)


def test_wgmma_pieces_cover_every_target_once():
    for n, t_tile in ((2345, 1), (2345, 100), (2345, 2048), (2345, 2346), (128, 128),
                      (2344, 128), (5, (1 << 31) - 1)):
        lo, hi = pieces(n, t_tile)
        assert (hi > lo).all() and (hi - lo <= WG_N).all()
        cover = np.zeros(n, dtype=int)
        for a, b in zip(lo, hi):
            cover[a:b] += 1
            assert a // t_tile == (b - 1) // t_tile  # inside one unit
        assert (cover == 1).all(), (n, t_tile)


@pytest.mark.parametrize("t_tile", [1, 100, 2048, "n+1"])
@pytest.mark.parametrize("G_rows", WG_ROWS)
def test_wgmma_model_equals_v5_tile_reference(G_rows, t_tile):
    n = 69 if t_tile == 1 else 2345  # not a multiple of 4 or of 128
    codes, n_real = wg_codes(n, seed=G_rows)
    guides = wg_guides(G_rows, codes, n_real, seed=G_rows + 1)
    got = wgmma_model(codes, guides, THR_EDGES, "full",
                      t_tile=n + 1 if t_tile == "n+1" else t_tile)
    c, g = torch.from_numpy(codes), torch.from_numpy(guides)
    partial = 0
    for thr in THR_EDGES:
        want = sv.v5_tile_reference(c, g, thr)[0].numpy()
        assert np.array_equal(got[thr], want), (G_rows, t_tile, thr)
        partial += 0 < int(want[:n_real].sum()) < n_real
    assert partial or G_rows == 1


@pytest.mark.parametrize("n", [2344, 2345])
@pytest.mark.parametrize("mode", ["full", "dot"])
@pytest.mark.parametrize("G_rows", WG_ROWS)
def test_wgmma_model_equals_expanded_reference(G_rows, mode, n):
    """X6 on the one-hot expand_onehot builds (n = 2345, PAD_CODE tail, the
    byte-by-byte path), and on random 0/1 bytes with several 1s per group
    of four rows (n = 2344, the word path)."""
    codes, n_real = wg_codes(n, seed=7 * G_rows)
    guides = wg_guides(G_rows, codes, n_real, seed=G_rows + 2)
    if n % 4:
        oh = sv.expand_onehot(torch.from_numpy(codes), 23).numpy()
    else:
        rng = np.random.default_rng(n + G_rows)
        oh = (rng.random((128, n)) < 0.4).astype(np.int8)
        assert (oh.reshape(32, 4, n).sum(axis=1) > 1).any()
    got = wgmma_model(oh, guides, THR_EDGES, mode, source="onehot")
    o, g = torch.from_numpy(oh), torch.from_numpy(guides)
    for thr in THR_EDGES if mode == "full" else [None]:
        want = sv.expanded_reference(o, g, 16 if thr is None else thr, mode)[0].numpy()
        assert np.array_equal(got[thr], want), (G_rows, mode, n, thr)


# X1 and X2 on the same kernel: their launchers run it at their TPU kernels'
# t_tile of 4096, X1 on the whole 128-row tiles only (one memset of
# -1 >= thr when there is none), X2 at any int16 threshold.

TOOL_TILE = 4096
X1_ROWS = (1, 64, 127, 128, 129, 192, 1025)
X2_ROWS = (1, 65, 1025)
INT16_THR_EDGES = (-2 ** 15, -257, -1, 0, 1, 16, 32, 33, 256, 257, 2 ** 15 - 1)


def launcher_model(variant, codes, guides, thrs):
    """Bytes of ff_v1_gloop_launch / ff_v3_int16_launch: {thr: (n,) int8}."""
    if variant == "v1_gloop":
        rows = guides.shape[0] // sv.G_TILE * sv.G_TILE
        if rows == 0:
            return {thr: np.full(codes.shape[1], int(-1 >= thr), dtype=np.int8) for thr in thrs}
        guides = guides[:rows]
    return wgmma_model(codes, guides, thrs, "full", t_tile=TOOL_TILE)


@pytest.mark.parametrize("G_rows", X1_ROWS)
def test_wgmma_model_equals_v1_gloop_reference(G_rows):
    """X1 past one 4096-target unit: rows past the last whole 128-row tile
    hold exact one-hots of targets (count 32), and neither the launcher nor
    the plain version reads them; with fewer than 128 rows every byte is
    -1 >= thr."""
    n = TOOL_TILE + 2345
    codes, n_real = wg_codes(n, seed=11 * G_rows)
    guides = wg_guides(G_rows, codes, n_real, seed=G_rows + 3)
    whole = G_rows // sv.G_TILE * sv.G_TILE
    cols = np.random.default_rng(G_rows).integers(0, n_real, size=G_rows - whole)
    guides[whole:] = sv.interleaved_onehot(torch.from_numpy(codes[:, cols].T.copy())).numpy()
    got = launcher_model("v1_gloop", codes, guides, THR_EDGES)
    c, g = torch.from_numpy(codes), torch.from_numpy(guides)
    for thr in THR_EDGES:
        want = sv.v1_gloop_reference(c, g, thr)[0].numpy()
        assert np.array_equal(got[thr], want), (G_rows, thr)
        if whole == 0:
            assert (want == int(-1 >= thr)).all(), thr
    if whole < G_rows:
        every_row = sv.v5_tile_reference(c, g, 32)[0].numpy()
        assert int(every_row.sum()) > int(got[32].sum()), G_rows


@pytest.mark.parametrize("G_rows", X2_ROWS)
def test_wgmma_model_equals_v3_int16_reference(G_rows):
    """X2 at the int16 threshold edges: the kernel's 32-bit max >= thr is
    the int16 any(m >= thr), since the counts are 0..32."""
    n = TOOL_TILE + 2345
    codes, n_real = wg_codes(n, seed=13 * G_rows)
    guides = wg_guides(G_rows, codes, n_real, seed=G_rows + 4)
    got = launcher_model("v3_int16", codes, guides, INT16_THR_EDGES)
    c, g = torch.from_numpy(codes), torch.from_numpy(guides)
    partial = 0
    for thr in INT16_THR_EDGES:
        want = sv.v3_int16_reference(c, g, thr)[0].numpy()
        assert np.array_equal(got[thr], want), (G_rows, thr)
        if thr <= 0:
            assert want.all(), thr
        elif thr > 32:
            assert not want.any(), thr
        partial += 0 < int(want[:n_real].sum()) < n_real
    assert partial or G_rows == 1


# X3 on the same kernel: its wrapper permutes the block-layout guides to
# interleaved order once per call (interleaved_from_block) and runs X5's
# launcher at the TPU kernel's t_tile of 4096.

X3_TILES = (1, 100, TOOL_TILE, "n+1")


@pytest.mark.parametrize("t_tile", X3_TILES)
@pytest.mark.parametrize("G_rows", WG_ROWS)
def test_wgmma_model_equals_v4_concat_onehot_reference(G_rows, t_tile):
    """X3 on block-layout guides with 1s in columns 24..31 (base A at
    positions the codes hold as 0), a PAD_CODE tail and n not a multiple of
    128, permuted as its wrapper permutes them, at every int32 threshold
    edge: every byte is 1 at thr <= 0 and none is set past 32. Its answer,
    like X5's, does not depend on the target tile."""
    n = 69 if t_tile == 1 else TOOL_TILE + 2345
    codes, n_real = wg_codes(n, seed=17 * G_rows)
    guides = wg_guides(G_rows, codes, n_real, seed=G_rows + 5, onehot_T=codes_onehot)
    assert guides[:, 24:32].any() and n % WG_N
    permuted = sv.interleaved_from_block(torch.from_numpy(guides)).numpy()
    got = wgmma_model(codes, permuted, THR_EDGES, "full",
                      t_tile=n + 1 if t_tile == "n+1" else t_tile)
    c, g = torch.from_numpy(codes), torch.from_numpy(guides)
    partial = 0
    for thr in THR_EDGES:
        want = sv.v4_concat_onehot_reference(c, g, thr)[0].numpy()
        assert np.array_equal(got[thr], want), (G_rows, t_tile, thr)
        if thr <= 0:
            assert want.all(), thr
        elif thr > 32:
            assert not want.any(), thr
        partial += 0 < int(want[:n_real].sum()) < n_real
    # with more exact copies than real targets, every target reaches 32
    assert partial or G_rows == 1 or G_rows // 3 > n_real


def test_interleaved_from_block_moves_column_32b_plus_i_to_4i_plus_b():
    """X3's permutation: column 4i+b of the result is block column 32b+i
    (a bijection of the 128 columns), the block layout of a guide one-hot
    comes back as its interleaved layout, and the permuted guides times the
    interleaved one-hot (X5's B tile) give the block-layout guides' counts
    with codes_onehot: the product sums over the columns, so their order
    is free."""
    rng = np.random.default_rng(29)
    blk = torch.from_numpy(rng.integers(-128, 128, size=(70, 128)).astype(np.int8))
    got = sv.interleaved_from_block(blk)
    assert got.dtype == torch.int8 and got.is_contiguous() and got.shape == blk.shape
    for i in range(32):
        for b in range(4):
            assert torch.equal(got[:, 4 * i + b], blk[:, 32 * b + i]), (i, b)
    codes, n_real = wg_codes(1000, seed=29)
    for L in (20, 23, 24):
        oh = torch.from_numpy(rng.integers(0, 2, size=(66, 4 * L)).astype(np.int8))
        assert torch.equal(sv.interleaved_from_block(guide_block_layout(oh, L)),
                           sv.interleaved_guides(oh, L)), L
    guides = torch.from_numpy(wg_guides(66, codes, n_real, seed=23, onehot_T=codes_onehot))
    c_T = torch.from_numpy(codes).t()
    counts = torch._int_mm(codes_onehot(c_T).contiguous(), guides.t().contiguous())
    assert torch.equal(counts, torch._int_mm(sv.interleaved_onehot(c_T).contiguous(),
                                             sv.interleaved_from_block(guides).t().contiguous()))
    assert int(counts.max()) == 32 and not counts[n_real:].any()


# ---------------------------------------------------------------------------
# A numpy model of X4's kernel (csrc/stage1_variants.cu bf16out_kernel and
# the n-tile step of csrc/wgmma_s8.cuh), step by step as the card runs it:
# wgmma m64n128k32 with the targets as M, their A words packed from code
# bytes and byte-compared with each base by __vcmpeq4 (block order: k-step s
# is base s at positions 0..31); the guides as N, staged chunk-major at most
# 1024 rows at a time with zero rows up to the 128-row n-tile and read back
# through the n-tile descriptors; the accumulators by owner, the fold from 0,
# the max over a target's four lanes and the OR over stages. It reuses the
# wgmma kernel's helpers above (vcmpeq4, byte_perm, chunk_major, desc_read,
# acc_owner).

X4_M, X4_N, X4_STAGE, X4_STEPS = 64, 128, 1024, 4
X4_MODEL_ROWS = (1, 127, 128, 129, 1024, 1025, 2048, "512 super rows")
X4_MODEL_N = 2345  # not a multiple of 64; its last 335 columns are PAD_CODE


def x4_code_bytes(codes):
    """c[m, w, l, v, p], uint32: the code bytes lane l = 4g + t of warp w
    reads for m-tile m (load_block_codes): position 16(p >> 2) + 4t + (p & 3)
    of target 64m + 16w + g + 8v, zero-extended; targets past n read
    PAD_CODE."""
    n = codes.shape[1]
    m, w, lane, v, p = np.meshgrid(np.arange(-(-n // X4_M)), np.arange(4), np.arange(32),
                                   np.arange(2), np.arange(8), indexing="ij")
    col = X4_M * m + 16 * w + (lane >> 2) + 8 * v
    pos = 16 * (p >> 2) + 4 * (lane & 3) + (p & 3)
    got = codes.view(np.uint8)[pos, np.minimum(col, n - 1)]
    return np.where(col < n, got, PAD_CODE).astype(np.uint32)


def x4_a_words(c):
    """a[m, w, l, s, v + 2h] (block_a_words): code bytes c[..., v, 4h..4h+3]
    packed into one word by two __byte_perm steps, then __vcmpeq4 with
    s * 0x01010101, masked to 0/1 bytes."""
    word = byte_perm(byte_perm(c[..., 0::4], c[..., 1::4], 0x0040),
                     byte_perm(c[..., 2::4], c[..., 3::4], 0x0040), 0x5410)  # [..., v, h]
    a = np.zeros(c.shape[:3] + (X4_STEPS, 4), dtype=np.uint32)
    for s in range(X4_STEPS):
        eq = vcmpeq4(word, np.uint32(0x01010101 * s)) & np.uint32(0x01010101)
        a[..., s, :] = eq.swapaxes(-1, -2).reshape(eq.shape[:-2] + (4,))
    return a


def x4_a_owner():
    """(target row, k) of the 64 x 32 A tile that byte b of a[r] of lane l
    of warp w holds (wgmma_s8.cuh mma_s8_rs): row 16w + g + 8(r & 1), k
    16(r >> 1) + 4t + b."""
    w, lane, r, b = np.meshgrid(np.arange(4), np.arange(32), np.arange(4), np.arange(4),
                                indexing="ij")
    return 16 * w + (lane >> 2) + 8 * (r & 1), 16 * (r >> 1) + 4 * (lane & 3) + b


def x4_a_tiles(a):
    """(m_tiles, 64, 128) int32: the A operand the words stand for, k-step
    s in columns 32s..32s+31."""
    row, k = x4_a_owner()
    tiles = np.zeros((a.shape[0], X4_M, 128), dtype=np.int32)
    byte = _bytes_of(a).astype(np.int32)  # (M, w, l, s, r, b)
    for s in range(X4_STEPS):
        tiles[:, row, 32 * s + k] = byte[:, :, :, s]
    return tiles


def x4_stages(guides):
    """The stages as the kernel walks them: (smem, rows) of each 1024-row
    chunk of the guides, staged chunk-major with zero rows up to the
    128-row n-tile."""
    stages = []
    for r0 in range(0, guides.shape[0], X4_STAGE):
        staged = guides[r0:r0 + X4_STAGE]
        rows = -(-staged.shape[0] // X4_N) * X4_N
        stages.append((chunk_major(staged, rows), rows))
    return stages


def x4_b_tiles(smem, rows):
    """(n_tiles, 128, 128) int32: the B operand the descriptors of n-tile j
    and k-step s read (start (2s * rows + 128j) * 16, lbo 16 * rows, sbo
    128)."""
    return np.stack([np.concatenate([desc_read(smem, (2 * s * rows + X4_N * j) * 16,
                                               16 * rows, 128, X4_N)
                                     for s in range(X4_STEPS)], axis=1)
                     for j in range(rows // X4_N)]).astype(np.int32)


def x4_model(codes, guides):
    """The kernel on the CPU: returns bytes(thr), the (n,) int8 output it
    writes at thr. Per stage, m-tile and n-tile the accumulators d[w, l, k]
    are the A tile times the B tile; each thread folds d[4j], d[4j+1] (row
    g) and d[4j+2], d[4j+3] (row g + 8) into two runners per row from 0
    (__vimax3_s32, j even and odd), takes the max over the four lanes t of
    its g, and lane t = 0 writes target 64m + 16w + g, t = 1 target + 8,
    where < n, OR-ed into its byte of the earlier stages."""
    n = codes.shape[1]
    A = x4_a_tiles(x4_a_words(x4_code_bytes(codes))).astype(np.float32)  # (M, 64, 128)
    row, col = acc_owner()
    m, w, g, t = np.meshgrid(np.arange(A.shape[0]), np.arange(4), np.arange(8), np.arange(4),
                             indexing="ij")
    target = X4_M * m + 16 * w + g + 8 * t
    writes = (t < 2) & (target < n)
    assert np.array_equal(np.sort(target[writes]), np.arange(n)), "a target written twice or never"
    tops = []
    for smem, rows in x4_stages(guides):
        B = x4_b_tiles(smem, rows).astype(np.float32)                     # (J, 128, 128)
        counts = np.matmul(A[:, None], B.transpose(0, 2, 1)[None]).astype(np.int32)
        d = counts[:, :, row, col]                                        # (M, J, w, l, 64)
        run = np.zeros(d.shape[:1] + d.shape[2:4] + (2, 2), dtype=np.int32)
        for h in range(2):
            j = np.arange(h, X4_N // 8, 2)
            for v in range(2):
                pair = np.maximum(d[..., 4 * j + 2 * v], d[..., 4 * j + 2 * v + 1])
                run[..., v, h] = np.maximum(pair.max(axis=(1, -1)), 0)
        lanes = run.max(axis=-1).reshape(run.shape[0], 4, 8, 4, 2)      # (M, w, g, t, v)
        shuffled = np.broadcast_to(lanes.max(axis=3, keepdims=True), lanes.shape)
        tops.append(np.take_along_axis(shuffled, np.minimum(t, 1)[..., None], axis=-1)[..., 0])

    def bytes_at(thr):
        out = np.zeros(n, dtype=np.int8)
        for r0, top in enumerate(tops):
            prev = out[target[writes]] if r0 else 0
            out[target[writes]] = prev | (top[writes] >= thr)
        return out

    return bytes_at


def x4_model_inputs(rows, seed):
    """(32, X4_MODEL_N) codes with a PAD_CODE tail, n_real, and `rows` 0/1
    block-layout guides (wg_guides: exact one-hots of targets, substituted
    ones, random bytes; the last rows // 16 zero padding), or "512 super
    rows": the paired rows of 1024 such rows."""
    codes, n_real = wg_codes(X4_MODEL_N, seed)
    G = 1024 if rows == "512 super rows" else rows
    guides = wg_guides(G, codes, n_real, seed + 1, onehot_T=codes_onehot)
    guides[G - G // 16:] = 0
    if rows == "512 super rows":
        guides = sv.super_rows(torch.from_numpy(guides)).numpy()
    return codes, n_real, np.ascontiguousarray(guides)


def test_x4_a_words_are_the_block_order_one_hots_of_the_targets():
    """Every byte of the 64 x 32 A k-step tile is held once, and the A
    tiles the packed __vcmpeq4 words stand for are the block-layout one-hot
    of the targets (column 32b + i = code_i == b, all 32 code rows), zero
    for PAD_CODE columns, bytes outside 0..3 and targets past n."""
    row, k = x4_a_owner()
    seen = np.zeros((X4_M, 32), dtype=int)
    np.add.at(seen, (row, k), 1)
    assert (seen == 1).all()
    codes, n_real = wg_codes(X4_MODEL_N, seed=41)
    codes[5, 7] = -1   # a byte outside 0..3 besides PAD_CODE: no base
    n = codes.shape[1]
    A = x4_a_tiles(x4_a_words(x4_code_bytes(codes))).reshape(-1, 128)
    want = codes_onehot(torch.from_numpy(codes).t().contiguous()).numpy()
    assert np.array_equal(A[:n], want) and not A[n:].any()
    assert not A[n_real:n].any() and A[7, 5::32].sum() == 0


def test_x4_stages_read_back_through_the_descriptors():
    """Each stage read through its n-tile descriptors is its 1024-row chunk
    of the guides, then zero rows up to the 128-row n-tile."""
    rng = np.random.default_rng(43)
    for G in (1, 129, 1024, 1025, 2048):
        guides = rng.integers(-128, 128, size=(G, 128)).astype(np.int8)
        stages = x4_stages(guides)
        assert len(stages) == -(-G // X4_STAGE)
        for i, (smem, rows) in enumerate(stages):
            part = guides[X4_STAGE * i:X4_STAGE * (i + 1)]
            B = x4_b_tiles(smem, rows).reshape(rows, 128)
            assert rows % X4_N == 0 and rows - part.shape[0] < X4_N
            assert np.array_equal(B[:part.shape[0]], part) and not B[part.shape[0]:].any()


@pytest.mark.parametrize("rows", X4_MODEL_ROWS)
def test_x4_model_equals_v6_bf16out_reference_and_pallas_interpret(rows):
    """The model gives exactly the plain version's bytes and those of the
    Pallas maker make_v6_bf16out in interpret mode (tolerance: none) at
    every int32 threshold edge, on a ragged width with a PAD_CODE tail, at
    guide rows around the 128-row n-tile and the 1024-row stage (1025 and
    2048 take two), with zero padding rows and 1s in block columns 24..31,
    and on the tool's 512 super rows."""
    codes, n_real, guides = x4_model_inputs(rows, seed=len(str(rows)) + 47)
    assert guides[:, 24:32].any() or rows == 1
    model = x4_model(codes, guides)
    c, g = torch.from_numpy(codes), torch.from_numpy(guides)
    partial = 0
    for thr in THR_EDGES:
        want = sv.v6_bf16out_reference(c, g, thr)[0].numpy()
        got = model(thr)
        assert np.array_equal(got, want), (rows, thr)
        tpu = pallas(lambda: X.make_v6_bf16out(thr, X4_MODEL_N, guides.shape[0],
                                               t_tile=X4_MODEL_N), codes, guides)
        assert np.array_equal(got, tpu[0]), (rows, thr)
        if thr <= 0:
            assert want.all(), thr
        elif thr > 32:
            assert not want.any(), thr
        partial += 0 < int(want[:n_real].sum()) < n_real
    assert not model(1)[n_real:].any()
    assert partial or rows == 1
