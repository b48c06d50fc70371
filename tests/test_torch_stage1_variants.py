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
tensor-core X4 kernel rests on are held on the plain version: its byte is
the OR of the bytes of row chunks zero-padded to 16 rows, and it equals the
integer any(count >= thr) at every int32 threshold.
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
    of the bytes over row chunks, each zero-padded to a multiple of 16
    rows, is the byte over all rows, at every threshold edge."""
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
            part = torch.nn.functional.pad(guides[a:b], (0, 0, 0, -(b - a) % 16))
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
