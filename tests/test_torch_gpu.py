"""The port on a CUDA card: kernels vs plain versions, scanner, counter, CLIs.

Every test here is marked `gpu` and skips without a card. The machine with
the card has no JAX, so this file imports only the port (whose numpy
backend and host modules are its own copies) and runs without the
repository's conftest (which pins JAX to the CPU):

    PYTHONPATH=. python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import filecmp
import os

import numpy as np
import pytest
import torch

import chip_smoke
from flashfry_tpu_torch import cli
from flashfry_tpu_torch.database import build_database_from_sites, save_database
from flashfry_tpu_torch.discovery import find_target_sites
from flashfry_tpu_torch.engine import pruned_comparisons, pruned_comparisons_device
from flashfry_tpu_torch.ops import scan_kernel as tk
from flashfry_tpu_torch.ops import stage1_variants as sv
from flashfry_tpu_torch.ops.scan import DeviceScanner, guide_onehot_matrix, plane_codes
from flashfry_tpu_torch.scoring import device as scoring_device
from flashfry_tpu_torch.standards import Cas9NGGParameterPack, Cpf1ParameterPack
from flashfry_tpu_torch.tools import experiment_stage1 as tool

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_genome(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def build_db(seq, pack):
    return build_database_from_sites(find_target_sites(iter([("chrT", seq)]), pack), 7)


@pytest.mark.parametrize("G", [1, 15, 16, 17, 100, 128, "512 super rows", 2048])
def test_stage1_kernel_equals_plain(cuda, G):
    """The tensor-core kernel on a ragged width (not a multiple of its
    64-target warp tile) with a PAD_CODE tail, at guide rows that are and
    are not multiples of its 16-row m-tile, with guide padding rows, and on
    super rows (two 1s per position), for every thr from 1 to 20: bitwise
    equal to the plain version, one launch per call."""
    rng = np.random.default_rng(3)
    n_real, n = 150_001, 153_333
    targets = rng.integers(0, 1 << 46, size=n_real, dtype=np.uint64)
    codes = torch.from_numpy(plane_codes(targets, 23, n)).to(cuda)
    rows = 1024 if G == "512 super rows" else G
    guides = targets[rng.integers(0, n_real, size=rows - rows // 16)].copy()
    for j in range(guides.shape[0]):
        for pos in rng.integers(0, 23, size=j % 7):
            guides[j] ^= np.uint64(int(rng.integers(1, 4))) << np.uint64(2 * int(pos))
    oh, _, _ = guide_onehot_matrix(guides, Cas9NGGParameterPack, pad_to=rows)
    gi8 = tk.guide_block_layout(torch.from_numpy(oh).to(cuda), 23)
    if G == "512 super rows":
        gi8 = sv.super_rows(gi8)
    before = tk.stage1.launches
    for thr in range(1, 21):
        got = tk.stage1(codes, gi8, thr)
        want = tk.stage1_reference(codes, gi8, thr)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (G, thr)
        assert not bool(got[n_real:].any())
        if thr == 20:
            assert bool(got.any())
    assert tk.stage1.launches == before + 20


def test_stage1_variant_kernels_equal_plain(cuda):
    """X1, X2, X3, X4 (on the rows and on their super rows), X5 (three
    tiles) and X6 (three modes) on a ragged width with a PAD_CODE tail, at
    128 and 2048 guide rows, mm 0..5: bitwise equal."""
    rng = np.random.default_rng(9)
    n_real, n = 150_001, 153_333
    targets = rng.integers(0, 1 << 46, size=n_real, dtype=np.uint64)
    codes = torch.from_numpy(plane_codes(targets, 23, n)).to(cuda)
    onehot = sv.expand_onehot(codes, 23)
    before = [k.launches for k in sv.KERNELS]
    hits = 0
    for G in (128, 2048):
        guides = targets[rng.integers(0, n_real, size=G - 20)].copy()
        for j in range(guides.shape[0]):
            for pos in rng.integers(0, 23, size=j % 7):
                guides[j] ^= np.uint64(int(rng.integers(1, 4))) << np.uint64(2 * int(pos))
        oh, _, _ = guide_onehot_matrix(guides, Cas9NGGParameterPack, pad_to=G)
        goh = torch.from_numpy(oh).to(cuda)
        gi8 = sv.interleaved_guides(goh, 23)
        blk = tk.guide_block_layout(goh, 23)
        sup = sv.super_rows(blk)
        for mm in range(6):
            thr = 20 - mm
            pairs = [(sv.v1_gloop(codes, gi8, thr), sv.v1_gloop_reference(codes, gi8, thr)),
                     (sv.v3_int16(codes, gi8, thr), sv.v3_int16_reference(codes, gi8, thr)),
                     (sv.v4_concat_onehot(codes, blk, thr),
                      sv.v4_concat_onehot_reference(codes, blk, thr)),
                     (sv.v6_bf16out(codes, blk, thr), sv.v6_bf16out_reference(codes, blk, thr)),
                     (sv.v6_bf16out(codes, sup, thr), sv.v6_bf16out_reference(codes, sup, thr)),
                     (sv.expanded(onehot, gi8, thr, "full"),
                      sv.expanded_reference(onehot, gi8, thr, "full"))]
            want = sv.v5_tile_reference(codes, gi8, thr)
            pairs += [(sv.v5_tile(codes, gi8, thr, t), want) for t in (1000, 2048, 8192)]
            for got, ref in pairs:
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (G, mm)
                assert not bool(got[0, n_real:].any())
            hits += int(pairs[0][0].sum())
        for mode in ("dot", "copy"):
            got = sv.expanded(onehot, gi8, 16, mode)
            assert torch.equal(got, sv.expanded_reference(onehot, gi8, 16, mode)), (G, mode)
    assert hits > 0
    assert [k.launches - b for k, b in zip(sv.KERNELS, before)] == [12, 12, 12, 24, 36, 16]


@pytest.mark.parametrize("G", chip_smoke.X4_ROWS)
def test_v6_bf16out_kernel_equals_plain_at_every_row_count_and_thr_edge(cuda, G):
    """X4 on the tensor cores, on a ragged width with a PAD_CODE tail, at
    guide rows around its 16-row m-tile and its 1024-row stage (1025 and
    2048 rows take two stages), on super rows, and with random 0/1 rows
    (1s in columns 24..31), at every int32 threshold edge: bitwise equal to
    the plain version, one launch per call, all ones at thr <= 0."""
    rng = np.random.default_rng(12)
    n_real, n = 150_001, 153_333
    targets = rng.integers(0, 1 << 46, size=n_real, dtype=np.uint64)
    codes = torch.from_numpy(plane_codes(targets, 23, n)).to(cuda)
    assert chip_smoke.x4_edge_compares(codes, n_real, G) > 0


@pytest.mark.parametrize("G", [64, 192, 1000])
def test_v1_gloop_kernel_reads_only_whole_tiles(cuda, G):
    """X1 with a ragged tail of guide rows (64: no whole tile, the max stays
    -1) equals its plain version, at thresholds that hit and at -1."""
    rng = np.random.default_rng(G)
    n = 70_001
    targets = rng.integers(0, 1 << 46, size=n, dtype=np.uint64)
    codes = torch.from_numpy(plane_codes(targets, 23)).to(cuda)
    oh, _, _ = guide_onehot_matrix(targets[rng.integers(0, n, size=G)],
                                   Cas9NGGParameterPack, pad_to=G)
    gi8 = sv.interleaved_guides(torch.from_numpy(oh).to(cuda), 23)
    for thr in (20, 16, -1):
        got = sv.v1_gloop(codes, gi8, thr)
        assert torch.equal(got, sv.v1_gloop_reference(codes, gi8, thr)), (G, thr)
        if G < 128:
            assert bool((got == int(-1 >= thr)).all())
        elif thr == 20:
            assert bool(got.any())


def test_experiment_tool_on_cuda(cuda):
    """The port's tool at a small size: all twelve keys, each through its
    kernel, held against its plain version inside run()."""
    before = [k.launches for k in sv.KERNELS] + [tk.stage1.launches]
    _inp, results = tool.run(device="cuda", chunk=1 << 16, G=256, reps=1,
                             variants_spec=",".join(tool.ORDER))
    assert [r["max_abs_err"] for r in results if "key" in r] == [0] * 12
    after = [k.launches for k in sv.KERNELS] + [tk.stage1.launches]
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_scanner_and_counter_on_cuda_match_host(cuda, pack):
    genome = random_genome(200_000, seed=21)
    db = build_db(genome, pack)
    guides = np.asarray(find_target_sites(iter([("g", genome[2000:4000])]),
                                          pack).sequences)
    mm = db.bit_encoding().mismatches_cross(guides, db.targets)
    want = {g: [(int(t), int(mm[g, t])) for t in np.nonzero(mm[g] <= 4)[0]]
            for g in range(guides.shape[0]) if (mm[g] <= 4).any()}
    got = {}
    before = tk.stage1.launches
    for t_idx, g_idx, m in DeviceScanner(db, cuda).scan(guides, 4):
        for t, g, k in zip(t_idx.tolist(), g_idx.tolist(), m.tolist()):
            got.setdefault(g, []).append((t, k))
    assert got == want
    assert tk.stage1.launches > before
    for k in (3, 4, 5):
        assert pruned_comparisons_device(db, guides, k, cuda) == \
            pruned_comparisons(db, guides, k)


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_discover_cli_on_cuda_at_max_mismatch_of_active_positions(cuda, tmp_path, pack):
    """--maxMismatch = the active positions on the card: the scan skips
    stage 1 and recounts every real column, so the planted target that
    matches the guide at no active position is reported, byte for byte as
    the numpy CLI reports it."""
    active = list(pack.comparison_mask_positions())
    guide = np.asarray(list(random_genome(pack.total_scan_length, seed=60)))
    if pack.five_prime_pam:
        guide[:4] = list("TTTA")
    else:
        guide[-3:] = list("AGG")
    anti = guide.copy()  # a different base at every active position
    anti[active] = ["ACGT"[("ACGT".index(b) + 1) % 4] for b in guide[active]]
    genome = "".join([random_genome(6000, seed=61), "".join(guide), "TTTT",
                      "".join(anti), random_genome(100, seed=62)])
    db = build_db(genome, pack)
    sites = np.asarray(find_target_sites(iter([("g", "".join(guide))]), pack).sequences)
    assert (db.bit_encoding().mismatches_cross(sites, db.targets) == len(active)).any()
    db_path = str(tmp_path / "db")
    save_database(db, db_path)
    fasta = tmp_path / "g.fa"
    fasta.write_text(">g\n%s\n" % "".join(guide))
    base = ["discover", "--fasta", str(fasta), "--database", db_path,
            "--positionOutput", "--maxMismatch", str(len(active)),
            "--maximumOffTargets", "1000000"]
    mine, ref = str(tmp_path / "t"), str(tmp_path / "n")
    before = tk.stage1.launches
    report = cli.run(base + ["--output", mine, "--device", "cuda"])
    cli.run(base + ["--output", ref, "--backend", "numpy"])
    assert report["guides"] == 1 and report["overflowed_guides"] == 0
    assert tk.stage1.launches == before
    assert filecmp.cmp(mine, ref, shallow=False) and os.path.getsize(mine)


def test_discover_cli_on_cuda_byte_identical_to_numpy(cuda, tmp_path):
    genome = random_genome(200_000, seed=4)
    db = build_db(genome, Cas9NGGParameterPack)
    db_path = str(tmp_path / "db")
    save_database(db, db_path)
    fasta = tmp_path / "g.fa"
    fasta.write_text(">g\n" + genome[1000:3000] + "\n")
    for k in ("3", "5"):
        base = ["discover", "--fasta", str(fasta), "--database", db_path,
                "--positionOutput", "--maxMismatch", k]
        mine, ref = str(tmp_path / ("t" + k)), str(tmp_path / ("n" + k))
        cli.run(base + ["--output", mine, "--device", "cuda"])
        cli.run(base + ["--output", ref, "--backend", "numpy"])
        assert filecmp.cmp(mine, ref, shallow=False) and os.path.getsize(mine)


@pytest.mark.parametrize("enzyme", ["spcas9ngg", "spcas919"])
@pytest.mark.parametrize("n,g", [(1, 1), (1000, 37), (65_537, 1059), (1 << 20, 1059)])
def test_descriptor_kernel_equals_plain(cuda, enzyme, n, g):
    """K5 on off-targets with 0..9 planted mismatches (counts 0, 1, 6, 7 and
    beyond, the overflow bit, every PAM): both words equal the plain
    version's, one launch per call."""
    lo, hi, gi, gcodes, act_n, k = chip_smoke.planted_off_targets(n, g, enzyme, n + g, cuda)
    before = scoring_device.descriptors.launches
    w0, w1 = scoring_device.descriptors(lo, hi, gi, gcodes, act_n)
    torch.cuda.synchronize()
    p0, p1 = scoring_device.descriptors_plain(lo, hi, gi, gcodes, act_n)
    assert w0.dtype == w1.dtype == torch.int32
    assert torch.equal(w0, p0) and torch.equal(w1, p1)
    assert torch.equal((w0 >> 27) & 7, k.clamp(max=7).to(torch.int32))
    assert torch.equal((w0 >> 30) & 1, (k > 6).to(torch.int32))
    assert scoring_device.descriptors.launches == before + 1
    if n >= 1000:
        assert bool((k > 6).any()) and bool((k == 0).any())


@pytest.mark.parametrize("enzyme", ["spcas9ngg", "spcas919"])
@pytest.mark.parametrize("act", ["0", "n_act", "L"])
def test_descriptor_kernel_equals_plain_at_every_active_count(cuda, enzyme, act):
    """K5 with no active position, the enzyme's active positions and all L
    (the PAM positions count too), L = 23 and 22: both words equal the
    plain version's, one launch per call."""
    lo, hi, gi, gcodes, n_act, k = chip_smoke.planted_off_targets(65_537, 1059, enzyme, 3, cuda)
    act_n = {"0": 0, "n_act": n_act, "L": gcodes.shape[1]}[act]
    assert chip_smoke.descriptors_equal((lo, hi, gi, gcodes, act_n, k), "%s act_n=%d"
                                        % (enzyme, act_n), planted=act == "n_act") == 0


def test_descriptor_kernel_launches_nothing_for_no_off_targets(cuda):
    lo, hi, gi, gcodes, act_n, _k = chip_smoke.planted_off_targets(0, 3, "spcas9ngg", 1, cuda)
    before = scoring_device.descriptors.launches
    w0, w1 = scoring_device.descriptors(lo, hi, gi, gcodes, act_n)
    assert w0.shape == w1.shape == (0,) and w0.is_cuda
    assert scoring_device.descriptors.launches == before


def test_score_cli_on_cuda_byte_identical_to_numpy(cuda, tmp_path):
    """index -> discover -> score on the card: --backend device writes the
    bytes of --backend numpy and of --backend native, with one K5 launch
    for the three off-target models; mm 7 lists hold descriptor-overflow
    rows."""
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, size=150_000)
    unit = rng.integers(0, 4, size=300)
    for j, p in enumerate(rng.integers(0, 150_000 - 300, size=40)):
        copy = unit.copy()
        s = rng.integers(0, 300, size=3 * (j % 2))
        copy[s] = (copy[s] + rng.integers(1, 4, size=s.size)) % 4
        codes[p:p + 300] = copy
    genome = "".join("ACGT"[c] for c in codes)
    db_path = str(tmp_path / "db")
    save_database(build_db(genome, Cas9NGGParameterPack), db_path)
    for mm, guides in (("4", genome[p:p + 300] + genome[2000:2400]), ("7", genome[9000:9300])):
        fasta = tmp_path / ("g%s.fa" % mm)
        fasta.write_text(">g\n" + guides + "\n")
        found = str(tmp_path / ("found" + mm))
        cli.run(["discover", "--fasta", str(fasta), "--database", db_path, "--output",
                 found, "--positionOutput", "--maxMismatch", mm, "--device", "cuda"])
        base = ["score", "--input", found, "--database", db_path, "--includeOTs",
                "--scoringMetrics", "doench2016cfd,hsu2013,jostandsantos,minot,dangerous,rank"]
        outs = {}
        for backend in ("device", "numpy", "native"):
            outs[backend] = str(tmp_path / ("scored%s.%s" % (mm, backend)))
            before = scoring_device.descriptors.launches
            report = cli.run(base + ["--output", outs[backend], "--backend", backend])
            assert report["off_targets"] > 50
            assert scoring_device.descriptors.launches - before == (backend == "device")
        assert os.path.getsize(outs["device"])
        assert filecmp.cmp(outs["device"], outs["numpy"], shallow=False)
        assert filecmp.cmp(outs["device"], outs["native"], shallow=False)
