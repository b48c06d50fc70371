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
from flashfry_tpu_torch import cli, trace
from flashfry_tpu_torch.database import build_database_from_sites, save_database
from flashfry_tpu_torch.discovery import find_target_sites
from flashfry_tpu_torch.engine import (discover, pruned_comparisons,
                                      pruned_comparisons_device)
from flashfry_tpu_torch.ops import scan as scan_module
from flashfry_tpu_torch.ops import scan_kernel as tk
from flashfry_tpu_torch.ops import stage1_variants as sv
from flashfry_tpu_torch.ops.scan import DeviceScanner, guide_onehot_matrix, plane_codes
from flashfry_tpu_torch.ops.scan_kernel import CODE_ROWS
from flashfry_tpu_torch.parallel.mesh import ShardedScanner, make_mesh
from flashfry_tpu_torch.scoring import device as scoring_device
from flashfry_tpu_torch.standards import Cas9NGGParameterPack, Cpf1ParameterPack
from flashfry_tpu_torch.tools import experiment_stage1 as tool
from planes_words import counted_words, with_counts

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


@pytest.mark.parametrize("G", chip_smoke.PHASE3_ROWS)
def test_stage1_kernel_equals_plain(cuda, G):
    """The wgmma kernel on a ragged width (not a multiple of its 64-target
    m-tile) with a PAD_CODE tail, at guide rows that are and are not
    multiples of compact_guides' 16 rows and of its 128-row n-tile (1152:
    9 n-tiles), with guide padding rows, and on super rows (two 1s per
    position), for every thr from 1 to 20: bitwise equal to the plain
    version, one launch per call."""
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
    128 and 2048 guide rows, mm 0..5, and X1 and X2 at the wgmma kernel's
    row edges (chip_smoke.WGMMA_ROWS): bitwise equal."""
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
    for G in chip_smoke.WGMMA_ROWS:
        guides = targets[rng.integers(0, n_real, size=G)]
        oh, _, _ = guide_onehot_matrix(guides, Cas9NGGParameterPack, pad_to=G)
        gi8 = sv.interleaved_guides(torch.from_numpy(oh).to(cuda), 23)
        for thr in (20, 16):
            for got, ref in ((sv.v1_gloop(codes, gi8, thr), sv.v1_gloop_reference(codes, gi8, thr)),
                             (sv.v3_int16(codes, gi8, thr), sv.v3_int16_reference(codes, gi8, thr))):
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (G, thr)
                assert not bool(got[0, n_real:].any())
    assert hits > 0
    edges = 2 * len(chip_smoke.WGMMA_ROWS)
    assert [k.launches - b for k, b in zip(sv.KERNELS, before)] == \
        [12 + edges, 12 + edges, 12, 24, 36, 16]


@pytest.mark.parametrize("G", chip_smoke.X4_ROWS)
def test_v6_bf16out_kernel_equals_plain_at_every_row_count_and_thr_edge(cuda, G):
    """X4 on wgmma, on a ragged width with a PAD_CODE tail, at guide rows
    around its 128-row n-tile (and the earlier design's 16-row m-tile) and
    its 1024-row stage (1025 and 2048 rows take two stages), on super rows,
    and with random 0/1 rows (1s in columns 24..31), at every int32
    threshold edge: bitwise equal to the plain version, one launch per
    call, all ones at thr <= 0."""
    rng = np.random.default_rng(12)
    n_real, n = 150_001, 153_333
    targets = rng.integers(0, 1 << 46, size=n_real, dtype=np.uint64)
    codes = torch.from_numpy(plane_codes(targets, 23, n)).to(cuda)
    assert chip_smoke.x4_edge_compares(codes, n_real, G) > 0


@pytest.mark.parametrize("G", chip_smoke.WGMMA_ROWS)
def test_v5_tile_and_expanded_kernels_equal_plain_at_every_row_count_and_thr_edge(cuda, G):
    """X1, X2, X3, X5 and X6 full/dot on the wgmma kernel, on a ragged
    width with a PAD_CODE tail, at guide rows around its 64-row m-tile and
    its 1024-row stage, X3 on block-layout guides (its block-order target
    tile), X5 at target tiles 1, 100, 2048, 8192 and n + 1, X6 on the
    expanded one-hot and on random 0/1 bytes (several 1s per group of four
    rows: the tensor-core product needs no one-hot), at every int32
    threshold edge (X2: int16): bitwise equal to the plain versions, one
    counted launch per call (chip_smoke.wgmma_edge_compares asserts the
    counts)."""
    rng = np.random.default_rng(13)
    n_real, n = 150_001, 153_333
    targets = rng.integers(0, 1 << 46, size=n_real, dtype=np.uint64)
    codes = torch.from_numpy(plane_codes(targets, 23, n)).to(cuda)
    assert chip_smoke.wgmma_edge_compares(codes, n_real, G) > 0


@pytest.mark.parametrize("G", sorted(set(chip_smoke.WGMMA_ROWS) | {192, 1000}))
def test_v1_gloop_kernel_reads_only_whole_tiles(cuda, G):
    """X1 with a ragged tail of guide rows (fewer than 128: no whole tile,
    the max stays -1) equals its plain version, at thresholds that hit and
    at -1."""
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


def scan_by_guide(scanner, guides, mm):
    got = {}
    for t_idx, g_idx, m in scanner.scan(guides, mm):
        for t, g, k in zip(t_idx.tolist(), g_idx.tolist(), m.tolist()):
            got.setdefault(g, []).append((t, k))
    return got


@pytest.mark.parametrize("mm", [3, 5])
@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_streaming_scan_on_cuda_equals_resident(cuda, monkeypatch, pack, mm):
    """Seven or more one-granule slabs through the two buffers, the copy stream
    and its events, 128-row guide blocks (three) inside each: every buffer
    and pinned pair is reused, so a missing wait shows as a wrong hit. Hits
    per guide, in order, equal the resident scan's; K1 runs once per slab
    and block."""
    genome = random_genome(240_000 if pack is Cas9NGGParameterPack else 960_000,
                           seed=23)
    db = build_db(genome, pack)
    guides = np.asarray(find_target_sites(iter([("g", genome[5000:45000])]),
                                          pack).sequences)[:300]
    monkeypatch.setattr(scan_module, "MAX_GUIDE_ROWS", 128)
    resident = DeviceScanner(db, cuda)
    assert resident.mode == "resident"  # the default budget holds it
    want = scan_by_guide(resident, guides, mm)
    stream = DeviceScanner(db, cuda, budget=2 * 32 * scan_module.SLAB_GRANULE)
    assert stream.mode == "streaming" and stream.slabs >= 3
    assert db.num_targets % stream.slab_n
    before = tk.stage1.launches
    got = scan_by_guide(stream, guides, mm)
    assert tk.stage1.launches - before == stream.slabs * 3
    assert got == want and sum(map(len, got.values())) > 0


@pytest.mark.parametrize("L", [20, 21, 22, 23, 24])
def test_expand_kernel_equals_plain(cuda, L):
    """csrc/planes.cu against expand_codes_plain, bitwise, on words with
    counts: widths that are not multiples of 16 (each row at another
    alignment), an offset start, tails of 1..3 targets past whole tiles,
    n = 0; the bytes outside the columns keep their value. One launch per
    call with targets, none without, in plane_build.kernel_slabs."""
    rng = np.random.default_rng(L)
    for width, start, n in ((4099, 0, 4099), (4099, 5, 4093), (1027, 1, 1025),
                            (2053, 13, 2040), (33, 3, 30), (17, 17, 0),
                            (1 << 20, 0, 1 << 20), ((1 << 20) + 3, 2, 1 << 20)):
        words = torch.from_numpy(counted_words(rng, n, L).view(np.int64))
        start_buf = torch.from_numpy(rng.integers(-128, 128, size=(32, width),
                                                  dtype=np.int8))
        want = start_buf.clone()
        scan_module.expand_codes_plain(want, words, start, L)
        got = start_buf.to(cuda)
        with trace.recording() as rec:
            scan_module.expand_codes(got, words.to(cuda), start, L)
        torch.cuda.synchronize()
        assert rec.counts.get("plane_build.kernel_slabs", 0) == (1 if n else 0)
        assert torch.equal(got.cpu(), want), (width, start, n)
        assert np.array_equal(want[:, start:start + n].numpy(),
                              plane_codes(words.numpy().view(np.uint64), L))


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_resident_and_streaming_planes_on_cuda_equal_plane_codes(cuda, pack,
                                                                 monkeypatch):
    """The resident build (in pieces of 1,000 targets, so the two pinned
    staging buffers are each reused) and every streamed slab equal
    plane_codes on words with counts; plane_build.kernel_slabs counts the
    pieces, and both builds count their time on the card."""
    monkeypatch.setattr(scan_module, "SLAB", 1000)
    db = with_counts(build_db(random_genome(
        240_000 if pack is Cas9NGGParameterPack else 960_000, seed=27), pack), 3)
    L, n = db.pack.total_scan_length, db.num_targets
    want = torch.from_numpy(plane_codes(db.targets, L, n + 5))
    with trace.recording() as rec:
        got = scan_module.device_plane_codes(db.targets, L, n + 5, cuda)
        torch.cuda.synchronize()
    pieces = -(-n // 1000)
    assert torch.equal(got.cpu(), want)
    assert rec.counts.pop("plane_build.card_us") > 0
    assert rec.counts == {"plane_build.h2d_bytes": 8 * n,
                          "plane_build.kernel_slabs": pieces}
    assert torch.equal(DeviceScanner(db, cuda).codes.cpu(), want[:, :n])

    stream = DeviceScanner(db, cuda, budget=2 * 32 * scan_module.SLAB_GRANULE)
    assert stream.mode == "streaming" and stream.slabs >= 3
    with trace.recording() as rec:
        for t_lo, codes, n_valid in stream.stream_slabs():
            assert torch.equal(codes[:, :n_valid].cpu(), want[:, t_lo:t_lo + n_valid])
            assert bool((codes[:, n_valid:] == scan_module.PAD_CODE).all())
    pieces = sum(-(-min(stream.slab_n, n - lo) // 1000)
                 for lo in range(0, n, stream.slab_n))
    assert rec.counts.pop("plane_build.card_us") > 0
    assert rec.counts == {"plane_build.h2d_bytes": 8 * n,
                          "plane_build.kernel_slabs": pieces}


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_fill_planes_on_cuda_overwrites_every_byte_of_a_sentinel_buffer(
        cuda, pack, monkeypatch):
    """The one plane build on the card, handed a buffer of 9s, in pieces of
    1,000 targets (ragged last piece) and at an odd width: every real column
    equals plane_codes (K3 writes rows >= L as 0) and every later column is
    PAD_CODE, so nothing of the buffer's old bytes is left."""
    monkeypatch.setattr(scan_module, "SLAB", 1000)
    db = with_counts(build_db(random_genome(
        240_000 if pack is Cas9NGGParameterPack else 960_000, seed=29), pack), 5)
    L, n = db.pack.total_scan_length, db.num_targets
    assert n % 1000 and n > 3000
    buf = torch.full((32, n + 37), 9, dtype=torch.int8, device=cuda)
    scan_module.fill_planes(buf, db.targets, L, scan_module.WordStaging(1000, buf.device))
    torch.cuda.synchronize()
    assert torch.equal(buf[:, :n].cpu(), torch.from_numpy(plane_codes(db.targets, L)))
    assert bool((buf[:, n:] == scan_module.PAD_CODE).all())


def test_plane_build_counts_its_time_on_the_card(cuda, tmp_path):
    """A resident build, the sharded build of a 2 x 2 mesh on one card and
    the discover CLI count plane_build.card_us, positive and no larger than
    their plane_build span (which the sharded build's test closes after a
    wait of its own: the scanner makes none); a streaming scanner, which
    builds its slabs in every scan, counts it too, positive and no larger
    than its scan span. The CLI's spans at top level cover at least 95% of
    its call."""
    genome = random_genome(1_000_000, seed=33)
    db = build_db(genome, Cas9NGGParameterPack)
    DeviceScanner(db, cuda)  # the expand kernel loaded, blocks cached
    for build in (lambda: DeviceScanner(db, cuda),
                  lambda: (ShardedScanner(db, mesh=make_mesh(["cuda:0"] * 4)),
                           torch.cuda.synchronize())):
        with trace.recording() as rec:
            with trace.span("plane_build"):
                build()
            assert "plane_build.card_us" not in rec.counts  # read at close
        assert 0 < rec.counts["plane_build.card_us"] <= 1e6 * rec.spans["plane_build"]

    guides = np.asarray(db.targets[:64], dtype=np.uint64)
    with trace.recording() as rec:
        stream = DeviceScanner(db, cuda, budget=2 * 32 * scan_module.SLAB_GRANULE)
        assert stream.mode == "streaming" and stream.slabs >= 3
        with trace.span("scan"):
            assert list(stream.scan(guides, 3))
    assert rec.counts["plane_build.h2d_bytes"] == 8 * db.num_targets
    assert 0 < rec.counts["plane_build.card_us"] <= 1e6 * rec.spans["scan"]

    db_path = str(tmp_path / "db")
    save_database(db, db_path)
    (tmp_path / "g.fa").write_text(">g\n" + genome[5000:7000] + "\n")
    report = cli.run(["discover", "--fasta", str(tmp_path / "g.fa"), "--database",
                      db_path, "--output", str(tmp_path / "out"), "--device", "cuda"])
    spans, counts = report["spans"], report["counts"]
    assert 0 < counts["plane_build.card_us"] <= 1e6 * spans["plane_build"]
    call = report["call_seconds"]
    assert 0.95 * call <= sum(report["top_spans"].values()) <= call


@pytest.mark.parametrize("second", [False, True], ids=["current_card", "second_card"])
def test_plane_builds_wait_on_the_card_they_build_on(cuda, second, monkeypatch):
    """With cuda:0 current, the planes built on cuda:0 or on cuda:1: the
    staging buffers' waits are on the building card's stream. That card is
    first held busy by a spin kernel, so no upload can run before the host
    would have copied every slab had it not waited: the build in 7
    pieces (each staging buffer refilled thrice) still equals plane_codes
    bitwise on words with counts, and so do the scanner's resident and
    streaming planes and each shard of a 3-shard mesh built there."""
    if second and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda:1" if second else "cuda:0")
    L, n = 23, 200_000
    monkeypatch.setattr(scan_module, "SLAB", 1 << 15)
    words = counted_words(np.random.default_rng(7), n, L)
    db = with_counts(build_db(random_genome(240_000, seed=31), Cas9NGGParameterPack), 5)
    want = torch.from_numpy(plane_codes(db.targets, db.pack.total_scan_length))
    with torch.cuda.device(0):
        # the build's kernels loaded and device and pinned blocks cached
        # first: a kernel's first load, cudaMalloc or cudaHostAlloc inside
        # the build would wait for the card and hide a missing wait
        scan_module.device_plane_codes(words[:10], L, 10, dev)
        torch.cuda.synchronize(dev)
        torch.empty(64 << 20, dtype=torch.int8, device=dev)
        torch.empty(1 << 20, dtype=torch.int8, device=dev)
        pinned = [torch.empty(1 << 15, dtype=torch.int64, pin_memory=True)
                  for _ in range(2)]
        del pinned
        with torch.cuda.device(dev):
            torch.cuda._sleep(1 << 29)  # about a quarter of a second
        got = scan_module.device_plane_codes(words, L, n + 3, dev)
        torch.cuda.synchronize(dev)
        assert got.device == dev
        assert torch.equal(got.cpu(), torch.from_numpy(plane_codes(words, L, n + 3)))

        resident = DeviceScanner(db, dev)
        assert resident.codes.device == dev and torch.equal(resident.codes.cpu(), want)
        stream = DeviceScanner(db, dev, budget=2 * 32 * scan_module.SLAB_GRANULE)
        assert stream.mode == "streaming" and stream.slabs >= 3
        for t_lo, codes, n_valid in stream.stream_slabs():
            assert codes.device == dev
            assert torch.equal(codes[:, :n_valid].cpu(), want[:, t_lo:t_lo + n_valid])
        sharded = ShardedScanner(db, mesh=make_mesh(["cuda:0", dev, dev]))
        assert sharded.D == 3 and torch.cuda.current_device() == 0
        for (s, _q), planes in sharded.planes.items():
            lo, nv = s * sharded.shard_n, sharded.shard_valid(s)
            assert planes.device == (dev if s else torch.device("cuda:0"))
            assert torch.equal(planes[:, :nv].cpu(), want[:, lo:lo + nv])
            assert bool((planes[:, nv:] == scan_module.PAD_CODE).all())


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_sharded_scan_on_a_virtual_mesh_of_one_card_equals_resident(cuda, pack):
    """A 2 db x 2 guides mesh on cuda:0: each (shard, sub-block)'s planes are
    the resident planes' columns with PAD_CODE past them, the hits per guide
    in order are the resident scan's, and K1 runs once per (shard,
    sub-block) of the one 1024-row block (512 + 88 guides)."""
    genome = random_genome(400_000, seed=25)
    db = build_db(genome, pack)
    guides = np.asarray(find_target_sites(iter([("g", genome[5000:45000])]),
                                          pack).sequences)[:600]
    assert guides.shape[0] == 600
    resident = DeviceScanner(db, cuda)
    want = scan_by_guide(resident, guides, 4)
    sharded = ShardedScanner(db, mesh=make_mesh(["cuda:0"] * 4))
    for (s, q), planes in sharded.planes.items():
        lo, nv = s * sharded.shard_n, sharded.shard_valid(s)
        assert torch.equal(planes[:, :nv], resident.codes[:, lo:lo + nv])
        assert bool((planes[:, nv:] == scan_module.PAD_CODE).all())
    before = tk.stage1.launches
    got = scan_by_guide(sharded, guides, 4)
    assert tk.stage1.launches - before == 4
    assert got == want and sum(map(len, got.values())) > 0


def test_two_process_discover_cli_on_cuda_byte_identical_to_numpy(cuda, tmp_path, monkeypatch):
    """The discover CLI in two processes on the card (a gloo group): process
    0 writes the numpy CLI's bytes, process 1 nothing, and each launched K1
    on its own shard."""
    genome = random_genome(200_000, seed=27)
    db = build_db(genome, Cas9NGGParameterPack)
    db_path = str(tmp_path / "db")
    save_database(db, db_path)
    fasta = tmp_path / "g.fa"
    fasta.write_text(">g\n" + genome[1000:3000] + "\n")
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "DEVICE", "cuda")
    outs, reports, _wall = chip_smoke.process_discover(
        db_path, str(fasta), "mh", ("--maxMismatch", "4"))
    ref = str(tmp_path / "n")
    cli.run(["discover", "--fasta", str(fasta), "--database", db_path, "--positionOutput",
             "--maxMismatch", "4", "--output", ref, "--backend", "numpy"])
    assert filecmp.cmp(outs[0], ref, shallow=False) and os.path.getsize(ref)
    assert not os.path.exists(outs[1])
    for pid, r in enumerate(reports):
        assert (r["scan_mode"], r["shards"], r["process"]) == ("multihost", [2, 1], pid)
        assert r["stage1_launches"] >= 1 and r["gathered_bytes"] > 0


def test_streaming_discover_cli_on_cuda_byte_identical_to_numpy(cuda, tmp_path):
    """engine.discover with a streaming scanner on the card writes the
    numpy CLI's bytes, overflowing guides included."""
    codes = chip_smoke.synthesize_genome(2, np.random.default_rng(2024))
    db = build_db(np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes().decode(),
                  Cas9NGGParameterPack)
    db_path = str(tmp_path / "db")
    save_database(db, db_path)
    fasta = str(tmp_path / "g.fa")
    chip_smoke.write_guides(fasta, db, chip_smoke.sample_guides(
        db, 60, np.random.default_rng(3)))
    stream = DeviceScanner(db, cuda, budget=CODE_ROWS * db.num_targets // 2)
    assert stream.mode == "streaming" and stream.slabs >= 3
    sites = cli.find_target_sites(cli.iterate_fasta(fasta), db.pack,
                                  flanking_sequence=6, capture_context=True)
    guides = discover(db, sites, max_mismatch=4, device=cuda, scanner=stream)
    mine, ref = str(tmp_path / "t"), str(tmp_path / "n")
    cli.write_output(mine, guides, db.bit_encoding(), db.bit_position(),
                     models=(), write_ots=True, write_positions=True)
    cli.run(["discover", "--fasta", fasta, "--database", db_path, "--positionOutput",
             "--maxMismatch", "4", "--output", ref, "--backend", "numpy"])
    assert any(g.full for g in guides)
    assert filecmp.cmp(mine, ref, shallow=False)


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
