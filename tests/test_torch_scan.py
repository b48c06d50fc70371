"""flashfry_tpu_torch.ops.scan (DeviceScanner, resident and streaming)
against flashfry_tpu.

Per guide, the port must yield the same ordered (target, mm) list as
flashfry_tpu's DeviceScanner (jnp path) and the numpy oracle: the hit-order
contract (global target-major per guide) is what the overflow cap needs.
Streaming, the same holds across slab boundaries, and the ScanStats equal
the resident scan's and flashfry_tpu's streaming scan's.
"""

import dataclasses
import filecmp
import warnings

import numpy as np
import pytest
import torch

import flashfry_tpu_torch.ops.scan as tscan
from flashfry_tpu import cli as jax_cli
from flashfry_tpu.database import build_database_from_sites, save_database
from flashfry_tpu.discovery import find_target_sites
from flashfry_tpu.engine import ScanStats
from flashfry_tpu.ops.scan import DeviceScanner as JaxScanner
from flashfry_tpu.ops.scan import PAD_CODE, device_plane_codes, plane_codes
from flashfry_tpu.standards import Cas9NGGParameterPack, Cpf1ParameterPack
from flashfry_tpu_torch import cli, trace
from flashfry_tpu_torch import engine as port_engine
from flashfry_tpu_torch.ops.scan import DeviceScanner
from planes_words import counted_words, with_counts


def random_genome(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def build_db(seq, pack):
    return build_database_from_sites(find_target_sites(iter([("chrT", seq)]), pack), 7)


def by_guide(scan_iter):
    got = {}
    for t_idx, g_idx, mm in scan_iter:
        assert t_idx.dtype == np.int64 and mm.dtype == np.int8
        for t, g, m in zip(t_idx.tolist(), g_idx.tolist(), mm.tolist()):
            got.setdefault(g, []).append((t, m))
    return got


def oracle(db, guide_longs, max_mm):
    mm = db.bit_encoding().mismatches_cross(
        np.asarray(guide_longs, dtype=np.uint64), db.targets)
    out = {}
    for g in range(mm.shape[0]):
        t_hits = np.nonzero(mm[g] <= max_mm)[0]
        if t_hits.size:
            out[g] = [(int(t), int(mm[g, t])) for t in t_hits]
    return out


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_device_scanner_matches_jax_scanner_and_oracle(pack):
    genome = random_genome(60000, seed=21)
    db = build_db(genome, pack)
    guides = np.asarray(find_target_sites(iter([("g", genome[2000:2600])]),
                                          pack).sequences)
    assert guides.shape[0] > 0
    want = oracle(db, guides, 4)
    s_port, s_jax = ScanStats(), ScanStats()
    scanner = DeviceScanner(db, "cpu")
    assert scanner.codes.shape == (32, db.num_targets)  # no padding columns
    got = by_guide(scanner.scan(guides, 4, stats=s_port))
    jax_got = by_guide(JaxScanner(db, use_pallas=False, chunk=1 << 14)
                       .scan(guides, 4, stats=s_jax))
    assert got == want == jax_got
    assert (s_port.all_targets, s_port.all_targets_and_positions,
            s_port.dense_comparisons) == (s_jax.all_targets,
                                          s_jax.all_targets_and_positions,
                                          s_jax.dense_comparisons)


def test_device_plane_codes_matches_host_and_jax(monkeypatch):
    rng = np.random.default_rng(3)
    for n, n_pad, slab in ((1000, 1 << 12, 1 << 10), (0, 1 << 10, 1 << 10),
                           (1 << 12, 1 << 12, 1 << 12), (3000, 4096, 1 << 12)):
        targets = rng.integers(0, 1 << 46, size=n, dtype=np.uint64)
        want = plane_codes(targets, 23, n_pad)
        # the port's pieces need not divide n_pad (JAX's slabs must)
        monkeypatch.setattr(tscan, "SLAB", slab // 4 + 7)
        got = tscan.device_plane_codes(targets, 23, n_pad, "cpu")
        assert got.dtype == torch.int8 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(
            got.numpy(), np.asarray(device_plane_codes(targets, 23, n_pad, slab)))
        assert (got.numpy()[:, n:] == PAD_CODE).all()


def test_col_batch_smaller_than_hit_columns_matches_oracle(monkeypatch):
    genome = random_genome(50000, seed=41)
    db = build_db(genome, Cas9NGGParameterPack)
    guides = np.asarray(find_target_sites(iter([("g", genome[0:3000])]),
                                          Cas9NGGParameterPack).sequences)
    want = oracle(db, guides, 5)
    n_cols = len({t for hits in want.values() for t, _ in hits})
    monkeypatch.setattr(tscan, "COL_BATCH", 64)
    assert n_cols > 4 * tscan.COL_BATCH, n_cols
    assert by_guide(DeviceScanner(db, "cpu").scan(guides, 5)) == want


def test_multi_block_sorted_hot_cluster_matches_oracle():
    """tests/test_scan_jax.py's sorted repeat-family case: a planted
    60-copy repeat and a SORTED sample of database targets as guides, so
    more than two 128-guide blocks are dealt round-robin."""
    genome = random_genome(120000, seed=5)
    rng = np.random.default_rng(9)
    unit = "".join("ACGT"[c] for c in rng.integers(0, 4, size=300))
    g = list(genome)
    for _ in range(60):
        p = int(rng.integers(0, len(genome) - 300))
        u = list(unit)
        for _ in range(int(rng.integers(0, 5))):
            u[int(rng.integers(0, 300))] = "ACGT"[int(rng.integers(0, 4))]
        g[p:p + 300] = u
    db = build_db("".join(g), Cas9NGGParameterPack)
    idx = np.sort(np.random.default_rng(3).choice(db.num_targets, size=300,
                                                  replace=False))
    guides = db.targets[idx]
    assert by_guide(DeviceScanner(db, "cpu").scan(guides, 4)) == oracle(db, guides, 4)


def test_scanner_refuses_cuda_without_a_card(monkeypatch):
    db = build_db(random_genome(3000, seed=2), Cas9NGGParameterPack)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        DeviceScanner(db, "cuda")


# --- streaming -------------------------------------------------------------

GRANULE = tscan.SLAB_GRANULE
TWO_GRANULES = 2 * 32 * GRANULE  # bytes of two one-granule slabs


def stats_of(stats):
    return (stats.all_targets, stats.all_targets_and_positions,
            stats.dense_comparisons)


def streaming(db, budget):
    scanner = DeviceScanner(db, "cpu", budget=budget)
    assert scanner.mode == "streaming" and scanner.codes is None
    assert scanner.slabs == -(-db.num_targets // scanner.slab_n)
    return scanner


@pytest.fixture(scope="module")
def stream_dbs():
    """~15,000 targets (a 120 kb genome for SpCas9-NGG, 480 kb for Cpf1,
    whose PAM is rarer), so one-granule slabs make >= 3 slabs with a
    partial last one; 300 guides from the genome."""
    out = {}
    for pack, size in ((Cas9NGGParameterPack, 120000), (Cpf1ParameterPack, 480000)):
        genome = random_genome(size, seed=77)
        db = build_db(genome, pack)
        guides = np.asarray(find_target_sites(iter([("g", genome[5000:25000])]),
                                              pack).sequences)[:300]
        out[pack.name] = db, guides
    return out


@pytest.mark.parametrize("mm", range(6))
@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_streaming_scan_matches_resident_and_jax_streaming(stream_dbs, monkeypatch,
                                                           pack, mm):
    """Slabs outer, 128-row guide blocks inner (three blocks): hits per guide
    in order and the ScanStats equal the port's resident scan and
    flashfry_tpu's streaming scan at the same budget."""
    db, guides = stream_dbs[pack.name]
    monkeypatch.setattr(tscan, "MAX_GUIDE_ROWS", 128)
    monkeypatch.setenv("FLASHFRY_TPU_MAX_BLOCK", "128")
    assert guides.shape[0] == 300
    scanner = streaming(db, TWO_GRANULES)
    assert scanner.slab_n == GRANULE and scanner.slabs >= 3
    assert db.num_targets % scanner.slab_n  # a partial last slab
    s_stream, s_res, s_jax = ScanStats(), ScanStats(), ScanStats()
    got = by_guide(scanner.scan(guides, mm, stats=s_stream))
    resident = by_guide(DeviceScanner(db, "cpu").scan(guides, mm, stats=s_res))
    jax_scanner = JaxScanner(db, use_pallas=False, chunk=1 << 12,
                             hbm_budget=TWO_GRANULES)
    assert jax_scanner.codes is None
    jax_got = by_guide(jax_scanner.scan(guides, mm, stats=s_jax))
    assert got == resident == jax_got
    assert sum(map(len, got.values())) > 0
    assert stats_of(s_stream) == stats_of(s_res) == stats_of(s_jax)
    assert s_stream.all_targets == 3 * db.num_targets  # three blocks, once


def test_streaming_one_slab_and_exact_multiple_of_the_slab(stream_dbs):
    """A slab as wide as the database (its PAD_CODE tail past n), and a
    database of exactly three full slabs, against the resident scan and
    flashfry_tpu's streaming scan."""
    db, guides = stream_dbs[Cas9NGGParameterPack.name]
    want = by_guide(DeviceScanner(db, "cpu").scan(guides, 4))
    one = streaming(db, TWO_GRANULES)
    one.slab_n, one.slabs = -(-db.num_targets // GRANULE) * GRANULE, 1
    assert by_guide(one.scan(guides, 4)) == want

    m = 3 * GRANULE
    cut = dataclasses.replace(db, targets=db.targets[:m],
                              pos_offsets=db.pos_offsets[:m + 1])
    exact = streaming(cut, TWO_GRANULES)
    assert exact.slabs == 3 and cut.num_targets == 3 * exact.slab_n
    s_stream, s_jax = ScanStats(), ScanStats()
    got = by_guide(exact.scan(guides, 4, stats=s_stream))
    assert got == by_guide(DeviceScanner(cut, "cpu").scan(guides, 4))
    jax_got = by_guide(JaxScanner(cut, use_pallas=False, chunk=1 << 12,
                                  hbm_budget=TWO_GRANULES).scan(guides, 4, stats=s_jax))
    assert got == jax_got and stats_of(s_stream) == stats_of(s_jax)


@pytest.mark.parametrize("over", [0, 1], ids=["mm=active", "mm=active+1"])
@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_streaming_at_max_mismatch_beyond_active_positions(stream_dbs, pack, over):
    """Every real column of every slab is recounted (no stage 1): each
    target of the database, once, in order, as the port's host scan gives
    them. (flashfry_tpu's device backend drops targets here.)"""
    db, guides = stream_dbs[pack.name]
    mm = len(pack.comparison_mask_positions()) + over
    s_stream, s_host = ScanStats(), ScanStats()
    got = by_guide(streaming(db, TWO_GRANULES).scan(guides[:2], mm, stats=s_stream))
    want = by_guide(port_engine._scan_numpy(db, guides[:2], mm, s_host, None))
    assert got == want
    assert [len(v) for v in got.values()] == [db.num_targets] * 2


def test_streaming_budget_admission(stream_dbs):
    db, _guides = stream_dbs[Cas9NGGParameterPack.name]
    n = db.num_targets
    fits = DeviceScanner(db, "cpu", budget=32 * n)
    assert fits.mode == "resident" and fits.slabs == 1
    assert fits.codes.shape == (32, n)
    assert DeviceScanner(db, "cpu").mode == "resident"  # no budget on the CPU
    assert streaming(db, 32 * n - 1).slab_n == (32 * n - 1) // 64 // GRANULE * GRANULE
    with pytest.raises(ValueError, match="two slabs"):
        DeviceScanner(db, "cpu", budget=TWO_GRANULES - 1)


def repeat_family_genome(seed):
    """2500 copies of one 300 bp unit, each base mutated with probability
    8%, between 60 bp random spacers: a guide from the unit has > 2000
    genomic positions within mm 4, spread over many distinct targets (one
    mutated copy each) and so over the whole sorted target range."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, size=300)
    parts = []
    for _ in range(2500):
        copy = unit.copy()
        hit = rng.random(300) < 0.08
        copy[hit] = (copy[hit] + rng.integers(1, 4, size=int(hit.sum()))) % 4
        parts += [rng.integers(0, 4, size=60), copy]
    seq = "".join("ACGT"[c] for c in np.concatenate(parts))
    return seq, "".join("ACGT"[c] for c in unit)


def test_streaming_discover_overflow_across_slabs_matches_numpy_cli(tmp_path):
    """engine.discover with a streaming scanner, written by the port's
    targetio, against `flashfry_tpu discover --backend numpy`, byte for
    byte, where a guide's 2000-position cap is crossed only after hits in
    earlier slabs."""
    genome, unit = repeat_family_genome(5)
    pack = Cas9NGGParameterPack
    db = build_db(genome, pack)
    db_path, fasta = str(tmp_path / "db"), tmp_path / "guides.fa"
    save_database(db, db_path)
    fasta.write_text(">unit\n%s\n" % unit)
    pdb = cli.load_database(db_path)
    scanner = DeviceScanner(pdb, "cpu", budget=2 * 32 * 6 * GRANULE)
    assert scanner.mode == "streaming" and scanner.slabs >= 3
    sites = cli.find_target_sites(cli.iterate_fasta(str(fasta)), pdb.pack,
                                  flanking_sequence=6, capture_context=True)
    guides = port_engine.discover(pdb, sites, max_mismatch=4, device="cpu",
                                  scanner=scanner)
    mine, ref = str(tmp_path / "stream.out"), str(tmp_path / "numpy.out")
    cli.write_output(mine, guides, pdb.bit_encoding(), pdb.bit_position(),
                     models=(), write_ots=True, write_positions=True)
    assert jax_cli.main(["discover", "--fasta", str(fasta), "--database", db_path,
                         "--positionOutput", "--maxMismatch", "4",
                         "--backend", "numpy", "--output", ref]) == 0
    assert filecmp.cmp(mine, ref, shallow=False)

    # some overflowing guide reaches its cap in a later slab than its first hit
    counts = np.diff(np.asarray(pdb.pos_offsets))
    crossed = []
    for g in (g for g in guides if g.full):
        hits = sorted(t for t, _ in by_guide(scanner.scan(
            np.array([g.long_encoding], dtype=np.uint64), 4))[0])
        at = hits[int(np.argmax(np.cumsum(counts[hits]) > 2000))]
        crossed.append((hits[0] // scanner.slab_n, at // scanner.slab_n))
    assert any(last > first for first, last in crossed), crossed


# --- the plane build: raw int64 words, expanded on the device ---------------

@pytest.mark.parametrize("L", [20, 23, 24])
def test_expand_plain_and_plane_build_equal_plane_codes_and_jax(L, monkeypatch):
    """The plain int64 expand, alone at an offset and through
    device_plane_codes' pieces of SLAB targets, equals plane_codes and the
    JAX package's device_plane_codes bitwise, with counts in the words' top
    bits: ragged piece edges, n = 0 and odd widths."""
    rng = np.random.default_rng(L)
    for n, n_pad, slab in ((1000, 1001, 333), (0, 7, 4), (0, 1 << 10, 1 << 10),
                           (4096, 4099, 1000), (3001, 3001, 3001), (5, 9, 2)):
        targets = counted_words(rng, n, L)
        assert n == 0 or (targets >> np.uint64(48)).any()
        want = plane_codes(targets, L, n_pad)
        monkeypatch.setattr(tscan, "SLAB", slab)
        got = tscan.device_plane_codes(targets, L, n_pad, "cpu")
        assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
        jax_slab = n_pad if n_pad <= 4 * slab else next(
            d for d in range(slab, 0, -1) if n_pad % d == 0)
        assert np.array_equal(
            got.numpy(), np.asarray(device_plane_codes(targets, L, n_pad, jax_slab)))

        # alone, into columns [start, start + n) of a wider buffer: the
        # columns around them keep their bytes
        start, width = 3, n + 8
        buf = torch.full((32, width), 9, dtype=torch.int8)
        tscan.expand_codes_plain(buf, torch.from_numpy(targets.view(np.int64)),
                                 start, L)
        assert np.array_equal(buf[:, start:start + n].numpy(), want[:, :n])
        assert (buf[:, :start] == 9).all() and (buf[:, start + n:] == 9).all()


def test_stage_words_copies_raw_words_from_a_read_only_memmap(tmp_path):
    """The host's staging copy takes the database's words as they are (the
    count bits too), from a read-only memory map without a warning, and from
    a plain array."""
    words = counted_words(np.random.default_rng(5), 1000, 23)
    path = str(tmp_path / "targets.u64")
    words.tofile(path)
    mapped = np.memmap(path, dtype=np.uint64, mode="r")
    for src in (mapped[100:900], words[100:900]):
        dst = torch.empty(800, dtype=torch.int64)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tscan.stage_words(dst, src)
        assert np.array_equal(dst.numpy().view(np.uint64), words[100:900])


def test_expand_codes_rejects_what_the_kernel_does_not_take():
    buf = torch.zeros((32, 16), dtype=torch.int8)
    words = torch.zeros(8, dtype=torch.int64)
    tscan.expand_codes(buf, words, 8, 24)  # the last 8 columns
    for bad_buf, bad_words, start, L in (
            (buf.to(torch.int32), words, 0, 23),           # not int8
            (buf[:31], words, 0, 23),                      # not 32 rows
            (buf.t().contiguous().t(), words, 0, 23),      # rows not contiguous
            (buf, words.to(torch.int32), 0, 23),           # not int64
            (buf, words[::2], 0, 23),                      # words not contiguous
            (buf, words, 9, 23),                           # past the buffer
            (buf, words, -1, 23),
            (buf, words, 0, 0),                            # L out of 1..24
            (buf, words, 0, 25)):
        with pytest.raises(ValueError):
            tscan.expand_codes(bad_buf, bad_words, start, L)


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_resident_streaming_and_sharded_cpu_builds_equal_plane_codes(stream_dbs, pack):
    """The three builds share one path: the resident planes, every streamed
    slab (PAD_CODE past its targets) and every shard's planes equal
    plane_codes' columns, with counts in the words."""
    from flashfry_tpu_torch.parallel.mesh import ShardedScanner, make_mesh
    db = with_counts(stream_dbs[pack.name][0], 11)
    L, n = db.pack.total_scan_length, db.num_targets
    want = plane_codes(db.targets, L)
    assert np.array_equal(DeviceScanner(db, "cpu").codes.numpy(), want)
    scanner = streaming(db, TWO_GRANULES)
    slabs = 0
    for t_lo, codes, n_valid in scanner.stream_slabs():
        assert np.array_equal(codes[:, :n_valid].numpy(), want[:, t_lo:t_lo + n_valid])
        assert (codes[:, n_valid:] == PAD_CODE).all()
        slabs += 1
    assert slabs == scanner.slabs >= 3
    sharded = ShardedScanner(db, mesh=make_mesh(["cpu"] * 6))
    for (s, _q), planes in sharded.planes.items():
        lo, nv = s * sharded.shard_n, sharded.shard_valid(s)
        assert np.array_equal(planes[:, :nv].numpy(), want[:, lo:lo + nv])
        assert (planes[:, nv:] == PAD_CODE).all()
    assert sum(sharded.shard_valid(s) for s in range(sharded.D)) == n


def test_plane_build_counts_on_the_cpu(stream_dbs):
    """8 bytes a target go up, resident or streamed, and the CPU launches
    no kernel and times nothing on a card: plane_build.kernel_slabs and
    plane_build.card_us are absent."""
    db = stream_dbs[Cas9NGGParameterPack.name][0]
    with trace.recording() as rec:
        DeviceScanner(db, "cpu")
    assert rec.counts == {"plane_build.h2d_bytes": 8 * db.num_targets}
    with trace.recording() as rec:
        for _ in streaming(db, TWO_GRANULES).stream_slabs():
            pass
    assert rec.counts == {"plane_build.h2d_bytes": 8 * db.num_targets}


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_fill_planes_overwrites_every_byte_of_a_sentinel_buffer(stream_dbs, pack,
                                                                monkeypatch):
    """The one plane build, handed a buffer of 9s, in pieces of 1,000
    targets through two staging buffers that take turns: every real column
    equals plane_codes (rows >= L zero) and every later column is PAD_CODE,
    so nothing of the buffer's old bytes is left."""
    monkeypatch.setattr(tscan, "SLAB", 1000)
    db = with_counts(stream_dbs[pack.name][0], 9)
    L, n = db.pack.total_scan_length, db.num_targets
    assert n > 3 * 1000
    buf = torch.full((32, n + 37), 9, dtype=torch.int8)
    tscan.fill_planes(buf, db.targets, L, tscan.WordStaging(1000, torch.device("cpu")))
    assert np.array_equal(buf[:, :n].numpy(), plane_codes(db.targets, L))
    assert (buf[:, n:] == PAD_CODE).all()


def test_fill_planes_refuses_a_buffer_narrower_than_its_targets():
    targets = counted_words(np.random.default_rng(4), 100, 23)
    buf = torch.full((32, 99), 9, dtype=torch.int8)
    with pytest.raises(ValueError):
        tscan.fill_planes(buf, targets, 23, tscan.WordStaging(100, torch.device("cpu")))
    assert (buf == 9).all()  # refused before any piece is written


def expand_model(words, n, L, stride, start, addr):
    """A numpy model of csrc/planes.cu's expand_kernel: its blocks, threads,
    shared-memory words and the two store kinds of phase 2, over a buffer
    whose first byte lies at device address `addr` (only addr % 4 matters).
    Returns the (32, stride) bytes written (-1 where none) and how many
    times each byte was written."""
    threads, run = 256, 4
    tile = threads * run
    out = np.full(32 * stride, -1, dtype=np.int16)
    hits = np.zeros(32 * stride, dtype=np.int64)
    w = words.view(np.uint64)
    tid = np.arange(threads)
    for t0 in range(0, n, tile):
        length = min(tile, n - t0)
        c = tid[:, None] * run + np.arange(run)[None, :]               # (256, 4)
        wk = np.where(c < length, w[np.minimum(t0 + c, n - 1)], 0).astype(np.uint64)
        packed = np.zeros((24, threads + 1), dtype=np.uint64)
        for i in range(L):
            codes = (wk >> np.uint64(2 * (L - 1 - i))) & np.uint64(3)
            packed[i, :threads] = (codes << (np.uint64(8) * np.arange(run, dtype=np.uint64))
                                   ).sum(axis=1)
        for r in range(32):
            row = r * stride + start + t0                # byte offset of the row
            a = (4 - (addr + row) % 4) % 4
            head = min(a, length)
            body = (length - a) & ~3 if length > a else 0
            j = a + 4 * tid
            full = j + 4 <= a + body
            if r < L:
                pair = packed[r, tid] | (packed[r, tid + 1] << np.uint64(32))
                v = (pair >> np.uint64(8 * a)) & np.uint64(0xFFFFFFFF)
            else:
                v = np.zeros(threads, dtype=np.uint64)
            for m in np.nonzero(full)[0]:
                assert (addr + row + j[m]) % 4 == 0  # an aligned 4-byte store
                for k in range(4):
                    out[row + j[m] + k] = int(v[m] >> np.uint64(8 * k)) & 0xFF
                    hits[row + j[m] + k] += 1
            for t in range(8):
                b = t if t < head else (a + body + t - 4 if 4 <= t < 8 else -1)
                if t >= head and not (4 <= t < 8 and a + body + t - 4 < length):
                    continue
                val = int(packed[r, b >> 2] >> np.uint64(8 * (b & 3))) & 3 if r < L else 0
                out[row + b] = val
                hits[row + b] += 1
    return out.reshape(32, stride), hits.reshape(32, stride)


@pytest.mark.parametrize("stride,start,n,addr", [
    (4096, 0, 4096, 0),          # aligned rows, whole tiles
    (3001, 0, 3001, 0),          # odd width: each row at another alignment
    (2053, 7, 2040, 1),          # odd start and a misaligned buffer
    (1030, 2, 1027, 3),          # one whole tile and a 3-target tail
    (6, 1, 5, 2),                # fewer targets than one word's head
    (1, 0, 1, 0)])
def test_expand_kernel_model_writes_each_column_once(stride, start, n, addr):
    """Every byte of columns [start, start + n) of all 32 rows is written
    exactly once, with plane_codes' code (0 on rows >= L), every word store
    is aligned, and no byte outside those columns is touched."""
    rng = np.random.default_rng(stride + start)
    for L in (20, 23, 24):
        words = counted_words(rng, n, L)
        out, hits = expand_model(words.view(np.int64), n, L, stride, start, addr)
        cols = slice(start, start + n)
        assert (hits[:, cols] == 1).all()
        assert (np.delete(hits, np.arange(start, start + n), axis=1) == 0).all()
        assert np.array_equal(out[:, cols], plane_codes(words, L).astype(np.int16))
