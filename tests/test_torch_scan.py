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
from flashfry_tpu_torch import cli
from flashfry_tpu_torch import engine as port_engine
from flashfry_tpu_torch.ops.scan import DeviceScanner, planes_from_jax


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


def test_device_plane_codes_matches_host_and_jax():
    rng = np.random.default_rng(3)
    for n, n_pad, slab in ((1000, 1 << 12, 1 << 10), (0, 1 << 10, 1 << 10),
                           (1 << 12, 1 << 12, 1 << 12), (3000, 4096, 1 << 12)):
        targets = rng.integers(0, 1 << 46, size=n, dtype=np.uint64)
        want = plane_codes(targets, 23, n_pad)
        # the port's slabs need not divide n_pad (JAX's must)
        got = tscan.device_plane_codes(targets, 23, n_pad, "cpu", slab=slab // 4 + 7)
        assert got.dtype == torch.int8 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(
            got.numpy(), np.asarray(device_plane_codes(targets, 23, n_pad, slab)))
        assert (got.numpy()[:, n:] == PAD_CODE).all()


def test_planes_from_jax_carries_the_scanner_state_across():
    genome = random_genome(40000, seed=31)
    db = build_db(genome, Cas9NGGParameterPack)
    guides = np.asarray(find_target_sites(iter([("g", genome[900:1500])]),
                                          Cas9NGGParameterPack).sequences)
    jax_scanner = JaxScanner(db, use_pallas=False, chunk=1 << 12)
    planes = np.asarray(jax_scanner.codes)
    assert planes.shape[1] > db.num_targets  # JAX pads to its chunk
    port = DeviceScanner.from_planes(db, planes, "cpu")
    assert np.array_equal(port.codes.numpy(), planes)
    got = by_guide(port.scan(guides, 4))
    assert got == by_guide(jax_scanner.scan(guides, 4)) == oracle(db, guides, 4)


def test_planes_are_validated():
    good = plane_codes(np.arange(5, dtype=np.uint64), 23, 16)
    with pytest.raises(ValueError):
        planes_from_jax(good.astype(np.int32), "cpu")
    with pytest.raises(ValueError):
        planes_from_jax(good[:31], "cpu")
    gap = good.copy()
    gap[:, 2] = PAD_CODE          # padding before a real column
    with pytest.raises(ValueError):
        planes_from_jax(gap, "cpu")
    bad = good.copy()
    bad[0, 1] = 5
    with pytest.raises(ValueError):
        planes_from_jax(bad, "cpu")

    db = build_db(random_genome(3000, seed=2), Cas9NGGParameterPack)
    n = db.num_targets
    planes = torch.from_numpy(plane_codes(db.targets, 23, n + 8))
    DeviceScanner.from_planes(db, planes, "cpu")
    with pytest.raises(ValueError):
        DeviceScanner.from_planes(db, planes[:, :n - 1].contiguous(), "cpu")
    dirty = planes.clone()
    dirty[0, n] = 0               # a non-PAD column past the database
    with pytest.raises(ValueError):
        DeviceScanner.from_planes(db, dirty, "cpu")


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
