"""flashfry_tpu_torch.parallel.mesh (ShardedScanner) against flashfry_tpu.

On virtual CPU meshes of 1, 2, 4 and 8 devices the port's sharded scan must
give flashfry_tpu's ShardedScanner's hits and the numpy oracle's, and, per
guide, the same ordered (target, mm) list as the port's one-device
DeviceScanner: hits in global target order across shard boundaries, the
order the overflow cap needs. The guides include a repeat family whose
members sit on both sides of the shard boundaries. ScanStats equal JAX's;
stage 1 is launched on every shard before any shard's hits are read; and
discover with a ShardedScanner writes flashfry_tpu's numpy CLI bytes.
"""

import filecmp

import numpy as np
import pytest
import torch

import bench
from flashfry_tpu import cli as jax_cli
from flashfry_tpu.database import build_database_from_sites, save_database
from flashfry_tpu.discovery import find_target_sites
from flashfry_tpu.engine import ScanStats as JaxStats
from flashfry_tpu.parallel.mesh import ShardedScanner as JaxSharded
from flashfry_tpu.parallel.mesh import make_mesh as jax_mesh
from flashfry_tpu.standards import Cas9NGGParameterPack, Cpf1ParameterPack
from flashfry_tpu_torch import cli, engine
from flashfry_tpu_torch.engine import ScanStats, discover
from flashfry_tpu_torch.ops import scan as scan_ops
from flashfry_tpu_torch.ops.scan import DeviceScanner
from flashfry_tpu_torch.parallel import mesh
from flashfry_tpu_torch.parallel.mesh import ShardedScanner, make_mesh, pick_devices

PACKS = [Cas9NGGParameterPack, Cpf1ParameterPack]


def family_genome(seed, n=120_000, copies=60, rate=0.03):
    """A random genome with one 300 bp unit planted `copies` times, each
    copy mutated at `rate` per base: the family's targets differ in their
    bin prefixes too, so they spread over the whole target order."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=n, dtype=np.int8)
    unit = rng.integers(0, 4, size=300, dtype=np.int8)
    for p in rng.integers(0, n - 300, size=copies).tolist():
        c = unit.copy()
        flip = rng.random(300) < rate
        c[flip] = (c[flip] + rng.integers(1, 4, size=int(flip.sum()))) % 4
        g[p:p + 300] = c
    to_str = lambda a: np.frombuffer(b"ACGT", dtype=np.uint8)[a].tobytes().decode()
    return to_str(g), to_str(unit)


def ceil_div(a, b):
    return -(-a // b)


def build_db(seq, pack):
    return build_database_from_sites(find_target_sites(iter([("chrT", seq)]), pack), 7)


def by_guide(scan_iter):
    got = {}
    for t_idx, g_idx, mm in scan_iter:
        assert t_idx.dtype == np.int64 and g_idx.dtype == np.int64 and mm.dtype == np.int8
        for t, g, m in zip(t_idx.tolist(), g_idx.tolist(), mm.tolist()):
            got.setdefault(g, []).append((t, m))
    return got


def oracle(db, guide_longs, max_mm):
    mm = db.bit_encoding().mismatches_cross(
        np.asarray(guide_longs, dtype=np.uint64), db.targets)
    return {g: [(int(t), int(mm[g, t])) for t in np.nonzero(mm[g] <= max_mm)[0]]
            for g in range(mm.shape[0]) if (mm[g] <= max_mm).any()}


@pytest.fixture(scope="module", params=PACKS, ids=lambda p: p.name)
def family(request):
    """(db, guides): the family's own sites, the targets on both sides of
    every shard boundary of 1..8 shards (the port's and JAX's), and 20
    random targets."""
    pack = request.param
    genome, unit = family_genome(seed=11)
    db = build_db(genome, pack)
    n = db.num_targets
    edges = set()
    for d in range(1, 9):
        port = ceil_div(n, d)
        for width in (port, ceil_div(port, 1 << 12) << 12):  # JAX pads to its chunk
            edges.update(b + k for b in range(width, n, width) for k in (-1, 0))
    picks = sorted(e for e in edges if 0 <= e < n)
    rng = np.random.default_rng(7)
    guides = np.concatenate([
        np.asarray(find_target_sites(iter([("u", unit)]), pack).sequences),
        db.targets[picks], db.targets[rng.choice(n, size=20, replace=False)]])
    return db, guides


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_sharded_scanner_matches_jax_oracle_and_device_scanner(family, n_devices):
    db, guides = family
    s_port, s_jax = ScanStats(), JaxStats()
    scanner = ShardedScanner(db, mesh=make_mesh(["cpu"] * n_devices))
    gx = 2 if n_devices % 2 == 0 else 1
    assert (scanner.D, scanner.Gx) == (n_devices // gx, gx)
    assert scanner.shard_n == ceil_div(db.num_targets, scanner.D)
    got = by_guide(scanner.scan(guides, 4, stats=s_port))
    want = oracle(db, guides, 4)
    jax_scanner = JaxSharded(db, mesh=jax_mesh(n_devices), use_pallas=False, chunk=1 << 12)
    assert got == want == by_guide(jax_scanner.scan(guides, 4, stats=s_jax))
    assert got == by_guide(DeviceScanner(db, "cpu").scan(guides, 4))
    assert (s_port.all_targets, s_port.all_targets_and_positions,
            s_port.dense_comparisons) == (s_jax.all_targets,
                                          s_jax.all_targets_and_positions,
                                          s_jax.dense_comparisons) != (0, 0, 0)
    if scanner.D > 1:  # some guide's hits cross a shard boundary, in order
        spans = [len({t // scanner.shard_n for t, _ in hits}) for hits in got.values()]
        assert max(spans) > 1


def test_several_guide_blocks_with_two_guide_sub_blocks():
    """5000 guides: two 4096-row blocks (two 2048-row sub-blocks each) on
    4 x 2 devices, with stats per block, against JAX and the oracle (whose
    per-guide lists are in target order, as the one-device scan's are)."""
    genome, _unit = family_genome(seed=13, n=30_000)
    db = build_db(genome, Cas9NGGParameterPack)
    rng = np.random.default_rng(5)
    guides = db.targets[rng.choice(db.num_targets, size=5000, replace=True)]
    s_port, s_jax = ScanStats(), JaxStats()
    got = by_guide(ShardedScanner(db, mesh=make_mesh(["cpu"] * 8)).scan(guides, 4, stats=s_port))
    jax_got = by_guide(JaxSharded(db, mesh=jax_mesh(8), use_pallas=False,
                                  chunk=1 << 12).scan(guides, 4, stats=s_jax))
    assert got == oracle(db, guides, 4) == jax_got
    assert s_port.dense_comparisons == s_jax.dense_comparisons == 5000 * db.num_targets
    assert s_port.all_targets == s_jax.all_targets == 2 * db.num_targets


@pytest.mark.parametrize("over", [0, 1], ids=["mm=active", "mm=active+1"])
@pytest.mark.parametrize("pack", PACKS, ids=lambda p: p.name)
def test_max_mismatch_at_or_beyond_active_positions_matches_the_oracle(pack, over):
    """Every real target of every shard is a hit, stage 1 is skipped, and the
    shard with fewer targets than shard_n yields only its real ones. Held to
    the numpy oracle only: flashfry_tpu's device scan drops targets that
    match a guide at no active position here."""
    genome, _unit = family_genome(seed=17, n=4000, copies=4)
    db = build_db(genome, pack)
    guides = db.targets[[0, db.num_targets // 2]]
    mm = len(pack.comparison_mask_positions()) + over
    scanner = ShardedScanner(db, mesh=make_mesh(["cpu"] * 6))
    assert db.num_targets % scanner.shard_n  # a short last shard
    got = by_guide(scanner.scan(guides, mm))
    assert got == oracle(db, guides, mm)
    assert [len(v) for v in got.values()] == [db.num_targets] * 2


def test_sharded_planes_equal_the_jax_sharded_scanners_codes():
    """Shard by shard, the port's planes on ["cpu"] * 4 (2 x 2) hold the JAX
    sharded scanner's columns of the shard's global targets, PAD_CODE past
    them; each (s, q) holds its own copy. The shards differ in width (the
    JAX scanner pads each to its chunk), so the test slices by target."""
    genome, _unit = family_genome(seed=19, n=50_000)
    db = build_db(genome, Cas9NGGParameterPack)
    n = db.num_targets
    jax_scanner = JaxSharded(db, mesh=jax_mesh(4), use_pallas=False, chunk=1 << 12)
    codes = np.asarray(jax_scanner.codes)
    assert codes.shape[1] == jax_scanner.D * jax_scanner.shard_n > n
    assert (codes[:, n:] == scan_ops.PAD_CODE).all()
    own = ShardedScanner(db, ["cpu"] * 4)
    assert (own.D, own.Gx) == (jax_scanner.D, 2)
    assert n % own.shard_n  # a short last shard
    for s in range(own.D):
        lo, nv = s * own.shard_n, own.shard_valid(s)
        for q in range(own.Gx):
            p = own.planes[s, q].numpy()
            assert p.shape == (32, own.shard_n)
            assert np.array_equal(p[:, :nv], codes[:, lo:lo + nv])
            assert (p[:, nv:] == scan_ops.PAD_CODE).all()
        assert own.planes[s, 0].data_ptr() != own.planes[s, 1].data_ptr()  # one each


def test_stage1_runs_on_every_shard_before_any_hits_are_read(monkeypatch):
    """Three 256-row guide blocks (MAX_GUIDE_ROWS cut to 128) on 4 x 2
    devices: per block, stage 1 on all eight (s, q), then their hits."""
    genome, _unit = family_genome(seed=23, n=30_000)
    db = build_db(genome, Cas9NGGParameterPack)
    rng = np.random.default_rng(3)
    guides = db.targets[rng.choice(db.num_targets, size=600, replace=True)]
    monkeypatch.setattr(scan_ops, "MAX_GUIDE_ROWS", 128)
    scanner = ShardedScanner(db, mesh=make_mesh(["cpu"] * 8))
    events = []
    launch, collect = mesh.launch_block, mesh.collect_block

    def launch_block(codes, *a, **k):
        events.append(("launch", id(codes)))
        return launch(codes, *a, **k)

    def collect_block(codes, *a, **k):
        events.append(("collect", id(codes)))  # on the first batch asked for
        yield from collect(codes, *a, **k)

    monkeypatch.setattr(mesh, "launch_block", launch_block)
    monkeypatch.setattr(mesh, "collect_block", collect_block)
    got = by_guide(scanner.scan(guides, 4))
    assert got == oracle(db, guides, 4)
    order = [id(scanner.planes[s, q]) for s in range(4) for q in range(2)]
    # every (s, q) launched, then collected, s and q ascending
    per_block = [("launch", c) for c in order] + [("collect", c) for c in order]
    assert events == per_block * 3


def test_discover_with_a_sharded_scanner_writes_the_numpy_cli_bytes(tmp_path):
    codes = bench.synthesize_genome(2, np.random.default_rng(2024))
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes()
    db = build_database_from_sites(
        find_target_sites(iter([("chrS", genome)]), Cas9NGGParameterPack), 7)
    db_path = str(tmp_path / "db")
    save_database(db, db_path)
    seqs, _ = db.bit_encoding().decode_batch(
        bench.sample_guides(db, 60, np.random.default_rng(3)))
    fasta = tmp_path / "g.fa"
    fasta.write_text("".join(">g%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))
    sites = cli.find_target_sites(cli.iterate_fasta(str(fasta)), db.pack,
                                  flanking_sequence=6, capture_context=True)
    port_db = cli.load_database(db_path)
    scanner = ShardedScanner(port_db, mesh=make_mesh(["cpu"] * 4))
    guides = discover(port_db, sites, max_mismatch=4, device="cpu", scanner=scanner)
    mine, ref = str(tmp_path / "sharded.out"), str(tmp_path / "numpy.out")
    cli.write_output(mine, guides, port_db.bit_encoding(), port_db.bit_position(),
                     models=(), write_ots=True, write_positions=True)
    assert jax_cli.main(["discover", "--fasta", str(fasta), "--database", db_path,
                         "--positionOutput", "--maxMismatch", "4", "--output", ref,
                         "--backend", "numpy"]) == 0
    assert any(g.full for g in guides), "no guide passed the 2000 cap"
    assert filecmp.cmp(mine, ref, shallow=False)


def test_discover_refuses_a_sharded_scanner_of_another_database_or_device_type():
    genome, _unit = family_genome(seed=29, n=20_000)
    db = build_db(genome, Cas9NGGParameterPack)
    other = build_db(family_genome(seed=31, n=20_000)[0], Cas9NGGParameterPack)
    sites = find_target_sites(iter([("g", genome[100:400])]), Cas9NGGParameterPack)
    with pytest.raises(ValueError, match="different database"):
        discover(db, sites, device="cpu",
                 scanner=ShardedScanner(other, mesh=make_mesh(["cpu"] * 2)))
    elsewhere = ShardedScanner(db, mesh=make_mesh(["cpu"] * 2))
    elsewhere.device_type = "cuda"
    with pytest.raises(ValueError, match="sharded scanner lives on cuda"):
        discover(db, sites, device="cpu", scanner=elsewhere)
    discover(db, sites, device="cpu", scanner=ShardedScanner(db, mesh=make_mesh(["cpu"] * 2)))


def test_default_scanner_shards_a_bare_cuda_over_several_cards(monkeypatch):
    """discover's own choice: a ShardedScanner over every card for "cuda"
    with more than one card, a DeviceScanner for one card or "cuda:N"
    (the cards are stood in for by the CPU here)."""
    db = build_db(family_genome(seed=37, n=20_000)[0], Cas9NGGParameterPack)
    built = []
    monkeypatch.setattr(engine, "DeviceScanner", lambda db, dev: built.append(dev))
    monkeypatch.setattr(engine, "pick_devices", lambda d: ["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    sharded = engine.default_scanner(db, torch.device("cuda"))
    assert isinstance(sharded, ShardedScanner) and (sharded.D, sharded.Gx) == (2, 2)
    engine.default_scanner(db, torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    engine.default_scanner(db, torch.device("cuda"))
    assert built == [torch.device("cuda", 1), torch.device("cuda")]


def test_mesh_shapes_devices_and_the_memory_check(monkeypatch):
    shapes = {n: tuple(map(len, (make_mesh(["cpu"] * n), make_mesh(["cpu"] * n)[0])))
              for n in (1, 2, 3, 4, 8)}
    assert shapes == {1: (1, 1), 2: (1, 2), 3: (3, 1), 4: (2, 2), 8: (4, 2)}
    assert pick_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pick_devices("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        ShardedScanner(build_db("ACGT" * 10, Cas9NGGParameterPack))
    with pytest.raises(ValueError, match="names every device"):
        ShardedScanner(build_db("ACGT" * 10, Cas9NGGParameterPack),
                       mesh=((None,), (torch.device("cpu"),)))

    db = build_db(family_genome(seed=41, n=20_000)[0], Cas9NGGParameterPack)
    need = 32 * ceil_div(db.num_targets, 2)
    frees = iter([1 << 40, need])  # the second shard finds too little left
    monkeypatch.setattr(mesh, "device_free_bytes", lambda dev: next(frees))
    with pytest.raises(ValueError, match="shard 1's planes need %d bytes" % need):
        ShardedScanner(db, mesh=((torch.device("cpu"),),) * 2)
