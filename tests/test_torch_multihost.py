"""flashfry_tpu_torch.parallel.multihost: discover over several processes.

Two gloo processes on the CPU must each yield the numpy oracle's hits, in
global target order per guide, whether each holds one shard or a 2 x 2
grid of them over several guide blocks; the gathered-bytes counters keep
flashfry_tpu's meaning (every byte gathered, this process's share
included). `python -m flashfry_tpu_torch discover --coordinator ...` run
once per process, on two or four processes, writes, on process 0 only,
flashfry_tpu's numpy CLI bytes.
"""

import filecmp
import json
import os
import re
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import bench
from flashfry_tpu import cli as jax_cli
from flashfry_tpu.database import build_database_from_sites, save_database
from flashfry_tpu.discovery import find_target_sites
from flashfry_tpu.standards import Cas9NGGParameterPack
from flashfry_tpu_torch.ops.scan import DeviceScanner
from flashfry_tpu_torch.parallel import multihost
from flashfry_tpu_torch.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds a pair of processes may take


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(argv_of, processes=2) -> list:
    """Start argv_of(process_id, coordinator) for processes 0, 1, ..., wait
    for all (killing all past TIMEOUT), and return their stderr; all must
    exit 0."""
    coordinator = "localhost:%d" % free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, *argv_of(pid, coordinator)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for pid in range(processes)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [err for _out, err in outs]


def by_guide(t_idx, g_idx, mm):
    got = {}
    for t, g, m in zip(np.asarray(t_idx).tolist(), np.asarray(g_idx).tolist(),
                       np.asarray(mm).tolist()):
        got.setdefault(g, []).append((t, m))
    return got


def oracle(db, guide_longs, max_mm):
    mm = db.bit_encoding().mismatches_cross(
        np.asarray(guide_longs, dtype=np.uint64), db.targets)
    return {g: [(int(t), int(mm[g, t])) for t in np.nonzero(mm[g] <= max_mm)[0]]
            for g in range(mm.shape[0]) if (mm[g] <= max_mm).any()}


def write_guides(path, db, longs):
    seqs, _ = db.bit_encoding().decode_batch(np.asarray(longs, dtype=np.uint64))
    with open(path, "w") as fh:
        fh.write("".join(">g%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))


@pytest.fixture(scope="module")
def repeat_db(tmp_path_factory):
    """2 Mbp repeat-rich genome (bench.synthesize_genome) and 60
    position-sampled guides: some overflow the 2000-position cap, and the
    repeat families' hits lie in both processes' halves of the targets."""
    d = tmp_path_factory.mktemp("torch_multihost")
    codes = bench.synthesize_genome(2, np.random.default_rng(2024))
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes()
    db = build_database_from_sites(
        find_target_sites(iter([("chrS", genome)]), Cas9NGGParameterPack), 7)
    db_path = str(d / "db")
    save_database(db, db_path)
    longs = bench.sample_guides(db, 60, np.random.default_rng(3))
    np.savez(str(d / "guides.npz"), guides=longs)
    write_guides(str(d / "guides.fa"), db, longs)
    return d, db, longs


def test_two_worker_processes_give_the_oracles_hits(repeat_db):
    d, db, longs = repeat_db
    out = str(d / "hits.npz")
    errs = run_pair(lambda pid, coordinator: [
        "-m", "flashfry_tpu_torch.parallel.multihost", "--coordinator", coordinator,
        "--numProcesses", "2", "--processId", str(pid), "--database", str(d / "db"),
        "--guides", str(d / "guides.npz"), "--output", out, "--maxMismatch", "4",
        "--device", "cpu"])
    hits = np.load(out)["hits"]
    want = oracle(db, longs, 4)
    assert by_guide(*hits.T) == want
    shard_n = -(-db.num_targets // 2)
    spans = [len({t // shard_n for t, _ in v}) for v in want.values()]
    assert max(spans) == 2  # a guide's hits come from both processes, in order
    # one block: the two counts (8 bytes each), then both processes' hits
    # padded to the larger count (16 bytes each), every byte counted
    counts = [sum(1 for v in want.values() for t, _ in v if t // shard_n == p)
              for p in (0, 1)]
    line = "%d hit rows; gathered %d bytes in 2 calls" % (hits.shape[0],
                                                          2 * 8 + 2 * 16 * max(counts))
    assert all(line in err for err in errs), errs[0][-2000:]


CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    from flashfry_tpu_torch.database import load_database
    from flashfry_tpu_torch.parallel import multihost

    coordinator, pid, db_path, guides_path, out = sys.argv[1:]
    with multihost.process_group(coordinator, 2, int(pid)):
        mesh = multihost.make_global_mesh(["cpu"] * 4)
        scanner = multihost.MultiHostScanner(load_database(db_path), mesh=mesh)
        assert (scanner.D, scanner.Gx) == (4, 2), (scanner.D, scanner.Gx)
        assert scanner.rows == [2 * int(pid), 2 * int(pid) + 1], scanner.rows
        assert all(dev is None for s in range(4) if s not in scanner.rows
                   for dev in mesh[s])
        batches = list(scanner.scan(np.load(guides_path)["guides"], 4))
        np.savez(out, *[np.concatenate(a) for a in zip(*batches)],
                 counters=[scanner.dcn_allgather_bytes, scanner.dcn_allgather_calls])
""")


def test_two_processes_of_two_by_two_shards_over_several_guide_blocks(tmp_path):
    """Each process holds db rows 2p, 2p + 1 of a 4 x 2 mesh; 5000 guides
    make two 4096-row blocks, gathered block by block."""
    rng = np.random.default_rng(19)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=30_000)].tobytes()
    db = build_database_from_sites(
        find_target_sites(iter([("chrT", genome)]), Cas9NGGParameterPack), 7)
    save_database(db, str(tmp_path / "db"))
    longs = db.targets[rng.choice(db.num_targets, size=5000, replace=True)]
    np.savez(str(tmp_path / "guides.npz"), guides=longs)
    run_pair(lambda pid, coordinator: [
        "-c", CHILD, coordinator, str(pid), str(tmp_path / "db"),
        str(tmp_path / "guides.npz"), str(tmp_path / ("out%d.npz" % pid))])
    got = [np.load(str(tmp_path / ("out%d.npz" % pid))) for pid in (0, 1)]
    want = oracle(db, longs, 4)
    for g in got:
        assert by_guide(g["arr_0"], g["arr_1"], g["arr_2"]) == want
        assert g["counters"][1] == 4  # two gathers in each of two blocks
    assert all(np.array_equal(got[0][k], got[1][k]) for k in got[0].files)


@pytest.mark.parametrize("processes", [2, 4])
def test_discover_cli_on_several_processes_writes_the_numpy_cli_bytes(repeat_db, processes):
    d, _db, _longs = repeat_db
    base = ["discover", "--fasta", str(d / "guides.fa"), "--database", str(d / "db"),
            "--positionOutput", "--maxMismatch", "4"]
    outs = [str(d / ("mh%d_%d.out" % (processes, pid))) for pid in range(processes)]
    errs = run_pair(lambda pid, coordinator: [
        "-m", "flashfry_tpu_torch", *base, "--output", outs[pid], "--device", "cpu",
        "--coordinator", coordinator, "--numProcesses", str(processes),
        "--processId", str(pid)], processes)
    ref = str(d / "numpy.out")
    assert jax_cli.main(base + ["--output", ref, "--backend", "numpy"]) == 0
    assert filecmp.cmp(outs[0], ref, shallow=False)
    assert not any(os.path.exists(o) for o in outs[1:])
    reports = [json.loads(re.search(r"discover report: (\{.*\})", e).group(1)) for e in errs]
    for pid, r in enumerate(reports):
        assert (r["scan_mode"], r["shards"], r["process"]) == ("multihost", [processes, 1], pid)
        assert r["overflowed_guides"] > 0
        assert r["gathered_bytes"] == reports[0]["gathered_bytes"] > 0


def test_one_process_group_in_process(repeat_db):
    """A group of one: initialize is idempotent inside process_group, the
    global mesh is the local grid, MultiHostScanner gives DeviceScanner's
    hits in order with two counted gathers, a mesh that puts this process's
    rows elsewhere raises, and the group is gone on the way out."""
    _d, db, longs = repeat_db
    with multihost.process_group("localhost:%d" % free_port(), 1, 0):
        assert not multihost.initialize("localhost:1", 1, 0)
        mesh = multihost.make_global_mesh(["cpu"] * 4)
        assert mesh == make_mesh(["cpu"] * 4)
        scanner = multihost.MultiHostScanner(db, mesh=mesh)
        got = by_guide(*(np.concatenate(a) for a in zip(*scanner.scan(longs, 4))))
        assert got == by_guide(*(np.concatenate(a) for a in
                                 zip(*DeviceScanner(db, "cpu").scan(longs, 4))))
        n_hits = sum(map(len, got.values()))
        assert (scanner.dcn_allgather_bytes, scanner.dcn_allgather_calls) == \
            (8 + 16 * n_hits, 2)
        cpu = torch.device("cpu")
        with pytest.raises(ValueError, match="does not hold db rows"):
            multihost.MultiHostScanner(db, mesh=((None, None), (cpu, cpu)))
    assert not dist.is_initialized()
