"""flashfry_tpu_torch.engine and its discover CLI against flashfry_tpu.

The comparison counter must equal the host and JAX counters exactly, and
`python -m flashfry_tpu_torch discover --device cpu` must write the same
bytes as flashfry_tpu's CLI with the numpy and the jax backends.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from flashfry_tpu import cli as jax_cli
from flashfry_tpu.database import (build_database_from_sites, load_database,
                                   save_database)
from flashfry_tpu.discovery import find_target_sites
from flashfry_tpu.engine import ScanStats
from flashfry_tpu.engine import discover as host_discover
from flashfry_tpu.engine import pruned_comparisons
from flashfry_tpu.engine import pruned_comparisons_device as jax_counter
from flashfry_tpu.standards import Cas9NGGParameterPack, Cpf1ParameterPack
from flashfry_tpu.utils import iterate_fasta
from flashfry_tpu_torch import cli
from flashfry_tpu_torch.engine import discover, pruned_comparisons_device
from flashfry_tpu_torch.ops.scan import DeviceScanner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_genome(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def build_db(seq, pack):
    return build_database_from_sites(find_target_sites(iter([("chrT", seq)]), pack), 7)


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack],
                         ids=lambda p: p.name)
def test_pruned_comparisons_device_equals_host_and_jax(pack):
    genome = random_genome(40000, seed=101)
    db = build_db(genome, pack)
    guides = np.asarray(find_target_sites(iter([("g", genome[700:1900])]),
                                          pack).sequences)
    assert guides.shape[0] > 32  # several guide chunks, one ragged
    for mm in (3, 4, 5):
        want = pruned_comparisons(db, guides, mm)
        got = pruned_comparisons_device(db, guides, mm, "cpu", guide_chunk=16)
        assert got == want == jax_counter(db, guides, mm, guide_chunk=16) > 0


@pytest.fixture(scope="module")
def repeat_db(tmp_path_factory):
    """2 Mbp repeat-rich genome (bench.synthesize_genome): high-copy
    families push some guides past the 2000-position overflow cap."""
    d = tmp_path_factory.mktemp("torch_engine")
    codes = bench.synthesize_genome(2, np.random.default_rng(2024))
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes()
    db = build_database_from_sites(
        find_target_sites(iter([("chrS", genome)]), Cas9NGGParameterPack), 7)
    db_path = str(d / "db.npz")
    save_database(db, db_path)
    longs = bench.sample_guides(db, 60, np.random.default_rng(3))
    seqs, _ = db.bit_encoding().decode_batch(longs)
    fasta = str(d / "guides.fa")
    with open(fasta, "w") as fh:
        fh.write("".join(">g%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))
    return d, db_path, fasta


@pytest.mark.parametrize("extra", [
    ("--maxMismatch", "3"),
    ("--maxMismatch", "4"),
    ("--maxMismatch", "5"),
    ("--maxMismatch", "4", "--forceLinear"),
], ids=["mm3", "mm4", "mm5", "mm4-forceLinear"])
def test_discover_cli_byte_identical_to_numpy_and_jax(repeat_db, extra):
    d, db_path, fasta = repeat_db
    tag = "_".join(extra).replace("-", "")
    base = ["discover", "--fasta", fasta, "--database", db_path,
            "--positionOutput", *extra]
    mine, ref_np, ref_jax = (str(d / (tag + s)) for s in (".torch", ".numpy", ".jax"))
    report = cli.run(base + ["--output", mine, "--device", "cpu"])
    assert jax_cli.main(base + ["--output", ref_np, "--backend", "numpy"]) == 0
    assert filecmp.cmp(mine, ref_np, shallow=False)
    assert report["overflowed_guides"] > 0, "no guide passed the 2000 cap"
    if extra == ("--maxMismatch", "4"):
        # numpy == jax at every mm is tests/test_scan_jax.py's job; one jax
        # run (one CPU compile) ties the port to the jax backend too
        assert jax_cli.main(base + ["--output", ref_jax, "--backend", "jax"]) == 0
        assert filecmp.cmp(mine, ref_jax, shallow=False)


def test_python_m_discover_device_cpu(repeat_db):
    d, db_path, fasta = repeat_db
    base = ["discover", "--fasta", fasta, "--database", db_path,
            "--positionOutput", "--maxMismatch", "4"]
    mine, ref = str(d / "m.torch"), str(d / "m.numpy")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-m", "flashfry_tpu_torch", *base,
                    "--output", mine, "--device", "cpu"],
                   check=True, env=env, cwd=ROOT, capture_output=True)
    assert jax_cli.main(base + ["--output", ref, "--backend", "numpy"]) == 0
    assert filecmp.cmp(mine, ref, shallow=False)


def test_discover_stats_and_guides_equal_host(repeat_db):
    _d, db_path, fasta = repeat_db
    db = load_database(db_path)
    sites = find_target_sites(iterate_fasta(fasta), db.pack,
                              flanking_sequence=6, capture_context=True)
    s_port, s_host = ScanStats(), ScanStats()
    a = discover(db, sites, max_mismatch=4, stats=s_port, device="cpu")
    b = host_discover(db, sites, max_mismatch=4, backend="numpy", stats=s_host)
    assert s_port.all_comparisons == s_host.all_comparisons > 0
    assert [g.full for g in a] == [g.full for g in b]
    assert [[ot.sequence for ot in g.off_targets] for g in a] == \
        [[ot.sequence for ot in g.off_targets] for g in b]


@pytest.mark.parametrize("over", [0, 1], ids=["mm=active", "mm=active+1"])
@pytest.mark.parametrize("enzyme", ["spcas9ngg", "cpf1"])
def test_discover_at_max_mismatch_beyond_active_positions(tmp_path, enzyme, over):
    """With --maxMismatch >= the active positions every target is an
    off-target of every guide, even one that matches the guide at no active
    position (planted here): the torch backend, which cannot pass such a
    target through stage 1, must still report it, as both numpy backends
    do. One guide, so no other guide of its block lets the target through."""
    pack = Cas9NGGParameterPack if enzyme == "spcas9ngg" else Cpf1ParameterPack
    active = pack.comparison_mask_positions()
    guide = np.asarray(list(random_genome(pack.total_scan_length, seed=60)))
    if pack.five_prime_pam:
        guide[:4] = list("TTTA")
    else:
        guide[-3:] = list("AGG")
    anti = guide.copy()  # a different base at every active position
    anti[list(active)] = ["ACGT"[("ACGT".index(b) + 1) % 4] for b in guide[list(active)]]
    genome = "".join([random_genome(6000, seed=61), "".join(guide), "TTTT",
                      "".join(anti), random_genome(100, seed=62)])
    fa, guides_fa = tmp_path / "genome.fa", tmp_path / "guide.fa"
    fa.write_text(">chrT\n%s\n" % genome)
    guides_fa.write_text(">g\n%s\n" % "".join(guide))
    db_path = str(tmp_path / "db")
    cli.run(["index", "--reference", str(fa), "--database", db_path,
             "--enzyme", enzyme])
    db = cli.load_database(db_path)
    n_act = len(active)
    mm = db.bit_encoding().mismatches_cross(db.targets, np.asarray(
        find_target_sites(iter([("g", "".join(guide))]), pack).sequences))
    assert mm.shape[1] == 1 and (mm[:, 0] == n_act).sum() >= 1  # anti's target
    base = ["discover", "--fasta", str(guides_fa), "--database", db_path,
            "--positionOutput", "--maxMismatch", str(n_act + over),
            "--maximumOffTargets", "1000000"]
    outs = [str(tmp_path / s) for s in ("torch", "port_numpy", "numpy")]
    report = cli.run(base + ["--output", outs[0], "--device", "cpu"])
    cli.run(base + ["--output", outs[1], "--backend", "numpy"])
    assert jax_cli.main(base + ["--output", outs[2], "--backend", "numpy"]) == 0
    assert report["guides"] == 1 and report["overflowed_guides"] == 0
    assert filecmp.cmp(outs[1], outs[2], shallow=False)
    assert filecmp.cmp(outs[0], outs[2], shallow=False)


def test_scanner_from_another_database_raises_value_error():
    genome = random_genome(20000, seed=8)
    db = build_db(genome, Cas9NGGParameterPack)
    other = build_db(random_genome(20000, seed=9), Cas9NGGParameterPack)
    sites = find_target_sites(iter([("g", genome[100:400])]), Cas9NGGParameterPack)
    with pytest.raises(ValueError, match="different database"):
        discover(db, sites, device="cpu", scanner=DeviceScanner(other, "cpu"))
    discover(db, sites, device="cpu", scanner=DeviceScanner(db, "cpu"))


def test_device_cuda_without_cuda_exits_with_a_message(repeat_db, monkeypatch):
    _d, db_path, fasta = repeat_db
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["discover", "--fasta", fasta, "--database", db_path,
                  "--output", os.devnull, "--device", "cuda"])
    assert e.value.code != 0 and "is_available() is false" in str(e.value.code)


def test_multi_process_flags_are_rejected(repeat_db):
    """--coordinator with --backend numpy, or without --numProcesses, stops
    with flashfry_tpu's message (its CLI raises SystemExit and
    AssertionError), before any process group is joined; so do
    --numProcesses and --processId without --coordinator."""
    _d, db_path, fasta = repeat_db
    base = ["discover", "--fasta", fasta, "--database", db_path,
            "--output", os.devnull, "--coordinator", "localhost:1"]
    for extra in (["--numProcesses", "2", "--processId", "0", "--backend", "numpy"],
                  ["--processId", "0"]):
        with pytest.raises((SystemExit, AssertionError)) as want:
            jax_cli.main(base + extra)
        with pytest.raises(SystemExit) as got:
            cli.main(base + extra + ["--device", "cpu"])
        assert str(got.value) == str(want.value) and "--coordinator" in str(got.value)
    for extra in (["--numProcesses", "2"], ["--processId", "0"]):
        with pytest.raises(SystemExit, match="require --coordinator"):
            cli.main(base[:-2] + extra + ["--device", "cpu"])
