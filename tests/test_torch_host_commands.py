"""The port's host-only commands and modules against flashfry_tpu's.

`python -m flashfry_tpu_torch random` and `extract` must write the same
bytes as `flashfry_tpu random` / `extract` on the same inputs and --seed,
and the port's refdict must read a sequence dictionary as flashfry_tpu's
does. The databases are synthetic: flashfry_tpu's own extract test reads a
fixture genome that this repository does not ship.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from flashfry_tpu import cli as jax_cli
from flashfry_tpu.database import build_database_from_sites, save_database
from flashfry_tpu.discovery import find_target_sites
from flashfry_tpu.refdict import ReferenceDictReader as JaxDictReader
from flashfry_tpu.standards import Cas9NGGParameterPack
from flashfry_tpu_torch import cli
from flashfry_tpu_torch.refdict import ReferenceDictReader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 20 guide bases of SpCas9-NGG: two memory slots and their complements
PATTERN_20 = ",".join(["N1", "N2"] + ["N"] * 16 + ["N2-", "N1-"])
# 4096 possible guides, so 300 draws repeat some
PATTERN_SMALL = ",".join(["A", "C", "G", "T"] * 3 + ["A", "C"] + ["N"] * 6)

RANDOM_CASES = {
    "cas9ngg": ["--enzyme", "spcas9ngg", "--randomCount", "200"],
    "cpf1": ["--enzyme", "cpf1", "--randomCount", "200"],
    "unidirectional": ["--enzyme", "spcas9ngg", "--randomCount", "200",
                       "--onlyUnidirectional"],
    "cpf1-unidirectional": ["--enzyme", "cpf1", "--randomCount", "100",
                            "--onlyUnidirectional"],
    "patterned": ["--enzyme", "spcas9ngg", "--randomCount", "150",
                  "--patterned", PATTERN_20],
    "context": ["--enzyme", "spcas9ngg", "--randomCount", "150",
                "--sequenceContextLeft", "5", "--sequenceContextRight", "7",
                "--namePrefix", "ctx"],
    "duplicates-allowed": ["--enzyme", "spcas9ngg", "--randomCount", "300",
                           "--patterned", PATTERN_SMALL, "--duplicatesAllowed"],
    "duplicates-refused": ["--enzyme", "spcas9ngg", "--randomCount", "300",
                           "--patterned", PATTERN_SMALL,
                           "--maxSuccessiveDesignFailures", "5"],
}


def same_bytes(a, b):
    return filecmp.cmp(str(a), str(b), shallow=False)


@pytest.mark.parametrize("seed", [1, 29])
@pytest.mark.parametrize("case", list(RANDOM_CASES))
def test_random_byte_identical_to_flashfry_tpu(tmp_path, case, seed):
    flags = RANDOM_CASES[case] + ["--seed", str(seed)]
    mine, ref = tmp_path / "port.fa", tmp_path / "jax.fa"
    cli.run(["random", "--outputFile", str(mine)] + flags)
    assert jax_cli.main(["random", "--outputFile", str(ref)] + flags) == 0
    assert same_bytes(mine, ref)
    names = open(mine).read().split("\n")[::2][:-1]
    assert names and all(n.startswith(">") for n in names)
    if case == "duplicates-allowed":
        seqs = open(mine).read().split("\n")[1::2]
        assert len(seqs) > len(set(seqs))


def test_python_m_random_and_extract(tmp_path, extract_db):
    env = dict(os.environ, PYTHONPATH=ROOT)
    for name, args in (
            ("random", ["--enzyme", "cpf1", "--randomCount", "50", "--seed", "8"]),
            ("extract", ["--binaryOTFile", extract_db, "--minInGenome", "2"])):
        mine, ref = tmp_path / (name + ".port"), tmp_path / (name + ".jax")
        subprocess.run([sys.executable, "-m", "flashfry_tpu_torch", name,
                        "--outputFile", str(mine)] + args,
                       check=True, env=env, cwd=ROOT, capture_output=True)
        assert jax_cli.main([name, "--outputFile", str(ref)] + args) == 0
        assert same_bytes(mine, ref) and os.path.getsize(mine) > 0


@pytest.fixture(scope="module")
def extract_db(tmp_path_factory):
    """A 40 kb random genome with a 200 bp unit planted 12 times, so some
    targets occur more than once."""
    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=40000)].copy()
    unit = bases[rng.integers(0, 4, size=200)]
    for p in rng.integers(0, 40000 - 200, size=12):
        genome[p:p + 200] = unit
    db = build_database_from_sites(
        find_target_sites(iter([("chrE", genome.tobytes().decode())]),
                          Cas9NGGParameterPack), 7)
    assert db.sequence_counts().max() > 1
    path = str(tmp_path_factory.mktemp("extract") / "db")
    save_database(db, path)
    return path


EXTRACT_CASES = {
    "all": [],
    "min-in-genome": ["--minInGenome", "2"],
    "max-in-genome": ["--maxInGenome", "1"],
    "min-and-max": ["--minInGenome", "2", "--maxInGenome", "5"],
    "subsample": ["--subsampleProportion", "0.3", "--seed", "4"],
    "subsample-min": ["--subsampleProportion", "0.5", "--seed", "11",
                      "--minInGenome", "2"],
}


@pytest.mark.parametrize("case", list(EXTRACT_CASES))
def test_extract_byte_identical_to_flashfry_tpu(tmp_path, extract_db, case):
    flags = EXTRACT_CASES[case]
    mine, ref = tmp_path / "port.fa", tmp_path / "jax.fa"
    cli.run(["extract", "--binaryOTFile", extract_db, "--outputFile", str(mine)]
            + flags)
    assert jax_cli.main(["extract", "--database", extract_db,
                         "--outputFile", str(ref)] + flags) == 0
    assert same_bytes(mine, ref) and os.path.getsize(mine) > 0


def test_reference_dict_reader_equals_flashfry_tpu(tmp_path):
    """tests/test_discovery.py's .dict text through both readers."""
    p = tmp_path / "ref.dict"
    p.write_text(
        "@HD\tVN:1.6\n"
        "@SQ\tSN:chr1\tLN:248956422\tM5:abc\n"
        "@SQ\tSN:chr2\tLN:242193529\n"
        "@PG\tID:x\n")
    mine, ref = ReferenceDictReader(str(p)), JaxDictReader(str(p))
    assert [(e.seq_name, e.length) for e in mine] == \
        [(e.seq_name, e.length) for e in ref] == \
        [("chr1", 248956422), ("chr2", 242193529)]
    bp, ref_bp = mine.generate_bit_position(), ref.generate_bit_position()
    assert bp.contig_names_in_order == ref_bp.contig_names_in_order == ["chr1", "chr2"]
    assert bp.contig_map == ref_bp.contig_map
