"""flashfry_tpu_torch's own host modules against the flashfry_tpu originals.

The port keeps a copy of every host module it needs (index, database,
site finding, bit coding, the numpy scan, hit collection, output
rendering, the native C++). Each copy must do exactly what its original
does: the same `index` content for all six enzymes in both on-disk formats,
databases that either package reads from the other's files, discover
output byte-identical to `python -m flashfry_tpu discover --backend numpy`
(the port's numpy and CPU torch backends, with and without the native
library), and equal bit coding. The database loader must also find numpy's
private header reader where numpy >= 2.1 keeps it.
"""

import filecmp
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from flashfry_tpu import cli as ref_cli
from flashfry_tpu import ffformat as ref_ffformat
from flashfry_tpu.bitcoding import BitEncoding as RefBitEncoding
from flashfry_tpu.database import load_database as ref_load
from flashfry_tpu.standards import name_to_parameter_pack as ref_pack
from flashfry_tpu_torch import cli, database, ffformat
from flashfry_tpu_torch.bitcoding import BitEncoding
from flashfry_tpu_torch.standards import name_to_parameter_pack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENZYMES = ("spcas9ngg", "spcas9", "spcas9nag", "spcas919", "spcas9ngg19", "cpf1")
DB_FIELDS = ("targets", "positions", "pos_offsets", "bin_start")


def write_fasta(path, records):
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(">%s\n" % name)
            fh.write("".join(seq[i:i + 80] + "\n" for i in range(0, len(seq), 80)))


def repeat_genome(n, seed):
    """Random bases with a 300 bp unit planted 40 times, half of the copies
    exact and half with a few substitutions, so guides from the unit have
    many off-targets and overflow a small cap. Returns the bases and the
    start of the last copy (which no later copy overwrites)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n)
    unit = rng.integers(0, 4, size=300)
    starts = rng.integers(0, n - 300, size=40)
    for j, p in enumerate(starts):
        copy = unit.copy()
        if j % 2:
            s = rng.integers(0, 300, size=4)
            copy[s] = (copy[s] + rng.integers(1, 4, size=4)) % 4
        codes[p:p + 300] = copy
    return "".join("ACGT"[c] for c in codes), int(starts[-1])


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_copies")
    seq, copy_at = repeat_genome(120_000, seed=17)
    fa = str(d / "genome.fa")
    write_fasta(fa, [("chrA", seq[:70_000]), ("chrB", seq[70_000:])])
    return d, fa, seq, copy_at


def assert_same_database(a, b):
    assert a.pack.name == b.pack.name and a.bin_width == b.bin_width
    assert list(a.contig_names) == list(b.contig_names)
    for f in DB_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("fmt", ["native", "flashfry"])
@pytest.mark.parametrize("enzyme", ENZYMES)
def test_index_content_equals_flashfry_tpu(genome, tmp_path, enzyme, fmt):
    """The two index CLIs write equal content (np.savez stamps each zip
    entry with its time, so the files are compared member by member), and
    each package's load_database reads both files to equal arrays."""
    _d, fa, _seq, _copy_at = genome
    mine, ref = str(tmp_path / "port.db"), str(tmp_path / "ref.db")
    args = ["index", "--reference", fa, "--enzyme", enzyme, "--format", fmt]
    cli.run(args + ["--database", mine])
    assert ref_cli.main(args + ["--database", ref]) == 0
    with open(mine + ".header") as a, open(ref + ".header") as b:
        assert a.read() == b.read()
    if fmt == "native":
        with np.load(mine) as a, np.load(ref) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    else:
        blocks = ffformat.bgzf_decompress_all(mine)
        assert len(blocks) > 0
        assert blocks == ref_ffformat.bgzf_decompress_all(ref)
        assert blocks == ffformat.bgzf_decompress_all(ref)
    want = ref_load(ref)
    assert want.num_targets > 100
    for loader in (database.load_database, ref_load):
        for path in (mine, ref):
            assert_same_database(loader(path), want)


@pytest.fixture(scope="module")
def discover_inputs(genome):
    """Each package's own index of the genome, and guides from a repeat
    copy and from plain sequence."""
    d, fa, seq, copy_at = genome
    mine, ref = str(d / "discover_port.db"), str(d / "discover_ref.db")
    args = ["index", "--reference", fa, "--enzyme", "spcas9ngg"]
    cli.run(args + ["--database", mine])
    assert ref_cli.main(args + ["--database", ref]) == 0
    guides = str(d / "guides.fa")
    write_fasta(guides, [("plain", seq[5_000:5_400]),
                         ("repeat", seq[copy_at:copy_at + 300]),
                         ("other", seq[90_000:90_300])])
    return d, mine, ref, guides, {}


CASES = {
    "mm3": ("--maxMismatch", "3"),
    "mm4": ("--maxMismatch", "4"),
    "maximumOffTargets1": ("--maxMismatch", "4", "--maximumOffTargets", "1"),
    "forceLinear": ("--maxMismatch", "4", "--forceLinear"),
    "no_native": ("--maxMismatch", "4"),
}


def run_cli(module, argv, no_native):
    """discover in process, or with FLASHFRY_TPU_NO_NATIVE=1 in a child
    (the native library, once loaded, stays loaded in this process)."""
    if not no_native:
        if module == "flashfry_tpu":
            assert ref_cli.main(argv) == 0
        else:
            cli.run(argv)
        return
    env = dict(os.environ, PYTHONPATH=ROOT, FLASHFRY_TPU_NO_NATIVE="1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.mark.parametrize("backend", ["numpy", "torch-cpu"])
@pytest.mark.parametrize("case", list(CASES))
def test_discover_byte_identical_to_flashfry_tpu_numpy(discover_inputs, case, backend):
    d, mine_db, ref_db, guides, refs = discover_inputs
    no_native = case == "no_native"
    base = ["discover", "--fasta", guides, "--positionOutput", *CASES[case]]
    if case not in refs:
        refs[case] = str(d / (case + ".ref"))
        run_cli("flashfry_tpu", base + ["--database", ref_db, "--output", refs[case],
                                        "--backend", "numpy"], no_native)
    mine = str(d / ("%s.%s" % (case, backend)))
    flags = ["--backend", "numpy"] if backend == "numpy" else ["--device", "cpu"]
    run_cli("flashfry_tpu_torch", base + ["--database", mine_db, "--output", mine, *flags],
            no_native)
    assert os.path.getsize(refs[case]) > 0
    assert filecmp.cmp(mine, refs[case], shallow=False)
    with open(mine) as fh:
        text = fh.read()
    if case == "maximumOffTargets1":
        assert "OVERFLOW" in text
    if case == "mm4":
        # guides from the planted unit find its other copies
        counts = [int(line.split("\t")[7]) for line in text.splitlines()
                  if line.startswith("repeat\t")]
        assert counts and max(counts) >= 20, counts


@pytest.mark.parametrize("enzyme", ENZYMES)
def test_bit_encoding_equals_flashfry_tpu(enzyme):
    pack = name_to_parameter_pack(enzyme)
    mine, ref = BitEncoding(pack), RefBitEncoding(ref_pack(enzyme))
    rng = np.random.default_rng(len(enzyme))
    seqs = ["".join("ACGT"[c] for c in row)
            for row in rng.integers(0, 4, size=(300, pack.total_scan_length))]
    longs = mine.encode_batch(seqs)
    assert np.array_equal(longs, ref.encode_batch(seqs))
    dec, ref_dec = mine.decode_batch(longs), ref.decode_batch(longs)
    assert dec[0] == ref_dec[0] == seqs
    assert np.array_equal(np.asarray(dec[1]), np.asarray(ref_dec[1]))
    targets = longs[rng.permutation(300)]
    for j in range(0, 300, 3):   # near neighbours: 0..5 substitutions
        for pos in rng.integers(0, pack.total_scan_length, size=j % 6):
            targets[j] ^= np.uint64(int(rng.integers(1, 4))) << np.uint64(2 * int(pos))
    mm = mine.mismatches_cross(targets, longs[:64])
    assert np.array_equal(mm, ref.mismatches_cross(targets, longs[:64]))
    assert (mm <= 5).any()


@pytest.mark.parametrize("where", ["numpy.lib.format", "numpy.lib._format_impl"])
def test_load_database_finds_the_npy_header_reader(genome, tmp_path, monkeypatch, where):
    """numpy < 2.1 keeps _read_array_header in numpy.lib.format, numpy >= 2.1
    (the card's machine) in numpy.lib._format_impl: the port loads either way."""
    _d, fa, _seq, _copy_at = genome
    path = str(tmp_path / "db")
    cli.run(["index", "--reference", fa, "--database", path, "--enzyme", "spcas9ngg"])
    want = ref_load(path)
    read = getattr(np.lib.format, "_read_array_header", None)
    if read is None:   # this numpy keeps it in _format_impl already
        read = __import__("numpy.lib._format_impl", fromlist=["x"])._read_array_header
    calls = []

    def counted(fh, version):
        calls.append(version)
        return read(fh, version)

    if where == "numpy.lib.format":
        monkeypatch.setattr(np.lib.format, "_read_array_header", counted, raising=False)
    else:
        monkeypatch.delattr(np.lib.format, "_read_array_header", raising=False)
        stand_in = types.ModuleType("numpy.lib._format_impl")
        stand_in._read_array_header = counted
        monkeypatch.setitem(sys.modules, "numpy.lib._format_impl", stand_in)
    db = database.load_database(path)
    assert len(calls) == len(DB_FIELDS) + 1      # every member is memory-mapped
    assert isinstance(db.targets, np.memmap)
    assert_same_database(db, want)
