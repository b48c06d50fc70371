"""flashfry_tpu_torch's `score` against flashfry_tpu's, on the CPU.

Everything here is bitwise; no tolerance is used anywhere.

  (a) the descriptor pass: the port's extract_descriptors on the CPU (the
      plain PyTorch version of csrc/descriptors.cu) equals flashfry_tpu's
      jitted JAX pass word for word, on off-targets with 0..9 planted
      mismatches; and a numpy model of the kernel's own algorithm (packed
      guide words, XOR, one bit per mismatching position, at most six
      steps from the highest set bit) equals both;
  (b) the port's OTScoreBatch on its three backends (device on the CPU,
      native, numpy) gives the f64 columns of flashfry_tpu's numpy backend,
      compared as int64 views, descriptor-overflow rows included;
  (c) the golden-value cases of tests/test_scoring.py, run on the port's
      classes;
  (d) the `score` command: on a synthetic genome, index -> discover ->
      `python -m flashfry_tpu_torch score --device cpu` writes the bytes of
      `python -m flashfry_tpu score` for the eleven metrics, with each
      backend, without the native library, and under the output flags; and
      how FLASHFRY_TPU_SCORE_BACKEND and --backend choose the backend.

Inputs come from numpy seeds.
"""

import filecmp
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from flashfry_tpu import cli as ref_cli
from flashfry_tpu.scoring import device as ref_device
from flashfry_tpu.scoring import off_target as ref_off_target
from flashfry_tpu.scoring import otbatch as ref_otbatch
from flashfry_tpu_torch import cli
from flashfry_tpu_torch.bitcoding import BitEncoding
from flashfry_tpu_torch.ops.scan import split_words
from flashfry_tpu_torch.scoring import device as port_device
from flashfry_tpu_torch.scoring import off_target, otbatch
from flashfry_tpu_torch.standards import (Cas9NGG19ParameterPack, Cas9NGGParameterPack,
                                          name_to_parameter_pack)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELEVEN = ("doench2016cfd,hsu2013,jostandsantos,minot,dangerous,doench2014ontarget,"
          "moreno2015,bedannotator,reciprocalofftargets,folding,rank")


@pytest.fixture(autouse=True)
def cpu_backend():
    """Every test starts on the device backend with its pass on the CPU, and
    leaves no memoized batch behind."""
    otbatch.set_backend("device", "cpu")
    yield
    otbatch.clear_batch_cache()
    otbatch.set_backend("device", "cpu")


def random_longs(rng, pack, k):
    L = pack.total_scan_length
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=L)) for _ in range(k)]
    return BitEncoding(pack).encode_batch(seqs)


def planted(pack, n, g, seed, max_mm=9):
    """n off-targets of g random guides: off-target i is its guide with
    i % (max_mm + 1) substitutions at distinct active positions, a random PAM
    dinucleotide and a random count above bit 48. Returns (flat, gi, glongs,
    L, act_pos, planted counts)."""
    rng = np.random.default_rng(seed)
    L = pack.total_scan_length
    act = np.asarray(sorted(pack.comparison_mask_positions()), np.int32)
    glongs = random_longs(rng, pack, g)
    gi = rng.integers(0, g, size=n).astype(np.int64)
    k = np.arange(n) % (max_mm + 1)
    flat = glongs[gi] & np.uint64(0xFFFFFFFFFFFF)
    for i in range(n):
        s = int(flat[i])
        for p in rng.choice(act, size=int(k[i]), replace=False):
            s ^= int(rng.integers(1, 4)) << (2 * (L - 1 - int(p)))
        s = (s & ~0xF) | int(rng.integers(0, 16))
        flat[i] = np.uint64(s)
    flat |= rng.integers(1, 100, size=n).astype(np.uint64) << np.uint64(48)
    return flat, gi, glongs, L, act, k


# ---------------- (a) the descriptor pass ----------------

@pytest.mark.parametrize("enzyme", ["spcas9ngg", "spcas919"])
@pytest.mark.parametrize("n", [1, 7, 1000, 70_000])
def test_descriptors_plain_equals_flashfry_tpu(enzyme, n):
    pack = name_to_parameter_pack(enzyme)
    flat, gi, glongs, L, act, k = planted(pack, n, g=min(n, 37), seed=n)
    assert L == (23 if enzyme == "spcas9ngg" else 22)
    w0, w1 = port_device.extract_descriptors(flat, gi, glongs, L, act, "cpu")
    r0, r1 = ref_device.extract_descriptors(flat, gi, glongs, L, act)
    assert w0.dtype == w1.dtype == np.int32 and w0.shape == w1.shape == (n,)
    assert np.array_equal(w0, r0) and np.array_equal(w1, r1)
    # the words say what was planted: the count capped at 7, overflow past 6
    _, _, _, mmc, overflow, pam = otbatch.unpack_descriptors(w0, w1)
    assert np.array_equal(mmc, np.minimum(k, 7))
    assert np.array_equal(overflow, (k > 6).astype(overflow.dtype))
    assert np.array_equal(pam, (flat & np.uint64(15)).astype(pam.dtype))
    assert port_device.descriptors.launches == 0  # the CPU launches no kernel


U64 = np.uint64


def clz64(v):
    """Leading zeros of each uint64 (64 for 0), as the card's __clzll."""
    v = v.copy()
    n = np.zeros(v.shape, np.uint64)
    for s in (32, 16, 8, 4, 2, 1):
        top_zero = (v >> U64(64 - s)) == 0
        n += np.where(top_zero, U64(s), U64(0))
        v = np.where(top_zero, v << U64(s), v)
    return n + ((v >> U64(63)) == 0).astype(np.uint64)


def set_bit_walk(lo, hi, gi, gcodes, act_n):
    """numpy model of csrc/descriptors.cu, step for step: lo/hi/gi int32
    (N,), gcodes (G, L) int8 -> (w0, w1) int32 (N,)."""
    G, L = gcodes.shape
    up = U64(64 - 2 * L)
    words = np.zeros(G, np.uint64)  # the pack kernel
    for p in range(L):
        words = (words << U64(2)) | (gcodes[:, p].astype(np.uint64) & U64(3))
    words <<= up  # position p at bits 63 - 2p, 62 - 2p
    seq = ((hi.view(np.uint32).astype(np.uint64) << U64(32))
           | lo.view(np.uint32).astype(np.uint64)) << up
    guide = words[np.clip(gi, 0, G - 1)]
    x = seq ^ guide
    active = U64(0) if act_n == 0 else \
        (U64(2 ** 64 - 1) << U64(64 - 2 * act_n)) & U64(0xAAAAAAAAAAAAAAAA)
    m = (x | (x << U64(1))) & active  # bit 63 - 2p: position p mismatches
    count = np.bitwise_count(m).astype(np.uint64)
    w = [np.zeros(lo.shape, np.uint64), np.zeros(lo.shape, np.uint64)]
    for k in range(6):  # the highest set bit first: ascending positions
        z = clz64(m) & U64(63)  # 2p
        o = (seq << z) >> U64(62)
        g = (guide << z) >> U64(62)
        d = np.where(U64(k) < count, ((z >> U64(1)) << U64(4)) | (g << U64(2)) | o, U64(0))
        w[k // 3] |= d << U64(9 * (k % 3))
        m &= ~(U64(1 << 63) >> z)
    w[0] |= (np.minimum(count, U64(7)) << U64(27)) | ((count > 6).astype(np.uint64) << U64(30))
    w[1] |= (lo.view(np.uint32).astype(np.uint64) & U64(15)) << U64(27)
    return tuple(a.astype(np.uint32).view(np.int32) for a in w)


@pytest.mark.parametrize("enzyme", ["spcas9ngg", "spcas919"])
@pytest.mark.parametrize("act", ["0", "1", "n_act", "L"])
def test_set_bit_walk_equals_plain_and_flashfry_tpu(enzyme, act):
    """The kernel's algorithm, modelled in numpy, at act_n = 0 (no
    descriptor), 1, the enzyme's active positions and L (the PAM positions
    count too), on 0..9 planted mismatches: word for word the plain
    version's and the JAX pass's."""
    pack = name_to_parameter_pack(enzyme)
    flat, gi, glongs, L, act_pos, k = planted(pack, 3000, g=41, seed=len(act) + len(enzyme))
    act_n = {"0": 0, "1": 1, "n_act": act_pos.shape[0], "L": L}[act]
    lo, hi = split_words(flat)
    model = set_bit_walk(lo, hi, gi, port_device.guide_codes(glongs, L), act_n)
    plain = port_device.extract_descriptors(flat, gi, glongs, L, np.arange(act_n), "cpu")
    ref = ref_device.extract_descriptors(flat, gi, glongs, L, np.arange(act_n))
    for got, want, name in zip(model + plain, ref + ref, ("w0", "w1") * 2):
        assert np.array_equal(got, want), (name, act)
    _, _, _, mmc, overflow, pam = otbatch.unpack_descriptors(*model)
    assert np.array_equal(pam, (flat & np.uint64(15)).astype(pam.dtype))
    if act == "0":
        assert not mmc.any() and not model[0].any()
    elif act == "n_act":
        assert np.array_equal(mmc, np.minimum(k, 7))
        assert np.array_equal(overflow, (k > 6).astype(overflow.dtype))
    else:
        assert bool((mmc > 0).any()) and bool((mmc < 7).any())


def test_extract_descriptors_edges():
    pack = Cas9NGGParameterPack
    flat, gi, glongs, L, act, _ = planted(pack, 10, 3, seed=2)
    w0, w1 = port_device.extract_descriptors(flat[:0], gi[:0], glongs, L, act, "cpu")
    assert w0.shape == w1.shape == (0,) and w0.dtype == np.int32
    with pytest.raises(ValueError, match="contiguous leading"):
        port_device.extract_descriptors(flat, gi, glongs, L, act[1:], "cpu")
    with pytest.raises(ValueError, match="guide index"):
        port_device.extract_descriptors(flat, gi + 3, glongs, L, act, "cpu")


def test_descriptors_rejects_what_the_kernel_does_not_take():
    import torch
    lo = torch.zeros(4, dtype=torch.int32)
    g = torch.zeros((2, 23), dtype=torch.int8)
    port_device.descriptors(lo, lo, lo, g, 20)
    with pytest.raises(TypeError):
        port_device.descriptors(lo, lo, lo.long(), g, 20)
    with pytest.raises(TypeError):
        port_device.descriptors(lo, lo[:3], lo, g, 20)
    with pytest.raises(TypeError):
        port_device.descriptors(lo, lo, lo, g.int(), 20)
    with pytest.raises(ValueError):
        port_device.descriptors(lo, lo, lo, g, 24)
    with pytest.raises(ValueError):
        port_device.descriptors(lo, lo, lo, g.t().contiguous().t(), 20)


# ---------------- (b) the score batch on each backend ----------------

def random_and_planted(pack, n, g, seed, max_planted_mm):
    """tests/test_otbatch.py's fixture: half the off-targets are guides with
    0..max_planted_mm substitutions anywhere, half are random sequences."""
    rng = np.random.default_rng(seed)
    L = pack.total_scan_length
    glongs = random_longs(rng, pack, g)
    flat = random_longs(rng, pack, n)
    gi = rng.integers(0, g, size=n).astype(np.int64)
    half = n // 2
    base = glongs[gi[:half]] & np.uint64(0xFFFFFFFFFFFF)
    for i in range(half):
        s = int(base[i])
        for _ in range(int(rng.integers(0, max_planted_mm + 1))):
            s ^= int(rng.integers(1, 4)) << (2 * (L - 1 - int(rng.integers(0, L))))
        flat[i] = np.uint64(s)
    flat |= rng.integers(1, 100, size=n).astype(np.uint64) << np.uint64(48)
    act = np.asarray(sorted(pack.comparison_mask_positions()), np.int32)
    return flat, gi, glongs, L, act


BATCHES = {
    "20mer": (Cas9NGGParameterPack, 20000, 32, 11, 6, ("cfd", "hsu", "jost")),
    "20mer_overflow": (Cas9NGGParameterPack, 4000, 32, 7, 12, ("cfd", "hsu", "jost")),
    "19mer": (Cas9NGG19ParameterPack, 5000, 16, 4, 4, ("jost",)),
}


def columns(models, batch, pack, kinds):
    """{kind: (score, differs)} of one OTScoreBatch, with the tables of the
    off-target module `models` of the same package."""
    cfd, hsu, jost = (models.Doench2016CFDScore(), models.CrisprMitEduOffTarget(),
                      models.JostAndSantosCRISPRi())
    jost._pack = pack
    calls = {"cfd": lambda: batch._column("cfd", cfd_tables=(cfd._mm_table, cfd._pam_table)),
             "hsu": lambda: batch._column("hsu", hsu_tables=(hsu._one_minus, hsu._pam_table),
                                          gs=20),
             "jost": lambda: batch._column("jost", jost_tables=(jost._table, jost._lo()))}
    return {k: calls[k]() for k in kinds}


@pytest.mark.parametrize("backend", otbatch.BACKENDS)
@pytest.mark.parametrize("case", list(BATCHES))
def test_score_batch_equals_flashfry_tpu_numpy(case, backend):
    pack, n, g, seed, planted_mm, kinds = BATCHES[case]
    fx = random_and_planted(pack, n, g, seed, planted_mm)
    ref = ref_otbatch.OTScoreBatch(*fx)
    ref._backend = "numpy"
    want = columns(ref_off_target, ref, pack, kinds)
    otbatch.set_backend(backend, "cpu")
    mine = otbatch.OTScoreBatch(*fx)
    assert mine._backend == backend
    got = columns(off_target, mine, pack, kinds)
    for kind in kinds:
        assert np.array_equal(got[kind][0].view(np.int64), want[kind][0].view(np.int64)), kind
        assert np.array_equal(got[kind][1], want[kind][1]), kind
    assert mine._backend == backend  # no backend gave way to another
    if backend == "device":
        # the random half overflows the packing and is redone by the oracle;
        # most of the planted half is scored from its descriptors
        assert 100 < int(mine._recompute.size) < n - n // 4


def test_get_batch_memo_keeps_the_backend_in_its_key():
    fx = random_and_planted(Cas9NGGParameterPack, 500, 8, 3, 4)
    b1 = otbatch.get_batch(*fx)
    assert otbatch.get_batch(*fx) is b1 and b1._backend == "device"
    otbatch.set_backend("numpy")
    b2 = otbatch.get_batch(*fx)
    assert b2 is not b1 and b2._backend == "numpy"
    with pytest.raises(ValueError, match="unknown score backend"):
        otbatch.set_backend("auto")


def test_device_backend_on_cuda_without_a_card_raises():
    """The device backend on `cuda` never scores on the host instead."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    otbatch.set_backend("device", "cuda")
    b = otbatch.OTScoreBatch(*random_and_planted(Cas9NGGParameterPack, 50, 4, 1, 4))
    cfd = off_target.Doench2016CFDScore()
    with pytest.raises((RuntimeError, AssertionError)):
        b._column("cfd", cfd_tables=(cfd._mm_table, cfd._pam_table))


# ---------------- (c) golden values on the port's classes ----------------

def golden_module():
    """tests/test_scoring.py with its imports turned to the port."""
    with open(os.path.join(ROOT, "tests", "test_scoring.py")) as fh:
        text = fh.read()
    assert "from flashfry_tpu." in text
    mod = types.ModuleType("golden_cases_on_the_port")
    exec(compile(text.replace("from flashfry_tpu.", "from flashfry_tpu_torch."),
                 "test_scoring.py (port)", "exec"), mod.__dict__)
    return mod


GOLDEN = golden_module()
GOLDEN_CASES = sorted(n for n in vars(GOLDEN) if n.startswith("test_"))


def test_golden_cases_cover_every_model():
    assert len(GOLDEN_CASES) >= 22
    for word in ("cfd", "doench2014", "hsu", "crisprscan", "jost", "dangerous",
                 "closest_hit", "aggregate_rank", "schulze"):
        assert any(word in n for n in GOLDEN_CASES), word
    assert GOLDEN.Doench2016CFDScore is off_target.Doench2016CFDScore


@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_golden_case_on_the_port(name):
    getattr(GOLDEN, name)()


# ---------------- (d) the score command ----------------

def write_fasta(path, records):
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(">%s\n" % name)
            fh.write("".join(seq[i:i + 80] + "\n" for i in range(0, len(seq), 80)))


@pytest.fixture(scope="module")
def discovered(tmp_path_factory):
    """A 120 kb genome with a 300 bp unit planted 40 times (half the copies
    with substitutions), indexed and discovered by the port on the CPU: at
    mm 4 for guides from plain sequence and from a repeat copy, and at mm 7
    for two guides, whose lists hold off-targets with more than six
    mismatches. A BED over both contigs for bedannotator."""
    d = tmp_path_factory.mktemp("torch_scoring")
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, size=120_000)
    unit = rng.integers(0, 4, size=300)
    starts = rng.integers(0, 120_000 - 300, size=40)
    for j, p in enumerate(starts):
        copy = unit.copy()
        if j % 2:
            s = rng.integers(0, 300, size=4)
            copy[s] = (copy[s] + rng.integers(1, 4, size=4)) % 4
        codes[p:p + 300] = copy
    seq = "".join("ACGT"[c] for c in codes)
    fa, db = str(d / "genome.fa"), str(d / "db")
    write_fasta(fa, [("chrA", seq[:70_000]), ("chrB", seq[70_000:])])
    cli.run(["index", "--reference", fa, "--database", db, "--enzyme", "spcas9ngg"])
    copy_at = int(starts[-1])
    inputs = {}
    for tag, mm, records in (
            ("mm4", "4", [("chrA", seq[5_000:5_400]),
                          ("chrB", seq[copy_at:copy_at + 300])]),
            ("mm7", "7", [("chrA", seq[9_000:9_060])])):
        guides = str(d / (tag + ".fa"))
        write_fasta(guides, records)
        inputs[tag] = str(d / (tag + ".discover"))
        cli.run(["discover", "--fasta", guides, "--database", db, "--output",
                 inputs[tag], "--positionOutput", "--maxMismatch", mm, "--device", "cpu"])
    bed = str(d / "regions.bed")
    with open(bed, "w") as fh:
        for j, s in enumerate(np.sort(rng.integers(0, 70_000, size=300))):
            fh.write("%s\t%d\t%d\tI%d\n" % ("chrA" if j % 2 else "chrB", s,
                                            s + int(rng.integers(20, 400)), j))
    with open(inputs["mm7"]) as fh:
        assert "_7<" in fh.read(), "no off-target with 7 mismatches"
    return d, db, inputs, bed, {}


OPTIONS = {
    "plain": ("mm4", ()),
    "includeOTs": ("mm4", ("--includeOTs",)),
    "numericOutput": ("mm4", ("--numericOutput",)),
    "maxMismatch3": ("mm4", ("--maxMismatch", "3", "--includeOTs")),
    "overflow_rows": ("mm7", ("--includeOTs", "--countOnTargetInScore")),
}
HOW = ("device", "native", "numpy", "no_native")


@pytest.mark.parametrize("how", HOW)
@pytest.mark.parametrize("option", list(OPTIONS))
def test_score_cli_byte_identical_to_flashfry_tpu(discovered, monkeypatch, option, how):
    d, db, inputs, bed, refs = discovered
    tag, flags = OPTIONS[option]
    base = ["score", "--input", inputs[tag], "--database", db, "--scoringMetrics", ELEVEN,
            "--inputAnnotationBed", "regions:" + bed, *flags]
    if option not in refs:
        refs[option] = str(d / (option + ".ref"))
        monkeypatch.setenv("FLASHFRY_TPU_SCORE_BACKEND", "numpy")
        assert ref_cli.main(base + ["--output", refs[option]]) == 0
        monkeypatch.delenv("FLASHFRY_TPU_SCORE_BACKEND")
    mine = str(d / ("%s.%s" % (option, how)))
    if how == "no_native":
        # in a child: the native library, once loaded, stays loaded here
        env = dict(os.environ, PYTHONPATH=ROOT, FLASHFRY_TPU_NO_NATIVE="1")
        proc = subprocess.run(
            [sys.executable, "-m", "flashfry_tpu_torch", *base, "--output", mine,
             "--backend", "native", "--device", "cpu"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
    else:
        report = cli.run(base + ["--output", mine, "--backend", how, "--device", "cpu"])
        assert report["backend"] == how and report["off_targets"] > 0
        assert report["device"] == ("cpu" if how == "device" else "host")
    assert os.path.getsize(refs[option]) > 0
    assert filecmp.cmp(mine, refs[option], shallow=False)
    with open(mine) as fh:
        header = fh.readline().rstrip("\n").split("\t")
    for column in ("DoenchCFD_maxOT", "Hsu2013", "JostCRISPRi_maxOT", "regions",
                   "AggregateRankedScore_medianRank"):
        assert column in header, (column, header)


@pytest.mark.parametrize("variable,flag,want", [
    (None, None, "device"),
    ("auto", None, "device"),
    ("numpy", None, "numpy"),
    ("native", None, "native"),
    ("device", None, "device"),
    ("numpy", "device", "device"),
    ("device", "numpy", "numpy"),
    ("native", "numpy", "numpy"),
])
def test_score_backend_from_variable_and_flag(monkeypatch, variable, flag, want):
    """FLASHFRY_TPU_SCORE_BACKEND is --backend's default; the flag wins."""
    if variable is None:
        monkeypatch.delenv("FLASHFRY_TPU_SCORE_BACKEND", raising=False)
    else:
        monkeypatch.setenv("FLASHFRY_TPU_SCORE_BACKEND", variable)
    argv = ["score", "--input", "i", "--output", "o", "--database", "d",
            "--scoringMetrics", "minot"] + (["--backend", flag] if flag else [])
    args = cli.build_parser().parse_args(argv)
    assert args.backend == want and args.device == "cuda"


def test_score_backend_variable_must_name_a_backend(monkeypatch):
    monkeypatch.setenv("FLASHFRY_TPU_SCORE_BACKEND", "tpu")
    with pytest.raises(SystemExit, match="FLASHFRY_TPU_SCORE_BACKEND"):
        cli.build_parser()


def test_score_cli_without_a_card_is_an_error(discovered, tmp_path, monkeypatch):
    """No --device on a machine without a card: resolve_device's error, and
    no output written; the host backends need no card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.delenv("FLASHFRY_TPU_SCORE_BACKEND", raising=False)
    _d, db, inputs, _bed, _refs = discovered
    out = str(tmp_path / "scored")
    base = ["score", "--input", inputs["mm4"], "--database", db, "--output", out,
            "--scoringMetrics", "doench2016cfd"]
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        cli.run(base)
    assert not os.path.exists(out)
    assert cli.run(base + ["--backend", "numpy"])["device"] == "host"
    assert os.path.getsize(out) > 0
