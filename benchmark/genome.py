"""The benchmark's genome and FASTA files.

synthesize_genome is the repository's repeat-rich genome generator
(bench.py's, as chip_smoke.py copies it), copied here so that the
benchmark reads nothing outside its own folder, with one change: the
repeat families' sizes come from a fixed stream (SIZES), so that every
seed's genome holds the same work. Base codes are A=0, C=1, G=2, T=3 as
int8.
"""

from __future__ import annotations

import numpy as np

CONTIG = "chrS"
SIZES = 20180925   # the stream of the repeat families' sizes, the same for every seed
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def synthesize_genome(genome_mb: float, rng: np.random.Generator) -> np.ndarray:
    """Synthetic genome with a repeat landscape (int8 codes), far thinner
    than hg38's: about 5% of it lies in repeat families, where about half
    of hg38 is repeats, so a guide has fewer off-targets here than in a
    real genome of the same size.

    On a uniform random base genome it overlays
      * ~5% covered by repeat families: unit 300-5000 bp, copy number
        log-uniform 10-1000, every copy mutated at 1.5% a base, so sibling
        copies sit 0-5+ mismatches apart in any 23-mer window (a heavy
        mm <= 4 off-target tail);
      * 3 high-copy "Alu-like" families: unit 300 bp, thousands of copies,
        20% of them exact, so guides landing in them pass the 2000-position
        overflow cap.

    Each family's unit length, copy number, exact copies and the number
    of mutations of each copy are drawn from the fixed stream SIZES; the
    bases, the copies' places and the mutations from rng.
    """
    size = np.random.default_rng(SIZES)
    n = int(genome_mb * 1_000_000)
    genome = rng.integers(0, 4, size=n, dtype=np.int8)

    def place(unit: np.ndarray, copies: int, exact_frac: float) -> int:
        m = unit.shape[0]
        pos = rng.integers(0, n - m, size=copies)
        exact = size.random(copies) < exact_frac
        for p, ex in zip(pos.tolist(), exact.tolist()):
            c = unit
            if not ex:
                c = unit.copy()
                nm = size.binomial(m, 0.015)
                if nm:
                    s = rng.integers(0, m, size=nm)
                    c[s] = (c[s] + rng.integers(1, 4, size=nm)) % 4
            genome[p:p + m] = c
        return m * copies

    placed = 0
    for _ in range(3):
        unit = rng.integers(0, 4, size=300, dtype=np.int8)
        copies = max(2500, int(size.integers(5000, 20001) * genome_mb / 3000))
        placed += place(unit, copies, 0.2)
    target = int(0.05 * n)
    while placed < target:
        m = int(size.integers(300, 5001))
        copies = int(np.exp(size.uniform(np.log(10), np.log(1000))))
        unit = rng.integers(0, 4, size=m, dtype=np.int8)
        placed += place(unit, copies, 0.0)
    return genome


def write_fasta(path: str, name: str, codes: np.ndarray, width: int = 100) -> None:
    """int8 base codes (0..3) -> one-record FASTA with `width`-base lines."""
    n = codes.shape[0]
    rows = -(-n // width)
    padded = np.zeros(rows * width, dtype=np.int8)
    padded[:n] = codes
    body = np.empty((rows, width + 1), dtype=np.uint8)
    body[:, :width] = ACGT[padded].reshape(rows, width)
    body[:, width] = ord("\n")
    tail = n - (rows - 1) * width
    with open(path, "wb") as fh:
        fh.write((">%s\n" % name).encode())
        fh.write(body[:-1].tobytes())
        fh.write(body[-1, :tail].tobytes() + b"\n")
