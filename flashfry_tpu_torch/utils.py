"""General utilities: complement/reverse-complement, GC content, FASTA IO.

Counterpart of the reference's utils/Utils.scala (revcomp :81-88, gcContent
:46) and the FASTA streaming in reference/ReferenceEncoder.scala:53-66.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, List, Tuple

import numpy as np

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A",
         "a": "t", "c": "g", "g": "c", "t": "a"}


def comp_base(c: str) -> str:
    return _COMP.get(c, c)


def comp_string(s: str) -> str:
    return "".join(_COMP.get(c, c) for c in s)


def reverse_comp_string(s: str) -> str:
    """Utils.scala:88 — complement then reverse."""
    return comp_string(s)[::-1]


def gc_content(guide: str) -> float:
    """Utils.scala:46 — fraction of G/C over the full string (PAM included)."""
    g = guide.upper()
    return sum(1 for b in g if b in "GC") / float(len(g))


def open_maybe_gzip(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def iterate_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (converted_name, uppercase_sequence) per contig.

    Name conversion matches ReferenceEncoder.scala:56 — strip '>', then
    replace spaces and tabs with underscores. Sequence is uppercased
    (ReferenceEncoder.scala:63).
    """
    name = None
    chunks: List[str] = []
    with open_maybe_gzip(path) as fh:
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks).upper()
                name = line[1:].replace(" ", "_").replace("\t", "_")
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks).upper()


def entropy(seq: str) -> float:
    """Shannon entropy over base composition (Utils.scala)."""
    s = seq.upper()
    if not s:
        return 0.0
    total = 0.0
    for b in "ACGT":
        p = s.count(b) / len(s)
        if p > 0:
            total += -p * np.log2(p)
    return float(total)


def longest_homopolymer(seq: str) -> int:
    best = run = 0
    prev = None
    for c in seq.upper():
        run = run + 1 if c == prev else 1
        prev = c
        best = max(best, run)
    return best


def median(values) -> float:
    """Median with the reference's exact semantics (Utils.scala:215-224):
    mean of the two middle elements for even length."""
    s = sorted(values)
    n = len(s)
    if n == 0:
        raise ValueError("median of empty sequence")
    if n % 2 == 1:
        return float(s[n // 2])
    return (float(s[n // 2 - 1]) + float(s[n // 2])) / 2.0
