"""Sequence-dictionary (.dict) reader.

Counterpart of reference/ReferenceDictReader.scala:29-47: parse the SAM-style
sequence dictionary (``@SQ\tSN:<name>\tLN:<length>`` lines) that accompanies
a reference FASTA, and build a BitPosition contig registry from it in file
order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

from .positions import BitPosition


@dataclass(frozen=True)
class ReferenceEntry:
    seq_name: str
    length: int


class ReferenceDictReader:
    """Iterable of the @SQ entries of a .dict file."""

    def __init__(self, ref: str):
        self.seq_list: List[ReferenceEntry] = []
        with open(ref) as fh:
            for line in fh:
                if line.startswith("@SQ"):
                    sp = line.rstrip("\n").split("\t")
                    name = sp[1].removeprefix("SN:")
                    length = int(sp[2].removeprefix("LN:"))
                    self.seq_list.append(ReferenceEntry(name, length))

    def __iter__(self) -> Iterator[ReferenceEntry]:
        return iter(self.seq_list)

    def generate_bit_position(self) -> BitPosition:
        ret = BitPosition()
        for entry in self.seq_list:
            ret.add_reference(entry.seq_name)
        return ret
