"""Genomic position bit-packing (vectorized).

Mirrors the reference's BitPosition layout exactly
(reference: src/main/scala/bitcoding/BitPosition.scala:28-95):

  high 4 bits   strand (0 forward / 1 reverse)
  next 8 bits   target length
  20 bits       contig id (1-based registration order)
  low 32 bits   position within the contig
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

STRAND_MASK = np.uint64(0xF000000000000000)
SIZE_MASK = np.uint64(0x0FF0000000000000)
CONTIG_MASK = np.uint64(0x000FFFFF00000000)
POSITION_MASK = np.uint64(0x00000000FFFFFFFF)

SHIFT_STRAND = np.uint64(60)
SHIFT_SIZE = np.uint64(52)
SHIFT_CONTIG = np.uint64(32)


class BitPosition:
    """Contig registry + position codec (BitPosition.scala:36-74)."""

    def __init__(self):
        self.contig_map: Dict[str, int] = {}
        self.index_to_contig: Dict[int, str] = {}
        self.next_seq_id = 1

    def add_reference(self, ref_name: str) -> None:
        self.contig_map[ref_name] = self.next_seq_id
        self.index_to_contig[self.next_seq_id] = ref_name
        self.next_seq_id += 1
        assert self.next_seq_id < (int(CONTIG_MASK) >> int(SHIFT_CONTIG)), "Contig count exceeds capacity"

    def encode(self, ref_name: str, position: int, target_length: int, forward_strand: bool) -> int:
        assert ref_name in self.contig_map, "Unknown contig: " + ref_name
        assert position >= 0
        assert target_length < 256
        return int(self.encode_batch(np.full(1, self.contig_map[ref_name], dtype=np.uint64),
                                     np.array([position], dtype=np.uint64),
                                     np.array([target_length], dtype=np.uint64),
                                     np.array([forward_strand]))[0])

    @staticmethod
    def encode_batch(contig_ids: np.ndarray, positions: np.ndarray,
                     target_lengths: np.ndarray, forward_strand: np.ndarray) -> np.ndarray:
        """Vectorized encode (BitPosition.scala:51-62)."""
        contig_shifted = contig_ids.astype(np.uint64) << SHIFT_CONTIG
        pos = positions.astype(np.uint64)
        strand = np.where(forward_strand, np.uint64(0), np.uint64(1) << SHIFT_STRAND).astype(np.uint64)
        size = target_lengths.astype(np.uint64) << SHIFT_SIZE
        return contig_shifted | pos | strand | size

    def decode(self, encoding: int) -> Tuple[str, int, int, bool]:
        """Returns (contig, start, size, forward_strand) (BitPosition.scala:64-73)."""
        c, s, z, f = self.decode_batch(np.array([encoding], dtype=np.uint64))
        return self.index_to_contig[int(c[0])], int(s[0]), int(z[0]), bool(f[0])

    @staticmethod
    def decode_batch(encodings: np.ndarray):
        """Vectorized decode to (contig_ids, starts, sizes, forward_strand)."""
        e = np.asarray(encodings, dtype=np.uint64)
        contig = ((e & CONTIG_MASK) >> SHIFT_CONTIG).astype(np.int64)
        start = (e & POSITION_MASK).astype(np.int64)
        size = ((e & SIZE_MASK) >> SHIFT_SIZE).astype(np.int64)
        fwd = ((e & STRAND_MASK) >> SHIFT_STRAND) == 0
        return contig, start, size, fwd

    @property
    def contig_names_in_order(self) -> List[str]:
        return [self.index_to_contig[i] for i in range(1, self.next_seq_id)]


def overlap(contig: str, start: int, length: int,
            o_contig: str, start_pos: int, end_pos: int) -> bool:
    """Interval overlap test used by BED annotation, replicating the
    reference's exact boundary conditions
    (bitcoding/PositionInformation.scala:32-37)."""
    if contig != o_contig:
        return False
    return ((start < start_pos and start_pos < start + length and start < end_pos)
            or (start >= start_pos and start < end_pos and start_pos < start + length))
