"""FlashFry on-disk database interoperability (import + export).

The reference stores its off-target database as a BGZF-compressed stream of
per-bin blocks plus a plain-text ``.header`` sidecar
(reference: reference/binary/DatabaseWriter.scala:58-111,
BinaryHeader.scala:69-160, blocks/BlockManager.scala:316-442). Our native
format is the columnar npz (database.py) — this module converts both ways so
existing FlashFry databases can be used directly and our databases can be
inspected/consumed by the reference toolchain:

  * block layouts: linear  = [1][target, pos*count]... ;
    indexed = [2][256 x (offset<<32 | size)][target, pos*count]... where the
    4^4 interior lookup is keyed by the 4 bases after the bin prefix and
    offsets/sizes count longs within the data section
    (BlockManager.scala:362-442). A bin is written indexed iff it holds more
    than 500 targets and the enzyme is not 5'-PAM
    (DatabaseWriter.scala:84-89);
  * every target long carries its genome occurrence count in the high 16
    bits, and exactly ``count`` position longs follow it
    (BlockManager.linearBlockToGuides:316-351, BlockReader.scala:170);
  * longs are NATIVE byte order (little-endian on any machine that matters —
    Utils.longArrayToByteArray, utils/Utils.scala:154-165);
  * the header lists magic, version, enzyme index, 4^w, one
    ``bin=virtualOffset,uncompressedBytes,numTargets`` line per bin in
    A<C<G<T order, then ``contig=index`` lines (ids start at 1);
  * blockPosition is the BGZF *virtual offset* (compressed_block_offset<<16 |
    offset_within_uncompressed_block), the htsjdk convention.

BGZF itself is plain gzip members with a BC/BSIZE extra subfield and a fixed
28-byte EOF member, so both directions are pure zlib here — no htsjdk.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .bitcoding import all_bins
from .database import (Database, HEADER_EXTENSION, MAGIC_NUMBER, VERSION)
from .standards import (ParameterPack, index_to_parameter_pack,
                        parameter_pack_to_index)

MAX_TARGETS_PER_LINEAR_BIN = 500   # DatabaseWriter.scala:66
INTERIOR_BIN_WIDTH = 4             # DatabaseWriter.scala:85 (lookupBinSize)

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_BGZF_MAX_UNCOMPRESSED = 65280  # htsjdk's default block size


# ---------------------------------------------------------------------------
# BGZF
# ---------------------------------------------------------------------------

class BgzfWriter:
    """Minimal BGZF writer tracking htsjdk-style virtual offsets."""

    def __init__(self, fh):
        self.fh = fh
        self.buf = bytearray()
        self.compressed_offset = 0

    @property
    def virtual_offset(self) -> int:
        return (self.compressed_offset << 16) | len(self.buf)

    def write(self, data: bytes) -> None:
        self.buf.extend(data)
        while len(self.buf) >= _BGZF_MAX_UNCOMPRESSED:
            self._flush_block(self.buf[:_BGZF_MAX_UNCOMPRESSED])
            del self.buf[:_BGZF_MAX_UNCOMPRESSED]

    def _flush_block(self, payload) -> None:
        payload = bytes(payload)
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        # BSIZE = total block length - 1: 18-byte header + cdata + crc/isize(8)
        bsize = len(cdata) + 25
        header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 +
                  b"\x06\x00BC\x02\x00" + struct.pack("<H", bsize))
        block = (header + cdata +
                 struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                             len(payload)))
        self.fh.write(block)
        self.compressed_offset += len(block)

    def close(self) -> None:
        if self.buf:
            self._flush_block(self.buf)
            self.buf.clear()
        self.fh.write(_BGZF_EOF)


def bgzf_decompress_all(path: str) -> bytes:
    """Sequentially decompress every member of a BGZF (or plain gzip) file."""
    out = bytearray()
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    while pos < len(data):
        d = zlib.decompressobj(wbits=31)  # gzip member
        out.extend(d.decompress(data[pos:]))
        consumed = len(data) - pos - len(d.unused_data)
        if consumed <= 0:
            break
        pos += consumed
    return bytes(out)


# ---------------------------------------------------------------------------
# block encode / decode
# ---------------------------------------------------------------------------

def parse_block_longs(block: np.ndarray, bin_width: int
                      ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """One bin's longs -> (targets, [positions per target]).

    Accepts both layouts; the first long is the block type
    (BlockManager.compareBlock:63-90)."""
    if block.size == 0:
        return np.zeros(0, np.uint64), []
    btype = int(block[0])
    if btype == 1:
        data = block[1:]
    elif btype == 2:
        data = block[1 + 4 ** INTERIOR_BIN_WIDTH:]
    else:
        raise ValueError("Invalid bin type, unknown value: %d" % btype)
    targets = []
    positions = []
    off = 0
    n = data.size
    while off < n:
        t = np.uint64(data[off])
        count = int(t >> np.uint64(48))
        if count <= 0:
            raise ValueError("Encoded position count should be greater than zero")
        if off + 1 + count > n:
            # truncated/corrupt block: the target's position entries would
            # run past the end (BlockManager.scala:229-237 asserts the same)
            raise ValueError("position entries exceed the block size")
        targets.append(t)
        positions.append(np.asarray(data[off + 1: off + 1 + count], dtype=np.uint64))
        off += count + 1
    return np.asarray(targets, dtype=np.uint64), positions


def encode_block_longs(targets: np.ndarray, pos_offsets: np.ndarray,
                       positions: np.ndarray, pack: ParameterPack,
                       bin_width: int) -> np.ndarray:
    """One bin's (targets, CSR positions) -> FlashFry block longs."""
    n = targets.shape[0]
    n_pos = int(pos_offsets[-1] - pos_offsets[0])
    indexed = n > MAX_TARGETS_PER_LINEAR_BIN and not pack.five_prime_pam

    # interleave [target, pos...] with one vectorized scatter
    data = np.zeros(n + n_pos, dtype=np.uint64)
    counts = (targets >> np.uint64(48)).astype(np.int64)
    t_slots = np.zeros(n, dtype=np.int64)
    if n:
        t_slots[1:] = np.cumsum(counts[:-1] + 1)
    data[t_slots] = targets
    pos_mask = np.ones(n + n_pos, dtype=bool)
    pos_mask[t_slots] = False
    data[pos_mask] = positions[int(pos_offsets[0]):int(pos_offsets[-1])]

    if not indexed:
        return np.concatenate([np.array([1], np.uint64), data])

    # interior 4-mer lookup over the bases following the bin prefix
    # (BlockManager.createIndexedBlock:362-413); 3'-PAM only, so the sub-bin
    # is bases [w, w+4) of the decoded sequence = bits below the prefix
    L = pack.total_scan_length
    shift = np.uint64(2 * (L - bin_width - INTERIOR_BIN_WIDTH))
    sub = ((targets >> shift) & np.uint64(0xFF)).astype(np.int64)
    sizes = np.zeros(4 ** INTERIOR_BIN_WIDTH, dtype=np.int64)
    np.add.at(sizes, sub, counts + 1)
    first = np.full(4 ** INTERIOR_BIN_WIDTH, -1, dtype=np.int64)
    # targets are sequence-sorted within the bin, so each sub-bin's first
    # occurrence is its minimum slot
    uniq, first_idx = np.unique(sub, return_index=True)
    first[uniq] = t_slots[first_idx]
    # empty sub-bins keep offset -1, size 0, exactly like the reference's
    # LinkedHashMap initialization (binLookup(bin) = -1)
    lookup = (first.astype(np.int64) << 32 | sizes).view(np.uint64)
    return np.concatenate([np.array([2], np.uint64), lookup, data])


# ---------------------------------------------------------------------------
# whole-database export / import
# ---------------------------------------------------------------------------

def export_flashfry_database(db: Database, path: str) -> None:
    """Write `path` (BGZF blocks) + `path + ".header"` in the reference's
    exact on-disk format (DatabaseWriter.writeToBinnedFileSet)."""
    bins = all_bins(db.bin_width)
    offsets: List[Tuple[int, int, int]] = []
    with open(path, "wb") as fh:
        w = BgzfWriter(fh)
        for i in range(db.num_bins):
            t0, t1 = int(db.bin_start[i]), int(db.bin_start[i + 1])
            vpos = w.virtual_offset
            block = encode_block_longs(db.targets[t0:t1],
                                       db.pos_offsets[t0:t1 + 1],
                                       db.positions, db.pack, db.bin_width)
            raw = block.astype("<u8").tobytes()
            w.write(raw)
            offsets.append((vpos, len(raw), t1 - t0))
        w.close()

    with open(path + HEADER_EXTENSION, "w") as out:
        out.write(str(MAGIC_NUMBER) + "\n")
        out.write(str(VERSION) + "\n")
        out.write(str(parameter_pack_to_index(db.pack)) + "\n")
        out.write(str(db.num_bins) + "\n")
        for b, (vpos, usize, ntgt) in zip(bins, offsets):
            out.write("%s=%d,%d,%d\n" % (b, vpos, usize, ntgt))
        for idx, name in enumerate(db.contig_names, start=1):
            out.write("%s=%d\n" % (name, idx))


def read_flashfry_header(header_path: str):
    """Parse a FlashFry .header -> (pack, bin_width, [(vpos, usize, ntgt)],
    contig_names)."""
    with open(header_path) as fh:
        lines = [l.rstrip("\n") for l in fh]
    if int(lines[0]) != MAGIC_NUMBER:
        raise ValueError("%s doesn't have the magic number expected" % header_path)
    if int(lines[1]) != VERSION:
        raise ValueError("%s: bad version %s" % (header_path, lines[1]))
    pack = index_to_parameter_pack(int(lines[2]))
    bin_count = int(lines[3])
    bin_width = round(np.log(bin_count) / np.log(4))
    offsets = []
    for i, b in enumerate(all_bins(bin_width)):
        name, _, rest = lines[4 + i].partition("=")
        if name != b:
            raise ValueError("header bin order mismatch: expected %s got %s" % (b, name))
        parts = rest.split(",")
        offsets.append((int(parts[0]), int(parts[1]), int(parts[2])))
    contigs = []
    for line in lines[4 + bin_count:]:
        if not line:
            continue
        name, _, idx = line.rpartition("=")
        contigs.append((int(idx), name))
    contigs.sort()
    return pack, bin_width, offsets, [name for _, name in contigs]


def import_flashfry_database(path: str) -> Database:
    """Read a reference-format database (BGZF + .header) into our columnar
    Database. Sequential read — no virtual-offset seeking needed because the
    header's per-bin uncompressed sizes tile the stream in bin order."""
    pack, bin_width, offsets, contig_names = read_flashfry_header(
        path + HEADER_EXTENSION)
    raw = bgzf_decompress_all(path)
    longs = np.frombuffer(raw, dtype="<u8")

    all_targets: List[np.ndarray] = []
    all_positions: List[np.ndarray] = []
    bin_counts = np.zeros(4 ** bin_width, dtype=np.int64)
    off = 0
    for i, (_vpos, usize, ntgt) in enumerate(offsets):
        n_longs = usize // 8
        block = longs[off: off + n_longs]
        off += n_longs
        targets, pos_lists = parse_block_longs(block, bin_width)
        if targets.shape[0] != ntgt:
            raise ValueError("bin %d: header says %d targets, block has %d"
                             % (i, ntgt, targets.shape[0]))
        bin_counts[i] = targets.shape[0]
        if targets.size:
            all_targets.append(targets)
            all_positions.extend(pos_lists)

    targets = (np.concatenate(all_targets) if all_targets
               else np.zeros(0, np.uint64))
    counts = (targets >> np.uint64(48)).astype(np.int64)
    pos_offsets = np.zeros(targets.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=pos_offsets[1:])
    positions = (np.concatenate(all_positions) if all_positions
                 else np.zeros(0, np.uint64))
    bin_start = np.zeros(4 ** bin_width + 1, dtype=np.int64)
    np.cumsum(bin_counts, out=bin_start[1:])
    return Database(pack=pack, bin_width=bin_width, targets=targets,
                    positions=positions, pos_offsets=pos_offsets,
                    bin_start=bin_start, contig_names=contig_names)
