"""Off-target database: construction, on-disk format, loading.

TPU-native re-expression of the reference's binned binary database
(reference: src/main/scala/reference/binary/DatabaseWriter.scala:58-111,
BlockReader.scala:87-135, BinaryHeader.scala:69-160). Instead of BGZF blocks
with interleaved linear/indexed layouts, we store flat columnar arrays that
can be uploaded to TPU HBM directly:

  targets      uint64[N]   count<<48 | packed bases, in global scan order
  positions    uint64[M]   packed genomic positions (BitPosition layout)
  pos_offsets  int64[N+1]  CSR offsets: target i's positions are
                           positions[pos_offsets[i]:pos_offsets[i+1]]
  bin_start    int64[4^w+1] CSR offsets over targets by prefix bin

Global scan order = (prefix-bin lexicographic, then full sequence ascending),
which for 3'-PAM enzymes is simply ascending packed-sequence order. This is
exactly the order FlashFry's traversers visit targets (bins in
BaseCombinationGenerator order, within-bin sorted by sequence —
BlockReader.scala:104, DatabaseWriter.scala:78), so off-target output
ordering and overflow semantics are preserved.

Duplicate sequences are merged with their position lists concatenated, count
saturating at Short.MaxValue and the position list capped to the same
(BlockReader.scala:147-153).

The sidecar text header keeps FlashFry's `.header` line format
(BinaryHeader.scala:69-97) for inspection and parity tests.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import zipfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import native
from .bitcoding import BitEncoding, STRING_MASK, all_bins
from .discovery import DiscoveredSites, find_target_sites
from .positions import BitPosition
from .standards import ParameterPack, index_to_parameter_pack, parameter_pack_to_index

MAGIC_NUMBER = 0x1234ABCDE123890  # BinaryConstants.scala:24
VERSION = 1
SHORT_MAX = 32767
DEFAULT_BIN_WIDTH = 7  # BuildOffTargetDatabase.scala:53-55 (--binSize default)
HEADER_EXTENSION = ".header"


@dataclass
class Database:
    pack: ParameterPack
    bin_width: int
    targets: np.ndarray       # uint64[N]
    positions: np.ndarray     # uint64[M]
    pos_offsets: np.ndarray   # int64[N+1]
    bin_start: np.ndarray     # int64[4^w + 1]
    contig_names: List[str]   # registration order (1-based ids)

    @property
    def num_targets(self) -> int:
        return int(self.targets.shape[0])

    @property
    def num_bins(self) -> int:
        return 4 ** self.bin_width

    def bit_position(self) -> BitPosition:
        bp = BitPosition()
        for name in self.contig_names:
            bp.add_reference(name)
        return bp

    def bit_encoding(self) -> BitEncoding:
        return BitEncoding(self.pack)

    def bin_target_counts(self) -> np.ndarray:
        return np.diff(self.bin_start)

    def sequence_counts(self) -> np.ndarray:
        """In-genome occurrence count per target (high 16 bits)."""
        return (self.targets >> np.uint64(48)).astype(np.int64)


def build_database_from_sites(sites: DiscoveredSites, bin_width: int = DEFAULT_BIN_WIDTH,
                              max_positions_per_target: int = SHORT_MAX) -> Database:
    """Sort, dedup and bin discovered sites into a Database.

    Replicates BlockReader.loadBlock's sort/merge semantics
    (BlockReader.scala:87-135) applied globally.
    """
    pack = sites.pack
    enc = BitEncoding(pack)
    n = len(sites)

    seqs = sites.sequences & STRING_MASK  # strip the per-site count of 1
    bin_idx = enc.bin_index_of_targets(seqs, bin_width)

    built = native.build_index(seqs, bin_idx, sites.contig_ids, sites.positions,
                               sites.forward, pack.total_scan_length,
                               4 ** bin_width, max_positions_per_target)
    if built is not None:
        targets, positions, pos_offsets, bin_start = built
        return Database(
            pack=pack,
            bin_width=bin_width,
            targets=targets,
            positions=positions,
            pos_offsets=pos_offsets,
            bin_start=bin_start,
            contig_names=sites.contig_names,
        )

    pos_longs = sites.position_longs()

    # global scan order: (bin, full sequence); stable so that equal sequences
    # keep their discovery order, which fixes position-list ordering
    order = np.lexsort((seqs, bin_idx))
    seqs_sorted = seqs[order]
    pos_sorted = pos_longs[order]
    bins_sorted = bin_idx[order]

    # group identical sequences
    if n > 0:
        new_group = np.concatenate([[True], seqs_sorted[1:] != seqs_sorted[:-1]])
    else:
        new_group = np.zeros(0, dtype=bool)
    group_ids = np.cumsum(new_group) - 1
    num_groups = int(group_ids[-1]) + 1 if n > 0 else 0

    group_sizes = np.bincount(group_ids, minlength=num_groups).astype(np.int64)
    counts = np.minimum(group_sizes, max_positions_per_target)

    group_first = np.nonzero(new_group)[0]
    uniq_seqs = seqs_sorted[group_first]
    uniq_bins = bins_sorted[group_first]

    # cap position lists at max_positions_per_target (BlockReader.scala:153)
    if n > 0:
        rank_within = np.arange(n) - np.repeat(group_first, group_sizes)
        keep = rank_within < max_positions_per_target
        positions = pos_sorted[keep]
    else:
        positions = pos_sorted

    pos_offsets = np.zeros(num_groups + 1, dtype=np.int64)
    np.cumsum(counts, out=pos_offsets[1:])

    targets = uniq_seqs | (counts.astype(np.uint64) << np.uint64(48))

    num_bins = 4 ** bin_width
    bin_counts = np.bincount(uniq_bins, minlength=num_bins).astype(np.int64)
    bin_start = np.zeros(num_bins + 1, dtype=np.int64)
    np.cumsum(bin_counts, out=bin_start[1:])

    return Database(
        pack=pack,
        bin_width=bin_width,
        targets=targets.astype(np.uint64),
        positions=positions.astype(np.uint64),
        pos_offsets=pos_offsets,
        bin_start=bin_start,
        contig_names=sites.contig_names,
    )


def build_database(fasta_path: str, pack: ParameterPack,
                   bin_width: int = DEFAULT_BIN_WIDTH) -> Database:
    from .utils import iterate_fasta
    sites = find_target_sites(iterate_fasta(fasta_path), pack)
    return build_database_from_sites(sites, bin_width)


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def save_database(db: Database, path: str, compressed: bool = False) -> None:
    """Write the database (single .npz-format file at exactly `path`) plus a
    FlashFry-style text sidecar header at `path + ".header"`.

    Uncompressed by default: members of a stored (uncompressed) zip are
    contiguous on disk, so load_database can memory-map every array for
    instant, lazy loading — the discover phase then pages straight from the
    file into the device-upload path."""
    meta = {
        "magic": MAGIC_NUMBER,
        "version": VERSION,
        "enzyme_index": parameter_pack_to_index(db.pack),
        "bin_width": db.bin_width,
        "contigs": db.contig_names,
    }
    writer = np.savez_compressed if compressed else np.savez
    with open(path, "wb") as fh:
        writer(
            fh,
            targets=db.targets,
            positions=db.positions,
            pos_offsets=db.pos_offsets,
            bin_start=db.bin_start,
            meta=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
        )
    write_text_header(db, path + HEADER_EXTENSION)


def _read_array_header(fh, version):
    """numpy's private .npy header reader: numpy.lib.format holds it before
    numpy 2.1, numpy.lib._format_impl from 2.1 on."""
    read = getattr(np.lib.format, "_read_array_header", None)
    if read is None:
        read = importlib.import_module("numpy.lib._format_impl")._read_array_header
    return read(fh, version)


def _memmap_npz_members(path: str) -> Optional[Dict[str, np.ndarray]]:
    """Memory-map every member of an UNCOMPRESSED npz. Returns None when any
    member is deflated (falls back to np.load) or the npy header is exotic."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as fh:
        try:
            zf = zipfile.ZipFile(fh)
        except zipfile.BadZipFile:
            return None
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                return None
            # local file header: 30 fixed bytes + name + extra (lengths in
            # the LOCAL header can differ from the central directory's)
            fh.seek(info.header_offset)
            lh = fh.read(30)
            if lh[:4] != b"PK\x03\x04":
                return None
            name_len = int.from_bytes(lh[26:28], "little")
            extra_len = int.from_bytes(lh[28:30], "little")
            data_off = info.header_offset + 30 + name_len + extra_len
            fh.seek(data_off)
            try:
                version = np.lib.format.read_magic(fh)
                shape, fortran, dtype = _read_array_header(fh, version)
            except (ValueError, KeyError):
                return None
            if fortran or dtype.hasobject:
                return None
            key = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            out[key] = np.memmap(path, dtype=dtype, mode="r",
                                 offset=fh.tell(), shape=shape)
    return out


def write_text_header(db: Database, header_path: str) -> None:
    """FlashFry-compatible header lines (BinaryHeader.scala:69-97).

    blockPosition is re-purposed as the target start index of the bin and
    uncompressedSize as 8 bytes x (targets + positions) in the bin, keeping
    the same "offset,size,count" semantics over our columnar layout.
    """
    bins = all_bins(db.bin_width)
    with open(header_path, "w") as out:
        out.write(str(MAGIC_NUMBER) + "\n")
        out.write(str(VERSION) + "\n")
        out.write(str(parameter_pack_to_index(db.pack)) + "\n")
        out.write(str(4 ** db.bin_width) + "\n")
        bs = db.bin_start
        po = db.pos_offsets
        for i, b in enumerate(bins):
            t0, t1 = int(bs[i]), int(bs[i + 1])
            n_longs = (t1 - t0) + int(po[t1] - po[t0])
            out.write("%s=%d,%d,%d\n" % (b, t0, n_longs * 8, t1 - t0))
        for idx, name in enumerate(db.contig_names, start=1):
            out.write("%s=%d\n" % (name, idx))


def load_database(path: str) -> Database:
    # auto-detect a reference-format (BGZF) database: FlashFry users can
    # point discover/score/extract at their existing files unchanged
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        from .ffformat import import_flashfry_database
        return import_flashfry_database(path)
    arrays = _memmap_npz_members(path)
    if arrays is None:  # compressed / legacy file
        with np.load(path, allow_pickle=False) as data:
            arrays = {k: data[k] for k in
                      ("targets", "positions", "pos_offsets", "bin_start", "meta")}
    meta = json.loads(bytes(arrays["meta"]).decode("utf-8"))
    if meta["magic"] != MAGIC_NUMBER:
        raise ValueError("Database %s doesn't have the magic number expected" % path)
    if meta["version"] != VERSION:
        raise ValueError("Database %s has version %s, expected %d" % (path, meta["version"], VERSION))
    return Database(
        pack=index_to_parameter_pack(meta["enzyme_index"]),
        bin_width=meta["bin_width"],
        targets=arrays["targets"].view(np.uint64),
        positions=arrays["positions"].view(np.uint64),
        pos_offsets=np.asarray(arrays["pos_offsets"]),
        bin_start=np.asarray(arrays["bin_start"]),
        contig_names=list(meta["contigs"]),
    )
