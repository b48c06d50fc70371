"""The scan sharded over several devices: a (db, guides) grid.

Counterpart of flashfry_tpu/parallel/mesh.py. The database's targets are
split over the "db" axis into contiguous, ascending shards; each guide
block is split over the "guides" axis into sub-blocks. Device (s, q) holds
shard s's (32, shard_n) planes, built on (s, 0) by the one-device plane
build (ops.scan.fill_planes, with no closing wait) and copied to each
q > 0, and scans sub-block q against them with the one-device scan's two
halves (ops.scan.launch_block, then ops.scan.collect_block): stage 1 is
launched on every (s, q) before
any hit count is read, then the hits are collected shard by shard, s
ascending and q ascending within a shard. Shards are ascending target
ranges and each yields its hits target-major, so per guide the hits arrive
in global target order, the order the overflow cap needs.

A device may appear more than once: ["cpu"] * 8 is the CPU tests' virtual
mesh, ["cuda:0"] * 4 one card's. JAX's jitted shard_map step, its fixed
caps with escalation, retries and host fallback, and its count-first
sliced fetch have no counterpart: each shard's scan counts first and
allocates exactly, as the one-device scan does.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..database import Database
from ..device import resolve_device
from ..ops.scan import (CODE_ROWS, collect_block, device_plane_codes,
                        guide_block_rows, interleaved_blocks, launch_block,
                        scan_reserve_bytes)

DeviceLike = Union[str, torch.device]
Mesh = Tuple[Tuple[Optional[torch.device], ...], ...]


def pick_devices(device: DeviceLike = "cuda") -> List[torch.device]:
    """The devices a name stands for: every visible card for a bare "cuda",
    else the one device named. A missing card raises, as
    device.resolve_device does."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(devices: Sequence[DeviceLike]) -> Mesh:
    """The (db, guides) grid of the devices, row-major: the guides axis is 2
    when the count is even and at least 2, else 1, as in flashfry_tpu."""
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    gx = 2 if len(devs) % 2 == 0 else 1
    return tuple(tuple(devs[s:s + gx]) for s in range(0, len(devs), gx))


def device_free_bytes(dev: torch.device) -> Optional[int]:
    """A card's free memory; None on the CPU, where no limit is checked."""
    if dev.type != "cuda":
        return None
    return torch.cuda.mem_get_info(dev)[0]


class ShardedScanner:
    """Holds one database sharded over a (db, guides) mesh and scans guide
    batches against it (DeviceScanner.scan's interface).

    mesh: a make_mesh grid; without one, make_mesh(devices), and without
    devices every visible card (pick_devices("cuda")). All its devices have
    one type. Shard s owns the global targets [s * shard_n, (s + 1) *
    shard_n), shard_n = ceil(n / D); its planes are built on (s, 0)'s
    device from that range only (ops.scan.device_plane_codes), PAD_CODE
    past its last target, and copied device to device to each (s, q > 0):
    each (s, q) holds its own. The constructor makes no closing wait: a
    card's scan is ordered after its build on the card's stream. A shard
    whose planes exceed its card's free memory less the scan's reserve
    raises ValueError: there is no sharded streaming and no fallback.
    """

    def __init__(self, db: Database, devices: Optional[Sequence[DeviceLike]] = None,
                 mesh: Optional[Mesh] = None):
        if mesh is None:
            mesh = make_mesh(pick_devices("cuda") if devices is None else devices)
        self.db = db
        self.mesh = mesh
        self.D, self.Gx = len(mesh), len(mesh[0])
        self.n = db.num_targets
        self.shard_n = -(-max(self.n, 1) // self.D)
        self.rows = self._local_rows()
        types = {dev.type for s in self.rows for dev in mesh[s]}
        if len(types) != 1:
            raise ValueError("a mesh's devices must have one type, got %s"
                             % sorted(types))
        self.device_type = types.pop()
        self.planes: Dict[Tuple[int, int], torch.Tensor] = {}
        per_device: Dict[torch.device, int] = {}
        for s in self.rows:
            for dev in mesh[s]:
                per_device[dev] = per_device.get(dev, 0) + 1
        for s in self.rows:
            lo = s * self.shard_n
            for q, dev in enumerate(mesh[s]):
                free = device_free_bytes(dev)
                need = CODE_ROWS * self.shard_n
                # every launch of a block on dev holds its hit bytes at once
                reserve = scan_reserve_bytes(per_device[dev] * self.shard_n)
                if free is not None and need > free - reserve:
                    raise ValueError(
                        "shard %d's planes need %d bytes; %s has %d free, less "
                        "a reserve of %d for the scan" % (s, need, dev, free, reserve))
                if q:  # replicated over the guides axis: a copy of (s, 0)'s
                    self.planes[s, q] = self.planes[s, 0].to(dev, copy=True)
                else:
                    self.planes[s, q] = device_plane_codes(
                        db.targets[lo:lo + self.shard_n], db.pack.total_scan_length,
                        self.shard_n, dev)

    def _local_rows(self) -> List[int]:
        """The db rows whose planes this process builds and scans: all."""
        if any(dev is None for row in self.mesh for dev in row):
            raise ValueError("a ShardedScanner's mesh names every device")
        return list(range(self.D))

    def shard_valid(self, s: int) -> int:
        """The number of real targets in shard s."""
        return max(0, min(self.shard_n, self.n - s * self.shard_n))

    def block_rows(self, n_guides: int) -> int:
        """Rows of each guide block: Gx sub-blocks of guide_block_rows(the
        sub-block's share), 128 x Gx doubled while below n_guides and below
        MAX_GUIDE_ROWS x Gx, as flashfry_tpu's sharded scan sizes them."""
        return self.Gx * guide_block_rows(-(-n_guides // self.Gx))

    def scan(self, guide_longs: np.ndarray, max_mismatch: int,
             bin_mask: Optional[np.ndarray] = None,
             stats=None) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (target_idx int64, guide_idx int64, mm int8) batches; within
        each guide, hits arrive in global target order. bin_mask is ignored,
        as in DeviceScanner.scan.

        Guide blocks of block_rows rows are dealt round-robin
        (interleaved_blocks); sub-block q is rows [q * block / Gx, (q + 1) *
        block / Gx) of its block, padded to block / Gx rows; a sub-block
        without guides launches nothing. Stats count each block once."""
        g_all = np.asarray(guide_longs, dtype=np.uint64)
        block = self.block_rows(g_all.shape[0])
        sub = block // self.Gx
        pack = self.db.pack
        for idx in interleaved_blocks(g_all.shape[0], block):
            if not idx.size:
                continue
            if stats is not None:
                stats.all_targets += self.n
                stats.all_targets_and_positions += int(self.db.pos_offsets[-1])
                stats.dense_comparisons += self.n * idx.size
            subs = [idx[q * sub:(q + 1) * sub] for q in range(self.Gx)]
            launched = {(s, q): launch_block(self.planes[s, q], g_all[subs[q]],
                                             pack, max_mismatch, sub)
                        for s in self.rows for q in range(self.Gx) if subs[q].size}
            yield from self._merge(
                collect_block(self.planes[s, q], launched[s, q], s * self.shard_n,
                              self.shard_valid(s), subs[q], max_mismatch)
                for s, q in launched)

    def _merge(self, local: Iterator) -> Iterator:
        """One block's hits from the shards of this process, in (s, q)
        order -> the block's hits. One process holds every shard."""
        for batches in local:
            yield from batches
