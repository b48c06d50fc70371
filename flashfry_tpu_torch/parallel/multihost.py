"""Discover over several processes: the sharded scan with a gloo gather.

Counterpart of flashfry_tpu/parallel/multihost.py. Every process runs the
same scan over one global (db, guides) mesh whose db axis is process-major:
process p holds db rows [p * local_db, (p + 1) * local_db) on its own
devices, the guides axis stays inside a process, and each process builds
the planes of its own shards only, reading just their target range from the
memory-mapped database. Per guide block, each process scans its shards
(stage 1 on its own devices) and the hits it has fetched are exchanged with
torch.distributed's gloo backend: first every process's hit count, then
the hits, padded to the largest count. Concatenated in rank order they are
in ascending global target order, so every process yields the same global
hits in the order a one-process scan yields them.

gloo, because what is exchanged is host memory (hits the scan has already
fetched), and because NCCL cannot put two ranks on one card: with gloo, the
path the CPU tests run is the path the cards run.

    python -m flashfry_tpu_torch.parallel.multihost --coordinator HOST:PORT \\
        --numProcesses 2 --processId {0,1} --database DB --guides G.npz \\
        [--output HITS.npz] [--maxMismatch 4] [--device {cuda,cpu}]

runs one process of such a scan (the same command once per process);
process 0 writes the hits to --output as .npz with `hits`, (n, 3) int64
rows of (target, guide, mm).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import DEVICES
from .mesh import DeviceLike, Mesh, ShardedScanner, make_mesh, pick_devices

logger = logging.getLogger("flashfry_tpu_torch.multihost")

TIMEOUT_S = 600  # a collective that waits longer (a lost process) raises


def initialize(coordinator: str, num_processes: int, process_id: int) -> bool:
    """Join the gloo process group at tcp://coordinator (host:port, served
    by process 0) unless one exists; returns whether it was created here."""
    if dist.is_initialized():
        return False
    dist.init_process_group("gloo", init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


@contextlib.contextmanager
def process_group(coordinator: str, num_processes: int, process_id: int):
    """initialize(...) for the body of a with statement; a group it created
    is destroyed on the way out."""
    created = initialize(coordinator, num_processes, process_id)
    try:
        yield
    finally:
        if created:
            dist.destroy_process_group()


def make_global_mesh(device: Union[DeviceLike, Sequence[DeviceLike]]) -> Mesh:
    """The (db, guides) mesh over every process's devices: this process's
    devices (pick_devices(device), or the sequence given) in a make_mesh
    grid, its rows at [rank * local_db, (rank + 1) * local_db) of the db
    axis, the other processes' rows None. Every process must bring a grid
    of the same shape."""
    local = make_mesh(pick_devices(device) if isinstance(device, (str, torch.device))
                      else device)
    world, rank = dist.get_world_size(), dist.get_rank()
    shapes = [torch.zeros(2, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(shapes, torch.tensor([len(local), len(local[0])]))
    if any(not torch.equal(s, shapes[rank]) for s in shapes):
        raise ValueError("processes bring device grids of different shapes: %s"
                         % [tuple(s.tolist()) for s in shapes])
    blank = ((None,) * len(local[0]),) * len(local)
    return sum((local if p == rank else blank for p in range(world)), ())


class MultiHostScanner(ShardedScanner):
    """ShardedScanner over a make_global_mesh grid: this process builds and
    scans the db rows whose devices it holds, and every guide block's hits
    are gathered from all processes, so scan() yields the global hits on
    every process.

    dcn_allgather_bytes and dcn_allgather_calls count, as flashfry_tpu's
    counters of the same names do, every byte each all_gather returns, this
    process's own share included, and each all_gather call: two per guide
    block (the counts, then the hits padded to the largest count; the
    second is skipped when no process has a hit)."""

    dcn_allgather_bytes = 0
    dcn_allgather_calls = 0

    def _local_rows(self):
        """The db rows of this process: [rank * local_db, (rank + 1) *
        local_db), the rows whose devices the mesh names."""
        world, rank = dist.get_world_size(), dist.get_rank()
        local_db = self.D // world
        rows = [s for s, row in enumerate(self.mesh) if row[0] is not None]
        if self.D % world or rows != list(range(rank * local_db, (rank + 1) * local_db)):
            raise ValueError("process %d of %d does not hold db rows %d..%d of "
                             "the mesh (it holds %s)" % (rank, world, rank * local_db,
                                                         (rank + 1) * local_db - 1, rows))
        return rows

    def _gather(self, t: torch.Tensor):
        """all_gather of a CPU tensor of the same shape on every process;
        counted."""
        out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(out, t)
        self.dcn_allgather_bytes += sum(o.numel() * o.element_size() for o in out)
        self.dcn_allgather_calls += 1
        return out

    def _merge(self, local: Iterator) -> Iterator:
        """This process's hits of one block, in (s, q) order -> every
        process's, in rank order: (target, guide << 8 | mm) int64 rows
        padded to the largest count."""
        parts = [b for batches in local for b in batches]
        if parts:
            t, g, m = (np.concatenate(a) for a in zip(*parts))
            rows = np.stack([t, g << 8 | m.astype(np.int64)], axis=1)
        else:
            rows = np.zeros((0, 2), dtype=np.int64)
        counts = [int(c) for c in self._gather(torch.tensor([rows.shape[0]]))]
        if max(counts) == 0:
            return
        buf = torch.zeros((max(counts), 2), dtype=torch.int64)
        buf[:rows.shape[0]] = torch.from_numpy(rows)
        got = np.concatenate([o[:c].numpy() for o, c in zip(self._gather(buf), counts)])
        yield got[:, 0], got[:, 1] >> 8, (got[:, 1] & 0xFF).astype(np.int8)


def run_worker(coordinator: str, num_processes: int, process_id: int,
               db_path: str, guides_path: str, out_path: Optional[str],
               max_mismatch: int = 4, device: str = "cuda") -> np.ndarray:
    """One process of a multi-process scan: join the group, load the
    database (memory-mapped: this process reads only its shards' targets),
    scan the .npz's `guides` on `device`, and return the global (target,
    guide, mm) hit rows, the same on every process. Process 0 writes them
    to out_path (.npz, `hits`) when one is given."""
    from ..database import load_database
    with process_group(coordinator, num_processes, process_id):
        db = load_database(db_path)
        guides = np.load(guides_path)["guides"].astype(np.uint64)
        scanner = MultiHostScanner(db, mesh=make_global_mesh(device))
        batches = list(scanner.scan(guides, max_mismatch))
        hits = (np.column_stack([np.concatenate(a).astype(np.int64) for a in zip(*batches)])
                if batches else np.zeros((0, 3), dtype=np.int64))
        logger.info("process %d of %d: %d hit rows; gathered %d bytes in %d calls",
                    process_id, num_processes, hits.shape[0],
                    scanner.dcn_allgather_bytes, scanner.dcn_allgather_calls)
        if out_path and dist.get_rank() == 0:
            np.savez(out_path, hits=hits)
        return hits


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="one process of a multi-process scan")
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--numProcesses", type=int, required=True)
    ap.add_argument("--processId", type=int, required=True)
    ap.add_argument("--database", required=True)
    ap.add_argument("--guides", required=True, help=".npz with a 'guides' uint64 array")
    ap.add_argument("--output", default=None)
    ap.add_argument("--maxMismatch", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="this process's devices: every visible card, or the CPU")
    a = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s - %(message)s")
    run_worker(a.coordinator, a.numProcesses, a.processId, a.database,
               a.guides, a.output, a.maxMismatch, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
