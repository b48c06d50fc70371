"""The work the inputs need, and the chip's peaks: the yardstick of the
roofline shares.

Stage 1 of a discover job compares each of the job's G guide sites with
each of the database's N targets at the enzyme's n_act compared positions,
as a product of one-hots over 4 bases: 2 * (4 * n_act) * G * N int8
operations. It reads the L code bytes of each target once and writes one
hit byte per target. G and N are real counts (the reference's rows of the
job and its distinct targets), never a kernel's padded rows or columns, so
removing padding shows as a gain and no implementation of stage 1 moves
this count.
"""

from __future__ import annotations

from typing import Optional, Tuple

# NVIDIA's data sheet, H100 SXM5, dense: int8 tensor-core operations per
# second, HBM3 bytes per second (at the card's full 700 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1979e12, "bytes_per_s": 3.35e12},
}


def stage1_work(guides: int, n_targets: int, n_act: int, length: int
                ) -> Tuple[float, float]:
    """(int8 operations, bytes) stage 1 needs for one job."""
    ops = 2.0 * (4 * n_act) * guides * n_targets
    moved = float(n_targets) * (length + 1)
    return ops, moved


def bound_seconds(ops: float, moved: float, device_kind: str) -> Optional[float]:
    """The least time the chip could take, or None for a chip without peaks."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        return None
    return max(ops / peak["int8_ops_per_s"], moved / peak["bytes_per_s"])
