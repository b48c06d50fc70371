"""Enzymes as the configurations state them, and the PAM scan.

An enzyme is its forward window pattern over A, C, G, T and N (N: any
base), the window positions compared for mismatches, and the bin over
which FlashFry orders its targets (the bin_width bases from bin_start).
A window is a site on the forward strand when it matches the pattern, and
on the reverse strand when it matches the pattern's reverse complement, in
which case the site's sequence is the window's reverse complement. Only
windows of A, C, G and T count. Codes: A=0, C=1, G=2, T=3, anything else 4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}

# ASCII -> base code, anything but ACGTacgt -> 4
ASCII_CODES = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    ASCII_CODES[_b] = _i
    ASCII_CODES[ord(chr(_b).lower())] = _i


@dataclass(frozen=True)
class Enzyme:
    pattern: str                  # forward window, e.g. 21 N then GG
    compared: Tuple[int, ...]     # window positions counted as mismatches
    bin_start: int                # first base of the ordering bin
    bin_width: int

    @property
    def length(self) -> int:
        return len(self.pattern)

    @property
    def reverse_pattern(self) -> str:
        return "".join(COMPLEMENT[c] for c in reversed(self.pattern))


def enzyme_of(config: dict) -> Enzyme:
    e = config["enzyme"]
    return Enzyme(pattern=e["window_pattern"],
                  compared=tuple(e["compared_positions"]),
                  bin_start=int(e["bin_start"]),
                  bin_width=int(config["bin_width"]))


def site_starts(codes: torch.Tensor, pattern: str) -> torch.Tensor:
    """Ascending starts (int64) of the windows of `codes` (uint8) that match
    `pattern` and hold only A, C, G and T."""
    L = len(pattern)
    n = codes.numel() - L + 1
    if n <= 0:
        return torch.zeros(0, dtype=torch.int64, device=codes.device)
    ok = torch.ones(n, dtype=torch.bool, device=codes.device)
    for off, ch in enumerate(pattern):
        if ch != "N":
            ok &= codes[off:off + n] == CODE[ch]
    bad = codes > 3
    if bool(bad.any()):
        cum = torch.zeros(codes.numel() + 1, dtype=torch.int64, device=codes.device)
        torch.cumsum(bad, 0, out=cum[1:])
        ok &= (cum[L:L + n] - cum[:n]) == 0
    return torch.nonzero(ok).squeeze(1)


def strand_sites(codes: torch.Tensor, enzyme: Enzyme) -> Tuple[torch.Tensor, torch.Tensor]:
    """(forward starts, reverse starts) of every site in `codes`."""
    return (site_starts(codes, enzyme.pattern),
            site_starts(codes, enzyme.reverse_pattern))
