"""Random guide FASTA generation (the `random` CLI module).

Counterpart of modules/GenerateRandomFasta.scala:70-124 and
utils/RandoCRISPR.scala (random / IUPAC-patterned draws, memory slots with
optional reverse-complement references like ``N1`` / ``N1-``).
"""

from __future__ import annotations

import random
import re
from typing import Dict, List, Optional, Tuple

from .discovery import _pam_window_patterns, _scan_codes
from .standards import name_to_parameter_pack
from .utils import comp_base

_IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T",
    "R": "AG", "Y": "CT", "K": "GT", "M": "AC", "S": "CG", "W": "AT",
    "B": "CGT", "D": "AGT", "H": "AAT",  # H matches the reference's (A,A,T) draw
    "V": "ACG", "N": "ACGT",
}


class RandoCRISPR:
    """Random target generator (utils/RandoCRISPR.scala:25-81)."""

    def __init__(self, size: int, pams, pam_five_prime: bool,
                 string_prefix: str = "", random_front: int = 0,
                 random_rear: int = 0, pattern: Optional[str] = None,
                 rng: Optional[random.Random] = None):
        self.size = size
        self.pams = list(pams)
        self.pam_five_prime = pam_five_prime
        self.string_prefix = string_prefix
        self.random_front = random_front
        self.random_rear = random_rear
        self.pattern = pattern
        self.r = rng or random.Random()

    def _random_string(self, n: int) -> str:
        return "".join(self.r.choice("ACGT") for _ in range(n))

    def _draw_iupac(self, base: str) -> str:
        if base not in _IUPAC:
            raise ValueError("Unknown or not allowed FASTA character: " + base)
        return self.r.choice(_IUPAC[base])

    def _patterned_draw(self, pattern: str, set_length: int) -> str:
        """IUPAC pattern with memory slots (utils/RandoCRISPR.scala:112-146):
        tokens like 'N1' remember the drawn base, 'N1-' emits its complement."""
        tokens = pattern.split(",")
        assert len(tokens) == set_length, \
            "We're seeing an unexpected pattern length: %d; expected %d" % (len(tokens), set_length)
        memories: Dict[int, Tuple[str, str]] = {}
        out = []
        for index, token in enumerate(tokens):
            if len(token) == 1:
                out.append(self._draw_iupac(token))
            else:
                if token[-1] == "-":
                    slot, rc = int(token[1:-1]), True
                else:
                    slot, rc = int(token[1:]), False
                base_pattern = token[0]
                if slot in memories:
                    assert memories[slot][0] == base_pattern, \
                        "Mismatched assignments of memory base at position %d" % index
                    drawn = memories[slot][1]
                    out.append(comp_base(drawn) if rc else drawn)
                else:
                    assert not rc, "We dont have a memory of the parent, so we can't complement: " + token
                    drawn = self._draw_iupac(base_pattern)
                    memories[slot] = (base_pattern, drawn)
                    out.append(drawn)
        return "".join(out)

    def next(self):
        front = self._random_string(self.random_front)
        rear = self._random_string(self.random_rear)
        pam = "".join(self.r.choice("ACGT") if b == "N" else b
                      for b in self.r.choice(self.pams))
        if self.pattern is not None:
            guide = self._patterned_draw(self.pattern, self.size)
        else:
            guide = self._random_string(self.size - len(self.string_prefix))
        if self.pam_five_prime:
            full = front + pam + self.string_prefix + guide + rear
        else:
            full = front + self.string_prefix + guide + pam + rear
        return guide, full


def count_sites(full_target: str, pack) -> int:
    """Number of scan-pattern matches in both orientations, mirroring the
    onlyUnidirectional filter (GenerateRandomFasta.scala:101-103)."""
    import numpy as np

    from .bitcoding import _BASE_LUT
    codes = _BASE_LUT[np.frombuffer(full_target.encode("ascii"), dtype=np.uint8)]
    fwd_pats, rev_pats = _pam_window_patterns(pack)
    L = pack.total_scan_length
    return (_scan_codes(codes, fwd_pats, L).size + _scan_codes(codes, rev_pats, L).size)


def generate_random_fasta(args) -> None:
    """The `random` CLI command (GenerateRandomFasta.scala:70-124)."""
    pack = name_to_parameter_pack(args.enzyme)
    rng = random.Random(args.seed) if args.seed is not None else random.Random()
    maker = RandoCRISPR(
        pack.total_scan_length - pack.pam_length,
        pack.padded_pam,
        pack.five_prime_pam,
        "",
        args.sequenceContextLeft,
        args.sequenceContextRight,
        args.patterned if args.patterned else None,
        rng=rng,
    )
    sequences: Dict[str, List[str]] = {}
    total = 0
    successive_failures = 0
    while (len(sequences) < args.randomCount and
           successive_failures <= args.maxSuccessiveDesignFailures):
        guide, full = maker.next()
        if guide not in sequences or args.duplicatesAllowed:
            if not args.onlyUnidirectional or count_sites(full, pack) == 1:
                sequences.setdefault(guide, []).append(full)
            successive_failures = 0
        else:
            successive_failures += 1

    with open(args.outputFile, "w") as out:
        for guide, full_targets in sequences.items():
            for full in full_targets:
                out.write(">" + args.namePrefix + full + "\n" + full + "\n")
