"""Enzyme parameter packs.

TPU-native re-design of the reference's enzyme definitions
(reference: src/main/scala/standards/StandardScanParameters.scala:28-215 and
src/main/scala/standards/Enzyme.scala). Each pack carries the PAM set, scan
length, 5'/3' PAM orientation, the 48-bit comparison mask that excludes PAM
bases from mismatch counting, and — instead of the reference's scanning
regexes — declarative PAM patterns consumed by the vectorized site scanner
(flashfry_tpu.discovery).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

CAS9_SCAN_LENGTH_20MER = 23
CAS9_SCAN_LENGTH_19MER = 22
CAS9_PAM_LENGTH = 3
CPF1_SCAN_LENGTH = 24
CPF1_PAM_LENGTH = 4


@dataclass(frozen=True)
class ParameterPack:
    """All the details about an enzyme's scanning/comparison geometry.

    Mirrors the contract of the reference ParameterPack trait
    (StandardScanParameters.scala:28-48).

    ``fwd_pam_patterns`` / ``rev_pam_patterns`` replace the reference's
    lookahead regexes (e.g. Cas9ParameterPack.fwdRegex at
    StandardScanParameters.scala:104-106): each is an IUPAC-ish pattern the
    scanner matches at a fixed offset inside the ``total_scan_length`` window.
    A window is a site iff all non-N pattern bases match and every base in the
    window is one of ACGT (the reference regexes admit only ACGT).
    """

    name: str
    enzyme_family: str  # "cas9" | "cpf1"
    index: int  # reference's enzyme index (StandardScanParameters.scala:61-69)
    pam: Tuple[str, ...]
    padded_pam: Tuple[str, ...]
    pam_length: int
    total_scan_length: int
    comparison_bit_encoding: int
    five_prime_pam: bool
    guide_range: Tuple[int, int]

    @property
    def guide_length(self) -> int:
        return self.guide_range[1] - self.guide_range[0]

    @property
    def fwd_pam_patterns(self) -> Tuple[str, ...]:
        """PAM patterns on the forward strand, positioned within the window."""
        if self.five_prime_pam:
            # e.g. Cpf1 fwd: TTT at window start (TTTN pam)
            return tuple(p for p in self.pam)
        # 3' PAM: pattern sits at the window end (e.g. [AG]G at positions L-2..L-1)
        return tuple(p for p in self.pam)

    def comparison_mask_positions(self) -> Tuple[int, ...]:
        """Base positions (0-based, 5'→3' in the scanned window) that take part
        in mismatch counting, derived from comparison_bit_encoding.

        Base i (string order) occupies bits [2*(L-1-i), 2*(L-1-i)+1] of the
        packed encoding (BitEncoding.scala:50-63 shifts left per char).
        """
        L = self.total_scan_length
        out = []
        for i in range(L):
            shift = 2 * (L - 1 - i)
            if (self.comparison_bit_encoding >> shift) & 0x3:
                out.append(i)
        return tuple(out)


Cas9ParameterPack = ParameterPack(
    name="SPCAS9",
    enzyme_family="cas9",
    index=2,
    pam=("GG", "AG"),
    padded_pam=("NGG", "NAG"),
    pam_length=CAS9_PAM_LENGTH,
    total_scan_length=CAS9_SCAN_LENGTH_20MER,
    comparison_bit_encoding=0x3FFFFFFFFFC0,
    five_prime_pam=False,
    guide_range=(0, CAS9_SCAN_LENGTH_20MER - CAS9_PAM_LENGTH),
)

Cas9ParameterPack19bp = ParameterPack(
    name="SPCAS919",
    enzyme_family="cas9",
    index=5,
    pam=("GG", "AG"),
    padded_pam=("NGG", "NAG"),
    pam_length=CAS9_PAM_LENGTH,
    total_scan_length=CAS9_SCAN_LENGTH_19MER,
    comparison_bit_encoding=0x0FFFFFFFFFC0,
    five_prime_pam=False,
    guide_range=(0, CAS9_SCAN_LENGTH_19MER - CAS9_PAM_LENGTH),
)

Cas9NGGParameterPack = ParameterPack(
    name="SPCAS9NGG",
    enzyme_family="cas9",
    index=3,
    pam=("GG",),
    padded_pam=("NGG",),
    pam_length=CAS9_PAM_LENGTH,
    total_scan_length=CAS9_SCAN_LENGTH_20MER,
    comparison_bit_encoding=0x3FFFFFFFFFC0,
    five_prime_pam=False,
    guide_range=(0, CAS9_SCAN_LENGTH_20MER - CAS9_PAM_LENGTH),
)

Cas9NGG19ParameterPack = ParameterPack(
    name="SPCAS9NGG19",
    enzyme_family="cas9",
    index=6,
    pam=("GG",),
    padded_pam=("NGG",),
    pam_length=CAS9_PAM_LENGTH,
    total_scan_length=CAS9_SCAN_LENGTH_19MER,
    comparison_bit_encoding=0x0FFFFFFFFFC0,
    five_prime_pam=False,
    guide_range=(0, CAS9_SCAN_LENGTH_19MER - CAS9_PAM_LENGTH),
)

Cas9NAGParameterPack = ParameterPack(
    name="SPCAS9NAG",
    enzyme_family="cas9",
    index=4,
    pam=("AG",),
    padded_pam=("NAG",),
    pam_length=CAS9_PAM_LENGTH,
    total_scan_length=CAS9_SCAN_LENGTH_20MER,
    comparison_bit_encoding=0x3FFFFFFFFFC0,
    five_prime_pam=False,
    guide_range=(0, CAS9_SCAN_LENGTH_20MER - CAS9_PAM_LENGTH),
)

Cpf1ParameterPack = ParameterPack(
    name="CPF1",
    enzyme_family="cpf1",
    index=1,
    pam=("TTT",),
    padded_pam=("TTTN",),
    pam_length=CPF1_PAM_LENGTH,
    total_scan_length=CPF1_SCAN_LENGTH,
    comparison_bit_encoding=0x00FFFFFFFFFF,
    five_prime_pam=True,
    guide_range=(CPF1_PAM_LENGTH, CPF1_SCAN_LENGTH),
)

_NAME_TO_PACK = {
    "CPF1": Cpf1ParameterPack,
    "SPCAS9": Cas9ParameterPack,
    "SPCAS9NGG": Cas9NGGParameterPack,
    "SPCAS9NAG": Cas9NAGParameterPack,
    "SPCAS919": Cas9ParameterPack19bp,
    "SPCAS9NGG19": Cas9NGG19ParameterPack,
}

_INDEX_TO_PACK = {p.index: p for p in _NAME_TO_PACK.values()}


def name_to_parameter_pack(name: str) -> ParameterPack:
    """Registry lookup by CLI name (StandardScanParameters.scala:51-59)."""
    key = name.upper()
    if key not in _NAME_TO_PACK:
        raise ValueError("Unable to find the correct parameter pack for enzyme: " + name)
    return _NAME_TO_PACK[key]


def index_to_parameter_pack(index: int) -> ParameterPack:
    """Registry lookup by persisted enzyme index (StandardScanParameters.scala:61-69)."""
    if index not in _INDEX_TO_PACK:
        raise ValueError("Unable to find the correct parameter pack for enzyme: %d" % index)
    return _INDEX_TO_PACK[index]


def parameter_pack_to_index(pack: ParameterPack) -> int:
    return pack.index
