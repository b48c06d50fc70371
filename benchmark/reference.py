"""Plain reference of FlashFry's `discover`, in NumPy and PyTorch.

It imports nothing of the program. From the genome's codes it finds every
site again (sites.py), and for a guide it compares the guide with every
site, position by position, over the compared positions. What FlashFry
makes of those hits, as the configuration states it:

  * a target is a distinct window sequence (PAM included); its positions
    are its sites in the genome's discovery order (forward sites
    ascending, then reverse sites ascending), at most
    `max_positions_per_target` of them, and its count is their number;
  * a guide's targets come in FlashFry's order: by the ordering bin (the
    bin_width bases from bin_start), then by the whole sequence, A < C <
    G < T;
  * the overflow cap: a target is taken while the positions taken before
    it number fewer than `maximumOffTargets`; the guide overflows when
    they reach it;
  * a row is `contig start stop target context overflow orientation
    otCount offTargets`, an off-target `SEQ_count_mm<contig:pos^F|...>`.

The job's own sites are found the same way in each FASTA record. Rows
come in the order of their start, then record, then strand (forward
first), with the window and `flankingSequence` bases each side as context
where the record holds them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .genome import ACGT, CONTIG
from .sites import Enzyme, strand_sites

HEADER = ("contig\tstart\tstop\ttarget\tcontext\toverflow\torientation\t"
          "otCount\toffTargets\n")
ORDERS = ("flashfry", "position")


def _text(codes: np.ndarray) -> str:
    return ACGT[codes].tobytes().decode("ascii")


def _packed(codes: np.ndarray) -> np.ndarray:
    """(k, L) codes -> uint64, first base most significant."""
    out = np.zeros(codes.shape[0], dtype=np.uint64)
    for j in range(codes.shape[1]):
        out = (out << np.uint64(2)) | codes[:, j].astype(np.uint64)
    return out


@dataclass
class Site:
    record: int
    start: int
    forward: bool
    codes: np.ndarray           # (L,) uint8, the site's sequence
    context: Optional[str]


class ReferenceGenome:
    """Every site of one genome, with its compared codes on `device`."""

    def __init__(self, genome: np.ndarray, enzyme: Enzyme, device,
                 max_positions: int, contig: str = CONTIG):
        self.enzyme = enzyme
        self.contig = contig
        self.max_positions = max_positions
        self.g = torch.from_numpy(np.ascontiguousarray(genome).view(np.uint8)).to(device)
        fwd, rev = strand_sites(self.g, enzyme)
        self.n_fwd = fwd.numel()
        self.starts = torch.cat([fwd, rev])
        L = enzyme.length
        self.cmp = torch.empty((len(enzyme.compared), self.starts.numel()),
                               dtype=torch.uint8, device=self.g.device)
        for k, j in enumerate(enzyme.compared):
            self.cmp[k, :self.n_fwd] = self.g[fwd + j]
            self.cmp[k, self.n_fwd:] = 3 - self.g[rev + (L - 1 - j)]

    def window_codes(self, site: torch.Tensor) -> torch.Tensor:
        """(k, L) sequences of the given sites, in site orientation."""
        L = self.enzyme.length
        ar = torch.arange(L, device=site.device)
        rev = site >= self.n_fwd
        s = self.starts[site][:, None]
        fwd_codes = self.g[s + ar[None, :]]
        rev_codes = 3 - self.g[s + (L - 1 - ar)[None, :]]
        return torch.where(rev[:, None], rev_codes, fwd_codes)

    def n_targets(self) -> int:
        """Distinct site sequences: the targets a database of this genome
        holds."""
        L = self.enzyme.length
        fwd, rev = self.starts[:self.n_fwd], self.starts[self.n_fwd:]
        pf = torch.zeros(fwd.numel(), dtype=torch.int64, device=fwd.device)
        pr = torch.zeros(rev.numel(), dtype=torch.int64, device=rev.device)
        for j in range(L):
            pf = pf * 4 + self.g[fwd + j]
            pr = pr * 4 + (3 - self.g[rev + (L - 1 - j)])
        return int(torch.unique(torch.cat([pf, pr])).numel())

    def hits(self, guide: np.ndarray, max_mm: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sites within max_mm of the guide's (L,) codes: ascending site
        indices and their mismatch counts, position by position."""
        q = torch.from_numpy(guide[list(self.enzyme.compared)].astype(np.uint8))
        q = q.to(self.g.device)[:, None]
        mm = (self.cmp != q).sum(0, dtype=torch.int16)
        site = torch.nonzero(mm <= max_mm).squeeze(1)
        return site, mm[site]

    def hits_many(self, guides: np.ndarray, max_mm: int, block: int = 512,
                  chunk: int = 1 << 22) -> List[Tuple[np.ndarray, np.ndarray]]:
        """hits() of every row of guides (G, L), as products of one-hots
        over 4 bases (the match counts, at most 24, are exact in float16
        with float32 accumulation): the control's pace for whole jobs."""
        P = len(self.enzyme.compared)
        dev = self.g.device
        dt = torch.float16 if dev.type == "cuda" else torch.float32
        four = torch.arange(4, device=dev, dtype=torch.uint8)
        q = torch.from_numpy(guides[:, list(self.enzyme.compared)].astype(np.uint8)).to(dev)
        q_oh = (q[:, :, None] == four).reshape(q.shape[0], 4 * P).to(dt)
        gs, ss, ms = [], [], []
        for lo in range(0, self.cmp.shape[1], chunk):
            c = self.cmp[:, lo:lo + chunk].t()
            c_oh = (c[:, :, None] == four).reshape(c.shape[0], 4 * P).to(dt)
            for b in range(0, q.shape[0], block):
                matches = c_oh @ q_oh[b:b + block].t()             # (chunk, B)
                s, g = torch.nonzero(matches >= P - max_mm, as_tuple=True)
                ms.append((P - matches[s, g]).to(torch.int16).cpu().numpy())
                gs.append((g + b).cpu().numpy())
                ss.append((s + lo).cpu().numpy())
        g, s, m = (np.concatenate(x) for x in (gs, ss, ms))
        order = np.lexsort((s, g))
        g, s, m = g[order], s[order], m[order]
        bounds = np.searchsorted(g, np.arange(q.shape[0] + 1))
        return [(s[bounds[i]:bounds[i + 1]], m[bounds[i]:bounds[i + 1]])
                for i in range(q.shape[0])]

    def off_targets(self, guide: np.ndarray, max_mm: int, cap: int,
                    order: str = "flashfry", found=None) -> Tuple[int, str]:
        """(otCount, offTargets) of one guide, from its hits (found, or
        hits()). order "position" puts the targets in the order of their
        first site instead of FlashFry's (the control's broken guarantee)."""
        if order not in ORDERS:
            raise ValueError("order %r: expected one of %s" % (order, ORDERS))
        site, mm = self.hits(guide, max_mm) if found is None else found
        site = torch.as_tensor(site, device=self.g.device)
        if site.numel() == 0:
            return 0, ""
        codes = self.window_codes(site).cpu().numpy()
        starts = self.starts[site].cpu().numpy()
        site = site.cpu().numpy()
        mm = np.asarray(mm.cpu() if isinstance(mm, torch.Tensor) else mm)
        packed = _packed(codes)
        uniq, first, inverse = np.unique(packed, return_index=True,
                                         return_inverse=True)
        inverse = inverse.reshape(-1)
        e = self.enzyme
        L = e.length
        bins = (uniq >> np.uint64(2 * (L - e.bin_start - e.bin_width))) \
            & np.uint64((1 << (2 * e.bin_width)) - 1)
        if order == "flashfry":
            target_order = np.lexsort((uniq, bins))
        else:
            target_order = np.argsort(site[first], kind="stable")
        by_target = np.argsort(inverse, kind="stable")      # sites ascending
        bounds = np.searchsorted(inverse[by_target], np.arange(uniq.size + 1))
        total = 0
        tokens = []
        for t in target_order.tolist():
            if cap > 0 and total >= cap:
                break
            members = by_target[bounds[t]:bounds[t + 1]][:self.max_positions]
            total += members.size
            pos = "|".join("%s:%d^%s" % (self.contig, starts[m],
                                         "F" if site[m] < self.n_fwd else "R")
                           for m in members.tolist())
            tokens.append("%s_%d_%d<%s>" % (_text(codes[first[t]]), members.size,
                                            int(mm[first[t]]), pos))
        return total, ",".join(tokens)


def job_sites(records: Sequence[np.ndarray], enzyme: Enzyme, flank: int) -> List[Site]:
    """Every site of a job's FASTA records (uint8 codes), in output order."""
    L = enzyme.length
    gap = np.full(L - 1, 4, dtype=np.uint8)
    parts, offsets, o = [], [], 0
    for r, codes in enumerate(records):
        if r:
            parts.append(gap)
            o += L - 1
        offsets.append(o)
        parts.append(codes.astype(np.uint8))
        o += codes.shape[0]
    joined = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    offsets = np.asarray(offsets, dtype=np.int64)
    out = []
    fwd, rev = strand_sites(torch.from_numpy(joined), enzyme)
    for forward, found in ((True, fwd.numpy()), (False, rev.numpy())):
        rec = np.searchsorted(offsets, found, side="right") - 1
        for r, s in zip(rec.tolist(), (found - offsets[rec]).tolist()):
            codes = records[r]
            win = codes[s:s + L]
            ctx = (codes[s - flank:s + L + flank]
                   if s >= flank and s + L + flank <= codes.shape[0] else None)
            if not forward:
                win = 3 - win[::-1]
                ctx = None if ctx is None else 3 - ctx[::-1]
            out.append(Site(r, s, forward, np.ascontiguousarray(win),
                            None if ctx is None else _text(ctx)))
    out.sort(key=lambda x: (x.start, x.record, not x.forward))
    return out


def site_columns(site: Site, names: Sequence[str]) -> str:
    """contig, start, stop, target, context of a row (tab-joined)."""
    return "\t".join((names[site.record], str(site.start),
                      str(site.start + site.codes.shape[0]), _text(site.codes),
                      site.context if site.context is not None else "NONE"))


def row(site: Site, names: Sequence[str], ref: ReferenceGenome, max_mm: int,
        cap: int, order: str = "flashfry", found=None) -> str:
    """One output row, newline included."""
    total, tokens = ref.off_targets(site.codes, max_mm, cap, order, found)
    over = "OVERFLOW" if cap > 0 and total >= cap else "OK"
    return "%s\t%s\t%s\t%d\t%s\n" % (site_columns(site, names), over,
                                     "FWD" if site.forward else "RVS", total,
                                     tokens)
