"""Batched per-off-target scoring: one backend-dispatched pass for the
three activity models (Doench 2016 CFD, Hsu 2013, Jost & Santos).

The reference scores each OT with a per-character Scala loop
(Doench2016CFDScore.scala:132-151, CrisprMitEduOffTarget.scala:107-148,
JostAndSantosCRISPRi.scala:92-127). Here every model reduces to the same
shape — decode the flat packed OT array, gather per-position activity
factors, multiply — and three backends produce BIT-IDENTICAL per-OT f64
columns (the formatted output depends on the last ulp):

  * numpy  — the oracle: vectorized table gathers + multiply.reduce
             (strictly sequential, verified == Python left fold);
  * native — ff_score_ots (csrc/flashfry_native.cpp): fused
             decode+gather+product in one OpenMP pass, same accumulation
             order;
  * device — the card does ALL the integer work (decode, compare, compact
             mismatch descriptors; scoring/device.py, csrc/descriptors.cu)
             and the host turns descriptors into scores with ~#mismatch
             exact f64 gathers in the oracle's multiplication order. The
             float math stays on the host, where the product order is the
             oracle's by construction; identity factors are exact 1.0
             multiplies, so the descriptor path skipping them is
             bit-neutral.

Backend selection: `set_backend(name, device)`, which the `score` command
calls with its --backend and --device (default: device on cuda). The device
backend never gives way to another: only rows whose descriptor packing
overflowed (more than DESC_K mismatches) are redone by the numpy oracle.

Every backend returns, per model, (score f64[N], differs u8[N]) where
differs is the "any mismatch at enzyme comparison-mask positions" flag all
three models select on (== mismatches(ot, guide) != 0 under the mask).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..bitcoding import STRING_MASK, longs_to_codes

DESC_K = 6  # max mismatch descriptors per OT in the device packing


BACKENDS = ("device", "native", "numpy")

_backend = "device"
_device = "cuda"  # where the device backend runs its descriptor pass


def set_backend(name: str, device: str = "cuda") -> None:
    """Choose the backend of every batch made from here on, and the device
    ("cuda", "cuda:N" or "cpu") of the device backend's descriptor pass."""
    global _backend, _device
    if name not in BACKENDS:
        raise ValueError("unknown score backend %r (expected one of %s)"
                         % (name, ", ".join(BACKENDS)))
    _backend, _device = name, str(device)


def backend() -> str:
    return _backend


def _ot_codes(longs: np.ndarray, L: int) -> np.ndarray:
    return longs_to_codes(np.asarray(longs, dtype=np.uint64) & STRING_MASK, L)


def _differs_numpy(oc: np.ndarray, gext: np.ndarray,
                   act_pos: np.ndarray) -> np.ndarray:
    return (oc[:, act_pos] != gext[:, act_pos]).any(axis=1)


# ---------------------------------------------------------------------------
# numpy oracle implementations (exact formulas of the per-guide originals)
# ---------------------------------------------------------------------------

def _cfd_numpy(oc, gext, mm_table, pam_table, L):
    pos20 = np.arange(20)[None, :]
    vals = mm_table[gext[:, :20], oc[:, :20], pos20]
    cand = np.multiply.reduce(vals, axis=1)
    return pam_table[oc[:, L - 2], oc[:, L - 1]] * cand


def _hsu_numpy(oc, gext, one_minus, pam_table, gs, L):
    M = oc[:, :gs] != gext[:, :gs]
    mmc = M.sum(axis=1)
    part_one = np.multiply.reduce(
        np.where(M, one_minus[None, :], 1.0), axis=1)
    first = np.argmax(M, axis=1)
    last = (gs - 1) - np.argmax(M[:, ::-1], axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        avg_dist = (last - first) / np.maximum(mmc - 1, 1).astype(np.float64)
    part_two = np.where(mmc < 2, 1.0,
                        1.0 / ((((19.0 - avg_dist) / 19.0) * 4.0) + 1.0))
    mmf = mmc.astype(np.float64)
    with np.errstate(divide="ignore"):
        part_three = np.where(mmc == 0, 1.0, 1.0 / (mmf * mmf))
    total = part_one * part_two * part_three * 100.0
    return total * pam_table[oc[:, L - 2], oc[:, L - 1]]


def _jost_numpy(oc, gext, table, plo):
    pos19 = np.arange(19)[None, :]
    vals = table[pos19, oc[:, plo:plo + 19], gext[:, plo:plo + 19]]
    return np.multiply.reduce(vals, axis=1)


# ---------------------------------------------------------------------------
# descriptor decode (device backend host epilogue)
# ---------------------------------------------------------------------------

def unpack_descriptors(w0: np.ndarray, w1: np.ndarray):
    """(w0, w1) int32[N] packed words -> (pos (N,6), g (N,6), o (N,6),
    mmc (N,), overflow (N,), pam (N,)). Layout (scoring/device.py):
    w0 = d0|d1|d2 (9 bits each) | mmc (3 bits @27) | overflow (bit 30);
    w1 = d3|d4|d5 | pam (4 bits @27); descriptor = pos<<4 | g<<2 | o,
    ascending sequence position."""
    sh = 9 * np.arange(3, dtype=np.int32)
    d = np.empty((w0.shape[0], DESC_K), dtype=np.int32)
    d[:, :3] = (w0[:, None] >> sh[None, :]) & 511
    d[:, 3:] = (w1[:, None] >> sh[None, :]) & 511
    pos = d >> 4
    g = (d >> 2) & 3
    o = d & 3
    mmc = (w0 >> 27) & 7
    overflow = (w0 >> 30) & 1
    pam = (w1 >> 27) & 15
    return pos, g, o, mmc, overflow, pam


def _valid_k(mmc: np.ndarray) -> np.ndarray:
    return np.arange(DESC_K, dtype=np.int32)[None, :] < mmc[:, None]


def _cfd_from_desc(desc, mm_table, pam_table):
    pos, g, o, mmc, _, pam = desc
    valid = _valid_k(mmc)
    vals = np.where(valid, mm_table[g, o, np.minimum(pos, 19)], 1.0)
    cand = np.multiply.reduce(vals, axis=1)
    return pam_table.reshape(-1)[pam] * cand


def _hsu_from_desc(desc, one_minus, pam_table, gs):
    pos, _, _, mmc, _, pam = desc
    valid = _valid_k(mmc)
    p1 = np.multiply.reduce(
        np.where(valid, one_minus[np.minimum(pos, gs - 1)], 1.0), axis=1)
    first = np.where(mmc > 0, pos[:, 0], 0)
    last = np.where(
        mmc > 0,
        pos[np.arange(pos.shape[0]), np.minimum(mmc, DESC_K) - 1],
        gs - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        avg_dist = (last - first) / np.maximum(mmc - 1, 1).astype(np.float64)
    p2 = np.where(mmc < 2, 1.0,
                  1.0 / ((((19.0 - avg_dist) / 19.0) * 4.0) + 1.0))
    mmf = mmc.astype(np.float64)
    with np.errstate(divide="ignore"):
        p3 = np.where(mmc == 0, 1.0, 1.0 / (mmf * mmf))
    total = p1 * p2 * p3 * 100.0
    return total * pam_table.reshape(-1)[pam]


def _jost_from_desc(desc, table, plo):
    pos, g, o, mmc, _, _ = desc
    valid = _valid_k(mmc) & (pos >= plo) & (pos < plo + 19)
    idx = np.clip(pos - plo, 0, 18)
    vals = np.where(valid, table[idx, o, g], 1.0)
    return np.multiply.reduce(vals, axis=1)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

class OTScoreBatch:
    """One guide batch's flat OT array, scored lazily per model.

    Constructed once per score_guides call set (the models share it through
    a module-level memo keyed on the batch identity, so the device backend
    uploads/fetches ONCE for all three models)."""

    def __init__(self, flat: np.ndarray, gi: np.ndarray, glongs: np.ndarray,
                 L: int, act_pos: np.ndarray):
        self.flat = np.asarray(flat, dtype=np.uint64)
        self.gi = np.asarray(gi, dtype=np.int64)
        self.glongs = np.asarray(glongs, dtype=np.uint64)
        self.L = int(L)
        self.act_pos = np.asarray(act_pos, dtype=np.int32)
        self.n = int(self.flat.shape[0])
        self._oc = None
        self._gext = None
        self._desc = None       # device descriptors (unpacked)
        self._recompute = None  # rows the descriptor packing overflowed
        self._backend = backend()
        self._device = _device

    # -- shared intermediates ------------------------------------------------

    def _codes(self):
        if self._oc is None:
            self._oc = _ot_codes(self.flat, self.L)
            gcodes = longs_to_codes(self.glongs & STRING_MASK, self.L)
            self._gext = gcodes[self.gi]
        return self._oc, self._gext

    def _descriptors(self):
        if self._desc is None:
            from .device import extract_descriptors
            w0, w1 = extract_descriptors(self.flat, self.gi, self.glongs,
                                         self.L, self.act_pos, self._device)
            self._desc = unpack_descriptors(w0, w1)
            self._recompute = np.nonzero(self._desc[4])[0]
        return self._desc

    def differs(self) -> np.ndarray:
        if self._backend == "device" and self.n:
            d = self._descriptors()
            out = (d[3] > 0) | (d[4] > 0)
            return out.astype(np.uint8)
        oc, gext = self._codes()
        return _differs_numpy(oc, gext, self.act_pos).astype(np.uint8)

    # -- per-model columns ---------------------------------------------------

    def cfd(self, mm_table, pam_table) -> Tuple[np.ndarray, np.ndarray]:
        return self._column("cfd", cfd_tables=(mm_table, pam_table))

    def hsu(self, one_minus, pam_table, gs: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._column("hsu", hsu_tables=(one_minus, pam_table), gs=gs)

    def jost(self, table, plo: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._column("jost", jost_tables=(table, plo))

    def _column(self, kind: str, cfd_tables=None, hsu_tables=None,
                jost_tables=None, gs: int = 20):
        if self.n == 0:
            z = np.zeros(0, np.float64)
            return z, z.astype(np.uint8)
        if self._backend == "native":
            from .. import native as _native
            r = _native.score_ots(self.flat, self.gi, self.glongs, self.L,
                                  self.act_pos, cfd_tables=cfd_tables,
                                  hsu_tables=hsu_tables,
                                  jost_tables=jost_tables)
            if r is not None:
                return r[kind], r["differs"]
            self._backend = "numpy"  # build failed: permanent fallback
        if self._backend == "device":
            desc = self._descriptors()
            if kind == "cfd":
                score = _cfd_from_desc(desc, *cfd_tables)
            elif kind == "hsu":
                score = _hsu_from_desc(desc, *hsu_tables, gs)
            else:
                score = _jost_from_desc(desc, *jost_tables)
            if self._recompute.size:
                # >DESC_K mismatches packed (only reachable when the OT list
                # was built with maxMismatch > 6): exact numpy redo per row
                rows = self._recompute
                sub = OTScoreBatch(self.flat[rows], self.gi[rows],
                                   self.glongs, self.L, self.act_pos)
                sub._backend = "numpy"
                score[rows] = sub._column(kind, cfd_tables, hsu_tables,
                                          jost_tables, gs)[0]
            return score, self.differs()
        oc, gext = self._codes()
        if kind == "cfd":
            score = _cfd_numpy(oc, gext, *cfd_tables, self.L)
        elif kind == "hsu":
            score = _hsu_numpy(oc, gext, *hsu_tables, gs, self.L)
        else:
            score = _jost_numpy(oc, gext, *jost_tables)
        return score, _differs_numpy(oc, gext, self.act_pos).astype(np.uint8)


_memo_key = None
_memo_batch: Optional[OTScoreBatch] = None


def clear_batch_cache() -> None:
    """Drop the memoized batch (its cached code matrices alone are
    hundreds of MB at library scale)."""
    global _memo_key, _memo_batch
    _memo_key = None
    _memo_batch = None


def get_batch(flat: np.ndarray, gi: np.ndarray, glongs: np.ndarray, L: int,
              act_pos: np.ndarray) -> OTScoreBatch:
    """Memoized single-entry batch cache: consecutive models scoring the
    same guide set (same flat OT array) share one OTScoreBatch, so the
    device backend pays its upload/fetch once for all three models. The key
    is EXACT: an md5 over the full flat/gi buffers plus the guide longs —
    small beside the rebuild it guards, and immune to the sampled-key
    collision a direct API user could hit
    (two OT sets agreeing at the ~65 sampled positions)."""
    import hashlib
    global _memo_key, _memo_batch
    flat = np.ascontiguousarray(flat, dtype=np.uint64)
    n = int(flat.shape[0])
    h = hashlib.md5()
    h.update(flat)
    h.update(np.ascontiguousarray(gi, dtype=np.int64))
    key = (n, int(L), h.hexdigest(),
           np.asarray(glongs, np.uint64).tobytes(),
           np.asarray(act_pos, np.int64).tobytes(),  # enzyme active set
           backend(), _device)
    if _memo_key == key and _memo_batch is not None:
        return _memo_batch
    _memo_key = key
    _memo_batch = OTScoreBatch(flat, gi, glongs, L, act_pos)
    return _memo_batch
