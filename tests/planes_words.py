"""Packed target words as the database stores them (count << 48 | bases),
with a random count in bits 48..63, for the plane-build tests on the CPU
(test_torch_scan.py) and on the card (test_torch_gpu.py). Imports only
numpy, so the card's machine, which has no JAX, can import it."""

import dataclasses

import numpy as np


def counted_words(rng, n, L):
    """n random L-base targets with a random count in bits 48..63 of every
    word."""
    seq = rng.integers(0, 1 << (2 * L), size=n, dtype=np.uint64)
    counts = rng.integers(0, 1 << 16, size=n, dtype=np.uint64)
    return seq | (counts << np.uint64(48))


def with_counts(db, seed):
    """db with a random count in bits 48..63 of every target word."""
    rng = np.random.default_rng(seed)
    seq = np.asarray(db.targets, dtype=np.uint64) & np.uint64((1 << 48) - 1)
    counts = rng.integers(1, 1 << 16, size=seq.shape[0], dtype=np.uint64)
    return dataclasses.replace(db, targets=seq | (counts << np.uint64(48)))
