"""Database dump to FASTA (the `extract` CLI module).

Counterpart of modules/DumpDatabase.scala and
reference/traverser/dump/DumpAllGuides.scala:61-130: walk every bin in order,
decode targets, filter by in-genome count [min, max], optionally subsample,
write ``>SEQ_count\\nSEQ`` records.

Vectorized: the count/subsample filters are one boolean mask per chunk, the
sequence text is one batched decode (the reference streams target-by-target
through the JVM; a per-target Python loop would take minutes at hg38's 375M
targets).
"""

from __future__ import annotations

import numpy as np

from .bitcoding import STRING_MASK, longs_to_codes, _CODE_TO_BASE
from .database import load_database

CHUNK = 1 << 20


def dump_database(args) -> None:
    db = load_database(args.database)
    L = db.pack.total_scan_length
    rng = np.random.default_rng(args.seed)

    min_c = args.minInGenome
    max_c = args.maxInGenome
    prop = args.subsampleProportion

    with open(args.outputFile, "w") as out:
        for lo in range(0, db.num_targets, CHUNK):
            targets = db.targets[lo:lo + CHUNK]
            counts = (targets >> np.uint64(48)).astype(np.int64)
            keep = (counts >= min_c) & (counts <= max_c)
            if prop < 1.0:
                # DumpAllGuides.scala:104: rand <= proportion per target
                keep &= rng.random(targets.shape[0]) <= prop
            kept = targets[keep]
            if kept.shape[0] == 0:
                continue
            codes = longs_to_codes(kept & STRING_MASK, L)
            big = bytes(_CODE_TO_BASE[codes].reshape(-1)).decode("ascii")
            cnt = counts[keep].tolist()
            out.writelines(
                ">%s_%d\n%s\n" % (big[i * L:(i + 1) * L], c, big[i * L:(i + 1) * L])
                for i, c in enumerate(cnt))
