"""The genome, guide and locus generators repeat exactly under a seed."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.genome import synthesize_genome
from benchmark.reference import job_sites
from benchmark.sites import enzyme_of, strand_sites
from benchmark.check import BLOCK_ROWS, _edges
from benchmark.traffic import _fasta, make_jobs, pool_size
from small_cells import REPO


def config(name):
    return json.load(open(os.path.join(REPO, "benchmark", "configs", name + ".json")))


def mix(name, **kw):
    t = json.load(open(os.path.join(REPO, "benchmark", "traffic", name + ".json")))
    t.update(kw)
    return t


def test_genome_repeats_under_a_seed():
    a = synthesize_genome(0.3, np.random.default_rng([123, 0]))
    b = synthesize_genome(0.3, np.random.default_rng([123, 0]))
    c = synthesize_genome(0.3, np.random.default_rng([124, 0]))
    assert a.dtype == np.int8 and a.shape == (300_000,) and a.max() <= 3
    assert np.array_equal(a, b) and not np.array_equal(a, c)


@pytest.mark.parametrize("cfg", ["spcas9ngg_400mbp", "cas12a_400mbp"])
@pytest.mark.parametrize("traffic", ["library", "locus"])
def test_jobs_repeat_under_a_seed(cfg, traffic):
    enzyme = enzyme_of(config(cfg))
    genome = synthesize_genome(0.3, np.random.default_rng([7, 0]))
    sites = strand_sites(torch.from_numpy(genome.view(np.uint8)), enzyme)
    t = mix(traffic, **({"sites_per_job": 100} if traffic == "library"
                        else {"records_per_job": 40}))

    def draw(seed):
        return make_jobs(t, genome, sites, enzyme, np.random.default_rng([seed, 1]), 3, "j")

    a, b, c = draw(9), draw(9), draw(10)
    assert [j.fasta for j in a] == [j.fasta for j in b]
    assert [j.fasta for j in a] != [j.fasta for j in c]
    assert len({j.fasta for j in a}) == 3          # no job repeats
    for job in a:
        if t["kind"] == "regions":
            assert len(job.record_names) == t["records_per_job"]
            assert (job.lengths == t["region_bp"]).all()
        else:
            flank, L = t["record_flank"], enzyme.length
            assert (job.lengths == L + 2 * flank).all()
            starts = set(torch.cat(sites).tolist())
            assert all(int(s) + flank in starts for s in job.starts)
            # the records hold sites_per_job sites, and the last record is needed
            held = [len(job_sites([genome.view(np.uint8)[s:s + L + 2 * flank]], enzyme, flank))
                    for s in job.starts.tolist()]
            assert sum(held) >= t["sites_per_job"] > sum(held) - held[-1]


def test_pool_covers_the_window():
    assert pool_size({"max_jobs_per_s": 5}, 51) == 256
    assert pool_size({"max_jobs_per_s": 40}, 10) == 401


def test_fasta_takes_records_of_one_length_only():
    genome = np.arange(40, dtype=np.int8) % 4
    one = _fasta(["a0", "a1"], genome, np.array([0, 10]), np.array([5, 5]))
    assert one == b">a0\nACGTA\n>a1\nGTACG\n"
    with pytest.raises(ValueError):
        _fasta(["a0", "a1"], genome, np.array([0, 10]), np.array([5, 6]))
    with pytest.raises(ValueError):
        _fasta(["a0", "a10"], genome, np.array([0, 10]), np.array([5, 5]))


@pytest.mark.parametrize("n", [1, 247, 2048, 10_003])
def test_sample_takes_block_edges(n):
    edges = _edges(n)
    k = -(-n // BLOCK_ROWS)
    assert {0, n - 1} <= edges and all(0 <= i < n for i in edges)
    for b in range(0, n, BLOCK_ROWS):          # blocks cut in order
        assert {b, min(b + BLOCK_ROWS, n) - 1} <= edges
    assert set(range(k)) | set(range(n - k, n)) <= edges   # dealt round-robin


def test_keep_takes_heads_and_the_sample():
    from types import SimpleNamespace
    from benchmark.check import keep
    from benchmark.reference import HEADER
    rows = ["chrS\t%d\t%d\tACGT\tNONE\t%s\tFWD\t%d\tAC_1_0<chrS:1^F>"
            % (i, i + 4, "OVERFLOW" if i == 3 else "OK", 2000 if i == 3 else 7 + i % 5)
            for i in range(5000)]
    rows[2500] = rows[2500].replace("\tFWD\t7\t", "\tFWD\t12345\t")
    text = (HEADER + "\n".join(rows) + "\n").encode()
    mix = {"check_rows_per_job": 4, "check_overflow_rows_per_job": 1}
    k = keep(SimpleNamespace(), text, False, mix, np.random.default_rng(0))
    assert [h.decode() for h in k.heads] == [r.rsplit("\t", 2)[0] for r in rows]
    assert "12345" in rows[2500] and {3, 2500} <= set(k.sampled) and _edges(5000) <= set(k.sampled)
    assert len(k.sampled) <= len(_edges(5000)) + 4 + 2
    assert all(k.sampled[i] == rows[i] + "\n" for i in k.sampled)
    assert keep(SimpleNamespace(), text.replace(b"\tFWD\t7\t", b"\tFWD 7\t", 1), False,
                mix, np.random.default_rng(0)).heads is None
    assert keep(SimpleNamespace(), text, True, mix, np.random.default_rng(0)).heads is None
