"""The plain reference against brute force, the roofline's count, the
trace reduction and the result line."""

import itertools
import json
import os

import numpy as np
import pytest

from benchmark import harness, readers
from benchmark.devtrace import reduce_events
from benchmark.reference import ReferenceGenome, job_sites
from benchmark.sites import enzyme_of
from benchmark.work import PEAKS, bound_seconds, stage1_work
from small_cells import REPO, small_root

H100 = "NVIDIA H100 80GB HBM3"


def config(name):
    return json.load(open(os.path.join(REPO, "benchmark", "configs", name + ".json")))


def brute_force(genome: str, pattern: str, compared, guide: str):
    """Every window on both strands, by string slicing: {(start, strand):
    mismatches} of the sites matching `pattern`."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    L, out = len(pattern), {}
    for s in range(len(genome) - L + 1):
        w = genome[s:s + L]
        for strand, seq in (("F", w), ("R", "".join(comp[c] for c in reversed(w)))):
            if all(p == "N" or p == c for p, c in zip(pattern, seq)):
                out[(s, strand)] = sum(seq[j] != guide[j] for j in compared)
    return out


@pytest.mark.parametrize("cfg", ["spcas9ngg_400mbp", "cas12a_400mbp"])
def test_hits_equal_brute_force_hamming(cfg):
    rng = np.random.default_rng(3)
    enzyme = enzyme_of(config(cfg))
    codes = rng.integers(0, 4, 6000, dtype=np.int8)
    unit = codes[100:160].copy()
    for p in (1000, 2500, 4000):          # near copies, so guides hit at mm 0-5
        c = unit.copy()
        flip = rng.choice(60, size=rng.integers(0, 4), replace=False)
        c[flip] = (c[flip] + 1) % 4
        codes[p:p + 60] = c
    text = "".join("ACGT"[c] for c in codes)
    ref = ReferenceGenome(codes, enzyme, "cpu", 32767)
    starts = ref.starts.numpy()
    sites = [int(x) for x in rng.choice(starts.size, 12, replace=False)]
    for site, mm in itertools.product(sites, range(6)):
        guide = ref.window_codes(__import__("torch").tensor([site]))[0].numpy()
        gtext = "".join("ACGT"[c] for c in guide)
        want = {k: v for k, v in brute_force(text, enzyme.pattern, enzyme.compared,
                                               gtext).items() if v <= mm}
        idx, got_mm = ref.hits(guide, mm)
        got = {(int(starts[i]), "F" if i < ref.n_fwd else "R"): int(m)
               for i, m in zip(idx.tolist(), got_mm.tolist())}
        assert got == want


def test_cap_and_target_order():
    """A target is taken while fewer than cap positions were taken before
    it; targets come by bin, then sequence; positions forward first."""
    enzyme = enzyme_of(config("spcas9ngg_400mbp"))
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 4000, dtype=np.int8)
    site = np.array([0] * 20 + [0, 2, 2], dtype=np.int8)  # AAAA...A then AGG
    variant = site.copy()
    variant[19] = 3
    for p in (500, 900, 1300):
        codes[p:p + 23] = site
    codes[2000:2023] = variant
    ref = ReferenceGenome(codes, enzyme, "cpu", 32767)
    total, tokens = ref.off_targets(site.astype(np.uint8), 1, 0)
    seqs = [t.split("_")[0] for t in tokens.split(",")]
    assert seqs == sorted(seqs) and total >= 4
    first = tokens.split(",")[0]
    assert first.startswith("A" * 20 + "AGG_3_0<chrS:500^F|chrS:900^F|chrS:1300^F>")
    total, tokens = ref.off_targets(site.astype(np.uint8), 1, 2)
    assert total == 3 and tokens == first      # the cap stops after the first
    total, tokens = ref.off_targets(site.astype(np.uint8), 1, 2, order="position")
    assert tokens.split(",")[0] == first


def test_job_sites_order_and_context():
    enzyme = enzyme_of(config("spcas9ngg_400mbp"))
    rec = np.frombuffer(b"AAAAAACCAAAAAAAAAAAAAAAAAAAGGAAAAAA", np.uint8)
    codes = np.array([{65: 0, 67: 1, 71: 2, 84: 3}[b] for b in rec], np.uint8)
    sites = job_sites([codes, codes], enzyme, 6)
    assert [(s.start, s.record, s.forward) for s in sites] == \
        [(6, 0, True), (6, 0, False), (6, 1, True), (6, 1, False)]
    assert sites[0].context is not None and len(sites[0].context) == 35


def test_stage1_count_follows_from_shapes():
    ops, moved = stage1_work(guides=1059, n_targets=47_831_764, n_act=20, length=23)
    assert ops == 2 * (4 * 20) * 1059 * 47_831_764
    assert moved == 47_831_764 * 24
    assert bound_seconds(ops, moved, H100) == pytest.approx(ops / 1979e12)
    assert bound_seconds(ops, moved, "some other card") is None
    assert bound_seconds(0, moved, H100) == pytest.approx(moved / 3.35e12)
    trace = reduce_events([
        {"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0, "dur": 1e6},
        {"ph": "X", "cat": "kernel", "name": "stage1_kernel(signed char const*)",
         "ts": 100, "dur": 4100}], {})
    ctx = readers.Context(config={}, traffic={}, enzyme=enzyme_of(config("spcas9ngg_400mbp")),
                          setup_s=1, window_s=1, job_s=[1], reports=[], device_kind=H100,
                          trace=trace, n_targets=47_831_764, site_counts=[1059])
    assert readers.roofline(ctx, "stage1_kernel") == pytest.approx(
        100 * (ops / PEAKS[H100]["int8_ops_per_s"]) / 0.0041)
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 0.0041))


def test_trace_busy_union_and_idle_by_phase():
    report = {"load_s": 0.1, "guide_sites_s": 0.1, "upload_expand_s": 0.3,
              "counter_s": 0.0, "scan_s": 0.2, "collect_s": 0.1, "write_s": 0.1}
    ev = [{"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0, "dur": 1.1e6},
          {"ph": "X", "cat": "user_annotation", "name": "j0", "ts": 0.05e6, "dur": 1.0e6},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 0.3e6, "dur": 0.1e6},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 0.35e6, "dur": 0.1e6},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 0.5e6, "dur": 0.2e6}]
    t = reduce_events(ev, {"j0": report})
    assert t.busy_s == pytest.approx(0.35)
    assert t.kernel_s["k"] == pytest.approx(0.3)
    assert sum(t.idle_s.values()) == pytest.approx(1.1 - 0.35)
    assert t.idle_s["harness"] == pytest.approx(0.1)
    assert t.idle_s["load"] == pytest.approx(0.1)
    assert t.idle_s["plane_build"] == pytest.approx(0.1)   # 0.25-0.30, 0.45-0.50


def test_result_line_has_the_contract_keys(tmp_path):
    root, b = small_root(tmp_path, genome_mbp=0.5, sites=100)
    for trace in (False, True):
        r = harness.run_cell(b, "spcas9ngg_400mbp.locus", 11, 0.3, trace,
                             device="cpu", root=root)
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        assert list(r) == keys + (["breakdown"] if trace else []) + ["compared"]
        assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        if trace:
            assert {"busy_s", "window_s"} <= set(r["device"])
            assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(r["metrics"]) == {"job_s", "job_p90_s", "setup_s"}
        for m in r["metrics"].values():
            assert set(m) == {"value", "unit"}
        json.dumps(r)


@pytest.mark.parametrize("cfg", ["spcas9ngg_400mbp", "cas12a_400mbp"])
def test_hits_many_equals_hits(cfg):
    """The control's batched products give hits() exactly."""
    import torch
    enzyme = enzyme_of(config(cfg))
    codes = np.random.default_rng(8).integers(0, 4, 30000, dtype=np.int8)
    codes[20000:20300] = codes[1000:1300]
    ref = ReferenceGenome(codes, enzyme, "cpu", 32767)
    pick = torch.arange(0, ref.starts.numel(), max(1, ref.starts.numel() // 40))
    guides = ref.window_codes(pick).numpy()
    for mm in (0, 3, 5):
        many = ref.hits_many(guides, mm, block=7, chunk=1000)
        for g, (site, m) in zip(guides, many):
            s1, m1 = ref.hits(g, mm)
            assert np.array_equal(site, s1.numpy()) and np.array_equal(m, m1.numpy())
