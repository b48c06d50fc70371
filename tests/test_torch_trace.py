"""flashfry_tpu_torch.trace: the spans and counters of a discover call, the
report's phase keys read from them, and the benchmark readers of the new
per-layer metrics.

Spans nest and sum, a recorder counts, nothing is recorded without a
recorder and no profiler span is opened outside a profiler; inside one,
each span is an `ff.*` event nested in its caller's. The discover CLI's
report keeps its phase keys, now read from the spans, and carries every
span and the plane build's uploaded bytes; a streaming scanner records the
plane build's three steps once per slab or more.
"""

import json
import os
import re
import time

import numpy as np
import pytest
import torch

from benchmark.harness import load_reader
from benchmark.readers import Context
from flashfry_tpu_torch import cli, trace
from flashfry_tpu_torch.database import build_database_from_sites, save_database
from flashfry_tpu_torch.discovery import find_target_sites
from flashfry_tpu_torch.engine import ScanStats, discover
from flashfry_tpu_torch.ops.scan import CODE_ROWS, SLAB_GRANULE, DeviceScanner
from flashfry_tpu_torch.standards import Cas9NGGParameterPack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANE = ("plane_build.split", "plane_build.upload", "plane_build.expand")
COLLECT = ("collect.native", "collect.assign")
CLI = ("cli.parse", "cli.prepare", "release", "report")
SPANS = {"load", "guide_sites", "plane_build", *PLANE, "prologue", "counter",
         "scan", "collect", *COLLECT, "write", *CLI}
TOP = {"cli.parse", "cli.prepare", "load", "guide_sites", "plane_build",
       "prologue", "scan", "write", "release", "report"}
PHASE_KEYS = ("load_s", "guide_sites_s", "upload_expand_s", "counter_s",
              "scan_s", "collect_s", "write_s")


def test_spans_nest_and_sum_self_time_and_counts():
    with trace.recording() as rec:
        with trace.span("a") as a:
            for _ in range(2):
                with trace.span("a.b"):
                    time.sleep(0.002)
            time.sleep(0.002)
        with trace.span("a.b") as alone:
            pass
        trace.count("n", 3)
        trace.count("n", 4)
    assert rec.calls == {"a": 1, "a.b": 3}
    assert rec.spans["a"] == a.seconds > rec.spans["a.b"] - alone.seconds >= 0.004
    assert rec.self_s("a") == pytest.approx(a.seconds - (rec.spans["a.b"] - alone.seconds))
    assert rec.self_s("a") >= 0.002 and rec.self_s("a.b") == rec.spans["a.b"]
    assert rec.counts == {"n": 7}
    assert trace._RECORDER.get() is None


def test_recordings_do_not_leak_into_each_other():
    with trace.recording() as outer:
        with trace.recording() as inner:
            with trace.span("x"):
                trace.count("c", 1)
        with trace.span("y"):
            pass
    assert set(inner.spans) == {"x"} and inner.counts == {"c": 1}
    assert set(outer.spans) == {"y"} and outer.counts == {}


def test_no_recorder_and_no_profiler_do_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function entered outside a profiler: " + name)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("load") as s:
        with trace.span("load.inner"):
            pass
    trace.count("plane_build.h2d_bytes", 8)
    assert s.seconds >= 0 and trace._RECORDER.get() is None
    with trace.recording() as rec:
        pass
    assert rec.spans == {} and rec.counts == {} and rec.calls == {}


def test_counts_at_close_are_read_once_when_the_block_ends_cleanly():
    """count_at_close's reads are made when the recorder closes, after
    everything inside; not at all without a recorder, nor when the block
    raises."""
    reads = []

    def read(n):
        reads.append(n)
        return n

    trace.count_at_close("c", lambda: read(1))
    assert reads == []
    with trace.recording() as rec:
        trace.count_at_close("c", lambda: read(2))
        trace.count("c", 3)
        trace.count_at_close("c", lambda: read(4))
        assert reads == [] and rec.counts == {"c": 3}
    assert reads == [2, 4] and rec.counts == {"c": 9}
    with pytest.raises(RuntimeError):
        with trace.recording() as failed:
            trace.count_at_close("c", lambda: read(5))
            raise RuntimeError
    assert reads == [2, 4] and failed.counts == {} and failed.seconds > 0


def _events(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        return [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_spans_lie_inside_their_callers_record_function(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("job-1"):
            with trace.recording() as rec:
                with trace.span("plane_build"):
                    for name in PLANE:
                        with trace.span(name):
                            time.sleep(0.001)
                with trace.span("write"):
                    pass
        with torch.profiler.record_function("job-2"):
            with trace.span("load"):  # no recorder: the profiler still sees it
                time.sleep(0.001)
    events = _events(prof, tmp_path / "trace.json")
    by_name = {e["name"]: e for e in events}
    ff = [e for e in events if e["name"].startswith(trace.PREFIX)]
    assert sorted(e["name"] for e in ff) == sorted(
        trace.PREFIX + n for n in ("plane_build", *PLANE, "write", "load"))
    for e in ff:
        job = by_name["job-2" if e["name"] == "ff.load" else "job-1"]
        assert _inside(e, job), e
    for name in PLANE:
        assert _inside(by_name["ff." + name], by_name["ff.plane_build"])
    assert set(rec.spans) == {"plane_build", *PLANE, "write"}


def random_genome(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace_db")
    genome = random_genome(120_000, seed=18)
    db = build_database_from_sites(
        find_target_sites(iter([("chrT", genome)]), Cas9NGGParameterPack), 7)
    save_database(db, str(d / "db"))
    fasta = d / "g.fa"
    fasta.write_text(">g\n" + genome[500:1100] + "\n")
    return d, db


def _discover(d, *extra):
    return cli.run(["discover", "--fasta", str(d / "g.fa"), "--database", str(d / "db"),
                    "--output", str(d / "out"), "--positionOutput", *extra])


def test_cli_report_phase_keys_come_from_spans(small_db):
    d, db = small_db
    t = time.perf_counter()
    report = _discover(d, "--device", "cpu")
    wall = time.perf_counter() - t
    spans = report["spans"]
    assert report["guides"] > 0
    assert set(spans) == SPANS
    assert all(k in report for k in PHASE_KEYS)
    # the phase keys keep their names and definitions, read from the spans
    assert report["load_s"] == spans["load"]
    assert report["guide_sites_s"] == spans["guide_sites"]
    assert report["upload_expand_s"] == spans["plane_build"]
    assert report["counter_s"] == spans["counter"]
    assert report["collect_s"] == spans["collect"]
    assert report["write_s"] == spans["write"]
    assert report["scan_s"] == spans["scan"] - spans["counter"] - spans["collect"]
    assert report["scan_s"] >= 0
    assert sum(spans[n] for n in PLANE) <= spans["plane_build"]
    # the top-level phases do not overlap: together at most the call's wall
    assert sum(report[k] for k in PHASE_KEYS) + spans["prologue"] <= wall
    counts = report["counts"]
    assert counts["plane_build.h2d_bytes"] == 8 * db.num_targets
    assert "plane_build.card_us" not in counts  # a CPU build counts none
    assert set(counts) == {"plane_build.h2d_bytes", "collect.hits", "collect.accepted",
                           "collect.coords", "write.bytes", "write.rows"}
    assert set(report["top_spans"]) == TOP
    json.dumps(report)


def test_cli_report_of_the_numpy_backend(small_db):
    d, _db = small_db
    report = _discover(d, "--backend", "numpy")
    spans = report["spans"]
    assert set(spans) == {"load", "guide_sites", "prologue", "scan", "collect",
                          *COLLECT, "write", *CLI}
    assert "upload_expand_s" not in report
    assert set(report["counts"]) == {"collect.hits", "collect.accepted",
                                     "collect.coords", "write.bytes", "write.rows"}
    assert report["counter_s"] == 0.0
    assert report["scan_s"] == spans["scan"] - spans["collect"]


def test_streaming_scanner_records_the_plane_build_per_slab(small_db):
    _d, db = small_db
    scanner = DeviceScanner(db, "cpu", budget=2 * CODE_ROWS * SLAB_GRANULE)
    assert scanner.mode == "streaming" and scanner.slabs >= 3
    guides = np.asarray(db.targets[:40], dtype=np.uint64)
    with trace.recording() as rec:
        hits = list(scanner.scan(guides, 3))
    assert hits
    for name in PLANE:
        assert rec.calls[name] >= scanner.slabs, name
    assert "plane_build" not in rec.spans  # the slabs' steps run inside the scan
    assert rec.counts == {"plane_build.h2d_bytes": 8 * db.num_targets}


def test_discover_stats_seconds_are_its_spans(small_db):
    d, db = small_db
    from flashfry_tpu_torch.utils import iterate_fasta
    sites = find_target_sites(iterate_fasta(str(d / "g.fa")), db.pack,
                              capture_context=True)
    stats = ScanStats()
    with trace.recording() as rec:
        guides = discover(db, sites, max_mismatch=3, stats=stats, device="cpu")
    assert guides
    assert stats.scan_seconds == rec.spans["scan"]
    assert stats.counter_seconds == rec.spans["counter"]
    assert stats.collect_seconds == rec.spans["collect"]
    # without a scanner discover builds one inside its scan
    assert rec.child_s["scan"] == pytest.approx(
        rec.spans["counter"] + rec.spans["plane_build"] + rec.spans["collect"])
    assert set(PLANE) <= set(rec.spans)


@pytest.fixture(scope="module")
def repeat_db(tmp_path_factory):
    """A database in which most guides of the FASTA lie twice in the
    genome, the copy one base apart (a base changed every 40), so they hit
    two targets: a cap of one keeps one."""
    d = tmp_path_factory.mktemp("trace_repeat_db")
    genome = random_genome(60_000, seed=23)
    copy = list(genome[10_000:12_000])
    for i in range(0, len(copy), 40):
        copy[i] = "ACGT"[("ACGT".index(copy[i]) + 1) % 4]
    genome += "".join(copy)
    db = build_database_from_sites(
        find_target_sites(iter([("chrR", genome)]), Cas9NGGParameterPack), 7)
    save_database(db, str(d / "db"))
    (d / "g.fa").write_text(">g\n" + genome[10_200:11_000] + "\n")
    return d


def _output_positions(path):
    """The positions an output lists: every entry of every <...> list."""
    with open(path) as fh:
        rows = fh.read().splitlines()[1:]
    return sum(len(inner.split("|")) for row in rows
               for inner in re.findall(r"<([^>]*)>", row.split("\t")[-1])), len(rows)


@pytest.mark.parametrize("collect", ["native", "numpy"])
@pytest.mark.parametrize("extra", [("--device", "cpu"), ("--backend", "numpy"),
                                   ("--device", "cpu", "--maximumOffTargets", "1")],
                         ids=["cpu", "numpy_backend", "cap_1"])
def test_collect_and_write_counters_match_the_output(repeat_db, monkeypatch, extra, collect):
    """collect.hits counts every hit, collect.accepted those under the cap,
    collect.coords the positions the output lists, and write.bytes and
    write.rows the output file's size and rows, with the native collect and
    with its numpy formulation; the two write the same bytes."""
    d = repeat_db
    if collect == "numpy":
        from flashfry_tpu_torch import native
        monkeypatch.setattr(native, "collect_hits", lambda *a: None)
    report = _discover(d, *extra)
    counts, spans = report["counts"], report["spans"]
    positions, rows = _output_positions(d / "out")
    assert rows == report["guides"] > 0
    if "--maximumOffTargets" in extra:
        assert counts["collect.hits"] > counts["collect.accepted"] == rows
        assert report["overflowed_guides"] == rows
    else:
        assert counts["collect.hits"] == counts["collect.accepted"] > rows
    assert counts["collect.coords"] == positions >= counts["collect.accepted"]
    assert counts["write.bytes"] == os.path.getsize(d / "out")
    assert counts["write.rows"] == rows
    assert spans["collect.native"] + spans["collect.assign"] <= spans["collect"]
    with open(d / "out", "rb") as fh:
        out = fh.read()
    monkeypatch.undo()
    _discover(d, *extra)
    with open(d / "out", "rb") as fh:
        assert fh.read() == out


@pytest.mark.parametrize("extra", [("--device", "cpu"), ("--backend", "numpy")],
                         ids=["cpu", "numpy_backend"])
def test_top_level_spans_cover_the_call(small_db, extra):
    """call_seconds is the recorder's seconds, and the spans at top level,
    which do not overlap, cover at least 95% of it: every part of the call
    lies in a named span."""
    d, _db = small_db
    t = time.perf_counter()
    report = _discover(d, *extra)
    wall = time.perf_counter() - t
    top = report["top_spans"]
    assert set(top) <= TOP and {"cli.parse", "cli.prepare", "load", "release",
                                "report", "write"} <= set(top)
    for name, seconds in top.items():
        assert seconds == report["spans"][name]
    call = report["call_seconds"]
    assert 0.95 * call <= sum(top.values()) <= call <= wall


def _mapped(path):
    with open("/proc/self/maps") as fh:
        return [line for line in fh if line.rstrip().endswith(path)]


def test_release_unmaps_the_database_inside_the_call(small_db, monkeypatch):
    """The database is memory-mapped while the call writes, and no longer
    once cli.run returns: release frees the maps inside the call."""
    d, _db = small_db
    path = str(d / "db")
    seen = []
    write = cli.write_output

    def spy(*a, **k):
        seen.append(_mapped(path))
        return write(*a, **k)

    monkeypatch.setattr(cli, "write_output", spy)
    report = _discover(d, "--device", "cpu")
    assert seen and seen[0], "the database was not memory-mapped during the call"
    assert _mapped(path) == []
    assert "release" in report["top_spans"]


REPORTS = [
    {"counter_s": 0.002,
     "spans": {"plane_build.split": 0.5, "plane_build.upload": 0.08,
               "plane_build.expand": 0.01, "prologue": 0.001,
               "cli.parse": 0.002, "cli.prepare": 0.0001, "report": 0.0009,
               "release": 0.004, "collect": 0.010, "write": 0.008},
     "counts": {"plane_build.h2d_bytes": 384_000_000, "collect.hits": 5000,
                "write.bytes": 400_000, "plane_build.card_us": 9000},
     "call_seconds": 0.1, "top_spans": {"a": 0.05, "b": 0.049}},
    {"counter_s": 0.004,
     "spans": {"plane_build.split": 0.6, "plane_build.upload": 0.12,
               "plane_build.expand": 0.03, "prologue": 0.003,
               "cli.parse": 0.003, "cli.prepare": 0.0002, "report": 0.0008,
               "release": 0.006, "collect": 0.020, "write": 0.012},
     "counts": {"plane_build.h2d_bytes": 376_000_000, "collect.hits": 15000,
                "write.bytes": 600_000, "plane_build.card_us": 11000},
     "call_seconds": 0.12, "top_spans": {"a": 0.117}},
]
READERS = [
    ("plane_split_s.job", 0.55),
    ("plane_upload_s.job", 0.10),
    ("plane_expand_s.job", 0.02),
    ("plane_upload_gbps.job", 760_000_000 / 0.2 / 1e9),
    ("prologue_s.job", 0.002),
    ("counter_s.job", 0.003),
    ("cli_s.job", 0.0035),
    ("release_s.job", 0.005),
    ("unspanned_s.job", 0.002),
    ("collect_us_per_hit.job", 0.030 / 20000 * 1e6),
    ("write_mbps.job", 1_000_000 / 0.020 / 1e6),
    ("plane_card_s.job", 0.010),
]


def _ctx(reports):
    return Context(config={}, traffic={}, enzyme=None, setup_s=1.0, window_s=1.0,
                   job_s=[0.5] * len(reports), reports=reports, device_kind="cpu")


@pytest.mark.parametrize("name,want", READERS, ids=[n for n, _ in READERS])
def test_reader_gives_its_mean_and_none_without_its_key(name, want):
    read = load_reader(name, ROOT)
    assert read(_ctx(REPORTS)) == pytest.approx(want)
    assert read(_ctx([{"load_s": 0.1}, {"load_s": 0.2}])) is None
    assert read(_ctx([])) is None


def test_new_readers_are_declared_for_the_locus_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        per_layer = {m["name"]: m for m in json.load(fh)["per_layer"]}
    for name, _ in READERS:
        m = per_layer[name]
        assert m["workloads"] == ["spcas9ngg_400mbp.locus"] and m["moves"] == "job_s"
