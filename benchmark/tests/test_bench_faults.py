"""The check fails what it must: a run driven on the CPU, past the look
for a card, with the timed path broken underneath, comes out not correct;
the sound program and the reference itself come out correct; the control
(control.py: the reference with its targets in genomic order) does not."""

import time

import pytest

from benchmark import harness
from benchmark.control import control_discover
from small_cells import small_root


def stale(genome, config, device):
    """Each job returns the previous job's state: its output and report."""
    run = harness.program_discover(genome, config, device)
    last = {}

    def discover(argv):
        out = argv[argv.index("--output") + 1]
        if last:
            time.sleep(0.02)   # as long as a job, so the pool lasts
            with open(out, "wb") as fh:
                fh.write(last["written"])
            return last["report"]
        last["report"] = run(argv)
        with open(out, "rb") as fh:
            last["written"] = fh.read()
        return last["report"]
    return discover


def half(genome, config, device):
    """Half of each job's records left out; of a job of one record, the
    second half of its bases."""
    run = harness.program_discover(genome, config, device)

    def discover(argv):
        fasta = argv[argv.index("--fasta") + 1]
        blocks = open(fasta, "rb").read().split(b">")[1:]
        if len(blocks) == 1:
            head, _, seq = blocks[0].partition(b"\n")
            seq = seq.rstrip(b"\n")
            blocks = [head + b"\n" + seq[:len(seq) // 2] + b"\n"]
        with open(fasta, "wb") as fh:
            fh.write(b"".join(b">" + x for x in blocks[:max(1, len(blocks) // 2)]))
        return run(argv)
    return discover


def altered(monkeypatch):
    """One hit of every stage-2 batch reports the next target."""
    from flashfry_tpu_torch.ops import scan
    collect = scan.collect_block

    def wrong(*a, **kw):
        for t, g, mm in collect(*a, **kw):
            t = t.copy()
            t[0] += 1
            yield t, g, mm
    monkeypatch.setattr(scan, "collect_block", wrong)
    return harness.program_discover


def last_row_altered(genome, config, device):
    """The last row of each job, at the end of its last guide block,
    counts one off-target more."""
    run = harness.program_discover(genome, config, device)

    def discover(argv):
        report = run(argv)
        out = argv[argv.index("--output") + 1]
        lines = open(out).read().split("\n")
        cols = lines[-2].split("\t")
        cols[7] = str(int(cols[7]) + 1)
        lines[-2] = "\t".join(cols)
        with open(out, "w") as fh:
            fh.write("\n".join(lines))
        return report
    return discover


def reference_itself(genome, config, device):
    return control_discover(genome, config, device, order="flashfry")


CASES = {"program": (None, True), "reference": (reference_itself, True),
         "control": (control_discover, False), "stale_state": (stale, False),
         "half_left_out": (half, False), "answer_altered": ("altered", False),
         "last_row_altered": (last_row_altered, False)}


# the benchmark's cell first, then the parked library cells (small_cells.py)
WORKLOADS = ("spcas9ngg_400mbp.locus", "spcas9ngg_400mbp.library",
             "cas12a_400mbp.library")
# faults that do not depend on the enzyme or the mix run on the benchmark's cell
RUNS = [(case, w) for case in CASES for w in WORKLOADS
        if w == WORKLOADS[0] or case not in ("stale_state", "half_left_out",
                                             "last_row_altered")]


@pytest.mark.parametrize("case,workload", RUNS)
def test_check(case, workload, tmp_path, monkeypatch):
    make, want = CASES[case]
    if make is None:
        make = harness.program_discover
    elif make == "altered":
        make = altered(monkeypatch)
    root, b = small_root(tmp_path, genome_mbp=1.0, sites=150, parked=True)
    r = harness.run_cell(b, workload, 2024, 0.5, False, device="cpu", root=root,
                         make_discover=make)
    assert r["attempted"] >= (2 if case == "stale_state" else 1)
    assert r["correct"] is want, r["compared"]
    if not want:
        assert any(c["value"] > c["limit"] for c in r["compared"].values())
