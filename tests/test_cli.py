"""CLI + sanity-fixture tests (the reversecomptest scenario of the
reference sanitytests/, driven through the real CLI)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "sanitytests", "reversecomptest.txt")

ENV = dict(
    os.environ,
    PYTHONPATH=REPO,
    JAX_PLATFORMS="cpu",
)


def run_cli(args):
    return subprocess.run(
        [sys.executable, "-m", "bella_tpu.cli"] + args,
        capture_output=True, text=True, env=ENV, cwd=REPO, timeout=600,
    )


def test_reversecomp_sanity(tmp_path):
    out = tmp_path / "rc"
    r = run_cli(["-f", FIXTURE, "-o", str(out), "-k", "17", "-l", "2", "-u", "4"])
    assert r.returncode == 0, r.stderr
    rows = open(str(out) + ".out").read().splitlines()
    assert len(rows) == 1, rows
    v = rows[0].split("\t")
    # one pair, 'c' strand, full-length overlap
    assert v[0] == "fwd_read" and v[1] == "rc_read"
    assert v[5] == "c"
    assert int(v[4]) >= 990  # overlap ~ full 1000bp
    assert int(v[3]) >= 950  # near-perfect score


def test_reversecomp_hopc(tmp_path):
    """The RC sanity fixture through --hopc: the reverse-strand overlap
    must be found on the 'c' strand (round-1 zeroed is_rc in HOPC mode,
    so this produced a garbage forward alignment)."""
    out = tmp_path / "rchopc"
    r = run_cli(["-f", FIXTURE, "-o", str(out), "-k", "17", "-l", "2",
                 "-u", "4", "--hopc"])
    assert r.returncode == 0, r.stderr
    rows = open(str(out) + ".out").read().splitlines()
    assert len(rows) == 1, rows
    v = rows[0].split("\t")
    assert v[0] == "fwd_read" and v[1] == "rc_read"
    assert v[5] == "c"
    assert int(v[3]) >= 950  # near-perfect score on the RC pair


def test_skip_alignment_cli(tmp_path):
    out = tmp_path / "rc2"
    r = run_cli(
        ["-f", FIXTURE, "-o", str(out), "-k", "17", "-l", "2", "-u", "4",
         "--skip-alignment"]
    )
    assert r.returncode == 0, r.stderr
    rows = open(str(out) + ".out").read().splitlines()
    assert len(rows) == 1
    v = rows[0].split("\t")
    assert len(v) == 6
    assert int(v[3]) == 1000  # overlap estimate = full read length


def test_cli_missing_args():
    r = run_cli([])
    assert r.returncode == 2


def test_paf_cli(tmp_path):
    out = tmp_path / "rc3"
    r = run_cli(
        ["-f", FIXTURE, "-o", str(out), "-k", "17", "-l", "2", "-u", "4", "--paf"]
    )
    assert r.returncode == 0, r.stderr
    rows = open(str(out) + ".out").read().splitlines()
    assert len(rows) == 1
    v = rows[0].split("\t")
    assert len(v) == 12 and v[4] == "-"


def test_hifi_config_cli(tmp_path):
    """The BASELINE HiFi configuration: low error, split-count passes,
    PAF output (reference flags --error 0.005 --split-count N --paf)."""
    import numpy as np
    from bella_tpu.io.simulate import random_genome, sample_reads, write_fastq
    from bella_tpu.cli import main

    g = random_genome(12000, seed=71)
    reads, _ = sample_reads(
        g, 40, mean_len=1500, min_len=800, error_rate=0.005, seed=72,
        circular=False,
    )
    fq = tmp_path / "hifi.fastq"
    write_fastq(str(fq), reads)
    out = tmp_path / "hifi"
    rc = main([
        "-f", str(fq), "-o", str(out), "-k", "17", "-e", "0.005",
        "--split-count", "3", "--paf",
    ])
    assert rc == 0
    rows = (tmp_path / "hifi.out").read_text().splitlines()
    assert rows, "HiFi run produced no overlaps"
    f = rows[0].split("\t")
    # PAF: qname qlen qstart qend strand tname tlen tstart tend ...
    assert len(f) >= 12 and f[4] in "+-"
    assert int(f[3]) > int(f[2]) and int(f[8]) > int(f[7])


def test_multi_fastq_fofn(tmp_path):
    """Multiple fastq files via fofn concatenate with correct read ids."""
    from bella_tpu.io.simulate import random_genome, sample_reads, write_fastq
    from bella_tpu.cli import main

    g = random_genome(8000, seed=73)
    reads, _ = sample_reads(
        g, 30, mean_len=1200, min_len=600, error_rate=0.1, seed=74,
        circular=False,
    )
    # split into two files
    from bella_tpu.io.fastq import ReadSet

    half = reads.num_reads // 2
    seqs = [reads.sequence(i) for i in range(reads.num_reads)]
    a = ReadSet.from_sequences(seqs[:half], reads.names[:half])
    b = ReadSet.from_sequences(seqs[half:], reads.names[half:])
    write_fastq(str(tmp_path / "a.fastq"), a)
    write_fastq(str(tmp_path / "b.fastq"), b)
    fofn = tmp_path / "in.txt"
    fofn.write_text(f"{tmp_path}/a.fastq\n{tmp_path}/b.fastq\n")
    out = tmp_path / "multi"
    rc = main(["-f", str(fofn), "-o", str(out), "-k", "17", "--skip-alignment"])
    assert rc == 0
    rows = (tmp_path / "multi.out").read_text().splitlines()
    assert rows
    names = {n for r in rows for n in r.split()[:2]}
    assert names <= set(reads.names)


def test_degenerate_inputs(tmp_path):
    """Empty fastq and all-short reads exit with a diagnostic, not a
    traceback (reference include/kmercount.hpp:662-667 behavior)."""
    empty = tmp_path / "empty.fastq"
    empty.write_text("")
    r = run_cli(["-f", str(empty), "-o", str(tmp_path / "o1")])
    assert r.returncode == 1 and "ERROR:" in r.stderr

    short = tmp_path / "short.fastq"
    short.write_text("@r1\nACGT\n+\nIIII\n@r2\nACGT\n+\nIIII\n")
    r = run_cli(["-f", str(short), "-o", str(tmp_path / "o2"), "-k", "17"])
    assert r.returncode == 1 and "ERROR:" in r.stderr

    r = run_cli(["-f", "/nonexistent.fofn", "-o", str(tmp_path / "o3")])
    assert r.returncode != 0
