"""Native C parser must agree with the numpy parser exactly."""

import numpy as np
import pytest

from bella_tpu.io.fastq import ReadSet, parse_fastq
from bella_tpu.io.simulate import random_genome, sample_reads, write_fastq
from bella_tpu.native import get_lib, parse_fastq_native


@pytest.fixture(scope="module")
def fastq_file(tmp_path_factory):
    td = tmp_path_factory.mktemp("native")
    g = random_genome(5000, seed=21)
    reads, _ = sample_reads(g, 25, mean_len=600, min_len=200, error_rate=0.1, seed=22)
    p = td / "sim.fastq"
    write_fastq(str(p), reads, qual_char="5")
    return str(p)


def test_native_builds():
    assert get_lib() is not None, "g++ build of native parser failed"


def test_native_matches_numpy(fastq_file):
    native = parse_fastq_native(fastq_file)
    assert native is not None
    names, codes, offsets, err_sum, err_bases = native

    # numpy reference path (bypass native preference)
    import bella_tpu.io.fastq as fq
    import bella_tpu.native as nat

    saved = nat.parse_fastq_native
    nat.parse_fastq_native = lambda p: None
    try:
        ref = fq.parse_fastq(fastq_file)
    finally:
        nat.parse_fastq_native = saved

    assert names == ref.names
    assert np.array_equal(codes, ref.codes)
    assert np.array_equal(offsets, ref.offsets)
    assert err_bases == ref.err_bases
    assert abs(err_sum - ref.err_sum) < 1e-6 * max(ref.err_sum, 1)


def test_native_truncated_record(tmp_path):
    p = tmp_path / "t.fastq"
    p.write_text("@r1\nACGT\n+\nIIII\n@r2\nACGTACGT\n")
    rs = parse_fastq(str(p))
    assert rs.num_reads == 1 and rs.names == ["r1"]


def test_native_no_trailing_newline(tmp_path):
    p = tmp_path / "t.fastq"
    p.write_text("@r1\nACGT\n+\nIIII")
    rs = parse_fastq(str(p))
    assert rs.num_reads == 1
    assert rs.sequence(0) == "ACGT"


def test_native_paf_matches_python(tmp_path):
    """write_paf (C) emits byte-identical rows to paf_rows (python),
    including the '-'-strand coordinate flip."""
    import numpy as np

    from bella_tpu.io import writers
    from bella_tpu.io.fastq import ReadSet

    rng = np.random.default_rng(5)
    lens = np.array([500, 800, 650], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    reads = ReadSet(
        names=["rA", "rB/1", "rC longsuffix".split()[0]],
        codes=rng.integers(0, 4, int(lens.sum())).astype(np.int8),
        offsets=offsets.astype(np.int64),
        err_bases=0,
        err_sum=0.0,
    )
    rh = np.array([1, 2, 2], np.int32)
    rv = np.array([0, 0, 1], np.int32)
    score = np.array([120, 340, 77], np.int32)
    ov = np.array([400, 600, 300], np.int32)
    rc = np.array([False, True, False])
    bv = np.array([10, 20, 30], np.int32)
    ev = np.array([410, 620, 330], np.int32)
    bh = np.array([50, 40, 5], np.int32)
    eh = np.array([450, 640, 305], np.int32)

    path = str(tmp_path / "out.paf")
    ok = writers.write_paf_native(
        path, reads, rh, rv, score, ov, rc, bv, ev, bh, eh
    )
    assert ok, "native PAF writer unavailable"
    got = open(path).read()
    want = "".join(
        writers.paf_rows(reads, rh, rv, score, ov, rc, bv, ev, bh, eh)
    )
    assert got == want


def test_threaded_parse_matches_serial(tmp_path, monkeypatch):
    """Thread-partitioned parse (byte ranges resynced to record
    boundaries, incl. quality lines starting with '@') == serial parse."""
    import numpy as np
    from bella_tpu.io.simulate import random_genome, sample_reads, write_fastq
    from bella_tpu.native import parse_fastq_native, get_lib

    if get_lib() is None:
        import pytest

        pytest.skip("native library unavailable")
    g = random_genome(30000, seed=97)
    reads, _ = sample_reads(g, 80, mean_len=1500, min_len=400,
                            error_rate=0.1, seed=98, circular=False)
    p = tmp_path / "mt.fastq"
    # qual_char '@' makes EVERY quality line start with '@' — the resync
    # ambiguity the reference disambiguates (fq_reader.c:200-312)
    write_fastq(str(p), reads, qual_char="@")
    monkeypatch.setenv("BELLA_PARSE_THREADS", "1")
    a = parse_fastq_native(str(p))
    for nt in ("2", "5", "13"):
        monkeypatch.setenv("BELLA_PARSE_THREADS", nt)
        b = parse_fastq_native(str(p))
        assert a is not None and b is not None
        assert a[0] == b[0]                       # names
        assert (a[1] == b[1]).all()               # codes
        assert (a[2] == b[2]).all()               # offsets
        assert abs(a[3] - b[3]) < 1e-6            # err_sum


def test_parallel_writer_matches_serial(tmp_path, monkeypatch):
    """The parallel pwrite-at-offsets writer (overlap.hpp:603-640
    scheme) emits byte-identical files at any thread count."""
    import numpy as np
    import pytest

    from bella_tpu.io import writers
    from bella_tpu.io.simulate import random_genome, sample_reads
    from bella_tpu.native import get_lib

    if get_lib() is None:
        pytest.skip("native library unavailable")
    g = random_genome(12000, seed=99)
    reads, _ = sample_reads(g, 40, mean_len=1200, min_len=500,
                            error_rate=0.1, seed=100, circular=False)
    P = 5000
    rng = np.random.default_rng(7)
    h = rng.integers(1, reads.num_reads, P).astype(np.int32)
    v = (h - 1).astype(np.int32)
    cnt = rng.integers(1, 50, P).astype(np.int32)
    ov = rng.integers(500, 3000, P).astype(np.int32)
    outs = {}
    for nt in ("1", "7"):
        monkeypatch.setenv("BELLA_WRITE_THREADS", nt)
        p = tmp_path / f"ov{nt}.out"
        assert writers.write_overlap_native(
            str(p), reads,
            type("P", (), dict(read_h=h, read_v=v, count=cnt,
                               overlap_est=ov, num_pairs=P))(),
        )
        outs[nt] = p.read_bytes()
    assert outs["1"] == outs["7"] and outs["1"]


def test_library_keyed_by_source_and_portable(tmp_path, monkeypatch):
    """The built library's name carries a hash of source and flags, so
    an edited source rebuilds; no host-specific flag is used, so a copy
    made on one host loads on another."""
    import os

    import bella_tpu.native as nat

    path = nat.library_path()
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert not any("march" in f for f in nat._FLAGS)
    edited = tmp_path / "fastq_native.cpp"
    with open(nat._SRC) as f:
        edited.write_text(f.read() + "\n// edited\n")
    monkeypatch.setattr(nat, "_SRC", str(edited))
    assert nat.library_path() != path
