"""x-drop aligner vs a full-DP NumPy oracle (role of xavier/tester.py),
and the aligner driver (backend choice, batching, the wrapper around the
CUDA kernel) driven through the plain-JAX reference on the CPU."""

import numpy as np
import pytest

import jax.numpy as jnp

from bella_tpu import BellaConfig
from bella_tpu.align.xdrop import (
    _batch_bucket,
    _extend_both,
    _extender,
    _length_tier,
    _prepare_extensions,
    _lshift_rows,
    _pair_block,
    align_candidates,
    check_against_reference,
    extend_batch,
    in_step_order,
    pad_reads,
    resolve_aligner_backend,
)
from bella_tpu.io import ReadSet
from bella_tpu.overlap.pairs import CandidatePairs


def oracle_extend(t, q, xdrop, match=1, mis=-1, gap=-1):
    """Unbounded-band antidiagonal DP with Xavier's termination rule:
    stop when an antidiagonal's max drops more than xdrop below best
    (xavier/xavier.h:138-150). Returns (best, t_end, q_end)."""
    nt, nq = len(t), len(q)
    NI = -(10**9)
    D = np.full((nt + 1, nq + 1), NI, dtype=np.int64)
    D[0, 0] = 0
    for i in range(1, nt + 1):
        D[i, 0] = i * gap
    for j in range(1, nq + 1):
        D[0, j] = j * gap
    best, bt, bq = 0, 0, 0
    for d in range(1, nt + nq + 1):
        ilo, ihi = max(0, d - nq), min(nt, d)
        curmax = NI
        for i in range(ilo, ihi + 1):
            j = d - i
            if i > 0 and j > 0:
                s = match if t[i - 1] == q[j - 1] else mis
                D[i, j] = max(D[i - 1, j - 1] + s, D[i - 1, j] + gap, D[i, j - 1] + gap)
            curmax = max(curmax, D[i, j])
        # update best AFTER the xdrop check, mirroring the kernel
        if curmax < best - xdrop:
            break
        for i in range(ilo, ihi + 1):
            if D[i, d - i] > best:
                best, bt, bq = D[i, d - i], i, d - i
    return best, bt, bq


def mutate(seq, error_rate, rng):
    out = []
    for c in seq:
        r = rng.random()
        if r < error_rate / 3:
            out.append((c + rng.integers(1, 4)) % 4)  # sub
        elif r < 2 * error_rate / 3:
            out.append(rng.integers(0, 4))  # ins
            out.append(c)
        elif r < error_rate:
            pass  # del
        else:
            out.append(c)
    return np.array(out, dtype=np.int8)


def run_one(t, q, xdrop, band=128):
    L = max(len(t), len(q)) + 8
    T = np.full((1, L), 127, np.int8)
    Q = np.full((1, L), 127, np.int8)
    T[0, : len(t)] = t
    Q[0, : len(q)] = q
    out = extend_batch(
        jnp.asarray(T), jnp.asarray(np.array([len(t)], np.int32)),
        jnp.asarray(Q), jnp.asarray(np.array([len(q)], np.int32)),
        xdrop, band=band, max_steps=2 * L,
    )
    return int(out["score"][0]), int(out["t_end"][0]), int(out["q_end"][0])


def test_perfect_match():
    rng = np.random.default_rng(0)
    t = rng.integers(0, 4, 300).astype(np.int8)
    s, te, qe = run_one(t, t.copy(), xdrop=7)
    assert (s, te, qe) == (300, 300, 300)


def test_empty_and_tiny():
    assert run_one(np.zeros(0, np.int8), np.zeros(0, np.int8), 7) == (0, 0, 0)
    a = np.array([1], np.int8)
    assert run_one(a, a.copy(), 7) == (1, 1, 1)
    # single mismatch at start: best stays 0 (empty extension)
    assert run_one(np.array([1], np.int8), np.array([2], np.int8), 7)[0] == 0


def test_chimeric_pair_fails_threshold():
    """Banded DP on random DNA drifts slowly upward (max over band lanes),
    so x-drop alone doesn't clip a 200bp-repeat chimera — with the
    reference's rule either. What rejects it is the adaptive threshold:
    score ~ 200 + small drift stays far below (1-d)*phi*ov for ov~500
    only marginally... assert the score reflects ~the common prefix, not
    the full 500bp overlap a true pair would give."""
    rng = np.random.default_rng(1)
    common = rng.integers(0, 4, 200).astype(np.int8)
    t = np.concatenate([common, rng.integers(0, 4, 300).astype(np.int8)])
    q = np.concatenate([common, rng.integers(0, 4, 300).astype(np.int8)])
    s, te, qe = run_one(t, q, xdrop=7)
    assert 190 <= s <= 280  # far below the ~500 of a true full overlap
    assert te <= 500 and qe <= 500


def test_fully_random_pair_scores_low():
    rng = np.random.default_rng(11)
    t = rng.integers(0, 4, 1000).astype(np.int8)
    q = rng.integers(0, 4, 1000).astype(np.int8)
    s, te, qe = run_one(t, q, xdrop=7)
    # junk drift rate is well below the adaptive threshold slope
    # ((1-0.1)*slope(0.15) ~ 0.40/base); this is the property BELLA's
    # Chernoff cutoff relies on (include/overlap.hpp:454-461)
    assert s < 0.2 * 1000


@pytest.mark.parametrize("err,seed", [(0.0, 2), (0.05, 3), (0.10, 4), (0.15, 5), (0.25, 6)])
def test_matches_oracle(err, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, 400).astype(np.int8)
    t = base
    q = mutate(base, err, rng)
    for xdrop in (7, 15, 50):
        s, te, qe = run_one(t, q, xdrop)
        es, ete, eqe = oracle_extend(t, q, xdrop)
        assert s == es, (err, xdrop, s, es)
        assert (te, qe) == (ete, eqe), (err, xdrop, (te, qe), (ete, eqe))


def test_batch_matches_single():
    rng = np.random.default_rng(7)
    seqs = []
    for i in range(9):
        base = rng.integers(0, 4, int(rng.integers(50, 400))).astype(np.int8)
        seqs.append((base, mutate(base, 0.1, rng)))
    L = max(max(len(a), len(b)) for a, b in seqs) + 8
    T = np.full((9, L), 127, np.int8)
    Q = np.full((9, L), 127, np.int8)
    tl = np.zeros(9, np.int32)
    ql = np.zeros(9, np.int32)
    for i, (a, b) in enumerate(seqs):
        T[i, : len(a)] = a
        Q[i, : len(b)] = b
        tl[i], ql[i] = len(a), len(b)
    out = extend_batch(jnp.asarray(T), jnp.asarray(tl), jnp.asarray(Q), jnp.asarray(ql),
                       7, band=128, max_steps=2 * L)
    for i, (a, b) in enumerate(seqs):
        s, te, qe = run_one(a, b, 7)
        assert int(out["score"][i]) == s
        assert int(out["t_end"][i]) == te and int(out["q_end"][i]) == qe


def _mk_pairs(read_h, read_v, pos_h, pos_v, seed_rc):
    n = len(read_h)
    return CandidatePairs(
        read_h=np.array(read_h, np.int32), read_v=np.array(read_v, np.int32),
        pos_h=np.array(pos_h, np.int32), pos_v=np.array(pos_v, np.int32),
        count=np.ones(n, np.int32), matches=np.ones(n, np.int32),
        overlap_est=np.ones(n, np.int32), seed_rc=np.array(seed_rc, bool),
    )


def test_align_candidates_forward_overlap():
    rng = np.random.default_rng(8)
    g = rng.integers(0, 4, 600).astype(np.uint8)
    s1 = "".join("ACGT"[c] for c in g[:400])
    s2 = "".join("ACGT"[c] for c in g[200:])
    rs = ReadSet.from_sequences([s2, s1])  # read_h=1 is s1, read_v=0 is s2
    cfg = BellaConfig(kmer_size=17)
    # shared kmer: genome pos 300 -> s1 pos 300, s2 pos 100
    pairs = _mk_pairs([1], [0], [300], [100], [False])
    padded, lens = pad_reads(rs)
    aln = align_candidates(padded, lens, pairs, cfg)
    # perfect 200bp overlap: score 200, H aligns [200,400), V aligns [0,200)
    assert int(aln.score[0]) == 200
    assert int(aln.beg_h[0]) == 200 and int(aln.end_h[0]) == 400
    assert int(aln.beg_v[0]) == 0 and int(aln.end_v[0]) == 200


def test_align_candidates_revcomp():
    rng = np.random.default_rng(9)
    g = rng.integers(0, 4, 400).astype(np.uint8)
    s1 = "".join("ACGT"[c] for c in g)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    s2 = "".join(comp[c] for c in reversed(s1))
    rs = ReadSet.from_sequences([s1, s2])
    cfg = BellaConfig(kmer_size=17)
    # seed: s2 pos p corresponds to s1 pos 400-p-17; pick s1 pos 100 -> s2 pos 283
    pairs = _mk_pairs([1], [0], [283], [100], [True])
    padded, lens = pad_reads(rs)
    aln = align_candidates(padded, lens, pairs, cfg)
    assert int(aln.score[0]) == 400  # full-length rc match


# ----------------------------------------------------------------------
# extend_batch (the reference both backends must equal) vs the oracle
# ----------------------------------------------------------------------


@pytest.mark.parametrize("band", [32, 64, 128, 256])
@pytest.mark.parametrize("xdrop", [15, 50])
@pytest.mark.parametrize("err", [0.05, 0.15])
def test_matches_oracle_bands(band, xdrop, err):
    rng = np.random.default_rng(band + xdrop + int(err * 100))
    base = rng.integers(0, 4, 300).astype(np.int8)
    q = mutate(base, err, rng)
    assert run_one(base, q, xdrop, band=band) == oracle_extend(base, q, xdrop)


@pytest.mark.parametrize("band", [32, 64, 128])
def test_one_sided_drift_beyond_half_band(band):
    """Every 7th target base missing from the query: the optimal path
    drifts ~1 cell per 7 steps, far past W/2 over 1400 bases. The
    adaptive band follows it to the oracle's exact optimum."""
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, 1400).astype(np.int8)
    q = t[np.arange(len(t)) % 7 != 6].copy()
    s, te, qe = run_one(t, q, 50, band=band)
    assert abs(te - qe) > band // 2
    assert (s, te, qe) == oracle_extend(t, q, 50)


def test_length_tier_pow4_ladder():
    lens = np.array([1, 256, 300, 512, 1000, 1024, 1100, 4096, 5000, 20000])
    tiers = _length_tier(lens, 16384)
    assert tiers.tolist() == [
        512, 512, 1024, 1024, 1024, 1024, 4096, 4096, 16384, 16384,
    ]
    # cap at lmax
    assert _length_tier(np.array([20000]), 4096).tolist() == [4096]


def test_length_tier_read_tiers_cover_pair_tiers():
    # a pair's tier = tier of its longer read, so the read-length tiers
    # are a superset of the pair tiers (what compiling every tier of a
    # corpus ahead of its alignment relies on)
    rng = np.random.default_rng(0)
    lens = rng.integers(200, 30000, size=300)
    lmax = int(((lens.max() + 511) // 512) * 512)
    read_tiers = set(_length_tier(lens, lmax).tolist())
    h = rng.integers(0, 300, size=1000)
    v = rng.integers(0, 300, size=1000)
    pair_tiers = set(
        _length_tier(np.maximum(lens[h], lens[v]), lmax).tolist()
    )
    assert pair_tiers <= read_tiers


def test_batch_bucket():
    assert _batch_bucket(10, 4096) == 64      # tiny run: floor bucket
    assert _batch_bucket(100, 4096) == 128    # pow2 >= P
    assert _batch_bucket(10**6, 4096) == 4096 # big run: full batch
    assert _batch_bucket(1, 4096, ndev=8) == 64


# ----------------------------------------------------------------------
# backend choice and the kernel wrapper, driven through the reference
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name,expect", [
    ("auto", "jax"), ("jax", "jax"), ("cuda", RuntimeError),
    ("pallas", ValueError),
])
def test_backend_choice_on_cpu(name, expect):
    if isinstance(expect, str):
        assert resolve_aligner_backend(name) == expect
    else:
        with pytest.raises(expect):
            resolve_aligner_backend(name)


def test_config_rejects_unknown_backend():
    with pytest.raises(ValueError):
        BellaConfig(aligner_backend="pallas")


def test_explicit_cuda_without_gpu_raises_in_align():
    pairs = _mk_pairs([1], [0], [10], [10], [False])
    rs = ReadSet.from_sequences(["ACGT" * 50, "ACGT" * 50])
    padded, lens = pad_reads(rs)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        align_candidates(padded, lens, pairs, BellaConfig(aligner_backend="cuda"))


def _ext_batch(rng, B, L):
    ext = {}
    for side in ("l", "r"):
        T = np.full((B, L), 127, np.int8)
        Q = np.full((B, L), 127, np.int8)
        tl = rng.integers(0, L + 1, B).astype(np.int32)
        ql = np.zeros(B, np.int32)
        for i in range(B):
            t = rng.integers(0, 4, tl[i]).astype(np.int8)
            q = mutate(t, 0.1, rng)[:L]
            T[i, : tl[i]], Q[i, : len(q)] = t, q
            ql[i] = len(q)
        ext[side + "t"], ext[side + "q"] = jnp.asarray(T), jnp.asarray(Q)
        ext[side + "t_len"], ext[side + "q_len"] = jnp.asarray(tl), jnp.asarray(ql)
    return ext


def test_extend_both_orders_rows_and_restores_pairs():
    """The CUDA path's wrapper (_extend_both over in_step_order) hands
    the kernel 2B rows in step-count order and maps results back: equal
    to separate left and right reference calls."""
    rng = np.random.default_rng(21)
    B, L = 12, 160
    ext = _ext_batch(rng, B, L)
    seen = {}

    def spy(T, tl, Q, ql, xdrop, band, max_steps):
        seen["steps"] = np.asarray(tl + ql)
        return extend_batch(T, tl, Q, ql, xdrop, band=band, max_steps=max_steps)

    left, right = _extend_both(ext, in_step_order(spy), 7, 64, 2 * L)
    assert seen["steps"].shape == (2 * B,)
    assert np.all(np.diff(seen["steps"]) >= 0)
    for side, got in (("l", left), ("r", right)):
        ref = extend_batch(ext[side + "t"], ext[side + "t_len"], ext[side + "q"],
                           ext[side + "q_len"], 7, band=64, max_steps=2 * L)
        for k in ("score", "t_end", "q_end"):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


def test_extend_both_split_is_left_then_right():
    """Rows [0, B) of the permuted call are the left extensions: a fake
    kernel that returns each row's own t_len shows the split."""
    rng = np.random.default_rng(22)
    ext = _ext_batch(rng, 5, 40)

    def echo(T, tl, Q, ql, xdrop, band, max_steps):
        return dict(score=tl, t_end=ql, q_end=tl + ql)

    left, right = _extend_both(ext, echo, 7, 32, 80)
    np.testing.assert_array_equal(np.asarray(left["score"]), np.asarray(ext["lt_len"]))
    np.testing.assert_array_equal(np.asarray(right["t_end"]), np.asarray(ext["rq_len"]))


def test_reference_rows_keep_pair_order():
    """The plain-JAX extender runs rows as given (no permutation: its
    batch moves in lockstep, so row order cannot shorten it)."""
    assert _extender("jax") is extend_batch
    rng = np.random.default_rng(25)
    ext = _ext_batch(rng, 6, 30)
    seen = {}

    def spy(T, tl, Q, ql, xdrop, band, max_steps):
        seen["tl"] = np.asarray(tl)
        return dict(score=tl, t_end=tl, q_end=tl)

    _extend_both(ext, spy, 7, 32, 60)
    np.testing.assert_array_equal(
        seen["tl"], np.concatenate([ext["lt_len"], ext["rt_len"]]))


def test_padding_rows_extend_nothing():
    """Tail-padding rows (valid False) get empty extensions on both
    strands, so they cost the kernel no antidiagonals."""
    rng = np.random.default_rng(24)
    reads = jnp.asarray(rng.integers(0, 4, (4, 64)).astype(np.int8))
    lens = jnp.asarray(np.array([60, 50, 40, 30], np.int32))
    ext = _prepare_extensions(
        reads, lens, jnp.array([1, 1, 3]), jnp.array([0, 0, 2]),
        jnp.array([5, 5, 5]), jnp.array([7, 7, 7]),
        jnp.array([False, True, True]), 17, jnp.array([True, False, False]),
    )
    for k in ("lt_len", "lq_len", "rt_len", "rq_len"):
        got = np.asarray(ext[k])
        assert got[0] > 0 and (got[1:] == 0).all(), k


def test_lshift_rows_matches_numpy():
    rng = np.random.default_rng(23)
    x = rng.integers(0, 4, (6, 20)).astype(np.int8)
    s = np.array([0, 1, 5, 19, 20, 3], np.int32)
    got = np.asarray(_lshift_rows(jnp.asarray(x), jnp.asarray(s)))
    for b in range(6):
        want = np.full(20, 127, np.int8)
        want[: 20 - s[b]] = x[b, s[b]:]
        np.testing.assert_array_equal(got[b], want)


def test_pair_block_row_order():
    pairs = _mk_pairs([3, 4], [1, 2], [10, 20], [30, 40], [True, False])
    blk = _pair_block(pairs, np.array([1, 0]), np.array([True, False]))
    assert blk.dtype == np.int32
    assert blk.tolist() == [[4, 3], [2, 1], [20, 10], [40, 30], [0, 1], [1, 0]]


def _sim_pairs(seed, n_reads=30):
    from bella_tpu.io.simulate import random_genome, sample_reads
    from bella_tpu.overlap.pairs import detect_overlaps

    g = random_genome(6000, seed=seed)
    rs, _ = sample_reads(g, n_reads, mean_len=900, min_len=400,
                         error_rate=0.12, seed=seed + 1, circular=False)
    pairs, _, _ = detect_overlaps(rs, BellaConfig())
    assert pairs.num_pairs > 40
    return rs, pairs


@pytest.mark.parametrize("batch_size", [64, 128])
def test_batching_and_tail_padding_do_not_change_results(batch_size):
    """Many small batches (each tail padded with invalid rows) equal one
    large batch."""
    rs, pairs = _sim_pairs(53)
    padded, lens = pad_reads(rs)
    cfg = BellaConfig(aligner_backend="jax")
    one = align_candidates(padded, lens, pairs, cfg)
    many = align_candidates(padded, lens, pairs, cfg, batch_size=batch_size)
    for f in ("score", "beg_h", "end_h", "beg_v", "end_v"):
        np.testing.assert_array_equal(getattr(one, f), getattr(many, f), err_msg=f)


def test_reads_argument_pads_on_demand():
    rs, pairs = _sim_pairs(51, n_reads=24)
    padded, lens = pad_reads(rs)
    cfg = BellaConfig()
    a_pad = align_candidates(padded, lens, pairs, cfg)
    a_rs = align_candidates(None, lens, pairs, cfg, reads=rs)
    for f in ("score", "beg_h", "end_h", "beg_v", "end_v"):
        np.testing.assert_array_equal(getattr(a_pad, f), getattr(a_rs, f), err_msg=f)


def test_selfcheck_compares_against_reference(capsys):
    rs, pairs = _sim_pairs(55, n_reads=24)
    padded, lens = pad_reads(rs)
    align_candidates(padded, lens, pairs, BellaConfig(selfcheck=True))
    assert "alignCheck" in capsys.readouterr().err


def test_selfcheck_checks_the_widest_tier(monkeypatch):
    """The selfcheck batch is the last one dispatched: the widest length
    tier, not the shortest pairs that go first."""
    from bella_tpu.align import xdrop
    from bella_tpu.utils import log as blog

    rs, pairs = _sim_pairs(56)
    padded, lens = pad_reads(rs)
    pair_len = np.maximum(lens[pairs.read_h], lens[pairs.read_v])
    tiers = _length_tier(pair_len, padded.shape[1])
    assert tiers.min() < tiers.max()
    checked = []
    real_check = xdrop.check_against_reference

    def spy(got, ref, backend):
        checked.append(got.shape[1])
        real_check(got, ref, backend)

    monkeypatch.setattr(xdrop, "check_against_reference", spy)
    align_candidates(padded, lens, pairs, BellaConfig(selfcheck=True), batch_size=64)
    assert blog.LAST["alignCheckTier"] == tiers.max()
    last = (pairs.num_pairs - 1) % 64 + 1  # size of the tail batch
    assert checked == [last]


def test_check_against_reference_is_exact():
    ref = np.arange(15, dtype=np.int32).reshape(5, 3)
    check_against_reference(ref.copy(), ref, "cuda")
    bad = ref.copy()
    bad[0, 2] += 1  # one score off by one
    with pytest.raises(RuntimeError, match="1/3 pairs"):
        check_against_reference(bad, ref, "cuda")


@pytest.mark.parametrize("ndev", [2, 8])
def test_mesh_alignment_parity(ndev):
    """Mesh alignment (shard_map, pair rows sharded, reads replicated)
    on the virtual CPU mesh equals the one-device result."""
    from bella_tpu.parallel.sharded import make_mesh

    rs, pairs = _sim_pairs(57)
    padded, lens = pad_reads(rs)
    cfg = BellaConfig(aligner_backend="jax")
    ref = align_candidates(padded, lens, pairs, cfg)
    got = align_candidates(padded, lens, pairs, cfg, mesh=make_mesh(ndev))
    for f in ("score", "beg_h", "end_h", "beg_v", "end_v"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
