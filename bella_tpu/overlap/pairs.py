"""Candidate-pair generation: the A @ A^T SpGEMM with a positional semiring.

Sort-based re-design of the reference HashSpGEMM + chaining stack
(include/overlap.hpp:651, include/chain.hpp, include/common/common.h:119-183).

Key observation: reliable k-mers have multiplicity <= upper_freq (8 by
default), so each k-mer segment of the k-mer-major occurrence stream
expands into at most U*(U-1)/2 read pairs. The whole SpGEMM is therefore:

  1. EMIT   - for lag d in 1..U-1, pair occurrence i with occurrence i-d
              of the same k-mer segment (static U-1 shifted slices; no
              hash tables, no dynamic shapes),
  2. SORT   - one lexicographic device sort by (pair, bin, posH),
  3. REDUCE - segmented scans implement the chainop/choose semiring:
              bin shared k-mers by overlap estimate, majority-vote the
              bin, emit one seed per pair.

Lower-triangular-only output (row read > column read) mirrors
include/overlap.hpp:315-316. The semiring semantics follow chain.hpp:
  - overlapop (chain.hpp:48-71): strand via seed equality, overlap
    estimate = min margins + k,
  - chainop  (chain.hpp:101-150): k-mers whose estimates agree within
    bin_size vote together; support counts well-separated k-mers
    (> kmer_size apart),
  - choose/chain (common.h:142-170): the most-supported bin wins, its
    first k-mer is the alignment seed.
Binning here is by quantized estimate (ov // bin_size) and support by
distinct posH // (k+1) buckets, instead of the reference's data-order
greedy merge: deterministic, order-free, equivalent in aggregate
(validated by recall/precision parity tests).

Memory staging: when the expanded candidate stream would exceed the
memory budget, emission runs in k-mer-range stages (the reference's
column-block staging, include/overlap.hpp:682-710) whose valid rows are
spilled to host, re-sorted, and chained in pair-aligned chunks.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bella_tpu.config import BellaConfig
from bella_tpu.kmers.count import ReliableTriples
from bella_tpu.utils import segments as seg
from bella_tpu.utils.log import log

_U64 = jnp.uint64
PAIR_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)

# device bytes per expanded candidate row in the fused kernel (key 8,
# bin 4, posH 4, posV 4, flip 1, ov 4; x2 for the out-of-place sort)
_ROW_BYTES = 50


@dataclasses.dataclass
class CandidatePairs:
    """One row per candidate read pair (H = larger read id = "row" read,
    V = smaller = "column" read, matching RunPairWiseAlignments rid/cid,
    include/overlap.hpp:533-537)."""

    read_h: np.ndarray    # (P,) int32
    read_v: np.ndarray    # (P,) int32
    pos_h: np.ndarray     # (P,) int32 seed k-mer start on H (raw coords)
    pos_v: np.ndarray     # (P,) int32 seed k-mer start on V
    count: np.ndarray     # (P,) int32 total shared k-mer occurrences
    matches: np.ndarray   # (P,) int32 support of the winning bin
    overlap_est: np.ndarray  # (P,) int32 overlap estimate of the seed
    seed_rc: np.ndarray   # (P,) bool  seed strands disagree -> 'c' strand

    @property
    def num_pairs(self) -> int:
        return int(self.read_h.shape[0])

    @staticmethod
    def empty() -> "CandidatePairs":
        z = np.zeros(0, np.int32)
        return CandidatePairs(z, z, z, z, z, z, z, np.zeros(0, bool))

    @staticmethod
    def concatenate(parts) -> "CandidatePairs":
        parts = [p for p in parts if p.num_pairs]
        if not parts:
            return CandidatePairs.empty()
        return CandidatePairs(
            *(np.concatenate([getattr(p, f.name) for p in parts])
              for f in dataclasses.fields(CandidatePairs))
        )

    def take_prefix(self, n: int) -> "CandidatePairs":
        """First n rows (the speculative-size path over-fetches the seed
        block and trims to the verified count on host)."""
        if n >= self.num_pairs:
            return self
        return CandidatePairs(
            *(getattr(self, f.name)[:n]
              for f in dataclasses.fields(CandidatePairs))
        )


def _emit_slices(kmer_ids, read_ids, positions, is_rc, upper_freq: int):
    """EMIT stage: U-1 shifted slices over k-mer segments."""
    kb = seg.boundaries(kmer_ids)
    rank = seg.seg_rank(kb)
    valid_occ = kmer_ids >= 0

    keys, phs, pvs, rchs, rcvs = [], [], [], [], []
    for d in range(1, upper_freq):
        ra, rb = read_ids[d:], read_ids[:-d]
        pa, pb = positions[d:], positions[:-d]
        ca, cb = is_rc[d:], is_rc[:-d]
        ok = (rank[d:] >= d) & (ra != rb) & valid_occ[d:]
        h_is_a = ra > rb
        h = jnp.where(h_is_a, ra, rb)
        v = jnp.where(h_is_a, rb, ra)
        key = (h.astype(_U64) << _U64(32)) | v.astype(_U64)
        keys.append(jnp.where(ok, key, jnp.asarray(PAIR_SENTINEL)))
        phs.append(jnp.where(h_is_a, pa, pb))
        pvs.append(jnp.where(h_is_a, pb, pa))
        rchs.append(jnp.where(h_is_a, ca, cb))
        rcvs.append(jnp.where(h_is_a, cb, ca))

    key = jnp.concatenate(keys)
    pos_h = jnp.concatenate(phs).astype(jnp.int32)
    pos_v = jnp.concatenate(pvs).astype(jnp.int32)
    rc_h = jnp.concatenate(rchs)
    rc_v = jnp.concatenate(rcvs)
    return key, pos_h, pos_v, rc_h, rc_v


def _multiop(key, pos_h, pos_v, rc_h, rc_v, read_lengths, kmer_size: int):
    """Per-candidate semiring multiply: strand + overlap estimate
    (overlapop, chain.hpp:48-71)."""
    k = kmer_size
    h = (key >> _U64(32)).astype(jnp.int32)
    v = key.astype(jnp.int32)  # low 32 bits; junk for sentinels (masked)
    len_h = read_lengths[jnp.clip(h, 0, read_lengths.shape[0] - 1)]
    len_v = read_lengths[jnp.clip(v, 0, read_lengths.shape[0] - 1)]
    flip = rc_h != rc_v
    beg_h = jnp.where(flip, len_h - pos_h - k, pos_h)
    ov = (
        jnp.minimum(beg_h, pos_v)
        + jnp.minimum(len_h - (beg_h + k), len_v - (pos_v + k))
        + k
    ).astype(jnp.int32)
    return flip, ov


def _chain_sorted(key, bin_id, pos_h, pos_v, flip, ov, kmer_size: int):
    """REDUCE stage on a (pair, bin, posH)-sorted stream."""
    k = kmer_size
    live = key != jnp.asarray(PAIR_SENTINEL)
    pair_b = seg.boundaries(key)
    bin_b = seg.boundaries2(key, bin_id)

    # support counts well-separated k-mers (> kmer_size apart in the
    # reference's distance predicate, chain.hpp:89-97,121): distinct
    # posH // (k+1) buckets per bin, order-free
    bucket = pos_h // (k + 1)
    prev_bucket = jnp.concatenate([bucket[:1], bucket[:-1]])
    dup = (~bin_b) & (bucket == prev_bucket)
    kept = (~dup) & live

    support = seg.seg_sum_bcast(kept.astype(jnp.int32), bin_b)
    count = seg.seg_sum_bcast(live.astype(jnp.int32), pair_b)

    # majority vote: max support, tie -> lowest bin (deterministic stand-in
    # for the reference's insertion-order tie-break, common.h:142-148).
    # int64 score: unpacked paths allow positions > 16 bit, so support
    # can exceed 2^15 (gather-free scans, see utils/segments.py)
    binidx = seg.seg_cumsum(bin_b.astype(jnp.int32), pair_b)
    score = support.astype(jnp.int64) * (1 << 31) + ((1 << 31) - binidx)
    best = seg.seg_max_bcast(score, pair_b)
    seed_mask = (score == best) & bin_b & live

    return dict(
        seed_mask=seed_mask,
        read_h=(key >> _U64(32)).astype(jnp.int32),
        read_v=key.astype(jnp.int32),
        pos_h=pos_h,
        pos_v=pos_v,
        count=count.astype(jnp.int32),
        matches=support,
        overlap_est=ov,
        seed_rc=flip,
    )


@partial(jax.jit, static_argnames=("upper_freq", "kmer_size", "bin_size"))
def _emit_and_chain(
    kmer_ids, read_ids, positions, is_rc, read_lengths,
    upper_freq: int, kmer_size: int, bin_size: int,
):
    """Fused single-stage kernel: EMIT -> multiop -> SORT -> REDUCE."""
    key, pos_h, pos_v, rc_h, rc_v = _emit_slices(
        kmer_ids, read_ids, positions, is_rc, upper_freq
    )
    flip, ov = _multiop(key, pos_h, pos_v, rc_h, rc_v, read_lengths, kmer_size)
    bin_id = (ov // bin_size).astype(jnp.int32)
    key, bin_id, pos_h, pos_v, flip, ov = jax.lax.sort(
        (key, bin_id, pos_h, pos_v, flip, ov), num_keys=4
    )
    return _chain_sorted(key, bin_id, pos_h, pos_v, flip, ov, kmer_size)


@partial(jax.jit, static_argnames=("upper_freq", "kmer_size", "bin_size"))
def _emit_stage(
    kmer_ids, read_ids, positions, is_rc, read_lengths,
    upper_freq: int, kmer_size: int, bin_size: int,
):
    """Staged path, phase 1: emit + multiop only (rows spill to host)."""
    key, pos_h, pos_v, rc_h, rc_v = _emit_slices(
        kmer_ids, read_ids, positions, is_rc, upper_freq
    )
    flip, ov = _multiop(key, pos_h, pos_v, rc_h, rc_v, read_lengths, kmer_size)
    return dict(key=key, pos_h=pos_h, pos_v=pos_v, flip=flip, ov=ov)


@partial(jax.jit, static_argnames=("kmer_size",))
def _chain_stage(key, bin_id, pos_h, pos_v, flip, ov, kmer_size: int):
    """Staged path, phase 2: sort + reduce one pair-aligned chunk."""
    key, bin_id, pos_h, pos_v, flip, ov = jax.lax.sort(
        (key, bin_id, pos_h, pos_v, flip, ov), num_keys=4
    )
    return _chain_sorted(key, bin_id, pos_h, pos_v, flip, ov, kmer_size)


_FIELDS = (
    "read_h", "read_v", "pos_h", "pos_v", "count", "matches",
    "overlap_est", "seed_rc",
)
# packed-dict variant (_chain_packed): h/v and count/matches ride as
# single u32 columns until after the seed compaction
_FIELDS_PACKED = ("hv", "cm", "pos_h", "pos_v", "overlap_est", "seed_rc")
# wide-id packed variant (_chain_wide): read ids up to 2^31 ride as two
# u32 columns, count/matches stay packed
_FIELDS_WIDE = ("read_h", "read_v", "cm", "pos_h", "pos_v",
                "overlap_est", "seed_rc")


@partial(jax.jit, static_argnames=("size", "fields"))
def _gather_seeds(out, size: int, fields=_FIELDS):
    """Device-side compaction: find the seed-row indices with a
    SINGLE-operand sort (dead bit in bit 31, row index below — streams
    are < 2^31 rows), then gather the eight field arrays at just those
    `size` indices. Multi-million-row sorts pay per operand, so one
    operand plus small-output gathers moves far fewer bytes than a
    10-operand sort; the device->host transfer stays proportional to
    the number of PAIRS, not the candidate stream."""
    n = out["seed_mask"].shape[0]
    if size <= (1 << 18):
        # few seeds: find their indices with a SINGLE-operand sort (dead
        # bit in bit 31, row index below) and gather the eight fields at
        # just those rows — gather cost scales with the OUTPUT size
        key = (
            ((~out["seed_mask"]).astype(jnp.uint32) << jnp.uint32(31))
            | jax.lax.iota(jnp.uint32, n)
        )
        skey = jax.lax.sort(key)
        idx = (skey[:size] & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
        cols = [jnp.take(out[f], idx, axis=0) for f in fields]
    else:
        # many seeds (large corpora): carry the payloads through a
        # stable multi-operand sort instead of multi-million-row gathers
        dead = (~out["seed_mask"]).astype(jnp.uint32)
        iota = jax.lax.iota(jnp.int32, n)
        sorted_all = jax.lax.sort(
            (dead, iota) + tuple(out[f] for f in fields), num_keys=2
        )
        cols = [a[:size] for a in sorted_all[2:]]
    # one stacked (F, size) int32 block -> ONE device->host transfer
    return jnp.stack([a.astype(jnp.int32) for a in cols])


def _compact(out, live_rows=None) -> CandidatePairs:
    num = int(jnp.sum(out["seed_mask"]))
    if num == 0:
        return CandidatePairs.empty()
    n = int(out["seed_mask"].shape[0])
    if live_rows is not None:
        # the chain sort pushed live rows (and therefore every seed row)
        # to the front of the stream: compact only that prefix
        lim = min(_size_bucket(max(int(live_rows), 1 << 10)), n)
        if lim < n:
            out = {f: a[:lim] for f, a in out.items()}
            n = lim
    size = 1 << max(10, (num - 1).bit_length())  # pow2 buckets: stable jits
    size = min(size, n)
    packed = "hv" in out
    wide = (not packed) and "cm" in out
    names = _FIELDS_PACKED if packed else (_FIELDS_WIDE if wide else _FIELDS)
    stacked = np.asarray(_gather_seeds(out, size, fields=names))[:, :num]
    fields = dict(zip(names, stacked))
    if packed:
        hv = fields.pop("hv").astype(np.uint32)
        fields["read_h"] = (hv >> 16).astype(np.int32)
        fields["read_v"] = (hv & 0xFFFF).astype(np.int32)
    if packed or wide:
        cm = fields.pop("cm").astype(np.uint32)
        fields["count"] = (cm >> 16).astype(np.int32)
        fields["matches"] = (cm & 0xFFFF).astype(np.int32)
    fields["seed_rc"] = fields["seed_rc"].astype(bool)
    return CandidatePairs(**fields)


_SENT32 = np.int32(0x7FFFFFFF)


@partial(jax.jit, static_argnames=("kmer_size", "use_hopc", "pack_ridpos"))
def _extract_kmers(
    codes, lengths, offsets, n_real=None,
    kmer_size: int = 17, use_hopc: bool = False, pack_ridpos: bool = False,
):
    """Phase 1a: unpack + canonicalise the k-mer stream (unsorted).

    A SEPARATE program from the sort and from the counting scans: in a
    merged program the canonicalisation temporaries, the out-of-place
    sort and the scan buffers coexist in one allocation plan, so its
    peak is their sum rather than the largest of them.

    The sort keys are the canonical k-mer split into two uint32 halves
    (a 32-bit comparator; whether one packed u64 key is faster on the
    GPU is not measured yet). Read-id/position
    streams are derived on device from (lengths, offsets) — uploading
    them precomputed would triple the host->device transfer."""
    from bella_tpu.seq.encode import canonical_kmers, hopc_kmers, pack_kmers

    k = kmer_size
    if codes.dtype == jnp.uint8 and codes.ndim == 2:
        # codes arrive 2-bit packed 4/byte (4x smaller host->device
        # transfer); unpack on device
        shifts = jnp.arange(4, dtype=jnp.uint8)[None, :] * jnp.uint8(2)
        codes = ((codes >> shifts) & jnp.uint8(3)).reshape(-1)
    total = codes.shape[0]
    nreads = lengths.shape[0]
    rid_per_base = jnp.repeat(
        jnp.arange(nreads, dtype=jnp.int32), lengths, total_repeat_length=total
    )
    rid = rid_per_base[: total - k + 1]
    valid = rid == rid_per_base[k - 1:]
    if n_real is not None:
        # occurrences of the shape-bucketing phantom read are masked out
        valid = valid & (rid < n_real)
    pos = (
        jnp.arange(total - k + 1, dtype=jnp.int32)
        - offsets[:-1].astype(jnp.int32)[rid]
    )
    if use_hopc:
        # true strand of the compressed window rides along (compression
        # commutes with revcomp, see seq/encode.py hopc_kmers)
        canon, _len, is_rc = hopc_kmers(codes, k)
    else:
        packed = pack_kmers(codes, k)
        canon, is_rc = canonical_kmers(packed, k)
    canon = jnp.where(valid, canon, jnp.asarray(PAIR_SENTINEL))
    is_rc = is_rc & valid
    khi = (canon >> _U64(32)).astype(jnp.uint32)
    klo = canon.astype(jnp.uint32)

    if pack_ridpos:
        # caller guarantees real read ids and positions fit 16 bits:
        # the sort moves every operand through every compare-exchange,
        # so 3 payload operands -> 2 is ~20% less traffic on the hot
        # sort. Rows whose position overflows 16 bits (the
        # shape-bucketing phantom read) are already invalid ->
        # sentinel keys, and their garbage payloads are never read.
        u32 = jnp.uint32
        ridpos = (rid.astype(u32) << u32(16)) | (pos.astype(u32) & u32(0xFFFF))
        return khi, klo, ridpos, is_rc, None
    return khi, klo, rid, is_rc, pos


@partial(jax.jit, static_argnames=("kmer_size", "pack_ridpos"))
def _extract_kmers_phased(
    codes_bytes, lengths, offsets, n_real=None,
    kmer_size: int = 17, pack_ridpos: bool = False,
):
    """Phase 1a for 2-bit-PACKED uploads: the reference's 4-phase
    bit-shift extraction (kmercode/Kmer.cpp:232-298) as 1-D u64 ops.

    No unpacked (m/4, 4) buffer is built: an 8-byte sliding window W[j]
    (u64, 32 consecutive bases LSB-first) yields the k-mer
    at position 4j+s as bits [2s, 2s+2k) — so each of the 4 phase
    streams is pure 1-D elementwise work, and the phases concatenate
    (order is irrelevant: everything downstream sorts). Requires
    k <= 28 (phase 3 reaches base offset s+k-1 <= 31).

    codes_bytes: (m/4 + 8,) uint8, 8 zero pad bytes beyond the stream.
    Emits one row per base position (rows whose k-mer would cross a
    read boundary or the stream end are sentinel-masked)."""
    from bella_tpu.seq.encode import canonical_from_window

    k = kmer_size
    u32, u64 = jnp.uint32, _U64
    mb = codes_bytes.shape[0] - 8
    total_p = 4 * mb
    nreads = lengths.shape[0]
    b64 = codes_bytes.astype(u64)

    def body(t, w):
        return w | (
            jax.lax.dynamic_slice(b64, (t,), (mb,)) << (u64(8) * t.astype(u64))
        )

    W = jax.lax.fori_loop(0, 8, body, jnp.zeros((mb,), u64))

    off32 = offsets.astype(jnp.int32)
    j32 = jnp.arange(mb, dtype=jnp.int32)
    # per-phase read ids AND read-start offsets, built by ONE scatter-add
    # + one prefix sum over the 1-D phase streams. Phase s covers
    # positions 4j+s, so read r (starting at off[r]) first appears at
    # j = ceil((off[r]-s)/4); rows 0-3 scatter count markers (prefix sum
    # = rid+1), rows 4-7 scatter OFFSET DELTAS off[r]-off[r-1] (prefix
    # sum = off[rid] — reads are stream-ordered, so the deltas
    # telescope), which deletes the four per-phase off32[rid] gathers.
    # All work stays 1-D mb-sized.
    # out-of-range j0 (read starts after the last phase-s position) is
    # correctly dropped from BOTH halves: no in-range position belongs
    # to it, and any later read's marker+delta are dropped too.
    o = off32[:-1]
    delta = jnp.concatenate([o[:1], o[1:] - o[:-1]])
    rows = jnp.concatenate(
        [jnp.full(o.shape, s2, jnp.int32) for s2 in range(8)]
    )
    cols = jnp.concatenate(
        [jnp.maximum(o - s2 + 3, 0) >> 2 for s2 in range(4)] * 2
    )
    vals = jnp.concatenate(
        [jnp.ones(o.shape, jnp.int32)] * 4 + [delta] * 4
    )
    ind8 = jnp.zeros((8, mb), jnp.int32).at[rows, cols].add(
        vals, mode="drop"
    )
    if mb <= (1 << 23):
        # all eight streams share one unrolled Hillis-Steele sweep
        x = ind8
        d = 1
        while d < mb:
            x = x + jnp.concatenate(
                [jnp.zeros((8, d), jnp.int32), x[:, :-d]], axis=1
            )
            d <<= 1
    else:
        # huge shapes: one cumsum HLO keeps the allocation plan small
        # (the unrolled chain plans log2(N) temporaries)
        x = jnp.cumsum(ind8, axis=1)
    rids = [x[s] - 1 for s in range(4)]
    ostarts = [x[4 + s] for s in range(4)]

    khis, klos, p1s, p2s, rcs = [], [], [], [], []
    for s in range(4):
        # one bitrev per phase: the twin is (~raw & mask) in this
        # window layout (see canonical_from_window)
        canon, is_rc = canonical_from_window(W >> u64(2 * s), k)
        g = 4 * j32 + jnp.int32(s)
        rid = rids[s]
        pos = g - ostarts[s]
        # k-mer validity: same read at the last base, inside the stream
        s2 = (s + k - 1) % 4
        dj = (s + k - 1) // 4
        rid_end = jnp.concatenate([
            rids[s2][dj:], jnp.full((dj,), nreads - 1, jnp.int32)
        ]) if dj else rids[s2]
        valid = (rid == rid_end) & (g <= jnp.int32(total_p - k))
        if n_real is not None:
            valid = valid & (rid < n_real)
        canon = jnp.where(valid, canon, jnp.asarray(PAIR_SENTINEL))
        khis.append((canon >> u64(32)).astype(u32))
        klos.append(canon.astype(u32))
        rcs.append(is_rc & valid)
        if pack_ridpos:
            p1s.append(
                (rid.astype(u32) << u32(16)) | (pos.astype(u32) & u32(0xFFFF))
            )
        else:
            p1s.append(rid)
            p2s.append(pos)
    khi = jnp.concatenate(khis)
    klo = jnp.concatenate(klos)
    sc = jnp.concatenate(rcs)
    p1 = jnp.concatenate(p1s)
    p2 = jnp.concatenate(p2s) if not pack_ridpos else None
    return khi, klo, p1, sc, p2


_CHUNK_BASES = 24_000_000  # upload/extract pipeline quantum (~6 MB packed)


@partial(jax.jit, static_argnames=("kmer_size", "pack_ridpos"))
def _extract_chunk(codes_bytes, lengths, offsets, n_real, rid_base,
                   kmer_size: int, pack_ridpos: bool):
    """Chunked phase 1a: 4-phase extraction of one read-aligned chunk
    with global read ids (rid_base offset). All chunks share ONE
    compiled shape (codes padded to the chunk bucket, read count padded
    with zero-length reads that own no positions), so the host can
    pipeline chunk i+1's upload with chunk i's extraction."""
    u32 = jnp.uint32
    if pack_ridpos:
        khi, klo, ridpos, sc, _ = _extract_kmers_phased(
            codes_bytes, lengths, offsets, n_real,
            kmer_size=kmer_size, pack_ridpos=True,
        )
        # chunk-local -> global ids; phantom/pad rows are sentinel-keyed,
        # their payloads are never read (same contract as _chunk_partition)
        ridpos = ridpos + (rid_base.astype(u32) << u32(16))
        return khi, klo, ridpos, sc, None
    khi, klo, rid, sc, pos = _extract_kmers_phased(
        codes_bytes, lengths, offsets, n_real,
        kmer_size=kmer_size, pack_ridpos=False,
    )
    return khi, klo, rid + rid_base, sc, pos


def _extract_stream_chunked(reads, kmer_size: int, pack_ridpos: bool):
    """Host pipeline over read-aligned chunks: pack chunk i+1 on host
    while chunk i uploads and extracts on device. Returns the
    concatenated (khi, klo, p1, sc, p2) occurrence stream (p2 None when
    pack_ridpos)."""
    offsets = reads.offsets.astype(np.int64)
    R = reads.num_reads
    total = len(reads.codes)
    max_len = int(reads.lengths.max()) if R else 0
    nchunks = max(int(np.ceil(total / _CHUNK_BASES)), 2)
    cb = _size_bucket(max(-(-total // nchunks), max_len + 8, 1 << 16))
    cb = ((cb + 3) // 4) * 4
    bounds = [0]
    while bounds[-1] < R:
        lo = bounds[-1]
        hi = lo + 1
        while hi < R and offsets[hi + 1] - offsets[lo] <= cb:
            hi += 1
        bounds.append(hi)
    nr_max = max(b - a for a, b in zip(bounds, bounds[1:]))
    NR = _size_bucket(nr_max + 1)
    parts = []
    for lo, hi in zip(bounds, bounds[1:]):
        span = int(offsets[hi] - offsets[lo])
        codes_c = reads.codes[int(offsets[lo]):int(offsets[hi])]
        lengths_c = reads.lengths[lo:hi].astype(np.int32)
        offs_c = (offsets[lo:hi + 1] - offsets[lo]).astype(np.int32)
        if span < cb:  # phantom read pads the chunk to the bucket
            codes_c = np.concatenate(
                [codes_c, np.zeros(cb - span, codes_c.dtype)]
            )
            lengths_c = np.append(lengths_c, np.int32(cb - span))
            offs_c = np.append(offs_c, np.int32(cb))
        if len(lengths_c) < NR:  # zero-length reads pad the read count
            pad = NR - len(lengths_c)
            lengths_c = np.concatenate([lengths_c, np.zeros(pad, np.int32)])
            offs_c = np.concatenate(
                [offs_c, np.full(pad, offs_c[-1], np.int32)]
            )
        c4 = codes_c.reshape(-1, 4).astype(np.uint8)
        cbytes = np.concatenate([
            c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4) | (c4[:, 3] << 6),
            np.zeros(8, np.uint8),
        ])
        parts.append(_extract_chunk(
            jnp.asarray(cbytes), jnp.asarray(lengths_c),
            jnp.asarray(offs_c), jnp.int32(hi - lo), jnp.int32(lo),
            kmer_size=kmer_size, pack_ridpos=pack_ridpos,
        ))
    return tuple(
        None if parts[0][i] is None
        else jnp.concatenate([p[i] for p in parts])
        for i in range(5)
    )


def _part_shift(kmer_size: int, wide: bool) -> int:
    """Bit position where the pass tag sits above the live bits of the
    high key word in _chunk_partition's packed mode: the packed-strand
    layout (non-wide, see _sort_kmers pack_sc) occupies 2k+1 bits
    across both words, the wide layout 2k bits."""
    return max(0, 2 * kmer_size + (1 if not wide else 0) - 32)


def _part_packable(kmer_size: int, splits: int, wide: bool) -> bool:
    """True when `splits` pass tags plus the sentinel tag fit in the
    free top bits of the high key word (they always do for the k <= 28
    corpora this path serves, unless splits is astronomically large)."""
    s = _part_shift(kmer_size, wide)
    return s < 32 and (splits + 1) < (1 << (32 - s))


@partial(jax.jit, static_argnames=("kmer_size", "splits", "wide", "packed"))
def _chunk_partition(
    codes_bytes, lengths, offsets, n_real, rid_base,
    kmer_size: int, splits: int, wide: bool = False, packed: bool = False,
):
    """Beyond-HBM path, per chunk: phased extraction + k-mer-space
    partition (the reference's --split-count hash partitioning,
    include/kmercount.hpp:478-534, applied chunk-wise so only one
    chunk's working set is ever resident). Rows sort by pass tag
    (sentinels to pass `splits`); `starts` gives each pass's slice.

    wide=False: payload streams (khi, klo, ridpos, sc) — 16-bit ids.
    wide=True:  payload streams (khi, klo, rid, possc) — ids to 2^31,
    positions 16-bit, strand in possc bit 0.

    packed=True (requires _part_packable): the pass tag rides the free
    top bits of the high key word, cutting the partition sort — the
    split path's dominant cost — from 5 operands to 3 (non-wide; the
    strand bit moves below the k-mer bits as in _sort_kmers pack_sc, so
    returns (khi2, klo2, ridpos, starts) in the pre-packed layout) or
    4 (wide: (khi, klo, rid, possc, starts), tag stripped)."""
    from bella_tpu.seq.encode import hash64

    u32 = jnp.uint32
    if wide:
        khi, klo, rid, sc, pos = _extract_kmers_phased(
            codes_bytes, lengths, offsets, n_real,
            kmer_size=kmer_size, pack_ridpos=False,
        )
        a = rid.astype(u32) + rid_base.astype(u32)
        b = (pos.astype(u32) << u32(1)) | sc.astype(u32)
    else:
        khi, klo, ridpos, sc, _ = _extract_kmers_phased(
            codes_bytes, lengths, offsets, n_real,
            kmer_size=kmer_size, pack_ridpos=True,
        )
        # chunk-local read ids -> global (ids stay 16-bit by caller
        # contract)
        a = ridpos + (rid_base.astype(u32) << u32(16))
        b = sc
    canon = (khi.astype(_U64) << _U64(32)) | klo.astype(_U64)
    p = (hash64(canon) % _U64(splits)).astype(u32)
    dead = (khi == u32(0xFFFFFFFF)) & (klo == u32(0xFFFFFFFF))
    if packed:
        s = _part_shift(kmer_size, wide)
        bounds = jnp.arange(splits + 1, dtype=u32) << u32(s)
        if wide:
            pk = jnp.where(dead, u32(0xFFFFFFFF), (p << u32(s)) | khi)
            pk, klo, a, b = jax.lax.sort((pk, klo, a, b), num_keys=1)
            starts = jnp.searchsorted(pk, bounds)
            khi = pk & u32((1 << s) - 1) if s else jnp.zeros_like(pk)
            return khi, klo, a, b, starts
        # strand below the k-mer bits (the _sort_kmers pack_sc layout,
        # consumed pre-packed by the region sort / _count_sorted)
        khi2 = (khi << u32(1)) | (klo >> u32(31))
        klo2 = jnp.where(dead, u32(0xFFFFFFFF),
                         (klo << u32(1)) | b.astype(u32))
        pk = jnp.where(dead, u32(0xFFFFFFFF), (p << u32(s)) | khi2)
        pk, klo2, a = jax.lax.sort((pk, klo2, a), num_keys=1)
        starts = jnp.searchsorted(pk, bounds)
        khi2 = pk & u32((1 << s) - 1) if s else jnp.zeros_like(pk)
        return khi2, klo2, a, starts
    p = jnp.where(dead, u32(splits), p)
    p, khi, klo, a, b = jax.lax.sort((p, khi, klo, a, b), num_keys=1)
    starts = jnp.searchsorted(p, jnp.arange(splits + 1, dtype=u32))
    return khi, klo, a, b, starts


@partial(jax.jit, static_argnames=("cap",), donate_argnums=(0, 1, 2, 3))
def _accum_append(
    akhi, aklo, aridpos, asc, khi, klo, ridpos, sc,
    src_start, n_valid, dst_start, cap: int,
):
    """Append up to `cap` rows from src[src_start:] into the (donated)
    accumulators at dst_start. Read-modify-write: rows beyond n_valid
    keep the accumulator's existing content, so the fixed-width window
    never clobbers a neighbouring pass's region even when the caller's
    region has less than `cap` rows of room left. Accumulators carry
    `cap` rows of tail slack so the write never clamps its start."""
    u32 = jnp.uint32
    sent = jnp.full((cap,), 0xFFFFFFFF, u32)
    # pad so dynamic_slice never clamps the start (which would silently
    # shift the window over a neighbouring pass's rows)
    khi = jnp.concatenate([khi, sent])
    klo = jnp.concatenate([klo, sent])
    ridpos = jnp.concatenate([ridpos, sent])
    sc = jnp.concatenate([sc, jnp.zeros((cap,), sc.dtype)])
    keep = jax.lax.iota(jnp.int32, cap) < n_valid
    s = (src_start,)
    d = (dst_start,)

    def rmw(acc, src, fill_keep):
        w = jnp.where(keep, jax.lax.dynamic_slice(src, s, (cap,)), fill_keep)
        old = jax.lax.dynamic_slice(acc, d, (cap,))
        w = jnp.where(keep, w, old)
        return jax.lax.dynamic_update_slice(acc, w, d)

    return (
        rmw(akhi, khi, sent),
        rmw(aklo, klo, sent),
        rmw(aridpos, ridpos, jnp.zeros((cap,), u32)),
        rmw(asc, sc, jnp.zeros((cap,), sc.dtype)),
    )


@partial(jax.jit, static_argnames=("cap",), donate_argnums=(0, 1, 2))
def _accum_append3(
    akhi, aklo, aridpos, khi, klo, ridpos,
    src_start, n_valid, dst_start, cap: int,
):
    """_accum_append for the packed 3-stream layout (non-wide packed
    partition: strand rides the key words, so no sc stream exists).
    Same fixed-width read-modify-write contract."""
    u32 = jnp.uint32
    sent = jnp.full((cap,), 0xFFFFFFFF, u32)
    khi = jnp.concatenate([khi, sent])
    klo = jnp.concatenate([klo, sent])
    ridpos = jnp.concatenate([ridpos, sent])
    keep = jax.lax.iota(jnp.int32, cap) < n_valid
    s = (src_start,)
    d = (dst_start,)

    def rmw(acc, src, fill_keep):
        w = jnp.where(keep, jax.lax.dynamic_slice(src, s, (cap,)), fill_keep)
        old = jax.lax.dynamic_slice(acc, d, (cap,))
        w = jnp.where(keep, w, old)
        return jax.lax.dynamic_update_slice(acc, w, d)

    return (
        rmw(akhi, khi, sent),
        rmw(aklo, klo, sent),
        rmw(aridpos, ridpos, jnp.zeros((cap,), u32)),
    )


@partial(jax.jit, static_argnames=("pack_ridpos", "pack_sc", "pre_packed"))
def _sort_kmers(khi, klo, p1, sc, p2, pack_ridpos: bool = False,
                pack_sc: bool = False, pre_packed: bool = False):
    """Phase 1b: k-mer-major sort (separate program; see _extract_kmers).

    pack_sc (requires pack_ridpos and k <= 31, i.e. the high k-mer word
    below 2^31): the whole 2k-bit k-mer shifts left by one across both
    key words and the strand bit takes bit 0 of the LOW word — i.e.
    BELOW every k-mer bit, so equal k-mers stay contiguous — cutting
    the big sort from 4 operands to 3. Equal k-mers then order by strand before stream
    order — harmless, because the chain stage re-sorts candidates by
    all three packed fields, so the final seeds are independent of
    intra-segment emit order.

    pre_packed (requires pack_sc): khi/klo already arrive in the packed
    strand-below layout (the packed partition emits it directly), so
    skip the repack arithmetic and sort as-is."""
    if pack_sc and pre_packed:
        khi2, klo2, p1 = jax.lax.sort((khi, klo, p1), num_keys=2)
        return khi2, klo2, p1, None, None
    if pack_sc:
        u32 = jnp.uint32
        dead = (khi == u32(0xFFFFFFFF)) & (klo == u32(0xFFFFFFFF))
        khi2 = jnp.where(dead, u32(0xFFFFFFFF),
                         (khi << u32(1)) | (klo >> u32(31)))
        klo2 = jnp.where(dead, u32(0xFFFFFFFF),
                         (klo << u32(1)) | sc.astype(u32))
        khi2, klo2, p1 = jax.lax.sort((khi2, klo2, p1), num_keys=2)
        return khi2, klo2, p1, None, None
    if pack_ridpos:
        return jax.lax.sort((khi, klo, p1, sc), num_keys=2) + (None,)
    khi, klo, sr, sp, sc = jax.lax.sort((khi, klo, p1, p2, sc), num_keys=2)
    return khi, klo, sr, sc, sp


@partial(jax.jit, static_argnames=("lower", "upper", "pack_ridpos",
                                   "pack_sc"))
def _count_sorted(
    khi, klo, p1, sc, p2,
    lower: int = 2, upper: int = 8, pack_ridpos: bool = False,
    pack_sc: bool = False,
):
    """Phase 1b: exact counting + reliable filter + within-segment rank
    over the k-mer-sorted stream (separate program; see _extract_sort).
    Returns the strand column too: unpacked from bit 0 of the high key
    word under pack_sc (see _sort_kmers), passed through otherwise."""
    u32 = jnp.uint32
    if pack_ridpos:
        sr = (p1 >> u32(16)).astype(jnp.int32)
        sp = (p1 & u32(0xFFFF)).astype(jnp.int32)
    else:
        sr, sp = p1, p2
    is_sentinel = (khi == u32(0xFFFFFFFF)) & (klo == u32(0xFFFFFFFF))
    if pack_sc:
        # strand in bit 0 of the LOW word (see _sort_kmers pack_sc);
        # segment on the k-mer bits only — sentinels keep both words at
        # 0xFFFFFFFF, above any real shifted k-mer for k <= 31
        sc = ((klo & u32(1)) != u32(0)) & (~is_sentinel)
        kb = seg.boundaries2(khi, klo >> u32(1))
    else:
        kb = seg.boundaries2(khi, klo)
    ones = jnp.ones_like(sr, dtype=jnp.int32)
    # gather-free int32 segment ops
    counts = seg.seg_sum_bcast(ones, kb)
    rank = seg.seg_cumsum(ones, kb) - 1
    reliable = (counts >= lower) & (counts <= upper) & (~is_sentinel)
    # nnzs[0] = reliable rows; nnzs[d] = reliable rows in segments with
    # count > d, for d in 1..upper-1 — the per-lag prefix sizes of the
    # count-descending compacted stream (see _compact_sort /
    # _fused_emit_packed lag_sizes): lag d can only pair rows of
    # segments with > d occurrences, so its emission slice shrinks to
    # nnzs[d] (22% at lag 2, <1% at lag 5 on long-read error k-mers).
    # One stacked readback ships all of them with nnz.
    # ONE fused (upper, n) broadcast-compare reduction instead of upper
    # separate full-stream sums; row 0
    # compares counts > 0, true for every reliable row, so nnzs[0] = nnz.
    # Width capped at _LAG_STATS (S_d is nonincreasing, so lags beyond
    # the cap reuse the last entry as a valid upper bound) — wide bounds
    # allow upper = 2^15 and an uncapped (upper, n) sweep would blow up.
    dv = jnp.arange(min(upper, _LAG_STATS), dtype=jnp.int32)[:, None]
    nnzs = jnp.sum(
        (reliable[None, :] & (counts[None, :] > dv)).astype(jnp.int32),
        axis=1,
    )
    num_kmers = jnp.sum(kb & reliable)
    return reliable, sr, sp, sc, rank, counts, nnzs, num_kmers


def _fused_count(
    codes, lengths, offsets, n_real=None,
    kmer_size: int = 17, lower: int = 2, upper: int = 8, use_hopc: bool = False,
    pack_ridpos: bool = False, phased: bool = False,
):
    """Phase 1 driver: three device programs (canonicalise, sort,
    count+filter) so no single compile-time allocation plan approaches
    device memory at 100M+-position shapes. phased=True means `codes` is the
    2-bit-packed byte stream (+8 pad bytes) for the 4-phase extractor."""
    # strand bit in the key (3-operand sort) whenever the high k-mer
    # word leaves bit 31 free — always true at the packed path's k <= 28
    pack_sc = pack_ridpos and kmer_size <= 31
    ex_fn = _extract_kmers_phased if phased else _extract_kmers
    ex_kw = dict(kmer_size=kmer_size, pack_ridpos=pack_ridpos)
    if not phased:
        ex_kw["use_hopc"] = use_hopc
    khi, klo, p1, sc, p2 = ex_fn(
        codes, lengths, offsets, n_real, **ex_kw
    )
    khi, klo, p1, sc, p2 = _sort_kmers(
        khi, klo, p1, sc, p2,
        pack_ridpos=pack_ridpos, pack_sc=pack_sc,
    )
    return _count_sorted(
        khi, klo, p1, sc, p2,
        lower=lower, upper=upper, pack_ridpos=pack_ridpos, pack_sc=pack_sc,
    )


_LAG_STATS = 64  # per-lag prefix stats computed for lags below this


def _lag_sizes(narr, size: int, upper: int):
    """Static per-lag emission prefixes from the nnzs readback (see
    _count_sorted): monotone nonincreasing pow2 buckets upper-bounding
    the count>d row counts, capped at `size`. To bound the compile-
    variant alphabet (lag_sizes is a static jit key), the canonical
    pow4-decay tuple
    (size, size/4, size/16, ...) is used whenever it covers the actual
    counts — one variant per size bucket for typical error-k-mer count
    decays (~4-5x per lag); the exact pow2 tuple is the fallback.
    BELLA_NO_LAG_SLICES=1 disables slicing on every path."""
    import os as _os

    nlag = upper - 1
    if _os.environ.get("BELLA_NO_LAG_SLICES"):
        return (size,) * nlag
    actual = []
    for d in range(1, upper):
        i = min(d, len(narr) - 1)
        actual.append(int(narr[i]) if i >= 1 else 0)
    canonical = [max(size >> (2 * d), 1 << 10) for d in range(nlag)]
    if all(c >= a for c, a in zip(canonical, actual)):
        return tuple(min(c, size) for c in canonical)
    out, prev = [], size
    for sd in actual:
        b = (1 << max(10, int(sd - 1).bit_length())) if sd > 0 else 1 << 10
        b = min(b, prev, size)
        out.append(b)
        prev = b
    return tuple(out)


@partial(jax.jit, static_argnames=("kmer_size", "upper", "bin_size"))
def _fused_emit(
    live, sr, sp, sc, rank, read_lengths,
    kmer_size: int, upper: int, bin_size: int,
):
    """Phase 2: pair emission + multiop over the counted stream.

    Non-reliable / padding rows never pair: reliability is a per-segment
    property, so segments are wholly live or wholly dead. Pair keys are
    (h, v) int32 pairs (no packed uint64)."""
    k = kmer_size
    len_s = read_lengths[jnp.clip(sr, 0, read_lengths.shape[0] - 1)]
    hs, vs, phs, pvs, fls, lhs, lvs = [], [], [], [], [], [], []
    for d in range(1, upper):
        ra, rb = sr[d:], sr[:-d]
        pa, pb = sp[d:], sp[:-d]
        ca, cb = sc[d:], sc[:-d]
        la, lb = len_s[d:], len_s[:-d]
        ok = (rank[d:] >= d) & (ra != rb) & live[d:] & live[:-d]
        h_is_a = ra > rb
        h = jnp.where(h_is_a, ra, rb)
        v = jnp.where(h_is_a, rb, ra)
        hs.append(jnp.where(ok, h, _SENT32))
        vs.append(jnp.where(ok, v, _SENT32))
        phs.append(jnp.where(h_is_a, pa, pb))
        pvs.append(jnp.where(h_is_a, pb, pa))
        fls.append(jnp.where(h_is_a, ca, cb) != jnp.where(h_is_a, cb, ca))
        lhs.append(jnp.where(h_is_a, la, lb))
        lvs.append(jnp.where(h_is_a, lb, la))
    h = jnp.concatenate(hs)
    v = jnp.concatenate(vs)
    pos_h = jnp.concatenate(phs).astype(jnp.int32)
    pos_v = jnp.concatenate(pvs).astype(jnp.int32)
    flip = jnp.concatenate(fls)

    len_h = jnp.concatenate(lhs)
    len_v = jnp.concatenate(lvs)
    beg_h = jnp.where(flip, len_h - pos_h - k, pos_h)
    ov = (
        jnp.minimum(beg_h, pos_v)
        + jnp.minimum(len_h - (beg_h + k), len_v - (pos_v + k))
        + k
    ).astype(jnp.int32)
    bin_id = (ov // bin_size).astype(jnp.int32)
    return h, v, bin_id, pos_h, pos_v, flip, ov


@partial(jax.jit, static_argnames=("kmer_size", "upper", "bin_size",
                                   "lag_sizes"))
def _fused_emit_packed(
    n_rows, sr, sp, sc, rank, read_lengths, h_bounds=None,
    *, kmer_size: int, upper: int, bin_size: int,
    lag_sizes: tuple = (),
):
    """Packed phase 2+3: when read ids and positions fit 16 bits (the
    reference caps positions at 16 bits too, src/main.cpp:193), the whole
    candidate row packs into THREE uint32 sort operands instead of seven:

        hv  = h << 16 | v                 (pair key; 0xFFFFFFFF sentinel)
        k3  = bin << 17 | pos_h << 1 | flip
        pv  = pos_v                       (payload)

    ov is recomputed after the sort from the unpacked fields. Sorting
    moves every operand through every compare-exchange, so 7 -> 3
    operands is ~2.3x less data movement (and much faster compiles)."""
    k = kmer_size
    u32 = jnp.uint32
    # rows arrive compacted (reliable-first): the first n_rows are live.
    # n_rows may also be a per-row bool mask (the split path concatenates
    # per-pass compacted blocks, so pad rows sit between blocks).
    if n_rows.dtype == jnp.bool_:
        live = n_rows
    else:
        live = jax.lax.iota(jnp.int32, sr.shape[0]) < n_rows
    # ONE per-row length lookup before the lag loop: the former per-lag
    # table gathers ran on (upper-1) x rows streams
    len_s = read_lengths[jnp.clip(sr, 0, read_lengths.shape[0] - 1)]
    hvs, k3s, pvs = [], [], []
    for d in range(1, upper):
        # lag_sizes[d-1]: with the count-DESC compaction (see
        # _compact_sort cnt) every row usable at lag d (segment count
        # > d) lives in a prefix whose bucketed size the driver read
        # back — slice it so lag 5 streams ~1% of the rows instead of
        # 100%. Rows past the true prefix inside the bucket belong to
        # count <= d segments, so their rank < d masks them exactly as
        # before; no extra masking needed.
        if lag_sizes:
            L = min(lag_sizes[d - 1], sr.shape[0])
            if L <= d:
                continue
            srd, spd, scd = sr[:L], sp[:L], sc[:L]
            lend, rankd, lived = len_s[:L], rank[:L], live[:L]
        else:
            srd, spd, scd = sr, sp, sc
            lend, rankd, lived = len_s, rank, live
        ra, rb = srd[d:], srd[:-d]
        pa, pb = spd[d:], spd[:-d]
        ca, cb = scd[d:], scd[:-d]
        la, lb = lend[d:], lend[:-d]
        ok = (rankd[d:] >= d) & (ra != rb) & lived[d:] & lived[:-d]
        h_is_a = ra > rb
        h = jnp.where(h_is_a, ra, rb).astype(u32)
        v = jnp.where(h_is_a, rb, ra).astype(u32)
        if h_bounds is not None:
            # hv-range staged chaining: only pairs whose h lands in
            # [h_bounds[0], h_bounds[1]) are emitted this pass — a
            # pair's candidates all share (h, v), so read-range
            # partitioning keeps pairs whole (reference analogue:
            # column-block staging, include/overlap.hpp:682-710)
            ok = ok & (h >= h_bounds[0]) & (h < h_bounds[1])
        pos_h = jnp.where(h_is_a, pa, pb).astype(jnp.int32)
        pos_v = jnp.where(h_is_a, pb, pa).astype(u32)
        flip = jnp.where(h_is_a, ca, cb) != jnp.where(h_is_a, cb, ca)

        len_h = jnp.where(h_is_a, la, lb)
        len_v = jnp.where(h_is_a, lb, la)
        beg_h = jnp.where(flip, len_h - pos_h - k, pos_h)
        ov = (
            jnp.minimum(beg_h, pos_v.astype(jnp.int32))
            + jnp.minimum(len_h - (beg_h + k), len_v - (pos_v.astype(jnp.int32) + k))
            + k
        )
        bin_id = jnp.maximum(ov, 0).astype(u32) // u32(bin_size)

        hv = (h << u32(16)) | v
        k3 = (bin_id << u32(17)) | (pos_h.astype(u32) << u32(1)) | flip.astype(u32)
        hvs.append(jnp.where(ok, hv, u32(0xFFFFFFFF)))
        k3s.append(k3)
        pvs.append(pos_v)
    hv = jnp.concatenate(hvs)
    k3 = jnp.concatenate(k3s)
    pv = jnp.concatenate(pvs)
    if lag_sizes:
        # pad to a bucketed total so the chain stages compile once per
        # bucket, not once per lag_sizes combination
        total = hv.shape[0]
        padded = _size_bucket(max(int(total), 1 << 12))
        if padded > total:
            pad = padded - total
            hv = jnp.concatenate([hv, jnp.full((pad,), u32(0xFFFFFFFF))])
            k3 = jnp.concatenate([k3, jnp.zeros((pad,), u32)])
            pv = jnp.concatenate([pv, jnp.zeros((pad,), pv.dtype)])
    # most emitted rows are sentinels (segments shorter than the lag):
    # report the live count so the driver can compact before the sort
    n_live = jnp.sum((hv != u32(0xFFFFFFFF)).astype(jnp.int32))
    return hv, k3, pv, n_live


# row count beyond which the count-DESC compact key drops its iota and
# relies on sort stability (23 index bits would overflow); tests
# monkeypatch it to cover the stable branch on small streams
_STABLE_SORT_ROWS = 1 << 23


@jax.jit
def _compact_sort(live, sr, sp, sc, rank, cnt=None):
    """Sort half of the reliable-row compaction: a stable single-key
    sort in place of nonzero+gather. The dead bit rides in
    bit 31 of the row-index key (streams < 2^31 rows), and the four
    payloads pack into two uint32 operands — rows that survive are
    reliable, so rank < upper_freq <= 255 — keeping the sort at 3
    operands instead of 6. Stability (index key) keeps k-mer segments
    contiguous and in order, so downstream lag-pairing still works on
    the prefix.

    With `cnt` (per-row segment counts), live rows additionally order
    by DESCENDING count ahead of the stable index — every row of a
    segment shares its count, so whole segments stay contiguous and the
    rows usable at lag d (count > d) become a PREFIX whose size the
    driver reads back with nnz (see _count_sorted nnzs /
    _fused_emit_packed lag_sizes).

    Split from the size-slicing half so the driver can DISPATCH this
    sort before it blocks on the nnz readback (the slice size depends
    on nnz; the sort does not) — the readback and the sort then
    overlap instead of serialising."""
    u32 = jnp.uint32
    n = live.shape[0]
    if cnt is None:
        key = ((~live).astype(u32) << u32(31)) | jax.lax.iota(u32, n)
    else:
        # dead bit 31 | (255 - count) bits 23-30 | row index bits 0-22;
        # streams beyond 2^23 rows fall back to a stable sort on the
        # short key (equal keys keep input order, preserving segments)
        inv_cnt = u32(255) - jnp.minimum(cnt.astype(u32), u32(255))
        if n <= _STABLE_SORT_ROWS:
            key = (
                ((~live).astype(u32) << u32(31))
                | (inv_cnt << u32(23))
                | jax.lax.iota(u32, n)
            )
        else:
            key = ((~live).astype(u32) << u32(8)) | inv_cnt
            ridpos = (sr.astype(u32) << u32(16)) | (sp.astype(u32) & u32(0xFFFF))
            misc = (
                (sc.astype(u32) << u32(8))
                | jnp.minimum(rank.astype(u32), u32(255))
            )
            _, ridpos, misc = jax.lax.sort(
                (key, ridpos, misc), num_keys=1, is_stable=True
            )
            return ridpos, misc
    ridpos = (sr.astype(u32) << u32(16)) | (sp.astype(u32) & u32(0xFFFF))
    misc = (
        (sc.astype(u32) << u32(8))
        | jnp.minimum(rank.astype(u32), u32(255))
    )
    _, ridpos, misc = jax.lax.sort((key, ridpos, misc), num_keys=1)
    return ridpos, misc


@partial(jax.jit, static_argnames=("size",))
def _compact_slice(ridpos, misc, size: int):
    """Slice half of the reliable-row compaction (static-size prefix +
    field unpack; trivial program, one compile per size bucket)."""
    u32 = jnp.uint32
    sr = (ridpos[:size] >> u32(16)).astype(jnp.int32)
    sp = (ridpos[:size] & u32(0xFFFF)).astype(jnp.int32)
    sc = (misc[:size] >> u32(8)) != u32(0)
    rank = (misc[:size] & u32(0xFF)).astype(jnp.int32)
    return sr, sp, sc, rank


@partial(jax.jit, static_argnames=("size",))
def _take_prefix_n(*arrs, size: int):
    """Static-size prefix of N same-length arrays (one tiny program per
    operand-count x size bucket; keeps packed compaction operands packed
    for the staged-chain resident set)."""
    return tuple(a[:size] for a in arrs)


def _compact_reliable(live, sr, sp, sc, rank, size: int, cnt=None):
    """Sort-based device compaction of reliable occurrence rows (see
    _compact_sort for the design; this wrapper runs both halves)."""
    ridpos, misc = _compact_sort(live, sr, sp, sc, rank, cnt)
    return _compact_slice(ridpos, misc, size)


@partial(jax.jit, donate_argnums=(0, 1, 2))
def _chain_sort_packed(hv, k3, pv):
    """The chain's sort, alone and with donated inputs: all three
    operands are sort keys so the winning bin's seed row is independent
    of the emit stream's order (the 4-phase packed extractor emits
    phase-major, the triples path position-major)."""
    return jax.lax.sort((hv, k3, pv), num_keys=3)


def _chain_packed(
    hv, k3, pv, read_lengths, kmer_size: int, bin_size: int,
    live_rows=None, lengths_np=None, hint=None, hint_out=None,
):
    """Packed sort + fused chain+compact (see _fused_emit_packed):
    returns CandidatePairs directly.

    live_rows (host int, from the emit stage) bounds the live candidate
    rows: the sort pushes sentinels to the tail, so the scans — a
    full-stream materialisation — only cover the live prefix (bucketed).
    At 100M+-row streams this is the difference between fitting HBM and
    not."""
    hv, k3, pv = _chain_sort_packed(hv, k3, pv)
    if callable(live_rows):
        # the host round trip for the live count overlaps the sort
        # executing on device
        live_rows = live_rows()
    if live_rows is not None:
        lim = min(_size_bucket(max(int(live_rows), 1 << 10)), hv.shape[0])
        if hint_out is not None:
            hint_out["lim"] = lim
        if lim < hv.shape[0]:
            hv, k3, pv = hv[:lim], k3[:lim], pv[:lim]
    elif hint_out is not None:
        hint_out["lim"] = int(hv.shape[0])
    return _finish_chain(
        (hv, k3, pv), read_lengths, lengths_np, kmer_size, bin_size,
        wide=False, hint=hint, hint_out=hint_out,
    )


@partial(jax.jit, static_argnames=("kmer_size", "bin_size"))
def _chain_scans_packed(
    hv, k3, pv, read_lengths, kmer_size: int, bin_size: int
):
    """Segmented chain scans over the (pair, bin, posH, posV)-sorted
    live prefix."""
    k = kmer_size
    u32 = jnp.uint32
    live = hv != u32(0xFFFFFFFF)
    h = (hv >> u32(16)).astype(jnp.int32)
    v = (hv & u32(0xFFFF)).astype(jnp.int32)
    bin_id = (k3 >> u32(17)).astype(jnp.int32)
    pos_h = ((k3 >> u32(1)) & u32(0xFFFF)).astype(jnp.int32)
    flip = (k3 & u32(1)).astype(bool)
    pos_v = pv.astype(jnp.int32)

    len_h = read_lengths[jnp.clip(h, 0, read_lengths.shape[0] - 1)]
    len_v = read_lengths[jnp.clip(v, 0, read_lengths.shape[0] - 1)]
    beg_h = jnp.where(flip, len_h - pos_h - k, pos_h)
    ov = (
        jnp.minimum(beg_h, pos_v)
        + jnp.minimum(len_h - (beg_h + k), len_v - (pos_v + k))
        + k
    ).astype(jnp.int32)

    pair_b = seg.boundaries(hv)
    bin_b = seg.boundaries2(hv, bin_id)

    bucket = pos_h // (k + 1)
    prev_bucket = jnp.concatenate([bucket[:1], bucket[:-1]])
    dup = (~bin_b) & (bucket == prev_bucket)
    kept = (~dup) & live

    # gather-free int32 segment machinery (seg.*_bcast): this stage runs
    # on tens of millions of rows
    support = seg.seg_sum_bcast(kept.astype(jnp.int32), bin_b)
    count = seg.seg_sum_bcast(live.astype(jnp.int32), pair_b)
    binidx = seg.seg_cumsum(bin_b.astype(jnp.int32), pair_b)  # 1-based rank
    # support < 2^12 (<= max_len/(k+1) with 16-bit positions), rank
    # capped at 2^15 - 1 -> score fits int32
    bin_rank = jnp.minimum(binidx - 1, (1 << 15) - 1)
    score = support * (1 << 15) + ((1 << 15) - 1 - bin_rank)
    best = seg.seg_max_bcast(score, pair_b)
    seed_mask = (score == best) & bin_b & live

    # packed outputs (hv as-is; count|matches in one u32): this dict is
    # a full-candidate-stream materialisation — at 100M+ rows every
    # field column costs ~0.5 GB, so h/v/count/matches stay packed until
    # after the seed compaction
    cm = (
        (jnp.minimum(count, (1 << 16) - 1).astype(u32) << u32(16))
        | jnp.minimum(support, (1 << 16) - 1).astype(u32)
    )
    return dict(
        seed_mask=seed_mask, hv=hv, cm=cm, pos_h=pos_h, pos_v=pos_v,
        overlap_est=ov,
        seed_rc=flip,
    )


# ----------------------------------------------------------------------
# Wide-id packed stages: read ids up to 2^31 (the reference's KMERINDEX
# uint32/uint64 switch, src/main.cpp:60-61) with 16-bit positions.
# Occurrence rows are (khi, klo, rid, possc) and candidate rows
# (h, v, k3, pv) — 4 u32 sort operands either way, so corpora beyond
# 65,535 reads keep the device fast path instead of falling to the
# host-staged spill.
# ----------------------------------------------------------------------


@jax.jit
def _sort_kmers_wide(khi, klo, rid, pos, sc):
    """K-mer-major sort with wide read ids: positions and strand pack
    into one u32 (possc = pos << 1 | rc), ids ride as their own u32."""
    u32 = jnp.uint32
    possc = (pos.astype(u32) << u32(1)) | sc.astype(u32)
    return jax.lax.sort(
        (khi, klo, rid.astype(u32), possc), num_keys=2
    )


@partial(jax.jit, static_argnames=("lower", "upper"))
def _count_sorted_wide(khi, klo, rid, possc, lower: int, upper: int):
    """Counting + reliable filter + rank over the wide-id sorted stream."""
    u32 = jnp.uint32
    sr = rid.astype(jnp.int32)
    sp = (possc >> u32(1)).astype(jnp.int32)
    sc = (possc & u32(1)) != u32(0)
    kb = seg.boundaries2(khi, klo)
    ones = jnp.ones_like(sr, dtype=jnp.int32)
    counts = seg.seg_sum_bcast(ones, kb)
    rank = seg.seg_cumsum(ones, kb) - 1
    is_sentinel = (khi == u32(0xFFFFFFFF)) & (klo == u32(0xFFFFFFFF))
    reliable = (counts >= lower) & (counts <= upper) & (~is_sentinel)
    # nnzs[0] = nnz, nnzs[d] = rows in segments with count > d (one
    # fused broadcast reduction, width-capped — see _count_sorted)
    dv = jnp.arange(min(upper, _LAG_STATS), dtype=jnp.int32)[:, None]
    nnzs = jnp.sum(
        (reliable[None, :] & (counts[None, :] > dv)).astype(jnp.int32),
        axis=1,
    )
    num_kmers = jnp.sum(kb & reliable)
    return reliable, sr, sp, sc, rank, counts, nnzs, num_kmers


@jax.jit
def _compact_sort_wide(live, sr, sp, sc, rank, cnt=None):
    """Sort half of the wide-id reliable compaction (see _compact_sort:
    split so the sort dispatches before the nnz readback blocks). rid
    rides as its own u32 operand and rank is not clamped to 8 bits
    (upper_freq may reach 2^15)."""
    u32 = jnp.uint32
    n = live.shape[0]
    if cnt is None:
        key = ((~live).astype(u32) << u32(31)) | jax.lax.iota(u32, n)
        stable = False
    else:
        # count-DESC on a short 15-bit inverse-count key (wide bounds
        # reach upper_freq = 2^15, so an 8-bit clamp would scramble the
        # count>d prefix property for lags >= 255); stability preserves
        # segment contiguity
        inv_cnt = u32(0x7FFF) - jnp.minimum(cnt.astype(u32), u32(0x7FFF))
        key = ((~live).astype(u32) << u32(15)) | inv_cnt
        stable = True
    possc = (sp.astype(u32) << u32(1)) | sc.astype(u32)
    _, rid2, possc2, rank2 = jax.lax.sort(
        (key, sr.astype(u32), possc, rank.astype(u32)), num_keys=1,
        is_stable=stable,
    )
    return rid2, possc2, rank2


@partial(jax.jit, static_argnames=("size",))
def _compact_slice_wide(rid2, possc2, rank2, size: int):
    """Slice half of the wide-id reliable compaction."""
    u32 = jnp.uint32
    sr = rid2[:size].astype(jnp.int32)
    sp = (possc2[:size] >> u32(1)).astype(jnp.int32)
    sc = (possc2[:size] & u32(1)) != u32(0)
    rank = rank2[:size].astype(jnp.int32)
    return sr, sp, sc, rank


def _compact_reliable_wide(live, sr, sp, sc, rank, size: int, cnt=None):
    """Reliable-row compaction with wide ids (both halves)."""
    return _compact_slice_wide(
        *_compact_sort_wide(live, sr, sp, sc, rank, cnt), size=size)


def _fused_count_wide(
    codes, lengths, offsets, n_real=None,
    kmer_size: int = 17, lower: int = 2, upper: int = 8,
    use_hopc: bool = False, phased: bool = False,
):
    """Wide-id phase-1 driver (extract -> sort -> count), mirroring
    _fused_count with rid/possc operand layout."""
    extract = partial(
        _extract_kmers_phased, kmer_size=kmer_size, pack_ridpos=False,
    ) if phased else partial(
        _extract_kmers, kmer_size=kmer_size, use_hopc=use_hopc,
        pack_ridpos=False,
    )
    khi, klo, rid, sc, pos = extract(codes, lengths, offsets, n_real)
    khi, klo, rid, possc = _sort_kmers_wide(khi, klo, rid, pos, sc)
    return _count_sorted_wide(khi, klo, rid, possc, lower=lower, upper=upper)


@partial(jax.jit, static_argnames=("kmer_size", "upper", "bin_size",
                                   "lag_sizes"))
def _fused_emit_wide(
    n_rows, sr, sp, sc, rank, read_lengths, h_bounds=None,
    *, kmer_size: int, upper: int, bin_size: int,
    lag_sizes: tuple = (),
):
    """Wide-id pair emission: candidate rows (h, v, k3, pv) with h and v
    as separate u32 operands (sentinel 0xFFFFFFFF on h and v); k3 packs
    (bin, posH, flip) exactly as _fused_emit_packed."""
    k = kmer_size
    u32 = jnp.uint32
    if n_rows.dtype == jnp.bool_:
        live = n_rows  # per-row mask (split path, see _fused_emit_packed)
    else:
        live = jax.lax.iota(jnp.int32, sr.shape[0]) < n_rows
    # one per-row length lookup before the lag loop (see _fused_emit_packed)
    len_s = read_lengths[jnp.clip(sr, 0, read_lengths.shape[0] - 1)]
    hs, vs, k3s, pvs = [], [], [], []
    for d in range(1, upper):
        # per-lag count>d prefix of the count-DESC stream (see
        # _fused_emit_packed lag_sizes)
        if lag_sizes:
            L = min(lag_sizes[d - 1], sr.shape[0])
            if L <= d:
                continue
            srd, spd, scd = sr[:L], sp[:L], sc[:L]
            lend, rankd, lived = len_s[:L], rank[:L], live[:L]
        else:
            srd, spd, scd = sr, sp, sc
            lend, rankd, lived = len_s, rank, live
        ra, rb = srd[d:], srd[:-d]
        pa, pb = spd[d:], spd[:-d]
        ca, cb = scd[d:], scd[:-d]
        la, lb = lend[d:], lend[:-d]
        ok = (rankd[d:] >= d) & (ra != rb) & lived[d:] & lived[:-d]
        h_is_a = ra > rb
        h = jnp.where(h_is_a, ra, rb)
        v = jnp.where(h_is_a, rb, ra)
        if h_bounds is not None:
            # hv-range staged chaining (see _fused_emit_packed)
            hu = h.astype(u32)
            ok = ok & (hu >= h_bounds[0]) & (hu < h_bounds[1])
        pos_h = jnp.where(h_is_a, pa, pb).astype(jnp.int32)
        pos_v = jnp.where(h_is_a, pb, pa).astype(u32)
        flip = jnp.where(h_is_a, ca, cb) != jnp.where(h_is_a, cb, ca)

        len_h = jnp.where(h_is_a, la, lb)
        len_v = jnp.where(h_is_a, lb, la)
        beg_h = jnp.where(flip, len_h - pos_h - k, pos_h)
        ov = (
            jnp.minimum(beg_h, pos_v.astype(jnp.int32))
            + jnp.minimum(len_h - (beg_h + k), len_v - (pos_v.astype(jnp.int32) + k))
            + k
        )
        bin_id = jnp.maximum(ov, 0).astype(u32) // u32(bin_size)
        k3 = (bin_id << u32(17)) | (pos_h.astype(u32) << u32(1)) | flip.astype(u32)
        hs.append(jnp.where(ok, h.astype(u32), u32(0xFFFFFFFF)))
        vs.append(jnp.where(ok, v.astype(u32), u32(0xFFFFFFFF)))
        k3s.append(k3)
        pvs.append(pos_v)
    h = jnp.concatenate(hs)
    v = jnp.concatenate(vs)
    k3 = jnp.concatenate(k3s)
    pv = jnp.concatenate(pvs)
    if lag_sizes:
        total = h.shape[0]
        padded = _size_bucket(max(int(total), 1 << 12))
        if padded > total:
            pad = padded - total
            sent = jnp.full((pad,), u32(0xFFFFFFFF))
            h = jnp.concatenate([h, sent])
            v = jnp.concatenate([v, sent])
            k3 = jnp.concatenate([k3, jnp.zeros((pad,), u32)])
            pv = jnp.concatenate([pv, jnp.zeros((pad,), pv.dtype)])
    n_live = jnp.sum((h != u32(0xFFFFFFFF)).astype(jnp.int32))
    return h, v, k3, pv, n_live


@partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _chain_sort_wide(h, v, k3, pv):
    """All four operands are keys: seed choice independent of emit order."""
    return jax.lax.sort((h, v, k3, pv), num_keys=4)


def _chain_wide(h, v, k3, pv, read_lengths, kmer_size: int, bin_size: int,
                live_rows=None, lengths_np=None, hint=None, hint_out=None):
    """Wide-id sort + fused chain+compact (live-prefix trimming as in
    _chain_packed): returns CandidatePairs directly."""
    h, v, k3, pv = _chain_sort_wide(h, v, k3, pv)
    if callable(live_rows):
        live_rows = live_rows()
    if live_rows is not None:
        lim = min(_size_bucket(max(int(live_rows), 1 << 10)), h.shape[0])
        if hint_out is not None:
            hint_out["lim"] = lim
        if lim < h.shape[0]:
            h, v, k3, pv = h[:lim], v[:lim], k3[:lim], pv[:lim]
    elif hint_out is not None:
        hint_out["lim"] = int(h.shape[0])
    return _finish_chain(
        (h, v, k3, pv), read_lengths, lengths_np, kmer_size, bin_size,
        wide=True, hint=hint, hint_out=hint_out,
    )


@partial(jax.jit, static_argnames=("kmer_size", "bin_size"))
def _chain_scans_wide(h, v, k3, pv, read_lengths, kmer_size: int, bin_size: int):
    """Segmented chain scans over the (h, v, bin, posH, posV)-sorted
    wide-id live prefix."""
    k = kmer_size
    u32 = jnp.uint32
    live = h != u32(0xFFFFFFFF)
    hi = h.astype(jnp.int32)
    vi = v.astype(jnp.int32)
    bin_id = (k3 >> u32(17)).astype(jnp.int32)
    pos_h = ((k3 >> u32(1)) & u32(0xFFFF)).astype(jnp.int32)
    flip = (k3 & u32(1)).astype(bool)
    pos_v = pv.astype(jnp.int32)

    len_h = read_lengths[jnp.clip(hi, 0, read_lengths.shape[0] - 1)]
    len_v = read_lengths[jnp.clip(vi, 0, read_lengths.shape[0] - 1)]
    beg_h = jnp.where(flip, len_h - pos_h - k, pos_h)
    ov = (
        jnp.minimum(beg_h, pos_v)
        + jnp.minimum(len_h - (beg_h + k), len_v - (pos_v + k))
        + k
    ).astype(jnp.int32)

    pair_b = seg.boundaries2(h, v)
    bin_b = seg.boundaries_many(h, v, bin_id)

    bucket = pos_h // (k + 1)
    prev_bucket = jnp.concatenate([bucket[:1], bucket[:-1]])
    dup = (~bin_b) & (bucket == prev_bucket)
    kept = (~dup) & live

    support = seg.seg_sum_bcast(kept.astype(jnp.int32), bin_b)
    count = seg.seg_sum_bcast(live.astype(jnp.int32), pair_b)
    binidx = seg.seg_cumsum(bin_b.astype(jnp.int32), pair_b)
    # 16-bit positions -> support < 2^12, same int32 score as the packed
    # chain
    bin_rank = jnp.minimum(binidx - 1, (1 << 15) - 1)
    score = support * (1 << 15) + ((1 << 15) - 1 - bin_rank)
    best = seg.seg_max_bcast(score, pair_b)
    seed_mask = (score == best) & bin_b & live

    cm = (
        (jnp.minimum(count, (1 << 16) - 1).astype(u32) << u32(16))
        | jnp.minimum(support, (1 << 16) - 1).astype(u32)
    )
    return dict(
        seed_mask=seed_mask, read_h=hi, read_v=vi, cm=cm,
        pos_h=pos_h, pos_v=pos_v, overlap_est=ov, seed_rc=flip,
    )


# ----------------------------------------------------------------------
# Fused chain finish: scans + packed readback + seed compaction in ONE
# program. Replaces the former scans -> full 7-column dict -> separate
# gather -> 6-row readback tail for the packed/wide single-chip paths:
#   * only 3 (packed) / 4 (wide) u32 columns ever materialise full-stream,
#   * the pair-count readback overlaps the gather executing on device,
#   * the device->host readback shrinks to 3-4 rows x num,
#   * the overlap estimate is derived data — recomputed on host from
#     (flip, pos, lengths) with the exact device int32 formula.
# Row packing: cm2 = flip<<31 | count16<<13 | support13 (support is
# bounded by max_len/(k+1) < 2^13 under 16-bit positions); poshv =
# pos_h<<16 | pos_v.
# ----------------------------------------------------------------------


@partial(jax.jit, static_argnames=("kmer_size", "bin_size", "wide"))
def _chain_finish(ops, read_lengths, kmer_size: int, bin_size: int,
                  wide: bool):
    """Device phase A: chain scans (inlined) + readback packing. Returns
    the packed columns, the seed-ordering key (dead bit over row index),
    and the seed count — the count's readback then overlaps the
    phase-B sort, which doesn't depend on it."""
    u32 = jnp.uint32
    if wide:
        h, v, k3, pv = ops
        out = _chain_scans_wide(
            h, v, k3, pv, read_lengths, kmer_size=kmer_size,
            bin_size=bin_size,
        )
        id_cols = (out["read_h"].astype(u32), out["read_v"].astype(u32))
    else:
        hv, k3, pv = ops
        out = _chain_scans_packed(
            hv, k3, pv, read_lengths, kmer_size=kmer_size, bin_size=bin_size
        )
        id_cols = (out["hv"],)
    seed = out["seed_mask"]
    nseed = jnp.sum(seed.astype(jnp.int32))
    cm = out["cm"]
    cm2 = (
        (out["seed_rc"].astype(u32) << u32(31))
        | ((cm >> u32(16)) << u32(13))
        | jnp.minimum(cm & u32(0xFFFF), u32(0x1FFF))
    )
    poshv = (out["pos_h"].astype(u32) << u32(16)) | out["pos_v"].astype(u32)
    cols = id_cols + (cm2, poshv)
    key = ((~seed).astype(u32) << u32(31)) | jax.lax.iota(u32, seed.shape[0])
    return cols, key, nseed


@jax.jit
def _sort_seedkey(key):
    """Phase B, small streams: single-operand seed-index sort (gathers
    at the exact pair bucket follow once the count is known)."""
    return jax.lax.sort(key)


@partial(jax.jit, donate_argnums=(0, 1))
def _sort_carry(key, cols):
    """Phase B, huge streams: carry the packed columns through the sort
    instead of multi-million-row gathers."""
    return jax.lax.sort((key,) + cols, num_keys=1)[1:]


@partial(jax.jit, static_argnames=("size",))
def _gather_block(skey, cols, size: int, stats=None):
    """Phase C: gather the packed columns at the first `size` seed rows
    and stack to ONE (F, size) readback block. With `stats` (a short
    int32 vector of deferred size counters on the speculative-size
    path), one extra row carries it home inside the same transfer —
    a separate scalar readback would pay its own round trip."""
    u32 = jnp.uint32
    idx = (skey[:size] & u32(0x7FFFFFFF)).astype(jnp.int32)
    rows = [jnp.take(c, idx, axis=0).astype(jnp.int32) for c in cols]
    if stats is not None:
        rows.append(_pad_stats_row(stats, size))
    return jnp.stack(rows)


def _pad_stats_row(stats, size: int):
    s = stats.astype(jnp.int32)[:size]
    return jnp.concatenate(
        [s, jnp.zeros((size - s.shape[0],), jnp.int32)]
    ) if s.shape[0] < size else s


@partial(jax.jit, static_argnames=("size",))
def _slice_block(sorted_cols, size: int, stats=None):
    """Phase C (carry variant): slice the seed prefix and stack."""
    rows = [c[:size].astype(jnp.int32) for c in sorted_cols]
    if stats is not None:
        rows.append(_pad_stats_row(stats, size))
    return jnp.stack(rows)


@jax.jit
def _stack_stats(*arrs):
    """Concatenate deferred size counters (1-D arrays / scalars) into
    one int32 vector so they ride a single transfer."""
    return jnp.concatenate(
        [jnp.atleast_1d(a).astype(jnp.int32) for a in arrs]
    )


def _unpack_pairs(arr, lengths_np, kmer_size: int, wide: bool
                  ) -> CandidatePairs:
    """Host half: unpack the (3|4, num) block; recompute the overlap
    estimate with the device formula (int32, chain.hpp:48-71)."""
    if wide:
        read_h = arr[0].astype(np.int32)
        read_v = arr[1].astype(np.int32)
        cm2 = arr[2].view(np.uint32)
        poshv = arr[3].view(np.uint32)
    else:
        hv = arr[0].view(np.uint32)
        read_h = (hv >> 16).astype(np.int32)
        read_v = (hv & 0xFFFF).astype(np.int32)
        cm2 = arr[1].view(np.uint32)
        poshv = arr[2].view(np.uint32)
    pos_h = (poshv >> 16).astype(np.int32)
    pos_v = (poshv & 0xFFFF).astype(np.int32)
    flip = (cm2 >> 31) != 0
    count = ((cm2 >> 13) & 0xFFFF).astype(np.int32)
    matches = (cm2 & 0x1FFF).astype(np.int32)
    lens = np.asarray(lengths_np, dtype=np.int32)
    k = np.int32(kmer_size)
    len_h = lens[read_h]
    len_v = lens[read_v]
    beg_h = np.where(flip, len_h - pos_h - k, pos_h)
    ov = (
        np.minimum(beg_h, pos_v)
        + np.minimum(len_h - (beg_h + k), len_v - (pos_v + k))
        + k
    ).astype(np.int32)
    return CandidatePairs(
        read_h, read_v, pos_h, pos_v, count, matches, ov, flip
    )


def _finish_chain(ops, read_lengths, lengths_np, kmer_size: int,
                  bin_size: int, wide: bool, hint=None,
                  hint_out=None) -> CandidatePairs:
    """Host driver for the fused finish: phase A (scans+pack) emits the
    seed count; phase B (the seed-ordering sort) is dispatched BEFORE
    the count's readback blocks, so the two overlap; phase C then moves
    exactly the pair bucket to the host.

    hint (speculative-size path, see detect_overlaps): dict with
    "nseed" (the previous run's seed count — used for the phase-C
    bucket WITHOUT blocking on this run's count) and "stats_pre"
    (deferred upstream counters); the true counters ride home as an
    extra row of the phase-C block and land in hint_out["stats"] as
    [*stats_pre..., nseed] for the caller to verify. Shapes only —
    every device value is exact; a wrong hint is detected and redone
    by the caller."""
    n = int(ops[0].shape[0])
    cols, key, nseed = _chain_finish(
        ops, read_lengths,
        kmer_size=kmer_size, bin_size=bin_size, wide=wide,
    )
    del ops
    carry = n > (1 << 23)  # huge streams: gathers are the slow path
    if carry:
        sorted_cols = _sort_carry(key, cols)
    else:
        skey = _sort_seedkey(key)
    stats = None
    if hint is not None:
        stats = _stack_stats(*hint["stats_pre"], nseed)
        num = int(hint["nseed"])
        if num == 0:
            hint_out["stats"] = np.asarray(stats)
            return CandidatePairs.empty()
    else:
        num = int(nseed)  # round trip overlaps the phase-B sort
        if hint_out is not None:
            hint_out["nseed"] = num
        if num == 0:
            return CandidatePairs.empty()
    size = min(1 << max(10, (num - 1).bit_length()), n)
    if carry:
        arr = np.asarray(_slice_block(sorted_cols, size, stats))
    else:
        arr = np.asarray(_gather_block(skey, cols, size, stats))
    if stats is not None:
        hint_out["stats"] = arr[-1]
        arr = arr[:-1]
        # The stats row is [*stats_pre..., nseed]; trim to the TRUE seed
        # count when the hint overestimated (stale on-disk hint or key
        # collision) — rows past it are sentinel/non-seed rows whose
        # packed ids would index out of range in _unpack_pairs. An
        # underestimate is caught by _verify_hints and redone exactly.
        npre = sum(
            int(np.prod(np.shape(a), dtype=np.int64))
            for a in hint["stats_pre"]
        )
        num = min(num, int(hint_out["stats"][npre]))
    arr = arr[:, :num]
    if lengths_np is None:
        lengths_np = np.asarray(read_lengths)
    return _unpack_pairs(arr, lengths_np, kmer_size, wide=wide)


@partial(jax.jit, static_argnames=("kmer_size",))
def _chain_stage32(h, v, bin_id, pos_h, pos_v, flip, ov, kmer_size: int):
    """Phase 3: (h, v, bin, posH) 4-key int32 sort + segmented chain."""
    k = kmer_size
    h, v, bin_id, pos_h, pos_v, flip, ov = jax.lax.sort(
        (h, v, bin_id, pos_h, pos_v, flip, ov), num_keys=5
    )
    live = h != _SENT32
    pair_b = seg.boundaries2(h, v)
    bin_b = seg.boundaries_many(h, v, bin_id)

    bucket = pos_h // (k + 1)
    prev_bucket = jnp.concatenate([bucket[:1], bucket[:-1]])
    dup = (~bin_b) & (bucket == prev_bucket)
    kept = (~dup) & live

    support = seg.seg_sum_bcast(kept.astype(jnp.int32), bin_b)
    count = seg.seg_sum_bcast(live.astype(jnp.int32), pair_b)
    binidx = seg.seg_cumsum(bin_b.astype(jnp.int32), pair_b)
    score = support.astype(jnp.int64) * (1 << 31) + ((1 << 31) - binidx)
    best = seg.seg_max_bcast(score, pair_b)
    seed_mask = (score == best) & bin_b & live

    return dict(
        seed_mask=seed_mask, read_h=h, read_v=v, pos_h=pos_h, pos_v=pos_v,
        count=count, matches=support, overlap_est=ov,
        seed_rc=flip,
    )


# speculative-size cache: the packed detect path's only host blocking is
# 3 size readbacks (nnz / live candidates / seeds), each a host round
# trip that serializes the dispatch stream. Sizes only pick static
# SHAPE buckets — device values stay exact — so a repeat run on the same
# corpus dispatches every stage immediately with the previous run's
# sizes and verifies the true counters (one extra row of the final
# transfer) at the end; any size that proved too small triggers one
# non-speculative redo. Keyed by a corpus/config fingerprint; a
# collision costs a redo, never a wrong result.
_SIZE_HINTS: dict = {}


def _hints_key(reads, config):
    lens = reads.lengths
    step = max(1, len(lens) // 64)
    # Content sample: a strided byte sample of the packed codes (~16 K
    # elements, a few MB of cache-line traffic even on the slow host)
    # makes distinct corpora with identical length profiles hit
    # distinct hint records — same-shape different-content corpora
    # would otherwise pay a speculative dispatch + exact redo per run.
    import hashlib

    codes = np.asarray(reads.codes)
    cstep = max(1, len(codes) // 16384)
    sample = np.ascontiguousarray(codes[::cstep])
    digest = hashlib.sha1(sample.tobytes()).hexdigest()[:16]
    return (
        reads.num_reads, len(reads.codes),
        int(lens[::step].astype(np.int64).sum()), digest,
        config.kmer_size, config.lower_freq, config.upper_freq,
        config.bin_size, config.use_hopc,
    )


def _hints_load(hkey):
    """The hint record of an earlier run in this process, if any.
    BELLA_NO_SIZE_HINTS=1 forces the exact blocking-readback flow."""
    import os

    if os.environ.get("BELLA_NO_SIZE_HINTS"):
        return None
    return _SIZE_HINTS.get(hkey)


def _hints_store(hkey, narr, n_cand: int, nseed: int) -> None:
    _SIZE_HINTS[hkey] = dict(
        narr=np.asarray(narr).copy(), n_cand=int(n_cand), nseed=int(nseed)
    )


def _verify_hints(hkey, hints, hint_out, nnzs_len: int, size: int,
                  lag_sizes, upper: int):
    """Check a hinted run's true counters against the buckets it used.
    Returns (ok, n_act, nseed_act); always stores the fresh counters."""
    sarr = hint_out["stats"]
    narr_act = sarr[:nnzs_len]
    ncand_act = int(sarr[nnzs_len])
    nseed_act = int(sarr[nnzs_len + 1])
    n_act = int(narr_act[0])
    ok = n_act <= size and ncand_act <= int(hint_out.get("lim", 0))
    if ok:
        for d in range(1, upper):
            a = int(narr_act[min(d, nnzs_len - 1)])
            if lag_sizes[d - 1] < min(a, size):
                ok = False
                break
    ok = ok and nseed_act <= int(hints["nseed"])
    _hints_store(hkey, narr_act, ncand_act, nseed_act)
    return ok, n_act, nseed_act


def _size_bucket(n: int) -> int:
    """Next size in a 8-buckets-per-octave progression (<=12.5% padding
    waste). Bucketed input shapes keep jit cache keys stable across
    datasets, so compiles are reused."""
    if n <= 4096:
        return 4096
    octave = 1 << ((n - 1).bit_length() - 1)
    step = max(octave // 8, 1)
    return ((n + step - 1) // step) * step


def _detect_overlaps_split(reads, config: BellaConfig, budget: float,
                           wide: bool = False, force_group: int = 0,
                           staged_chain: bool = False):
    """Beyond-HBM fused path: k-mer-space split counting with on-device
    accumulation (the reference's --split-count, include/kmercount.hpp:
    478-534).

    1. the code stream is chunked at read boundaries; each chunk is
       extracted (4-phase) and partitioned by hash(kmer) % splits into
       per-pass regions of one big device accumulator (so only a chunk's
       working set plus the accumulator regions are resident),
    2. each pass region is sorted + counted + reliable-compacted on its
       own (region-sized sorts, the memory win),
    3. ONE packed emit+chain runs over the concatenated reliable rows
       (passes own disjoint k-mer sets, so segments stay contiguous and
       within-segment ranks remain valid).

    When the full splits * region_cap accumulator would exceed ~40% of
    the budget, passes are processed in GROUPS sized to
    the budget and every chunk is RE-extracted once per group — the
    reference's actual --split-count re-scan trade
    (include/kmercount.hpp:478-534: one full read pass per split),
    except re-extraction here costs only device compute: each chunk's
    2-bit packed bytes (0.25 B/position) stay resident on device across
    groups, so nothing is re-uploaded.

    All capacities are bucketed; overflow is counted and logged, never
    silent."""
    k = config.kmer_size
    u32 = jnp.uint32
    total = len(reads.codes)
    R = reads.num_reads
    offsets = reads.offsets.astype(np.int64)
    max_len = int(reads.lengths.max()) if R else 0

    # 200 B/position: the per-pass working set is the binding constraint
    # — the region's sort -> count -> compact chain keeps ~50 B/row in
    # flight WHILE the ~40%-of-budget accumulator is resident (the
    # accumulator self-scales via `group`, so more splits shrink the
    # per-pass peak without shrinking throughput); the per-pass
    # compacted blocks and the 8-stream extractor scan join that peak.
    #
    # staged_chain additionally keeps the 2-bit chunk codes (0.25
    # B/position) AND the accumulated packed reliable slices (~1.5
    # B/position at long-read reliable densities) resident through the
    # pass loop — carve them out of the working budget so the per-pass
    # peak still fits.
    if staged_chain:
        budget = max(budget - total * 1.0, budget * 0.4)
    splits = max(int(np.ceil(total * 200 / budget)), 2)
    # packed partition: the pass tag rides the key word's free top bits,
    # cutting the partition sort (the split path's dominant cost) from 5
    # operands to 3 (non-wide, strand packed too — no sc stream) or 4
    # (wide). Always true for the k <= 28 corpora this path serves.
    packed = _part_packable(k, splits, wide)
    p3 = packed and not wide  # 3-stream accumulator layout
    # chunk size: the partition sort (x2 out-of-place) is the
    # chunk-resident cost
    cb = _size_bucket(max(min(int(budget / 240), total), max_len + 8, 1 << 16))
    cb = ((cb + 3) // 4) * 4
    region_cap = _size_bucket(total // splits * 7 // 5 + (1 << 14))
    cap_cp = _size_bucket(cb * 8 // (5 * splits) + 4096)
    # passes resident at once: the accumulator (12 B/row packed non-wide,
    # else 13) may take ~40% of the budget (count sorts run per region;
    # the resident code stream and chunk working set take the rest)
    # staged mode spends a LARGER budget share on the accumulator: the
    # group count sets how many times the whole corpus re-partitions
    # (groups ~ total*1.4*13/(share*budget), each a full-corpus
    # partition sort), and staged compacts are small, so trading transient
    # slack for fewer re-extractions wins
    group = force_group or int(
        max(1, min(splits,
                   int(budget * (0.45 if staged_chain else 0.4))
                   // (region_cap * (12 if p3 else 13))))
    )
    n_groups = (splits + group - 1) // group
    if n_groups > 1:
        log("splitPassGroups",
            f"{n_groups} groups x {group} passes (re-extraction per group)")

    sent = np.uint32(0xFFFFFFFF)

    # host-side chunking ONCE; packed chunk bytes are uploaded once and
    # stay resident across pass groups (0.25 B/position). Chunk read
    # counts are padded to one shared bucket with zero-length reads
    # (they own no positions), so every chunk reuses ONE compiled
    # _chunk_partition shape instead of one per distinct read count.
    bounds = [0]
    while bounds[-1] < R:
        lo = bounds[-1]
        hi = lo + 1
        while hi < R and offsets[hi + 1] - offsets[lo] <= cb:
            hi += 1
        bounds.append(hi)
    NR = _size_bucket(max(b - a for a, b in zip(bounds, bounds[1:])) + 1)
    chunks = []  # (codes_dev, lengths_dev, offs_dev, n_reads, lo)
    for lo, hi in zip(bounds, bounds[1:]):
        span = int(offsets[hi] - offsets[lo])
        codes_c = reads.codes[int(offsets[lo]):int(offsets[hi])]
        lengths_c = reads.lengths[lo:hi].astype(np.int32)
        offs_c = (offsets[lo:hi + 1] - offsets[lo]).astype(np.int32)
        if span < cb:  # phantom read pads the chunk to the bucket
            codes_c = np.concatenate(
                [codes_c, np.zeros(cb - span, codes_c.dtype)]
            )
            lengths_c = np.append(lengths_c, np.int32(cb - span))
            offs_c = np.append(offs_c, np.int32(cb))
        if len(lengths_c) < NR:  # zero-length reads pad the read count
            pad = NR - len(lengths_c)
            lengths_c = np.concatenate([lengths_c, np.zeros(pad, np.int32)])
            offs_c = np.concatenate(
                [offs_c, np.full(pad, offs_c[-1], np.int32)]
            )
        c4 = codes_c.reshape(-1, 4).astype(np.uint8)
        cbytes = np.concatenate([
            c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4) | (c4[:, 3] << 6),
            np.zeros(8, np.uint8),
        ])
        chunks.append((
            jnp.asarray(cbytes), jnp.asarray(lengths_c),
            jnp.asarray(offs_c), hi - lo, lo,
        ))

    lengths_dev = jnp.asarray(reads.lengths.astype(np.int32))
    emit_parts = []   # per-pass emitted candidate streams
    ncands = []       # per-pass live-candidate device scalars
    compact_parts = []  # staged_chain: per-pass packed reliable slices
    num_kmers = 0
    nnz_total = 0
    overflow = 0
    for g0 in range(0, splits, group):
        g1 = min(g0 + group, splits)
        # + cap_cp tail slack: _accum_append's fixed-width window may
        # extend past the last region without clamping (clamping would
        # shift it). wide mode: aridpos holds rid (u32) and asc holds
        # possc (u32). One `group`-sized shape for every group (the
        # tail group just leaves regions empty) = one compile.
        akhi = jnp.full((group * region_cap + cap_cp,), sent, u32)
        aklo = jnp.full((group * region_cap + cap_cp,), sent, u32)
        aridpos = jnp.zeros((group * region_cap + cap_cp,), u32)
        asc = (None if p3 else
               jnp.zeros((group * region_cap + cap_cp,),
                         u32 if wide else bool))

        off = [0] * (g1 - g0)
        for codes_dev, lengths_dev_c, offs_dev, nr_c, lo_c in chunks:
            part = _chunk_partition(
                codes_dev, lengths_dev_c, offs_dev,
                jnp.int32(nr_c), jnp.int32(lo_c),
                kmer_size=k, splits=splits, wide=wide, packed=packed,
            )
            if p3:
                khi, klo_a, ridpos, starts = part
                sc = None
            else:
                khi, klo_a, ridpos, sc, starts = part
            st = np.asarray(starts)
            for pi, p in enumerate(range(g0, g1)):
                nv = int(st[p + 1] - st[p])
                if nv <= 0:
                    continue
                if nv > cap_cp:
                    overflow += nv - cap_cp
                    nv = cap_cp
                room = region_cap - off[pi]
                if nv > room:
                    overflow += nv - room
                    nv = room
                if nv <= 0:
                    continue
                if p3:
                    akhi, aklo, aridpos = _accum_append3(
                        akhi, aklo, aridpos, khi, klo_a, ridpos,
                        np.int32(st[p]), np.int32(nv),
                        np.int32(pi * region_cap + off[pi]), cap=cap_cp,
                    )
                else:
                    akhi, aklo, aridpos, asc = _accum_append(
                        akhi, aklo, aridpos, asc, khi, klo_a, ridpos, sc,
                        np.int32(st[p]), np.int32(nv),
                        np.int32(pi * region_cap + off[pi]), cap=cap_cp,
                    )
                off[pi] += nv
            del part, khi, klo_a, ridpos, sc, starts

        # per-pass count + reliable compaction + EMISSION. Passes own
        # disjoint k-mer sets, so lag pairing and chain segments never
        # straddle passes: emitting per pass (with the count-DESC lag
        # prefixes, see _fused_emit_packed lag_sizes) keeps only the
        # ~2-3x-nnz_p candidate stream per pass instead of carrying all
        # reliable rows to one (upper-1) x total emission — the chain
        # sort shrinks ~3x and reliable rows are never capped/dropped.
        for pi in range(g1 - g0):
            sl_lo = pi * region_cap
            # sort only the FILLED prefix of the region (bucketed; the
            # fill off[pi] is host-known, rows beyond it are sentinels
            # from the fixed-width appends): the 1.4x routing slack
            # otherwise rides through the pass's sort+count+compact
            fill = min(
                _size_bucket(max(off[pi] + 1, 1 << 14)), region_cap
            )
            sl_hi = sl_lo + fill
            # wide rows carry possc as their own operand (17 bits — no
            # room in the key word), so only the 16-bit layout packs the
            # strand bit into the sort key (3 operands instead of 4);
            # the packed partition already emits that layout (p3), so
            # the region sort skips the repack arithmetic
            khi_p, klo_p, rp_p, sc_p, _ = _sort_kmers(
                akhi[sl_lo:sl_hi], aklo[sl_lo:sl_hi],
                aridpos[sl_lo:sl_hi],
                None if p3 else asc[sl_lo:sl_hi], None,
                pack_ridpos=True, pack_sc=not wide, pre_packed=p3,
            )
            if wide:
                (reliable, sr, sp, scw, rank, cnt_p, nnzs_p,
                 nk_p) = _count_sorted_wide(
                    khi_p, klo_p, rp_p, sc_p,
                    lower=config.lower_freq, upper=config.upper_freq,
                )
                nnz_p = nnzs_p[0]
            else:
                reliable, sr, sp, scw, rank, cnt_p, nnzs_p, nk_p = (
                    _count_sorted(
                        khi_p, klo_p, rp_p, sc_p, None,
                        lower=config.lower_freq, upper=config.upper_freq,
                        pack_ridpos=True, pack_sc=True,
                    ))
                nnz_p = nnzs_p[0]
            # compaction sort dispatched before the nnz_p readback blocks
            # (see _compact_sort): the sort overlaps the readback
            if wide:
                comp = _compact_sort_wide(reliable, sr, sp, scw, rank, cnt_p)
            else:
                comp = _compact_sort(reliable, sr, sp, scw, rank, cnt_p)
            # drop the full-fill count outputs before the emit/chain of
            # this pass allocate (the split path runs near the budget)
            del reliable, sr, sp, scw, rank, cnt_p
            narr_p = np.asarray(nnzs_p)
            n_p = int(narr_p[0])
            num_kmers += int(nk_p)
            nnz_total += n_p
            if n_p == 0:
                continue
            size_p = min(_size_bucket(max(n_p, 1 << 14)), region_cap)
            if staged_chain:
                # keep the PACKED compacted reliable slice resident
                # (2-3 u32 operands, ~8-12 B/row at ~0.1 rows/position)
                # and defer ALL emission to the per-h-range passes —
                # the corpus-wide candidate stream never materialises
                compact_parts.append((
                    _take_prefix_n(*comp, size=size_p),
                    narr_p, n_p, size_p,
                ))
                del comp
                continue
            if wide:
                csr, csp, csc, crank = _compact_slice_wide(
                    *comp, size=size_p)
            else:
                csr, csp, csc, crank = _compact_slice(
                    *comp, size=size_p)
            del comp
            lag_sizes = _lag_sizes(narr_p, size_p, config.upper_freq)
            if wide:
                h_p, v_p, k3_p, pv_p, nc_p = _fused_emit_wide(
                    nnzs_p[0].astype(jnp.int32), csr, csp, csc, crank,
                    lengths_dev, kmer_size=k, upper=config.upper_freq,
                    bin_size=config.bin_size, lag_sizes=tuple(lag_sizes),
                )
                emit_parts.append((h_p, v_p, k3_p, pv_p))
            else:
                hv_p, k3_p, pv_p, nc_p = _fused_emit_packed(
                    nnzs_p[0].astype(jnp.int32), csr, csp, csc, crank,
                    lengths_dev, kmer_size=k, upper=config.upper_freq,
                    bin_size=config.bin_size, lag_sizes=tuple(lag_sizes),
                )
                emit_parts.append((hv_p, k3_p, pv_p))
            ncands.append(nc_p)
            del csr, csp, csc, crank
        # the accumulator is dead weight between groups and after the
        # last one; free it before the next allocation / the emit stages
        del akhi, aklo, aridpos, asc
    if overflow:
        log("splitRoutingOverflowDropped", overflow)
    del chunks
    if staged_chain:
        return _staged_chain_finish(
            compact_parts, reads, config, budget, wide, lengths_dev,
            num_kmers, nnz_total,
        )
    if not emit_parts:
        return CandidatePairs.empty(), num_kmers, nnz_total

    # concatenate the per-pass candidate streams (each already padded
    # with sentinels to its own bucket — sentinels sort to the end of
    # the chain sort and are excluded from the live count)
    n_cand = lambda: sum(int(c) for c in ncands)
    if wide:
        h = jnp.concatenate([p[0] for p in emit_parts])
        v = jnp.concatenate([p[1] for p in emit_parts])
        k3 = jnp.concatenate([p[2] for p in emit_parts])
        pv = jnp.concatenate([p[3] for p in emit_parts])
        del emit_parts
        pairs = _chain_wide(
            h, v, k3, pv, lengths_dev, kmer_size=k,
            bin_size=config.bin_size, live_rows=n_cand,
            lengths_np=reads.lengths,
        )
        del h, v, k3, pv
    else:
        hv = jnp.concatenate([p[0] for p in emit_parts])
        k3 = jnp.concatenate([p[1] for p in emit_parts])
        pv = jnp.concatenate([p[2] for p in emit_parts])
        del emit_parts
        pairs = _chain_packed(
            hv, k3, pv, lengths_dev, kmer_size=k, bin_size=config.bin_size,
            live_rows=n_cand, lengths_np=reads.lengths,
        )
        del hv, k3, pv
    return pairs, num_kmers, nnz_total


def _staged_chain_finish(compact_parts, reads, config: BellaConfig,
                         budget: float, wide: bool, lengths_dev,
                         num_kmers: int, nnz_total: int):
    """hv-range staged emission + chaining (the reference's column-block
    staging role, include/overlap.hpp:682-710, re-designed around the
    sort pipeline): beyond the fused path's candidate-stream gate, the
    per-pass PACKED reliable slices stay resident (~1 B/position) and
    pairs are produced one h-range at a time —

      for each read range [lo, hi): every pass re-emits only pairs
      whose h lands in the range (a pair's candidates all share (h, v),
      so ranges partition PAIRS exactly), the range's streams compact
      through the chain sort, and one chain finish yields that range's
      CandidatePairs; ranges concatenate on host (O(pairs)).

    Exactness: the pair set and every per-pair result are identical to
    the unstaged path — ranges partition pairs, and chaining is
    per-pair-independent. Cost: emission and its compaction sort re-run
    once per range over each pass's lag-sliced stream (~2x total sort
    volume at 2 ranges); nothing corpus-sized is ever resident."""
    if not compact_parts:
        return CandidatePairs.empty(), num_kmers, nnz_total
    k = config.kmer_size
    upper = config.upper_freq
    u32 = jnp.uint32

    lag_all = [
        _lag_sizes(narr_p, size_p, upper)
        for _, narr_p, _, size_p in compact_parts
    ]
    est_rows = sum(sum(ls) for ls in lag_all)
    bytes_per_row = 16 if wide else 12
    # per-range chain working set: concat + its 2x out-of-place sort
    chain_budget = max(budget * 0.3, float(1 << 28))
    n_ranges = max(2, -(-int(est_rows * bytes_per_row * 3) // int(chain_budget)))
    # read-id range bounds balanced by position mass (pair mass per h
    # tracks read-h coverage); exact per-range sizing comes from the
    # emit live counters, so imbalance costs padding, never correctness
    cum = np.cumsum(reads.lengths.astype(np.int64))
    bounds = [0] + [
        int(np.searchsorted(cum, cum[-1] * i // n_ranges))
        for i in range(1, n_ranges)
    ] + [reads.num_reads]
    log("stagedChainRanges",
        f"{n_ranges} h-ranges x {len(compact_parts)} passes "
        f"(est {est_rows} emitted rows)")

    out_parts = []
    for r in range(n_ranges):
        lo, hi = bounds[r], bounds[r + 1]
        if lo >= hi:
            continue
        hb = jnp.asarray([lo, hi], np.uint32)
        # pipelined dispatch: emit + chain-sort of the next passes are
        # dispatched (async) before the previous ones' live-count
        # readbacks block, so the readbacks overlap in-flight sorts
        # instead of serializing every pass. The window
        # is BOUNDED (4) because a pass's full-size emit buffer stays
        # alive until its slice — unbounded dispatch would re-materialize
        # the corpus-wide stream this path exists to avoid.
        parts = []
        live = 0
        pending = []

        def _drain_one():
            nonlocal live
            arrs, nl = pending.pop(0)
            nl_i = int(nl)
            b = min(_size_bucket(max(nl_i, 1 << 10)), arrs[0].shape[0])
            parts.append(_take_prefix_n(*arrs, size=b))
            live += nl_i

        for (ops, narr_p, n_p, size_p), lag_sizes in zip(
            compact_parts, lag_all
        ):
            if wide:
                sr, sp, sc, rank = _compact_slice_wide(
                    *ops, size=size_p
                )
                h_, v_, k3_, pv_, nl = _fused_emit_wide(
                    jnp.int32(n_p), sr, sp, sc, rank,
                    lengths_dev, hb, kmer_size=k, upper=upper,
                    bin_size=config.bin_size, lag_sizes=tuple(lag_sizes),
                )
                del sr, sp, sc, rank
                # chain sort doubles as sentinel compaction (sentinel
                # h/v sort to the tail); slice to the live bucket
                pending.append(
                    (_chain_sort_wide(h_, v_, k3_, pv_), nl)
                )
                del h_, v_, k3_, pv_
            else:
                sr, sp, sc, rank = _compact_slice(
                    *ops, size=size_p
                )
                hv_, k3_, pv_, nl = _fused_emit_packed(
                    jnp.int32(n_p), sr, sp, sc, rank,
                    lengths_dev, hb, kmer_size=k, upper=upper,
                    bin_size=config.bin_size, lag_sizes=tuple(lag_sizes),
                )
                del sr, sp, sc, rank
                pending.append((
                    _chain_sort_packed(hv_, k3_, pv_), nl
                ))
                del hv_, k3_, pv_
            if len(pending) >= 4:
                _drain_one()
        while pending:
            _drain_one()
        if wide:
            h = jnp.concatenate([p[0] for p in parts])
            v = jnp.concatenate([p[1] for p in parts])
            k3 = jnp.concatenate([p[2] for p in parts])
            pv = jnp.concatenate([p[3] for p in parts])
            del parts
            pr = _chain_wide(
                h, v, k3, pv, lengths_dev, kmer_size=k,
                bin_size=config.bin_size, live_rows=live,
                lengths_np=reads.lengths,
            )
            del h, v, k3, pv
        else:
            hv = jnp.concatenate([p[0] for p in parts])
            k3 = jnp.concatenate([p[1] for p in parts])
            pv = jnp.concatenate([p[2] for p in parts])
            del parts
            pr = _chain_packed(
                hv, k3, pv, lengths_dev, kmer_size=k,
                bin_size=config.bin_size, live_rows=live,
                lengths_np=reads.lengths,
            )
            del hv, k3, pv
        out_parts.append(pr)
    return CandidatePairs.concatenate(out_parts), num_kmers, nnz_total


def detect_overlaps(reads, config: BellaConfig, _use_hints: bool = True):
    """Fused (4-dispatch) end-to-end overlap detection for the common
    configuration (plain k-mers or HOPC, single split). Intermediates
    never leave the device; split into separate medium jits, whose
    sizes come from readbacks in between. Returns (CandidatePairs,
    num_kmers, nnz).

    _use_hints: repeat runs on the same corpus/config dispatch with the
    previous run's size buckets and verify at the end (see _SIZE_HINTS);
    set False to force the exact blocking-readback flow."""
    k = config.kmer_size
    m = len(reads.codes) - k + 1
    if m <= 0:
        return CandidatePairs.empty(), 0, 0
    budget = config.effective_memory_mb * 1e6
    if m * 100 > budget:
        # beyond the single-pass device budget (~100 device bytes per
        # k-mer position across the count sort + emit/chain programs):
        # use the fused split-count path — its accumulator groups passes
        # to the budget and re-extracts per group (the reference's
        # --split-count re-scan), so the binding constraint is the final
        # emit/chain over the per-pass lag-sliced candidate streams
        # (~8 B/position at typical reliable densities; reliable rows
        # are never capped). Beyond that, the host-staged path (the
        # reference's column-block staging, overlap.hpp:682-710).
        max_len = int(reads.lengths.max()) if reads.num_reads else 0
        common = (
            max_len <= 0xFFFF and config.bin_size >= 3
            and not config.use_hopc and k <= 28
        )
        p16 = reads.num_reads <= 0xFFFF and config.upper_freq <= 255
        wide_ok = (
            reads.num_reads < (1 << 31) - 1
            and config.upper_freq <= (1 << 15)
        )
        if common and (p16 or wide_ok):
            if len(reads.codes) * 10 <= budget:
                # concatenated candidate stream + its chain sort fit
                log("detectionPath", "split")
                return _detect_overlaps_split(reads, config, budget,
                                              wide=not p16)
            if len(reads.codes) * 4 <= budget:
                # beyond the stream gate (codes * 10 > budget): hv-range
                # staged chaining — only the packed reliable slices
                # (~1 B/position) stay resident, pairs are chained one
                # read-range at a time (_staged_chain_finish); moves
                # the full-speed gate to codes * 4 <= budget
                log("detectionPath", "staged")
                return _detect_overlaps_split(reads, config, budget,
                                              wide=not p16,
                                              staged_chain=True)
        from bella_tpu.kmers.count import build_reliable_triples

        log("detectionPath", "host-staged")

        tri = build_reliable_triples(reads, config)
        pairs = generate_candidates(tri, reads.lengths, config)
        return pairs, tri.num_kmers, tri.nnz
    log("detectionPath", "single-pass")
    total = len(reads.codes)
    # 2-bit pack for the upload (bucket sizes are multiples of 4): 4x
    # smaller host->device transfer, consumed by the 4-phase extractor
    # (see _extract_kmers_phased) so no padded unpack buffer ever
    # materialises. HOPC and k > 28 fall back to a raw upload + the
    # per-position extractor.
    phased = not config.use_hopc and k <= 28
    # packed 3-operand sort path when ids/positions fit 16 bits (the
    # reference caps positions at 16 bits too, src/main.cpp:193)
    max_len = int(reads.lengths.max()) if reads.num_reads else 0
    # upper_freq <= 255: _compact_reliable packs the within-segment rank
    # into 8 bits, so wider bounds (legal via --auto-bounds at high
    # coverage) must take the unpacked path
    packed = (
        reads.num_reads <= 0xFFFF and max_len <= 0xFFFF
        and config.bin_size >= 3 and config.upper_freq <= 255
    )
    # wide-id packed path: > 65,535 reads with <= 65,535-base reads (the
    # common large-corpus shape; KMERINDEX switch src/main.cpp:60-61)
    wide = (
        not packed and reads.num_reads < (1 << 31) - 1 and max_len <= 0xFFFF
        and config.bin_size >= 3 and config.upper_freq <= (1 << 15)
    )
    # big corpora on the phased path: chunked extraction pipelines the
    # host packing + upload of chunk i+1 with chunk i's device
    # extraction (one compiled shape across chunks)
    chunked = phased and (packed or wide) and total > 2 * _CHUNK_BASES
    if not chunked:
        # pad the code stream to a bucketed size with a phantom read
        # whose occurrences are masked invalid (stable jit shapes)
        total_p = _size_bucket(total)
        codes = reads.codes
        lengths = reads.lengths.astype(np.int32)
        offsets = reads.offsets.astype(np.int32)
        if total_p > total:
            codes = np.concatenate(
                [codes, np.zeros(total_p - total, codes.dtype)]
            )
            lengths = np.append(lengths, np.int32(total_p - total))
            offsets = np.append(offsets, np.int32(total_p))
        if phased:
            c4 = codes.reshape(-1, 4).astype(np.uint8)
            codes_packed = np.concatenate([
                c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4) | (c4[:, 3] << 6),
                np.zeros(8, np.uint8),  # window pad (8-byte sliding u64)
            ])
        else:
            codes_packed = codes.astype(np.int8)
    if wide:
        if chunked:
            khi, klo, rid, sc0, pos = _extract_stream_chunked(
                reads, k, pack_ridpos=False,
            )
            khi, klo, rid, possc = _sort_kmers_wide(
                khi, klo, rid, pos, sc0
            )
            (reliable, sr, sp, sc, rank, cnt, nnzs,
             num_kmers) = _count_sorted_wide(
                khi, klo, rid, possc,
                lower=config.lower_freq, upper=config.upper_freq,
            )
            del khi, klo, rid, possc, sc0, pos
        else:
            reliable, sr, sp, sc, rank, cnt, nnzs, num_kmers = _fused_count_wide(
                jnp.asarray(codes_packed),
                jnp.asarray(lengths),
                jnp.asarray(offsets),
                n_real=jnp.int32(reads.num_reads),
                kmer_size=k,
                lower=config.lower_freq,
                upper=config.upper_freq,
                use_hopc=config.use_hopc,
                phased=phased,
            )
        # dispatch the compaction sort BEFORE blocking on the nnz
        # readback: the sort (no size dependence) then runs on device
        # while the readback is in flight
        comp = _compact_sort_wide(reliable, sr, sp, sc, rank, cnt)
        del reliable, sr, sp, sc, rank, cnt
        hkey = _hints_key(reads, config)
        hints = _hints_load(hkey) if _use_hints else None
        if hints is not None:
            narr = hints["narr"]
        else:
            narr = np.asarray(nnzs)
        n = int(narr[0])
        if n == 0 and hints is None:
            return CandidatePairs.empty(), int(num_kmers), 0
        lengths_dev = jnp.asarray(reads.lengths.astype(np.int32))
        size = min(_size_bucket(max(n, 1 << 14)), int(comp[0].shape[0]))
        lag_sizes = _lag_sizes(narr, size, config.upper_freq)
        emit_kw = dict(
            kmer_size=k, upper=config.upper_freq, bin_size=config.bin_size,
            lag_sizes=tuple(lag_sizes),
        )
        csr, csp, csc, crank = _compact_slice_wide(
            *comp, size=size
        )
        del comp
        h, v, k3, pv, _n_cand = _fused_emit_wide(
            nnzs[0].astype(jnp.int32),
            csr, csp, csc, crank, lengths_dev, **emit_kw,
        )
        hint_out: dict = {}
        if hints is not None:
            finish_hint = dict(
                nseed=int(hints["nseed"]), stats_pre=(nnzs, _n_cand)
            )
            live_rows = int(hints["n_cand"])
        else:
            finish_hint = None
            nc_memo: dict = {}

            def live_rows():
                nc_memo["v"] = int(_n_cand)
                return nc_memo["v"]
        pairs = _chain_wide(
            h, v, k3, pv, lengths_dev, kmer_size=k,
            bin_size=config.bin_size, live_rows=live_rows,
            lengths_np=reads.lengths, hint=finish_hint, hint_out=hint_out,
        )
        del h, v, k3, pv, csr, csp, csc, crank
        if hints is not None:
            ok, n_act, nseed_act = _verify_hints(
                hkey, hints, hint_out, int(nnzs.shape[0]), size,
                lag_sizes, config.upper_freq,
            )
            if not ok:
                log("sizeHintsMiss",
                    "speculative sizes underestimated; re-running exact")
                return detect_overlaps(reads, config, _use_hints=False)
            return pairs.take_prefix(nseed_act), int(num_kmers), n_act
        _hints_store(
            hkey, narr, nc_memo.get("v", 0),
            int(hint_out.get("nseed", pairs.num_pairs)),
        )
        return pairs, int(num_kmers), n
    if chunked:
        pack_sc = packed and k <= 31
        khi, klo, p1, sc0, p2 = _extract_stream_chunked(
            reads, k, pack_ridpos=packed,
        )
        khi, klo, p1, sc0, p2 = _sort_kmers(
            khi, klo, p1, sc0, p2,
            pack_ridpos=packed, pack_sc=pack_sc,
        )
        live, sr, sp, sc, rank, cnt, nnzs, num_kmers = _count_sorted(
            khi, klo, p1, sc0, p2,
            lower=config.lower_freq, upper=config.upper_freq,
            pack_ridpos=packed, pack_sc=pack_sc,
        )
        del khi, klo, p1, sc0, p2
    else:
        live, sr, sp, sc, rank, cnt, nnzs, num_kmers = _fused_count(
            jnp.asarray(codes_packed),
            jnp.asarray(lengths),
            jnp.asarray(offsets),
            n_real=jnp.int32(reads.num_reads),
            kmer_size=k,
            lower=config.lower_freq,
            upper=config.upper_freq,
            use_hopc=config.use_hopc,
            pack_ridpos=packed,
            phased=phased,
        )
    lengths_dev = jnp.asarray(reads.lengths.astype(np.int32))
    if packed:
        # separate dispatches, not one merged jit: the emit size comes
        # from the nnz readback. Reliable rows are compacted to a pow2-bucket prefix first so the
        # emit/sort/scan stages run on ~nnz rows, not all k-mer positions.
        # The compaction sort dispatches BEFORE the nnz readback blocks,
        # so the sort and the readback overlap; dropping the
        # full-stream references lets the backend free ~14 bytes/position
        # of device memory before the emit/chain stages allocate.
        comp = _compact_sort(live, sr, sp, sc, rank, cnt)
        del live, sr, sp, sc, rank, cnt
        hkey = _hints_key(reads, config)
        hints = _hints_load(hkey) if _use_hints else None
        if hints is not None:
            # speculative sizes: dispatch everything, verify at the end
            narr = hints["narr"]
        else:
            narr = np.asarray(nnzs)  # readback: nnz + per-lag prefix rows
        n = int(narr[0])
        if n == 0 and hints is None:
            return CandidatePairs.empty(), int(num_kmers), 0
        # _size_bucket (<=12.5% padding) instead of pow2 (up to 2x): the
        # emit and chain stages run on (upper-1) * size rows, so compact
        # padding multiplies directly into the two big sorts
        size = min(_size_bucket(max(n, 1 << 14)), int(comp[0].shape[0]))
        # per-lag emission prefixes: lag d streams only the segments
        # that can pair at lag d — 3-4x fewer emitted rows into the
        # chain sort on long-read error k-mer distributions
        lag_sizes = _lag_sizes(narr, size, config.upper_freq)
        emit_kw = dict(
            kmer_size=k, upper=config.upper_freq, bin_size=config.bin_size,
            lag_sizes=tuple(lag_sizes),
        )
        csr, csp, csc, crank = _compact_slice(*comp, size=size)
        del comp
        hv, k3, pv, _n_cand = _fused_emit_packed(
            nnzs[0].astype(jnp.int32),
            csr, csp, csc, crank, lengths_dev, **emit_kw,
        )
        # the chain's scans cover only the live prefix of the sorted
        # stream — the full-stream materialisation is the memory hog at
        # 100M+-row streams, and shorter scans are faster everywhere;
        # the deferred live-count sync overlaps the sort dispatch
        hint_out: dict = {}
        if hints is not None:
            finish_hint = dict(
                nseed=int(hints["nseed"]),
                stats_pre=(nnzs, _n_cand),
            )
            live_rows = int(hints["n_cand"])
        else:
            finish_hint = None
            nc_memo: dict = {}

            def live_rows():
                nc_memo["v"] = int(_n_cand)
                return nc_memo["v"]
        pairs = _chain_packed(
            hv, k3, pv, lengths_dev, kmer_size=k,
            bin_size=config.bin_size, live_rows=live_rows,
            lengths_np=reads.lengths, hint=finish_hint, hint_out=hint_out,
        )
        del hv, k3, pv, csr, csp, csc, crank
        if hints is not None:
            ok, n_act, nseed_act = _verify_hints(
                hkey, hints, hint_out, int(nnzs.shape[0]), size,
                lag_sizes, config.upper_freq,
            )
            if not ok:
                log("sizeHintsMiss",
                    "speculative sizes underestimated; re-running exact")
                return detect_overlaps(reads, config, _use_hints=False)
            return pairs.take_prefix(nseed_act), int(num_kmers), n_act
        _hints_store(
            hkey, narr, nc_memo.get("v", 0),
            int(hint_out.get("nseed", pairs.num_pairs)),
        )
        return pairs, int(num_kmers), n
    else:
        nnz = nnzs[0]
        h, v, bin_id, pos_h, pos_v, flip, ov = _fused_emit(
            live, sr, sp, sc, rank, lengths_dev,
            kmer_size=k,
            upper=config.upper_freq,
            bin_size=config.bin_size,
        )
        out = _chain_stage32(h, v, bin_id, pos_h, pos_v, flip, ov, kmer_size=k)
    pairs = _compact(out)
    return pairs, int(num_kmers), int(nnz)


@jax.jit
def _rank_from_ids(kmer_ids):
    """Within-segment rank for a kmer-id-major triple stream (device)."""
    kb = seg.boundaries(kmer_ids)
    ones = jnp.ones_like(kmer_ids, dtype=jnp.int32)
    return seg.seg_cumsum(ones, kb) - 1


def generate_candidates(
    triples: ReliableTriples, read_lengths: np.ndarray, config: BellaConfig
) -> CandidatePairs:
    """Host driver over a prebuilt reliable-triples matrix (the
    minimizer/syncmer/split-count/checkpoint path). Uses the packed
    uint32 emit+chain stages when ids/positions fit 16 bits, else the
    u64 path; k-mer-range staging with host spill beyond the budget."""
    if triples.nnz == 0:
        return CandidatePairs.empty()
    lengths = jnp.asarray(np.asarray(read_lengths, dtype=np.int32))
    n_reads = len(read_lengths)
    max_len = int(np.asarray(read_lengths).max()) if n_reads else 0
    packed = (
        n_reads <= 0xFFFF and max_len <= 0xFFFF and config.bin_size >= 3
        and config.upper_freq <= 255
        and triples.nnz * 100 <= config.effective_memory_mb * 1e6
    )
    if packed:
        n = triples.nnz
        size = 1 << max(14, (n - 1).bit_length())
        kid = _pad_to_bucket(triples.kmer_ids, size, -1)
        rank = _rank_from_ids(jnp.asarray(kid))
        hv, k3, pv, n_cand = _fused_emit_packed(
            jnp.int32(n),
            jnp.asarray(_pad_to_bucket(triples.read_ids, size, 0)),
            jnp.asarray(_pad_to_bucket(triples.positions, size, 0)),
            jnp.asarray(_pad_to_bucket(triples.is_rc, size, False)),
            rank,
            lengths,
            kmer_size=config.kmer_size,
            upper=config.upper_freq,
            bin_size=config.bin_size,
        )
        return _chain_packed(
            hv, k3, pv, lengths,
            kmer_size=config.kmer_size, bin_size=config.bin_size,
            live_rows=lambda: int(n_cand),
            lengths_np=read_lengths,
        )
    wide = (
        not packed and n_reads < (1 << 31) - 1 and max_len <= 0xFFFF
        and config.bin_size >= 3 and config.upper_freq <= (1 << 15)
        and triples.nnz * 100 <= config.effective_memory_mb * 1e6
    )
    if wide:
        n = triples.nnz
        size = 1 << max(14, (n - 1).bit_length())
        kid = _pad_to_bucket(triples.kmer_ids, size, -1)
        rank = _rank_from_ids(jnp.asarray(kid))
        h, v, k3, pv, n_cand = _fused_emit_wide(
            jnp.int32(n),
            jnp.asarray(_pad_to_bucket(triples.read_ids, size, 0)),
            jnp.asarray(_pad_to_bucket(triples.positions, size, 0)),
            jnp.asarray(_pad_to_bucket(triples.is_rc, size, False)),
            rank,
            lengths,
            kmer_size=config.kmer_size,
            upper=config.upper_freq,
            bin_size=config.bin_size,
        )
        return _chain_wide(
            h, v, k3, pv, lengths,
            kmer_size=config.kmer_size, bin_size=config.bin_size,
            live_rows=lambda: int(n_cand),
            lengths_np=read_lengths,
        )
    expanded = triples.nnz * (config.upper_freq - 1)
    budget_rows = int(config.effective_memory_mb * 1e6 / _ROW_BYTES)
    if expanded <= budget_rows:
        out = _emit_and_chain(
            jnp.asarray(triples.kmer_ids),
            jnp.asarray(triples.read_ids),
            jnp.asarray(triples.positions),
            jnp.asarray(triples.is_rc),
            lengths,
            upper_freq=config.upper_freq,
            kmer_size=config.kmer_size,
            bin_size=config.bin_size,
        )
        return _compact(out)
    return _generate_candidates_staged(
        triples, lengths, config, budget_rows
    )


def _pad_to_bucket(a, size, fill):
    pad = size - a.shape[0]
    if pad <= 0:
        return a
    return np.concatenate([a, np.full(pad, fill, a.dtype)])


def _generate_candidates_staged(
    triples: ReliableTriples, lengths, config: BellaConfig, budget_rows: int
) -> CandidatePairs:
    """K-mer-range emission stages -> host spill -> global host sort ->
    pair-aligned chain chunks (include/overlap.hpp:682-786 reshaped)."""
    u1 = config.upper_freq - 1
    stage_nnz = max(budget_rows // u1, 1 << 14)
    # stage boundaries must not split a k-mer segment
    nnz = triples.nnz
    starts = [0]
    while starts[-1] + stage_nnz < nnz:
        cut = starts[-1] + stage_nnz
        kid = triples.kmer_ids[cut]
        while cut > starts[-1] and triples.kmer_ids[cut - 1] == kid:
            cut -= 1
        starts.append(cut if cut > starts[-1] else starts[-1] + stage_nnz)
    starts.append(nnz)
    num_stages = len(starts) - 1
    log("RequiredStages", num_stages)

    bucket = stage_nnz  # stable jit shape across stages
    spill = {f: [] for f in ("key", "pos_h", "pos_v", "flip", "ov")}
    for s in range(num_stages):
        lo, hi = starts[s], starts[s + 1]
        out = _emit_stage(
            jnp.asarray(_pad_to_bucket(triples.kmer_ids[lo:hi], bucket, -1)),
            jnp.asarray(_pad_to_bucket(triples.read_ids[lo:hi], bucket, 0)),
            jnp.asarray(_pad_to_bucket(triples.positions[lo:hi], bucket, 0)),
            jnp.asarray(_pad_to_bucket(triples.is_rc[lo:hi], bucket, False)),
            lengths,
            upper_freq=config.upper_freq,
            kmer_size=config.kmer_size,
            bin_size=config.bin_size,
        )
        key = np.asarray(out["key"])
        live = key != PAIR_SENTINEL
        for f in spill:
            spill[f].append(np.asarray(out[f])[live])

    key = np.concatenate(spill["key"])
    order = np.argsort(key, kind="stable")
    key = key[order]
    pos_h = np.concatenate(spill["pos_h"])[order]
    pos_v = np.concatenate(spill["pos_v"])[order]
    flip = np.concatenate(spill["flip"])[order]
    ov = np.concatenate(spill["ov"])[order]
    bin_id = (ov // config.bin_size).astype(np.int32)

    total = key.shape[0]
    chunk_rows = budget_rows // 2
    parts = []
    lo = 0
    while lo < total:
        hi = min(lo + chunk_rows, total)
        # don't split a pair across chunks
        while hi < total and key[hi] == key[hi - 1]:
            hi += 1
        size = hi - lo
        padded = ((size + (1 << 16) - 1) >> 16) << 16  # 64k buckets
        out = _chain_stage(
            jnp.asarray(_pad_to_bucket(key[lo:hi], padded, PAIR_SENTINEL)),
            jnp.asarray(_pad_to_bucket(bin_id[lo:hi], padded, 0)),
            jnp.asarray(_pad_to_bucket(pos_h[lo:hi], padded, 0)),
            jnp.asarray(_pad_to_bucket(pos_v[lo:hi], padded, 0)),
            jnp.asarray(_pad_to_bucket(flip[lo:hi], padded, False)),
            jnp.asarray(_pad_to_bucket(ov[lo:hi], padded, 0)),
            kmer_size=config.kmer_size,
        )
        parts.append(_compact(out))
        lo = hi
    return CandidatePairs.concatenate(parts)
