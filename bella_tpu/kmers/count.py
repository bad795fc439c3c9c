"""Sort-based exact k-mer counting and reliable-matrix construction.

Sort-based replacement for the reference counting stack
(include/kmercount.hpp: SplitCount/DeNovoCount/SimpleCount + libcuckoo +
libbloom + HyperLogLog). Rationale: on the device, a sort over
packed uint64 canonical k-mers followed by segment reductions is exact,
needs no HLL sizing, makes singleton elimination free, and fuses counting
with matrix construction — the reference's second FASTQ pass
(src/main.cpp:339-423) disappears because occurrence positions ride along
through the sort.

Memory is bounded the same way the reference bounds it: `split_count`
k-mer-space passes keyed by hash (include/kmercount.hpp:478-534), with
dense reliable ids accumulated across passes (:655-657).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bella_tpu.config import BellaConfig
from bella_tpu.io.fastq import ReadSet
from bella_tpu.seq.encode import canonical_kmers, hash64, hopc_kmers, pack_kmers

_U64 = jnp.uint64
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclasses.dataclass
class KmerOccurrences:
    """Flat occurrence stream: one row per (k-mer, read, position).

    kmers: (N,) uint64 canonical packed k-mers (SENTINEL for padding)
    read_ids: (N,) int32
    positions: (N,) int32 -- k-mer start within its read
    is_rc: (N,) bool -- canonical == revcomp of the forward k-mer at
        this position (drives strand logic downstream, chain.hpp:36-44)
    """

    kmers: jnp.ndarray
    read_ids: jnp.ndarray
    positions: jnp.ndarray
    is_rc: jnp.ndarray

    @property
    def size(self) -> int:
        return int(self.kmers.shape[0])


def extract_occurrences(reads: ReadSet, config: BellaConfig) -> KmerOccurrences:
    """All valid k-mer occurrences of a read set (k-mers spanning a read
    boundary in the concatenated layout are masked to SENTINEL)."""
    k = config.kmer_size
    codes = jnp.asarray(reads.codes)
    total = int(codes.shape[0])
    n = total - k + 1
    if n <= 0:
        z = jnp.zeros((0,), jnp.int32)
        return KmerOccurrences(jnp.zeros((0,), _U64), z, z, jnp.zeros((0,), bool))

    rid_per_base = np.repeat(
        np.arange(reads.num_reads, dtype=np.int32), reads.lengths
    )
    rid = jnp.asarray(rid_per_base[:n])
    rid_end = jnp.asarray(rid_per_base[k - 1 :])
    valid = rid == rid_end
    pos = jnp.arange(n, dtype=jnp.int32) - jnp.asarray(
        reads.offsets[:-1].astype(np.int32)
    )[rid]

    if config.use_hopc:
        # is_rc carries the true strand of the compressed window
        # (compression commutes with revcomp, see hopc_kmers)
        canon, _hopc_len, is_rc = hopc_kmers(codes, k)
    else:
        packed = pack_kmers(codes, k)
        canon, is_rc = canonical_kmers(packed, k)
    canon = jnp.where(valid, canon, jnp.asarray(SENTINEL))
    return KmerOccurrences(canon, rid, pos, is_rc & valid)


@dataclasses.dataclass
class ReliableTriples:
    """The reads-by-reliable-kmers matrix A in k-mer-major (CSC-of-A)
    order -- the layout pair generation consumes directly. Replaces the
    CSC build + transpose of src/main.cpp:476-491.

    All arrays sorted by (kmer_id); padding rows have kmer_id == -1.
    """

    kmer_ids: np.ndarray   # (M,) int32 dense reliable-kmer ids
    read_ids: np.ndarray   # (M,) int32
    positions: np.ndarray  # (M,) int32
    is_rc: np.ndarray      # (M,) bool
    num_kmers: int         # number of distinct reliable k-mers
    num_reads: int

    @property
    def nnz(self) -> int:
        return int(self.kmer_ids.shape[0])


@partial(jax.jit, static_argnames=("lower", "upper"))
def _count_and_filter(kmers, read_ids, positions, is_rc, lower: int, upper: int):
    """Sort occurrences by k-mer; mark occurrences of k-mers whose
    multiplicity lies in [lower, upper]; assign dense ids by segment.

    Returns (sorted fields..., counts, dense_id, reliable_mask, boundary).
    """
    from bella_tpu.utils import segments as seg

    # sort on split uint32 key halves with payloads riding along (no
    # argsort+gather)
    khi = (kmers >> _U64(32)).astype(jnp.uint32)
    klo = kmers.astype(jnp.uint32)
    khi, klo, sr, sp, sc = jax.lax.sort(
        (khi, klo, read_ids, positions, is_rc), num_keys=2
    )
    sk = (khi.astype(_U64) << _U64(32)) | klo.astype(_U64)
    boundary = seg.boundaries2(khi, klo)
    # gather-free int32 segment ops
    counts = seg.seg_sum_bcast(jnp.ones_like(sr, dtype=jnp.int32), boundary)

    reliable = (counts >= lower) & (counts <= upper) & (sk != jnp.asarray(SENTINEL))
    new_rel_seg = boundary & reliable
    dense_id = jnp.cumsum(new_rel_seg.astype(jnp.int32)) - 1
    return sk, sr, sp, sc, counts, dense_id, reliable, boundary


@partial(jax.jit, static_argnames=("size",))
def _gather_reliable(dense_id, sr, sp, sc, reliable, size: int):
    """Device-side compaction of reliable occurrences, so the host
    transfer is O(nnz), not O(total occurrences).

    Single-u32-key sort (dead bit | row index) + small-output takes:
    gather cost scales with the OUTPUT size, so taking `size` rows is
    cheap."""
    n = reliable.shape[0]
    key = (
        ((~reliable).astype(jnp.uint32) << jnp.uint32(31))
        | jax.lax.iota(jnp.uint32, n)
    )
    skey = jax.lax.sort(key)
    idx = (skey[:size] & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    return (
        jnp.take(dense_id, idx), jnp.take(sr, idx),
        jnp.take(sp, idx), jnp.take(sc, idx),
    )


def count_kmers(
    occ: KmerOccurrences, lower: int = 1, upper: int = 2**31 - 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Standalone exact counter: (unique_kmers, counts) with counts in
    [lower, upper]. API parity with the reference counters' observable
    output (the reliable dictionary's keyed multiplicities)."""
    if occ.size == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    sk, _, _, _, counts, _, reliable, boundary = _count_and_filter(
        occ.kmers, occ.read_ids, occ.positions, occ.is_rc, lower, upper
    )
    head = np.asarray(boundary & reliable)
    return np.asarray(sk)[head], np.asarray(counts)[head]


def build_reliable_triples(
    reads: ReadSet,
    config: BellaConfig,
    occ: Optional[KmerOccurrences] = None,
) -> ReliableTriples:
    """Fused counting + matrix build, with split-count staging.

    Each pass keeps k-mers with hash64(kmer) % split_count == pass
    (the k-mer-space partitioning of include/kmercount.hpp:478-534),
    counts them exactly, filters to [lower_freq, upper_freq], and emits
    triples with dense ids offset by the k-mers of earlier passes.
    """
    if occ is None:
        occ = extract_occurrences(reads, config)
    s = config.split_count
    parts = []
    id_base = 0
    for p in range(s):
        if s > 1:
            keep = (hash64(occ.kmers) % _U64(s)) == _U64(p)
            kmers = jnp.where(keep, occ.kmers, jnp.asarray(SENTINEL))
        else:
            kmers = occ.kmers
        sk, sr, sp, sc, _counts, dense_id, reliable, _b = _count_and_filter(
            kmers, occ.read_ids, occ.positions, occ.is_rc,
            config.lower_freq, config.upper_freq,
        )
        num = int(jnp.sum(reliable))
        if num == 0:
            continue
        size = min(1 << max(10, (num - 1).bit_length()), int(reliable.shape[0]))
        g_kid, g_sr, g_sp, g_sc = _gather_reliable(
            dense_id, sr, sp, sc, reliable, size
        )
        kid = np.asarray(g_kid)[:num].astype(np.int32) + id_base
        parts.append(
            (
                kid,
                np.asarray(g_sr)[:num],
                np.asarray(g_sp)[:num],
                np.asarray(g_sc)[:num],
            )
        )
        id_base += int(kid[-1]) + 1 - id_base if kid.size else 0
    kmer_ids = np.concatenate([p[0] for p in parts]) if parts else np.zeros(0, np.int32)
    read_ids = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0, np.int32)
    positions = np.concatenate([p[2] for p in parts]) if parts else np.zeros(0, np.int32)
    is_rc = np.concatenate([p[3] for p in parts]) if parts else np.zeros(0, bool)
    return ReliableTriples(
        kmer_ids, read_ids, positions, is_rc, id_base, reads.num_reads
    )


@jax.jit
def _multiplicity_stats_dev(khi, klo):
    """Exact distinct/mass counters of the canonical k-mer stream:
    (D_all, M_all, D_ge2, M_ge2) — distinct k-mers and total occurrence
    mass, overall and restricted to multiplicity >= 2. One 2xu32-key
    sort + segmented scans; a 4-scalar readback."""
    from bella_tpu.utils import segments as seg

    khi, klo = jax.lax.sort((khi, klo), num_keys=2)
    live = (khi != jnp.uint32(0xFFFFFFFF)) | (klo != jnp.uint32(0xFFFFFFFF))
    b = seg.boundaries2(khi, klo)
    counts = seg.seg_sum_bcast(jnp.ones_like(khi, jnp.int32), b)
    head = b & live
    ge2 = head & (counts >= 2)
    return jnp.stack([
        jnp.sum(head.astype(jnp.int64)),
        jnp.sum(jnp.where(head, counts, 0).astype(jnp.int64)),
        jnp.sum(ge2.astype(jnp.int64)),
        jnp.sum(jnp.where(ge2, counts, 0).astype(jnp.int64)),
    ])


@partial(jax.jit, static_argnames=("mod",))
def _hash_slice_compact(khi, klo, mod: int):
    """Keep k-mers whose hash lands in slice 0 of `mod` (a 1/mod sample
    of k-mer SPACE — every kept k-mer keeps its FULL multiplicity, so
    per-k-mer statistics of the slice are unbiased, unlike read
    subsampling which scales depth down). Kept rows compact to a
    prefix via the standard dead-bit single-key sort."""
    kk = (khi.astype(_U64) << _U64(32)) | klo.astype(_U64)
    keep = (hash64(kk) % _U64(mod)) == _U64(0)
    keep &= kk != jnp.asarray(SENTINEL)
    n = khi.shape[0]
    key = (
        ((~keep).astype(jnp.uint32) << jnp.uint32(31))
        | jax.lax.iota(jnp.uint32, n)
    )
    _, khi2, klo2 = jax.lax.sort((key, khi, klo), num_keys=1)
    return khi2, klo2, jnp.sum(keep.astype(jnp.int32))


def multiplicity_stats(reads: ReadSet, config: BellaConfig,
                       max_rows: int = 32 << 20):
    """(distinct, mass, distinct_ge2, mass_ge2) over the corpus's
    canonical k-mers — the exact global statistics the reference can
    only approximate with its HyperLogLog sketch
    (kmercode/hyperloglog.hpp:49-108, used include/kmercount.hpp:269,483
    to size the Bloom filter): sort-based exact counting makes the true
    numbers one sort away, so all sketch-driven sizing here is exact.

    Corpora whose occurrence stream exceeds `max_rows` are measured on
    a hash-slice of k-mer space instead (chunked extraction; kept
    k-mers carry their full multiplicities, so ratios like the
    truncated mean are unbiased); returned counters are scaled back by
    the slice factor. Memory stays O(max_rows) at any corpus size."""
    total = len(reads.codes)
    if total <= max_rows:
        occ = extract_occurrences(reads, config)
        if occ.size == 0:
            return 0, 0, 0, 0
        khi = (occ.kmers >> _U64(32)).astype(jnp.uint32)
        klo = occ.kmers.astype(jnp.uint32)
        s = np.asarray(_multiplicity_stats_dev(khi, klo))
        return int(s[0]), int(s[1]), int(s[2]), int(s[3])

    mod = -(-total // (max_rows // 2))
    offsets = reads.offsets.astype(np.int64)
    R = reads.num_reads
    kept_hi, kept_lo = [], []
    lo = 0
    while lo < R:
        hi = lo + 1
        while hi < R and offsets[hi + 1] - offsets[lo] <= max_rows // 2:
            hi += 1
        sub = ReadSet(
            [""] * (hi - lo),
            reads.codes[int(offsets[lo]):int(offsets[hi])],
            (offsets[lo:hi + 1] - offsets[lo]),
        )
        occ = extract_occurrences(sub, config)
        if occ.size:
            khi = (occ.kmers >> _U64(32)).astype(jnp.uint32)
            klo = occ.kmers.astype(jnp.uint32)
            khi2, klo2, n = _hash_slice_compact(khi, klo, mod)
            n_i = int(n)
            if n_i:
                # bucketed device slice (stable compile shapes), host trim
                b = min(1 << max(12, (n_i - 1).bit_length()), khi2.shape[0])
                kept_hi.append(np.asarray(khi2[:b])[:n_i])
                kept_lo.append(np.asarray(klo2[:b])[:n_i])
        lo = hi
    if not kept_hi:
        return 0, 0, 0, 0
    s = np.asarray(_multiplicity_stats_dev(
        jnp.asarray(np.concatenate(kept_hi)),
        jnp.asarray(np.concatenate(kept_lo)),
    ))
    return (
        int(s[0]) * mod, int(s[1]) * mod,
        int(s[2]) * mod, int(s[3]) * mod,
    )
