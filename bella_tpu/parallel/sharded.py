"""Multi-device overlap detection over a jax.sharding.Mesh.

The reference is shared-memory OpenMP only (SURVEY §2.3); this module is
the scale-out design its parallelism maps to on several devices:

  1. reads-partitioned ingest: each device holds a slice of the k-mer
     occurrence stream (the OpenMP byte-range FASTQ split, kmercode/
     fq_reader.c:314-331, becomes data parallelism over the mesh),
  2. k-mer-space sharding: occurrences are exchanged with all_to_all
     keyed by hash(kmer) mod n_devices, so each device owns complete
     k-mer segments (the --split-count partitioning,
     include/kmercount.hpp:478-534, becomes the shard axis),
  3. local count+filter+emit: the single-chip sort-based SpGEMM runs
     unchanged per shard (k-mer segments never straddle devices),
  4. pair-space resharding: candidate entries are exchanged again keyed
     by hash(pair) so chaining sees every occurrence of a pair on one
     device (replaces HashSpGEMM's shared-memory column ownership),
  5. alignment runs data-parallel over the resulting pair shards
     (the multi-GPU batch split of loganGPU/functions.cuh:441-443).

Collectives are jax.lax.all_to_all under shard_map. All local
buffers are fixed-capacity with sentinel padding; overflow is counted
and surfaced (no silent drops).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from bella_tpu.config import BellaConfig
from bella_tpu.kmers.count import SENTINEL, ReliableTriples
from bella_tpu.overlap.pairs import CandidatePairs, PAIR_SENTINEL
from bella_tpu.seq.encode import hash64
from bella_tpu.utils import segments as seg

_U64 = jnp.uint64
AXIS = "x"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def _route(keys, dest, payload, capacity: int):
    """Exchange rows to the device given by `dest` (values in [0, n);
    dest == n marks padding rows, which are discarded locally).

    Local gather-based bucketing (no scatters): sort rows by dest, pad
    each bucket to `capacity`, all_to_all the bucket axis. Returns
    (received payload tuple, received validity mask, overflow count).
    """
    n = jax.lax.axis_size(AXIS)
    m = dest.shape[0]
    # one multi-operand sort, not argsort+gathers
    sorted_all = jax.lax.sort((dest,) + tuple(payload), num_keys=1)
    dest_s = sorted_all[0]
    payload_s = sorted_all[1:]

    # bucket b occupies [starts[b], starts[b+1]) in the sorted order
    starts = jnp.searchsorted(dest_s, jnp.arange(n + 1, dtype=dest_s.dtype))
    bucket = jnp.arange(n, dtype=jnp.int32)[:, None]
    slot = jnp.arange(capacity, dtype=jnp.int32)[None, :]
    idx = starts[:-1][:, None] + slot                      # (n, capacity)
    valid = idx < starts[1:][:, None]
    overflow = jnp.maximum(starts[1:] - starts[:-1] - capacity, 0).sum()
    idx = jnp.clip(idx, 0, m - 1)

    out = []
    for a in payload_s:
        boxed = jnp.where(valid, a[idx], _pad_value(a))
        out.append(jax.lax.all_to_all(boxed, AXIS, 0, 0, tiled=False))
    valid_x = jax.lax.all_to_all(valid, AXIS, 0, 0, tiled=False)
    # received shape (n, capacity) -> flatten
    return tuple(a.reshape(-1) for a in out), valid_x.reshape(-1), overflow


def _pad_value(a):
    if a.dtype == jnp.uint64:
        return jnp.asarray(SENTINEL)
    if a.dtype == jnp.bool_:
        return False
    return jnp.zeros((), a.dtype)


def _local_emit(kmers, read_ids, positions, is_rc, read_lengths,
                cfg_static) -> Tuple:
    """Single-shard count+filter+emit+chain. Mirrors the single-chip
    kernel (overlap/pairs.py) on the local k-mer shard; kept separate so
    it runs inside shard_map with fixed shapes."""
    (k, lower, upper, bin_size) = cfg_static
    # sort by kmer so segments are contiguous: one multi-operand sort
    # with payloads riding along, not argsort+gathers
    sk, sr, sp, sc = jax.lax.sort(
        (kmers, read_ids, positions, is_rc), num_keys=1
    )

    kb = seg.boundaries(sk)
    ones = jnp.ones_like(sr, dtype=jnp.int32)
    counts = seg.seg_sum_bcast(ones, kb)
    reliable = (counts >= lower) & (counts <= upper) & (sk != jnp.asarray(SENTINEL))
    sk = jnp.where(reliable, sk, jnp.asarray(SENTINEL))
    rank = seg.seg_cumsum(ones, kb) - 1

    keys, phs, pvs, rchs, rcvs = [], [], [], [], []
    live = sk != jnp.asarray(SENTINEL)
    for d in range(1, upper):
        ra, rb = sr[d:], sr[:-d]
        pa, pb = sp[d:], sp[:-d]
        ca, cb = sc[d:], sc[:-d]
        ok = (rank[d:] >= d) & (ra != rb) & live[d:]
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

    h = (key >> _U64(32)).astype(jnp.int32)
    v = key.astype(jnp.int32)
    len_h = read_lengths[jnp.clip(h, 0, read_lengths.shape[0] - 1)]
    len_v = read_lengths[jnp.clip(v, 0, read_lengths.shape[0] - 1)]
    flip = rc_h != rc_v
    beg_h = jnp.where(flip, len_h - pos_h - k, pos_h)
    ov = (
        jnp.minimum(beg_h, pos_v)
        + jnp.minimum(len_h - (beg_h + k), len_v - (pos_v + k))
        + k
    ).astype(jnp.int32)
    return key, pos_h, pos_v, flip, ov


def _local_emit_packed(kmers, read_ids, positions, is_rc, read_lengths,
                       cfg_static) -> Tuple:
    """Packed-u32 shard emit (ids/positions fit 16 bits): the single-chip
    (hv, k3, pv) scheme of overlap/pairs.py:_fused_emit_packed, halving
    the pair-space all_to_all and chain-sort traffic vs the u64 rows."""
    (k, lower, upper, bin_size) = cfg_static
    u32 = jnp.uint32
    sk, sr, sp, sc = jax.lax.sort(
        (kmers, read_ids, positions, is_rc), num_keys=1
    )
    kb = seg.boundaries(sk)
    ones = jnp.ones_like(sr, dtype=jnp.int32)
    counts = seg.seg_sum_bcast(ones, kb)
    reliable = (counts >= lower) & (counts <= upper) & (sk != jnp.asarray(SENTINEL))
    rank = seg.seg_cumsum(ones, kb) - 1
    live = reliable

    hvs, k3s, pvs = [], [], []
    for d in range(1, upper):
        ra, rb = sr[d:], sr[:-d]
        pa, pb = sp[d:], sp[:-d]
        ca, cb = sc[d:], sc[:-d]
        ok = (rank[d:] >= d) & (ra != rb) & live[d:] & live[:-d]
        h_is_a = ra > rb
        h = jnp.where(h_is_a, ra, rb).astype(u32)
        v = jnp.where(h_is_a, rb, ra).astype(u32)
        pos_h = jnp.where(h_is_a, pa, pb).astype(jnp.int32)
        pos_v = jnp.where(h_is_a, pb, pa).astype(u32)
        flip = jnp.where(h_is_a, ca, cb) != jnp.where(h_is_a, cb, ca)

        len_h = read_lengths[
            jnp.clip(h.astype(jnp.int32), 0, read_lengths.shape[0] - 1)
        ]
        len_v = read_lengths[
            jnp.clip(v.astype(jnp.int32), 0, read_lengths.shape[0] - 1)
        ]
        beg_h = jnp.where(flip, len_h - pos_h - k, pos_h)
        ov = (
            jnp.minimum(beg_h, pos_v.astype(jnp.int32))
            + jnp.minimum(
                len_h - (beg_h + k), len_v - (pos_v.astype(jnp.int32) + k)
            )
            + k
        )
        bin_id = jnp.maximum(ov, 0).astype(u32) // u32(bin_size)
        hv = (h << u32(16)) | v
        k3 = (bin_id << u32(17)) | (pos_h.astype(u32) << u32(1)) | flip.astype(u32)
        hvs.append(jnp.where(ok, hv, u32(0xFFFFFFFF)))
        k3s.append(k3)
        pvs.append(pos_v)
    return jnp.concatenate(hvs), jnp.concatenate(k3s), jnp.concatenate(pvs)


def sharded_candidates(
    triples: ReliableTriples,
    read_lengths: np.ndarray,
    config: BellaConfig,
    mesh: Optional[Mesh] = None,
    cap_occ: int = 0,
    cap_pair: int = 0,
) -> CandidatePairs:
    """Multi-device candidate generation; result matches the single-chip
    generate_candidates (validated in tests on a CPU mesh)."""
    if mesh is None:
        mesh = make_mesh()
    n = mesh.devices.size
    if triples.nnz == 0:
        z = np.zeros(0, np.int32)
        return CandidatePairs(z, z, z, z, z, z, z, np.zeros(0, bool))

    # pad occurrence stream to a multiple of n
    m = triples.nnz
    m_pad = ((m + n - 1) // n) * n
    pad = m_pad - m

    def padded(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)]) if pad else a

    # device routing happens on raw canonical k-mers; rebuild them from
    # ids is impossible, so route on dense ids (same-segment => same id)
    kmers = padded(triples.kmer_ids.astype(np.int64), -1)
    reads = padded(triples.read_ids, 0)
    poss = padded(triples.positions, 0)
    rcs = padded(triples.is_rc, False)

    k = config.kmer_size
    upper = config.upper_freq
    bin_size = config.bin_size
    local = m_pad // n
    # balanced routing keys make per-bucket load ~ local/n; 2x slack +
    # floor for tiny inputs. Overflow triggers a doubled-capacity retry,
    # never a drop.
    if cap_occ <= 0:
        cap_occ = max(2 * local // n, 1024)
    if cap_pair <= 0:
        cap_pair = max(2 * local * (upper - 1) // n, 4096)

    max_len = int(np.asarray(read_lengths).max()) if len(read_lengths) else 0
    packed = (
        len(read_lengths) <= 0xFFFF and max_len <= 0xFFFF and bin_size >= 3
        and upper <= 255
    )
    if packed:
        # NEVER drop on a hot shard: retry with doubled capacities (the
        # reference stages instead of dropping, include/overlap.hpp:682)
        for _attempt in range(5):
            out = _sharded_candidates_packed(
                mesh, kmers, reads, poss, rcs, read_lengths,
                (k, 1, upper, bin_size), cap_occ, cap_pair,
            )
            if out is not None:
                return out
            cap_occ *= 2
            cap_pair *= 2
        raise RuntimeError("sharded routing still overflowing after retries")

    def run_u64(cap_occ, cap_pair):
        @jax.jit
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
            out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                       P(AXIS), P(AXIS), P(AXIS)),
            check_vma=False,
        )
        def step(kmer_ids, read_ids, positions, is_rc, rl):
            nloc = jax.lax.axis_size(AXIS)
            # ---- 2: reshard by k-mer ----
            dest = (kmer_ids % nloc).astype(jnp.int32)
            dest = jnp.where(kmer_ids < 0, nloc, dest)  # padding -> trash
            (kk, rr, pp, cc), valid, ovf1 = _route(
                kmer_ids, dest, (kmer_ids, read_ids, positions, is_rc), cap_occ
            )
            kk_u = jnp.where(valid & (kk >= 0), kk.astype(_U64), jnp.asarray(SENTINEL))

            # ---- 3: local emit (counting already done globally; reliable
            # filter re-applied locally is a no-op on dense ids) ----
            key, pos_h, pos_v, flip, ov = _local_emit(
                kk_u, rr, pp, cc, rl, (k, 1, upper, bin_size)
            )

            # ---- 4: reshard by pair ----
            pdest = (hash64(key) % _U64(nloc)).astype(jnp.int32)
            pdest = jnp.where(key == jnp.asarray(PAIR_SENTINEL), nloc, pdest)
            (key2, ph2, pv2, fl2, ov2), pvalid, ovf2 = _route(
                key, pdest, (key, pos_h, pos_v, flip, ov), cap_pair
            )
            key2 = jnp.where(pvalid, key2, jnp.asarray(PAIR_SENTINEL))

            # ---- chain locally ----
            bin_id = (ov2 // bin_size).astype(jnp.int32)
            key2, bin_id, ph2, pv2, fl2, ov2 = jax.lax.sort(
                (key2, bin_id, ph2, pv2, fl2, ov2), num_keys=3
            )
            live = key2 != jnp.asarray(PAIR_SENTINEL)
            pair_b = seg.boundaries(key2)
            bin_b = seg.boundaries2(key2, bin_id)
            bucket = ph2 // (k + 1)
            prev_bucket = jnp.concatenate([bucket[:1], bucket[:-1]])
            dup = (~bin_b) & (bucket == prev_bucket)
            kept = (~dup) & live
            support = seg.seg_sum_bcast(kept.astype(jnp.int32), bin_b)
            count = seg.seg_sum_bcast(live.astype(jnp.int32), pair_b)
            binidx = seg.seg_cumsum(bin_b.astype(jnp.int32), pair_b)
            score = support.astype(jnp.int64) * (1 << 31) + ((1 << 31) - binidx)
            best = seg.seg_max_bcast(score, pair_b)
            seed_mask = (score == best) & bin_b & live

            return (seed_mask, key2, ph2, pv2, count, support, ov2, fl2,
                    (ovf1 + ovf2)[None])

        return step(
            jnp.asarray(kmers), jnp.asarray(reads), jnp.asarray(poss),
            jnp.asarray(rcs), jnp.asarray(read_lengths.astype(np.int32)),
        )

    for _attempt in range(5):
        out = run_u64(cap_occ, cap_pair)
        seed_mask, key2, ph2, pv2, count, support, ov2, fl2, ovf = out
        overflow = int(np.asarray(ovf).sum())
        if overflow == 0:
            break
        from bella_tpu.utils.log import log

        # NEVER drop: double the capacities and redo the exchange
        log("routingOverflowRetry", f"{overflow} rows, doubling capacities")
        cap_occ *= 2
        cap_pair *= 2
    else:
        raise RuntimeError("sharded routing still overflowing after retries")
    mask = np.asarray(seed_mask)
    key_np = np.asarray(key2)[mask]
    return CandidatePairs(
        read_h=(key_np >> np.uint64(32)).astype(np.int32),
        read_v=(key_np & np.uint64(0xFFFFFFFF)).astype(np.int32),
        pos_h=np.asarray(ph2)[mask],
        pos_v=np.asarray(pv2)[mask],
        count=np.asarray(count)[mask],
        matches=np.asarray(support)[mask],
        overlap_est=np.asarray(ov2)[mask],
        seed_rc=np.asarray(fl2)[mask],
    )


def _sharded_candidates_packed(
    mesh, kmers, reads, poss, rcs, read_lengths, cfg_static,
    cap_occ: int, cap_pair: int,
) -> CandidatePairs:
    """Packed-u32 multi-device path (ids/positions fit 16 bits): k-mer
    and pair resharding as in the u64 step, but pair rows travel as the
    (hv, k3, pv) triple and the chain reuses the single-chip live-prefix
    scans."""
    from bella_tpu.overlap.pairs import _chain_scans_packed

    (k, lower, upper, bin_size) = cfg_static
    u32 = jnp.uint32

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                   P(AXIS), P(AXIS)),
        check_vma=False,
    )
    def step(kmer_ids, read_ids, positions, is_rc, rl):
        nloc = jax.lax.axis_size(AXIS)
        # ---- reshard by k-mer ----
        dest = (kmer_ids % nloc).astype(jnp.int32)
        dest = jnp.where(kmer_ids < 0, nloc, dest)
        (kk, rr, pp, cc), valid, ovf1 = _route(
            kmer_ids, dest, (kmer_ids, read_ids, positions, is_rc), cap_occ
        )
        kk_u = jnp.where(
            valid & (kk >= 0), kk.astype(_U64), jnp.asarray(SENTINEL)
        )

        # ---- local count + packed emit ----
        hv, k3, pv = _local_emit_packed(
            kk_u, rr, pp, cc, rl, (k, lower, upper, bin_size)
        )

        # ---- reshard by pair (u32 keys, half the row bytes) ----
        pdest = (hash64(hv.astype(_U64)) % _U64(nloc)).astype(jnp.int32)
        pdest = jnp.where(hv == u32(0xFFFFFFFF), nloc, pdest)
        (hv2, k32, pv2), pvalid, ovf2 = _route(
            hv, pdest, (hv, k3, pv), cap_pair
        )
        hv2 = jnp.where(pvalid, hv2, u32(0xFFFFFFFF))

        # ---- chain locally (single-chip scans over the sorted rows) ----
        hv2, k32, pv2 = jax.lax.sort((hv2, k32, pv2), num_keys=3)
        out = _chain_scans_packed(
            hv2, k32, pv2, rl, kmer_size=k, bin_size=bin_size
        )
        return (
            out["seed_mask"], out["hv"], out["cm"], out["pos_h"],
            out["pos_v"], out["overlap_est"], out["seed_rc"],
            (ovf1 + ovf2)[None],
        )

    out = step(
        jnp.asarray(kmers), jnp.asarray(reads), jnp.asarray(poss),
        jnp.asarray(rcs), jnp.asarray(read_lengths.astype(np.int32)),
    )
    seed_mask, hv, cm, ph, pv, ov, rc, ovf = out
    overflow = int(np.asarray(ovf).sum())
    if overflow:
        from bella_tpu.utils.log import log

        log("routingOverflowRetry", f"{overflow} rows, doubling capacities")
        return None  # caller doubles the capacities and retries
    mask = np.asarray(seed_mask)
    hv_np = np.asarray(hv)[mask].astype(np.uint32)
    cm_np = np.asarray(cm)[mask].astype(np.uint32)
    return CandidatePairs(
        read_h=(hv_np >> 16).astype(np.int32),
        read_v=(hv_np & 0xFFFF).astype(np.int32),
        pos_h=np.asarray(ph)[mask],
        pos_v=np.asarray(pv)[mask],
        count=(cm_np >> 16).astype(np.int32),
        matches=(cm_np & 0xFFFF).astype(np.int32),
        overlap_est=np.asarray(ov)[mask],
        seed_rc=np.asarray(rc)[mask],
    )
