"""Distributed overlap detection from RAW reads over a device mesh.

This is the product multi-device path (CLI --devices N): unlike
`sharded_candidates` (which reshards a prebuilt global triples matrix),
counting itself is distributed — no stage ever sees the global k-mer
stream:

  1. reads-partitioned ingest: the host splits the 2-bit code stream at
     read boundaries into one chunk per device (the OpenMP byte-range
     FASTQ split, kmercode/fq_reader.c:314-331, as data parallelism),
  2. each device extracts its chunk's canonical k-mer occurrences with
     the 4-phase packed extractor (kmercode/Kmer.cpp:232-298 reborn),
  3. occurrences are exchanged with all_to_all keyed by
     hash64(kmer) % n, so every k-mer's occurrences land on one device
     (the --split-count partitioning, include/kmercount.hpp:478-534,
     becomes the mesh axis),
  4. LOCAL sort + exact count + reliable filter (the counting itself is
     distributed; replaces libcuckoo/libbloom, include/kmercount.hpp),
  5. local packed pair emission (lag pairing over whole k-mer segments),
  6. pair-space all_to_all keyed by hash(pair) so chaining sees every
     shared k-mer of a pair on one device,
  7. local chain scans -> one seed per pair.

Capacity overflow is NEVER dropped: the step reports per-device
overflow counters and the host retries the whole exchange with doubled
capacities (the reference drops nothing either — it stages instead,
include/overlap.hpp:682-786).

Collectives are jax.lax.all_to_all under shard_map (NCCL over NVLink
between GPUs); on
multi-host deployments initialize jax.distributed first (see
bella_tpu.parallel.init_distributed).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bella_tpu.config import BellaConfig
from bella_tpu.overlap.pairs import (
    CandidatePairs,
    _chain_scans_packed,
    _chain_scans_wide,
    _extract_kmers_phased,
    _size_bucket,
)
from bella_tpu.parallel.sharded import AXIS, _route, make_mesh
from bella_tpu.seq.encode import hash64
from bella_tpu.utils import segments as seg
from bella_tpu.utils.log import log

_U64 = jnp.uint64


def _shard_reads(reads, n: int):
    """Host-side reads-partitioned split: n chunks at read boundaries,
    each padded to one common bucketed span `cb` with a phantom read
    (whose occurrences are masked out on device). Returns stacked
    per-device arrays ready for shard_map consumption."""
    R = reads.num_reads
    offsets = reads.offsets.astype(np.int64)
    total = int(offsets[-1])

    # chunk boundaries: read boundary nearest i * total / n
    bounds = [0]
    for i in range(1, n):
        target = i * total // n
        r = int(np.searchsorted(offsets, target))
        r = min(max(r, bounds[-1]), R)
        bounds.append(r)
    bounds.append(R)

    spans = [int(offsets[bounds[i + 1]] - offsets[bounds[i]]) for i in range(n)]
    max_reads = max(bounds[i + 1] - bounds[i] for i in range(n))
    cb = _size_bucket(max(max(spans), 8))
    cb = ((cb + 3) // 4) * 4
    r_cap = max_reads + 1  # + phantom

    codes_b = np.zeros((n, cb // 4 + 8), np.uint8)
    lengths = np.zeros((n, r_cap), np.int32)
    offs = np.zeros((n, r_cap + 1), np.int32)
    n_real = np.zeros((n,), np.int32)
    rid_base = np.zeros((n,), np.uint32)

    for i in range(n):
        lo, hi = bounds[i], bounds[i + 1]
        span = spans[i]
        chunk = np.zeros(cb, reads.codes.dtype)
        chunk[:span] = reads.codes[int(offsets[lo]):int(offsets[hi])]
        c4 = chunk.reshape(-1, 4).astype(np.uint8)
        codes_b[i, : cb // 4] = (
            c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4) | (c4[:, 3] << 6)
        )
        nr = hi - lo
        lengths[i, :nr] = reads.lengths[lo:hi]
        lengths[i, nr] = cb - span  # phantom read fills the pad
        o = (offsets[lo:hi + 1] - offsets[lo]).astype(np.int32)
        offs[i, : nr + 1] = o
        offs[i, nr + 1 :] = np.int32(cb)  # phantom end + zero-len pads
        n_real[i] = nr
        rid_base[i] = lo
    return codes_b, lengths, offs, n_real, rid_base, cb


def _emit_packed_local(ridpos, sc, read_lengths, live, rank,
                       kmer_size: int, upper: int, bin_size: int):
    """Packed pair emission over the in-shard compacted reliable prefix
    (k-mer-sorted, whole segments): the _fused_emit_packed lag pairing,
    gated on the live-prefix mask."""
    k = kmer_size
    u32 = jnp.uint32
    sr = (ridpos >> u32(16)).astype(jnp.int32)
    sp = (ridpos & u32(0xFFFF)).astype(jnp.int32)
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

        len_h = read_lengths[jnp.clip(h.astype(jnp.int32), 0, read_lengths.shape[0] - 1)]
        len_v = read_lengths[jnp.clip(v.astype(jnp.int32), 0, read_lengths.shape[0] - 1)]
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
    return jnp.concatenate(hvs), jnp.concatenate(k3s), jnp.concatenate(pvs)


def _emit_wide_local(rid, possc, read_lengths, live, rank,
                     kmer_size: int, upper: int, bin_size: int):
    """Wide-id pair emission over the in-shard compacted reliable prefix:
    candidate rows (h, v, k3, pv) with h and v as separate u32 operands
    (the _fused_emit_wide layout, live-prefix gated)."""
    k = kmer_size
    u32 = jnp.uint32
    sr = rid.astype(jnp.int32)
    sp = (possc >> u32(1)).astype(jnp.int32)
    sc = (possc & u32(1)) != u32(0)
    hs, vs, k3s, pvs = [], [], [], []
    for d in range(1, upper):
        ra, rb = sr[d:], sr[:-d]
        pa, pb = sp[d:], sp[:-d]
        ca, cb = sc[d:], sc[:-d]
        ok = (rank[d:] >= d) & (ra != rb) & live[d:] & live[:-d]
        h_is_a = ra > rb
        h = jnp.where(h_is_a, ra, rb)
        v = jnp.where(h_is_a, rb, ra)
        pos_h = jnp.where(h_is_a, pa, pb).astype(jnp.int32)
        pos_v = jnp.where(h_is_a, pb, pa).astype(u32)
        flip = jnp.where(h_is_a, ca, cb) != jnp.where(h_is_a, cb, ca)

        len_h = read_lengths[jnp.clip(h, 0, read_lengths.shape[0] - 1)]
        len_v = read_lengths[jnp.clip(v, 0, read_lengths.shape[0] - 1)]
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
    return (jnp.concatenate(hs), jnp.concatenate(vs),
            jnp.concatenate(k3s), jnp.concatenate(pvs))


def detect_overlaps_sharded(
    reads, config: BellaConfig, mesh: Optional[Mesh] = None,
    cap_occ: int = 0, force_wide: bool = False,
) -> Tuple[CandidatePairs, int, int]:
    """Multi-device end-to-end overlap detection (counting included);
    result matches the single-chip detect_overlaps exactly (validated on
    a CPU mesh in tests). Requires the packed row format: ids and
    positions <= 16 bits, upper_freq <= 255, bin_size >= 3, k <= 28,
    plain k-mers (the single-chip path covers the rest)."""
    if mesh is None:
        mesh = make_mesh()
    n = int(mesh.devices.size)
    k = config.kmer_size
    max_len = int(reads.lengths.max()) if reads.num_reads else 0
    common = (
        max_len <= 0xFFFF and config.bin_size >= 3
        and not config.use_hopc and k <= 28 and reads.num_reads > n
    )
    p16 = reads.num_reads <= 0xFFFF and config.upper_freq <= 255
    wide_ok = (
        reads.num_reads < (1 << 31) - 1 and config.upper_freq <= (1 << 15)
    )
    if not (common and (p16 or wide_ok)):
        raise ValueError(
            "distributed detection requires read length <= 65535, "
            "bin_size >= 3, plain k-mers, k <= 28, upper_freq <= 2^15, "
            "and more reads than devices"
        )
    wide = force_wide or not p16

    codes_b, lengths, offs, n_real, rid_base, cb = _shard_reads(reads, n)
    m_loc = cb  # k-mer positions per device (incl. masked tail)
    upper = config.upper_freq

    if cap_occ <= 0:
        cap_occ = max(2 * m_loc // n, 4096)
    rl = reads.lengths.astype(np.int32)

    # Multi-host (jax.distributed) support: every process computes the
    # same host-side split from the same reads, so global arrays are
    # built by device_put-ing the full numpy block against the global
    # sharding (each process transfers only its addressable shards);
    # device->host reads go through process_allgather. Single-process
    # keeps the zero-copy jnp.asarray path.
    multi = jax.process_count() > 1
    if multi:
        from jax.experimental import multihost_utils

        shard = NamedSharding(mesh, P(AXIS))
        repl = NamedSharding(mesh, P())

        def _put_b(a):
            return jax.device_put(np.asarray(a), shard)

        def _put_r(a):
            return jax.device_put(np.asarray(a), repl)

        def _host(x):
            return multihost_utils.process_allgather(x, tiled=True)
    else:
        _put_b = _put_r = jnp.asarray

        def _host(x):
            return jax.tree_util.tree_map(np.asarray, x)

    for attempt in range(5):
        # in-shard reliable prefix capacity: the received occurrence
        # stream (n * cap_occ rows) is mostly routing pad + unreliable
        # rows; compacting reliable segments to a half-size prefix
        # before emission halves the emit stream, the pair exchange,
        # and the chain sort (overflow retries double it with cap_occ)
        cap_rel = min(max(n * cap_occ // 2, 8192), n * cap_occ)
        cap_pair = max(2 * (upper - 1) * cap_rel // n, 8192)
        out = _dist_step(
            mesh, _put_b(codes_b), _put_b(lengths),
            _put_b(offs), _put_b(n_real), _put_b(rid_base),
            _put_r(rl),
            kmer_size=k, lower=config.lower_freq, upper=upper,
            bin_size=config.bin_size, cap_occ=cap_occ, cap_rel=cap_rel,
            cap_pair=cap_pair, wide=wide,
        )
        ovf = out[-1]
        overflow = int(np.asarray(_host(ovf)).sum())
        if overflow == 0:
            break
        # NEVER drop: retry the exchange with doubled capacities (the
        # reference stages instead of dropping, include/overlap.hpp:682)
        log("routingOverflowRetry", f"{overflow} rows, doubling capacities")
        cap_occ *= 2
    else:
        raise RuntimeError("sharded routing still overflowing after retries")

    out = _host(out)  # one gather per array; numpy thereafter
    if wide:
        (seed_mask, rh, rv, cm, ph, pv, ov, rc, nnz_d, nk_d, ovf) = out
    else:
        (seed_mask, hv, cm, ph, pv, ov, rc, nnz_d, nk_d, ovf) = out
    num_kmers = int(np.asarray(nk_d).sum())
    nnz = int(np.asarray(nnz_d).sum())
    mask = np.asarray(seed_mask)
    cm_np = np.asarray(cm)[mask].astype(np.uint32)
    if wide:
        read_h = np.asarray(rh)[mask].astype(np.int32)
        read_v = np.asarray(rv)[mask].astype(np.int32)
    else:
        hv_np = np.asarray(hv)[mask].astype(np.uint32)
        read_h = (hv_np >> 16).astype(np.int32)
        read_v = (hv_np & 0xFFFF).astype(np.int32)
    pairs = CandidatePairs(
        read_h=read_h,
        read_v=read_v,
        pos_h=np.asarray(ph)[mask],
        pos_v=np.asarray(pv)[mask],
        count=(cm_np >> 16).astype(np.int32),
        matches=(cm_np & 0xFFFF).astype(np.int32),
        overlap_est=np.asarray(ov)[mask],
        seed_rc=np.asarray(rc)[mask],
    )
    return pairs, num_kmers, nnz


@partial(
    jax.jit,
    static_argnames=("kmer_size", "lower", "upper", "bin_size",
                     "cap_occ", "cap_rel", "cap_pair", "wide"),
    static_argnums=(0,),
)
def _dist_step(mesh, codes_b, lengths, offs, n_real, rid_base, rl,
               kmer_size: int, lower: int, upper: int, bin_size: int,
               cap_occ: int, cap_rel: int, cap_pair: int,
               wide: bool = False):
    u32 = jnp.uint32
    n_out = 8 if wide else 7

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS),) * n_out + (P(AXIS), P(AXIS), P(AXIS)),
        check_vma=False,
    )
    def step(codes_b, lengths, offs, n_real, rid_base, rl):
        nloc = jax.lax.axis_size(AXIS)
        # ---- 2: local extraction (4-phase packed) ----
        if wide:
            khi, klo, rid, sc, pos = _extract_kmers_phased(
                codes_b[0], lengths[0], offs[0], n_real[0],
                kmer_size=kmer_size, pack_ridpos=False,
            )
            a = rid.astype(u32) + rid_base[0].astype(u32)
            b = (pos.astype(u32) << u32(1)) | sc.astype(u32)
        else:
            khi, klo, ridpos, sc, _ = _extract_kmers_phased(
                codes_b[0], lengths[0], offs[0], n_real[0],
                kmer_size=kmer_size, pack_ridpos=True,
            )
            a = ridpos + (rid_base[0].astype(u32) << u32(16))
            b = sc

        # ---- 3: all_to_all by hash(kmer) ----
        canon = (khi.astype(_U64) << _U64(32)) | klo.astype(_U64)
        dead = (khi == u32(0xFFFFFFFF)) & (klo == u32(0xFFFFFFFF))
        dest = (hash64(canon) % _U64(nloc)).astype(jnp.int32)
        dest = jnp.where(dead, nloc, dest)
        (khi2, klo2, a2, b2), valid, ovf1 = _route(
            canon, dest, (khi, klo, a, b), cap_occ
        )
        khi2 = jnp.where(valid, khi2, u32(0xFFFFFFFF))
        klo2 = jnp.where(valid, klo2, u32(0xFFFFFFFF))

        # ---- 4: LOCAL counting (sort + segment reduce) ----
        khi2, klo2, a2, b2 = jax.lax.sort(
            (khi2, klo2, a2, b2), num_keys=2
        )
        kb = seg.boundaries2(khi2, klo2)
        ones = jnp.ones_like(khi2, dtype=jnp.int32)
        counts = seg.seg_sum_bcast(ones, kb)
        sent = (khi2 == u32(0xFFFFFFFF)) & (klo2 == u32(0xFFFFFFFF))
        reliable = (counts >= lower) & (counts <= upper) & (~sent)
        rank = seg.seg_cumsum(ones, kb) - 1
        nnz_loc = jnp.sum(reliable.astype(jnp.int32))
        nk_loc = jnp.sum((kb & reliable).astype(jnp.int32))

        # ---- 4b: in-shard reliable compaction ----
        # The received stream is mostly routing pad + unreliable rows;
        # a stable live-first sort moves reliable rows to a cap_rel
        # prefix so emission runs on half the rows. `reliable` is a
        # per-segment predicate (counts broadcast), so the prefix is
        # whole k-mer segments in order and lag pairing stays valid;
        # rank rides along. Live rows past cap_rel count as overflow
        # (the host retries with doubled capacities — never dropped).
        m_recv = khi2.shape[0]
        ckey = ((~reliable).astype(u32) << u32(31)) | jax.lax.iota(u32, m_recv)
        _, a3, b3, rank3 = jax.lax.sort(
            (ckey, a2, b2, rank.astype(u32)), num_keys=1
        )
        a3 = a3[:cap_rel]
        b3 = b3[:cap_rel]
        rank3 = rank3[:cap_rel].astype(jnp.int32)
        live3 = jax.lax.iota(jnp.int32, cap_rel) < nnz_loc
        ovf_rel = jnp.maximum(nnz_loc - jnp.int32(cap_rel), 0)

        counters = (nnz_loc[None], nk_loc[None])
        if wide:
            # ---- 5-7 wide: emit (h, v, k3, pv), pair-route, chain ----
            h, v, k3, pv = _emit_wide_local(
                a3, b3, rl, live3, rank3,
                kmer_size=kmer_size, upper=upper, bin_size=bin_size,
            )
            pkey = (h.astype(_U64) << _U64(32)) | v.astype(_U64)
            pdest = (hash64(pkey) % _U64(nloc)).astype(jnp.int32)
            pdest = jnp.where(h == u32(0xFFFFFFFF), nloc, pdest)
            (h2, v2, k32, pv2), pvalid, ovf2 = _route(
                h, pdest, (h, v, k3, pv), cap_pair
            )
            h2 = jnp.where(pvalid, h2, u32(0xFFFFFFFF))
            v2 = jnp.where(pvalid, v2, u32(0xFFFFFFFF))
            h2, v2, k32, pv2 = jax.lax.sort((h2, v2, k32, pv2), num_keys=4)
            out = _chain_scans_wide(
                h2, v2, k32, pv2, rl, kmer_size=kmer_size, bin_size=bin_size
            )
            return (
                out["seed_mask"], out["read_h"], out["read_v"], out["cm"],
                out["pos_h"], out["pos_v"], out["overlap_est"],
                out["seed_rc"],
            ) + counters + ((ovf1 + ovf2 + ovf_rel)[None],)

        # ---- 5: local packed emission ----
        hv, k3, pv = _emit_packed_local(
            a3, b3, rl, live3, rank3,
            kmer_size=kmer_size, upper=upper, bin_size=bin_size,
        )

        # ---- 6: all_to_all by hash(pair) ----
        pdest = (hash64(hv.astype(_U64)) % _U64(nloc)).astype(jnp.int32)
        pdest = jnp.where(hv == u32(0xFFFFFFFF), nloc, pdest)
        (hv2, k32, pv2), pvalid, ovf2 = _route(hv, pdest, (hv, k3, pv), cap_pair)
        hv2 = jnp.where(pvalid, hv2, u32(0xFFFFFFFF))

        # ---- 7: local chain ----
        hv2, k32, pv2 = jax.lax.sort((hv2, k32, pv2), num_keys=3)
        out = _chain_scans_packed(
            hv2, k32, pv2, rl, kmer_size=kmer_size, bin_size=bin_size
        )
        return (
            out["seed_mask"], out["hv"], out["cm"], out["pos_h"],
            out["pos_v"], out["overlap_est"], out["seed_rc"],
        ) + counters + ((ovf1 + ovf2 + ovf_rel)[None],)

    return step(codes_b, lengths, offs, n_real, rid_base, rl)


def init_distributed() -> None:
    """Multi-host runtime init: call before any jax computation when the
    job spans hosts (reference analogue: none — BELLA is single-node;
    SURVEY §5 distributed backend). No-op when the coordinator env vars
    are absent or initialization already happened.

    Config via env (the manual-cluster form; SLURM and other cluster
    environments are auto-detected by jax.distributed.initialize()):
      JAX_COORDINATOR_ADDRESS  host:port of process 0's coordinator
      JAX_NUM_PROCESSES        total process count
      JAX_PROCESS_ID           this process's rank
    On the CPU backend, cross-process collectives need the gloo
    implementation (set before backend init; validated by the
    2-process parity test, tests/test_multiprocess.py)."""
    import os

    coord = (
        os.environ.get("JAX_COORDINATOR_ADDRESS")
        or os.environ.get("COORDINATOR_ADDRESS")
    )
    if not coord:
        return
    kwargs = {}
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if (nproc is None) != (pid is None):
        raise RuntimeError(
            "manual-cluster init needs BOTH JAX_NUM_PROCESSES and "
            "JAX_PROCESS_ID (got only one); unset both for "
            "auto-detected clusters"
        )
    if nproc is not None:
        kwargs = dict(
            coordinator_address=coord,
            num_processes=int(nproc),
            process_id=int(pid),
        )
    # cross-process CPU collectives need gloo, and the flag must be set
    # BEFORE the backend initializes; it only affects the CPU client, so
    # setting it unconditionally is harmless on a GPU
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(**kwargs)
    log("jaxDistributed", f"process {jax.process_index()}/{jax.process_count()}")
