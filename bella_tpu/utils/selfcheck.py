"""Runtime self-check: cross-validate the compiled device pipeline
against independent host oracles (``--selfcheck``).

Reference role: the consistency / sanitizer escape hatches of the
reference build (makefile-nersc:17-23,70 — the commented ASAN wiring
and the ``-D__LIBCUCKOO_SERIAL`` serial mode used to rule out
concurrency bugs). On a jit/XLA stack the failure modes differ —
miscompiled programs, transfer corruption, kernel bugs — so this
analogue recomputes key invariants on the host in
plain numpy (a code path sharing nothing with the jitted programs'
bit tricks) and compares:

  * detection: an exact canonical k-mer recount — the distinct
    reliable k-mer count and the reliable occurrence row count must
    match the device's ``numReliableKmers`` / ``nnzA`` exactly;
  * candidate seeds: a sampled batch of emitted pairs — the canonical
    k-mer at (read_h, pos_h) must equal the one at (read_v, pos_v)
    (every seed is a shared reliable k-mer occurrence,
    include/overlap.hpp:282-363's inner product semantics);
  * alignment: the last batch (the widest length tier) re-run through
    the plain-JAX reference extend_batch, which must agree exactly
    (align/xdrop.py align_candidates), enabled under ``--selfcheck``.

Cost: the recount is O(corpus) host work (numpy unique = host sort),
so the switch is a debug/commissioning mode, not a production default
— exactly like running the reference under ASAN.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from bella_tpu.utils.log import log


class SelfCheckError(AssertionError):
    """A device result diverged from its host oracle."""


def _window_views(codes: np.ndarray, k: int) -> np.ndarray:
    """(n, k) uint8 sliding windows over the concatenated code stream
    (a strided view — no copy)."""
    return np.lib.stride_tricks.sliding_window_view(codes, k)


def _pack_fwd_np(win: np.ndarray) -> np.ndarray:
    """Pack (n, k) 2-bit code windows into uint64, first base most
    significant — plain shift/or loop, independent of the device's
    fori_loop / phased extractors."""
    n, k = win.shape
    val = np.zeros(n, np.uint64)
    for i in range(k):
        val = (val << np.uint64(2)) | win[:, i].astype(np.uint64)
    return val


def _canonical_np(win: np.ndarray) -> np.ndarray:
    """Canonical (min of forward, reverse-complement) packed k-mers of
    (n, k) code windows. The twin is packed from the reversed
    complemented window directly — no _bitrev2 bit trick shared with
    the device path."""
    fwd = _pack_fwd_np(win)
    rc = _pack_fwd_np((3 - win)[:, ::-1])
    return np.minimum(fwd, rc)


def _hopc_canonical_np(win: np.ndarray) -> np.ndarray:
    """Homopolymer-compressed canonical k-mers of (n, k) code windows
    (role of hopc_kmers): compress runs, pack at the compressed length,
    take min with the compressed reverse complement. Compression
    commutes with revcomp, so compressing the reversed complement
    window independently reproduces the twin."""

    def compress_pack(w):
        n, k = w.shape
        val = np.zeros(n, np.uint64)
        prev = np.full(n, 255, np.uint64)
        for i in range(k):
            cur = w[:, i].astype(np.uint64)
            keep = cur != prev
            val = np.where(keep, (val << np.uint64(2)) | cur, val)
            prev = cur
        return val

    fwd = compress_pack(win)
    rc = compress_pack((3 - win)[:, ::-1])
    return np.minimum(fwd, rc)


def host_reliable_stats(reads, config) -> Tuple[int, int]:
    """Host-oracle (num_reliable_kmers, nnz) for the plain/HOPC k-mer
    paths: exact canonical recount + [lower, upper] frequency filter.
    Matches the device counting semantics (counts segment on the
    canonical k-mer alone; strand never splits a segment,
    overlap/pairs.py _count_sorted)."""
    k = config.kmer_size
    codes = np.asarray(reads.codes, dtype=np.uint8)
    n = codes.shape[0] - k + 1
    if n <= 0 or reads.num_reads == 0:
        return 0, 0
    rid = np.repeat(np.arange(reads.num_reads, dtype=np.int64), reads.lengths)
    valid = rid[:n] == rid[k - 1:]
    win = _window_views(codes, k)[valid]
    canon = (
        _hopc_canonical_np(win) if config.use_hopc else _canonical_np(win)
    )
    _, counts = np.unique(canon, return_counts=True)
    rel = (counts >= config.lower_freq) & (counts <= config.upper_freq)
    return int(rel.sum()), int(counts[rel].sum())


def check_detection(reads, config, num_kmers: int, nnz: int) -> None:
    """Compare the device pipeline's reliable-set stats against the
    host recount; raise SelfCheckError on any divergence."""
    if config.use_minimizer or config.use_syncmer:
        # selection sparsifies the occurrence set before counting;
        # the seed spot-check (check_pairs) still covers these modes
        log("selfCheck", "detection recount skipped (minimizer/syncmer)")
        return
    h_num, h_nnz = host_reliable_stats(reads, config)
    if (h_num, h_nnz) != (int(num_kmers), int(nnz)):
        raise SelfCheckError(
            f"detection self-check failed: device numReliableKmers/nnzA "
            f"= {int(num_kmers)}/{int(nnz)}, host oracle = {h_num}/{h_nnz}"
        )
    log("selfCheck", f"detection recount ok ({h_num} kmers, {h_nnz} nnz)")


def check_pairs(reads, pairs, config, sample: int = 512) -> None:
    """Seed invariant: every candidate pair's (pos_h, pos_v) must point
    at occurrences of ONE shared canonical k-mer (the semiring value's
    seed, chain.hpp:36-44). Checks a deterministic sample."""
    P = pairs.num_pairs
    if P == 0:
        return
    k = config.kmer_size
    idx = np.unique(np.linspace(0, P - 1, min(sample, P)).astype(np.int64))
    codes = np.asarray(reads.codes, dtype=np.uint8)
    off = np.asarray(reads.offsets)

    def canon_at(rids, poss):
        starts = off[rids] + poss
        win = np.stack([codes[starts + i] for i in range(k)], axis=1)
        return (
            _hopc_canonical_np(win)
            if config.use_hopc else _canonical_np(win)
        )

    ch = canon_at(pairs.read_h[idx], pairs.pos_h[idx])
    cv = canon_at(pairs.read_v[idx], pairs.pos_v[idx])
    bad = np.nonzero(ch != cv)[0]
    if bad.size:
        i = int(idx[bad[0]])
        raise SelfCheckError(
            f"pair seed self-check failed: {bad.size}/{idx.size} sampled "
            f"pairs' seed k-mers disagree (first: pair {i}, reads "
            f"{int(pairs.read_h[i])}/{int(pairs.read_v[i])} at "
            f"{int(pairs.pos_h[i])}/{int(pairs.pos_v[i])})"
        )
    log("selfCheck", f"{idx.size} sampled pair seeds ok")
