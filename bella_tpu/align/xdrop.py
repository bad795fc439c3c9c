"""Batched banded x-drop seed-and-extend alignment.

Replacement for both Xavier (xavier/xavier.h — AVX2, one alignment per
core, 31-wide int8 band) and LOGAN (loganGPU/functions.cuh — CUDA, one
alignment per thread block). Two backends compute the same thing:

  * ``extend_batch`` (plain JAX, the reference): state is three
    antidiagonals of width `band_width` per pair, shape (batch, band),
    advanced for the whole batch by one ``lax.while_loop`` iteration
    per antidiagonal;
  * ``extend_batch_cuda`` (align/cuda_xdrop.py): the same recurrence as
    a CUDA kernel for Hopper, one pair per warp with the band in
    registers, one launch per batch.

Differences from the reference (documented deviations):
  * int32 scores — no int8 renormalisation dance (xavier/xavier.h:152-158),
  * band 128 wide by default (vs 31): strictly more accurate,
  * alignment end = argmax DP cell rather than the band offset at
    termination (xavier/xavier.h:175-176 uses hoffset/voffset): tighter
    coordinates, same scores,
  * short prefixes/suffixes are still aligned (the reference skips
    extensions shorter than its vector width, xavier/xavier.h:300,338 —
    a SIMD artifact, not a semantic).

Scoring matches the reference defaults: match +1, mismatch -1, gap -1
(include/align.hpp:159-164); termination when the current antidiagonal
max drops more than `xdrop` below the best (xavier/xavier.h:138-150).

DP formulation: D[i][j] over target T (the "H"/row read, possibly
reverse-complemented) and query Q (the "V"/column read). Antidiagonal
d holds cells (i = lo+p, j = d-lo-p) for p in [0, band); the band
offset `lo` advances toward the current argmax (adaptive banding as in
xavier/simdutils.h moveRight/moveDown).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bella_tpu.utils.log import log

NINF = jnp.int32(-(1 << 20))
PAD_CHAR = jnp.int8(127)  # never equals a 2-bit base code


def _shift(a, s: int, fill):
    """Shift along the last axis: out[p] = a[p+s] (s in {-1, 0, 1})."""
    if s == 0:
        return a
    if s == 1:
        return jnp.concatenate([a[:, 1:], jnp.full_like(a[:, :1], fill)], axis=1)
    return jnp.concatenate([jnp.full_like(a[:, :1], fill), a[:, :-1]], axis=1)


@partial(jax.jit, static_argnames=("band", "max_steps", "match", "mismatch", "gap"))
def extend_batch(
    T, t_len, Q, q_len, xdrop,
    band: int = 128,
    max_steps: int = 0,
    match: int = 1,
    mismatch: int = -1,
    gap: int = -1,
):
    """One-direction x-drop extension for a batch of sequence pairs.

    T, Q: (B, L) int8 code arrays (values 0..3, padding arbitrary)
    t_len, q_len: (B,) int32 valid lengths
    xdrop: scalar int
    Returns dict(score, t_end, q_end): best score and its DP cell (the
    number of target/query chars consumed by the best extension).
    """
    B, L = T.shape
    W = band
    if max_steps <= 0:
        max_steps = 2 * L
    t_len = t_len.astype(jnp.int32)
    q_len = q_len.astype(jnp.int32)

    p_idx = jnp.arange(W, dtype=jnp.int32)[None, :]  # (1, W)

    # diag d=0: D[0][0]=0; d=1: a[0]=D[0][1], a[1]=D[1][0] (gap cells,
    # NINF when the corresponding sequence is empty)
    a1 = jnp.full((B, W), NINF, dtype=jnp.int32).at[:, 0].set(0)  # diag d-2
    a2 = jnp.full((B, W), NINF, dtype=jnp.int32)                  # diag d-1
    a2 = a2.at[:, 0].set(jnp.where(q_len >= 1, jnp.int32(gap), NINF))
    a2 = a2.at[:, 1].set(jnp.where(t_len >= 1, jnp.int32(gap), NINF))

    # char windows for diag d: Twin[p] = T[lo+p-1], Qwin[p] = Q[d-lo-p-1]
    gather_t = jnp.clip(p_idx - 1, 0, L - 1)
    twin = jnp.where(p_idx >= 1, jnp.take_along_axis(T, gather_t, axis=1), PAD_CHAR)
    gather_q = jnp.clip(1 - p_idx, 0, L - 1)
    qwin = jnp.where(p_idx <= 1, jnp.take_along_axis(Q, gather_q, axis=1), PAD_CHAR)

    lo = jnp.zeros((B,), jnp.int32)
    dlt1 = jnp.zeros((B,), jnp.int32)  # lo(d-1) - lo(d-2)
    best = jnp.zeros((B,), jnp.int32)
    best_t = jnp.zeros((B,), jnp.int32)  # i of best cell
    best_q = jnp.zeros((B,), jnp.int32)  # j of best cell
    alive = (t_len + q_len) > 0
    d = jnp.full((B,), 2, jnp.int32)

    xdrop = jnp.int32(xdrop)

    def cond(state):
        return state["alive"].any() & (state["step"] < max_steps)

    def body(state):
        a1, a2 = state["a1"], state["a2"]
        lo, dlt1, d = state["lo"], state["dlt1"], state["d"]
        twin, qwin = state["twin"], state["qwin"]
        best, best_t, best_q = state["best"], state["best_t"], state["best_q"]
        alive = state["alive"]

        # --- compute diag d (dlt2 = lo(d)-lo(d-1) was applied when lo
        # was updated last step, encoded in the shifts chosen below) ---
        # We keep the convention: shifts already account for the move
        # performed at the end of the previous iteration via dlt2 state.
        dlt2 = state["dlt2"]

        sub = jnp.where(twin == qwin, jnp.int32(match), jnp.int32(mismatch))
        # predecessors (see module docstring):
        #   diag:  a1[p - 1 + dlt2 + dlt1] + sub
        #   gapQ:  a2[p - 1 + dlt2] + gap   (consume target)
        #   gapT:  a2[p + dlt2] + gap       (consume query)
        shift_d = dlt2 + dlt1 - 1  # in {-1, 0, 1}
        diag_m1 = _shift(a1, -1, NINF)
        diag_0 = a1
        diag_p1 = _shift(a1, 1, NINF)
        diag_pred = jnp.where(
            (shift_d == -1)[:, None], diag_m1,
            jnp.where((shift_d == 0)[:, None], diag_0, diag_p1),
        )
        gq_pred = jnp.where((dlt2 == 1)[:, None], a2, _shift(a2, -1, NINF))
        gt_pred = jnp.where((dlt2 == 1)[:, None], _shift(a2, 1, NINF), a2)

        a3 = jnp.maximum(
            diag_pred + sub,
            jnp.maximum(gq_pred, gt_pred) + jnp.int32(gap),
        )
        # mask cells outside the DP matrix
        i = lo[:, None] + p_idx
        j = d[:, None] - i
        valid = (i >= 0) & (i <= t_len[:, None]) & (j >= 0) & (j <= q_len[:, None])
        a3 = jnp.where(valid, a3, NINF)
        a3 = jnp.maximum(a3, NINF)  # clamp gap chains from NINF

        cur = a3.max(axis=1)
        argp = jnp.argmax(a3, axis=1).astype(jnp.int32)

        improved = alive & (cur > best)
        best = jnp.where(improved, cur, best)
        best_t = jnp.where(improved, lo + argp, best_t)
        best_q = jnp.where(improved, d - (lo + argp), best_q)

        # x-drop + end-of-matrix termination
        step_alive = alive & (cur >= best - xdrop) & (d < t_len + q_len)

        # --- move decision for diag d+1 ---
        move_b = argp > (W // 2)  # deep in target -> slide band down
        new_lo = jnp.where(step_alive & move_b, lo + 1, lo)
        new_dlt2 = jnp.where(step_alive & move_b, 1, 0).astype(jnp.int32)

        # window updates (one new char per pair)
        t_new_idx = jnp.clip(lo + W - 1, 0, L - 1)[:, None]
        t_new = jnp.take_along_axis(T, t_new_idx, axis=1)[:, 0]
        twin_b = _shift(twin, 1, PAD_CHAR).at[:, W - 1].set(t_new)
        q_new_idx = jnp.clip(d - lo, 0, L - 1)[:, None]
        q_new = jnp.take_along_axis(Q, q_new_idx, axis=1)[:, 0]
        qwin_a = _shift(qwin, -1, PAD_CHAR).at[:, 0].set(q_new)
        twin = jnp.where(move_b[:, None], twin_b, twin)
        qwin = jnp.where(move_b[:, None], qwin, qwin_a)

        return dict(
            a1=jnp.where(step_alive[:, None], a2, a1),
            a2=jnp.where(step_alive[:, None], a3, a2),
            lo=new_lo,
            dlt1=jnp.where(step_alive, dlt2, dlt1),
            dlt2=new_dlt2,
            d=jnp.where(step_alive, d + 1, d),
            twin=twin,
            qwin=qwin,
            best=best,
            best_t=best_t,
            best_q=best_q,
            alive=step_alive,
            step=state["step"] + 1,
        )

    state = dict(
        a1=a1, a2=a2, lo=lo, dlt1=dlt1, dlt2=jnp.zeros((B,), jnp.int32),
        d=d, twin=twin, qwin=qwin, best=best, best_t=best_t, best_q=best_q,
        alive=alive, step=jnp.int32(0),
    )
    state = jax.lax.while_loop(cond, body, state)
    return dict(score=state["best"], t_end=state["best_t"], q_end=state["best_q"])


# ----------------------------------------------------------------------
# Seed-and-extend driver (xavierAlign / XavierXDrop equivalents)
# ----------------------------------------------------------------------

BACKENDS = ("auto", "cuda", "jax")


@dataclasses.dataclass
class AlignmentResult:
    """Extended seeds + scores for a batch of candidate pairs, in the
    coordinate frame of PostAlignDecision (include/overlap.hpp:413-497):
    H coords are on the reverse-complemented H read when strand is 'c'."""

    score: np.ndarray   # (P,) int32
    beg_h: np.ndarray
    end_h: np.ndarray
    beg_v: np.ndarray
    end_v: np.ndarray
    strand_rc: np.ndarray  # (P,) bool


def resolve_aligner_backend(name: str) -> str:
    """The aligner that runs: "auto" is the CUDA kernel on a GPU and the
    plain-JAX reference elsewhere. An explicit "cuda" without a GPU
    raises rather than falling back."""
    if name not in BACKENDS:
        raise ValueError(f"aligner_backend must be one of {BACKENDS}, got {name!r}")
    platform = jax.devices()[0].platform
    if name == "auto":
        return "cuda" if platform == "gpu" else "jax"
    if name == "cuda" and platform != "gpu":
        raise RuntimeError(
            f"aligner_backend='cuda' needs a GPU; JAX's device is {platform!r}"
        )
    return name


def _lshift_rows(x, s):
    """out[b, t] = x[b, t+s[b]] for t+s[b] < L, PAD beyond."""
    L = x.shape[1]
    idx = jnp.arange(L, dtype=jnp.int32)[None, :] + s.astype(jnp.int32)[:, None]
    got = jnp.take_along_axis(x, jnp.clip(idx, 0, L - 1), axis=1)
    return jnp.where(idx < L, got, PAD_CHAR)


def _prepare_extensions(reads_dev, lens_dev, bh, bv, ph_raw, pv, rc, k: int,
                        valid, seq_len: int = 0):
    """Strand correction + left/right extension sequence gathers.

    Strand handling follows xavierAlign (include/align.hpp:152-202): if
    the seed's forward strings disagree (rc), the H read is
    reverse-complemented and the seed H coordinate flipped. Left
    extension spans the seed (reversed prefixes up to seed end), right
    extension the suffixes after the seed — mirroring XavierXDrop's
    EXTEND_BOTH composition (xavier/xavier.h:326-372).

    seq_len: length-tier width — every read in this batch fits seq_len,
    so the gathered rows slice to (B, seq_len) and the extension runs
    at the tier width, not the corpus-max width."""
    if seq_len and seq_len < reads_dev.shape[1]:
        h_seq = reads_dev[bh, :seq_len]
        V = reads_dev[bv, :seq_len]
    else:
        h_seq = reads_dev[bh]
        V = reads_dev[bv]
    len_h = lens_dev[bh]
    len_v = lens_dev[bv]
    L = h_seq.shape[1]

    # reverse complement: the complement is applied before the shift so
    # pad lanes stay PAD after it
    rc_seq = _lshift_rows(jnp.flip(h_seq ^ 3, axis=1), L - len_h)
    H = jnp.where(rc[:, None], rc_seq, h_seq)
    seed_h = jnp.where(rc, len_h - ph_raw - k, ph_raw)
    seed_end_h = seed_h + k
    seed_end_v = pv + k

    # reversed prefixes: flip(S)[t + L - end] = S[end-1-t]
    lt = _lshift_rows(jnp.flip(H, axis=1), L - seed_end_h)
    lq = _lshift_rows(jnp.flip(V, axis=1), L - seed_end_v)
    rt = _lshift_rows(H, seed_end_h)
    rq = _lshift_rows(V, seed_end_v)

    def live(n):
        # batch-padding rows get empty extensions: they end before the
        # first antidiagonal instead of re-aligning a real pair
        return jnp.where(valid, n, 0)

    return dict(
        lt=lt, lq=lq, lt_len=live(seed_end_h), lq_len=live(seed_end_v),
        rt=rt, rq=rq, rt_len=live(len_h - seed_end_h),
        rq_len=live(len_v - seed_end_v),
        seed_end_h=seed_end_h, seed_end_v=seed_end_v, L=L,
    )


def _extend_both(ext, extend, xdrop: int, band: int, max_steps: int):
    """Left and right extensions of a batch as ONE call of `extend` over
    2B rows (left rows first), split back into (left, right)."""
    B = ext["lt"].shape[0]
    out = extend(
        jnp.concatenate([ext["lt"], ext["rt"]]),
        jnp.concatenate([ext["lt_len"], ext["rt_len"]]).astype(jnp.int32),
        jnp.concatenate([ext["lq"], ext["rq"]]),
        jnp.concatenate([ext["lq_len"], ext["rq_len"]]).astype(jnp.int32),
        xdrop, band=band, max_steps=max_steps,
    )
    return ({k: v[:B] for k, v in out.items()},
            {k: v[B:] for k, v in out.items()})


def in_step_order(extend):
    """`extend` with its rows run in order of wavefront step count
    (t + q length) and the results returned in row order. For the CUDA
    kernel, whose warps share a block until the block's longest row
    ends; the batch-lockstep reference gains nothing from it."""

    def run(T, t_len, Q, q_len, xdrop, band, max_steps):
        order = jnp.argsort(t_len + q_len).astype(jnp.int32)
        out = extend(T[order], t_len[order], Q[order], q_len[order], xdrop,
                     band=band, max_steps=max_steps)
        # scatter back (row order[i] gets result i); an argsort of
        # `order` would do the same, but XLA's GPU permutation-sort
        # rewrite of it fails its HLO verifier under 64-bit mode
        return {k: jnp.zeros_like(v).at[order].set(v, unique_indices=True)
                for k, v in out.items()}

    return run


def _combine_extensions(ext, left, right):
    """Stacked (5, B) int32 block, one device->host transfer per batch:
    row order score/beg_h/end_h/beg_v/end_v."""
    return jnp.stack([
        left["score"] + right["score"],
        ext["seed_end_h"] - left["t_end"],
        ext["seed_end_h"] + right["t_end"],
        ext["seed_end_v"] - left["q_end"],
        ext["seed_end_v"] + right["q_end"],
    ]).astype(jnp.int32)


def _extender(backend: str):
    if backend == "cuda":
        from bella_tpu.align.cuda_xdrop import extend_batch_cuda

        # step-count order: ~8% less kernel device time than pair order
        # on the demo corpus's candidate set (PERF.md, Findings)
        return in_step_order(extend_batch_cuda)
    return extend_batch


def extend_pairs(
    reads_dev, lens_dev, pairblk, xdrop: int, kmer_size: int, band: int,
    max_steps: int = 0, seq_len: int = 0, backend: str = "jax",
):
    """Both-direction extension of one seed per pair on `backend`:
    returns (ext, left, right), the prepared extensions and the left and
    right extension results (dicts of score, t_end, q_end).

    pairblk is ONE (6, B) int32 block, rows (read_h, read_v, pos_h,
    pos_v, seed_rc, valid) — see _pair_block."""
    rc = pairblk[4] != 0
    valid = pairblk[5] != 0
    ext = _prepare_extensions(
        reads_dev, lens_dev, pairblk[0], pairblk[1], pairblk[2], pairblk[3],
        rc, kmer_size, valid, seq_len=seq_len,
    )
    steps = max_steps if max_steps > 0 else 2 * ext["L"]
    left, right = _extend_both(ext, _extender(backend), xdrop, band, steps)
    return ext, left, right


@partial(jax.jit, static_argnames=(
    "xdrop", "kmer_size", "band", "max_steps", "seq_len", "backend"))
def _seed_extend_batch(
    reads_dev, lens_dev, pairblk, xdrop: int, kmer_size: int, band: int,
    max_steps: int = 0, seq_len: int = 0, backend: str = "jax",
):
    """extend_pairs fused with the coordinate composition: one dispatch
    and one (5, B) result block per batch."""
    return _combine_extensions(*extend_pairs(
        reads_dev, lens_dev, pairblk, xdrop=xdrop, kmer_size=kmer_size,
        band=band, max_steps=max_steps, seq_len=seq_len, backend=backend,
    ))


def _pair_block(pairs, sel, valid):
    """The (6, B) int32 block consumed by _seed_extend_batch (row order
    is that function's contract)."""
    return np.stack([
        pairs.read_h[sel].astype(np.int32),
        pairs.read_v[sel].astype(np.int32),
        pairs.pos_h[sel].astype(np.int32),
        pairs.pos_v[sel].astype(np.int32),
        pairs.seed_rc[sel].astype(np.int32),
        valid.astype(np.int32),
    ])


def _length_tier(lengths: np.ndarray, lmax: int) -> np.ndarray:
    """pow4 sequence-width ladder (512, 1024, 4096, 16384, ...): each
    tier is one compiled shape of the batch step, so a batch of short
    pairs never pays the corpus-max width in its gathers, while the
    ladder keeps the number of compiled shapes small."""
    exp = np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64)
    tier = np.maximum(512, 1 << (((exp + 1) >> 1) << 1))
    return np.minimum(tier, lmax)


def _batch_bucket(P: int, batch_size: int, ndev: int = 1) -> int:
    """Bucket the alignment batch to the next power of two >= P
    (capped) so small runs don't pad to the full batch while big runs
    reuse one compiled shape."""
    bucket = max(64, ndev)
    while bucket < min(P, batch_size):
        bucket *= 2
    return min(max(batch_size, ndev), bucket)


def _batch_step(mesh, backend: str, **statics):
    """The per-batch step: _seed_extend_batch on one device, or under
    shard_map over the mesh's one axis with pair rows sharded and the
    read matrix and lengths replicated."""
    if mesh is None:
        return partial(_seed_extend_batch, backend=backend, **statics)
    from jax.sharding import PartitionSpec as P

    ax = mesh.axis_names[0]
    return jax.jit(jax.shard_map(
        partial(_seed_extend_batch, backend=backend, **statics),
        mesh=mesh, in_specs=(P(), P(), P(None, ax)), out_specs=P(None, ax),
        check_vma=False,
    ))


def align_candidates(
    reads_padded: Optional[np.ndarray],
    read_lengths: np.ndarray,
    pairs,
    config,
    batch_size: int = 0,
    mesh=None,
    reads=None,
) -> AlignmentResult:
    """Align all candidate pairs (host driver, batches on device).

    reads_padded: (R, Lmax) int8 2-bit codes, PAD elsewhere — or None,
    in which case it is built from `reads` (the ReadSet) by pad_reads.
    pairs: CandidatePairs (seed per pair). Strand handling follows
    xavierAlign (include/align.hpp:152-202): if the seed's forward
    strings disagree (seed_rc), the H read is reverse-complemented and
    the seed H coordinate flipped before extension.

    mesh: optional jax.sharding.Mesh — batches run data-parallel over
    the mesh's one axis (reads replicated, pair rows sharded), the form
    of the reference's multi-GPU batch split
    (loganGPU/functions.cuh:441-443).
    """
    P = pairs.num_pairs
    if P == 0:
        z = np.zeros(0, np.int32)
        return AlignmentResult(z, z, z, z, z, np.zeros(0, bool))
    backend = resolve_aligner_backend(config.aligner_backend)
    log("alignerBackend", backend)
    if batch_size <= 0:
        batch_size = config.align_batch
    ndev = int(mesh.devices.size) if mesh is not None else 1
    batch_size = _batch_bucket(P, batch_size, ndev)
    read_lengths = np.asarray(read_lengths)
    if reads_padded is None:
        reads_padded, _ = pad_reads(reads)
    Lmax = reads_padded.shape[1]
    statics = dict(
        xdrop=int(config.xdrop), kmer_size=int(config.kmer_size),
        band=int(config.band_width),
        # wavefront step cap: config.max_steps when set, else 2 * tier
        max_steps=int(config.max_steps or 0),
    )

    if mesh is None:
        reads_dev = jnp.asarray(reads_padded)
        lens_dev = jnp.asarray(read_lengths.astype(np.int32))
        put_blk = jnp.asarray
    else:
        from jax.sharding import NamedSharding, PartitionSpec

        repl = NamedSharding(mesh, PartitionSpec())
        cols = NamedSharding(mesh, PartitionSpec(None, mesh.axis_names[0]))
        reads_dev = jax.device_put(reads_padded, repl)
        lens_dev = jax.device_put(read_lengths.astype(np.int32), repl)

        def put_blk(a):
            return jax.device_put(a, cols)

    # order by (read-length tier, estimated overlap): the tier keys each
    # batch to a pow4 sequence width so short pairs never pay the
    # corpus-max width, and within a tier the overlap estimate keeps a
    # batch's extensions of similar length
    pair_len = np.maximum(
        read_lengths[pairs.read_h], read_lengths[pairs.read_v]
    ).astype(np.int64)
    tier = _length_tier(pair_len, Lmax)
    if pairs.overlap_est.size and pairs.overlap_est.max() > 0:
        order = np.lexsort((pairs.overlap_est, tier))
    else:
        order = np.lexsort((pair_len, tier))

    steps = {}
    # dispatch ALL batches first (async), read back after: device compute
    # of batch b overlaps the host-side prep/readback of its neighbours
    pending = []
    for s in range(0, P, batch_size):
        sel = order[s : s + batch_size]
        sel_valid = len(sel)
        if sel_valid < batch_size:  # pad the tail: one compiled shape
            sel = np.concatenate(
                [sel, np.zeros(batch_size - sel_valid, dtype=sel.dtype)]
            )
        valid = np.arange(batch_size) < sel_valid
        # batch sequence width = the batch's length tier
        seq_len = int(tier[sel[:sel_valid]].max())
        if seq_len not in steps:
            steps[seq_len] = _batch_step(
                mesh, backend, seq_len=seq_len, **statics
            )
        blk = _pair_block(pairs, sel, valid)
        out = steps[seq_len](reads_dev, lens_dev, put_blk(blk))
        pending.append((sel[:sel_valid], out))

    score = np.zeros(P, np.int32)
    beg_h = np.zeros(P, np.int32)
    end_h = np.zeros(P, np.int32)
    beg_v = np.zeros(P, np.int32)
    end_v = np.zeros(P, np.int32)
    for sel, out in pending:
        arr = np.asarray(out)  # (5, batch) int32, one transfer
        n = len(sel)
        score[sel] = arr[0, :n]
        beg_h[sel] = arr[1, :n]
        end_h[sel] = arr[2, :n]
        beg_v[sel] = arr[3, :n]
        end_v[sel] = arr[4, :n]

    if config.selfcheck:
        # debug mode (the role of the reference's serial/ASAN builds,
        # makefile-nersc:17-23,70): re-run the LAST batch through the
        # plain-JAX reference and require identical results. Batches go
        # in (tier, overlap_est) order, so the last one holds the widest
        # tier's largest overlaps: the longest extensions, with the most
        # room for the band to drift.
        # (blk and seq_len still hold the dispatch loop's last batch)
        sel, out = pending[-1]
        log("alignCheckTier", seq_len)
        ref = np.asarray(_seed_extend_batch(
            reads_dev, lens_dev, put_blk(blk), seq_len=seq_len,
            backend="jax", **statics,
        ))
        n = len(sel)
        check_against_reference(np.asarray(out)[:, :n], ref[:, :n], backend)
    return AlignmentResult(score, beg_h, end_h, beg_v, end_v, pairs.seed_rc.copy())


def check_against_reference(got: np.ndarray, ref: np.ndarray, backend: str) -> None:
    """Raise unless the aligner's (5, B) batch block equals the plain-JAX
    reference's exactly (integer DP: the tolerance is zero)."""
    bad = np.nonzero((got != ref).any(axis=0))[0]
    log("alignCheck", f"{got.shape[1]} pairs vs extend_batch: {len(bad)} differ")
    if len(bad):
        i = int(bad[0])
        raise RuntimeError(
            f"aligner check failed: {len(bad)}/{got.shape[1]} pairs of the "
            f"{backend!r} backend differ from extend_batch; first at column "
            f"{i}: {got[:, i].tolist()} vs {ref[:, i].tolist()}"
        )


def pad_reads(reads, bucket: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """ReadSet -> (R, Lmax) int8 padded matrix + lengths. Lmax rounded
    up to `bucket` to stabilise jit shapes across runs."""
    lens = reads.lengths.astype(np.int32)
    lmax = int(((int(lens.max()) + bucket - 1) // bucket) * bucket) if len(lens) else bucket
    mat = np.full((reads.num_reads, lmax), 127, dtype=np.int8)
    for r in range(reads.num_reads):
        s, e = reads.offsets[r], reads.offsets[r + 1]
        mat[r, : e - s] = reads.codes[s:e]
    return mat, lens
