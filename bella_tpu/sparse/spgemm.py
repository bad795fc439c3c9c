"""General sparse matrix-matrix multiply on device (sort-based).

Sort-based counterpart of the reference's hash SpGEMM
(include/overlap.hpp:282-363) and its two-pass structure: a host-side
symbolic pass sizes the expansion exactly like estimateFLOP
(include/overlap.hpp:158-202), then a single jitted numeric pass expands
every multiply into a flat (row, col, value) stream, sorts by output
coordinate, and segment-reduces duplicates — no hash tables, fully
static shapes.

Used by the SpGEMM benchmark driver (scripts/spgemm_bench.py, the role
of src/mkl_free_main.cpp) and as a generic building block; the overlap
pipeline uses the specialised bounded-multiplicity kernel in
bella_tpu/overlap/pairs.py instead.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bella_tpu.sparse.matrix import CSC, csc_from_triples

_U64 = jnp.uint64


@partial(jax.jit, static_argnames=("ncols",))
def _numeric(a_row, a_val, a_colptr,
             b_expand_src, b_row, b_col, b_val, ncols: int):
    """Numeric pass: expand, sort by (col, row), reduce duplicates.

    b_expand_src maps each expansion slot to its B-nonzero index; the
    A-nonzero index is colptr[B.row] + rank within the slot run.
    """
    # rank of each expansion slot within its B-nonzero run
    n = b_expand_src.shape[0]
    idx = jnp.arange(n, dtype=jnp.int64)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), b_expand_src[1:] != b_expand_src[:-1]]
    )
    start = jax.lax.associative_scan(jnp.maximum, jnp.where(first, idx, 0))
    rank = idx - start

    bsrc = b_expand_src
    a_idx = a_colptr[b_row[bsrc]] + rank
    rows = a_row[a_idx]
    cols = b_col[bsrc]
    vals = a_val[a_idx] * b_val[bsrc]

    key = (cols.astype(_U64) << _U64(32)) | rows.astype(_U64)
    key, vals, rows, cols = jax.lax.sort((key, vals, rows, cols), num_keys=1)

    boundary = jnp.concatenate([jnp.ones((1,), bool), key[1:] != key[:-1]])
    # segment-sum values via cumsum trick
    c = jnp.cumsum(vals)
    is_last = jnp.concatenate([boundary[1:], jnp.ones((1,), bool)])
    idx2 = jnp.arange(n, dtype=jnp.int64)
    end = jax.lax.associative_scan(
        jnp.minimum, jnp.where(is_last, idx2, n - 1)[::-1]
    )[::-1]
    startb = jax.lax.associative_scan(jnp.maximum, jnp.where(boundary, idx2, 0))
    seg_total = c[end] - c[startb] + vals[startb]
    return rows, cols, seg_total, boundary


def spgemm(a: CSC, b: CSC) -> CSC:
    """C = A @ B with numeric values (defaults to pattern=1 counts)."""
    a_val = a.values if a.values is not None else np.ones(a.nnz)
    b_val = b.values if b.values is not None else np.ones(b.nnz)

    # host symbolic pass (estimateFLOP): expansion length per B-nonzero
    a_colnnz = np.diff(a.colptr)
    b_rows = b.rowids.astype(np.int64)
    b_cols = np.repeat(np.arange(b.cols, dtype=np.int64), np.diff(b.colptr))
    per_nnz = a_colnnz[b_rows]
    total = int(per_nnz.sum())
    if total == 0:
        return csc_from_triples(
            np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0), a.rows, b.cols
        )
    expand_src = np.repeat(np.arange(b.nnz, dtype=np.int64), per_nnz)

    rows, cols, vals, boundary = _numeric(
        jnp.asarray(a.rowids.astype(np.int64)),
        jnp.asarray(np.asarray(a_val, np.float64)),
        jnp.asarray(a.colptr.astype(np.int64)),
        jnp.asarray(expand_src),
        jnp.asarray(b_rows),
        jnp.asarray(b_cols),
        jnp.asarray(np.asarray(b_val, np.float64)),
        ncols=b.cols,
    )
    head = np.asarray(boundary)
    return csc_from_triples(
        np.asarray(rows)[head],
        np.asarray(cols)[head],
        np.asarray(vals)[head],
        a.rows,
        b.cols,
    )
