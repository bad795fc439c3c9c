"""Scatter-free segment reductions over sorted streams.

The entire overlap pipeline operates on flat occurrence streams sorted so
that equal keys are contiguous ("segments"). Every per-segment
reduction here is built from associative scans + gathers (segmented-scan
operator) instead of scatters.

This is the replacement for the reference's per-column hash
accumulators (include/overlap.hpp:306-341) and libcuckoo upserts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def boundaries(keys) -> jnp.ndarray:
    """True at the first element of each run of equal keys."""
    n = keys.shape[0]
    if n == 0:
        return jnp.zeros((0,), bool)
    return jnp.concatenate([jnp.ones((1,), bool), keys[1:] != keys[:-1]])


def boundaries2(a, b) -> jnp.ndarray:
    """Run starts for composite (a, b) keys."""
    n = a.shape[0]
    if n == 0:
        return jnp.zeros((0,), bool)
    diff = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    return jnp.concatenate([jnp.ones((1,), bool), diff])


def boundaries_many(*keys) -> jnp.ndarray:
    """Run starts for composite (k1, k2, ...) keys."""
    n = keys[0].shape[0]
    if n == 0:
        return jnp.zeros((0,), bool)
    diff = keys[0][1:] != keys[0][:-1]
    for k in keys[1:]:
        diff = diff | (k[1:] != k[:-1])
    return jnp.concatenate([jnp.ones((1,), bool), diff])


def seg_bounds(boundary):
    """(start_idx, end_idx) of the segment containing each element."""
    n = boundary.shape[0]
    idx = jnp.arange(n, dtype=jnp.int64)
    start = jax.lax.associative_scan(jnp.maximum, jnp.where(boundary, idx, 0))
    is_last = jnp.concatenate([boundary[1:], jnp.ones((1,), bool)])
    end = jax.lax.associative_scan(
        jnp.minimum, jnp.where(is_last, idx, n - 1)[::-1]
    )[::-1]
    return start, end


def seg_count(boundary):
    """Segment length, broadcast to every element of the segment."""
    start, end = seg_bounds(boundary)
    return (end - start + 1).astype(jnp.int32)


def seg_sum(values, boundary):
    """Segment sum, broadcast to every element (cumsum + bound gathers)."""
    start, end = seg_bounds(boundary)
    c = jnp.cumsum(values.astype(jnp.int64))
    return c[end] - c[start] + values[start].astype(jnp.int64)


def _segscan(op, values, boundary, reverse=False):
    """Inclusive segmented scan with `op` (max/min/add) resetting at
    segment starts. Standard associative segmented-scan pair operator."""
    if reverse:
        is_last = jnp.concatenate([boundary[1:], jnp.ones((1,), bool)])
        values, boundary = values[::-1], is_last[::-1]

    def combine(x, y):
        xf, xv = x
        yf, yv = y
        return xf | yf, jnp.where(yf, yv, op(xv, yv))

    _, out = jax.lax.associative_scan(combine, (boundary, values))
    return out[::-1] if reverse else out


def seg_max(values, boundary):
    """Segment max, broadcast to every element."""
    fwd = _segscan(jnp.maximum, values, boundary)
    _, end = seg_bounds(boundary)
    return fwd[end]


def seg_min(values, boundary):
    fwd = _segscan(jnp.minimum, values, boundary)
    _, end = seg_bounds(boundary)
    return fwd[end]


def seg_rank(boundary):
    """0-based rank of each element within its segment."""
    start, _ = seg_bounds(boundary)
    return (jnp.arange(boundary.shape[0], dtype=jnp.int64) - start).astype(jnp.int32)


def seg_ids(boundary):
    """Dense 0-based segment index per element."""
    return (jnp.cumsum(boundary.astype(jnp.int64)) - 1).astype(jnp.int32)


# ----------------------------------------------------------------------
# Gather-free broadcast variants (Hillis-Steele doubling)
#
# The scan-and-gather primitives above (seg_sum/seg_max/seg_bounds) are
# exact but lower to big self-gathers plus jax.lax.associative_scan
# networks. The *_bcast variants below compute the same per-segment
# aggregate broadcast to every element using only static shifted slices
# and selects: 2 * log2(n) elementwise passes, no gather HLOs, no int64.
# ----------------------------------------------------------------------


def _shift_fwd(a, s: int, fill):
    """out[i] = a[i - s] (leading `s` elements = fill)."""
    return jnp.concatenate([jnp.full((s,), fill, a.dtype), a[:-s]])


def _seg_scan(values, boundary, op, unit):
    """Inclusive forward segmented scan (combine = op, resets at segment
    starts). Returns the scanned values; the last row of each segment
    holds the segment aggregate."""
    n = int(values.shape[0])
    v = values
    f = boundary
    s = 1
    while s < n:
        pv = _shift_fwd(v, s, jnp.asarray(unit, v.dtype))
        pf = _shift_fwd(f, s, True)
        v = jnp.where(f, v, op(v, pv))
        f = f | pf
        s <<= 1
    return v


def _copy_first(values, boundary):
    """Propagate each segment's FIRST value to every element."""
    n = int(values.shape[0])
    v = values
    f = boundary
    s = 1
    while s < n:
        pv = _shift_fwd(v, s, jnp.asarray(0, v.dtype))
        pf = _shift_fwd(f, s, True)
        v = jnp.where(f, v, pv)
        f = f | pf
        s <<= 1
    return v


def _bcast_last(values, boundary):
    """Propagate each segment's LAST value to every element (backward
    copy): reverse the stream, segment starts become is_last."""
    is_first_rev = jnp.concatenate([boundary[1:], jnp.ones((1,), bool)])[::-1]
    return _copy_first(values[::-1], is_first_rev)[::-1]


def seg_cumsum(values, boundary):
    """Inclusive segmented prefix sum (no gathers)."""
    return _seg_scan(values, boundary, jnp.add, 0)


def seg_sum_bcast(values, boundary):
    """Segment sum broadcast to every element (int32 in/out, no gathers)."""
    inc = _seg_scan(values, boundary, jnp.add, 0)
    return _bcast_last(inc, boundary)


def seg_max_bcast(values, boundary):
    """Segment max broadcast to every element (no gathers)."""
    if values.dtype == jnp.int32:
        unit = -(2**31)
    elif values.dtype == jnp.int64:
        unit = -(2**63)
    else:
        raise TypeError(values.dtype)
    inc = _seg_scan(values, boundary, jnp.maximum, unit)
    return _bcast_last(inc, boundary)


def seg_first_bcast(values, boundary):
    """Segment first-element value broadcast to every element."""
    return _copy_first(values, boundary)
