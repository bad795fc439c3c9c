"""Sparse-matrix core: CSC/CSR containers, tuples->matrix construction,
transpose, MatrixMarket IO, and an R-MAT generator.

API parity with the reference L3 layer (include/common/CSC.h,
src/CSC.cpp, include/common/CSR.h, transpose.h, IO.h, and the GTgraph
R-MAT generator used by the SpGEMM bench driver, src/mkl_free_main.cpp).
Construction is sort-based instead of the reference's
count/prefix-sum/scatter + per-column hash dedup (src/CSC.cpp:301-479);
the pipeline's hot path does NOT go through these containers (it stays
on the flat k-mer-major stream, bella_tpu/kmers/count.py) — they exist
for interchange, benchmarks, and the matrix dump (bellaio.h).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CSC:
    """Compressed sparse column; values optional (pattern matrices)."""

    colptr: np.ndarray   # (cols+1,) int64
    rowids: np.ndarray   # (nnz,) int32
    values: Optional[np.ndarray]
    rows: int
    cols: int

    @property
    def nnz(self) -> int:
        return int(self.rowids.shape[0])

    def transpose(self) -> "CSC":
        """CSC of the transpose == CSR of self (src/CSC.cpp:289-299)."""
        cols_of = np.repeat(np.arange(self.cols, dtype=np.int32),
                            np.diff(self.colptr))
        return csc_from_triples(
            cols_of, self.rowids,
            self.values if self.values is not None else None,
            rows=self.cols, cols=self.rows,
        )

    def to_dense(self) -> np.ndarray:
        d = np.zeros((self.rows, self.cols))
        for c in range(self.cols):
            for i in range(self.colptr[c], self.colptr[c + 1]):
                d[self.rowids[i], c] = 1 if self.values is None else self.values[i]
        return d

    def sorted_within_columns(self) -> bool:
        """CSC::Sorted() (src/CSC.cpp:526-536)."""
        for c in range(self.cols):
            seg = self.rowids[self.colptr[c] : self.colptr[c + 1]]
            if np.any(np.diff(seg) < 0):
                return False
        return True


@dataclasses.dataclass
class CSR:
    rowptr: np.ndarray
    colids: np.ndarray
    values: Optional[np.ndarray]
    rows: int
    cols: int

    @staticmethod
    def from_csc(a: CSC) -> "CSR":
        t = a.transpose()
        return CSR(t.colptr, t.rowids, t.values, a.rows, a.cols)


def csc_from_triples(
    rows_a: np.ndarray,
    cols_a: np.ndarray,
    vals_a: Optional[np.ndarray],
    rows: int,
    cols: int,
    merge: Optional[Callable] = None,
) -> CSC:
    """(row, col, val) triples -> CSC. Duplicates merged with `merge`
    (binary reduce; default keep-first, matching the k-mer-position
    matrix build, src/main.cpp:477-480)."""
    order = np.lexsort((rows_a, cols_a))
    r = np.asarray(rows_a, np.int32)[order]
    c = np.asarray(cols_a, np.int64)[order]
    v = None if vals_a is None else np.asarray(vals_a)[order]

    if len(r):
        keep = np.concatenate([[True], (r[1:] != r[:-1]) | (c[1:] != c[:-1])])
        if merge is not None and v is not None and not keep.all():
            seg = np.cumsum(keep) - 1
            merged = v[keep].copy()
            for i in np.flatnonzero(~keep):
                merged[seg[i]] = merge(merged[seg[i]], v[i])
            v = merged
            r, c = r[keep], c[keep]
        else:
            r, c = r[keep], c[keep]
            if v is not None:
                v = v[keep]
    colptr = np.zeros(cols + 1, dtype=np.int64)
    np.add.at(colptr, c + 1, 1)
    np.cumsum(colptr, out=colptr)
    return CSC(colptr, r, v, rows, cols)


def write_matrix_market(path: str, a: CSC) -> None:
    """MatrixMarket coordinate writer (CSC::ParallelWrite,
    src/CSC.cpp:201-287; 1-indexed)."""
    with open(path, "w") as f:
        kind = "pattern" if a.values is None else "integer"
        f.write(f"%%MatrixMarket matrix coordinate {kind} general\n")
        f.write(f"{a.rows}\t{a.cols}\t{a.nnz}\n")
        for c in range(a.cols):
            for i in range(a.colptr[c], a.colptr[c + 1]):
                if a.values is None:
                    f.write(f"{a.rowids[i] + 1}\t{c + 1}\n")
                else:
                    f.write(f"{a.rowids[i] + 1}\t{c + 1}\t{a.values[i]}\n")


def read_matrix_market(path: str) -> CSC:
    """MM coordinate reader (include/common/IO.h:10-58)."""
    with open(path) as f:
        header = f.readline()
        pattern = "pattern" in header
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        rows, cols, nnz = (int(x) for x in line.split())
        rr = np.zeros(nnz, np.int64)
        cc = np.zeros(nnz, np.int64)
        vv = None if pattern else np.zeros(nnz)
        for i in range(nnz):
            parts = f.readline().split()
            rr[i], cc[i] = int(parts[0]) - 1, int(parts[1]) - 1
            if not pattern:
                vv[i] = float(parts[2])
    return csc_from_triples(rr, cc, vv, rows, cols)


def rmat_triples(
    scale: int, edge_factor: int = 8,
    a: float = 0.57, b: float = 0.19, c: float = 0.19,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """R-MAT edge sampler (replaces the vendored GTgraph generator,
    SURVEY §2.2): n = 2^scale vertices, n*edge_factor edges, recursive
    quadrant probabilities (a, b, c, 1-a-b-c). Vectorized over bits."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    rows_o = np.zeros(m, dtype=np.int64)
    cols_o = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        right = (r > a + b) & (r <= a + b + c) | (r > a + b + c)
        down = ((r > a) & (r <= a + b)) | (r > a + b + c)
        rows_o |= down.astype(np.int64) << bit
        cols_o |= right.astype(np.int64) << bit
    return rows_o, cols_o


def spgemm_count(a: CSC, b: CSC) -> CSC:
    """Reference SpGEMM oracle on host (plain + semiring): pattern
    product C = A*B with integer counts, for correctness tests of the
    device pair-generation kernel (role of src/mkl_free_main.cpp's
    C == C_verify check)."""
    rows_out, cols_out, vals_out = [], [], []
    acc: dict = {}
    for j in range(b.cols):
        acc.clear()
        for t in range(b.colptr[j], b.colptr[j + 1]):
            krow = b.rowids[t]
            bv = 1 if b.values is None else b.values[t]
            for s in range(a.colptr[krow], a.colptr[krow + 1]):
                i = a.rowids[s]
                av = 1 if a.values is None else a.values[s]
                acc[i] = acc.get(i, 0) + av * bv
        for i, v in sorted(acc.items()):
            rows_out.append(i)
            cols_out.append(j)
            vals_out.append(v)
    return csc_from_triples(
        np.array(rows_out, np.int64), np.array(cols_out, np.int64),
        np.array(vals_out), a.rows, b.cols,
    )
