"""The CUDA x-drop kernel against the plain-JAX reference, on the card.

Every test here takes the ``gpu`` fixture and skips without an NVIDIA
GPU: a CUDA kernel has no interpret mode. Run them on the card with
``python -m pytest -o addopts= -m gpu tests/``. The wrapper around the
kernel (padding, row order, permutation, left/right split, backend
choice) is covered on the CPU in test_align.py through the reference.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bella_tpu import BellaConfig
from bella_tpu.align.xdrop import align_candidates, extend_batch, pad_reads

from test_align import mutate

pytestmark = pytest.mark.gpu


def _batch(rng, n, L, err):
    """n (target, query) pairs of mutated random DNA, lengths up to L,
    with PAD beyond each row's length; a few rows drift by one-sided
    indels past half the band."""
    T = np.full((n, L), 127, np.int8)
    Q = np.full((n, L), 127, np.int8)
    tl = np.zeros(n, np.int32)
    ql = np.zeros(n, np.int32)
    for i in range(n):
        m = int(rng.integers(0, L // 2 + 1))
        t = rng.integers(0, 4, m).astype(np.int8)
        if i % 7 == 3:  # gradual one-sided deletions: the path drifts
            q = t[np.arange(m) % 7 != 6]
        elif i % 5 == 0:  # unrelated pair: x-drop ends it early
            q = rng.integers(0, 4, int(rng.integers(0, m + 1))).astype(np.int8)
        else:
            q = mutate(t, err, rng)[:L]
        T[i, :m], Q[i, : len(q)] = t, q
        tl[i], ql[i] = m, len(q)
    return T, tl, Q, ql


def _both(T, tl, Q, ql, xdrop, band, max_steps):
    from bella_tpu.align.cuda_xdrop import extend_batch_cuda

    args = (jnp.asarray(T), jnp.asarray(tl), jnp.asarray(Q), jnp.asarray(ql))
    ref = extend_batch(*args, xdrop, band=band, max_steps=max_steps)
    got = jax.jit(
        lambda *a: extend_batch_cuda(*a, xdrop, band=band, max_steps=max_steps)
    )(*args)
    return ({k: np.asarray(v) for k, v in got.items()},
            {k: np.asarray(v) for k, v in ref.items()})


@pytest.mark.parametrize("band", [32, 64, 128, 256])
@pytest.mark.parametrize("xdrop", [7, 15, 50])
def test_kernel_matches_reference(gpu, band, xdrop):
    rng = np.random.default_rng(band * 100 + xdrop)
    T, tl, Q, ql = _batch(rng, 1024, 4096, 0.15)
    got, ref = _both(T, tl, Q, ql, xdrop, band, 2 * 4096)
    for k in ("score", "t_end", "q_end"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_kernel_edges(gpu):
    """Empty and one-base rows, bands wider than the rows, a step cap
    that stops live extensions."""
    rng = np.random.default_rng(3)
    T, tl, Q, ql = _batch(rng, 64, 40, 0.1)
    tl[:3], ql[:3] = 0, 0
    tl[3], ql[3] = 1, 0
    tl[4], ql[4] = 0, 1
    for band, steps in ((128, 80), (256, 80), (32, 9)):
        got, ref = _both(T, tl, Q, ql, 7, band, steps)
        for k in ("score", "t_end", "q_end"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=(band, k))


def test_align_candidates_cuda_matches_jax(gpu):
    """The whole aligner on real candidate pairs, both backends, with
    the selfcheck comparison on."""
    from bella_tpu.io.simulate import random_genome, sample_reads
    from bella_tpu.overlap.pairs import detect_overlaps

    g = random_genome(200_000, seed=5)
    rs, _ = sample_reads(g, 300, mean_len=3000, min_len=800,
                         error_rate=0.15, seed=6)
    pairs, _, _ = detect_overlaps(rs, BellaConfig())
    assert pairs.num_pairs > 500
    padded, lens = pad_reads(rs)
    a_jax = align_candidates(padded, lens, pairs, BellaConfig(aligner_backend="jax"))
    a_cuda = align_candidates(
        padded, lens, pairs, BellaConfig(aligner_backend="cuda", selfcheck=True),
        batch_size=256,
    )
    for f in ("score", "beg_h", "end_h", "beg_v", "end_v"):
        np.testing.assert_array_equal(getattr(a_cuda, f), getattr(a_jax, f), err_msg=f)


def test_mesh_cuda_parity(gpu):
    """The kernel under shard_map over every visible card: pair rows
    sharded, reads replicated; equal to the one-device reference."""
    from bella_tpu.io.simulate import random_genome, sample_reads
    from bella_tpu.overlap.pairs import detect_overlaps
    from bella_tpu.parallel.sharded import make_mesh

    g = random_genome(60_000, seed=7)
    rs, _ = sample_reads(g, 120, mean_len=2000, min_len=600,
                         error_rate=0.15, seed=8)
    pairs, _, _ = detect_overlaps(rs, BellaConfig())
    padded, lens = pad_reads(rs)
    ref = align_candidates(padded, lens, pairs, BellaConfig(aligner_backend="jax"))
    got = align_candidates(
        padded, lens, pairs, BellaConfig(aligner_backend="cuda"),
        mesh=make_mesh(len(jax.devices())),
    )
    for f in ("score", "beg_h", "end_h", "beg_v", "end_v"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
