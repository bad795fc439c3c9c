"""Hardware-scale split-path probe: ~50 Mbp, force_group=2, packed and
wide variants, exact parity vs the single-pass fused path (VERDICT r4
weak #7 — grouped re-extraction previously had toy-scale CI evidence
only; the CI-scale version lives in tests/test_staged.py).

Run on the GPU: python scripts/split_group_probe.py
"""

import time

import numpy as np

from bella_tpu import BellaConfig
from bella_tpu.io.simulate import random_genome, sample_reads
from bella_tpu.overlap import pairs as pm
from bella_tpu.overlap.pairs import detect_overlaps


def pair_map(p):
    return {
        (int(p.read_h[i]), int(p.read_v[i])): (
            int(p.count[i]), int(p.matches[i]), int(p.overlap_est[i]),
            int(p.pos_h[i]), int(p.pos_v[i]), bool(p.seed_rc[i]),
        )
        for i in range(p.num_pairs)
    }


def main():
    g = random_genome(2_000_000, seed=91)
    reads, _ = sample_reads(
        g, 8_500, mean_len=6000, min_len=1000, error_rate=0.15, seed=92,
    )
    total = int(reads.offsets[-1])
    print(f"corpus {total/1e6:.1f} Mbp, {reads.num_reads} reads", flush=True)
    cfg = BellaConfig()
    t0 = time.time()
    ref, nk_ref, nnz_ref = detect_overlaps(reads, cfg)
    print(f"fused: {time.time()-t0:.1f}s pairs={ref.num_pairs} "
          f"nk={nk_ref} nnz={nnz_ref}", flush=True)
    ms = pair_map(ref)
    budget = total * 55.0
    for wide in (False, True):
        t0 = time.time()
        got, nk, nnz = pm._detect_overlaps_split(
            reads, cfg, budget, wide=wide, force_group=2
        )
        dt = time.time() - t0
        assert (nk, nnz) == (nk_ref, nnz_ref), (wide, nk, nnz)
        mg = pair_map(got)
        assert set(ms) == set(mg)
        for k in ms:
            assert ms[k] == mg[k], (wide, k)
        print(f"split wide={wide} force_group=2: {dt:.1f}s "
              f"({total/dt/1e6:.1f} Mb/s) EXACT PARITY", flush=True)


if __name__ == "__main__":
    main()
