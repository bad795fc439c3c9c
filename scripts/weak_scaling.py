"""Weak-scaling characterization of the distributed detection step.

Without several cards at hand, this measures what CAN be measured
honestly:

  * functional weak-scaling on the virtual CPU mesh (1..8 devices,
    constant corpus per device) — validates shapes/capacities, NOT
    wall-clock scaling (all virtual devices share one host's cores),
  * the communication-volume model: bytes moved per device by the two
    all_to_all exchanges, which is the quantity that must stay flat
    with device count for weak scaling across real cards.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
     PYTHONPATH=. python scripts/weak_scaling.py   (from the repository root)
"""

import time

import numpy as np

from bella_tpu import BellaConfig
from bella_tpu.io.simulate import random_genome, sample_reads
from bella_tpu.parallel.dist import _shard_reads, detect_overlaps_sharded
from bella_tpu.parallel.sharded import make_mesh

import os
PER_DEV_BASES = int(os.environ.get('WS_PER_DEV_BASES', 300_000))


def corpus(n_dev: int):
    g = random_genome(40_000 * n_dev, seed=11)
    n_reads = PER_DEV_BASES * n_dev // 3000
    reads, _ = sample_reads(
        g, n_reads, mean_len=3000, min_len=1200, error_rate=0.15, seed=12,
        circular=False,
    )
    return reads


def main():
    import jax

    cfg = BellaConfig()
    print(f"devices available: {len(jax.devices())}")
    rows = []
    maxd = int(os.environ.get('WS_MAX_DEV', 8))
    for n in (1, 2, 4, 8):
        if n > maxd:
            break
        if n > len(jax.devices()):
            break
        reads = corpus(n)
        mesh = make_mesh(n)
        _, _, _, _, _, cb = _shard_reads(reads, n)
        # per-device exchanged rows: occurrence exchange ~ cb rows out
        # + cb in; pair exchange ~ (U-1) * live rows
        t0 = time.perf_counter()
        pairs, nk, nnz = detect_overlaps_sharded(reads, cfg, mesh)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        pairs, nk, nnz = detect_overlaps_sharded(reads, cfg, mesh)
        dt = time.perf_counter() - t0
        occ_bytes = cb * 13  # khi,klo,ridpos,sc per row
        pair_bytes = (cfg.upper_freq - 1) * (nnz // max(n, 1)) * 12
        rows.append((n, int(reads.lengths.sum()), pairs.num_pairs, dt,
                     occ_bytes / 1e6, pair_bytes / 1e6))
        print(
            f"ndev={n}: {reads.lengths.sum()/1e6:.1f} Mbp total, "
            f"{pairs.num_pairs} pairs, warm {warm:.2f}s run {dt:.2f}s, "
            f"per-device exchange ~{occ_bytes/1e6:.0f} MB occ + "
            f"{pair_bytes/1e6:.0f} MB pair"
        )
    if len(rows) >= 2:
        base = rows[0]
        print("\nper-device comm volume (flat == weak-scalable):")
        for r in rows:
            print(f"  ndev={r[0]}: occ {r[4]:.0f} MB, pair {r[5]:.0f} MB "
                  f"(vs ndev=1: {r[4]/base[4]:.2f}x, {r[5]/max(base[5],1e-9):.2f}x)")


if __name__ == "__main__":
    main()
