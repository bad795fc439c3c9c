"""Worker for the 2-process jax.distributed parity test.

Run as:  python multiproc_worker.py <process_id> <port> <out.npz>

Each process brings 4 virtual CPU devices; together they form the
8-device global mesh over which detect_overlaps_sharded runs the REAL
product distributed path (extraction -> k-mer all_to_all -> local count
-> pair all_to_all -> chain), with gloo carrying the cross-process
collectives. Process 0 writes the resulting pairs to <out.npz>.
"""

import os
import sys


def main() -> int:
    pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        .replace("--xla_force_host_platform_device_count=8", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = str(pid)

    import numpy as np

    from bella_tpu import BellaConfig
    from bella_tpu.io.simulate import random_genome, sample_reads
    from bella_tpu.parallel.dist import detect_overlaps_sharded, init_distributed
    from bella_tpu.parallel.sharded import make_mesh

    init_distributed()
    import jax

    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())

    g = random_genome(12000, seed=71)
    reads, _ = sample_reads(
        g, 50, mean_len=1200, min_len=600, error_rate=0.12, seed=72,
        circular=False,
    )
    cfg = BellaConfig()
    pairs, num_kmers, nnz = detect_overlaps_sharded(reads, cfg, make_mesh())
    if pid == 0:
        np.savez(
            out,
            read_h=pairs.read_h, read_v=pairs.read_v,
            pos_h=pairs.pos_h, pos_v=pairs.pos_v,
            count=pairs.count, matches=pairs.matches,
            overlap_est=pairs.overlap_est, seed_rc=pairs.seed_rc,
            num_kmers=num_kmers, nnz=nnz,
        )
    print(f"WORKER_OK {pid} pairs={pairs.num_pairs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
