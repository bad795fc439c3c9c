"""Benchmark: end-to-end overlap-detection throughput on one GPU.

Synthesizes an E. coli-demo-like workload (the reference's measurement
protocol: 30X long reads, k=17, bounds [2,8],
--skip-alignment) and measures the device pipeline: k-mer extraction ->
exact counting -> reliable filter -> candidate SpGEMM + chaining.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
The value is the median of 5 timed runs after TWO warmups (the first
warmup pays the cold compiles; the second pays the speculative-size
hinted path's own signatures, so no timed run ever includes a compile);
all samples are recorded in the "samples" field so the artifact shows
its own spread. The align+decide phase is measured by default and
folded into the same line as align_* fields (set BELLA_BENCH_ALIGN=0 to
skip it). The line names the device (platform, kind, count) and the
card (name and power limit, from nvidia-smi). Without a GPU it exits
non-zero and prints no line.
"""

import json
import os
import sys
import time

import numpy as np

GENOME = int(os.environ.get("BELLA_BENCH_GENOME", 300_000))
COVERAGE = int(os.environ.get("BELLA_BENCH_COVERAGE", 25))
MEAN_LEN = int(os.environ.get("BELLA_BENCH_MEAN_LEN", 6000))


def main():
    from chip_smoke import nvidia_smi, require_gpu

    devs = require_gpu()
    card = nvidia_smi()
    t_setup = time.time()
    from bella_tpu import BellaConfig
    from bella_tpu.io.simulate import random_genome, sample_reads
    from bella_tpu.overlap.pairs import detect_overlaps

    cfg = BellaConfig()
    g = random_genome(GENOME, seed=0)
    n_reads = GENOME * COVERAGE // MEAN_LEN
    reads, _ = sample_reads(
        g, n_reads, mean_len=MEAN_LEN, min_len=1000, error_rate=0.15, seed=1
    )
    total_bases = int(reads.lengths.sum())
    print(
        f"bench setup: {reads.num_reads} reads, {total_bases/1e6:.1f} Mbp "
        f"({time.time()-t_setup:.1f}s)",
        file=sys.stderr,
    )

    def run_once():
        return detect_overlaps(reads, cfg)

    # warmup x2: the first pays the cold compiles; the second runs the
    # speculative-size hinted path, which has signatures of its own —
    # without it the first timed run pays THOSE compiles
    t0 = time.time()
    pairs, num_kmers, nnz = run_once()
    warm = time.time() - t0
    t0 = time.time()
    pairs, num_kmers, nnz = run_once()
    warm2 = time.time() - t0
    # timed: median of 5 — one sample is not a measurement
    dts = []
    for _ in range(5):
        t0 = time.time()
        pairs, num_kmers, nnz = run_once()
        dts.append(time.time() - t0)
    dt = sorted(dts)[len(dts) // 2]

    bases_per_s = total_bases / dt
    expanded = nnz * (cfg.upper_freq - 1)  # SpGEMM expansion rows
    print(
        f"bench: warm={warm:.2f}s warm2={warm2:.2f}s run={dt:.2f}s "
        f"samples={[round(x, 3) for x in dts]} nnzA={nnz} "
        f"pairs={pairs.num_pairs} expanded={expanded} "
        f"({expanded/dt/1e6:.1f} Mrows/s)",
        file=sys.stderr,
    )

    row = {
        "metric": "overlap_detection_bases_per_s",
        "value": round(bases_per_s, 1),
        "unit": "bases/s",
        "samples": [round(total_bases / x, 0) for x in dts],
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
        "card": card,
    }

    if os.environ.get("BELLA_BENCH_ALIGN", "1") != "0":
        row.update(_bench_align(reads, pairs, cfg))
    print(json.dumps(row))


def _bench_align(reads, pairs, cfg):
    from bella_tpu.align.xdrop import align_candidates
    from bella_tpu.overlap.decision import post_align_decision

    lens = reads.lengths.astype(np.int32)

    def run_align():
        aln = align_candidates(None, lens, pairs, cfg, reads=reads)
        dec = post_align_decision(
            aln, pairs.read_h, pairs.read_v, reads.lengths, cfg
        )
        return aln, dec

    t0 = time.time()
    aln, dec = run_align()  # warmup/compile
    warm_a = time.time() - t0
    dts_a = []
    for _ in range(3):
        t0 = time.time()
        aln, dec = run_align()
        dts_a.append(time.time() - t0)
    dt_a = sorted(dts_a)[1]
    aligned_bases = int(
        (aln.end_h - aln.beg_h).sum() + (aln.end_v - aln.beg_v).sum()
    )
    rate = aligned_bases / dt_a
    print(
        f"align bench: warm={warm_a:.2f}s run={dt_a:.2f}s "
        f"samples={[round(x, 3) for x in dts_a]} "
        f"pairs={pairs.num_pairs} aligned_bases={aligned_bases} "
        f"passed={int(dec['passed'].sum())}",
        file=sys.stderr,
    )
    return {"align_value": round(rate, 1), "align_unit": "bases/s"}


if __name__ == "__main__":
    main()
