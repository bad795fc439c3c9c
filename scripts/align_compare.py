#!/usr/bin/env python3
"""Time the CUDA x-drop kernel against extend_batch under XLA, on a GPU.

    python scripts/align_compare.py [--seed N] [--genome-len BASES]
                                    [--trace-dir DIR]

Both aligners run through align_candidates on the full candidate set of
chip_smoke.py's corpus (detection is shared and not timed), one call per
run, as the pipeline makes it. Per run: align wall time and the compile
time inside it. The kernel runs cold, then warm; the kernel's device
time comes from a jax.profiler trace of one more warm run (the sum of
the durations of its xdrop_extend_kernel events). extend_batch runs
once, cold. Results of the two aligners must be identical.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_seconds(trace_dir: str, name_part: str):
    """(seconds of events whose name contains name_part, busy seconds of
    all events) over the GPU planes of the newest trace in trace_dir."""
    import jax

    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    data = jax.profiler.ProfileData.from_file(path)
    hit, spans = 0, []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if name_part in ev.name:
                    hit += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return hit / 1e9, busy / 1e9


def main(argv=None) -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genome-len", type=int, default=cs.GENOME_LEN)
    ap.add_argument("--trace-dir", default=".align_trace")
    args = ap.parse_args(argv)

    devs = cs.require_gpu()
    print(f"device: {devs[0].device_kind}; card: {cs.nvidia_smi()}", flush=True)

    import jax

    from bella_tpu import BellaConfig
    from bella_tpu.align import xdrop
    from bella_tpu.io.simulate import random_genome, sample_reads
    from bella_tpu.overlap.pairs import detect_overlaps
    from bella_tpu.utils.log import set_enabled

    set_enabled(False)
    g = random_genome(args.genome_len, seed=args.seed)
    reads, _ = sample_reads(
        g, round(cs.COVERAGE * args.genome_len / cs.MEAN_LEN),
        mean_len=cs.MEAN_LEN, min_len=cs.MIN_LEN, error_rate=cs.ERROR_RATE,
        seed=args.seed + 1,
    )
    cfg = BellaConfig(kmer_size=17, xdrop=7, error_rate=0.15,
                      lower_freq=2, upper_freq=8)
    pairs, _, _ = detect_overlaps(reads, cfg)
    padded, lens = xdrop.pad_reads(reads)
    print(f"corpus: {reads.num_reads} reads, {int(reads.offsets[-1])} bases, "
          f"{pairs.num_pairs} candidate pairs", flush=True)
    clock = cs.CompileClock()

    def run(backend, label):
        c = BellaConfig(kmer_size=17, xdrop=7, aligner_backend=backend)
        c0 = clock.seconds
        t0 = time.perf_counter()
        res = xdrop.align_candidates(padded, lens, pairs, c)
        wall = time.perf_counter() - t0
        print(f"{backend} ({label}): align {wall:.2f} s, of which compile "
              f"{clock.seconds - c0:.2f} s", flush=True)
        return res

    cuda = run("cuda", "cold")
    run("cuda", "warm")
    jax.profiler.start_trace(args.trace_dir)
    run("cuda", "warm, traced")
    jax.profiler.stop_trace()
    k_s, busy_s = device_seconds(args.trace_dir, "xdrop_extend_kernel")
    print(f"cuda (warm, traced): kernel device time {k_s:.3f} s, "
          f"device busy {busy_s:.3f} s", flush=True)
    ref = run("jax", "cold")
    for f in ("score", "beg_h", "end_h", "beg_v", "end_v"):
        if not np.array_equal(getattr(cuda, f), getattr(ref, f)):
            raise SystemExit(f"align_compare: backends differ in {f}")
    print("align_compare: results identical", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
