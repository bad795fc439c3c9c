"""Command-line driver, flag-compatible with the reference binary
(src/main.cpp:74-94): `python -m bella_tpu.cli -f fofn -o out [-k 17 ...]`.

Output lands at <output>.out like the reference (src/main.cpp:112-131).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bella",
        description="BELLA on JAX: Long Read to Long Read Aligner and Overlapper",
    )
    ap.add_argument("-f", "--fastq", required=True, help="list of fastq(s) (fofn) or a single .fastq")
    ap.add_argument("-o", "--output", required=True, help="output filename (suffix .out added)")
    ap.add_argument("-k", "--kmer", type=int, default=17, help="k-mer length")
    ap.add_argument("-x", "--xdrop", type=int, default=7, help="x-drop value")
    ap.add_argument("-e", "--error", type=float, default=0.15, help="error rate")
    ap.add_argument("--estimate", action="store_true", help="estimate error rate from data")
    ap.add_argument("--skip-alignment", action="store_true", help="overlap only")
    ap.add_argument("-m", "--memory", type=int, default=0, help="staging budget in MB (0 = probe device memory, as the reference probes free RAM)")
    ap.add_argument("--score-deviation", type=float, default=0.1,
                    help="deviation from the mean alignment score [0,1]")
    ap.add_argument("-b", "--bin-size", type=int, default=500, help="bin size for binning algorithm")
    ap.add_argument("--paf", action="store_true", help="output in PAF format")
    ap.add_argument("-g", "--gpus", type=int, default=1,
                    help="accepted for flag parity; device count comes from jax")
    ap.add_argument("--devices", type=int, default=0,
                    help="run distributed over N mesh devices (0 = single)")
    ap.add_argument("--split-count", type=int, default=1, help="k-mer counting split count")
    ap.add_argument("--hopc", action="store_true", help="use HOPC representation")
    ap.add_argument("-w", "--window", type=int, default=0, help="minimizer window size")
    ap.add_argument("-s", "--syncmer", action="store_true", help="enable syncmer selection")
    ap.add_argument("-u", "--upper-freq", type=int, default=8, help="k-mer frequency upper bound")
    ap.add_argument("-l", "--lower-freq", type=int, default=2, help="k-mer frequency lower bound")
    ap.add_argument("--fixed-threshold", type=int, default=-1,
                    help="fixed alignment score threshold (debug)")
    ap.add_argument("--auto-bounds", action="store_true",
                    help="derive frequency bounds from coverage via the binomial "
                         "model (depth estimated from the data when --coverage "
                         "is not given)")
    ap.add_argument("--coverage", type=int, default=0,
                    help="dataset coverage for --auto-bounds (0 = estimate)")
    ap.add_argument("--band-width", type=int, default=128, help="aligner band width")
    ap.add_argument("--write-matrix", metavar="MTX",
                    help="dump the reads x reliable-kmers matrix (MatrixMarket)")
    ap.add_argument("--checkpoint", metavar="NPZ",
                    help="save/resume the reliable-triples phase checkpoint")
    ap.add_argument("--profile", metavar="DIR", help="write a jax.profiler trace")
    ap.add_argument("--selfcheck", action="store_true",
                    help="cross-validate device results against host "
                         "oracles (recount + seed + aligner checks; "
                         "debug mode, O(corpus) host work)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from bella_tpu.config import BellaConfig
    from bella_tpu.pipeline import run_files
    from bella_tpu.utils.log import log

    config = BellaConfig(
        kmer_size=args.kmer,
        xdrop=args.xdrop,
        error_rate=args.error,
        estimate_err=args.estimate,
        skip_alignment=args.skip_alignment,
        total_memory_mb=args.memory,
        delta_chernoff=args.score_deviation,
        bin_size=args.bin_size,
        output_paf=args.paf,
        split_count=args.split_count,
        use_hopc=args.hopc,
        window_len=args.window,
        use_syncmer=args.syncmer,
        upper_freq=args.upper_freq,
        lower_freq=args.lower_freq,
        fixed_threshold=args.fixed_threshold,
        band_width=args.band_width,
        write_matrix=args.write_matrix,
        checkpoint=args.checkpoint,
        profile_dir=args.profile,
        devices=args.devices,
        selfcheck=args.selfcheck,
    )
    if config.devices > 1:
        # multi-process runs need the distributed client before any
        # device work (no-op when coordinator env vars are absent)
        from bella_tpu.parallel.dist import init_distributed

        init_distributed()
    if args.auto_bounds:
        # bounds resolve in run_pipeline once reads are parsed: with
        # --coverage they come straight from the binomial model; without
        # it the depth itself is estimated from the corpus's exact
        # multiplicity statistics (kmers/bound.estimate_coverage)
        config.auto_bounds = True
        config.coverage = args.coverage

    out_path = args.output + ".out"
    if os.path.exists(out_path):
        os.remove(out_path)

    t0 = time.perf_counter()
    try:
        result = run_files(args.fastq, config, out_path)
    except (RuntimeError, FileNotFoundError) as e:
        # diagnostic + nonzero exit, as the reference does on empty
        # reliable sets / unopenable files (include/kmercount.hpp:89-94,
        # 662-667) — not a traceback
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    total = time.perf_counter() - t0
    log("TotalRuntime", f"{total:.3f} seconds")
    # bare machine-parsable values on stdout (pipeline-script protocol,
    # src/main.cpp:473,532)
    print(result.num_kmers)
    print(f"{total:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
