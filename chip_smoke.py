#!/usr/bin/env python3
"""Prove on an NVIDIA GPU that the overlap+align pipeline runs and is right.

    python chip_smoke.py [--seed N] [--genome-len BASES]
    python chip_smoke.py --four-cards

One process, which alone touches the card. Phases, in order; any failure
exits non-zero before the last line is printed:

1. Device: JAX's first device must be a GPU. Prints its kind and count,
   and the card's name and power limit from nvidia-smi.
2. Kernel: on the real candidate pairs of the corpus below, compiles the
   batch step of the CUDA x-drop aligner at every length tier the corpus
   uses (band 128, batch 4096), prints the step's memory analysis, and
   runs it and the plain-JAX reference extend_batch through the same
   wrapper. The DP is int32 throughout, so the comparison is exact: the
   tolerance is zero for score, t_end and q_end of every pair and both
   extension directions.
3. Main path: simulated PacBio-CLR-class reads (a 4.6 Mbp random genome,
   E. coli's size; 30X, gamma read lengths of mean 6 kb and at least
   1 kb, 15% error: ~23k reads, ~138 Mbp) go through the CLI
   (`python -m bella_tpu.cli -k 17 -x 7 -e 0.15 -l 2 -u 8`, M4 output)
   twice in this process, cold (JAX's in-memory caches cleared first)
   and warm. Prints wall and compile time,
   the phase times, the candidate pairs, the detection rung, the
   aligner and peak device memory, and scores the output against the
   simulated truth at the 2 kb cutoff: recall and precision must both
   reach 95%.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

--four-cards runs only the multi-card path: the same corpus through the
pipeline with --devices 4 (one process driving four cards) and on one
card, and requires identical candidate pairs and output rows.

--genome-len cuts the corpus (only the genome length; coverage, read
lengths, error rate, k and bounds stay) for runs that must be shorter;
the default is the full 4.6 Mbp.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

GENOME_LEN = 4_600_000
COVERAGE = 30
MEAN_LEN = 6000
MIN_LEN = 1000
ERROR_RATE = 0.15
CLI_ARGS = ["-k", "17", "-x", "7", "-e", "0.15", "-l", "2", "-u", "8"]
MIN_RC_PR = 95.0
EVAL_CUTOFF = 2000
KERNEL_BATCH = 4096
KERNEL_BAND = 128


def say(*a) -> None:
    print(*a, flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, read by nvidia-smi (not JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu():
    """JAX's devices, or SystemExit when the first one is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX's device is {devs[0].platform}"
        )
    return devs


def last_line(devs) -> str:
    d = devs[0]
    return json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devs)},
    })


def make_corpus(workdir: str, genome_len: int, seed: int):
    """Simulate the corpus; write FASTQ, fofn and truth into workdir.
    Returns (reads, fofn, truth_path)."""
    from bella_tpu.io.simulate import random_genome, sample_reads, write_fastq, write_truth

    genome = random_genome(genome_len, seed=seed)
    n_reads = max(1, round(COVERAGE * genome_len / MEAN_LEN))
    reads, truth = sample_reads(
        genome, n_reads, mean_len=MEAN_LEN, min_len=MIN_LEN,
        error_rate=ERROR_RATE, seed=seed + 1,
    )
    fastq = os.path.join(workdir, "reads.fastq")
    write_fastq(fastq, reads)
    fofn = os.path.join(workdir, "reads.fofn")
    with open(fofn, "w") as f:
        f.write(fastq + "\n")
    truth_path = os.path.join(workdir, "truth.txt")
    write_truth(truth_path, truth)
    return reads, fofn, truth_path


def score_output(out_path: str, truth_path: str):
    """Recall/precision of an M4 output against the simulated truth."""
    from bella_tpu.eval.evaluate import evaluate_sets, load_truth, parse_bella, truth_pairs

    G = truth_pairs(load_truth(truth_path), min_overlap=EVAL_CUTOFF)
    S = parse_bella(out_path, min_overlap=EVAL_CUTOFF)
    return evaluate_sets(S, G, duplicate=True)


def peak_bytes():
    """The process's peak device memory so far (JAX cannot reset it)."""
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.seconds = 0.0

        def on_event(event, duration, **kwargs):
            if event in self.EVENTS:
                self.seconds += duration

        jax.monitoring.register_event_duration_secs_listener(on_event)


def kernel_phase(reads) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bella_tpu import BellaConfig
    from bella_tpu.align import xdrop
    from bella_tpu.overlap.pairs import detect_overlaps

    cfg = BellaConfig(kmer_size=17, xdrop=7, error_rate=0.15, lower_freq=2, upper_freq=8)
    t0 = time.perf_counter()
    pairs, _, _ = detect_overlaps(reads, cfg)
    say(f"kernel: {pairs.num_pairs} candidate pairs "
        f"(detection {time.perf_counter() - t0:.1f} s incl. compile; "
        f"process peak device memory {peak_bytes()} bytes)")
    if pairs.num_pairs == 0:
        raise SystemExit("chip_smoke: no candidate pairs")
    padded, lens = xdrop.pad_reads(reads)
    reads_dev, lens_dev = jnp.asarray(padded), jnp.asarray(lens)
    lmax = padded.shape[1]
    pair_len = np.maximum(lens[pairs.read_h], lens[pairs.read_v])
    pair_tier = xdrop._length_tier(pair_len, lmax)
    tiers = sorted(int(t) for t in np.unique(xdrop._length_tier(lens, lmax)))
    say(f"kernel: length tiers {tiers}, band {KERNEL_BAND}, batch {KERNEL_BATCH}; "
        "int32 DP, no floating point: tolerance zero")
    statics = dict(xdrop=cfg.xdrop, kmer_size=cfg.kmer_size, band=KERNEL_BAND,
                   max_steps=0)

    def raw(backend, seq_len):
        def f(r, l, b):
            _, left, right = xdrop.extend_pairs(
                r, l, b, seq_len=seq_len, backend=backend, **statics)
            return jnp.stack([left["score"], left["t_end"], left["q_end"],
                              right["score"], right["t_end"], right["q_end"]])
        return jax.jit(f)

    checked = 0
    for t in tiers:
        sel = np.nonzero(pair_tier == t)[0][:KERNEL_BATCH]
        n = len(sel)
        selp = np.concatenate([sel, np.zeros(KERNEL_BATCH - n, sel.dtype)])
        blk = jnp.asarray(xdrop._pair_block(pairs, selp, np.arange(KERNEL_BATCH) < n))
        t0 = time.perf_counter()
        step = xdrop._seed_extend_batch.lower(
            reads_dev, lens_dev, blk, seq_len=t, backend="cuda", **statics
        ).compile()
        say(f"kernel: tier {t}: align step compiled in {time.perf_counter() - t0:.1f} s; "
            f"memory_analysis: {step.memory_analysis()}")
        if n == 0:
            say(f"kernel: tier {t}: no candidate pair at this tier")
            continue
        step(reads_dev, lens_dev, blk).block_until_ready()
        t0 = time.perf_counter()
        got = np.asarray(raw("cuda", t)(reads_dev, lens_dev, blk))[:, :n]
        t_cuda = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = np.asarray(raw("jax", t)(reads_dev, lens_dev, blk))[:, :n]
        t_jax = time.perf_counter() - t0
        bad = np.nonzero((got != ref).any(axis=0))[0]
        say(f"kernel: tier {t}: {n} pairs x 2 directions, cuda {t_cuda:.2f} s, "
            f"extend_batch {t_jax:.2f} s (both incl. compile), {len(bad)} differ")
        if len(bad):
            i = int(bad[0])
            raise SystemExit(
                f"chip_smoke: kernel differs from extend_batch on {len(bad)}/{n} "
                f"pairs; first: {got[:, i].tolist()} vs {ref[:, i].tolist()}"
            )
        checked += n
    say(f"kernel: OK, {checked} pairs equal to extend_batch "
        "(score, t_end, q_end, both directions); "
        f"process peak device memory {peak_bytes()} bytes")


def main_path_phase(fofn: str, truth_path: str, workdir: str) -> None:
    from bella_tpu import cli
    from bella_tpu.utils import log as blog

    clock = CompileClock()
    for run in ("cold", "warm"):
        out = os.path.join(workdir, f"{run}")
        blog.PHASE_SECONDS.clear()
        blog.LAST.clear()
        before = peak_bytes()
        c0 = clock.seconds
        t0 = time.perf_counter()
        rc = cli.main(["-f", fofn, "-o", out, *CLI_ARGS])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"chip_smoke: CLI exited {rc} on the {run} run")
        peak = peak_bytes()
        m = score_output(out + ".out", truth_path)
        phases = ", ".join(f"{k} {v:.2f} s" for k, v in blog.PHASE_SECONDS.items())
        say(f"main/{run}: wall {wall:.2f} s, compile {clock.seconds - c0:.2f} s")
        say(f"main/{run}: phases: {phases}")
        say(f"main/{run}: candidate pairs {blog.LAST.get('candidatePairs')}, "
            f"detection rung {blog.LAST.get('detectionPath')}, "
            f"aligner {blog.LAST.get('alignerBackend')}, "
            f"rows out {blog.LAST.get('outputted')}")
        raised = "raised by this run" if peak > before else "not raised by this run"
        say(f"main/{run}: peak device memory {peak} bytes "
            f"(process peak, kernel phase included; {raised})")
        say(f"main/{run}: {m} at the {EVAL_CUTOFF} bp cutoff")
        if m.recall < MIN_RC_PR or m.precision < MIN_RC_PR:
            raise SystemExit(
                f"chip_smoke: recall {m.recall:.2f}% / precision "
                f"{m.precision:.2f}% below {MIN_RC_PR}%"
            )


def four_card_phase(fofn: str, workdir: str, devs) -> None:
    import numpy as np

    from bella_tpu import BellaConfig
    from bella_tpu.pipeline import run_files

    if len(devs) < 4:
        raise SystemExit(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devs)}")
    results = {}
    for n in (4, 1):
        cfg = BellaConfig(kmer_size=17, xdrop=7, error_rate=0.15,
                          lower_freq=2, upper_freq=8, devices=n)
        out = os.path.join(workdir, f"dev{n}.out")
        t0 = time.perf_counter()
        res = run_files(fofn, cfg, out)
        say(f"four-cards: --devices {n}: {res.pairs.num_pairs} candidate pairs, "
            f"{res.num_output} rows, {time.perf_counter() - t0:.1f} s incl. compile")
        p = res.pairs
        order = np.lexsort((p.read_v, p.read_h))
        cols = np.stack([getattr(p, f)[order].astype(np.int64) for f in (
            "read_h", "read_v", "pos_h", "pos_v", "count", "matches",
            "overlap_est", "seed_rc")])
        with open(out) as f:
            rows = sorted(f.read().splitlines())
        results[n] = (cols, rows)
    (c4, r4), (c1, r1) = results[4], results[1]
    if c4.shape != c1.shape or not np.array_equal(c4, c1):
        raise SystemExit("chip_smoke: candidate pairs differ between 4 cards and 1")
    if r4 != r1:
        raise SystemExit("chip_smoke: output rows differ between 4 cards and 1")
    say(f"four-cards: OK, {c1.shape[1]} candidate pairs and {len(r1)} output rows "
        "identical on 4 cards and on 1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genome-len", type=int, default=GENOME_LEN)
    ap.add_argument("--four-cards", action="store_true")
    args = ap.parse_args(argv)
    if args.genome_len < 1_000_000:
        raise SystemExit("chip_smoke: --genome-len is cut no lower than 1 Mbp")

    devs = require_gpu()
    say(f"device: {devs[0].device_kind}, {len(devs)} device(s)")
    say(f"card: {nvidia_smi()}")

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        t0 = time.perf_counter()
        reads, fofn, truth_path = make_corpus(workdir, args.genome_len, args.seed)
        say(f"corpus: {reads.num_reads} reads, {int(reads.offsets[-1])} bases "
            f"(genome {args.genome_len}, seed {args.seed}), "
            f"made in {time.perf_counter() - t0:.1f} s")
        if args.four_cards:
            four_card_phase(fofn, workdir, devs)
        else:
            kernel_phase(reads)
            # the CLI's first run then compiles its own programs (from
            # the persistent compile cache where it holds them)
            import jax

            jax.clear_caches()
            main_path_phase(fofn, truth_path, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(last_line(devs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
