"""End-to-end overlap pipeline driver.

Orchestrates the phases of src/main.cpp:65-535 (counting -> matrix ->
SpGEMM/chain -> align -> decide -> write) over the device stages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from bella_tpu.align.xdrop import align_candidates
from bella_tpu.config import BellaConfig
from bella_tpu.io import writers
from bella_tpu.io.fastq import ReadSet, read_files
from bella_tpu.kmers.count import build_reliable_triples, extract_occurrences
from bella_tpu.overlap.decision import post_align_decision, slope
from bella_tpu.overlap.pairs import CandidatePairs, generate_candidates
from bella_tpu.utils.log import log, phase


@dataclasses.dataclass
class PipelineResult:
    reads: ReadSet
    num_kmers: int
    nnz: int
    pairs: CandidatePairs
    rows: List[str]
    num_output: int
    alignment: Optional[object] = None  # AlignmentResult when aligned


def run_pipeline(
    reads: ReadSet, config: BellaConfig, output: Optional[str] = None
) -> PipelineResult:
    if output is not None:
        log("outputFile", output)
    if config.estimate_err and reads.err_bases:
        config.error_rate = reads.estimated_error_rate
        log("errorRate (estimated)", f"{config.error_rate:.6f}")

    if config.auto_bounds and reads.num_reads:
        from bella_tpu.kmers.bound import (
            compute_lower,
            compute_upper,
            estimate_coverage,
        )

        cov = config.coverage
        if not cov:
            with phase("coverageEstimation"):
                cov = estimate_coverage(reads, config)
            if cov <= 0:
                raise RuntimeError(
                    "--auto-bounds: no usable multiplicity signal to "
                    "estimate depth from; pass --coverage explicitly"
                )
            log("estimatedCoverage", cov)
        config.lower_freq = compute_lower(
            cov, config.error_rate, config.kmer_size, 0.002
        )
        config.upper_freq = compute_upper(
            cov, config.error_rate, config.kmer_size, 0.002
        )
        log("autoLowerBound", config.lower_freq)
        log("autoUpperBound", config.upper_freq)

    if config.profile_dir:
        import jax

        jax.profiler.start_trace(config.profile_dir)

    mesh = None
    if config.devices > 1:
        import jax

        from bella_tpu.parallel.sharded import make_mesh

        if len(jax.devices()) < config.devices:
            raise RuntimeError(
                f"--devices {config.devices} but only {len(jax.devices())} "
                "jax devices are visible"
            )
        mesh = make_mesh(config.devices)
        log("meshDevices", config.devices)

    total_bases = int(reads.offsets[-1]) if reads.num_reads else 0
    # birthday-collision regime check: with T k-mer positions in a 4^k
    # space, ~T^2/(2*4^k) UNRELATED position pairs share a k-mer by
    # chance; each collision fabricates a count-2 "reliable" k-mer and
    # junk candidate pairs (measured: 2.2 Gbp at k=17 fabricates ~1.3e8
    # of them and inflates candidates 20x — the reference's counting
    # has the identical failure mode, it just documents k=17 for a
    # 140 Mbp demo). Warn when chance collisions become material.
    exp_coll = total_bases * float(total_bases) / (2.0 * 4.0 ** config.kmer_size)
    if exp_coll > 0.02 * max(total_bases, 1):
        log(
            "kmerCollisionWarning",
            f"~{exp_coll:.2e} chance k-mer collisions expected at "
            f"{total_bases/1e9:.2f} Gbp with k={config.kmer_size}; "
            "use a larger -k (e.g. 21+) or raise -l",
        )

    # fused device path for the common configuration; the modular path
    # handles sparse selection, split-count staging, memory-staged
    # emission, matrix dump, and checkpoint/resume. The fused path
    # compacts reliable rows before pair emission, so its footprint is
    # ~100 B per k-mer position (sort operands + scratch), never the
    # expanded candidate stream.
    fused = (
        not (config.use_minimizer or config.use_syncmer)
        and config.split_count == 1
        and reads.num_reads > 0
        and config.write_matrix is None
        and config.checkpoint is None
    )
    # memory is handled inside detect_overlaps: single-pass fused within
    # the budget, the fused split-count path beyond it, host staging last
    if fused:
        from bella_tpu.overlap.pairs import detect_overlaps

        with phase("overlapDetection"):
            if mesh is not None:
                # distributed counting + SpGEMM + chaining over the mesh
                # (k-mer and pair all_to_all exchanges, parallel/dist.py)
                from bella_tpu.parallel.dist import detect_overlaps_sharded

                log("detectionPath", "distributed")
                pairs, num_kmers, nnz = detect_overlaps_sharded(
                    reads, config, mesh
                )
            else:
                pairs, num_kmers, nnz = detect_overlaps(reads, config)
        log("numReliableKmers", num_kmers)
        log("nnzA", nnz)
        log("candidatePairs", pairs.num_pairs)
        if pairs.num_pairs:
            # reference logs flops/nnz(C) as CompressionRatio (overlap.hpp:698)
            log(
                "compressionRatio",
                f"{nnz * (config.upper_freq - 1) / pairs.num_pairs:.2f}",
            )
        if num_kmers == 0:
            raise RuntimeError(
                "0 reliable k-mers: all frequencies outside "
                f"[{config.lower_freq}, {config.upper_freq}]; reduce k or bounds"
            )
        tri_num_kmers, tri_nnz = num_kmers, nnz
        if config.selfcheck:
            from bella_tpu.utils import selfcheck

            with phase("selfCheck"):
                selfcheck.check_detection(reads, config, num_kmers, nnz)
                selfcheck.check_pairs(reads, pairs, config)
    else:
        tri = None
        if config.checkpoint:
            from bella_tpu.io.matrixdump import load_checkpoint

            tri = load_checkpoint(config.checkpoint)
            if tri is not None:
                log("resumedFromCheckpoint", config.checkpoint)
        if tri is None:
            with phase("kmerCounting"):
                occ = extract_occurrences(reads, config)
                if config.use_minimizer or config.use_syncmer:
                    from bella_tpu.kmers.select import select_occurrences

                    occ = select_occurrences(occ, reads, config)
                tri = build_reliable_triples(reads, config, occ)
            if config.checkpoint:
                from bella_tpu.io.matrixdump import save_checkpoint

                save_checkpoint(config.checkpoint, tri)
                log("checkpointSaved", config.checkpoint)
        if config.write_matrix:
            from bella_tpu.io.matrixdump import dump_matrix_market

            dump_matrix_market(config.write_matrix, tri)
            log("matrixDumped", config.write_matrix)
        log("numReliableKmers", tri.num_kmers)
        log("nnzA", tri.nnz)
        if tri.num_kmers == 0:
            # reference exits with a diagnostic (include/kmercount.hpp:662-667)
            raise RuntimeError(
                "0 reliable k-mers: all frequencies outside "
                f"[{config.lower_freq}, {config.upper_freq}]; reduce k or bounds"
            )
        with phase("overlapDetection"):
            if mesh is not None:
                # selection paths build triples first; pair expansion +
                # chaining still distribute over the mesh
                from bella_tpu.parallel.sharded import sharded_candidates

                pairs = sharded_candidates(tri, reads.lengths, config, mesh)
            else:
                pairs = generate_candidates(tri, reads.lengths, config)
        log("candidatePairs", pairs.num_pairs)
        tri_num_kmers, tri_nnz = tri.num_kmers, tri.nnz
        if config.selfcheck:
            from bella_tpu.utils import selfcheck

            with phase("selfCheck"):
                if config.checkpoint is None:
                    # split passes partition by hash but cover every
                    # k-mer, so global stats still match the recount;
                    # a resumed checkpoint's source reads may differ
                    selfcheck.check_detection(
                        reads, config, tri.num_kmers, tri.nnz
                    )
                selfcheck.check_pairs(reads, pairs, config)

    aln = None
    num_output = 0
    rows: List[str] = []
    if config.skip_alignment:
        with phase("outputting"):
            num_output = pairs.num_pairs
            if output is not None and writers.write_overlap_native(output, reads, pairs):
                output = None  # written natively
            else:
                rows = writers.overlap_only_rows(pairs, reads)
    else:
        import time as _time

        t_aln = _time.perf_counter()
        with phase("alignment"):
            aln = align_candidates(
                None, reads.lengths.astype(np.int32), pairs, config,
                mesh=mesh, reads=reads,
            )
        dt_aln = _time.perf_counter() - t_aln
        if pairs.num_pairs and dt_aln > 0:
            # reference logs the alignment rate in bases/s (overlap.hpp:757-767)
            aligned_bases = int(
                (aln.end_h - aln.beg_h).sum() + (aln.end_v - aln.beg_v).sum()
            )
            log("alignmentRate", f"{aligned_bases / dt_aln:.0f} bases/s")
        with phase("decision"):
            dec = post_align_decision(
                aln, pairs.read_h, pairs.read_v, reads.lengths, config
            )
            passed = dec["passed"]
        log("alignedPairs", pairs.num_pairs)
        log("outputted", int(passed.sum()))
        with phase("outputting"):
            idx = np.flatnonzero(passed)
            num_output = len(idx)
            if config.output_paf:
                if output is not None and writers.write_paf_native(
                    output, reads,
                    pairs.read_h[idx], pairs.read_v[idx],
                    aln.score[idx], dec["overlap"][idx], aln.strand_rc[idx],
                    aln.beg_v[idx], aln.end_v[idx],
                    aln.beg_h[idx], aln.end_h[idx],
                ):
                    output = None  # written natively
                else:
                    rows = writers.paf_rows(
                        reads,
                        pairs.read_h[idx], pairs.read_v[idx],
                        aln.score[idx], dec["overlap"][idx], aln.strand_rc[idx],
                        aln.beg_v[idx], aln.end_v[idx],
                        aln.beg_h[idx], aln.end_h[idx],
                    )
            elif output is not None and writers.write_m4_native(
                output, reads,
                pairs.read_h[idx], pairs.read_v[idx], pairs.count[idx],
                aln.score[idx], dec["overlap"][idx], aln.strand_rc[idx],
                aln.beg_v[idx], aln.end_v[idx], aln.beg_h[idx], aln.end_h[idx],
            ):
                output = None  # written natively
            else:
                rows = writers.m4_rows(
                    reads,
                    pairs.read_h[idx], pairs.read_v[idx], pairs.count[idx],
                    aln.score[idx], dec["overlap"][idx], aln.strand_rc[idx],
                    aln.beg_v[idx], aln.end_v[idx], aln.beg_h[idx], aln.end_h[idx],
                )

    if output is not None:
        writers.write_rows(output, rows)

    if config.profile_dir:
        import jax

        jax.profiler.stop_trace()
        log("profileTrace", config.profile_dir)

    return PipelineResult(
        reads=reads,
        num_kmers=tri_num_kmers,
        nnz=tri_nnz,
        pairs=pairs,
        rows=rows,
        num_output=num_output,
        alignment=aln,
    )


def run_files(fofn: str, config: BellaConfig, output: str) -> PipelineResult:
    with phase("fastqParsing"):
        reads = read_files(fofn)
    log("numReads", reads.num_reads)
    return run_pipeline(reads, config, output)
