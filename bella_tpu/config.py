"""Run configuration.

Mirrors the reference's ``BELLApars`` struct (include/common/common.h:46-74)
and the CLI flag set (src/main.cpp:74-94), plus device knobs (band
width, batch sizes, aligner backend) and a staging budget probed from
the device in place of the reference's free-RAM probing
(include/overlap.hpp:365-404).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class BellaConfig:
    # --- reference BELLApars (include/common/common.h:46-74) ---
    kmer_size: int = 17            # -k
    bin_size: int = 500            # -b  chaining bin width
    fixed_threshold: int = -1      # debug-only fixed alignment score cutoff
    xdrop: int = 7                 # -x
    split_count: int = 1           # --split-count  k-mer-space passes
    estimate_err: bool = False     # --estimate  (error rate from quals)
    skip_alignment: bool = False   # --skip-alignment  overlap-only output
    output_paf: bool = False       # --paf
    use_hopc: bool = False         # --hopc homopolymer-compressed k-mers
    delta_chernoff: float = 0.10   # --score-deviation
    total_memory_mb: float = 0.0   # -m  staging budget; 0 = probe the
                                   # device (the reference probes free
                                   # RAM the same way unless -m is
                                   # given, include/overlap.hpp:365-404)
    error_rate: float = 0.15       # -e
    hopc_error_rate: float = 0.035 # error rate used when use_hopc is on
    use_syncmer: bool = False      # -s
    use_minimizer: bool = False    # set when window_len > 0
    window_len: int = 0            # -w  minimizer window
    lower_freq: int = 2            # -l  reliable k-mer lower bound
    upper_freq: int = 8            # -u  reliable k-mer upper bound
    smer_len: int = 5              # syncmer s-mer length (include/syncmer.hpp:47)
    auto_bounds: bool = False      # --auto-bounds  derive [lower,upper] from
                                   # coverage via the binomial model
                                   # (kmercode/bound.cpp:40-95)
    coverage: int = 0              # --coverage for --auto-bounds; 0 =
                                   # estimate depth from the corpus's exact
                                   # multiplicity stats (kmers/bound.py
                                   # estimate_coverage)

    # --- device knobs (no reference equivalent; replace RAM probing) ---
    band_width: int = 128          # x-drop aligner band (cells); ref uses 31
                                   # (xavier/simdutils.h:22-31); the CUDA
                                   # kernel takes 32, 64, 128 or 256
    aligner_backend: str = "auto"  # auto | cuda | jax  (auto = the CUDA
                                   # kernel on a GPU, the plain-JAX
                                   # extend_batch elsewhere)
    align_batch: int = 4096        # alignment pairs per device batch
                                   # (ref: 30000/GPU, include/align.hpp:35)
    max_steps: Optional[int] = None  # wavefront step cap; None = len-derived
                                   # (2 * padded read length, xdrop.py)
    selfcheck: bool = False        # --selfcheck  cross-validate device
                                   # results against host numpy oracles
                                   # (utils/selfcheck.py; the sanitizer/
                                   # serial-mode role of makefile-nersc:
                                   # 17-23,70) and the aligner against
                                   # extend_batch — debug mode, O(corpus)
                                   # host work
    devices: int = 0               # --devices  mesh size for distributed
                                   # detection + data-parallel alignment
                                   # (0/1 = single-device pipeline)
    seed: int = 0                  # PRNG seed for synthetic generators
    write_matrix: Optional[str] = None  # dump reads x kmers matrix (bellaio)
    checkpoint: Optional[str] = None    # save/resume reliable triples (npz)
    profile_dir: Optional[str] = None   # jax.profiler trace directory

    def __post_init__(self):
        if self.kmer_size < 1 or self.kmer_size > 32:
            raise ValueError("kmer_size must be in [1, 32] (2-bit packed uint64)")
        if self.window_len:
            self.use_minimizer = True
        if self.use_syncmer:
            self.use_minimizer = False
        if not (0.0 <= self.delta_chernoff <= 1.0):
            raise ValueError("delta_chernoff must be in [0, 1]")
        if self.aligner_backend not in ("auto", "cuda", "jax"):
            raise ValueError(
                "aligner_backend must be auto, cuda or jax, got "
                f"{self.aligner_backend!r}"
            )

    @property
    def effective_error_rate(self) -> float:
        """Error rate driving the adaptive threshold (src/main.cpp:307-314)."""
        return self.hopc_error_rate if self.use_hopc else self.error_rate

    @property
    def effective_memory_mb(self) -> float:
        """Staging budget: the -m flag when given, else the device's
        memory (estimateMemory parity, include/overlap.hpp:365-404)."""
        if self.total_memory_mb > 0:
            return self.total_memory_mb
        global _PROBED_MEMORY_MB
        if _PROBED_MEMORY_MB is None:
            import jax

            _PROBED_MEMORY_MB = device_memory_mb(jax.devices()[0])
        return _PROBED_MEMORY_MB


_PROBED_MEMORY_MB: Optional[float] = None
CPU_MEMORY_MB = 8000.0  # the reference's 8 GB default, for the CPU only


def device_memory_mb(dev) -> float:
    """What JAX may allocate on `dev` (``bytes_limit`` of its memory
    stats: on a GPU, the share of the card JAX reserved). The CPU, which
    reports no limit, gets the reference's 8 GB default; any other
    device without a limit is an error, never an assumed size."""
    stats = dev.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit:
        return limit / 1e6
    if dev.platform == "cpu":
        return CPU_MEMORY_MB
    raise RuntimeError(
        f"{dev.platform} device {dev.device_kind!r} reports no bytes_limit; "
        "pass the staging budget with -m MB"
    )
