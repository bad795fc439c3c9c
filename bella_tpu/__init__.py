"""bella_tpu — a long-read overlap/alignment framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of PASSIONLab/BELLA
(a C++/OpenMP/CUDA shared-memory pipeline), run on an NVIDIA GPU.

Pipeline (mirrors reference README.md:97-109):
  1. ingest FASTQ reads                         (host, numpy + native C parser)
  2. k-mer extraction + reliable-k-mer counting (device, sort-based exact)
  3. reads x kmers sparse matrix                (device, sort + prefix sums)
  4. candidate-pair generation = A @ A^T with a positional semiring
     (device, sort-based SpGEMM over bounded-occurrence k-mer segments)
  5. chaining/binning -> one seed per pair      (device, segment ops)
  6. batched banded x-drop seed-and-extend      (device, CUDA kernel)
  7. adaptive Chernoff-bound score threshold + M4/PAF output (host)

The library uses 64-bit integers for packed k-mers (k <= 32, 2 bits/base,
reference kmercode/Kmer.hpp:30-132), so x64 mode is enabled at import.

JAX's persistent compilation cache goes where JAX_COMPILATION_CACHE_DIR
says; without it, to ``.jax_cache`` at the root of the checkout.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)

CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from bella_tpu.config import BellaConfig  # noqa: E402

__version__ = "0.1.0"
__all__ = ["BellaConfig", "__version__"]
