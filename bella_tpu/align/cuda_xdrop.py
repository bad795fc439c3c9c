"""Build, load and call the Hopper x-drop kernel (cuda/xdrop.cu).

The kernel computes exactly what ``xdrop.extend_batch`` computes; see
the source for its layout. The shared library is compiled with nvcc at
first use, into ``cuda/_build/`` (git-ignored) under a name keyed by a
hash of the source and the compiler flags, so an edited source or flag
always rebuilds and a stale library is never loaded. Build it ahead of
a run with ``python -m bella_tpu.align.cuda_xdrop``.

A CUDA kernel has no interpret mode: off the GPU this module is only
reachable through ``aligner_backend="cuda"``, which raises there
(xdrop.resolve_aligner_backend).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

SOURCE = Path(__file__).with_name("cuda") / "xdrop.cu"
BUILD_DIR = SOURCE.parent / "_build"
TARGET = "bella_xdrop_extend"
SYMBOL = "BellaXdropExtend"
BANDS = (32, 64, 128, 256)

_LOCK = threading.Lock()
_LIB = None  # the loaded library; held so it is never unloaded


def nvcc_path() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA aligner cannot be built"
        )
    return path


def nvcc_flags() -> list:
    return [
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(),
    ]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join(nvcc_flags()).encode())
    return BUILD_DIR / f"libbella_xdrop-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless this source and these flags
    were already built; returns its path. Raises on a failed build."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # see a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *nvcc_flags(), "-o", tmp, str(SOURCE)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                f"{r.stdout}{r.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def register() -> None:
    """Build (if needed), load and register the FFI target, once per
    process."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return
        lib = ctypes.cdll.LoadLibrary(str(build()))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(getattr(lib, SYMBOL)), platform="CUDA"
        )
        _LIB = lib


def extend_batch_cuda(
    T, t_len, Q, q_len, xdrop: int,
    band: int = 128,
    max_steps: int = 0,
    match: int = 1,
    mismatch: int = -1,
    gap: int = -1,
):
    """``xdrop.extend_batch`` on the CUDA kernel: same arguments, same
    results (xdrop, band and max_steps are static here)."""
    if band not in BANDS:
        raise ValueError(f"CUDA aligner band must be one of {BANDS}, got {band}")
    B, L = T.shape
    if L < 1:
        raise ValueError("sequence width must be >= 1")
    if max_steps <= 0:
        max_steps = 2 * L
    register()
    out = jax.ffi.ffi_call(
        TARGET, tuple(jax.ShapeDtypeStruct((B,), jnp.int32) for _ in range(3)),
    )(
        T.astype(jnp.int8), t_len.astype(jnp.int32),
        Q.astype(jnp.int8), q_len.astype(jnp.int32),
        band=np.int32(band), xdrop=np.int32(xdrop),
        max_steps=np.int32(max_steps), match=np.int32(match),
        mismatch=np.int32(mismatch), gap=np.int32(gap),
    )
    return dict(score=out[0], t_end=out[1], q_end=out[2])


if __name__ == "__main__":
    print(build())
