"""ctypes bindings for the native ingest/output runtime.

Builds fastq_native.cpp with g++ on first use into ``_build/`` (git-
ignored) under a name keyed by a hash of the source and the compiler
flags; the flags are portable (no -march=native), so a library copied
with the tree to another host still runs there, and an edited source
always rebuilds. Every entry point has a pure-numpy fallback, so the
package works without a C++ compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastq_native.cpp")
_FLAGS = ["-O3", "-pthread", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update("\0".join(_FLAGS).encode())
    return os.path.join(_DIR, "_build", f"libbella_native-{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_FLAGS, _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.fastq_scan.restype = ctypes.c_int
        lib.fastq_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fastq_parse.restype = ctypes.c_int64
        lib.write_m4.restype = ctypes.c_int64
        lib.write_paf.restype = ctypes.c_int64
        lib.write_overlap.restype = ctypes.c_int64
        _lib = lib
        return _lib


def parse_fastq_native(path: str):
    """Returns (names, codes, offsets, err_sum, err_bases) or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    nr = ctypes.c_int64()
    tb = ctypes.c_int64()
    if lib.fastq_scan(path.encode(), ctypes.byref(nr), ctypes.byref(tb)) != 0:
        return None
    num_reads, total_bases = nr.value, tb.value
    codes = np.empty(total_bases, dtype=np.uint8)
    offsets = np.zeros(num_reads + 1, dtype=np.int64)
    name_cap = max(os.path.getsize(path), 1)
    name_buf = ctypes.create_string_buffer(name_cap)
    name_offs = np.zeros(num_reads + 1, dtype=np.int64)
    err = ctypes.c_double()
    got = lib.fastq_parse(
        path.encode(),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        name_buf, ctypes.c_int64(name_cap),
        name_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(err),
    )
    if got < 0 or got != num_reads:
        return None
    raw = name_buf.raw
    names = [
        raw[name_offs[i] : name_offs[i + 1] - 1].decode()
        for i in range(num_reads)
    ]
    return names, codes, offsets, err.value, int(total_bases)
