"""2-bit sequence / k-mer primitives, fully vectorized for the device.

Re-designs the reference ``Kmer`` class (kmercode/Kmer.hpp:30-132,
kmercode/Kmer.cpp:205-355) as array ops: a k-mer (k <= 32) is one uint64
holding 2-bit base codes, first base in the most-significant occupied
2-bit group, so unsigned integer compare == lexicographic string compare
(the property rep() relies on, kmercode/Kmer.cpp:314-317).

Base coding matches the reference bit trick (kmercode/Kmer.cpp:215-216):
A=0 C=1 G=2 T=3, computed branch-free from ASCII; like the reference,
'N' maps to G rather than being rejected.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

_U64 = jnp.uint64


def encode_bases(ascii_codes):
    """ASCII uint8 array -> 2-bit base codes (uint8, values 0..3).

    Branch-free mapping equivalent to kmercode/Kmer.cpp:215-216:
    code = x + ((x ^ (c & 2)) >> 1) with x = (c & 4) >> 1.
    Accepts upper or lower case (bit 0x20 is ignored by the trick).
    """
    c = jnp.asarray(ascii_codes, dtype=jnp.uint8)
    x = (c & 4) >> 1
    return (x + ((x ^ (c & 2)) >> 1)).astype(jnp.uint8)


def encode_bases_np(ascii_codes: np.ndarray) -> np.ndarray:
    """Numpy (host) version of :func:`encode_bases` for ingest paths."""
    c = np.asarray(ascii_codes, dtype=np.uint8)
    x = (c & 4) >> 1
    return (x + ((x ^ (c & 2)) >> 1)).astype(np.uint8)


def decode_bases(codes) -> np.ndarray:
    """2-bit codes -> ASCII uint8 ('A','C','G','T')."""
    return BASES[np.asarray(codes, dtype=np.uint8)]


def revcomp_codes(codes):
    """Reverse complement of a 2-bit code array (complement = c ^ 3)."""
    c = jnp.asarray(codes)
    return (c[::-1] ^ 3).astype(c.dtype)


def pack_kmers(codes, k: int):
    """All k-mers of a code sequence as packed uint64.

    codes: (N,) uint8 2-bit codes. Returns (N - k + 1,) uint64 where
    element p packs codes[p:p+k], first base most significant.

    k shifted adds -- fully parallel, replaces the 4-phase bit-shift
    batch extraction of kmercode/Kmer.cpp:232-298.
    """
    import jax

    c = jnp.asarray(codes, dtype=_U64)
    n_out = c.shape[0] - k + 1
    if n_out <= 0:
        return jnp.zeros((0,), dtype=_U64)

    # fori_loop, NOT an unrolled python loop: unrolled, XLA's allocation
    # plan keeps all k shifted temporaries alive (~k * 8 bytes/position);
    # the loop-carried
    # buffer is reused across iterations
    def body(t, val):
        w = jax.lax.dynamic_slice(c, (t,), (n_out,))
        return (val << _U64(2)) | w

    return jax.lax.fori_loop(0, k, body, jnp.zeros((n_out,), dtype=_U64))


def _bitrev2(x):
    """Reverse the order of the 32 2-bit groups of each uint64."""
    m2 = _U64(0x3333333333333333)
    m4 = _U64(0x0F0F0F0F0F0F0F0F)
    m8 = _U64(0x00FF00FF00FF00FF)
    m16 = _U64(0x0000FFFF0000FFFF)
    x = ((x & m2) << _U64(2)) | ((x >> _U64(2)) & m2)
    x = ((x & m4) << _U64(4)) | ((x >> _U64(4)) & m4)
    x = ((x & m8) << _U64(8)) | ((x >> _U64(8)) & m8)
    x = ((x & m16) << _U64(16)) | ((x >> _U64(16)) & m16)
    x = (x << _U64(32)) | (x >> _U64(32))
    return x


def kmer_mask(k: int):
    return _U64((1 << (2 * k)) - 1) if k < 32 else _U64(0xFFFFFFFFFFFFFFFF)


def revcomp_kmer(kmers, k: int):
    """Reverse complement of packed k-mers (the twin(),
    kmercode/Kmer.cpp:324-355), as pure bit ops: complement is ~x,
    base order reversal is a 2-bit-group reversal plus a shift."""
    x = jnp.asarray(kmers, dtype=_U64)
    return (_bitrev2(~x) >> _U64(64 - 2 * k)) & kmer_mask(k)


def canonical_kmers(kmers, k: int):
    """(canonical, is_rc): canonical = min(kmer, revcomp) -- the rep() of
    kmercode/Kmer.cpp:314-317; is_rc marks positions where the reverse
    complement was the smaller (needed later for strand voting)."""
    x = jnp.asarray(kmers, dtype=_U64)
    tw = revcomp_kmer(x, k)
    is_rc = tw < x
    return jnp.where(is_rc, tw, x), is_rc


def canonical_from_window(raw, k: int):
    """(canonical, is_rc) from a FIRST-BASE-LEAST-SIGNIFICANT window.

    `raw` packs k consecutive bases with the first base in the LOWEST
    2-bit group (the 4-phase sliding-window layout). In that layout the
    reverse complement needs NO bit reversal: complementing the window
    in place (~raw) yields comp(b_{k-1})..comp(b_0) read
    most-significant-first — exactly the twin as a number. Only the
    forward k-mer needs the 2-bit-group reversal, halving the dominant
    cost of the phased extractor (emulated-u64 bitrev chains)."""
    mask = kmer_mask(k)
    raw = jnp.asarray(raw, dtype=_U64) & mask
    fwd = _bitrev2(raw) >> _U64(64 - 2 * k)
    twin = (~raw) & mask
    is_rc = twin < fwd
    return jnp.where(is_rc, twin, fwd), is_rc


def hopc_kmers(codes, k: int):
    """Homopolymer-compressed canonical k-mers.

    For each window of k bases: drop bases equal to their predecessor,
    pack the compressed string (variable length L <= k), then take the
    canonical rep at length L (reference hopc(), kmercode/Kmer.cpp:465-474
    + toHOPC, kmercode/Kmer.hpp:169-182).

    Returns (packed, lengths, is_rc), each (N-k+1,). is_rc marks windows
    whose compressed twin was the smaller: compression commutes with
    reverse complement (run structure is strand-symmetric), so two
    occurrences of one canonical HOPC k-mer lie on opposite strands
    exactly when their is_rc flags differ — the strand decision the
    reference makes at align time by comparing raw seed substrings
    (include/align.hpp:168-174), made exact in HOPC space.
    """
    import jax

    c = jnp.asarray(codes, dtype=_U64)
    n_out = int(c.shape[0]) - k + 1
    if n_out <= 0:
        z = jnp.zeros((0,), dtype=_U64)
        return z, jnp.zeros((0,), dtype=jnp.int32), jnp.zeros((0,), bool)

    # fori_loop for buffer reuse (see pack_kmers)
    def body(t, carry):
        val, length, prev = carry
        cur = jax.lax.dynamic_slice(c, (t,), (n_out,))
        keep = cur != prev
        val = jnp.where(keep, (val << _U64(2)) | cur, val)
        length = length + keep.astype(jnp.int32)
        return val, length, cur

    val, length, _prev = jax.lax.fori_loop(
        0, k, body,
        (
            jnp.zeros((n_out,), dtype=_U64),
            jnp.zeros((n_out,), dtype=jnp.int32),
            jnp.full((n_out,), 255, dtype=_U64),  # sentinel != any base
        ),
    )
    # canonical rep at per-element length
    shift = (_U64(64) - _U64(2) * length.astype(_U64))
    tw = _bitrev2(~val) >> shift
    mask = jnp.where(
        length == 32,
        _U64(0xFFFFFFFFFFFFFFFF),
        (_U64(1) << (_U64(2) * length.astype(_U64))) - _U64(1),
    )
    tw = tw & mask
    is_rc = tw < val
    return jnp.minimum(val, tw), length, is_rc


def hash64(x):
    """64-bit avalanche hash (murmur3 finalizer constants) of uint64 keys.

    Fills the role of MurmurHash3_x64_64 (kmercode/hash_funcs.h:45) for
    minimizer ordering, syncmer tests, and split-count partitioning.
    Internal consistency is what matters; bit-compatibility with the
    reference hash is not required (selection is self-consistent).
    """
    h = jnp.asarray(x, dtype=_U64)
    h = h ^ (h >> _U64(33))
    h = h * _U64(0xFF51AFD7ED558CCD)
    h = h ^ (h >> _U64(33))
    h = h * _U64(0xC4CEB9FE1A85EC53)
    h = h ^ (h >> _U64(33))
    return h


# ----------------------------------------------------------------------
# Host-side helpers (tests / debugging)
# ----------------------------------------------------------------------

def string_to_kmer(s: str) -> int:
    """Pack an ACGT string (len <= 32) into the uint64 representation."""
    val = 0
    for ch in s:
        val = (val << 2) | int(encode_bases_np(np.frombuffer(ch.encode(), np.uint8))[0])
    return val


def kmer_to_string(val: int, k: int) -> str:
    out = []
    for t in range(k):
        out.append("ACGT"[(int(val) >> (2 * (k - 1 - t))) & 3])
    return "".join(out)
