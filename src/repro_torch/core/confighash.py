"""Vectorized counter-based config hashing (threefry-2x32 lanes).

Numpy copy of :mod:`repro.core.confighash`: a 4-lane polynomial
compression over the packed ``uint32`` field words of a config batch,
finalized by two cross-keyed threefry-2x32-13 blocks.  The 128-bit digest
keys the synthesis caches and seeds the synthesis jitter, so it must stay
bit-identical to the reference (tested).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_ROUNDS = 13

_MULTIPLIERS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A)


def _rotl32(x, d: int):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k0, k1, x0, x1, rounds: int = _ROUNDS):
    """Threefry-2x32 block over wrapping ``uint32`` lanes."""
    u32 = np.uint32
    k0 = np.asarray(k0, dtype=u32)
    k1 = np.asarray(k1, dtype=u32)
    x0 = np.asarray(x0, dtype=u32) + k0
    x1 = np.asarray(x1, dtype=u32) + k1
    ks = (k0, k1, k0 ^ k1 ^ u32(_PARITY))
    for r in range((rounds + 3) // 4):
        rots = _ROTATIONS[:4] if r % 2 == 0 else _ROTATIONS[4:]
        for rot in rots[:min(4, rounds - 4 * r)]:
            x0 = x0 + x1
            x1 = _rotl32(x1, rot) ^ x0
        x0 = x0 + ks[(r + 1) % 3]
        x1 = x1 + ks[(r + 2) % 3] + u32(r + 1)
    return x0, x1


def digest_words(words):
    """128-bit digest ``(d0, d1, d2, d3)`` of a sequence of uint32 word
    arrays."""
    u32 = np.uint32
    words = [np.asarray(w, dtype=u32) for w in words]
    # length word guards against trailing-zero ambiguity between schemas
    words.append(np.asarray(u32(len(words))))
    h = [np.asarray(u32(iv)) for iv in _IV]
    cs = [u32(c) for c in _MULTIPLIERS]
    for w in words:
        h = [hi * ci + w for hi, ci in zip(h, cs)]
    a0, a1 = threefry2x32(h[2], h[3], h[0], h[1])
    b0, b1 = threefry2x32(h[0] ^ u32(_PARITY), h[1], h[2], h[3])
    return a0, a1, b0, b1


def uniform01(lane, dtype=np.float64):
    """Uniform variate in [0, 1) from the high 24 bits of a digest lane."""
    return (np.asarray(lane, dtype=np.uint32) >> np.uint32(8)) \
        .astype(dtype) * dtype(2.0 ** -24)


def f64_words(x) -> tuple[np.ndarray, np.ndarray]:
    """Split a float64 array into (lo, hi) uint32 words; NaNs canonical."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    x = np.where(np.isnan(x), np.float64(np.nan), x)
    bits = x.view(np.uint64)
    return (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32), \
        (bits >> np.uint64(32)).astype(np.uint32)


def pack_config_words(soa: dict) -> list[np.ndarray]:
    """The packed uint32 field words of a config batch (every identity
    field, ``clock_cap`` included)."""
    ints = ["pe_type_idx", "pe_rows", "pe_cols", "ifmap_spad",
            "filter_spad", "psum_spad", "glb_kb"]
    words: list[np.ndarray] = [
        np.asarray(soa[k]).astype(np.uint32) for k in ints]
    for k in ("dram_bw_gbps", "clock_cap"):
        lo, hi = f64_words(soa[k])
        words.extend((lo, hi))
    return words


def config_digests(soa: dict):
    """128-bit digests for a config batch: ``(d0, d1, d2, d3)`` uint32."""
    return digest_words(pack_config_words(soa))


def digests_to_u64(d) -> np.ndarray:
    """Stack a 4-lane digest into an ``(N, 2)`` uint64 array (npz format)."""
    d0, d1, d2, d3 = (np.asarray(x, dtype=np.uint64) for x in d)
    return np.stack([(d1 << np.uint64(32)) | d0,
                     (d3 << np.uint64(32)) | d2], axis=-1)


def digest_keys(d) -> list[bytes]:
    """Per-config 16-byte cache keys from a 4-lane digest."""
    flat = np.ascontiguousarray(digests_to_u64(d))
    buf = flat.tobytes()
    return [buf[i:i + 16] for i in range(0, len(buf), 16)]
