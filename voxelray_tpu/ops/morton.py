"""Morton (Z-order) encode/decode for the octree encoding.

The reference interleaves 21 bits per axis into a 64-bit code via three
256-entry byte LUTs (src/octTree.hpp:21-127, 211-218) and decodes with a
magic-bits compaction (octTree.hpp:220-238).  On a vector device the LUT
gathers are extra memory traffic, so encoding uses the classic magic-bits
*spread* — bit-identical codes, different mechanics.

JAX is configured without x64 by default, so codes are carried as a pair
of uint32 (hi, lo) limbs: hi holds code bits [32, 63), lo bits [0, 32).
Helpers convert to numpy uint64 on the host for convenience.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["morton_encode3", "morton_decode3", "morton_encode3_np",
           "morton_decode3_np", "spread_bits_np", "sort_codes_device"]


def spread_bits_np(v: np.ndarray) -> np.ndarray:
    """Insert two zero bits between each of the low 21 bits (uint64)."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def _compact_bits_np(v: np.ndarray) -> np.ndarray:
    """Inverse of spread_bits_np (the reference's compactBits,
    octTree.hpp:220-238)."""
    v = v.astype(np.uint64) & np.uint64(0x1249249249249249)
    v = (v ^ (v >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    v = (v ^ (v >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    v = (v ^ (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    v = (v ^ (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    v = (v ^ (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return v


def morton_encode3_np(x, y, z) -> np.ndarray:
    """uint64 Morton codes: bit 3k = x_k, 3k+1 = y_k, 3k+2 = z_k —
    the same bit layout as morton3D (octTree.hpp:211-218)."""
    return (spread_bits_np(np.asarray(x))
            | (spread_bits_np(np.asarray(y)) << np.uint64(1))
            | (spread_bits_np(np.asarray(z)) << np.uint64(2)))


def morton_decode3_np(code):
    code = np.asarray(code, dtype=np.uint64)
    return (_compact_bits_np(code),
            _compact_bits_np(code >> np.uint64(1)),
            _compact_bits_np(code >> np.uint64(2)))


def _spread10(v):
    """Insert two zeros between each of the low 10 bits (uint32 lanes)."""
    v = v.astype(jnp.uint32) & jnp.uint32(0x3FF)
    v = (v | (v << 16)) & jnp.uint32(0x30000FF)
    v = (v | (v << 8)) & jnp.uint32(0x300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x30C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x9249249)
    return v


def morton_encode3(x, y, z):
    """Device-side encode -> (hi, lo) uint32 limbs of the 63-bit code.

    Each 21-bit coordinate splits into bits [0,10) -> code bits [0,30),
    bits [10,20) -> code bits [30,60), and bit 20 -> code bits 60/61/62.
    Bit layout matches morton_encode3_np exactly.
    """
    x = x.astype(jnp.uint32)
    y = y.astype(jnp.uint32)
    z = z.astype(jnp.uint32)
    lo_part = (_spread10(x) | (_spread10(y) << 1) | (_spread10(z) << 2))
    mid_part = (_spread10(x >> 10) | (_spread10(y >> 10) << 1)
                | (_spread10(z >> 10) << 2))  # code bits [30, 60)
    lo = lo_part | (mid_part << 30)
    hi = (mid_part >> 2) \
        | (((x >> 20) & 1) << 28) \
        | (((y >> 20) & 1) << 29) \
        | (((z >> 20) & 1) << 30)
    return hi, lo


def sort_codes_device(hi, lo):
    """On-device lexicographic sort of (hi, lo) uint32 Morton limb pairs.

    The device analog of the reference's only parallel sort,
    std::sort(std::execution::par_unseq) over 64-bit Morton keys
    (octTree.hpp:363-364): jax.lax.sort with both limbs as keys (hi major)
    gives exactly the uint64 ascending order.  Callers routing invalid
    items to the (0xFFFFFFFF, 0xFFFFFFFF) sentinel get them sorted last
    (valid 63-bit codes have hi <= 0x7FFFFFFF).
    """
    import jax

    hi = jnp.asarray(hi, jnp.uint32)
    lo = jnp.asarray(lo, jnp.uint32)
    return jax.lax.sort((hi, lo), num_keys=2)


def _compact10(v):
    v = v.astype(jnp.uint32) & jnp.uint32(0x9249249)
    v = (v ^ (v >> 2)) & jnp.uint32(0x30C30C3)
    v = (v ^ (v >> 4)) & jnp.uint32(0x300F00F)
    v = (v ^ (v >> 8)) & jnp.uint32(0x30000FF)
    v = (v ^ (v >> 16)) & jnp.uint32(0x3FF)
    return v


def morton_decode3(hi, lo):
    """Device-side decode of (hi, lo) uint32 limbs -> (x, y, z) uint32."""
    hi = hi.astype(jnp.uint32)
    lo = lo.astype(jnp.uint32)
    lo_part = lo & jnp.uint32(0x3FFFFFFF)                    # code [0, 30)
    mid_part = (lo >> 30) | ((hi & jnp.uint32(0x0FFFFFFF)) << 2)  # [30, 60)
    x = _compact10(lo_part) | (_compact10(mid_part) << 10) \
        | (((hi >> 28) & 1) << 20)
    y = _compact10(lo_part >> 1) | (_compact10(mid_part >> 1) << 10) \
        | (((hi >> 29) & 1) << 20)
    z = _compact10(lo_part >> 2) | (_compact10(mid_part >> 2) << 10) \
        | (((hi >> 30) & 1) << 20)
    return x, y, z
