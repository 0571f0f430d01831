"""The invertible 64-bit k-mer hash.

This is the minimap2-style Thomas Wang hash the reference applies to the
canonical (min of forward / reverse-complement) 2-bit k-mer encoding
(reference: vendor/KseqHashIterator.hpp:129-139).  Only shifts, adds, xors
and masks.

Two implementations with identical results:
  * :func:`hash64_np` — vectorized numpy (golden model, table construction)
  * :func:`hash64_jnp` — jnp, used inside jitted device kernels
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def kmer_mask(k: int) -> np.uint64:
    """2k-bit mask; valid for k <= 32 (src/ntSeqMatchCount.cpp:147-150)."""
    if not 0 < k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")
    if k == 32:
        return _U64(0xFFFFFFFFFFFFFFFF)
    return _U64((1 << (2 * k)) - 1)


def hash64_np(key: np.ndarray, mask: np.uint64) -> np.ndarray:
    """hash64 on a uint64 numpy array (vendor/KseqHashIterator.hpp:129-139)."""
    key = np.asarray(key, dtype=_U64)
    key = (~key + (key << _U64(21))) & mask
    key = key ^ (key >> _U64(24))
    key = ((key + (key << _U64(3))) + (key << _U64(8))) & mask
    key = key ^ (key >> _U64(14))
    key = ((key + (key << _U64(2))) + (key << _U64(4))) & mask
    key = key ^ (key >> _U64(28))
    key = (key + (key << _U64(31))) & mask
    return key


def hash64_jnp(key, mask):
    """Same transform for traced uint64 arrays inside jitted bodies."""
    import jax.numpy as jnp

    key = key.astype(jnp.uint64)
    mask = jnp.uint64(mask)
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key
