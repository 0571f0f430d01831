"""Device counting pipeline (engine v2).

v2 restructures the v1 step around its probe and scatter costs:

* input is 2-bit packed on the host (4 bases/byte + 1 validity bit/base),
  ~8x less upload volume; unpacking is a few shifts on device.
* the bucket table uses 16 x u64 slots per bucket (128 B rows; value
  planes never ride the gather, hit identity is (bucket, slot)).
* NO scatter: matching k-mers are packed as (bucket<<sbits|slot)+1 and
  extracted with jax.lax.top_k (hits are ~0.25% of windows in WGS data;
  K=65536 bounds a 4.2 Mbase batch's hits with huge slack).  The host
  accumulates the (tiny) hit list into the count vector with np.add.at —
  the reference's `omp atomic` table updates (FingerPrint.hpp:93-102)
  become a host-side histogram of device-extracted hits.
* if a batch overflows K (adversarially site-dense input), the engine
  falls back to the exact golden recount of that batch on the host.

Totals (valid k-mers, hits) stream back as scalars, which also drives the
-m early-termination check (FingerPrint.hpp:41-43,476-487).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ntsm_tpu.core.hash import hash64_jnp, kmer_mask

TOPK = 65536
SLOTS_V2 = 16  # 128-byte bucket rows


def pack_batch(codes: np.ndarray):
    """Host-side 2-bit packing: [B, L] u8 codes -> ([B, L//4] u8, [B, L//8] u8).

    BLOCK layout, not positional interleave: byte j holds bases
    (j, j+L/4, j+L/2, j+3L/4) in bit pairs (0,2,4,6).  Device unpacking is
    then a pure concatenation along the position axis, with no lane
    shuffles.

    The validity bitmask carries both "real base" (not N) and "inside the
    read" so lengths never need to ride along.
    """
    B, L = codes.shape
    assert L % 8 == 0
    base = codes & 3
    q = L // 4
    packed = (
        base[:, 0:q]
        | (base[:, q : 2 * q] << 2)
        | (base[:, 2 * q : 3 * q] << 4)
        | (base[:, 3 * q :] << 6)
    ).astype(np.uint8)
    valid = (codes < 4).astype(np.uint8)
    e = L // 8
    vbits = np.zeros((B, e), dtype=np.uint8)
    for i in range(8):
        vbits |= valid[:, i * e : (i + 1) * e] << i
    return packed, vbits


def pack_batch_fast(codes: np.ndarray):
    """pack_batch via the native C++ packer when available, numpy
    otherwise."""
    from ntsm_tpu import native

    lib = native.load()
    B, L = codes.shape
    if lib is None or L % 8 != 0:
        return pack_batch(codes)
    import ctypes

    codes = np.ascontiguousarray(codes)
    packed = np.empty((B, L // 4), dtype=np.uint8)
    vbits = np.empty((B, L // 8), dtype=np.uint8)
    lib.ntsm_pack_batch(
        codes.ctypes.data_as(ctypes.c_void_p),
        B,
        L,
        packed.ctypes.data_as(ctypes.c_void_p),
        vbits.ctypes.data_as(ctypes.c_void_p),
    )
    return packed, vbits


def unpack_codes(packed, vbits, L: int):
    """Device-side unpack -> (codes2bit [B, L] u8 in 0..3, valid [B, L] bool).

    Pure concatenation thanks to the block pack layout (no lane shuffles)."""
    codes = jnp.concatenate([(packed >> (2 * i)) & 3 for i in range(4)], axis=1)
    valid = jnp.concatenate(
        [(vbits >> i) & 1 for i in range(8)], axis=1
    ).astype(bool)
    return codes, valid


SIDE_MAXB = 8  # invalid positions per row the breaks sidecar can carry
SIDE_BYTES = 2 + 2 * SIDE_MAXB  # row_len u16 + SIDE_MAXB u16 positions


def unpack_codes_breaks(packed, side, L: int):
    """Device-side unpack for the BREAKS wire: validity is reconstructed
    from a [B, SIDE_BYTES] u8 sidecar (row length + up to SIDE_MAXB
    explicitly-invalid positions, little-endian u16s written bytewise by
    breaks_sidecar) instead of a [B, L/8] per-slot bitmask.  Bit-identical
    to unpack_codes' (codes, valid) whenever the sidecar fits (the
    producer falls back to the vbits wire when it doesn't): slots past
    row_len are pad (code 4 in the codes buffer, invalid either way) and
    in-length invalid slots (separators, Ns) are enumerated exactly."""
    codes = jnp.concatenate([(packed >> (2 * i)) & 3 for i in range(4)], axis=1)
    s32 = side.astype(jnp.int32)
    lens = s32[:, 0] | (s32[:, 1] << 8)
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    valid = pos < lens[:, None]
    for j in range(SIDE_MAXB):
        inv_j = s32[:, 2 + 2 * j] | (s32[:, 3 + 2 * j] << 8)
        valid &= pos != inv_j[:, None]
    return codes, valid


def window_hashes_packed(packed, vbits, k: int, L: int):
    """Canonical hash + validity for every window, from packed input."""
    codes, base_valid = unpack_codes(packed, vbits, L)
    return _window_hashes_from(codes, base_valid, k, L)


def window_hashes_breaks(packed, side, k: int, L: int):
    """window_hashes_packed for the breaks wire (same hash/mask ops on
    the same reconstructed (codes, valid) -> bitwise-identical output)."""
    codes, base_valid = unpack_codes_breaks(packed, side, L)
    return _window_hashes_from(codes, base_valid, k, L)


def _window_hashes_from(codes, base_valid, k: int, L: int):
    # The unpacked planes are materialized on purpose: fused into the 2k
    # shifted window slices below, the unpack made XLA's GPU hash fusion
    # ~20x slower than unpack and hash as two fusions (PERF.md, PR 1).
    codes, base_valid = jax.lax.optimization_barrier((codes, base_valid))
    B, W = codes.shape[0], L - k + 1
    c = codes.astype(jnp.uint64)
    comp = jnp.uint64(3) ^ c
    fw = jnp.zeros((B, W), dtype=jnp.uint64)
    rv = jnp.zeros((B, W), dtype=jnp.uint64)
    for j in range(k):
        fw = (fw << 2) | c[:, j : j + W]
        rv = rv | (comp[:, j : j + W] << (2 * j))
    h = hash64_jnp(jnp.minimum(fw, rv), kmer_mask(k))
    bad = (~base_valid).astype(jnp.int32)
    cs = jnp.cumsum(bad, axis=1)
    csz = jnp.pad(cs, ((0, 0), (1, 0)))
    valid = (csz[:, k:] - csz[:, :-k]) == 0
    return h, valid


@functools.partial(jax.jit, static_argnames=("k", "L"))
def count_step_v2(packed, vbits, keys, *, k, L):
    """One v2 step: returns (hit_ids [TOPK] i32 desc, n_found, n_valid).

    hit_ids are (bucket << 6 | slot) + 1, zero-padded.
    """
    h, valid = window_hashes_packed(packed, vbits, k, L)
    n_buckets, slots = keys.shape
    sbits = (slots - 1).bit_length()
    bucket = (h & jnp.uint64(n_buckets - 1)).astype(jnp.int32)
    rows = keys[bucket]  # [B, W, slots] gather rows
    match = rows == h[..., None]
    slot = jnp.where(
        match, jax.lax.broadcasted_iota(jnp.int32, match.shape, 2), slots
    ).min(axis=-1)
    found = match.any(axis=-1) & valid
    packed_hit = jnp.where(found, (bucket << sbits) | slot, -1) + 1
    flat = packed_hit.reshape(-1)
    top, _ = jax.lax.top_k(flat, min(TOPK, flat.shape[0]))
    return top, found.sum(dtype=jnp.int64), valid.sum(dtype=jnp.int64)


def make_table_v2(lookup):
    """Rebuild the lookup keys as a device array (values stay on host:
    hit identity is positional)."""
    return jnp.asarray(lookup.keys)


def hits_to_kmer_counts(hit_ids: np.ndarray, lookup, n_kmers: int, counts: np.ndarray):
    """Host accumulation: hit ids -> per-k-mer counts via the vals plane."""
    ids = hit_ids[hit_ids > 0] - 1
    if ids.size == 0:
        return 0
    sbits = (lookup.slots - 1).bit_length()
    b = ids >> sbits
    s = ids & (lookup.slots - 1)
    kidx = lookup.vals[b, s]
    np.add.at(counts, kidx, 1)
    return ids.size
