"""Device counting step (XLA path).

The hot loop of the reference — one hash-table probe plus ~10 integer ops
per base of every read (src/FingerPrint.hpp:89-103 via
vendor/KseqHashIterator.hpp:95-112) — becomes one fully-parallel jitted
step over a [batch, seglen] block of 2-bit codes:

* window encodings by k shifted adds over the segment axis (no scan: every
  window is computed in parallel; O(k) vector ops amortized over W windows)
* validity (no N, inside the read) via a windowed cumulative sum
* canonical hash64, bucket lookup (1 gather of an 8-slot bucket; the hash
  is uniform so its low bits are the address), scatter-add into the count
  vector (+1 overflow slot for misses).

Engine v1: the v3 engine (kernel_v3.py) is the production path; this step
serves the v1 engine and the mesh dry run.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ntsm_tpu.core.hash import hash64_jnp, kmer_mask


def window_hashes(codes, lengths, k: int, mask):
    """Canonical hash + validity for every window of a [B, L] code block."""
    B, L = codes.shape
    W = L - k + 1
    c = (codes & jnp.uint8(3)).astype(jnp.uint64)
    comp = jnp.uint64(3) ^ c
    fw = jnp.zeros((B, W), dtype=jnp.uint64)
    rv = jnp.zeros((B, W), dtype=jnp.uint64)
    for j in range(k):
        fw = (fw << 2) | c[:, j : j + W]
        rv = rv | (comp[:, j : j + W] << (2 * j))
    canon = jnp.minimum(fw, rv)
    h = hash64_jnp(canon, mask)

    inside = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1) < lengths[:, None]
    bad = ((codes >= 4) | ~inside).astype(jnp.int32)
    cs = jnp.cumsum(bad, axis=1)
    csz = jnp.pad(cs, ((0, 0), (1, 0)))
    valid = (csz[:, k:] - csz[:, :-k]) == 0
    return h, valid


def count_step_impl(codes, lengths, keys, vals, counts, total_kmers, total_hits, *, k, n_kmers):
    """One counting step (traceable body, see `count_step` for the jitted form).

    codes:   [B, L] uint8 (0..3 bases, >=4 invalid/pad)
    lengths: [B] int32
    keys:    [n_buckets, slots] uint64 site-k-mer hashes (EMPTY where unused)
    vals:    [n_buckets, slots] int32 k-mer index (n_kmers where unused)
    counts:  [n_kmers + 1] int32 accumulator (last slot = miss bin)
    """
    mask = kmer_mask(k)
    h, valid = window_hashes(codes, lengths, k, mask)

    n_buckets = keys.shape[0]
    bucket = (h & jnp.uint64(n_buckets - 1)).astype(jnp.int32)
    kg = keys[bucket]  # [B, W, slots]
    vg = vals[bucket]
    match = kg == h[..., None]
    slot_val = jnp.where(match, vg, jnp.int32(n_kmers)).min(axis=-1)
    found = match.any(axis=-1) & valid
    idx = jnp.where(found, slot_val, jnp.int32(n_kmers))

    counts = counts.at[idx.reshape(-1)].add(1, mode="drop")
    total_kmers = total_kmers + valid.sum(dtype=jnp.int64)
    total_hits = total_hits + found.sum(dtype=jnp.int64)
    return counts, total_kmers, total_hits


count_step = functools.partial(jax.jit, static_argnames=("k", "n_kmers"), donate_argnums=(4, 5, 6))(
    count_step_impl
)


def make_table_arrays(lookup, n_kmers: int):
    keys = jnp.asarray(lookup.keys)
    vals = jnp.asarray(np.where(lookup.vals < 0, n_kmers, lookup.vals).astype(np.int32))
    return keys, vals
