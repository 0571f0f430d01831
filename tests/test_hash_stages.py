"""The XLA window-hash stages (unpacked and packed wire) against the NumPy
golden hasher: same valid windows, same canonical hashes, with Ns and
ragged read lengths."""

import numpy as np
import pytest

import jax.numpy as jnp

from ntsm_tpu.core.hash import hash64_np, kmer_mask
from ntsm_tpu.core.kmers import window_encodings
from ntsm_tpu.count.kernel import window_hashes
from ntsm_tpu.count.kernel_v2 import pack_batch, window_hashes_packed


def _batch(rng, B, L, k):
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4  # Ns
    lengths = rng.integers(k, L + 1, size=B).astype(np.int32)
    for b in range(B):  # ragged reads: pad past the length
        codes[b, lengths[b]:] = 4
    return codes, lengths


def _golden(codes, lengths, k):
    """Per row: (valid mask, hashes) from core.kmers' NumPy oracle."""
    out = []
    for row, n in zip(codes, lengths):
        fw, rv, valid = window_encodings(row[:n], k)
        h = hash64_np(np.minimum(fw, rv), kmer_mask(k))
        out.append((valid, h))
    return out


def _check(h, v, codes, lengths, k):
    h = np.asarray(h)
    v = np.asarray(v)
    for b, (gv, gh) in enumerate(_golden(codes, lengths, k)):
        n = gv.shape[0]
        np.testing.assert_array_equal(v[b, :n], gv)
        assert not v[b, n:].any()
        np.testing.assert_array_equal(h[b, :n][gv], gh[gv])


@pytest.mark.parametrize("k", [5, 16, 19, 31, 32])
def test_window_hashes_match_golden(rng, k):
    codes, lengths = _batch(rng, 32, 96, k)
    h, v = window_hashes(
        jnp.asarray(codes), jnp.asarray(lengths), k, kmer_mask(k)
    )
    _check(h, v, codes, lengths, k)


@pytest.mark.parametrize("k", [5, 19, 32])
def test_packed_window_hashes_match_golden(rng, k):
    codes, lengths = _batch(rng, 24, 128, k)
    packed, vbits = pack_batch(codes)
    h, v = window_hashes_packed(
        jnp.asarray(packed), jnp.asarray(vbits), k, 128
    )
    _check(h, v, codes, lengths, k)
