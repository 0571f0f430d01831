"""Packed statistic blobs: the device-side i<j triangle gather, its
u16+high-bit wire, the streamed fetch, and host-side finalization.

Split out of eval/tpu.py (round 4).  Every statistic crosses the
device->host fetch in a ~17 B/pair blob (ll-hi f32[1,P]; u16[6,P]: five
statistic low halves + the loglik-lo bf16 bits; hi u8[P] carrying each
statistic's 2^16 bit) instead of fourteen [N, N] f32 planes.  Only 5 of the 8 integer statistics cross the wire: the
genotype indicators PARTITION the valid mask (het + hom_at + hom_cg =
val exactly, eval/kernels.py:_genotype_planes), so the hom tallies are
integer identities of the five fetched ones — homs_k = n − hets_k and
shared_homs = n − hets1 − hets2 + shared_hets − ibs0 — reconstructed
exactly in int64 by _unpack_blob."""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ntsm_tpu.eval.exact import DBL_MAX
from ntsm_tpu.eval.kernels import (
    ROW_TILE,
    _dd_sub,
    _joint_row_tile,
    _make_joint_fn,
)

NARROW_WIRE_MAX_SITES = (1 << 17) - 1  # u16+highbit wire validity bound


@functools.partial(jax.jit, static_argnames=("narrow",))
def _pack_triangle(tallies, s1, jint, jfh, jfl, narrow: bool):
    """Gather the i<j triangle of every per-pair statistic on device
    (P = N(N-1)/2, row-major pair order — matches np.triu_indices(N, 1)).

    Returns (ll [2, P] f32, ints, hi) where ints holds the 5-statistic
    wire [n, ibs0, shared_hets, hets1, hets2] (the hom tallies are
    derived host-side — see the module docstring):

    * narrow wire (every statistic < 2¹⁷, i.e. n_sites ≤ 131071 — 1.4x
      the human site set): ll is the f32 hi term only, ints is u16 low
      halves plus the loglik-lo bf16 bits (_narrow_ints), and hi is a
      [P] u8 whose bit k carries statistic k's 2¹⁶ bit — 17 B/pair on
      the wire vs 28 for the all-f32 blob (and vs the round-3
      8-statistic 25 / round-4 19).
    * wide fallback: ll is the full [2, P] pair, ints the exact-integer
      f32 stack, hi None.

    The log-likelihood −2·(J − s1 − s1ᵀ) (CompareCounts.hpp:1093-1099) is
    folded from its six hi/lo source planes with compensated pair
    arithmetic (~2⁻⁴⁸ relative, same class as the host f64 combine it
    replaces)."""
    n_plane = tallies["n"]
    N = n_plane.shape[0]
    P = (N * (N - 1)) // 2
    ii = jax.lax.broadcasted_iota(jnp.int32, (N, N), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (N, N), 1)
    flat = jnp.flatnonzero((jj > ii).reshape(-1), size=P, fill_value=0)
    tflat = (flat % N) * N + flat // N  # transpose gather: (j, i)
    g = lambda x: x.reshape(-1)[flat]  # noqa: E731
    gt = lambda x: x.reshape(-1)[tflat]  # noqa: E731

    dd_sub = _dd_sub
    si_hi, si_lo, sf_hi, sf_lo = s1
    jh, jl = dd_sub(g(jint[0]), g(jint[1]), g(jfh), g(jfl))
    s1ij = dd_sub(g(si_hi), g(si_lo), g(sf_hi), g(sf_lo))
    s1ji = dd_sub(gt(si_hi), gt(si_lo), gt(sf_hi), gt(sf_lo))
    dh, dl = dd_sub(jh, jl, *s1ij)
    dh, dl = dd_sub(dh, dl, *s1ji)
    ll = jnp.stack([-2.0 * dh, -2.0 * dl])
    ints = jnp.stack(
        [
            g(n_plane),
            g(tallies["ibs0"]),
            g(tallies["shared_hets"]),
            g(tallies["hets1"]),
            gt(tallies["hets1"]),
        ]
    )
    return _narrow_ints(ll, ints, narrow)


def _narrow_ints(ll, ints, narrow: bool):
    """u16+high-bit wire for a stack of ≤8 exact-integer f32 statistics
    (shared by the triangle, rect, and -p pair packers).

    The narrow wire also folds the compensated loglik pair's LO term to
    bfloat16 bits, appended as a sixth u16 row: |lo| ≤
    2⁻²⁴|hi| by two-sum construction, and bf16 keeps 8 of its mantissa
    bits, so the wire-quantization error is ≤ 2⁻³³ relative to the
    loglik.  Measured on adversarial deep/tiny cohorts (λ up to 2000,
    95%-missing): worst score error identical to 7 digits with the
    f32-lo wire (2.458e-5 abs both ways — entirely the pre-existing
    f32-pair accumulation, none of it this wire).  17 B/pair total:
    ll-hi f32[1, ...] + u16[6, ...] + u8[...]."""
    if not narrow:
        return ll, ints.astype(jnp.float32), None
    iv = ints.astype(jnp.int32)
    lo = (iv & 0xFFFF).astype(jnp.uint16)
    k = ints.shape[0]
    shift = jnp.arange(k, dtype=jnp.uint8).reshape(
        (k,) + (1,) * (ints.ndim - 1)
    )
    hi = jnp.sum((iv >> 16).astype(jnp.uint8) << shift, axis=0,
                 dtype=jnp.uint8)
    ll_lo_bits = jax.lax.bitcast_convert_type(
        ll[1].astype(jnp.bfloat16), jnp.uint16
    )
    return ll[:1], jnp.concatenate([lo, ll_lo_bits[None]], axis=0), hi


def _decode_ll_lo(bits: np.ndarray) -> np.ndarray:
    """Host inverse of the bf16 loglik-lo row: u16 bits -> f32 (bf16 is
    f32's top half, so the value is exactly bits << 16 viewed as f32)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _unpack_blob(ll, ints, hi):
    """Host-side inverse of the packed wire: (ll [2,p], iv [8,p] int64)
    from the fetched 5-statistic parts [n, ibs0, shared_hets, hets1,
    hets2].  The hom statistics never cross the wire — they are exact
    integer identities (the genotype indicators partition the valid
    mask, so homs_k = n − hets_k and n = shet + shom + ibs0 +
    (hets1 − shet) + (hets2 − shet)); iv rows come back in the
    historical order [n, ibs0, shared_hets, shared_homs, hets1, hets2,
    homs1, homs2] so downstream finalizers are unchanged.  On the
    narrow wire (hi given) ints carries a sixth row: the loglik-lo bf16
    bits (_narrow_ints), reassembled here into the [2, p] ll pair."""
    if hi is not None and ints.shape[0] == 6:
        ll = np.concatenate(
            [np.asarray(ll), _decode_ll_lo(np.asarray(ints[5]))[None]],
            axis=0,
        )
        ints = ints[:5]
    w = ints.astype(np.int64)
    if hi is not None:
        k = w.shape[0]
        shift = np.arange(k).reshape((k,) + (1,) * (ints.ndim - 1))
        w += ((hi[None].astype(np.int64) >> shift) & 1) << 16
    n, ibs0, shet, h1, h2 = w
    iv = np.stack(
        [n, ibs0, shet, n - h1 - h2 + shet - ibs0, h1, h2, n - h1, n - h2]
    )
    return ll, iv


def _blob_from_planes(tallies_d, s1_d, jint_d, a_d, b_d, v_t, opts, N,
                      n_sites: int):
    """Device triangle blob parts for the packed path: runs the joint
    fractional row tiles device-resident (no per-tile fetch) and gathers
    the i<j triangle of every statistic.  Returns the (lazy)
    (ll, ints, hi) device tuple of _pack_triangle — callers fetch it
    whole or stream it in P-chunks."""
    joint_fn = _make_joint_fn(opts.min_cov)
    tiles = []
    for r0 in range(0, N, ROW_TILE):
        ai, bi, vi = _joint_row_tile(a_d, b_d, v_t, r0, N)
        tiles.append(joint_fn(ai, bi, vi, a_d, b_d, v_t))
    jfh = jnp.concatenate([t[0] for t in tiles], axis=0)
    jfl = jnp.concatenate([t[1] for t in tiles], axis=0)
    # every statistic is bounded by n <= n_sites (pad columns are masked
    # out of the genotype planes by n_valid, for every -c), so the
    # u16+highbit wire is exact iff the site count fits 17 bits (1.4x the
    # human set).  NB: a_d here is the [C, N, c] chunked layout — its
    # last dim is CHUNK, never use it as a site-count bound.
    return _pack_triangle(
        tallies_d, s1_d, jint_d, jfh[:N], jfl[:N],
        narrow=n_sites <= NARROW_WIRE_MAX_SITES,
    )


def _fetch_blob_slice(parts, p0: int, p1: int):
    """Fetch one [p0:p1) pair slice of the (ll, ints, hi) blob parts to
    host numpy (the hi row may be None on the wide wire)."""
    ll, ints, hi = parts
    return (
        np.asarray(ll[:, p0:p1]),
        np.asarray(ints[:, p0:p1]),
        None if hi is None else np.asarray(hi[p0:p1]),
    )


def _finalize_packed(data, opts, buf, iu, ju) -> dict:
    """Per-pair stats from fetched blob parts whose pairs are
    (iu[k], ju[k]): same skew / DBL_MAX semantics as _finalize_stats,
    np.triu_indices(N, 1) pair order (hets2/homs2 are transpose gathers)."""
    llp, iv = _unpack_blob(*buf)
    ll = llp[0].astype(np.float64) + llp[1].astype(np.float64)
    n = iv[0]
    cov = data.cov
    with np.errstate(divide="ignore", invalid="ignore"):
        skewed = ll / (cov[iu] * cov[ju]) ** opts.cov_skew
        score = np.where(n > 0, skewed / np.maximum(n, 1.0), DBL_MAX)
    return dict(
        score=score,
        n=n,
        ibs0=iv[1],
        shared_hets=iv[2],
        shared_homs=iv[3],
        hets1=iv[4],
        hets2=iv[5],
        homs1=iv[6],
        homs2=iv[7],
    )


def _finalize_stats(data, opts, tallies, s1, J) -> dict:
    loglik = -2.0 * (J - s1 - s1.T)
    cov = data.cov
    with np.errstate(divide="ignore", invalid="ignore"):
        skewed = loglik / (cov[:, None] * cov[None, :]) ** opts.cov_skew
        nmat = tallies["n"].astype(np.float64)
        score = np.where(nmat > 0, skewed / np.maximum(nmat, 1.0), DBL_MAX)

    return dict(score=score, **tallies)
