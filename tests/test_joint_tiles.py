"""The eval engines' fractional joint-likelihood pass (_joint_tiles)
against a plain float64 evaluation of the reference's joint term
(computeSumLogPJoint's x·y/t part, CompareCounts.hpp:1013-1033)."""

import numpy as np
import pytest

import jax.numpy as jnp

from ntsm_tpu.eval.kernels import CHUNK, _joint_tiles


def _exact_joint_frac(a, b, v, mc):
    aa = a[:, None, :] + a[None, :, :]
    bb = b[:, None, :] + b[None, :, :]
    m = v[:, None, :] * v[None, :, :]
    nf = (aa > mc).astype(np.float64) + (bb > mc).astype(np.float64)
    return (nf * aa * bb / np.maximum(aa + bb, 1.0) * m).sum(-1)


@pytest.mark.parametrize("mc", [1.0, 3.0])
def test_joint_tiles_match_exact(rng, mc):
    N, C = 40, 3
    Lp = C * CHUNK
    a = rng.integers(0, 40, size=(N, Lp)).astype(np.float64)
    b = rng.integers(0, 40, size=(N, Lp)).astype(np.float64)
    b[rng.random((N, Lp)) < 0.3] = 0  # hom sites
    v = (rng.random((N, Lp)) < 0.9).astype(np.float64)

    def chunked(x):  # [N, Lp] -> [C, N, c]
        return jnp.swapaxes(
            jnp.asarray(x, jnp.float32).reshape(N, C, CHUNK), 0, 1
        )

    fh, fl = _joint_tiles(chunked(a), chunked(b), chunked(v),
                          chunked(a), chunked(b), chunked(v),
                          jnp.float32(mc))
    got = np.asarray(fh).astype(np.float64) + np.asarray(fl).astype(
        np.float64
    )
    want = _exact_joint_frac(a, b, v, mc)
    # per-chunk f32 sums over CHUNK sites, compensated across chunks
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-3)
