"""Device math for the eval engine: genotype planes, indicator
tally matmuls, compensated chunked accumulation, the joint-likelihood
passes, and the -p pair-block kernel.

Split out of eval/tpu.py (round 4); the drivers live there, the blob
codec in eval/blob.py, the wire/upload path in eval/wire.py, row
emission in eval/emit.py.  See eval/tpu.py's module docstring for the
math derivation (indicator matmuls + the x²/t = x − x·y/t joint
decomposition of CompareCounts.hpp:968-991,1013-1033).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

CHUNK = 256  # sites per f32 partial sum (not yet re-tuned on the GPU)
ROW_TILE = 64  # pair-block rows per joint-pass invocation


def _two_sum(hi, lo, p):
    """Compensated (Knuth two-sum) f32-pair accumulation.

    The f32 hi/lo pair keeps ~2^-48 relative error, recombined in f64 on
    the host; whether a native f64 accumulator is as fast on the GPU is
    an open question (ROADMAP)."""
    s = hi + p
    z = s - hi
    e = (hi - (s - z)) + (p - z)
    return s, lo + e


def _dd_sub(h1, l1, h2, l2):
    """Compensated-pair subtraction (h1,l1) − (h2,l2): the exact op
    sequence of the blob/rect packers — keep in sync (bitwise parity
    between engines depends on it)."""
    h, l = _two_sum(h1, l1, -h2)
    return _two_sum(h, l, -l2)


def _chunked_matmul_f64(lhs, rhs):
    """sum_c lhs[:, c, :] @ rhs[:, c, :].T with compensated accumulation.

    lhs: [N, C, c] f32, rhs: [M, C, c] f32 -> (hi, lo) [N, M] f32 pair;
    combine as hi.astype(f64) + lo.astype(f64) on the host.
    """
    N = lhs.shape[0]
    M = rhs.shape[0]

    def body(acc, xs):
        lc, rc = xs  # [N, c], [M, c]
        # HIGHEST: the default f32 matmul precision may round the
        # (non-indicator) value planes (TF32 on the GPU); force full f32.
        part = jnp.dot(
            lc,
            rc.T,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        hi, lo = acc
        return _two_sum(hi, lo, part), None

    z0 = jnp.zeros((N, M), jnp.float32)
    acc, _ = jax.lax.scan(
        body, (z0, z0), (jnp.swapaxes(lhs, 0, 1), jnp.swapaxes(rhs, 0, 1))
    )
    return acc


def _make_joint_fn(min_cov: int):
    mc = jnp.float32(min_cov)

    @jax.jit
    def joint_rows(ai, bi, vi, a, b, v):
        """Joint accumulators (f32 hi/lo pairs) for a row tile:
        ai/bi/vi [C, T, c]; a/b/v [C, N, c]."""
        return _joint_tiles(ai, bi, vi, a, b, v, mc)

    return joint_rows


def _genotype_planes(x, y, mc, n_valid=None):
    """Indicator planes + single-sample likelihood planes from two count
    planes — the parity-critical construction (calcHomHetMiss +
    computeSumLogPSingle, CompareCounts.hpp:742-768,968-991), shared by
    the single-device and mesh-sharded engines.

    n_valid (static) masks the chunk-alignment pad columns beyond the
    real site count: their a = b = 0 rides the strict `> minCov` test
    (CompareCounts.hpp:746), which only excludes them while mc >= 0 — a
    negative -c would otherwise count every pad site as a valid n."""
    px = x > mc
    py = y > mc
    if n_valid is not None and int(n_valid) < x.shape[-1]:
        live = jnp.arange(x.shape[-1]) < n_valid
        px &= live
        py &= live
    het = (px & py).astype(jnp.float32)
    hom_at = (px & ~py).astype(jnp.float32)
    hom_cg = (~px & py).astype(jnp.float32)
    vall = (px | py).astype(jnp.float32)
    s_int = jnp.where(px, x, 0.0) + jnp.where(py, y, 0.0)
    tot = jnp.maximum(x + y, 1.0)
    s_frac = (px.astype(jnp.float32) + py.astype(jnp.float32)) * (x * y) / tot
    return het, hom_at, hom_cg, vall, s_int, s_frac


def _tally_matmuls(het_l, hom_at_l, hom_cg_l, vall_l, het, hom_at, hom_cg, vall):
    """The six [rows, N] indicator tallies (exact 0/1 f32 matmuls).

    Default precision on purpose: both operands are 0/1, which TF32 (the
    GPU's default f32 matmul input format) represents exactly, and the f32
    accumulation stays exact while the sums stay below 2^24."""
    f32mm = lambda x, y: jnp.dot(x, y.T, preferred_element_type=jnp.float32)
    hom_l = hom_at_l + hom_cg_l
    hom = hom_at + hom_cg
    return dict(
        n=f32mm(vall_l, vall),
        shared_hets=f32mm(het_l, het),
        shared_homs=f32mm(hom_at_l, hom_at) + f32mm(hom_cg_l, hom_cg),
        ibs0=f32mm(hom_at_l, hom_cg) + f32mm(hom_cg_l, hom_at),
        hets1=f32mm(het_l, vall),
        homs1=f32mm(hom_l, vall),
    )


@functools.partial(jax.jit, static_argnames=("chunk", "mc", "n_valid"))
def _planes_and_tallies(a, b, *, mc: float, chunk: int, n_valid=None):
    """Everything derivable from the two count planes, on device:
    genotype indicator tallies (exact f32 matmuls of 0/1 planes),
    the single-sample likelihood planes and their pair sums (s1), and the
    chunked [C, N, c] layouts reused by the joint pass.

    Computing this on the device also cuts the upload from six [N, L]
    planes to the two count planes.
    """
    a = a.astype(jnp.float32)  # u16 wire widens here (no-op for f32)
    b = b.astype(jnp.float32)
    N, Lp = a.shape
    C = Lp // chunk
    # indicator matmuls: inputs are exactly 0/1, so even reduced-precision
    # matmul inputs (TF32) are error-free; sums stay exact integers in f32
    # while below 2^24 (n_sites << 2^24).
    het, hom_at, hom_cg, vall, s_int, s_frac = _genotype_planes(
        a, b, mc, n_valid
    )
    tallies = _tally_matmuls(
        het, hom_at, hom_cg, vall, het, hom_at, hom_cg, vall
    )

    cshape = (N, C, chunk)
    v_c = vall.reshape(cshape)
    si_hi, si_lo = _chunked_matmul_f64(s_int.reshape(cshape), v_c)
    sf_hi, sf_lo = _chunked_matmul_f64(s_frac.reshape(cshape), v_c)
    s1 = (si_hi, si_lo, sf_hi, sf_lo)

    # exact integer part of the joint term as matmuls (_joint_int_matmuls)
    jint = _joint_int_matmuls(a, b, vall, a, b, vall, mc, chunk)

    a_t = jnp.swapaxes(a.reshape(cshape), 0, 1)  # [C, N, c]
    b_t = jnp.swapaxes(b.reshape(cshape), 0, 1)
    v_t = jnp.swapaxes(v_c, 0, 1)
    return tallies, s1, jint, a_t, b_t, v_t


def _joint_tiles(ai, bi, vi, a, b, v, mc):
    """FRACTIONAL joint-likelihood accumulators for a row block:
    ai/bi/vi [C, T, c] vs full [C, N, c] -> (hi, lo) [T, N] f32 pair.

    The integer part of the joint term is NOT computed here — it
    decomposes into indicator matmuls ([aa>mc]·aa = aa − Σ_{v≤mc} v·[aa=v])
    evaluated exactly as matmuls by _joint_int_matmuls; only the
    data-dependent fraction needs this O(N²·sites) elementwise pass."""
    T = ai.shape[1]
    N = a.shape[1]

    def body(acc, xs):
        aic, bic, vic, ac, bc, vc = xs
        aa = aic[:, None, :] + ac[None, :, :]
        bb = bic[:, None, :] + bc[None, :, :]
        m = vic[:, None, :] * vc[None, :, :]
        pa = aa > mc
        pb = bb > mc
        tot = jnp.maximum(aa + bb, 1.0)
        nf = pa.astype(jnp.float32) + pb.astype(jnp.float32)
        jfrac = ((nf * (aa * bb) / tot) * m).sum(-1)
        fh, fl = acc
        return _two_sum(fh, fl, jfrac), None

    z0 = jnp.zeros((T, N), jnp.float32)
    acc, _ = jax.lax.scan(body, (z0, z0), (ai, bi, vi, a, b, v))
    return acc


def _joint_int_matmuls(a_l, b_l, v_l, a_f, b_f, v_f, mc: float, chunk: int):
    """Exact integer part of the joint term via chunked matmuls, for a row
    block against the full cohort: [T, Lp] local planes vs [N, Lp] full.

    jint(i,j) = Σ_s m·([aa>mc]·aa + [bb>mc]·bb), aa = a_i+a_j. With integer
    counts, [aa>mc]·aa = aa − Σ_{v=1..t} v·[aa==v] where t = floor(mc), and
    [aa==v] = Σ_w [a_i==w]·[a_j==v−w] — all separable products, so each
    term is one compensated chunked matmul; values are integers, so the
    result is exact.  Returns (hi, lo) f32 pair [T, N]."""
    T, Lp = a_l.shape
    N = a_f.shape[0]
    C = Lp // chunk
    t = int(np.floor(mc))

    def cm(x, y):
        return _chunked_matmul_f64(
            x.reshape(x.shape[0], C, chunk), y.reshape(y.shape[0], C, chunk)
        )

    def acc(h1, l1, h2, l2):
        h, l = _two_sum(h1, l1, h2)
        return _two_sum(h, l, l2)

    # row terms Σ (a_i+b_i)·m and column terms Σ (a_j+b_j)·m
    hi, lo = cm((a_l + b_l) * v_l, v_f)
    hi, lo = acc(hi, lo, *cm(v_l, (a_f + b_f) * v_f))

    # corrections: − Σ_{v=1..t} v·[aa==v]·m (and same for bb); the −v scale
    # rides the indicator plane so per-chunk partials stay exact f32
    for pl_l, pl_f in ((a_l, a_f), (b_l, b_f)):
        eq_l = [
            (pl_l == jnp.float32(w)).astype(jnp.float32) * v_l
            for w in range(t + 1)
        ]
        eq_f = [
            (pl_f == jnp.float32(w)).astype(jnp.float32) * v_f
            for w in range(t + 1)
        ]
        for v in range(1, t + 1):
            for w in range(0, v + 1):
                hi, lo = acc(
                    hi, lo, *cm(eq_l[w] * jnp.float32(-v), eq_f[v - w])
                )
    return hi, lo


def _joint_row_tile(a_d, b_d, v_t, r0: int, N: int):
    """One ROW_TILE-wide slice of the chunked [C, N, c] planes, zero-padded
    to the fixed tile width so every joint dispatch shares one compile."""
    r1 = min(r0 + ROW_TILE, N)
    ai = a_d[:, r0:r1]
    bi = b_d[:, r0:r1]
    vi = v_t[:, r0:r1]
    if r1 - r0 < ROW_TILE:
        padw = ((0, 0), (0, ROW_TILE - (r1 - r0)), (0, 0))
        ai = jnp.pad(ai, padw)
        bi = jnp.pad(bi, padw)
        vi = jnp.pad(vi, padw)
    return ai, bi, vi


PAIR_BLOCK = 4096  # candidate pairs per device invocation (-p path)


PAIR_GATHER_CHUNKS = 8  # site chunks fetched per row gather (-p kernel;
# not yet re-tuned on the GPU) — results are bitwise identical across g
# (sub-chunks unroll through the same accumulators)


@functools.partial(jax.jit, static_argnames=("g",))
def _chunk_planes(A, B, g: int = PAIR_GATHER_CHUNKS):
    """[N, Lp] wire planes -> one fused [C/g, N, 2*g*c] chunked layout
    (wire dtype kept: the scan body widens per sub-chunk).  Each row of
    the last dim holds g consecutive A chunks then g consecutive B
    chunks, so the -p pair kernel needs ONE gather per sample row per
    scan step instead of 2g.
    The planes are zero-padded up to a g*CHUNK multiple (the production
    Lp = 96512 is 377 odd chunks: +1.9% pad columns buys 8x fewer
    probes); pad sites are dead under the kernel's strict `> minCov`
    test for mc >= 0 and its n_valid live mask otherwise — always pass
    n_valid.  One transpose per eval run; nothing [P, Lp]-sized ever
    materializes."""
    N, Lp = A.shape
    pad = (-Lp) % (CHUNK * g)
    if pad:
        A = jnp.pad(A, ((0, 0), (0, pad)))
        B = jnp.pad(B, ((0, 0), (0, pad)))
    Cg = (Lp + pad) // (CHUNK * g)
    sw = lambda x: jnp.swapaxes(  # noqa: E731
        x.reshape(N, Cg, g * CHUNK), 0, 1
    )
    return jnp.concatenate([sw(A), sw(B)], axis=2)


def _pair_gather_g(Lp: int) -> int:
    """Gather width for a plane (kept for call-site symmetry; the fused
    layout pads, so any plane takes the full width)."""
    del Lp
    return PAIR_GATHER_CHUNKS


@functools.partial(
    jax.jit, static_argnames=("mc", "n_valid", "narrow", "g")
)
def _pair_block_stats_v2(F_t, ii, jj, *, mc: float, n_valid, narrow: bool,
                         g: int = PAIR_GATHER_CHUNKS):
    """Per-pair statistics for one block of candidate pairs (-p path),
    fully fused: one scan over the site chunks whose body gathers the
    paired row chunks and computes every statistic in place.

    The older kernel (_pair_block_stats) gathers whole [P, Lp] f32 rows
    and builds the genotype/s1 planes as [P, Lp] arrays BEFORE its scan —
    ~40 GB of device-memory traffic per 4096-pair block at the 96,287-site
    scale.  Chunk-local gathers keep every intermediate small, and the
    fused A++B layout with g chunks per gather cuts the gather count
    2g-fold.
    The arithmetic per pair is unchanged for ANY g: sub-chunks are
    unrolled in site order through the same accumulator sequence
    (per-chunk f32 sums, compensated cross-chunk accumulation — the -a
    engines' precision class), so results are bitwise identical across g
    and scores agree with the old kernel to the usual f32-pair tolerance
    with exact integer tallies.

    F_t: [C/g, N, 2*g*c] fused chunked wire planes (_chunk_planes);
    ii/jj: [P] i32 pair indices.  Returns the rect engine's
    (ll f32[2, P], ints, hi) 5-statistic wire (eval/blob._narrow_ints).

    Reference being replaced: the candidate pair loop of computeScorePCA,
    /root/reference/src/CompareCounts.hpp:335-356."""
    from ntsm_tpu.eval.blob import _narrow_ints

    mcf = jnp.float32(mc)
    Cg, N, w = F_t.shape
    c = w // (2 * g)
    P = ii.shape[0]
    nv = jnp.int32(Cg * g * c if n_valid is None else int(n_valid))
    site0 = jnp.arange(Cg, dtype=jnp.int32) * jnp.int32(g * c)
    lane = jnp.arange(c, dtype=jnp.int32)

    def sub_chunk(acc, a_i, b_i, a_j, b_j, live):
        """One CHUNK-wide statistic step ([P, c] f32 tiles).  live masks
        the pad columns past n_valid (strict >mc parity: a=b=0 pad sites
        are already excluded while mc >= 0; the mask covers negative -c
        exactly like _genotype_planes' n_valid)."""
        pxi = (a_i > mcf) & live
        pyi = (b_i > mcf) & live
        pxj = (a_j > mcf) & live
        pyj = (b_j > mcf) & live
        het_i = pxi & pyi
        hat_i = pxi & ~pyi
        hcg_i = ~pxi & pyi
        val_i = pxi | pyi
        het_j = pxj & pyj
        hat_j = pxj & ~pyj
        hcg_j = ~pxj & pyj
        val_j = pxj | pyj
        m = (val_i & val_j).astype(jnp.float32)

        def bsum(x):  # exact integer-valued f32 chunk reduction
            return x.astype(jnp.float32).sum(axis=1)

        n_c = bsum(val_i & val_j)
        shet_c = bsum(het_i & het_j)
        ibs0_c = bsum((hat_i & hcg_j) | (hcg_i & hat_j))
        h1_c = bsum(het_i & val_j)
        h2_c = bsum(het_j & val_i)

        # single-sample likelihood planes (calcHomHetMiss form)
        si = jnp.where(pxi, a_i, 0.0) + jnp.where(pyi, b_i, 0.0)
        sj = jnp.where(pxj, a_j, 0.0) + jnp.where(pyj, b_j, 0.0)
        sfi = (pxi.astype(jnp.float32) + pyi.astype(jnp.float32)) * (
            a_i * b_i
        ) / jnp.maximum(a_i + b_i, 1.0)
        sfj = (pxj.astype(jnp.float32) + pyj.astype(jnp.float32)) * (
            a_j * b_j
        ) / jnp.maximum(a_j + b_j, 1.0)
        s1_c = ((si - sfi + (sj - sfj)) * m).sum(axis=1)

        # joint terms on the summed counts
        aa = a_i + a_j
        bb = b_i + b_j
        paa = aa > mcf
        pbb = bb > mcf
        jint_c = (
            (jnp.where(paa, aa, 0.0) + jnp.where(pbb, bb, 0.0)) * m
        ).sum(axis=1)
        nf = paa.astype(jnp.float32) + pbb.astype(jnp.float32)
        jfrac_c = ((nf * (aa * bb) / jnp.maximum(aa + bb, 1.0)) * m).sum(
            axis=1
        )

        ints, (jih, jil), (jfh, jfl), (s1h, s1l) = acc
        ints = ints + jnp.stack([n_c, ibs0_c, shet_c, h1_c, h2_c])
        return (
            ints,
            _two_sum(jih, jil, jint_c),
            _two_sum(jfh, jfl, jfrac_c),
            _two_sum(s1h, s1l, s1_c),
        )

    def body(acc, xs):
        fc, s0 = xs  # [N, 2*g*c] fused wire rows, scalar site base
        rows_i = fc[ii]  # [P, 2*g*c] — ONE probe per pair-side per step
        rows_j = fc[jj]
        for s in range(g):  # unrolled in site order: bitwise == g=1
            a_i = rows_i[:, s * c : (s + 1) * c].astype(jnp.float32)
            b_i = rows_i[:, (g + s) * c : (g + s + 1) * c].astype(
                jnp.float32
            )
            a_j = rows_j[:, s * c : (s + 1) * c].astype(jnp.float32)
            b_j = rows_j[:, (g + s) * c : (g + s + 1) * c].astype(
                jnp.float32
            )
            live = (s0 + jnp.int32(s * c) + lane) < nv
            acc = sub_chunk(acc, a_i, b_i, a_j, b_j, live)
        return acc, None

    z = jnp.zeros((P,), jnp.float32)
    acc0 = (jnp.zeros((5, P), jnp.float32), (z, z), (z, z), (z, z))
    (ints, (jih, jil), (jfh, jfl), (s1h, s1l)), _ = jax.lax.scan(
        body, acc0, (F_t, site0)
    )
    dh, dl = _dd_sub(jih, jil, jfh, jfl)
    dh, dl = _dd_sub(dh, dl, s1h, s1l)
    ll = jnp.stack([-2.0 * dh, -2.0 * dl])
    return _narrow_ints(ll, ints, narrow)


@functools.partial(jax.jit, static_argnames=("chunk", "mc", "n_valid"))
def _pair_block_stats(A, B, ii, jj, *, mc: float, chunk: int, n_valid=None):
    """Per-pair statistics for one block of candidate pairs (-p path).

    A/B: [N, Lp] f32 count planes; ii/jj: [P] int32 pair indices.  The
    rows are gathered on device and every statistic reduces over sites
    elementwise — no O(N²) matrix is formed, so scoring cost is
    O(P · sites) for exactly the candidate pairs the kd-tree-equivalent
    search produced (reference scores candidates one pair at a time,
    CompareCounts.hpp:335-356).

    Tallies are indicator sums (exact in f32 below 2^24); s1 and the
    joint terms use the same per-chunk-f32 + two-sum accumulation as the
    all-vs-all engine, so -p and -a device scores are identical for the
    same pair.
    """
    mcf = jnp.float32(mc)
    # gather on the (possibly u16) wire dtype, widen the gathered rows
    a_i, b_i = A[ii].astype(jnp.float32), B[ii].astype(jnp.float32)
    a_j, b_j = A[jj].astype(jnp.float32), B[jj].astype(jnp.float32)
    het1, hat1, hcg1, val1, sint1, sfrac1 = _genotype_planes(
        a_i, b_i, mcf, n_valid
    )
    het2, hat2, hcg2, val2, sint2, sfrac2 = _genotype_planes(
        a_j, b_j, mcf, n_valid
    )
    m = val1 * val2

    def isum(x):  # exact integer-valued f32 reduction
        return x.sum(axis=1)

    # only the 5-statistic wire is computed — the hom tallies are exact
    # host-side identities of these (see eval/blob.py)
    tallies = dict(
        n=isum(m),
        shared_hets=isum(het1 * het2),
        ibs0=isum(hat1 * hcg2 + hcg1 * hat2),
        hets1=isum(het1 * val2),
        hets2=isum(het2 * val1),
    )

    P, Lp = a_i.shape
    C = Lp // chunk

    def cview(x):
        return jnp.swapaxes(x.reshape(P, C, chunk), 0, 1)  # [C, P, c]

    def body(acc, xs):
        ai_c, bi_c, aj_c, bj_c, m_c, s1_c = xs
        aa = ai_c + aj_c
        bb = bi_c + bj_c
        paa = aa > mcf
        pbb = bb > mcf
        jint_p = ((jnp.where(paa, aa, 0.0) + jnp.where(pbb, bb, 0.0)) * m_c).sum(-1)
        tot = jnp.maximum(aa + bb, 1.0)
        nf = paa.astype(jnp.float32) + pbb.astype(jnp.float32)
        jfrac_p = ((nf * (aa * bb) / tot) * m_c).sum(-1)
        s1_p = (s1_c * m_c).sum(-1)
        (jih, jil), (jfh, jfl), (s1h, s1l) = acc
        return (
            _two_sum(jih, jil, jint_p),
            _two_sum(jfh, jfl, jfrac_p),
            _two_sum(s1h, s1l, s1_p),
        ), None

    s1_plane = (sint1 - sfrac1) + (sint2 - sfrac2)
    z = jnp.zeros((P,), jnp.float32)
    acc, _ = jax.lax.scan(
        body,
        ((z, z), (z, z), (z, z)),
        (cview(a_i), cview(b_i), cview(a_j), cview(b_j), cview(m), cview(s1_plane)),
    )
    (jih, jil), (jfh, jfl), (s1h, s1l) = acc
    # fold the joint/single accumulators into the compensated loglik pair
    # ON DEVICE (same compensated-pair style as the rect/triangle packers
    # — s1 folded as ONE combined pair here, two pairs there, so low bits
    # may differ across engines; scores are tolerance-checked, not
    # bit-checked):
    # one [7, P] blob per block — rows 0-4 the 5-statistic integer wire,
    # rows 5-6 the loglik hi/lo — 28 B/pair on the single-array fetch
    # (the round-3 blob shipped all six accumulator rows: 44 B/pair).
    dh, dl = _dd_sub(jih, jil, jfh, jfl)
    dh, dl = _dd_sub(dh, dl, s1h, s1l)
    return jnp.stack(
        [
            tallies["n"],
            tallies["shared_hets"],
            tallies["ibs0"],
            tallies["hets1"],
            tallies["hets2"],
            -2.0 * dh,
            -2.0 * dl,
        ]
    )
