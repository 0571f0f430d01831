"""Device all-vs-all scoring engine — drivers.

The reference's O(N² · sites) OpenMP pair loop (computeScore,
src/CompareCounts.hpp:591-624) becomes dense device linear algebra:

* All relatedness / IBS / validity tallies are inner products of genotype
  one-hot indicator planes — a handful of [N, L] @ [L, N] matmuls.  Both
  operands are 0/1, so the products are exact even at reduced matmul
  precision (TF32 on the GPU keeps 0 and 1 exact), and the f32 sums are
  exact integers while counts stay below 2^24.

* The log-likelihood is decomposed per site into an integer part and a
  small fractional part using  x²/t = x − x·y/t :

      sumLogPSingle site term  = [a>mc]·a + [b>mc]·b − ([a>mc]+[b>mc])·ab/t
      sumLogPJoint  site term  =  same with a = a_i+a_j, b = b_i+b_j

  (reference formulas: CompareCounts.hpp:968-991, 1013-1033).  The single
  terms only depend on one sample, so their pair sums are matmuls against
  the pair-validity plane; only the joint fractional term needs a blocked
  elementwise pairwise pass.

* Precision: per-chunk sums are f32, cross-chunk accumulation is
  compensated f32 pairs combined in f64 on the host.  Empirical score
  agreement with the exact f64 engine is ~1e-9 relative; classification
  (same/differ at the 0.5 threshold) is identical.  Use --engine exact for
  bit-level output parity with the C++ reference.

Module layout (round-4 split): device math in eval/kernels.py, the
host->device wire in eval/wire.py, the packed-blob codec in
eval/blob.py, mesh sharding in eval/sharded.py, row emission in
eval/emit.py.  This module keeps the public drivers and re-exports the
historical names."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ntsm_tpu.eval import blob as _blob_mod
from ntsm_tpu.eval.blob import (  # noqa: F401  (re-exports)
    NARROW_WIRE_MAX_SITES,
    _blob_from_planes,
    _fetch_blob_slice,
    _finalize_packed,
    _finalize_stats,
    _narrow_ints,
    _pack_triangle,
    _unpack_blob,
)
from ntsm_tpu.eval.emit import (  # noqa: F401
    PAIR_COL_KEYS,
    _emit_pair_chunk,
    _emit_rows_native,
    _load_row_formatter,
    _pair_columns,
    _sample_strings,
    _triangle_vectors,
)
from ntsm_tpu.eval.exact import (  # noqa: F401
    DBL_MAX,
    HEADER,
    PairResult,
    Relate,
    results_row,
)
from ntsm_tpu.eval.kernels import (  # noqa: F401
    CHUNK,
    PAIR_BLOCK,
    ROW_TILE,
    _chunked_matmul_f64,
    _genotype_planes,
    _joint_int_matmuls,
    _joint_row_tile,
    _joint_tiles,
    _make_joint_fn,
    _pair_block_stats,
    _planes_and_tallies,
    _tally_matmuls,
    _two_sum,
)
from ntsm_tpu.eval.model import HET, HOM_AT, HOM_CG, UNKNOWN, CountData  # noqa: F401
from ntsm_tpu.eval.sharded import (  # noqa: F401
    _make_sharded_stats,
    _mesh_stat_planes,
    _pack_mesh_blob,
    _replicate_tree,
)
from ntsm_tpu.eval.wire import (  # noqa: F401
    _device_planes,
    _pad_sites,
    _upload_wires_streaming,
    _wire,
    _wire_plane,
    _wire_planes,
    load_count_data_eval,
)
from ntsm_tpu.options import Options
from ntsm_tpu.utils.device import require_accelerator
from ntsm_tpu.utils.formats import cpp_div  # noqa: F401

STREAM_PAIRS = 1 << 20  # packed-blob pairs per fetch chunk (~19 MB narrow)
PCA_FETCH_GROUP = 16  # -p pair blocks stacked per device->host fetch


def _auto_mesh():
    """The 1-D data mesh for eval sharding: the GLOBAL device mesh in
    multi-process mode (every process participates in the row-sharded
    stats — see the multi-host branch in compute_pair_stats_tpu), all
    local devices on a single process (a multi-GPU host / the virtual
    CPU mesh), or None on a single device."""
    from ntsm_tpu.parallel.mesh import data_mesh

    if jax.process_count() > 1:
        return data_mesh(jax.devices())
    if jax.local_device_count() > 1:
        return data_mesh(jax.local_devices())
    return None


def compute_pair_stats_tpu(
    data: CountData, opts: Options, mesh=None, packed: bool = False
) -> dict:
    """All [N, N] pairwise statistics on device; with `mesh`, the sample
    rows are sharded over the 1-D data mesh (each device scores its row
    block against the all_gather'ed planes).

    With `packed`, the i<j triangle of every statistic is gathered ON
    DEVICE into an (ll f32[2,P], ints u16[5,P], hi u8[P]) blob and
    fetched in three arrays per chunk instead of fourteen [N, N] planes,
    which cuts fetched bytes ~7x and turns ~110 transfers into 3 per
    STREAM_PAIRS chunk.  Returns per-pair vectors (see
    _finalize_packed)."""
    N = data.n_samples
    if mesh is not None:
        tallies_d, s1_d, joint_d = _mesh_stat_planes(data, opts, mesh)
        if packed and N >= 2:
            parts = _pack_mesh_blob(tallies_d, s1_d, joint_d, N, data.n_sites)
            parts = _replicate_tree(mesh, parts)
            P_ = (N * (N - 1)) // 2
            buf = _fetch_blob_slice(parts, 0, P_)
            iu, ju = np.triu_indices(N, 1)
            return dict(packed=True, iu=iu, ju=ju,
                        **_finalize_packed(data, opts, buf, iu, ju))
        tallies_d, s1_d, joint_d = _replicate_tree(
            mesh, (tallies_d, s1_d, joint_d)
        )
        sl = np.s_[:N, :N]
        tallies = {
            k: np.asarray(v).astype(np.int64)[sl] for k, v in tallies_d.items()
        }
        si_hi, si_lo, sf_hi, sf_lo = (
            np.asarray(x).astype(np.float64)[sl] for x in s1_d
        )
        s1 = (si_hi + si_lo) - (sf_hi + sf_lo)
        ih, il, fh, fl = (
            np.asarray(x).astype(np.float64)[sl] for x in joint_d
        )
        J = (ih + il) - (fh + fl)
        return _finalize_stats(data, opts, tallies, s1, J)

    tallies_d, s1_d, jint_d, a_d, b_d, v_t = _planes_and_tallies(
        *_device_planes(data),
        mc=float(opts.min_cov),
        chunk=CHUNK,
        n_valid=data.n_sites,
    )
    if packed and N >= 2:
        parts = _blob_from_planes(tallies_d, s1_d, jint_d,
                                  a_d, b_d, v_t, opts, N, data.n_sites)
        P = (N * (N - 1)) // 2
        buf = _fetch_blob_slice(parts, 0, P)
        iu, ju = np.triu_indices(N, 1)
        return dict(packed=True, iu=iu, ju=ju,
                    **_finalize_packed(data, opts, buf, iu, ju))

    joint_fn = _make_joint_fn(opts.min_cov)
    tallies, s1, jint = _fetch_full(tallies_d, s1_d, jint_d)
    J = np.zeros((N, N), np.float64)
    for r0 in range(0, N, ROW_TILE):
        r1 = min(r0 + ROW_TILE, N)
        ai, bi, vi = _joint_row_tile(a_d, b_d, v_t, r0, N)
        fh, fl = (
            np.asarray(x).astype(np.float64)
            for x in joint_fn(ai, bi, vi, a_d, b_d, v_t)
        )
        J[r0:r1] = jint[r0:r1] - ((fh + fl)[: r1 - r0])

    return _finalize_stats(data, opts, tallies, s1, J)


def _fetch_full(tallies_d, s1_d, jint_d):
    """Host fetch + f64 combine of the full [N, N] planes (the unpacked
    path)."""
    tallies = {k: np.asarray(v).astype(np.int64) for k, v in tallies_d.items()}
    si_hi, si_lo, sf_hi, sf_lo = (np.asarray(x).astype(np.float64) for x in s1_d)
    s1 = (si_hi + si_lo) - (sf_hi + sf_lo)
    jint = np.asarray(jint_d[0]).astype(np.float64) + np.asarray(
        jint_d[1]
    ).astype(np.float64)
    return tallies, s1, jint


def compute_score_all_tpu(data: CountData, opts: Options, out) -> None:
    """All-vs-all output identical in layout to the exact engine."""
    require_accelerator()
    mesh = _auto_mesh()
    out.write(HEADER)
    out.write("\n")
    if data.n_samples >= 2:
        _stream_packed_rows(data, opts, out, mesh=mesh)
        return
    stats = compute_pair_stats_tpu(data, opts, mesh=mesh)
    iu, ju, sc, cols = _triangle_vectors(stats, data.n_samples)
    lib = _load_row_formatter()
    samp_w = _sample_strings(data) if lib is not None else None
    _emit_pair_chunk(data, opts, out, iu, ju, sc, cols, lib, samp_w)


def _stream_packed_rows(data: CountData, opts: Options, out, mesh=None) -> None:
    """All-vs-all: fetch the device triangle blob in STREAM_PAIRS chunks
    on a prefetch thread while the host finalizes and formats the
    previous chunk — the device->host transfer overlaps the native row
    formatting.  Emission
    order is row-major i<j, identical to the unstreamed path.  With
    `mesh` the blob is packed from the row-sharded stat planes
    (_pack_mesh_blob) — same wire, same streaming.  Without a mesh the
    rect engine takes over: blocked i<j-only scoring that overlaps the
    load phase when the streaming loader attached a scorer (eval/rect.py).
    NTSM_EVAL_SQUARE=1 forces the legacy square single-device blob path
    (one [N, N] pass, recompiles per N) — kept for same-link A/B
    measurement against the rect engine."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    N = data.n_samples
    square = os.environ.get("NTSM_EVAL_SQUARE", "0") not in ("", "0")
    if mesh is None:
        if not square:
            from ntsm_tpu.eval.rect import stream_rect_rows

            stream_rect_rows(data, opts, out)
            return
        sc = getattr(data, "rect_scorer", None)
        if sc is not None:  # attached before the env check could apply
            sc.abort()
            data.rect_scorer = None
        tallies_d, s1_d, jint_d, a_d, b_d, v_t = _planes_and_tallies(
            *_device_planes(data),
            mc=float(opts.min_cov), chunk=CHUNK, n_valid=data.n_sites,
        )
        parts = _blob_from_planes(
            tallies_d, s1_d, jint_d, a_d, b_d, v_t, opts, N, data.n_sites
        )
    else:
        if not square:
            # production mesh path (single- AND multi-host): the rect
            # engine sharded over the mesh — i<j-only rects, load
            # overlap, 17 B/pair wire; multi-host processes feed the
            # identical deterministic dispatch sequence and fetch
            # replicated outputs (eval/rect_mesh.py).  The square
            # row-sharded path below is NTSM_EVAL_SQUARE=1 A/B only.
            from ntsm_tpu.eval.rect_mesh import stream_rect_rows_mesh

            stream_rect_rows_mesh(data, opts, out, mesh)
            return
        sc = getattr(data, "rect_scorer", None)
        if sc is not None:
            sc.abort()
            data.rect_scorer = None
        tallies_m, s1_m, joint_m = _mesh_stat_planes(data, opts, mesh)
        parts = _replicate_tree(
            mesh, _pack_mesh_blob(tallies_m, s1_m, joint_m, N, data.n_sites)
        )
    P = (N * (N - 1)) // 2
    iu, ju = np.triu_indices(N, 1)
    lib = _load_row_formatter()
    samp_w = _sample_strings(data) if lib is not None else None
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(_fetch_blob_slice, parts, 0, min(STREAM_PAIRS, P))
        for p0 in range(0, P, STREAM_PAIRS):
            p1 = min(p0 + STREAM_PAIRS, P)
            cur = fut.result()
            if p1 < P:
                fut = ex.submit(
                    _fetch_blob_slice, parts, p1, min(p1 + STREAM_PAIRS, P)
                )
            sl = slice(p0, p1)
            chunk = _finalize_packed(data, opts, cur, iu[sl], ju[sl])
            _emit_pair_chunk(
                data, opts, out, iu[sl], ju[sl], chunk["score"],
                [chunk[k] for k in PAIR_COL_KEYS], lib, samp_w,
            )


def compute_score_pca_tpu(data: CountData, opts: Options, out, cloud) -> None:
    """Device-batched PCA-filtered comparison: identical candidate set and
    emission order to compute_score_pca (eval/driver.py), pair scoring in
    PAIR_BLOCK batches on the device instead of the host pair loop.

    Score agreement with the exact engine matches the -a device engine
    (~1e-9 relative, identical tallies); use --engine exact for bit-level
    output parity.
    """
    from ntsm_tpu.eval.pca import pca_candidate_arrays, search_radii

    require_accelerator()

    radii = search_radii(data, opts)
    out.write(HEADER)
    out.write("\n")
    ii_all, jj_all = pca_candidate_arrays(cloud, radii, opts.dim)
    n_pairs_all = int(ii_all.shape[0])
    if not n_pairs_all:
        return

    A, B = _device_planes(data)
    cov = data.cov.astype(np.float64)

    emit_native = _load_row_formatter()
    samp_cache = _sample_strings(data) if emit_native is not None else None

    from concurrent.futures import ThreadPoolExecutor

    from ntsm_tpu.eval.kernels import (
        _chunk_planes,
        _pair_block_stats_v2,
        _pair_gather_g,
    )

    g = _pair_gather_g(A.shape[1])
    F_t = _chunk_planes(A, B, g)
    narrow = data.n_sites <= NARROW_WIRE_MAX_SITES

    # ONE upload of the whole candidate index list (padded to a block
    # multiple); blocks slice it device-side instead of one small upload
    # per block.
    ii_all = ii_all.astype(np.int32)
    jj_all = jj_all.astype(np.int32)
    pad = (-n_pairs_all) % PAIR_BLOCK
    ii_dev = jnp.asarray(
        np.pad(ii_all, (0, pad), constant_values=int(ii_all[0]))
    )
    jj_dev = jnp.asarray(
        np.pad(jj_all, (0, pad), constant_values=int(jj_all[0]))
    )

    def _dispatch(blk0: int):
        P = min(PAIR_BLOCK, n_pairs_all - blk0)
        dev = _pair_block_stats_v2(
            F_t, ii_dev[blk0 : blk0 + PAIR_BLOCK],
            jj_dev[blk0 : blk0 + PAIR_BLOCK],
            mc=float(opts.min_cov), n_valid=data.n_sites, narrow=narrow,
            g=g,
        )
        return ii_all[blk0 : blk0 + P], jj_all[blk0 : blk0 + P], P, dev

    # grouped pipeline: dispatch PCA_FETCH_GROUP pair blocks, stack their
    # wire parts device-side, fetch the stacked arrays per group on the
    # worker thread while the host finalizes and formats the previous
    # group — grouping cuts the transfer count 16x (PCA_FETCH_GROUP, not
    # yet re-tuned on the GPU).  The wire is the rect engine's 17 B/pair
    # narrow blob: ll-hi f32[1,P] + six u16 rows (5
    # statistic lows + bf16 loglik-lo bits) + u8 highs (28 B/pair as the
    # all-f32 [7, P] fallback on wide-count cohorts).
    def _dispatch_group(g0: int):
        metas, lls, ints, his = [], [], [], []
        end = min(g0 + PCA_FETCH_GROUP * PAIR_BLOCK, n_pairs_all)
        for blk0 in range(g0, end, PAIR_BLOCK):
            ii, jj, P, (ll, iv, hi) = _dispatch(blk0)
            metas.append((ii, jj, P))
            lls.append(ll)
            ints.append(iv)
            his.append(hi)
        return metas, (
            jnp.stack(lls),
            jnp.stack(ints),
            None if his[0] is None else jnp.stack(his),
        )

    def _fetch(stacked):
        ll, iv, hi = stacked
        return (
            np.asarray(ll),
            np.asarray(iv),
            None if hi is None else np.asarray(hi),
        )

    group_step = PCA_FETCH_GROUP * PAIR_BLOCK
    fetch_ex = ThreadPoolExecutor(1)
    try:
        metas, stacked = _dispatch_group(0)
        fut = fetch_ex.submit(_fetch, stacked)
        for g0 in range(0, n_pairs_all, group_step):
            cur_metas, blob_fut = metas, fut
            if g0 + group_step < n_pairs_all:
                metas, stacked = _dispatch_group(g0 + group_step)
                fut = fetch_ex.submit(_fetch, stacked)
            lls, ivs, his = blob_fut.result()
            for x, (ii, jj, P) in enumerate(cur_metas):
                _emit_pca_block(
                    data, opts, out, cov, emit_native, samp_cache, cloud,
                    ii, jj, P,
                    (lls[x], ivs[x], None if his is None else his[x]),
                )
    finally:
        fetch_ex.shutdown(wait=True)


def _emit_pca_block(data, opts, out, cov, emit_native, samp_cache, cloud,
                    ii, jj, P, blob) -> None:
    """Host finalize + emission for one fetched -p wire triple
    (ll f32[2, PAIR_BLOCK], ints, hi — the rect engine's 5-statistic
    blob, eval/blob.py; the loop body of compute_score_pca_tpu, split
    out so the pipeline can run it while the next block is in flight).
    The hom tallies are exact integer identities reconstructed by
    _unpack_blob; the compensated loglik pair was folded on device."""
    from ntsm_tpu.eval.pca import calc_distance_sq
    from ntsm_tpu.utils.formats import cpp_to_string

    ll, ints, hi = blob
    llp, iv8 = _unpack_blob(
        ll[:, :P], ints[:, :P], None if hi is None else hi[:P]
    )
    tallies = dict(
        zip(
            ("n", "ibs0", "shared_hets", "shared_homs", "hets1", "hets2",
             "homs1", "homs2"),
            iv8,
        )
    )
    loglik = llp[0].astype(np.float64) + llp[1].astype(np.float64)
    iv = ii[:P].astype(np.int64)
    jv = jj[:P].astype(np.int64)
    nvec = tallies["n"]
    with np.errstate(divide="ignore", invalid="ignore"):
        score_v = np.where(
            nvec > 0,
            loglik
            / (cov[iv] * cov[jv]) ** opts.cov_skew
            / np.maximum(nvec, 1).astype(np.float64),
            DBL_MAX,
        )
    if emit_native is not None:
        keep = (
            np.ones(P, dtype=bool)
            if opts.all
            else score_v < opts.score_thresh
        )
        kk = np.nonzero(keep)[0]
        if kk.size:
            same = (
                np.where(
                    score_v[kk] < opts.score_thresh, ord("1"), ord("0")
                ).astype(np.uint8)
                if opts.all
                else np.full(kk.size, ord("1"), dtype=np.uint8)
            )
            f3, i9 = _pair_columns(
                score_v[kk],
                tallies["ibs0"][kk],
                tallies["shared_hets"][kk],
                tallies["shared_homs"][kk],
                tallies["hets1"][kk],
                tallies["hets2"][kk],
                tallies["homs1"][kk],
                tallies["homs2"][kk],
                nvec[kk],
            )
            d = (
                cloud[iv[kk], : opts.dim] - cloud[jv[kk], : opts.dim]
            )
            dist_v = (d * d).sum(axis=1)
            _emit_rows_native(
                emit_native, data, out,
                np.ascontiguousarray(iv[kk].astype(np.int32)),
                np.ascontiguousarray(jv[kk].astype(np.int32)),
                f3, i9, same, dist_v, samp_w=samp_cache,
            )
        return
    for t in range(P):
        i, k = int(iv[t]), int(jv[t])
        n = int(tallies["n"][t])
        score = float(score_v[t])
        if not (opts.all or score < opts.score_thresh):
            continue
        r = Relate(
            ibs0=int(tallies["ibs0"][t]),
            ibs2=int(tallies["shared_hets"][t] + tallies["shared_homs"][t]),
            shared_homs=int(tallies["shared_homs"][t]),
            shared_hets=int(tallies["shared_hets"][t]),
            hets1=int(tallies["hets1"][t]),
            homs1=int(tallies["homs1"][t]),
            hets2=int(tallies["hets2"][t]),
            homs2=int(tallies["homs2"][t]),
        )
        r.hom_concord = cpp_div(
            float(r.shared_homs) - 2.0 * float(r.ibs0),
            float(min(r.homs1, r.homs2)),
        )
        r.relatedness = cpp_div(
            float(r.shared_hets) - 2.0 * float(r.ibs0),
            float(min(r.hets1, r.hets2)),
        )
        dist = cpp_to_string(calc_distance_sq(cloud, i, k, opts.dim))
        res = PairResult(i=i, j=k, score=score, n=n, relate=r)
        out.write(results_row(data, res, dist, opts))
        out.write("\n")
