"""Blocked rectangular all-vs-all engine: the -a production path.

The round-3 engine computed every statistic over the FULL [N, N] square
(then gathered the i<j triangle), and its score phase could only start
after the last count file was parsed and uploaded.  This engine fixes
both:

* Work is decomposed into fixed-shape rectangles — a 128-row tile of
  "j" samples against one 256-row uploaded block of "i" samples — so
  only the i<j triangle of the O(N²·sites) joint fractional pass is
  computed (the dominant device cost), and every shape is independent
  of N: ONE kernel compile serves every cohort size (the old engine
  recompiled _planes_and_tallies/_pack_triangle per N).

* A row tile becomes dispatchable the moment its own 256-row block has
  finished uploading — pairs (i, j), i < j are scorable once row j is
  resident — so device scoring and the statistic fetch run DURING the
  parse/upload phase.  End-to-end approaches max(load, score) + the
  final format pass instead of load + score.

Per-entry arithmetic reuses the exact kernels of the square engine
(_genotype_planes / _chunked_matmul_f64 / _joint_int_matmuls /
_joint_tiles and the _pack_triangle compensation order), so scores are
bitwise-identical to the round-3 packed path and integer statistics
remain exact.

Reference being beaten: the OpenMP pair loop of computeScore,
/root/reference/src/CompareCounts.hpp:591-624."""

from __future__ import annotations

import functools
import queue
import threading

import numpy as np

import jax
import jax.numpy as jnp

from ntsm_tpu.eval import blob as _blob
from ntsm_tpu.eval.blob import _narrow_ints
from ntsm_tpu.eval.kernels import (
    CHUNK,
    _chunked_matmul_f64,
    _dd_sub,
    _genotype_planes,
    _joint_int_matmuls,
    _joint_tiles,
)

ROWS = 128  # "j" rows per rect dispatch (half an upload block)
COLS = 256  # "i" columns per rect dispatch (= the upload block rows)
BATCH = 8  # rects stacked per device->host fetch: ~3 transfers per BATCH
# rects instead of ~3 per rect (not yet re-tuned on the GPU).  The
# 5-statistic wire (17 B/entry with the bf16 loglik-lo row,
# eval/blob.py) cuts bytes at the same transfer count.

# Diagonal rects (column block == row block) hold i >= j entries the
# host scatter discards, and the cohort's ragged final row tile holds
# j >= N pad rows — together 16% of fetched bytes at N=3202.  Diagonal rects therefore ship only their valid triangle via a
# static row-major gather (8128 of 32768 entries at half 0, 24512 at
# half 1), whose dj-sorted order makes "drop pad rows" a prefix slice;
# ragged tiles' full rects slice their row dim device-side before the
# stacked fetch.  Residual waste is the <=7-row slice round-up on one
# tile — fetched bytes ~= 19 B x P(1 + eps), eps < 1%.
_ROW_SLICE_PAD = 8  # ragged-tile row slice rounds up to this multiple


@functools.lru_cache(maxsize=None)
def _diag_host_idx(half: int):
    """Valid-entry coordinates (dj, di) of a diagonal rect half, ordered
    row-major by dj (i < j within the block: di < half*ROWS + dj)."""
    dj, di = np.nonzero(
        np.arange(COLS)[None, :] < (np.arange(ROWS)[:, None] + half * ROWS)
    )
    return dj.astype(np.int64), di.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _diag_flat_np(half: int) -> np.ndarray:
    """Flat [V] gather indices of a diagonal rect half.  HOST array on
    purpose: caching a jnp array here once leaked a tracer (first call
    landing inside a shard_map trace poisoned the cache for every later
    compile) — callers convert per use, a constant per compiled kind."""
    dj, di = _diag_host_idx(half)
    return (dj * COLS + di).astype(np.int32)


def _rect_diag_parts(parts, half: int, vr: int, dev_cache: dict | None = None):
    """Gather a diagonal rect's valid triangle on device (values are the
    untouched _rect_block_stats entries — bitwise identical to the full
    rect).  vr < ROWS additionally prefix-drops pad rows (dj >= vr).

    dev_cache (eager callers only — never under a trace, see
    _diag_flat_np's tracer-leak note) memoizes the device copy of the
    index vector per (half, length): the dispatcher hits this 2x per
    256-row block and each un-cached jnp.asarray is one more small
    host->device transfer."""
    ll, ints, hi = parts
    flat = _diag_flat_np(half)
    if vr < ROWS:
        dj, _ = _diag_host_idx(half)
        flat = flat[: int(np.searchsorted(dj, vr))]
    if dev_cache is not None:
        key = (half, flat.shape[0])
        cached = dev_cache.get(key)
        if cached is None:
            cached = dev_cache[key] = jnp.asarray(flat)
        flat = cached
    else:
        flat = jnp.asarray(flat)
    g = lambda x: x.reshape(x.shape[0], -1)[:, flat]  # noqa: E731
    return g(ll), g(ints), (None if hi is None else hi.reshape(-1)[flat])


def _f32mm(x, y):
    # 0/1 indicator planes only: exact at default precision (TF32 on the
    # GPU represents 0 and 1 exactly; the f32 sums stay below 2^24)
    return jnp.dot(x, y.T, preferred_element_type=jnp.float32)


def _rect_stats_impl(ra, rb, r0, ca, cb, *, mc: float, chunk: int,
                     n_valid, narrow: bool):
    """Packed statistics for one [ROWS, COLS] rectangle of pairs.

    ra/rb: [COLS, Lp] wire-dtype count planes of the row block (the
    "j" samples); r0 (traced): 0 or ROWS — which half-tile; ca/cb:
    [COLS, Lp] planes of the column block (the "i" samples).  Returns
    the same (ll f32[2, ROWS, COLS], ints, hi) wire as _pack_triangle,
    entry [., j − t0, i − k0] holding pair (i, j); invalid entries
    (i ≥ j, pad rows) are computed but discarded by the host scatter.

    Every constituent reuses the square engine's kernels on the rect
    shapes, preserving per-entry op order — scores match the round-3
    packed path bitwise, integer tallies are exact."""
    Lp = ra.shape[1]
    r0 = jnp.asarray(r0, jnp.int32)
    z = jnp.int32(0)
    ra = jax.lax.dynamic_slice(ra, (r0, z), (ROWS, Lp)).astype(jnp.float32)
    rb = jax.lax.dynamic_slice(rb, (r0, z), (ROWS, Lp)).astype(jnp.float32)
    ca = ca.astype(jnp.float32)
    cb = cb.astype(jnp.float32)
    mcf = jnp.float32(mc)
    het_r, hat_r, hcg_r, val_r, sint_r, sfrac_r = _genotype_planes(
        ra, rb, mcf, n_valid
    )
    het_c, hat_c, hcg_c, val_c, sint_c, sfrac_c = _genotype_planes(
        ca, cb, mcf, n_valid
    )

    # indicator tallies (exact 0/1 matmuls); both orientations — the row
    # sample is the pair's j, the column sample its i.  Only the 5-stat
    # wire is computed: the hom tallies are host-side identities of
    # these (see eval/blob.py), so their matmuls never run.
    n = _f32mm(val_r, val_c)
    shet = _f32mm(het_r, het_c)
    ibs0 = _f32mm(hat_r, hcg_c) + _f32mm(hcg_r, hat_c)
    hets_row = _f32mm(het_r, val_c)  # hets2 (sample j)
    hets_col = _f32mm(val_r, het_c)  # hets1 (sample i)

    C = Lp // chunk
    crow = (ROWS, C, chunk)
    ccol = (COLS, C, chunk)
    v_cc = val_c.reshape(ccol)
    v_rc = val_r.reshape(crow)
    # s1 sums over the pair mask, both orientations (compensated)
    si_row = _chunked_matmul_f64(sint_r.reshape(crow), v_cc)
    sf_row = _chunked_matmul_f64(sfrac_r.reshape(crow), v_cc)
    si_col = _chunked_matmul_f64(v_rc, sint_c.reshape(ccol))
    sf_col = _chunked_matmul_f64(v_rc, sfrac_c.reshape(ccol))

    jih, jil = _joint_int_matmuls(ra, rb, val_r, ca, cb, val_c, mc, chunk)

    sw = lambda x, s: jnp.swapaxes(x.reshape(s), 0, 1)  # noqa: E731
    jfh, jfl = _joint_tiles(
        sw(ra, crow), sw(rb, crow), sw(val_r, crow),
        sw(ca, ccol), sw(cb, ccol), sw(val_c, ccol), mcf,
    )

    # fold to the ll pair with _pack_triangle's exact compensation order
    jh, jl = _dd_sub(jih, jil, jfh, jfl)
    s1ij = _dd_sub(si_col[0], si_col[1], sf_col[0], sf_col[1])
    s1ji = _dd_sub(si_row[0], si_row[1], sf_row[0], sf_row[1])
    dh, dl = _dd_sub(jh, jl, *s1ij)
    dh, dl = _dd_sub(dh, dl, *s1ji)
    ll = jnp.stack([-2.0 * dh, -2.0 * dl])
    ints = jnp.stack([n, ibs0, shet, hets_col, hets_row])
    return _narrow_ints(ll, ints, narrow)


_rect_block_stats = functools.partial(
    jax.jit, static_argnames=("mc", "chunk", "n_valid", "narrow")
)(_rect_stats_impl)
# the un-jitted impl is shared with the mesh engine's shard_map body
# (eval/rect_mesh.py) — identical op sequence, so single-device and mesh
# rect results are bitwise equal


class RectScorer:
    """Incremental all-vs-all scorer: feed uploaded row blocks in order,
    collect the FINALIZED per-pair column arrays at the end.

    Threads: the caller (parse/upload loop) enqueues work; a dispatcher
    thread issues rect kernels (absorbing the one-time jit compile
    without stalling the parser) and stacks BATCH results per fetch; a
    fetch thread pulls each stacked batch to host, runs the
    cov-independent per-pair finalization, and scatters the (f3, i9)
    emission columns.  The bounded result queue backpressures device-side
    output pile-up."""

    def __init__(self, n_samples: int, n_sites: int, Lp: int, opts):
        import os
        import time

        from ntsm_tpu.utils.device import require_accelerator

        require_accelerator()
        if Lp % CHUNK:
            raise ValueError(f"Lp {Lp} not a multiple of CHUNK")
        # NTSM_RECT_TRACE=1: per-phase attribution for the score
        # phase — dispatch idle/busy split, fetch
        # bytes and wait, wall anchors.  One stderr line at result().
        self._trace = bool(int(os.environ.get("NTSM_RECT_TRACE", "0")))
        self._tr = dict(
            t0=time.perf_counter(), t_feed_done=0.0, t_disp_done=0.0,
            t_fetch_done=0.0, disp_idle=0.0, disp_issue=0.0,
            fetch_wait=0.0, fetch_get=0.0, scatter=0.0, disp_bp=0.0,
            n_rects=0, bytes_fetched=0,
        )
        self.N = int(n_samples)
        self.Lp = int(Lp)
        self.n_sites = int(n_sites)
        self.mc = float(opts.min_cov)
        self._cov_skew = float(opts.cov_skew)
        self.narrow = self.n_sites <= _blob.NARROW_WIRE_MAX_SITES
        self._diag_dev_cache: dict = {}  # (half, V) -> device idx vector
        P = self.N * (self.N - 1) // 2
        self.P = P
        # finalized per-pair columns (the _pair_columns / native-formatter
        # contract), filled by the fetch thread as rects land — the
        # end-of-run phase is pure formatting.  f3[:, 0] holds the raw
        # loglik until result() applies the cov-skew score transform (cov
        # isn't fully known until the last file parses).  np.zeros is
        # calloc-lazy, so the ~0.5 GB first-touch cost at cohort scale is
        # paid by the scatter writes, overlapped with the load phase.
        self.f3 = np.zeros((P, 3), np.float64)
        self.i9 = np.zeros((P, 9), np.int64)
        self.blocks: list[tuple] = []
        self._staged: list[tuple] = []
        self._staged_rows = 0
        self._rows_seen = 0
        self._work: queue.Queue = queue.Queue()
        self._results: queue.Queue = queue.Queue(maxsize=4)
        self._exc: list[BaseException] = []
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True
        )
        self._fetcher = threading.Thread(target=self._fetch_loop, daemon=True)
        self._dispatcher.start()
        self._fetcher.start()

    # -- feeding ---------------------------------------------------------
    def add_rows(self, a_piece, b_piece) -> None:
        """Append device plane pieces ([rows, Lp], wire dtype) in sample
        order; whole 256-row blocks are cut and their row tiles enqueued."""
        if self._exc:
            return  # result() will raise; keep the parse loop alive
        rows = a_piece.shape[0]
        if rows == 0:
            return
        self._staged.append((a_piece, b_piece))
        self._staged_rows += rows
        self._rows_seen += rows
        while self._staged_rows >= COLS:
            self._cut_block(pad=False)

    def finish_feed(self) -> None:
        """No more rows: pad the tail block and enqueue the sentinel."""
        import time

        if self._staged_rows > 0:
            self._cut_block(pad=True)
        self._tr["t_feed_done"] = time.perf_counter()
        self._work.put(None)

    def _cut_block(self, pad: bool) -> None:
        pieces_a = [p[0] for p in self._staged]
        pieces_b = [p[1] for p in self._staged]
        a = pieces_a[0] if len(pieces_a) == 1 else _concat_u16(pieces_a)
        b = pieces_b[0] if len(pieces_b) == 1 else _concat_u16(pieces_b)
        a = _to_u16(a)
        b = _to_u16(b)
        if a.shape[0] > COLS:
            a, a_rest = a[:COLS], a[COLS:]
            b, b_rest = b[:COLS], b[COLS:]
            self._staged = [(a_rest, b_rest)]
            self._staged_rows -= COLS
        else:
            if pad and a.shape[0] < COLS:
                w = ((0, COLS - a.shape[0]), (0, 0))
                a = jnp.pad(a, w)
                b = jnp.pad(b, w)
            self._staged = []
            self._staged_rows = 0
        bidx = len(self.blocks)
        self.blocks.append((a, b))
        # a block's arrival makes its two row tiles (and all pairs with
        # earlier columns) scorable
        for half in (0, 1):
            t0 = bidx * COLS + half * ROWS
            if t0 >= self.N:  # pure-pad tile: no pairs with j < N
                continue
            self._work.put((bidx, half))

    # -- device / fetch workers -----------------------------------------
    def _dispatch_loop(self) -> None:
        import time

        tr = self._tr
        # rect batches are stacked per KIND (full rects at a given row
        # slice; diagonal triangles at a given half+length) so every
        # stack is rectangular; all kinds but ("full", ROWS) are rare
        # (one diagonal per tile, ragged slices only on the final tile)
        pend: dict[tuple, list] = {}

        def flush(kind) -> None:
            items = pend.get(kind)
            if not items:
                return
            metas = [(t0, k0, kind) for t0, k0, _ in items]
            lls = jnp.stack([p[0] for _, _, p in items])
            ints = jnp.stack([p[1] for _, _, p in items])
            his = (
                None if items[0][2][2] is None
                else jnp.stack([p[2] for _, _, p in items])
            )
            items.clear()
            _t = time.perf_counter()
            self._results.put((metas, lls, ints, his))
            tr["disp_bp"] += time.perf_counter() - _t

        def add(kind, t0, k0, parts) -> None:
            items = pend.setdefault(kind, [])
            items.append((t0, k0, parts))
            if len(items) == BATCH:
                flush(kind)

        try:
            while True:
                _t = time.perf_counter()
                item = self._work.get()
                tr["disp_idle"] += time.perf_counter() - _t
                if item is None:
                    for kind in list(pend):
                        flush(kind)
                    tr["t_disp_done"] = time.perf_counter()
                    self._results.put(None)
                    return
                bidx, half = item
                ra, rb = self.blocks[bidx]
                r0 = half * ROWS
                t0 = bidx * COLS + r0
                vr = min(ROWS, self.N - t0)  # valid (non-pad) rows
                for k in range(bidx + 1):
                    ca, cb = self.blocks[k]
                    _t = time.perf_counter()
                    parts = _rect_block_stats(
                        ra, rb, r0, ca, cb,
                        mc=self.mc, chunk=CHUNK, n_valid=self.n_sites,
                        narrow=self.narrow,
                    )
                    if k == bidx:
                        # diagonal: ship only the i<j triangle (minus
                        # pad rows) — a static device gather
                        parts = _rect_diag_parts(
                            parts, half, vr, self._diag_dev_cache
                        )
                        kind = ("diag", half, int(parts[0].shape[1]))
                    elif vr < ROWS:
                        # ragged final tile: slice pad rows off before
                        # the stacked fetch (rounded for one compile)
                        vr8 = min(
                            ROWS,
                            -(-vr // _ROW_SLICE_PAD) * _ROW_SLICE_PAD,
                        )
                        ll, iv, hi = parts
                        parts = (
                            ll[:, :vr8], iv[:, :vr8],
                            None if hi is None else hi[:vr8],
                        )
                        kind = ("full", vr8)
                    else:
                        kind = ("full", ROWS)
                    tr["disp_issue"] += time.perf_counter() - _t
                    tr["n_rects"] += 1
                    add(kind, t0, k * COLS, parts)
        except BaseException as e:  # noqa: BLE001
            self._exc.append(e)
            self._results.put(None)

    def _fetch_loop(self) -> None:
        import time

        tr = self._tr
        try:
            while True:
                _t = time.perf_counter()
                item = self._results.get()
                tr["fetch_wait"] += time.perf_counter() - _t
                if item is None:
                    tr["t_fetch_done"] = time.perf_counter()
                    return
                metas, lls, ints, his = item
                _t = time.perf_counter()
                lls = np.asarray(lls)
                ints = np.asarray(ints)
                his = None if his is None else np.asarray(his)
                tr["fetch_get"] += time.perf_counter() - _t
                tr["bytes_fetched"] += lls.nbytes + ints.nbytes + (
                    0 if his is None else his.nbytes
                )
                _t = time.perf_counter()
                for x, (t0, k0, kind) in enumerate(metas):
                    self._finalize_scatter(
                        t0, k0, lls[x], ints[x],
                        None if his is None else his[x], kind,
                    )
                tr["scatter"] += time.perf_counter() - _t
        except BaseException as e:  # noqa: BLE001
            self._exc.append(e)
            # keep CONSUMING until the dispatcher's None sentinel: a
            # get_nowait drain that returns on Empty leaves the
            # dispatcher blocked forever on the maxsize-4 queue once it
            # fills again (eval would hang instead of surfacing _exc);
            # every dispatcher exit path — normal, exception, abort —
            # posts the sentinel, so this terminates
            while self._results.get() is not None:
                pass

    def _finalize_scatter(self, t0: int, k0: int, ll, ints, hi,
                          kind=("full", ROWS)) -> None:
        """Finalize one fetched rect's pairs into the [P, 3]/[P, 9]
        column arrays: unpack the wire, combine the compensated loglik in
        f64, and run the cov-independent column math (_pair_columns).
        Per-pair arithmetic is identical to the end-of-run
        _finalize_packed path it replaces (all elementwise ops).

        kind ("full", rows): ll is [2, rows, COLS] (rows < ROWS on the
        ragged final tile); kind ("diag", half, V): ll is [2, V], the
        static i<j triangle gather of _rect_diag_parts — every entry
        valid by construction."""
        from ntsm_tpu.eval.blob import _unpack_blob
        from ntsm_tpu.eval.emit import _pair_columns

        N = self.N
        if kind[0] == "diag":
            dj, di = _diag_host_idx(kind[1])
            V = kind[2]
            jj1 = t0 + dj[:V]
            ii1 = k0 + di[:V]
            pv = ii1 * N - (ii1 * (ii1 + 1)) // 2 + (jj1 - ii1 - 1)
            llp, iv = _unpack_blob(ll, ints, hi)
        else:
            rows = kind[1]
            jj = np.arange(t0, t0 + rows, dtype=np.int64)[:, None]
            ii = np.arange(k0, k0 + COLS, dtype=np.int64)[None, :]
            valid = (ii < jj) & (jj < N)
            if not valid.any():
                return
            # triu-major pair index: p = i·N − i(i+1)/2 + (j − i − 1)
            p = ii * N - (ii * (ii + 1)) // 2 + (jj - ii - 1)
            pv = p[valid]
            llp, iv = _unpack_blob(
                ll[:, valid], ints[:, valid],
                None if hi is None else hi[valid],
            )
        lls = llp[0].astype(np.float64) + llp[1].astype(np.float64)
        # f3[:, 0] gets the RAW loglik; result() applies the skew/score
        # transform once cov is complete
        f3c, i9c = _pair_columns(
            lls, iv[1], iv[2], iv[3], iv[4], iv[5], iv[6], iv[7], iv[0]
        )
        self.f3[pv] = f3c
        self.i9[pv] = i9c

    # -- completion ------------------------------------------------------
    def result(self, cov: np.ndarray):
        """Join the workers, apply the cov-skew score transform (same op
        order as _finalize_packed: CompareCounts.hpp:1093-1099 loglik,
        then /(cov_i·cov_j)^skew /max(n,1), DBL_MAX where n==0) and
        return the finalized (f3 [P, 3], i9 [P, 9]) column arrays in
        triu-major pair order — the _emit_prepared contract."""
        self._dispatcher.join()
        self._fetcher.join()
        if self._trace and not self._exc:
            import sys

            tr = self._tr
            t0 = tr["t0"]
            print(
                "[rect trace] wall %.1f s (feed done +%.1f, dispatch done "
                "+%.1f, fetch done +%.1f); %d rects; dispatch: idle %.1f / "
                "issue %.1f / result-backpressure %.1f s; fetch: wait %.1f "
                "/ device-get %.1f / scatter %.1f s; fetched %.1f MB "
                "(%.2f MB/s over device-get time)"
                % (
                    tr["t_fetch_done"] - t0, tr["t_feed_done"] - t0,
                    tr["t_disp_done"] - t0, tr["t_fetch_done"] - t0,
                    tr["n_rects"], tr["disp_idle"], tr["disp_issue"],
                    tr["disp_bp"], tr["fetch_wait"], tr["fetch_get"],
                    tr["scatter"], tr["bytes_fetched"] / 1e6,
                    tr["bytes_fetched"] / 1e6 / max(tr["fetch_get"], 1e-9),
                ),
                file=sys.stderr, flush=True,
            )
        if self._exc:
            raise self._exc[0]
        if self._rows_seen < self.N:
            raise RuntimeError(
                f"rect scorer fed {self._rows_seen} rows of {self.N}"
            )
        from ntsm_tpu.eval.exact import DBL_MAX

        iu, ju = np.triu_indices(self.N, 1)
        cov = np.asarray(cov, dtype=np.float64)
        n = self.i9[:, 8]
        with np.errstate(divide="ignore", invalid="ignore"):
            skewed = self.f3[:, 0] / (cov[iu] * cov[ju]) ** self._cov_skew
            self.f3[:, 0] = np.where(
                n > 0, skewed / np.maximum(n, 1.0), DBL_MAX
            )
        return self.f3, self.i9

    def abort(self) -> None:
        """Unblock the workers on an error path (loader fallback or a
        prepare() failure): no more feeding, results discarded."""
        self._exc.append(RuntimeError("rect scorer aborted"))
        self._work.put(None)


def _to_u16(x):
    """Normalize a wire block to u16 on device: one jit signature for
    every cohort (u8 wires are the norm; f32 wide wires keep f32 — the
    2^24 guard upstream makes their integers exact)."""
    if x.dtype == jnp.uint8 or x.dtype == jnp.uint16:
        return x.astype(jnp.uint16)
    return x.astype(jnp.float32)


def _concat_u16(pieces):
    wide = any(p.dtype not in (jnp.uint8, jnp.uint16) for p in pieces)
    dt = jnp.float32 if wide else jnp.uint16
    return jnp.concatenate([p.astype(dt) for p in pieces], axis=0)


def make_scorer_for_planes(data, opts, planes) -> RectScorer:
    """A RectScorer fed from already-resident device planes (the plain
    loader path): slices the [N, Lp] planes into 256-row blocks — the
    same block structure as the streamed path, so output is
    byte-identical either way."""
    A, B = planes
    N, Lp = A.shape
    sc = RectScorer(data.n_samples, data.n_sites, Lp, opts)
    for r0 in range(0, N, COLS):
        r1 = min(r0 + COLS, N)
        sc.add_rows(A[r0:r1], B[r0:r1])
    sc.finish_feed()
    return sc


def stream_rect_rows(data, opts, out) -> None:
    """All-vs-all emission through the rect engine: consume the scorer
    attached by the streaming loader (scoring AND per-pair finalization
    already ran during the parse) or build one from the device planes,
    then apply the score transform and format — the only end-of-run host
    math is the [P] skew pass and the native row formatting."""
    from ntsm_tpu.eval.wire import _device_planes

    scorer = getattr(data, "rect_scorer", None)
    if scorer is None:
        scorer = make_scorer_for_planes(data, opts, _device_planes(data))
    else:
        data.rect_scorer = None  # consumed
    _result_and_emit(scorer, data, opts, out)


def _result_and_emit(scorer, data, opts, out) -> None:
    """Shared tail of the rect engines (single-device and mesh): join
    the scorer, apply the cov-skew score transform, format natively."""
    from ntsm_tpu.eval import tpu as _tpu
    from ntsm_tpu.eval.emit import _emit_prepared, _sample_strings

    import time

    t0 = time.perf_counter()
    f3, i9 = scorer.result(data.cov)
    t_result = time.perf_counter() - t0
    iu, ju = np.triu_indices(data.n_samples, 1)
    lib = _tpu._load_row_formatter()  # via the module: monkeypatchable
    samp_w = _sample_strings(data) if lib is not None else None
    t0 = time.perf_counter()
    _emit_prepared(data, opts, out, iu, ju, f3, i9, lib, samp_w)
    if scorer._trace:
        import sys

        print(
            "[rect trace] tail: result(join+score transform) %.1f s, "
            "emit %.1f s" % (t_result, time.perf_counter() - t0),
            file=sys.stderr, flush=True,
        )
