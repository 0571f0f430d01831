"""Streaming -p engine: the rect treatment for the PCA-filtered path.

Round 4 ran the -p phases strictly serial — load, then projection, then
tier/candidate search, then device scoring.  This engine overlaps every
phase with the parse:

* Projection is per-sample, so each 256-row block of the count wire is
  projected the moment it parses (host worker thread; the row arithmetic
  is pca._project_rows — bitwise identical to project_pcs).
* The radius tier needs only per-sample stats (error rate, missing
  fraction), all final when the sample's file has parsed.
* A directed candidate pair (i, k) is decidable as soon as BOTH rows are
  resident: the streamed decision replicates pca_candidates' pruning on
  the incrementally-built distance matrix, so pairs are dispatched to
  the device pair-block kernel DURING the load, gathered from a device
  plane that is updated block by block as the uploads land.
* Scored statistics ride the 17 B/pair 5-statistic blob wire
  (eval/blob.py) and are stored by pair key; the end-of-run phase is the
  reference-order enumeration (order-exact vs compute_score_pca), the
  cov-skew score transform, and native row formatting.  Any enumerated
  pair the stream missed (robustness guard — the decision rule should
  make this empty) is scored in a final catch-up dispatch.

Reference being beaten: computeScorePCA's kd-tree search + serial pair
loop, /root/reference/src/CompareCounts.hpp:285-528."""

from __future__ import annotations

import functools
import os
import queue
import threading
import time

import numpy as np

import jax
import jax.numpy as jnp

from ntsm_tpu.eval.kernels import (
    CHUNK,
    PAIR_BLOCK,
    PAIR_GATHER_CHUNKS,
    _pair_block_stats_v2,
)

GROUP = 16  # pair blocks per index upload / stacked statistic fetch
BLOCK_ROWS = 256  # sample rows per device plane update


def _decide_new_block(sq, radii, s0: int, s1: int, INF: float):
    """Directed candidate pairs whose larger index lies in [s0, s1) —
    the streamed form of pca_candidates' pruning rules (eval/pca.py):
    every directed pair (searcher i, match k) is decidable the moment
    both rows are resident, because it needs only radii[i], radii[k] and
    sq[i, k].  Over all blocks this enumerates the pruned set exactly
    once (unit-tested against pca_candidates on random clouds/tiers).

    Returns (ii, kk) int32 arrays in arbitrary order (the end-of-run
    enumeration re-establishes the reference emission order)."""
    # searchers i in the new block against every resident k < s1
    i_idx = np.arange(s0, s1)[:, None]
    k_idx = np.arange(s1)[None, :]
    ri = radii[s0:s1][:, None]
    rk = radii[:s1][None, :]
    sqn = sq[s0:s1, :s1]
    fin = ri < INF
    mask1 = np.where(
        fin,
        (sqn < ri) & (((ri == rk) & (k_idx > i_idx)) | (ri > rk)),
        ~((rk == INF) & (k_idx <= i_idx)),
    )
    ii1, kk1 = np.nonzero(mask1)
    ii1 = (ii1 + s0).astype(np.int32)
    kk1 = kk1.astype(np.int32)
    if not s0:
        return ii1, kk1
    # old searchers i < s0 finding new matches k in [s0, s1): k > i
    # always, so the equal-radius tier keeps and the exhaustive tier
    # never skips
    rio = radii[:s0][:, None]
    rkn = radii[s0:s1][None, :]
    fino = rio < INF
    sqo = sq[:s0, s0:s1]
    mask2 = np.where(fino, (sqo < rio) & (rio >= rkn), True)
    ii2, kk2 = np.nonzero(mask2)
    return (
        np.concatenate([ii1, ii2.astype(np.int32)]),
        np.concatenate([kk1, (kk2 + s0).astype(np.int32)]),
    )


def _ft_shape(N: int, Lp: int, g: int):
    Lp2 = Lp + ((-Lp) % (CHUNK * g))
    Cg = Lp2 // (CHUNK * g)
    Npad = N + ((-N) % BLOCK_ROWS)
    return Cg, Npad, 2 * g * CHUNK


@jax.jit
def _ft_insert(F_t, blk_f, s0):
    """Write one fused row block into the gather plane at row s0.  No
    donation: the old buffer may still feed in-flight pair kernels; the
    copy is device-memory traffic (~1.3 GB at cohort scale)."""
    z = jnp.int32(0)
    return jax.lax.dynamic_update_slice(F_t, blk_f, (z, s0, z))


@functools.partial(jax.jit, static_argnames=("pad_cols", "pad_rows"))
def _fuse_block(a_blk, b_blk, pad_cols: int, pad_rows: int):
    """[R, Lp] u8/u16 wire block -> [Cg, R', 2*g*c] fused u16 chunk
    layout (the _chunk_planes row layout, for one row block)."""
    a = a_blk.astype(jnp.uint16)
    b = b_blk.astype(jnp.uint16)
    R, Lp = a.shape
    a = jnp.pad(a, ((0, pad_rows), (0, pad_cols)))
    b = jnp.pad(b, ((0, pad_rows), (0, pad_cols)))
    w = PAIR_GATHER_CHUNKS * CHUNK
    Cg = (Lp + pad_cols) // w
    sw = lambda x: jnp.swapaxes(  # noqa: E731
        x.reshape(R + pad_rows, Cg, w), 0, 1
    )
    return jnp.concatenate([sw(a), sw(b)], axis=2)


class PcaStreamEngine:
    """Feed host+device row blocks in sample order during the parse;
    collect reference-order scored rows at the end.

    Threads: the loader's parse thread enqueues host blocks; a host
    worker projects rows, assigns tiers, and decides candidate pairs; a
    dispatcher thread applies device plane updates and issues pair-block
    kernels (holding pair batches until their rows' upload has landed);
    a fetch thread pulls stacked statistic groups to host."""

    def __init__(self, n_samples: int, n_sites: int, Lp: int, opts):
        from ntsm_tpu.eval.pca import DBL_MAX, _ProjScratch
        from ntsm_tpu.utils.device import require_accelerator

        require_accelerator()
        self._trace = bool(int(os.environ.get("NTSM_PCA_TRACE", "0")))
        self._tr = dict(
            t0=time.perf_counter(), t_feed_done=0.0, t_host_done=0.0,
            t_disp_done=0.0, t_fetch_done=0.0, project=0.0, tier=0.0,
            sqdist=0.0, decide=0.0, host_wait=0.0, disp_idle=0.0,
            disp_issue=0.0, disp_update=0.0, fetch_wait=0.0, fetch_get=0.0,
            n_blocks=0, n_pairs=0, bytes_fetched=0, idx_upload=0.0,
        )
        self.N = int(n_samples)
        self.L = int(n_sites)
        self.Lp = int(Lp)
        self.opts = opts
        self.mc = float(opts.min_cov)
        self.dim = int(opts.dim)
        self.narrow = True  # u16 wire loader implies counts < 2^16 and
        # the statistics are bounded by n_sites; the wide tier never
        # streams (load_count_data_eval gates on n_sites too)
        self.DBL_MAX = DBL_MAX
        self.cloud = np.zeros((self.N, self.dim), np.float64)
        self.radii = np.full(self.N, DBL_MAX)
        self.sq = np.empty((self.N, self.N), np.float64)
        self.stats: dict = {}  # loader accumulators (stats_out)
        self._psc = _ProjScratch(min(self.N, 128), self.L, fast=True)
        self._rot = None  # (normv f64[L], rotT f64[L, dim]) once loaded
        self._exc: list[BaseException] = []
        # result stores, dispatch order
        self.keys: list[np.ndarray] = []  # directed i*N+k per block
        self.res_ll: list[np.ndarray] = []
        self.res_int: list[np.ndarray] = []
        self.res_hi: list[np.ndarray] = []

        g = PAIR_GATHER_CHUNKS
        Cg, Npad, w = _ft_shape(self.N, self.Lp, g)
        self._ft_dims = (Cg, Npad, w)
        self.F_t = None  # allocated lazily on the dispatcher thread

        # items are VIEWS into the loader's planes (no copies), so a deep
        # queue is free; a shallow one would backpressure the parse
        # thread — and with it the plane uploads — while the host worker
        # parses the rotation matrix (~1.9M strtold tokens, 10-30 s at
        # the human scale, overlapped with the parse by design)
        self._host_q: queue.Queue = queue.Queue(maxsize=64)
        self._work_q: queue.Queue = queue.Queue()
        self._results: queue.Queue = queue.Queue(maxsize=4)
        self._host_thread = threading.Thread(
            target=self._host_loop, daemon=True
        )
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True
        )
        self._fetcher = threading.Thread(target=self._fetch_loop, daemon=True)
        self._host_thread.start()
        self._dispatcher.start()
        self._fetcher.start()

    # -- feeding (parse thread) -------------------------------------
    def add_host_block(self, s0: int, s1: int, wa_blk, wb_blk) -> None:
        """Host wire rows [s0, s1) are final (u8/u16 views)."""
        if self._exc:
            return
        self._host_q.put(("blk", s0, s1, wa_blk, wb_blk))

    def add_dev_block(self, s0: int, s1: int, a_dev, b_dev) -> None:
        """The same rows have landed on device."""
        if self._exc:
            return
        self._work_q.put(("dev", s0, s1, a_dev, b_dev))

    def finish_feed(self) -> None:
        self._tr["t_feed_done"] = time.perf_counter()
        self._host_q.put(None)

    def abort(self) -> None:
        self._exc.append(RuntimeError("pca stream engine aborted"))
        self._host_q.put(None)
        self._work_q.put(None)

    # -- host worker: project, tier, decide ---------------------------
    def _load_rotation(self) -> None:
        from ntsm_tpu.eval.pca import load_norm_values, load_rotation

        norm = load_norm_values(self.opts.norm)
        rot = load_rotation(self.opts.pca, norm.shape[0])
        if self.opts.dim > rot.shape[0]:
            raise AssertionError("opt::dim exceeds component count (:155)")
        if norm.shape[0] != self.L:
            raise AssertionError(
                f"norm sites ({norm.shape[0]}) != cohort sites ({self.L})"
            )
        self._rot = (
            norm.astype(np.float64),
            rot[: self.dim].T.astype(np.float64),
        )

    def _host_loop(self) -> None:
        tr = self._tr
        try:
            self._load_rotation()
            while True:
                _t = time.perf_counter()
                item = self._host_q.get()
                tr["host_wait"] += time.perf_counter() - _t
                if item is None:
                    tr["t_host_done"] = time.perf_counter()
                    self._work_q.put(None)
                    return
                _, s0, s1, wa_blk, wb_blk = item
                self._host_block(s0, s1, wa_blk, wb_blk)
                tr["n_blocks"] += 1
        except BaseException as e:  # noqa: BLE001
            self._exc.append(e)
            self._work_q.put(None)
            while True:  # drain so the parse thread never blocks
                try:
                    if self._host_q.get_nowait() is None:
                        return
                except queue.Empty:
                    return

    def _host_block(self, s0: int, s1: int, wa_blk, wb_blk) -> None:
        from ntsm_tpu.eval.pca import _project_rows

        tr = self._tr
        L = self.L
        a = wa_blk[:, :L]
        b = wb_blk[:, :L]
        normv, rotT = self._rot
        _t = time.perf_counter()
        blk = self._psc.blk
        for r0 in range(0, s1 - s0, blk):
            r1 = min(r0 + blk, s1 - s0)
            _project_rows(
                self._psc, a[r0:r1], b[r0:r1], normv, rotT, self.mc,
                self.cloud[s0 + r0 : s0 + r1],
            )
        tr["project"] += time.perf_counter() - _t

        # radius tiers (search_radii, CompareCounts.hpp:294-308) from the
        # per-sample stats the loader has finalized for rows < s1
        _t = time.perf_counter()
        opts = self.opts
        st = self.stats
        miss = L - np.count_nonzero((a > self.mc) | (b > self.mc), axis=1)
        prop_missing = miss.astype(np.float64) / float(L)
        distinct_kmers = float(st["distinct"].sum())
        tks = st["tks"][s0:s1].astype(np.float64)
        kss = st["kss"][s0:s1].astype(np.float64)
        sums = st["samp_sum"][s0:s1].astype(np.float64)
        err = np.full(s1 - s0, -1.0)
        ok = (tks > 0) & (kss > 0)
        expected = tks[ok] * distinct_kmers / float(opts.genome_size)
        err[ok] = 1.0 - (sums[ok] / expected) ** (1.0 / kss[ok])
        rad = np.full(s1 - s0, self.DBL_MAX)
        tier1 = (err < opts.pc_error_thresh) & (
            prop_missing < opts.pc_miss_site1
        )
        tier2 = ~tier1 & (prop_missing < opts.pc_miss_site2)
        rad[tier1] = opts.pc_search_radius1 ** 2
        rad[tier2] = opts.pc_search_radius2 ** 2
        self.radii[s0:s1] = rad
        tr["tier"] += time.perf_counter() - _t

        # distance matrix rows [s0:s1) vs all resident columns [0, s1)
        # — 64-row sub-blocks, the exact per-entry arithmetic of
        # pca_candidates' blocked accumulation (bitwise-equal sq)
        _t = time.perf_counter()
        c = self.cloud[:, : self.dim]
        for r0 in range(s0, s1, 64):
            r1 = min(r0 + 64, s1)
            d = ((c[r0:r1, None, :] - c[None, :s1, :]) ** 2).sum(axis=2)
            self.sq[r0:r1, :s1] = d
            self.sq[:s1, r0:r1] = d.T
        tr["sqdist"] += time.perf_counter() - _t

        # directed candidate decisions for every pair whose larger index
        # is in this block (both rows resident)
        _t = time.perf_counter()
        ii_all, kk_all = _decide_new_block(
            self.sq, self.radii, s0, s1, self.DBL_MAX
        )
        tr["decide"] += time.perf_counter() - _t
        tr["n_pairs"] += ii_all.shape[0]
        if ii_all.shape[0]:
            self._work_q.put(("pairs", s1, ii_all, kk_all))

    # -- dispatcher: plane updates + pair kernels ----------------------
    def _dispatch_loop(self) -> None:
        tr = self._tr
        g = PAIR_GATHER_CHUNKS
        Cg, Npad, w = self._ft_dims
        rows_up = 0  # device rows present in F_t
        held: list[tuple] = []  # pair batches waiting for their rows
        pend_pairs: list[tuple] = []  # decided, rows resident, undispatched
        pend_n = 0
        pend_out: list[tuple] = []  # issued kernels awaiting a group fetch

        def flush_out() -> None:
            if not pend_out:
                return
            metas = [p[0] for p in pend_out]
            lls = jnp.stack([p[1][0] for p in pend_out])
            ints = jnp.stack([p[1][1] for p in pend_out])
            his = jnp.stack([p[1][2] for p in pend_out])
            pend_out.clear()
            self._results.put((metas, lls, ints, his))

        def issue(final: bool) -> None:
            """Upload pending pair indices (one transfer) and issue their
            pair-block kernels; group-fetch every GROUP blocks."""
            nonlocal pend_n
            if not pend_pairs or (not final and pend_n < GROUP * PAIR_BLOCK):
                return
            ii = np.concatenate([p[0] for p in pend_pairs])
            kk = np.concatenate([p[1] for p in pend_pairs])
            pend_pairs.clear()
            pend_n = 0
            take = ii.shape[0] if final else (
                ii.shape[0] // (GROUP * PAIR_BLOCK)
            ) * GROUP * PAIR_BLOCK
            if take < ii.shape[0]:
                pend_pairs.append((ii[take:], kk[take:]))
                pend_n = ii.shape[0] - take
                ii, kk = ii[:take], kk[:take]
            if ii.shape[0] == 0:
                return
            pad = (-ii.shape[0]) % PAIR_BLOCK
            _t = time.perf_counter()
            idx_dev = jnp.asarray(
                np.stack([
                    np.pad(ii, (0, pad), constant_values=0),
                    np.pad(kk, (0, pad), constant_values=0),
                ])
            )
            tr["idx_upload"] += time.perf_counter() - _t
            _t = time.perf_counter()
            for b0 in range(0, ii.shape[0], PAIR_BLOCK):
                P = min(PAIR_BLOCK, ii.shape[0] - b0)
                key = ii[b0 : b0 + P].astype(np.int64) * self.N + kk[
                    b0 : b0 + P
                ]
                self.keys.append(key)
                out = _pair_block_stats_v2(
                    self.F_t, idx_dev[0, b0 : b0 + PAIR_BLOCK],
                    idx_dev[1, b0 : b0 + PAIR_BLOCK],
                    mc=self.mc, n_valid=self.L, narrow=True, g=g,
                )
                pend_out.append((P, out))
                if len(pend_out) == GROUP:
                    flush_out()
            tr["disp_issue"] += time.perf_counter() - _t

        try:
            self.F_t = jnp.zeros((Cg, Npad, w), jnp.uint16)
            while True:
                _t = time.perf_counter()
                item = self._work_q.get()
                tr["disp_idle"] += time.perf_counter() - _t
                if item is None:
                    if held:  # invariant: all dev blocks precede the
                        # sentinel (load_count_data_eval finishes the
                        # uploads before finish_feed)
                        raise RuntimeError(
                            f"{sum(len(h[1]) for h in held)} decided "
                            "pairs never saw their device rows"
                        )
                    issue(final=True)
                    flush_out()
                    tr["t_disp_done"] = time.perf_counter()
                    self._results.put(None)
                    return
                if item[0] == "dev":
                    _, s0, s1, a_dev, b_dev = item
                    _t = time.perf_counter()
                    blk = _fuse_block(
                        a_dev, b_dev,
                        pad_cols=(Cg * w // 2) - self.Lp,
                        pad_rows=BLOCK_ROWS - (s1 - s0),
                    )
                    self.F_t = _ft_insert(self.F_t, blk, jnp.int32(s0))
                    rows_up = s1
                    tr["disp_update"] += time.perf_counter() - _t
                    still: list[tuple] = []
                    for req, ii, kk in held:
                        if req <= rows_up:
                            pend_pairs.append((ii, kk))
                            pend_n += ii.shape[0]
                        else:
                            still.append((req, ii, kk))
                    held[:] = still
                    issue(final=False)
                else:
                    _, req, ii, kk = item
                    if req <= rows_up:
                        pend_pairs.append((ii, kk))
                        pend_n += ii.shape[0]
                        issue(final=False)
                    else:
                        held.append((req, ii, kk))
        except BaseException as e:  # noqa: BLE001
            self._exc.append(e)
            self._results.put(None)

    # -- fetch worker ---------------------------------------------------
    def _fetch_loop(self) -> None:
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
                his = np.asarray(his)
                tr["fetch_get"] += time.perf_counter() - _t
                tr["bytes_fetched"] += (
                    lls.nbytes + ints.nbytes + his.nbytes
                )
                for x, P in enumerate(metas):
                    self.res_ll.append(lls[x][:, :P])
                    self.res_int.append(ints[x][:, :P])
                    self.res_hi.append(his[x][:P])
        except BaseException as e:  # noqa: BLE001
            self._exc.append(e)
            # keep CONSUMING until the dispatcher's None sentinel — a
            # get_nowait drain that returns on Empty leaves the
            # dispatcher blocked on the maxsize-4 queue once it refills
            # (the run would hang instead of raising _exc and the
            # driver's fall-back-to-serial path would never trigger);
            # every dispatcher exit path posts the sentinel
            while self._results.get() is not None:
                pass

    # -- completion -------------------------------------------------------
    def join(self) -> None:
        self._host_thread.join()
        self._dispatcher.join()
        self._fetcher.join()
        if self._exc:
            raise self._exc[0]

    def result_rows(self, data, opts, out) -> None:
        """Reference-order emission: enumerate candidates from the final
        cloud/radii/sq (order-exact vs compute_score_pca), look up each
        pair's streamed statistics, catch-up-score any the stream missed,
        and emit with the cov-skew transform."""
        from ntsm_tpu.eval.pca import pca_candidate_arrays, search_radii
        from ntsm_tpu.eval.tpu import _emit_pca_block
        from ntsm_tpu.eval.emit import _load_row_formatter, _sample_strings

        self.join()
        tr = self._tr
        t_tail = time.perf_counter()
        radii = search_radii(data, opts)
        if not np.array_equal(radii, self.radii):
            # should be impossible (same inputs, same formula); the
            # catch-up path below still yields correct output
            import sys

            print(
                "[pca stream] WARNING: streamed radii differ from "
                "search_radii; falling through to catch-up",
                file=sys.stderr,
            )
        t0 = time.perf_counter()
        enum_i, enum_k = pca_candidate_arrays(
            self.cloud[:, : self.dim], radii, self.dim, sq=self.sq
        )
        t_enum = time.perf_counter() - t0
        cov = data.cov.astype(np.float64)
        emit_native = _load_row_formatter()
        samp_cache = _sample_strings(data) if emit_native is not None else None

        if self.keys:
            keys = np.concatenate(self.keys)
            ll_s = np.concatenate(self.res_ll, axis=1)
            int_s = np.concatenate(self.res_int, axis=1)
            hi_s = np.concatenate(self.res_hi)
            order = np.argsort(keys, kind="stable")
            keys_sorted = keys[order]
        else:
            keys_sorted = np.empty(0, np.int64)
            order = np.empty(0, np.int64)
            ll_s = np.zeros((1, 0), np.float32)
            int_s = np.zeros((6, 0), np.uint16)
            hi_s = np.zeros(0, np.uint8)

        M = enum_i.shape[0]
        if M == 0:
            return
        want = enum_i * self.N + enum_k
        pos = np.searchsorted(keys_sorted, want)
        pos_c = np.minimum(pos, max(keys_sorted.shape[0] - 1, 0))
        found = (
            keys_sorted[pos_c] == want
            if keys_sorted.shape[0]
            else np.zeros(M, bool)
        )
        slot = np.where(found, order[pos_c] if order.shape[0] else 0, -1)

        n_miss = int(M - found.sum())
        if n_miss:
            miss_idx = np.nonzero(~found)[0]
            mll, mint, mhi = self._catchup(
                enum_i[miss_idx].astype(np.int32),
                enum_k[miss_idx].astype(np.int32),
            )
            ll_s = np.concatenate([ll_s, mll], axis=1)
            int_s = np.concatenate([int_s, mint], axis=1)
            hi_s = np.concatenate([hi_s, mhi])
            slot[miss_idx] = ll_s.shape[1] - n_miss + np.arange(n_miss)

        t0 = time.perf_counter()
        for b0 in range(0, M, PAIR_BLOCK):
            b1 = min(b0 + PAIR_BLOCK, M)
            sl = slot[b0:b1]
            _emit_pca_block(
                data, opts, out, cov, emit_native, samp_cache,
                self.cloud, enum_i[b0:b1], enum_k[b0:b1], b1 - b0,
                (ll_s[:, sl], int_s[:, sl], hi_s[sl]),
            )
        t_emit = time.perf_counter() - t0
        if self._trace:
            import sys

            t0_ = tr["t0"]
            print(
                "[pca stream trace] wall %.1f s (feed done +%.1f, host "
                "done +%.1f, dispatch done +%.1f, fetch done +%.1f); %d "
                "blocks, %d streamed pairs (%d missed -> catch-up); host: "
                "wait %.1f / project %.1f / tier %.1f / sqdist %.1f / "
                "decide %.1f s; dispatch: idle %.1f / update %.1f / "
                "idx-upload %.1f / issue %.1f s; fetch: wait %.1f / "
                "device-get %.1f s, %.1f MB; tail: enum %.1f / emit %.1f "
                "/ total %.1f s"
                % (
                    time.perf_counter() - t0_,
                    tr["t_feed_done"] - t0_, tr["t_host_done"] - t0_,
                    tr["t_disp_done"] - t0_, tr["t_fetch_done"] - t0_,
                    tr["n_blocks"], tr["n_pairs"], n_miss,
                    tr["host_wait"], tr["project"], tr["tier"],
                    tr["sqdist"], tr["decide"], tr["disp_idle"],
                    tr["disp_update"], tr["idx_upload"], tr["disp_issue"],
                    tr["fetch_wait"], tr["fetch_get"],
                    tr["bytes_fetched"] / 1e6, t_enum, t_emit,
                    time.perf_counter() - t_tail,
                ),
                file=sys.stderr, flush=True,
            )

    def _catchup(self, ii: np.ndarray, kk: np.ndarray):
        """Score pairs the stream missed (final F_t has every row).
        Kernels dispatch back-to-back and results cross as GROUP-stacked
        fetches — a per-block np.asarray loop would pay ~3 transfers per
        4096 pairs, the per-item-fetch pattern the main streamed path
        exists to avoid."""
        lls, ints, his = [], [], []
        pad = (-ii.shape[0]) % PAIR_BLOCK
        idx_dev = jnp.asarray(
            np.stack([
                np.pad(ii, (0, pad), constant_values=0),
                np.pad(kk, (0, pad), constant_values=0),
            ])
        )
        pend: list[tuple] = []  # (P, out) awaiting a stacked fetch

        def drain() -> None:
            if not pend:
                return
            ll_s = np.asarray(jnp.stack([o[0] for _, o in pend]))
            iv_s = np.asarray(jnp.stack([o[1] for _, o in pend]))
            hi_s = np.asarray(jnp.stack([o[2] for _, o in pend]))
            for x, (P, _) in enumerate(pend):
                lls.append(ll_s[x][:, :P])
                ints.append(iv_s[x][:, :P])
                his.append(hi_s[x][:P])
            pend.clear()

        for b0 in range(0, ii.shape[0], PAIR_BLOCK):
            P = min(PAIR_BLOCK, ii.shape[0] - b0)
            out = _pair_block_stats_v2(
                self.F_t, idx_dev[0, b0 : b0 + PAIR_BLOCK],
                idx_dev[1, b0 : b0 + PAIR_BLOCK],
                mc=self.mc, n_valid=self.L, narrow=True,
                g=PAIR_GATHER_CHUNKS,
            )
            pend.append((P, out))
            if len(pend) == GROUP:
                drain()
        drain()
        return (
            np.concatenate(lls, axis=1),
            np.concatenate(ints, axis=1),
            np.concatenate(his),
        )
