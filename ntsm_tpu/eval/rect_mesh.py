"""Mesh-sharded rect engine: the blocked i<j all-vs-all scorer with its
rect axis sharded over the 1-D data mesh.

The legacy mesh path (eval/sharded.py) computes FULL row-sharded [N, N]
statistic squares — the i<j half is discarded at blob pack — and starts
only after the load.  This engine keeps the single-device rect design:

* work unit is the same [ROWS, COLS] rectangle; a dispatch stacks D
  same-kind rects ([D, 3] (block, r0, col-block) metadata sharded one
  row per device) and each device dynamic-slices its two blocks out of
  a REPLICATED [NB, 2, COLS, Lp] block buffer and runs the identical
  _rect_stats_impl op sequence — results are bitwise equal to the
  single-device rect engine, so golden/exact parity carries over.
* only the i<j triangle is computed (diag rects gather their static
  valid triangle on device; ragged final tiles slice pad rows), and the
  same 17 B/pair 5-statistic blob wire crosses per device.
* blocks are fed as HOST wire rows (from the streaming loader's host
  callback or post-load plane views); the dispatcher replicates each
  256-row block to the mesh and updates the buffer, so scoring overlaps
  the parse exactly like the single-device engine.

Replication traffic is one [2, COLS, Lp] block broadcast per 256
samples (~100 MB at the human site count) — the same bytes the
single-device path uploads, broadcast between the devices.

Multi-host: every process parses every count file (the established
multi-host eval contract — cli/eval_cmd.py buffers rank-0 output) and
feeds the identical deterministic block/dispatch sequence, so the
per-process jit/collective calls rendezvous in lockstep; stacked rect
outputs are resharded to replicated before the host fetch (each process
then reads its local copy — no per-fetch collective).  The 2-process
gloo cluster pins byte-parity vs the single-process mesh
(tests/test_distributed.py).

Reference being beaten: the OpenMP pair loop of computeScore,
/root/reference/src/CompareCounts.hpp:591-624, at N-chip scale."""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ntsm_tpu.eval.rect import (
    COLS,
    ROWS,
    RectScorer,
    _diag_flat_np,
    _diag_host_idx,
    _rect_stats_impl,
    _ROW_SLICE_PAD,
)
from ntsm_tpu.eval.kernels import CHUNK


@functools.lru_cache(maxsize=None)
def _mesh_rect_fn(mesh, kind, mc: float, chunk: int, n_valid: int,
                  narrow: bool, Lp: int):
    """One compiled stacked-rect kernel for a (mesh, kind) pair: buf
    [NB, 2, COLS, Lp] replicated, meta [D, 3] i32 sharded -> per-device
    rect wire parts stacked on the sharded axis."""
    from ntsm_tpu.parallel.mesh import P, shard_map

    out_spec = (P("data"), P("data"), P("data"))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P("data")),
        out_specs=out_spec,
        check_vma=False,
    )
    def fn(buf, meta):
        bidx = meta[0, 0]
        r0 = meta[0, 1]
        k = meta[0, 2]
        blk = jax.lax.dynamic_index_in_dim(buf, bidx, 0, keepdims=False)
        cblk = jax.lax.dynamic_index_in_dim(buf, k, 0, keepdims=False)
        ll, ints, hi = _rect_stats_impl(
            blk[0], blk[1], r0, cblk[0], cblk[1],
            mc=mc, chunk=chunk, n_valid=n_valid, narrow=narrow,
        )
        if hi is None:  # wide tier: dummy hi row keeps one out structure
            hi = jnp.zeros(ll.shape[1:], jnp.uint8)
        if kind[0] == "diag":
            half, V = kind[1], kind[2]
            flat = jnp.asarray(_diag_flat_np(half)[:V])
            g = lambda x: x.reshape(x.shape[0], -1)[:, flat]  # noqa: E731
            ll, ints, hi = g(ll), g(ints), hi.reshape(-1)[flat]
        elif kind[1] < ROWS:
            rows = kind[1]
            ll, ints, hi = ll[:, :rows], ints[:, :rows], hi[:rows]
        return ll[None], ints[None], hi[None]

    return jax.jit(fn)


class MeshRectScorer(RectScorer):
    """Rect scorer whose rect dispatches are sharded over a 1-D device
    mesh.  Feed HOST wire row pieces (add_host_rows) in sample order —
    the dispatcher thread replicates whole 256-row blocks to the mesh;
    everything else (finalize/scatter/result) is the base engine."""

    def __init__(self, n_samples: int, n_sites: int, Lp: int, opts, mesh):
        self.mesh = mesh
        self.D = int(mesh.devices.size)
        self._host_staged: list = []
        self._host_staged_rows = 0
        self._n_blocks_fed = 0
        super().__init__(n_samples, n_sites, Lp, opts)

    # -- feeding: host rows instead of device pieces --------------------
    def add_rows(self, a_piece, b_piece) -> None:  # pragma: no cover
        raise TypeError("MeshRectScorer is fed host rows (add_host_rows)")

    def add_host_rows(self, a_rows: np.ndarray, b_rows: np.ndarray) -> None:
        """[rows, >=L] host wire rows (u8/u16 views), sample order; whole
        COLS-row blocks are cut and handed to the dispatcher."""
        if self._exc:
            return
        rows = a_rows.shape[0]
        if rows == 0:
            return
        self._host_staged.append((a_rows, b_rows))
        self._host_staged_rows += rows
        self._rows_seen += rows
        while self._host_staged_rows >= COLS:
            self._cut_host_block(pad=False)

    def finish_feed(self) -> None:
        import time

        if self._host_staged_rows > 0:
            self._cut_host_block(pad=True)
        self._tr["t_feed_done"] = time.perf_counter()
        self._work.put(None)

    def _cut_host_block(self, pad: bool) -> None:
        a = np.concatenate([p[0] for p in self._host_staged], axis=0) \
            if len(self._host_staged) > 1 else self._host_staged[0][0]
        b = np.concatenate([p[1] for p in self._host_staged], axis=0) \
            if len(self._host_staged) > 1 else self._host_staged[0][1]
        if a.shape[0] > COLS:
            self._host_staged = [(a[COLS:], b[COLS:])]
            self._host_staged_rows -= COLS
            a, b = a[:COLS], b[:COLS]
        else:
            self._host_staged = []
            self._host_staged_rows = 0
        # mirror rect._to_u16's dtype contract: u8/u16 wires ride u16,
        # the wide (counts >= 2^16) f32 wire keeps f32 — a u16 buffer
        # would silently C-cast those values mod 2^16
        wide = a.dtype not in (np.uint8, np.uint16)
        blk = np.zeros((2, COLS, self.Lp),
                       np.float32 if wide else np.uint16)
        L = min(a.shape[1], self.Lp)
        blk[0, : a.shape[0], :L] = a[:, :L]
        blk[1, : b.shape[0], :L] = b[:, :L]
        bidx = self._n_blocks_fed
        self._n_blocks_fed += 1
        self._work.put(("blk", bidx, blk))

    # -- dispatcher: replicate blocks, stack same-kind rects ------------
    def _dispatch_loop(self) -> None:
        import time

        from jax.sharding import NamedSharding

        from ntsm_tpu.parallel.mesh import P

        tr = self._tr
        mesh = self.mesh
        D = self.D
        rep = NamedSharding(mesh, P())
        row_sh = NamedSharding(mesh, P("data"))
        NB = (self.N + COLS - 1) // COLS
        Lp = self.Lp
        buf = None
        upd = jax.jit(
            lambda bf, blk, i: jax.lax.dynamic_update_slice(
                bf, blk[None], (i, jnp.int32(0), jnp.int32(0), jnp.int32(0))
            ),
            out_shardings=rep,
        )
        pend: dict[tuple, list] = {}  # kind -> [(t0, k0, bidx, r0, k)]

        def flush(kind) -> None:
            """Dispatch one stacked batch of up to D same-kind rects
            (padded with dummy copies of the first; their fetched
            entries are dropped by meta=None)."""
            items = pend.get(kind)
            if not items:
                return
            take = items[:D]
            del items[:D]
            metas = [(t0, k0, kind) for t0, k0, _, _, _ in take]
            metas += [None] * (D - len(take))
            mrows = np.array(
                [(b, r, k) for _, _, b, r, k in take]
                + [take[0][2:]] * (D - len(take)),
                dtype=np.int32,
            )
            _t = time.perf_counter()
            meta_dev = jax.device_put(mrows, row_sh)
            fn = _mesh_rect_fn(
                mesh, kind, self.mc, CHUNK, self.n_sites, self.narrow, Lp
            )
            lls, ints, his = fn(buf, meta_dev)
            tr["disp_issue"] += time.perf_counter() - _t
            tr["n_rects"] += len(take)
            _t = time.perf_counter()
            # his is always a device stack here (dummy zeros on the wide
            # tier); the fetch loop drops it for wide after the fetch
            self._results.put((metas, lls, ints, his))
            tr["disp_bp"] += time.perf_counter() - _t

        try:
            # buf dtype follows the cohort's count tier (u16 for the
            # u8/u16 wires, f32 for the wide >=2^16 tier — which only
            # arrives post-load, so every block shares one dtype);
            # allocated on the first block
            while True:
                _t = time.perf_counter()
                item = self._work.get()
                tr["disp_idle"] += time.perf_counter() - _t
                if item is None:
                    for kind in list(pend):
                        while pend[kind]:
                            flush(kind)
                    tr["t_disp_done"] = time.perf_counter()
                    self._results.put(None)
                    return
                _, bidx, blk = item
                _t = time.perf_counter()
                if buf is None:
                    buf = jax.device_put(
                        np.zeros((max(NB, 1), 2, COLS, Lp), blk.dtype), rep
                    )
                buf = upd(buf, jax.device_put(blk, rep), jnp.int32(bidx))
                tr["disp_update"] = tr.get("disp_update", 0.0) + (
                    time.perf_counter() - _t
                )
                for half in (0, 1):
                    t0 = bidx * COLS + half * ROWS
                    if t0 >= self.N:
                        continue
                    vr = min(ROWS, self.N - t0)
                    r0 = half * ROWS
                    for k in range(bidx + 1):
                        if k == bidx:
                            dj, _ = _diag_host_idx(half)
                            V = int(np.searchsorted(dj, vr))
                            kind = ("diag", half, V)
                        elif vr < ROWS:
                            kind = ("full", min(
                                ROWS, -(-vr // _ROW_SLICE_PAD) * _ROW_SLICE_PAD
                            ))
                        else:
                            kind = ("full", ROWS)
                        pend.setdefault(kind, []).append(
                            (t0, k * COLS, bidx, r0, k)
                        )
                        if len(pend[kind]) >= D:
                            flush(kind)
        except BaseException as e:  # noqa: BLE001
            self._exc.append(e)
            self._results.put(None)

    def _replicate(self, lls, ints, his):
        """jit identity resharding the stacked rect parts to replicated
        (multi-host fetch path); one cached program per part structure."""
        from jax.sharding import NamedSharding

        from ntsm_tpu.parallel.mesh import P

        fn = self.__dict__.get("_rep_fn")
        if fn is None:
            rep = NamedSharding(self.mesh, P())
            fn = self._rep_fn = jax.jit(
                lambda a, b, c: (a, b, c),
                out_shardings=(rep, rep, rep),
            )
        return fn(lls, ints, his)

    def _fetch_loop(self) -> None:
        """Same as the base fetch loop, but metas may contain None rows
        (dummy pad rects of a partial batch) and stacked parts arrive as
        mesh-sharded arrays (np.asarray assembles single-process;
        multi-host reshards to replicated first)."""
        import queue
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
                if jax.process_count() > 1:
                    # reshard to replicated so every process fetches its
                    # local copy (np.asarray of a cross-process-sharded
                    # array would touch non-addressable shards)
                    lls, ints, his = self._replicate(lls, ints, his)
                lls = np.asarray(lls)
                ints = np.asarray(ints)
                his = np.asarray(his) if self.narrow else None
                tr["fetch_get"] += time.perf_counter() - _t
                live = sum(1 for m in metas if m is not None)
                per = lls[0].nbytes + ints[0].nbytes + (
                    0 if his is None else his[0].nbytes
                )
                tr["bytes_fetched"] += per * live
                _t = time.perf_counter()
                for x, m in enumerate(metas):
                    if m is None:
                        continue
                    t0, k0, kind = m
                    self._finalize_scatter(
                        t0, k0, lls[x], ints[x],
                        None if his is None else his[x], kind,
                    )
                tr["scatter"] += time.perf_counter() - _t
        except BaseException as e:  # noqa: BLE001
            self._exc.append(e)
            while True:
                try:
                    if self._results.get_nowait() is None:
                        return
                except queue.Empty:
                    return


def make_mesh_scorer_for_data(data, opts, mesh) -> MeshRectScorer:
    """A MeshRectScorer fed from the cohort's host wire planes (the
    post-load path): same COLS-block structure as streamed feeding."""
    from ntsm_tpu.eval.wire import _wire_planes

    a_np, b_np = _wire_planes(data)
    N = data.n_samples
    Lp = a_np.shape[1]
    sc = MeshRectScorer(N, data.n_sites, Lp, opts, mesh)
    for r0 in range(0, N, COLS):
        r1 = min(r0 + COLS, N)
        sc.add_host_rows(a_np[r0:r1], b_np[r0:r1])
    sc.finish_feed()
    return sc


def stream_rect_rows_mesh(data, opts, out, mesh) -> None:
    """All-vs-all emission through the mesh rect engine: consume the
    scorer attached by the streaming loader or build one from the host
    planes, then the shared score-transform + native-format tail."""
    from ntsm_tpu.eval.rect import _result_and_emit

    scorer = getattr(data, "rect_scorer", None)
    if isinstance(scorer, MeshRectScorer):
        data.rect_scorer = None
    else:
        if scorer is not None:  # a single-device scorer was attached
            scorer.abort()
            data.rect_scorer = None
        scorer = make_mesh_scorer_for_data(data, opts, mesh)
    _result_and_emit(scorer, data, opts, out)
