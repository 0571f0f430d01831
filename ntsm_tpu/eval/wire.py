"""Host->device count-plane wire: u8/u16 tiering, padded plane
construction, and the parse-overlapped streaming upload used by the eval
CLI's load phase.

Split out of eval/tpu.py (round 4).  Tier policy (u8 < 256 <= u16 <
65536 <= f32, error past 2^24) is deliberately replicated at every wire
producer — _wire, _wire_plane, load_count_wires' whole-plane narrowing,
and _upload_wires_streaming's per-block _put — keep them in sync."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ntsm_tpu.eval.kernels import CHUNK
from ntsm_tpu.options import Options


def _pad_sites(x: np.ndarray, c: int, value=0):
    L = x.shape[-1]
    pad = (-L) % c
    if pad:
        width = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
        x = np.pad(x, width, constant_values=value)
    return x


def _wire(x_np: np.ndarray) -> np.ndarray:
    """Count-plane wire format for the host->device upload.

    Counts are small integers (site max counts; ~2x coverage at the top),
    so a u8/u16 wire quarters/halves the transfer against f32 — the
    upload dominates eval wall time on slow links (N=3202 planes are
    ~2.5 GB as f32).  The device side widens back to f32 on entry (every
    consumer starts with .astype(float32), a no-op for an f32 input).
    Values that don't fit u16 fall back to f32 wire; f32 is exact for
    integers up to 2^24, so a count plane beyond that (unreachable for
    real coverage depths — 2^24 site hits of one allele in one sample)
    raises rather than silently rounding before the exact-integer-tally
    claims."""
    if x_np.size and x_np.min() >= 0.0:
        hi = x_np.max()
        if hi < 256.0:
            return x_np.astype(np.uint8)
        if hi < 65536.0:
            return x_np.astype(np.uint16)
    if x_np.size and x_np.max() > 2.0**24:
        raise ValueError(
            "count plane exceeds 2^24; the f32 wire fallback would round "
            f"integer counts (max={x_np.max():.0f})"
        )
    return x_np


def _wire_plane(counts: np.ndarray, allele: int, c: int) -> np.ndarray:
    """One allele's padded wire plane straight from the integer
    [N, L, 2] counts — u16 without an f32 intermediate.

    The f32 round-trip (strided astype + pad + u16 cast) was ~22 s of pure
    host time for an N=3202 cohort; this is two passes (int max + one
    strided int->u16 copy into the padded buffer).  Semantics identical to
    _wire(_pad_sites(x.astype(f32), c)): u16 when everything fits, else
    f32 with the 2^24 exactness guard."""
    x = counts[:, :, allele]
    N, L = x.shape
    Lp = L + ((-L) % c)
    hi = int(x.max()) if x.size else 0
    lo = int(x.min()) if x.size else 0
    if x.size and hi < 65536 and lo >= 0:
        out = np.zeros((N, Lp), dtype=np.uint8 if hi < 256 else np.uint16)
        out[:, :L] = x
        return out
    if x.size and hi > 2**24:
        raise ValueError(
            "count plane exceeds 2^24; the f32 wire fallback would round "
            f"integer counts (max={hi})"
        )
    out = np.zeros((N, Lp), dtype=np.float32)
    out[:, :L] = x
    return out


def _wire_planes(data) -> tuple[np.ndarray, np.ndarray]:
    """The two padded upload planes for a CountData: free in wire mode
    (the loader already built exactly these), one _wire_plane pass each
    in plane mode."""
    wa = getattr(data, "wire_at", None)
    if wa is not None and wa.shape[1] % CHUNK == 0:
        return wa, data.wire_cg
    return (
        _wire_plane(data.max_counts, 0, CHUNK),
        _wire_plane(data.max_counts, 1, CHUNK),
    )


def _device_planes(data) -> tuple:
    """Device-resident count planes for the single-device paths: planes
    already uploaded during the parse (load_count_data_eval's streaming
    loader) when available, else one upload here."""
    dev = getattr(data, "dev_planes", None)
    if dev is not None:
        return dev
    a_np, b_np = _wire_planes(data)
    return jnp.asarray(a_np), jnp.asarray(b_np)


def _upload_wires_streaming(paths, block_rows: int = 256, block_cb=None,
                            meta_cb=None, host_cb=None, stats_out=None,
                            upload: bool = True):
    """Parse count files into wire planes while uploading each finished
    256-row block to the device on a worker thread — the host parse
    (~6 ms/file) and the host->device plane transfer (the eval load
    phase's two big costs) overlap instead of serializing.

    Returns (wires_tuple, finish) or None when the wire loader can't
    apply (caller falls back to the plain loaders; any blocks already
    transferred are simply dropped).  finish() joins the in-flight
    transfers and returns (a_dev, b_dev) — deferred so the caller can run
    prepare() (a few host-seconds at cohort scale) while the tail blocks
    are still on the wire.  Per-block u8 narrowing matches
    load_count_wires' whole-plane tiering: a block rides the u8 wire iff
    its own max fits, and the device concat widens every block to the
    widest dtype seen.

    block_cb(s0, s1, a_dev, b_dev): optional hook invoked on the caller's
    thread as each block's transfer completes (in row order, after
    block_until_ready) — the pipelined scorer uses it to start block-pair
    dispatches while later files are still parsing.

    host_cb(s0, s1, wa_blk, wb_blk): optional hook invoked with the HOST
    row views the moment a block's rows are final, BEFORE its upload is
    queued — the streaming -p engine projects/tiers from it.  stats_out
    is forwarded to load_count_wires (live per-sample accumulators).

    upload=False skips the per-block device transfers entirely (finish()
    then returns None): the mesh rect engine replicates host blocks to
    the mesh itself, so single-device planes would be dead weight."""
    from concurrent.futures import ThreadPoolExecutor

    from ntsm_tpu.io.countfile import load_count_wires

    futs: list = []
    ex = ThreadPoolExecutor(1)

    def _put(blk: np.ndarray):
        # loader planes are already u8-tiered; the astype only runs for
        # u16 blocks that happen to fit (avoids a fresh-page cast per
        # block — slow on this VM, see load_count_wires)
        x = blk
        if blk.dtype != np.uint8 and int(blk.max()) < 256:
            x = blk.astype(np.uint8)
        d = jnp.asarray(x)
        # real backpressure: one in-flight transfer at a time
        d.block_until_ready()
        return d

    def cb(s0, s1, wa_blk, wb_blk):
        if host_cb is not None:
            host_cb(s0, s1, wa_blk, wb_blk)
        if not upload:
            return
        futs.append((s0, s1, ex.submit(_put, wa_blk), ex.submit(_put, wb_blk)))
        if block_cb is not None:
            # drain every COMPLETED transfer (don't block on in-flight
            # ones) so the scorer sees blocks as they land on device
            while drained[0] < len(futs):
                s0d, s1d, fa, fb = futs[drained[0]]
                if not (fa.done() and fb.done()):
                    break
                block_cb(s0d, s1d, fa.result(), fb.result())
                drained[0] += 1

    drained = [0]
    try:
        wires = load_count_wires(paths, block_cb=cb, block_rows=block_rows,
                                 meta_cb=meta_cb, stats_out=stats_out)
    except BaseException:
        ex.shutdown(wait=True)
        raise
    if wires is None or (upload and not futs):
        ex.shutdown(wait=True)
        return None
    if not upload:
        ex.shutdown(wait=True)

        def finish_noop():
            return None

        finish_noop.cancel = lambda: None
        return wires, finish_noop

    def finish():
        try:
            blocks = []
            for idx, (s0, s1, fa, fb) in enumerate(futs):
                a_blk, b_blk = fa.result(), fb.result()
                if block_cb is not None and drained[0] == idx:
                    block_cb(s0, s1, a_blk, b_blk)
                    drained[0] += 1
                blocks.append((a_blk, b_blk))
        finally:
            # a failed block upload (device OOM, lost device) must not
            # leak the non-daemon worker thread + its pinned blocks
            ex.shutdown(wait=True)
        wide = any(d.dtype == jnp.uint16 for pair in blocks for d in pair)
        dt = jnp.uint16 if wide else jnp.uint8
        a_d = jnp.concatenate([a.astype(dt) for a, _ in blocks], axis=0)
        b_d = jnp.concatenate([b.astype(dt) for _, b in blocks], axis=0)
        return a_d, b_d

    # abandon path (caller's prepare() raised): drop queued uploads,
    # join the in-flight one, free the worker thread
    finish.cancel = lambda: ex.shutdown(wait=True, cancel_futures=True)
    return wires, finish


def load_count_data_eval(paths, opts: Options):
    """CountData for the eval CLI: on the single-process device paths the
    plane upload rides the parse loop (_upload_wires_streaming), so the
    load phase costs max(parse, transfer) instead of their sum.  The
    exact engine, multi-host runs, merge-only mode, and -b debug defer to
    the plain loader (they never upload these planes, or shard them
    differently)."""
    from ntsm_tpu.eval import tpu as _tpu
    from ntsm_tpu.eval.model import CountData, load_count_data

    import os

    mesh = _tpu._auto_mesh()
    square = os.environ.get("NTSM_EVAL_SQUARE", "0") not in ("", "0")
    if (
        getattr(opts, "engine", "tpu") == "exact"
        or len(paths) < 2
        or getattr(opts, "only_merge", False)
        or getattr(opts, "debug", False)
        or jax.process_count() > 1  # multi-host: square mesh path, plain
        # loader (the rect-mesh block buffer is process-local)
        or (mesh is not None and square and not getattr(opts, "pca", None))
    ):
        return load_count_data(paths, opts)
    from ntsm_tpu.utils.device import require_accelerator

    require_accelerator()  # the planes are uploaded during the parse
    # pipelined -a scoring: a RectScorer created as soon as the first
    # file fixes the site count consumes the uploaded blocks DURING the
    # parse, so pair scoring and the statistic fetch overlap the load
    # phase.  -p runs get the same treatment via the
    # PcaStreamEngine: projection/tier/candidate
    # decisions ride the host rows and pair scoring the uploaded blocks.
    holder: dict = {}
    meta = None
    blk_cb = None
    host_cb = None
    stats_out: dict = {}
    if getattr(opts, "pca", None) and not getattr(opts, "debug", False):
        from ntsm_tpu.eval.pca_stream import PcaStreamEngine

        def meta(L, N):
            if N >= 2 and L <= _tpu.NARROW_WIRE_MAX_SITES:
                eng = PcaStreamEngine(N, L, L + ((-L) % CHUNK), opts)
                eng.stats = stats_out
                holder["pca"] = eng

        def host_cb(s0, s1, wa_blk, wb_blk):
            eng = holder.get("pca")
            if eng is not None:
                eng.add_host_block(s0, s1, wa_blk, wb_blk)

        def blk_cb(s0, s1, a_dev, b_dev):
            eng = holder.get("pca")
            if eng is not None:
                eng.add_dev_block(s0, s1, a_dev, b_dev)

    elif not getattr(opts, "pca", None) and os.environ.get(
        "NTSM_EVAL_SQUARE", "0"
    ) in ("", "0"):
        if mesh is not None:
            # mesh rect engine: fed host rows; it replicates blocks to
            # the mesh itself, so the single-device uploads are skipped
            from ntsm_tpu.eval.rect_mesh import MeshRectScorer

            def meta(L, N):
                if N >= 2:
                    holder["scorer"] = MeshRectScorer(
                        N, L, L + ((-L) % CHUNK), opts, mesh
                    )

            def host_cb(s0, s1, wa_blk, wb_blk):
                sc = holder.get("scorer")
                if sc is not None:
                    sc.add_host_rows(wa_blk, wb_blk)

        else:
            from ntsm_tpu.eval.rect import RectScorer

            def meta(L, N):
                if N >= 2:
                    holder["scorer"] = RectScorer(
                        N, L, L + ((-L) % CHUNK), opts
                    )

            def blk_cb(s0, s1, a_dev, b_dev):
                sc = holder.get("scorer")
                if sc is not None:
                    sc.add_rows(a_dev, b_dev)

    def _abort_engines():
        for key in ("scorer", "pca"):
            eng = holder.get(key)
            if eng is not None:
                eng.abort()

    res = _tpu._upload_wires_streaming(
        paths, block_cb=blk_cb, meta_cb=meta, host_cb=host_cb,
        stats_out=stats_out,
        upload=blk_cb is not None or host_cb is None,
    )
    if res is None:
        # the streaming attempt already ran the full wire parse; don't
        # let the plain loader repeat it before its plane fallbacks
        _abort_engines()
        return load_count_data(paths, opts, try_wires=False)
    wires, finish = res
    locus_ids, distinct, wa, wb, site_acc, samp_mc, samp_sum, tks, kss = wires
    try:
        data = CountData(
            filenames=list(paths),
            locus_ids=locus_ids,
            distinct=distinct,
            raw_total_kmers=tks,
            ks=kss,
            total_counts=samp_mc,
            wire_at=wa,
            wire_cg=wb,
            site_acc=site_acc,
            samp_sum=samp_sum,
        ).prepare(opts)  # runs while the tail upload blocks are in flight
    except BaseException:
        finish.cancel()  # join the in-flight transfers, free the worker
        _abort_engines()
        raise
    data.dev_planes = finish()
    sc = holder.get("scorer")
    if sc is not None:
        sc.finish_feed()
        data.rect_scorer = sc
    eng = holder.get("pca")
    if eng is not None:
        eng.finish_feed()
        data.pca_stream = eng
    return data
