"""Counting engine: host feed pipeline + jitted device steps.

Replaces FingerPrint::computeCounts' thread-per-file OpenMP loop
(src/FingerPrint.hpp:46-87) with a host reader producing fixed-shape
batches and a device accumulation loop.  Early termination (-m) is
evaluated between batches against the same threshold formula
(FingerPrint.hpp:41-43,476-487); because the reference checks per read and
processes files in nondeterministic thread order, -m results are
read-order-dependent there too — we define the order as "batch boundary".

Multi-chip: batches are sharded over a 1-D data mesh; every device keeps a
private count vector (no atomics, unlike FingerPrint.hpp:93-102) and the
single merge happens at the end (psum over the mesh) — see
ntsm_tpu/parallel/mesh.py.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ntsm_tpu.count.golden import CountResult, max_counts_threshold
from ntsm_tpu.count.kernel import count_step, make_table_arrays
from ntsm_tpu.io.fastx import BatchReader
from ntsm_tpu.io.sites import SiteTable
from ntsm_tpu.options import Options
from ntsm_tpu.utils.formats import cpp_general


@dataclass
class EngineConfig:
    batch_reads: int = 32768
    segment_len: int = 256
    early_term_check_every: int = 8  # batches between host-side -m checks
    cand_k: int | None = None  # v3 candidate width override (tests)
    checkpoint_path: str | None = None  # periodic restartable snapshots
    checkpoint_every: int = 64  # batches between snapshots
    fail_after_batches: int | None = None  # fault injection (tests)
    dense: bool = True  # pack reads per row (separator + k-1 halo)
    upload_depth: int = 3  # producer-thread upload queue depth


def run_count_v3(
    table: SiteTable,
    filenames,
    opts: Options,
    config: EngineConfig | None = None,
    mesh=None,
) -> CountResult:
    """v3 pipeline: fingerprint-filtered probe with device-resident counts.

    The count vector lives on device for the whole run; the host fetches
    only a [3]-vector of diagnostics per batch, drained in one stacked
    fetch per `early_term_check_every` batches instead of a host sync per
    batch.
    """
    from collections import deque

    from ntsm_tpu.count.kernel_v2 import pack_batch_fast
    from ntsm_tpu.count.kernel_v3 import (
        count_step_v3,
        fuse_packed,
        split_fused,
        table_v3_for,
    )
    config = config or EngineConfig(
        batch_reads=opts.batch_reads,
        segment_len=opts.segment_len,
        checkpoint_path=getattr(opts, "checkpoint", None),
        checkpoint_every=getattr(opts, "checkpoint_every", 64),
    )
    k = table.k
    n_kmers = table.n_kmers
    tab = table_v3_for(table)
    kw = dict(
        k=k,
        L=config.segment_len,
        n_buckets=tab.n_buckets,
        slots=tab.slots,
        bbits=tab.bbits,
    )
    if config.cand_k is not None:
        kw["cand_k"] = config.cand_k

    n_dev = 1
    sharded_step = None
    if mesh is not None:
        from ntsm_tpu.parallel.mesh import make_sharded_count_step_v3

        n_dev = mesh.devices.size
        if config.batch_reads % n_dev:
            raise ValueError(
                f"batch_reads {config.batch_reads} not divisible by "
                f"mesh size {n_dev}"
            )
        sharded_step = make_sharded_count_step_v3(mesh, **kw)

    sorted_hashes = getattr(table, "_sorted_hashes", None)
    if sorted_hashes is None:
        sorted_hashes = table._sorted_hashes = np.sort(table.kmer_hashes)
        table._sort_order = np.argsort(table.kmer_hashes, kind="stable")
    sort_order = table._sort_order

    if mesh is None:
        counts = jnp.zeros(n_kmers + 1, dtype=jnp.int32)
    else:
        counts = jnp.zeros((n_dev, n_kmers + 1), dtype=jnp.int32)
    host_counts = np.zeros(n_kmers, dtype=np.int64)  # overflow recounts
    total_kmers = 0
    total_hits = 0
    total_bases = 0
    total_reads = 0
    max_counts = max_counts_threshold(n_kmers, opts.cov_thresh)
    check_term = max_counts != 0 and not math.isinf(max_counts)
    early = False
    n_retry = 0  # overflowed batches recounted by the big-K device step
    n_host = 0  # overflowed batch shards recounted exactly on the host

    from ntsm_tpu.count.golden import count_codes_batch
    from ntsm_tpu.count.kernel_v3 import CAND_K

    eff_cand_k = config.cand_k if config.cand_k is not None else CAND_K

    # --- checkpoint/resume (see count/checkpoint.py) ---
    skip_batches = 0
    sig = None
    if config.checkpoint_path:
        from ntsm_tpu.count.checkpoint import load_snapshot, params_sig

        sig = params_sig(
            filenames,
            k,
            config.segment_len,
            config.batch_reads,
            n_kmers,
            dense=config.dense,
        )
        snap = load_snapshot(config.checkpoint_path, sig)
        if snap is not None:
            skip_batches = snap["n_batches"]
            host_counts += snap["counts"]
            total_kmers = snap["total_kmers"]
            total_hits = snap["total_hits"]
            total_bases = snap["total_bases"]
            total_reads = snap["total_reads"]
            import sys

            print(
                f"Resuming from checkpoint {config.checkpoint_path} "
                f"({skip_batches} batches done)",
                file=sys.stderr,
            )

    def merged_counts_np() -> np.ndarray:
        c = counts
        if mesh is not None:
            from ntsm_tpu.parallel.mesh import merge_counts_across_devices

            c = merge_counts_across_devices(c)
        return np.asarray(c)[:n_kmers].astype(np.int64) + host_counts

    n_threads = min(getattr(opts, "threads", 1), len(filenames))
    if n_threads > 1 and not config.checkpoint_path:
        # thread-per-file-group fan-out (the reference's -t semantics,
        # FingerPrint.hpp:47); checkpointing needs the deterministic
        # single-stream order, so -t falls back to it there
        from ntsm_tpu.io.fastx import ParallelFileReader

        reader = ParallelFileReader(
            filenames,
            k=k,
            seglen=config.segment_len,
            batch=config.batch_reads,
            threads=n_threads,
            dense=config.dense,
        )
    else:
        if n_threads > 1 and config.checkpoint_path:
            import sys as _sys

            print(
                "ntsm count: --checkpoint requires the deterministic "
                "single-stream reader; -t ignored",
                file=_sys.stderr,
            )
        reader = BatchReader(
            filenames,
            k=k,
            seglen=config.segment_len,
            batch=config.batch_reads,
            dense=config.dense,
        )
    # drain window: one device->host fetch per `window` drained batches;
    # the default of 8 keeps <=16 batches (~134 MB of fallback codes)
    # pending
    window = max(2, config.early_term_check_every)
    pending: deque = deque()  # (diag device array, host codes for fallback)

    # overflow retry: a site-dense batch (candidates > cand_k) is re-run
    # on device with an 8x candidate budget before falling back to the
    # exact host recount — amplicon-style input stays on the fast path.
    RETRY_K = (
        eff_cand_k * 8
        if config.cand_k is not None  # tests pin both tiers via cand_k
        else max(eff_cand_k * 8, 262144)
    )

    def device_retry(codes) -> bool:
        """Re-run one batch with the big-K step; False if it overflowed
        even RETRY_K (host recount needed).  Single-device only (a sharded
        shard's rows are a plain batch here)."""
        nonlocal total_hits, counts, n_retry
        if mesh is not None:
            return False
        p2, v2 = pack_batch_fast(codes)
        f2 = jnp.asarray(fuse_packed(p2, v2))
        pk2, vb2 = split_fused(f2, config.segment_len)
        kw2 = dict(kw)
        kw2["cand_k"] = RETRY_K
        kw2["seg_c"] = None  # flat compaction: no per-row limit in the retry
        nonlocal_counts, diag2 = count_step_v3(
            pk2, vb2, tab.fp, tab.keys, tab.vals, counts, **kw2
        )
        _, n_cand2, n_hits2 = (int(x) for x in np.asarray(diag2))
        if n_cand2 > RETRY_K:
            return False
        counts = nonlocal_counts
        total_hits += n_hits2
        n_retry += 1
        return True

    # Fixed-shape diag pad: the drain fetch stacks up to 2*window per-batch
    # diag vectors; padding to a constant K keeps it ONE compiled XLA
    # program regardless of how many batches are pending (a ragged final
    # drain would otherwise compile a new stack-of-K program per K).
    pad_k = 2 * window
    zero_diag = None

    def drain(n: int):
        """Process the oldest n pending batches: one stacked diag fetch,
        then per-batch accounting; a batch whose
        candidate count overflowed CAND_K contributed nothing on device
        (the kernel zeroes its scatter) and is retried with a bigger
        budget, then recounted exactly on the host if still too dense."""
        nonlocal total_kmers, total_hits, zero_diag, n_host
        n = min(n, len(pending))
        if n == 0:
            return
        items = [pending.popleft() for _ in range(n)]
        stack = [d for d, _ in items]
        if len(stack) < pad_k:
            if zero_diag is None:
                zero_diag = jnp.zeros_like(stack[0])
            stack.extend([zero_diag] * (pad_k - len(stack)))
        elif len(stack) > pad_k:  # drains are capped at 2*window pending
            raise AssertionError("drain size exceeds pad_k")
        diags = np.asarray(jnp.stack(stack))[: len(items)]
        if mesh is None:
            diags = diags[:, None, :]  # [n, 1, 3] — one "shard" per batch
        for (_, codes), dg in zip(items, diags):
            shard_rows = codes.shape[0] // dg.shape[0]
            for d in range(dg.shape[0]):
                n_valid, n_cand, n_hits = (int(x) for x in dg[d])
                total_kmers += n_valid
                if n_cand > eff_cand_k:
                    rows = codes[d * shard_rows : (d + 1) * shard_rows]
                    if dg.shape[0] == 1 and device_retry(rows):
                        continue
                    # too dense even for the retry budget: exact recount
                    hit_idx, _ = count_codes_batch(
                        rows, k, sorted_hashes, sort_order
                    )
                    np.add.at(host_counts, hit_idx, 1)
                    total_hits += int(hit_idx.shape[0])
                    n_host += 1
                else:
                    total_hits += n_hits

    import sys
    import time as _time

    # verbose progress (reference: every 1e6 reads at -v -v -v,
    # FingerPrint.hpp:70-79); here per batch with throughput at -v -v
    t_start = _time.monotonic()
    next_read_mark = 1_000_000

    trace_dir = getattr(opts, "trace", None)
    trace_ctx = None
    if trace_dir:
        trace_ctx = jax.profiler.trace(trace_dir)
        trace_ctx.__enter__()
    # everything from here runs under try/finally: the profiler trace must
    # flush and reader threads must unblock even on error/early exit

    # Producer thread: read + pack + upload off the main thread.  The native
    # parse, the native pack and the host->device transfer all release the
    # GIL, so batch N+1 is prepared and uploaded while the device computes
    # batch N.
    import queue as _queue
    import threading as _threading

    # Batches are STAGED and uploaded AGG at a time as one [AGG, B, L*3/8]
    # array, and on the pure-throughput path the consumer also EXECUTES
    # the group as one scan-of-AGG dispatch (AGG and upload_depth are not
    # yet re-tuned on the GPU, see ROADMAP).  Diagnostics stay per batch
    # (scan stacks them), so drains, overflow retries and accounting are
    # unchanged.  Grouped execution is gated OFF whenever per-batch cut
    # points are observable — -m early termination (the pinned fixture's
    # totals count every dispatched batch, and a group dispatches AGG at
    # once), fault injection, or a checkpoint cadence not divisible by AGG
    # (a snapshot must describe exactly batch_idx batches) — so every
    # pinned semantic is bit-exact.
    AGG = 4
    group_exec = (
        mesh is None
        and not check_term
        and config.fail_after_batches is None
        and (not config.checkpoint_path
             or config.checkpoint_every % AGG == 0)
    )
    # breaks wire: ship row_len + explicit invalid positions (18 B/row)
    # instead of the [L/8] validity bitmask — a 15% wire cut at L=256
    # (96 -> 82 B/row), 24% at 512.  Per-batch: N-rich rows overflow the
    # sidecar and that batch rides the legacy vbits wire (both step
    # programs are compiled once).  Single-device path only: the mesh step
    # keeps vbits.  The sidecar's row_len and positions are u16 with an
    # 0xFFFF pad sentinel, so segments of 65536 slots or more keep vbits.
    use_breaks = (
        mesh is None
        and config.segment_len < 0xFFFF
        and os.environ.get("NTSM_VBITS_WIRE", "0") != "1"
    )
    if use_breaks:
        from ntsm_tpu.count.kernel_v3 import (
            breaks_sidecar,
            count_step_v3_breaks,
            split_fused_breaks,
        )

    scan_group = None
    scan_group_breaks = None
    if group_exec:
        # module-scope jitted scans (kernel_v3.scan_group_v3*): compiled
        # once per process; a closure jitted here would retrace per engine
        # call
        from ntsm_tpu.count.kernel_v3 import scan_group_v3

        def scan_group(fused_g, counts_in):
            return scan_group_v3(fused_g, tab.fp, tab.keys, tab.vals,
                                 counts_in, **kw)

        if use_breaks:
            from ntsm_tpu.count.kernel_v3 import scan_group_v3_breaks

            def scan_group_breaks(fused_g, counts_in):
                return scan_group_v3_breaks(fused_g, tab.fp, tab.keys,
                                            tab.vals, counts_in, **kw)
    upload_q: _queue.Queue = _queue.Queue(
        maxsize=max(config.upload_depth, AGG + 1)
    )
    stop_evt = _threading.Event()
    sentinel = object()
    prod_err: list = []
    wire_nbytes = [0]  # host->device bytes shipped (link-efficiency bench)

    def _qput(item) -> bool:
        from ntsm_tpu.io.fastx import _bounded_put

        return _bounded_put(upload_q, stop_evt, item)

    def _producer():
        it = iter(reader)
        staged: list = []  # (fused np, batch) awaiting one aggregated upload
        staged_kind = [False]  # breaks wire? (a group must be homogeneous
        # — the two wires have different row widths, so a kind change
        # flushes the partial group onto the per-batch dispatch path)

        def flush() -> bool:
            if not staged:
                return True
            fused_np = np.stack([f for f, _ in staged])
            wire_nbytes[0] += fused_np.nbytes
            # on a mesh each device receives only its rows of the batch
            dev = (jnp.asarray(fused_np) if upload_sharding is None
                   else jax.device_put(fused_np, upload_sharding))
            brk = staged_kind[0]
            if group_exec and len(staged) == AGG:
                # one queue item = one scan-of-AGG dispatch downstream
                ok = _qput((dev, [b for _, b in staged], brk))
            else:
                ok = all(
                    _qput((dev[i], b, brk)) for i, (_, b) in enumerate(staged)
                )
            staged.clear()
            return ok

        try:
            n = 0
            for batch in it:
                n += 1
                if n <= skip_batches:
                    continue  # deterministic reader: parse-only skip on resume
                side = (
                    breaks_sidecar(batch.codes, batch.lengths)
                    if use_breaks
                    else None
                )
                if side is not None:
                    packed, _ = pack_batch_fast(batch.codes)
                    fused_b, brk = fuse_packed(packed, side), True
                else:
                    packed, vbits = pack_batch_fast(batch.codes)
                    fused_b, brk = fuse_packed(packed, vbits), False
                if staged and staged_kind[0] != brk and not flush():
                    return
                staged_kind[0] = brk
                staged.append((fused_b, batch))
                if len(staged) >= AGG and not flush():
                    return
            flush()
        except BaseException as e:  # surfaced on the consumer side
            prod_err.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            _qput(sentinel)

    upload_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        upload_sharding = NamedSharding(mesh, PartitionSpec(None, "data"))
    prod = _threading.Thread(target=_producer, daemon=True)
    prod.start()
    batch_idx = skip_batches
    last_ckpt_idx = skip_batches  # batch count at the latest snapshot
    stage_t = dict(wait=0.0, dispatch=0.0, drain=0.0)  # -v -v stage budget
    try:
        while True:
            _t = _time.monotonic()
            item = upload_q.get()
            stage_t["wait"] += _time.monotonic() - _t
            if item is sentinel:
                if prod_err:
                    raise prod_err[0]
                break
            fused, batch, brk = item
            _t = _time.monotonic()
            if isinstance(batch, list):
                # whole upload group as ONE scan-of-AGG dispatch
                # (group_exec path); diags stay per batch
                counts, diags = (
                    scan_group_breaks if brk else scan_group
                )(fused, counts)
                for i, b in enumerate(batch):
                    batch_idx += 1
                    total_bases += b.n_bases
                    total_reads += b.n_reads
                    pending.append((diags[i], b.codes))
            else:
                batch_idx += 1
                if brk:
                    pk, sd = split_fused_breaks(fused, config.segment_len)
                    counts, diag = count_step_v3_breaks(
                        pk, sd, tab.fp, tab.keys, tab.vals, counts, **kw
                    )
                else:
                    pk, vb = split_fused(fused, config.segment_len)
                    if mesh is None:
                        counts, diag = count_step_v3(
                            pk, vb, tab.fp, tab.keys, tab.vals, counts, **kw
                        )
                    else:
                        counts, diag = sharded_step(
                            pk, vb, tab.fp, tab.keys, tab.vals, counts
                        )
                total_bases += batch.n_bases
                total_reads += batch.n_reads
                pending.append((diag, batch.codes))
            stage_t["dispatch"] += _time.monotonic() - _t
            while len(pending) >= 2 * window:
                # drain the older half; the newer half keeps the device
                # busy.  A while, not an if: a group item appends AGG=4
                # batches at once, so with window < AGG a single
                # drain(window) would let pending grow without bound and
                # the final drain would blow the fixed pad_k stack pad
                _t = _time.monotonic()
                drain(window)
                stage_t["drain"] += _time.monotonic() - _t
                if check_term and total_hits > max_counts:
                    # drain the rest too: their scatters are already in the
                    # device count vector, so totals (#@TK / Recorded) must
                    # include them, and any overflowed batch still needs its
                    # retry/host recount — otherwise counts and totals
                    # disagree at the termination point
                    drain(len(pending))
                    early = True
                    break
            if early:
                break
            # boundary-crossing check, not `% every == 0`: a mid-stream
            # wire-kind flip flushes a partial (non-AGG) group, after
            # which group items advance batch_idx by 4 from a base that
            # is no longer 0 mod 4 and an equality test would never
            # fire again (snapshots at any batch_idx are valid — resume
            # is a parse-skip of exactly batch_idx batches)
            if config.checkpoint_path and (
                batch_idx // config.checkpoint_every
                > last_ckpt_idx // config.checkpoint_every
            ):
                from ntsm_tpu.count.checkpoint import save_snapshot

                drain(len(pending))  # snapshot state = exactly batch_idx batches
                save_snapshot(
                    config.checkpoint_path,
                    sig=sig,
                    n_batches=batch_idx,
                    counts=merged_counts_np(),
                    total_kmers=total_kmers,
                    total_hits=total_hits,
                    total_bases=total_bases,
                    total_reads=total_reads,
                )
                last_ckpt_idx = batch_idx
            if opts.verbose > 2 and total_reads >= next_read_mark:
                next_read_mark = (total_reads // 1_000_000 + 1) * 1_000_000
                print(
                    f"Current Total: {total_reads} reads, {total_kmers} k-mers, "
                    f"{total_hits} total counts, and {total_bases} total bases ",
                    file=sys.stderr,
                )
            elif opts.verbose > 1:
                el = _time.monotonic() - t_start
                print(
                    f"batch {batch_idx}: {total_reads} reads, "
                    f"{total_bases} bases, {total_bases / el / 1e6:.1f} Mbase/s",
                    file=sys.stderr,
                )
            if (
                config.fail_after_batches is not None
                and batch_idx - skip_batches >= config.fail_after_batches
            ):
                raise RuntimeError("ntsm: injected failure (fail_after_batches)")
        _t = _time.monotonic()
        drain(len(pending))
        stage_t["drain"] += _time.monotonic() - _t
        if opts.verbose > 1:
            print(
                f"stage budget: wait {stage_t['wait']:.2f}s "
                f"dispatch {stage_t['dispatch']:.2f}s "
                f"drain {stage_t['drain']:.2f}s "
                f"({batch_idx - skip_batches} batches; overflow: "
                f"{n_retry} device retries, {n_host} host recounts)",
                file=sys.stderr,
            )
    finally:
        if trace_ctx is not None:
            trace_ctx.__exit__(None, None, None)
        # unblock the producer (it may be parked on a full queue) and wait
        # for it to close its reader
        stop_evt.set()
        prod.join(timeout=10)
    if check_term and not early:
        early = total_hits > max_counts
    if early:
        import sys

        print("Reached desired (-m) threshold", file=sys.stderr)

    if mesh is not None:
        from ntsm_tpu.parallel.mesh import merge_counts_across_devices

        counts = merge_counts_across_devices(counts)
    counts_np = np.asarray(counts)[:n_kmers].astype(np.int64) + host_counts
    return CountResult(
        counts=counts_np,
        total_kmers=total_kmers,
        total_hits=total_hits,
        total_bases=total_bases,
        total_reads=total_reads,
        early_term=early,
        wire_bytes=wire_nbytes[0],
    )


def run_count_v2(
    table: SiteTable,
    filenames,
    opts: Options,
    config: EngineConfig | None = None,
) -> CountResult:
    """v2 pipeline: packed upload, 512B-row gather, top_k hit extraction,
    host-side count accumulation (see kernel_v2.py for the measurements
    that shaped this)."""
    from ntsm_tpu.count.kernel_v2 import (
        SLOTS_V2,
        count_step_v2,
        hits_to_kmer_counts,
        pack_batch,
    )
    from ntsm_tpu.io.sites import build_lookup

    config = config or EngineConfig(
        batch_reads=opts.batch_reads, segment_len=opts.segment_len
    )
    k = table.k
    n_kmers = table.n_kmers
    lookup = build_lookup(table.kmer_hashes, slots=SLOTS_V2)
    keys = jnp.asarray(lookup.keys)

    sorted_hashes = np.sort(table.kmer_hashes)
    sort_order = np.argsort(table.kmer_hashes, kind="stable")

    counts = np.zeros(n_kmers, dtype=np.int64)
    total_kmers = 0
    total_hits = 0
    total_bases = 0
    total_reads = 0
    max_counts = max_counts_threshold(n_kmers, opts.cov_thresh)
    early = False

    reader = BatchReader(
        filenames, k=k, seglen=config.segment_len, batch=config.batch_reads
    )
    L = config.segment_len
    pending = None  # (device outputs, host batch) for simple double buffering
    it = iter(reader)

    def drain(entry):
        nonlocal total_kmers, total_hits, total_bases, total_reads
        (top, n_found, n_valid), batch = entry
        nf = int(n_found)
        total_kmers += int(n_valid)
        total_bases += batch.n_bases
        total_reads += batch.n_reads
        if nf > int(top.shape[0]):
            # adversarially dense batch: exact host recount
            from ntsm_tpu.count.golden import count_codes_batch

            hit_idx, _ = count_codes_batch(batch.codes, k, sorted_hashes, sort_order)
            np.add.at(counts, hit_idx, 1)
            total_hits += hit_idx.shape[0]
        else:
            hits_np = np.asarray(top[: max(nf, 0)])
            hits_to_kmer_counts(hits_np, lookup, n_kmers, counts)
            total_hits += nf

    for batch in it:
        packed, vbits = pack_batch(batch.codes)
        out = count_step_v2(jnp.asarray(packed), jnp.asarray(vbits), keys, k=k, L=L)
        if pending is not None:
            drain(pending)
        pending = (out, batch)
        if max_counts != 0 and not math.isinf(max_counts):
            if total_hits > max_counts:
                early = True
                break
    if pending is not None and not early:
        drain(pending)
        if max_counts != 0 and not math.isinf(max_counts):
            early = total_hits > max_counts
    if early:
        import sys

        print("Reached desired (-m) threshold", file=sys.stderr)

    return CountResult(
        counts=counts,
        total_kmers=total_kmers,
        total_hits=total_hits,
        total_bases=total_bases,
        total_reads=total_reads,
        early_term=early,
    )


def run_count(
    table: SiteTable,
    filenames,
    opts: Options,
    config: EngineConfig | None = None,
    version: int = 3,
    mesh=None,
) -> CountResult:
    from ntsm_tpu.utils.device import require_accelerator

    require_accelerator()
    if version == 3:
        if mesh is None and jax.local_device_count() > 1:
            # several local devices (or the virtual CPU mesh): shard
            # batches over all LOCAL devices automatically — in
            # multi-host mode each process runs its own host-local mesh
            # (global merge happens via
            # parallel.distributed.merge_count_results); skip when the
            # batch size doesn't divide the device count (stay
            # single-device rather than erroring on a valid config)
            batch = (config.batch_reads if config is not None
                     else opts.batch_reads)
            if batch % jax.local_device_count() == 0:
                from ntsm_tpu.parallel.mesh import data_mesh

                mesh = data_mesh(jax.local_devices())
        return run_count_v3(table, filenames, opts, config, mesh=mesh)
    if version == 2:
        return run_count_v2(table, filenames, opts, config)
    return run_count_v1(table, filenames, opts, config)


def run_count_v1(
    table: SiteTable,
    filenames,
    opts: Options,
    config: EngineConfig | None = None,
) -> CountResult:
    config = config or EngineConfig(
        batch_reads=opts.batch_reads, segment_len=opts.segment_len
    )
    k = table.k
    n_kmers = table.n_kmers
    keys, vals = make_table_arrays(table.lookup, n_kmers)

    counts = jnp.zeros(n_kmers + 1, dtype=jnp.int32)
    total_kmers = jnp.int64(0)
    total_hits = jnp.int64(0)

    step = count_step
    max_counts = max_counts_threshold(n_kmers, opts.cov_thresh)
    total_bases = 0
    total_reads = 0
    early = False

    reader = BatchReader(
        filenames, k=k, seglen=config.segment_len, batch=config.batch_reads
    )
    n_batches = 0
    for batch in reader:
        codes = jnp.asarray(batch.codes)
        lengths = jnp.asarray(batch.lengths)
        counts, total_kmers, total_hits = step(
            codes, lengths, keys, vals, counts, total_kmers, total_hits,
            k=k, n_kmers=n_kmers,
        )
        total_bases += batch.n_bases
        total_reads += batch.n_reads
        n_batches += 1
        if max_counts != 0 and not math.isinf(max_counts):
            if n_batches % config.early_term_check_every == 0:
                if int(total_hits) > max_counts:
                    early = True
                    break
    if not early and max_counts != 0 and not math.isinf(max_counts):
        early = int(total_hits) > max_counts
    if early:
        # message parity: FingerPrint.hpp:84-86
        import sys

        print("Reached desired (-m) threshold", file=sys.stderr)

    counts_np = np.asarray(counts)[:-1].astype(np.int64)
    return CountResult(
        counts=counts_np,
        total_kmers=int(total_kmers),
        total_hits=int(total_hits),
        total_bases=total_bases,
        total_reads=total_reads,
        early_term=early,
    )


def format_info_summary(
    table: SiteTable, result: CountResult, opts: Options
) -> tuple[str, str | None]:
    """FingerPrint::printInfoSummary text (src/FingerPrint.hpp:313-349).

    Returns (summary_text, warning_or_None).
    """
    mx, _ = result.site_max_sum(table)
    site_coverage = int(((mx[:, 0] > 0) | (mx[:, 1] > 0)).sum())
    out = (
        f"Total Bases Considered: {result.total_bases}\n"
        f"Total k-mers Considered: {result.total_kmers}\n"
        f"Total k-mers Recorded: {result.total_hits}\n"
        f"Distinct k-mers in initial set: {table.n_kmers}\n"
        f"Total Sites: {table.n_sites}\n"
        f"Sites Covered by at least one k-mer: {site_coverage}\n"
    )
    warning = None
    n_sites = table.n_sites
    cov_per = site_coverage / n_sites if n_sites else 0.0
    if cov_per < opts.site_cov_threshold:
        warning = (
            f"Warning: site coverage is : {cpp_general(cov_per, 6)}"
            "(<75%). Data may be sorted or sparse along the genome. "
            "Any PCA projection may be inaccurate."
        )
    return out, warning
