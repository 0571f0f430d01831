"""Counting engine v3: fingerprint-filtered probe, device-resident counts.

Per batch the step hashes every window, probes the site table and adds
the hits to a count vector that stays on the device.  The table probe is
a gather over the bucket rows for every window of the batch, so v3 keeps
the bytes each probe touches to one byte per slot: it probes a
1-byte-per-slot *fingerprint* plane first
(8 mixed bits of the hash remainder; empty slots hold 0 and never match).
With load factor ~0.6 the false-positive rate is ~0.25% of windows, so the
true match set is recovered by exact verification of only the top_k-compacted
candidates against the full u64 key plane (a gather of cand_k rows), and
counts are accumulated on device — no per-batch host round-trip.  The
engine syncs diagnostics (valid k-mers, candidate overflow, hits) every N
batches, which also drives -m early termination
(reference: FingerPrint.hpp:41-43,476-487).

A batch whose candidate count exceeds CAND_K (site-dense input, e.g.
amplicon data) is *skipped on device* (its scatter contributes nothing)
and recounted exactly on the host by the engine — detected via the
per-batch diagnostics.

Reference for the semantics replaced here: FingerPrint::insertCount
(src/FingerPrint.hpp:89-103) — one hash-table probe per k-mer window and
an atomic increment on match.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ntsm_tpu.count.kernel_v2 import (  # noqa: F401
    pack_batch,
    window_hashes_packed,
)


def fuse_packed(packed: np.ndarray, vbits: np.ndarray) -> np.ndarray:
    """One host->device transfer instead of two: [B, L/4] codes ++
    [B, L/8] validity."""
    return np.concatenate([packed, vbits], axis=1)


def breaks_sidecar(codes: np.ndarray, lengths: np.ndarray):
    """Host side of the BREAKS wire: the [B, L/8]
    validity bitmask is 1/3 of the fused wire, but almost all of its
    information is 'slot is inside the row'; the exceptions (read
    separators, N bases) are a handful of positions per row.  Encode
    validity as row_len + up to SIDE_MAXB explicit invalid positions
    (u16 LE, 0xFFFF pad): 18 B/row vs L/8 (32 B at L=256, 64 at 512).

    Returns the [B, SIDE_BYTES] u8 sidecar, or None when any row has
    more than SIDE_MAXB in-length invalid slots (N-rich input) — the
    caller then ships the legacy vbits wire for that batch."""
    from ntsm_tpu.count.kernel_v2 import SIDE_BYTES, SIDE_MAXB

    B, L = codes.shape
    lens = lengths.astype(np.int32)
    from ntsm_tpu import native

    lib = native.load()
    if (
        lib is not None
        and hasattr(lib, "ntsm_breaks_sidecar")
        and codes.dtype == np.uint8
        and codes.flags.c_contiguous
    ):
        # one C scan instead of three [B, L] numpy passes
        import ctypes

        lens = np.ascontiguousarray(lens)
        side = np.empty((B, SIDE_BYTES), np.uint8)
        rc = lib.ntsm_breaks_sidecar(
            codes.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_long(B), ctypes.c_long(L), ctypes.c_int(SIDE_MAXB),
            side.ctypes.data_as(ctypes.c_void_p),
        )
        return side if rc == 0 else None
    inv_mask = codes > 3
    inv_mask &= np.arange(L, dtype=np.int32)[None, :] < lens[:, None]
    cnt = np.count_nonzero(inv_mask, axis=1)
    if cnt.size and cnt.max() > SIDE_MAXB:
        return None
    side = np.empty((B, SIDE_BYTES), np.uint8)
    side[:, 0] = lens & 0xFF
    side[:, 1] = (lens >> 8) & 0xFF
    inv = np.full((B, SIDE_MAXB), 0xFFFF, np.uint16)
    r, c = np.nonzero(inv_mask)
    if r.size:
        starts = np.zeros(B, np.int64)
        np.cumsum(cnt[:-1], out=starts[1:])
        inv[r, np.arange(r.size) - starts[r]] = c
    side[:, 2::2] = (inv & 0xFF).astype(np.uint8)
    side[:, 3::2] = (inv >> 8).astype(np.uint8)
    return side


def split_fused(fused, L: int):
    q = L // 4
    return fused[:, :q], fused[:, q:]


# same slice math for the breaks wire (codes are the first L/4 bytes,
# the rest is the sidecar instead of vbits) — aliased so the two wire
# layouts can't drift apart silently
split_fused_breaks = split_fused
from ntsm_tpu.io.sites import EMPTY_KEY, LookupTable, build_lookup

SLOTS_V3 = 8
# candidate compaction width: expected candidates per 8.4 Mbase batch are
# ~9K fingerprint false positives per 4.2 Mbase (load 0.6 x 2^-8 per
# window) plus the true hits; not yet re-tuned on the GPU (ROADMAP).
CAND_K = 32768


def fingerprint_np(rem: np.ndarray) -> np.ndarray:
    """8-bit nonzero fingerprint of the hash remainder (host build side).

    hash64 is a bijective mixer, so the low remainder bits (disjoint from
    the bucket bits) are already decorrelated — the fingerprint is simply
    the low byte, clamped away from the 0 = empty-slot sentinel.
    """
    fp = (rem & np.uint64(0xFF)).astype(np.uint8)
    return np.maximum(fp, 1).astype(np.uint8)


def fingerprint_jnp(rem):
    fp = (rem & jnp.uint64(0xFF)).astype(jnp.uint8)
    return jnp.maximum(fp, jnp.uint8(1))


class TableV3:
    """Device planes for the v3 probe.

    fp    [n_buckets, slots] u8   fingerprint filter (0 = empty)
    keys  [n_buckets, slots] u64  exact hash (EMPTY_KEY = empty)
    vals  [n_buckets, slots] i32  k-mer index (n_kmers = empty)
    """

    def __init__(self, lookup: LookupTable):
        self.lookup = lookup
        self.n_buckets = lookup.n_buckets
        self.slots = lookup.slots
        self.bbits = int(self.n_buckets).bit_length() - 1
        rem = lookup.keys >> np.uint64(self.bbits)
        fp = fingerprint_np(rem)
        fp_np = np.where(lookup.keys == EMPTY_KEY, np.uint8(0), fp)
        self.fp = jnp.asarray(fp_np)
        self.keys = jnp.asarray(lookup.keys)
        self.vals = jnp.asarray(lookup.vals)

    @classmethod
    def from_hashes_device(cls, hashes: np.ndarray) -> "TableV3":
        """Build the probe planes ON DEVICE from the raw hash list.

        The host-built planes are ~436 MB at human scale (2.5M k-mers ->
        4.2M buckets x 8 slots of u8 fp + u64 key + i32 val).  Uploading
        the [n] u64 hash array instead (20 MB, ~22x less) and computing
        bucket/slot placement with one device sort + three scatters
        removes both that upload and the host-side plane build.  Bucket
        sizing (the only data-dependent decision) stays on the host via a
        cheap bincount.
        """
        from ntsm_tpu.io.sites import size_buckets

        n = int(hashes.shape[0])
        if n < 16:  # degenerate tables: the host path is simpler
            return cls(build_lookup(hashes, slots=SLOTS_V3))
        n_buckets = size_buckets(hashes, SLOTS_V3)
        self = cls.__new__(cls)
        self.lookup = None
        self.n_buckets = n_buckets
        self.slots = SLOTS_V3
        self.bbits = int(n_buckets).bit_length() - 1
        h_dev = jnp.asarray(hashes)  # the only table upload
        self.fp, self.keys, self.vals = _build_planes_device(
            h_dev, n_buckets=n_buckets, slots=SLOTS_V3, bbits=self.bbits
        )
        return self


@functools.partial(
    jax.jit, static_argnames=("n_buckets", "slots", "bbits")
)
def _build_planes_device(h, *, n_buckets: int, slots: int, bbits: int):
    """[n] u64 hashes -> (fp, keys, vals) planes, entirely on device.

    Same layout contract as build_lookup: stable bucket sort, slot =
    rank within the bucket run, vals = original k-mer index."""
    n = h.shape[0]
    bucket = (h & jnp.uint64(n_buckets - 1)).astype(jnp.int32)
    order = jnp.argsort(bucket, stable=True)
    sb = bucket[order]
    idx = jnp.arange(n, dtype=jnp.int32)
    run_start = jnp.concatenate(
        [jnp.ones(1, dtype=bool), sb[1:] != sb[:-1]]
    )
    start_idx = jax.lax.cummax(jnp.where(run_start, idx, 0))
    within = idx - start_idx
    flat = sb * jnp.int32(slots) + within
    hs = h[order]
    keys = (
        jnp.full(n_buckets * slots, EMPTY_KEY, dtype=jnp.uint64)
        .at[flat]
        .set(hs)
        .reshape(n_buckets, slots)
    )
    vals = (
        jnp.full(n_buckets * slots, n, dtype=jnp.int32)
        .at[flat]
        .set(order.astype(jnp.int32))
        .reshape(n_buckets, slots)
    )
    fpv = fingerprint_jnp(hs >> jnp.uint64(bbits))
    fp = (
        jnp.zeros(n_buckets * slots, dtype=jnp.uint8)
        .at[flat]
        .set(fpv)
        .reshape(n_buckets, slots)
    )
    return fp, keys, vals


def build_table_v3(hashes: np.ndarray) -> TableV3:
    return TableV3(build_lookup(hashes, slots=SLOTS_V3))


def table_v3_for(site_table) -> TableV3:
    """Memoized device table for a SiteTable (device-side build: one 20 MB
    hash upload + sort/scatter instead of a host plane build and a 436 MB
    upload; engines may be called repeatedly)."""
    tab = getattr(site_table, "_v3_table", None)
    if tab is None:
        tab = TableV3.from_hashes_device(site_table.kmer_hashes)
        site_table._v3_table = tab
    return tab


# hierarchical candidate compaction: a per-row top_k(SEG_K1) over
# [n_flat/SEG_C, SEG_C] followed by a top_k(cand_k) over the survivors
# replaces one flat top_k(cand_k) over every window of the batch (both
# widths not yet re-tuned on the GPU, see ROADMAP).  SEG_C=512 spans
# ~2.1 packed reads, so a row overflows SEG_K1 only when ~3 site-covering
# reads (13 candidate windows each) collide in one row — the overflow flag
# then routes the batch through the same retry tier as a cand_k overflow
# (exactness preserved; site-dense input was already on that path).
SEG_C = 512
SEG_K1 = 32


def probe_and_count(
    h,
    valid,
    fp_t,
    keys_t,
    vals_t,
    counts,
    *,
    n_buckets: int,
    slots: int,
    bbits: int,
    cand_k: int = CAND_K,
    seg_c: int | None = SEG_C,
    seg_k1: int = SEG_K1,
):
    """Shared probe stage: fingerprint filter -> hierarchical top_k
    compaction -> exact verify -> device scatter.  h/valid are [B, W]
    canonical window hashes + validity from either wire's hash stage.
    seg_c=None forces the flat single-top_k compaction (used by
    the engine's big-budget retry tier, where row limits must not apply)."""
    bucket = (h & jnp.uint64(n_buckets - 1)).astype(jnp.int32)
    rem = h >> jnp.uint64(bbits)
    q = fingerprint_jnp(rem)

    rows = fp_t[bucket]  # [B, W, slots] u8 — the hot gather
    cand = (rows == q[..., None]).any(axis=-1) & valid

    flat_cand = cand.reshape(-1)
    n_flat = flat_cand.shape[0]
    kk = min(cand_k, n_flat)
    hier = (
        seg_c is not None
        and n_flat % seg_c == 0
        and n_flat // seg_c >= 2
        and seg_k1 < kk
        and (n_flat // seg_c) * seg_k1 >= kk
    )
    if hier:
        R = n_flat // seg_c
        cand2 = flat_cand.reshape(R, seg_c)
        idx2 = jax.lax.broadcasted_iota(jnp.int32, (R, seg_c), 1)
        base = jax.lax.broadcasted_iota(jnp.int32, (R, 1), 0) * seg_c
        tagged = jnp.where(cand2, base + idx2, -1)
        t1, _ = jax.lax.top_k(tagged, seg_k1)  # [R, seg_k1]
        row_over = (
            cand2.sum(axis=1, dtype=jnp.int32) > jnp.int32(seg_k1)
        ).any()
        top, _ = jax.lax.top_k(t1.reshape(-1), kk)
    else:
        idx = jax.lax.broadcasted_iota(jnp.int32, (n_flat, 1), 0).reshape(-1)
        tagged = jnp.where(flat_cand, idx, -1)
        top, _ = jax.lax.top_k(tagged, kk)
        row_over = jnp.bool_(False)

    live = top >= 0
    cidx = jnp.maximum(top, 0)
    ch = h.reshape(-1)[cidx]
    cbucket = (ch & jnp.uint64(n_buckets - 1)).astype(jnp.int32)
    erows = keys_t[cbucket]  # [kk, slots] u64 — tiny exact gather
    ematch = (erows == ch[..., None]) & live[..., None]
    slot = jnp.where(
        ematch, jax.lax.broadcasted_iota(jnp.int32, ematch.shape, 1), slots
    ).min(axis=-1)
    hit = ematch.any(axis=-1)

    vrows = vals_t[cbucket]  # [kk, slots] i32
    kidx = jnp.take_along_axis(
        vrows, jnp.minimum(slot, slots - 1)[..., None], axis=-1
    ).reshape(-1)
    n_kmers_pad = counts.shape[0] - 1
    target = jnp.where(hit, kidx, n_kmers_pad)

    # int32 diagnostics: every count here is bounded by the window count
    # of one batch (<2^23)
    n_cand = cand.sum(dtype=jnp.int32)
    ok = (n_cand <= jnp.int32(kk)) & ~row_over
    upd = (hit & ok).astype(counts.dtype)
    counts = counts.at[target].add(upd)

    n_valid = valid.sum(dtype=jnp.int32)
    n_hits = jnp.where(ok, hit.sum(dtype=jnp.int32), jnp.int32(0))
    # a row-level overflow must surface as n_cand > cand_k so the engine
    # takes the same retry/host-recount branch as a global overflow
    n_cand = jnp.where(
        row_over, jnp.maximum(n_cand, jnp.int32(kk) + 1), n_cand
    )
    diag = jnp.stack([n_valid, n_cand, n_hits])
    return counts, diag


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "L", "n_buckets", "slots", "bbits", "cand_k", "seg_c", "seg_k1",
    ),
)
def count_step_v3(
    packed,
    vbits,
    fp_t,
    keys_t,
    vals_t,
    counts,
    *,
    k: int,
    L: int,
    n_buckets: int,
    slots: int,
    bbits: int,
    cand_k: int = CAND_K,
    seg_c: int | None = SEG_C,
    seg_k1: int = SEG_K1,
):
    """One fused counting step, counts stay on device.

    Returns (counts', diag) where diag = [n_valid, n_cand, n_hits] i64;
    if n_cand > cand_k the batch contributed NOTHING to counts and must be
    recounted on the host.
    """
    h, valid = window_hashes_packed(packed, vbits, k, L)
    return probe_and_count(
        h,
        valid,
        fp_t,
        keys_t,
        vals_t,
        counts,
        n_buckets=n_buckets,
        slots=slots,
        bbits=bbits,
        cand_k=cand_k,
        seg_c=seg_c,
        seg_k1=seg_k1,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "L", "n_buckets", "slots", "bbits", "cand_k", "seg_c", "seg_k1",
    ),
    donate_argnums=(4,),
)
def scan_group_v3(fused_g, fp_t, keys_t, vals_t, counts_in, *, k, L,
                  n_buckets, slots, bbits, cand_k=CAND_K, seg_c=SEG_C,
                  seg_k1=SEG_K1):
    """count_step_v3 over a stacked [S, B, 3L/8] upload group as ONE
    scan dispatch (the engine's group_exec path; diags stack [S, 3]).
    Module-scope so the program compiles once per process — a closure
    jitted inside run_count_v3 would retrace on every engine call."""
    kw = dict(k=k, L=L, n_buckets=n_buckets, slots=slots, bbits=bbits,
              cand_k=cand_k, seg_c=seg_c, seg_k1=seg_k1)

    def body(c, f):
        pk, vb = split_fused(f, L)
        return count_step_v3(pk, vb, fp_t, keys_t, vals_t, c, **kw)

    return jax.lax.scan(body, counts_in, fused_g)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "L", "n_buckets", "slots", "bbits", "cand_k", "seg_c",
        "seg_k1",
    ),
    donate_argnums=(4,),
)
def scan_group_v3_breaks(fused_g, fp_t, keys_t, vals_t, counts_in, *, k,
                         L, n_buckets, slots, bbits, cand_k=CAND_K,
                         seg_c=SEG_C, seg_k1=SEG_K1):
    """scan_group_v3 on the breaks wire ([S, B, L/4 + SIDE_BYTES])."""
    kw = dict(k=k, L=L, n_buckets=n_buckets, slots=slots, bbits=bbits,
              cand_k=cand_k, seg_c=seg_c, seg_k1=seg_k1)

    def body(c, f):
        pk, sd = split_fused_breaks(f, L)
        return count_step_v3_breaks(pk, sd, fp_t, keys_t, vals_t, c, **kw)

    return jax.lax.scan(body, counts_in, fused_g)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "L", "n_buckets", "slots", "bbits", "cand_k", "seg_c",
        "seg_k1",
    ),
)
def count_step_v3_breaks(
    packed,
    side,
    fp_t,
    keys_t,
    vals_t,
    counts,
    *,
    k: int,
    L: int,
    n_buckets: int,
    slots: int,
    bbits: int,
    cand_k: int = CAND_K,
    seg_c: int | None = SEG_C,
    seg_k1: int = SEG_K1,
):
    """count_step_v3 on the breaks wire ([B, SIDE_BYTES] sidecar instead
    of [B, L/8] vbits); the hash/probe stages are byte-identical, only
    the validity-mask prologue differs (kernel_v2.unpack_codes_breaks)."""
    from ntsm_tpu.count.kernel_v2 import window_hashes_breaks

    h, valid = window_hashes_breaks(packed, side, k, L)
    return probe_and_count(
        h,
        valid,
        fp_t,
        keys_t,
        vals_t,
        counts,
        n_buckets=n_buckets,
        slots=slots,
        bbits=bbits,
        cand_k=cand_k,
        seg_c=seg_c,
        seg_k1=seg_k1,
    )
