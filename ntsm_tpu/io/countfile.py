"""counts.txt codec — byte-compatible with the reference.

Writer replicates FingerPrint::printOptionalHeader/printCountsMax
(src/FingerPrint.hpp:261-311), MultiCount::printCountsMax
(src/MultiCount.hpp:93-138, which omits the #@ header lines) and
CompareCounts::mergeCounts (src/CompareCounts.hpp:626-674).

Reader replicates the CompareCounts constructor (src/CompareCounts.hpp:30-114):
the first file fixes the locus order and the distinct columns; every file's
rows are matched by locusID; a file's coverage total is the sum of its
max-count columns.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np


def format_counts(
    site_ids,
    max_counts: np.ndarray,  # [n_sites, 2]
    sum_counts: np.ndarray,  # [n_sites, 2]
    distinct: np.ndarray,  # [n_sites, 2]
    total_kmers: int | None,
    k: int | None,
) -> str:
    """Render a counts file. total_kmers/k None => no #@ header (ntsmVCF)."""
    parts: list[str] = []
    if total_kmers is not None:
        parts.append(f"#@TK\t{int(total_kmers)}\n#@KS\t{int(k)}")
    parts.append("\n#locusID\tcountAT\tcountCG\tsumAT\tsumCG\tdistinctAT\tdistinctCG\n")
    # one bulk conversion to Python ints instead of six per row
    cols = np.concatenate(
        [np.asarray(max_counts), np.asarray(sum_counts), np.asarray(distinct)],
        axis=1,
    ).astype(np.int64).tolist()
    for sid, (a, c, sa, sc, da, dc) in zip(site_ids, cols):
        parts.append(f"{sid}\t{a}\t{c}\t{sa}\t{sc}\t{da}\t{dc}\n")
    return "".join(parts)


def format_merged_counts(site_ids, max_counts, sum_counts, distinct, total_kmers, k) -> str:
    """mergeCounts layout: #@ header then table, no leading blank line
    (src/CompareCounts.hpp:639-644)."""
    body = format_counts(site_ids, max_counts, sum_counts, distinct, None, None)
    return f"#@TK\t{int(total_kmers)}\n#@KS\t{int(k)}{body}"


@dataclass
class CountFile:
    path: str
    max_counts: np.ndarray  # [n_sites, 2] int64 (countAT, countCG)
    sum_counts: np.ndarray  # [n_sites, 2] int64 (sumAT, sumCG)
    raw_total_kmers: int  # #@TK, 0 if absent
    k: int  # #@KS, 0 if absent
    total_counts: int  # sum of max_counts (src/CompareCounts.hpp:104-106)


_scratch: dict = {}


def _parse_native(path: str):
    """Native counts.txt parse: (tk, ks, ids_blob, ints[n,6]) or None.

    Scratch buffers are reused across files (first-touch page faults on
    fresh multi-MB allocations dominated the per-file cost otherwise)."""
    from ntsm_tpu import native

    lib = native.load()
    if lib is None:
        return None
    import ctypes

    if not hasattr(lib, "ntsm_parse_counts"):
        return None
    with open(path, "rb") as fh:
        buf = fh.read()
    cap = buf.count(b"\n") + 2
    ints = _scratch.get("ints")
    if ints is None or ints.shape[0] < cap:
        ints = _scratch["ints"] = np.empty((cap, 6), dtype=np.int64)
    idcap = len(buf) + cap + 16
    ids = _scratch.get("ids")
    if ids is None or ids.shape[0] < idcap:
        ids = _scratch["ids"] = np.empty(idcap, dtype=np.uint8)
    ids_len = ctypes.c_long(0)
    tk = ctypes.c_long(0)
    ks = ctypes.c_long(0)
    n = lib.ntsm_parse_counts(
        buf,
        ctypes.c_long(len(buf)),
        ints.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(ints.shape[0]),
        ids.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(ids.shape[0]),
        ctypes.byref(ids_len),
        ctypes.byref(tk),
        ctypes.byref(ks),
    )
    if n < 0:
        return None
    blob = ids[: ids_len.value].tobytes()
    return tk.value, ks.value, blob, ints[:n]


def load_count_arrays(paths):
    """Bulk loader for the eval engines: fills preallocated
    [N, L, 2] planes directly (np.stack over per-file arrays cost ~14 s
    per 128 files on this host).

    Returns (locus_ids, distinct, mc [N,L,2] i32, sc [N,L,2] i32,
    tks [N] i64, ks [N] i64) — int32 planes (counts are bounded by per-site
    read depth); a file with values outside int32 falls back to the exact
    int64 path via load_count_files."""
    from ntsm_tpu import native

    lib = native.load()
    if lib is None or not hasattr(lib, "ntsm_parse_counts2"):
        return None  # caller falls back to load_count_files
    import ctypes

    def parse_into(path, mc_row, sc_row, dist):
        """Native parse straight into the final [n, 2] i32 slices.
        Returns (rows, ids_blob, tk, ks) or None (malformed / overflow)."""
        with open(path, "rb") as fh:
            buf = fh.read()
        cap = mc_row.shape[0]
        idcap = len(buf) + 16
        ids = _scratch.get("ids")
        if ids is None or ids.shape[0] < idcap:
            ids = _scratch["ids"] = np.empty(idcap + cap, dtype=np.uint8)
        ids_len = ctypes.c_long(0)
        tk = ctypes.c_long(0)
        ks = ctypes.c_long(0)
        rows = lib.ntsm_parse_counts2(
            buf,
            ctypes.c_long(len(buf)),
            mc_row.ctypes.data_as(ctypes.c_void_p),
            sc_row.ctypes.data_as(ctypes.c_void_p),
            dist.ctypes.data_as(ctypes.c_void_p) if dist is not None else None,
            ctypes.c_long(cap),
            ids.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_long(ids.shape[0]),
            ctypes.byref(ids_len),
            ctypes.byref(tk),
            ctypes.byref(ks),
        )
        if rows < 0:
            return None
        return rows, ids[: ids_len.value].tobytes(), tk.value, ks.value

    # first file fixes locus order, row count and the distinct columns
    nat0 = _parse_native(paths[0])
    if nat0 is None:
        return None
    tk0, ks0, blob0, ints0 = nat0
    locus_ids = blob0.decode("latin-1").splitlines()  # raw-byte ids, as the reference
    distinct = ints0[:, 4:6].copy()
    n = len(locus_ids)
    N = len(paths)
    # int32: halves the memory traffic of everything downstream; counts
    # are bounded by per-site read depth (<< 2^31)
    mc = np.empty((N, n, 2), dtype=np.int32)
    sc = np.empty((N, n, 2), dtype=np.int32)
    tks = np.zeros(N, dtype=np.int64)
    kss = np.zeros(N, dtype=np.int64)
    tks[0] = tk0
    kss[0] = ks0
    if ints0[:, 0:4].max(initial=0) > np.iinfo(np.int32).max:
        return None
    mc[0] = ints0[:, 0:2]
    sc[0] = ints0[:, 2:4]
    index_of = None
    for s in range(1, N):
        got = parse_into(paths[s], mc[s], sc[s], None)
        if got is not None and got[0] == n and got[1] == blob0:
            _, _, tks[s], kss[s] = got
        else:
            # locus order differs / malformed / i32 overflow: exact
            # id-mapped parse for this file
            if index_of is None:
                index_of = {lid: i for i, lid in enumerate(locus_ids)}
            tk, ks, rows = _parse_rows(paths[s])
            mc[s] = 0
            sc[s] = 0
            try:
                for r in rows:
                    i = index_of[r[0]]
                    mc[s, i, 0] = int(r[1])
                    mc[s, i, 1] = int(r[2])
                    sc[s, i, 0] = int(r[3])
                    sc[s, i, 1] = int(r[4])
            except OverflowError:
                # count > 2^31-1 in a locus-reordered file: the int32 fast
                # planes can't hold it; signal the caller to use the exact
                # int64 load_count_files path instead
                return None
            tks[s] = tk
            kss[s] = ks
    return locus_ids, distinct, mc, sc, tks, kss


def load_count_wires(paths, pad_to: int = 256, block_cb=None,
                     block_rows: int = 256, meta_cb=None, stats_out=None):
    """Wire-plane bulk loader: parses straight into the eval engine's
    padded u8 upload planes (u16 after escalation — see _store) plus the
    integer accumulators that replace the full [N, L, 2] planes
    (ntsm_parse_counts3).

    Returns (locus_ids, distinct [L,2] i64, wa [N,Lp] u8|u16, wb same,
    site_acc [L,4] i64 (mcAT, mcCG, sumAT, sumCG summed over samples),
    samp_mc [N] i64, samp_sum [N] i64, tks [N] i64, kss [N] i64), or None
    when the native library is absent, any count exceeds u16, or any file
    needs locus reordering — the caller then falls back to
    load_count_arrays (int32 planes) / load_count_files (exact int64).

    block_cb(s0, s1, wa_blk, wb_blk) is invoked after rows [s0, s1) are
    final (u16 row views into the planes, never rewritten afterwards),
    every block_rows samples — the eval engine uses it to overlap the
    host->device plane upload with the parse.  meta_cb(L, N) fires once,
    right after the first file fixes the locus count — the pipelined
    scorer sizes itself from it before any block lands.  On a None
    return (fallback) the caller must discard whatever the callbacks
    consumed.

    stats_out (dict, optional) is filled — before the first block_cb —
    with live references to the per-sample accumulators (samp_mc,
    samp_sum, tks, kss [N] i64) and the first file's distinct [L, 2]:
    rows [0, s1) are final whenever block_cb(s0, s1, ...) fires.  The
    streaming -p engine derives its per-sample radius tiers from these
    during the parse.

    Motivation: fresh multi-GB allocations first-touch at ~60 MB/s on this
    host (VM page-fault pathology);
    the wire planes are the only [N, *] arrays the -a device engine actually
    uploads, so everything else is folded into O(L) / O(N) accumulators.
    """
    from ntsm_tpu import native

    lib = native.load()
    if lib is None or not hasattr(lib, "ntsm_parse_counts3"):
        return None
    import ctypes

    vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731

    # first file: fixes locus order, row count, distinct
    with open(paths[0], "rb") as fh:
        buf0 = fh.read()
    cap = buf0.count(b"\n") + 2
    wa0 = np.zeros(cap, np.uint16)
    wb0 = np.zeros(cap, np.uint16)
    acc0 = np.zeros((cap, 4), np.int64)
    samp = np.zeros(2, np.int64)
    dist = np.zeros((cap, 2), np.int64)
    ids = _scratch.get("ids")
    idcap = len(buf0) + cap + 16
    if ids is None or ids.shape[0] < idcap:
        ids = _scratch["ids"] = np.empty(idcap, dtype=np.uint8)
    ids_len = ctypes.c_long(0)
    tk = ctypes.c_long(0)
    ks = ctypes.c_long(0)
    n0 = lib.ntsm_parse_counts3(
        buf0, ctypes.c_long(len(buf0)), vp(wa0), vp(wb0), vp(acc0), vp(samp),
        vp(dist), ctypes.c_long(cap), vp(ids), ctypes.c_long(ids.shape[0]),
        ctypes.byref(ids_len), ctypes.byref(tk), ctypes.byref(ks),
    )
    if n0 <= 0:
        return None
    blob0 = ids[: ids_len.value].tobytes()
    locus_ids = blob0.decode("latin-1").splitlines()  # raw-byte ids, as the reference
    L = n0
    N = len(paths)
    if meta_cb is not None:
        meta_cb(L, N)
    Lp = L + ((-L) % pad_to)
    # Parse into u16 per-file scratch rows, store into u8 planes (the
    # wire tier real coverage depths always hit), escalating the whole
    # plane to u16 on the first count >= 256.  The previous shape —
    # parse into [N, Lp] u16 planes, then one astype(u8) at the end —
    # faulted 1.85 GB of fresh pages at the N=3202 cohort; fresh-page
    # faults on this VM run at a time-varying 20-60 MB/s (measured 44 s
    # JUST for the final casts), so the loader allocates the 0.6 GB u8
    # planes once and nothing else at O(N·L).
    wa = np.zeros((N, Lp), np.uint8)
    wb = np.zeros((N, Lp), np.uint8)
    row_a = np.zeros(Lp, np.uint16)
    row_b = np.zeros(Lp, np.uint16)
    site_acc = np.zeros((L, 4), np.int64)
    samp_mc = np.zeros(N, np.int64)
    samp_sum = np.zeros(N, np.int64)
    tks = np.zeros(N, np.int64)
    kss = np.zeros(N, np.int64)

    def _store(s, ra, rb):
        nonlocal wa, wb
        if wa.dtype == np.uint8 and (
            int(ra[:L].max(initial=0)) > 255 or int(rb[:L].max(initial=0)) > 255
        ):
            # u16 escalation (values unchanged — blocks already handed to
            # block_cb stay valid u8 views; the device concat widens)
            wa = wa.astype(np.uint16)
            wb = wb.astype(np.uint16)
        wa[s, :L] = ra[:L]
        wb[s, :L] = rb[:L]

    if stats_out is not None:
        stats_out.update(
            samp_mc=samp_mc, samp_sum=samp_sum, tks=tks, kss=kss,
            distinct=dist[:L],
        )
    _store(0, wa0, wb0)
    site_acc += acc0[:L]
    samp_mc[0], samp_sum[0] = samp
    tks[0], kss[0] = tk.value, ks.value
    cb_done = 0

    def _maybe_cb(done):
        nonlocal cb_done
        if block_cb is not None and (
            done - cb_done >= block_rows or (done == N and done > cb_done)
        ):
            block_cb(cb_done, done, wa[cb_done:done], wb[cb_done:done])
            cb_done = done

    _maybe_cb(1)
    for s in range(1, N):
        with open(paths[s], "rb") as fh:
            buf = fh.read()
        idcap = len(buf) + 16
        if ids.shape[0] < idcap:
            ids = _scratch["ids"] = np.empty(idcap + cap, dtype=np.uint8)
        r = lib.ntsm_parse_counts3(
            buf, ctypes.c_long(len(buf)), vp(row_a), vp(row_b), vp(site_acc),
            vp(samp), None, ctypes.c_long(L), vp(ids),
            ctypes.c_long(ids.shape[0]), ctypes.byref(ids_len),
            ctypes.byref(tk), ctypes.byref(ks),
        )
        if (
            r != L
            or ids_len.value != len(blob0)
            or ids[: ids_len.value].tobytes() != blob0
        ):
            # overflow (-2), malformed (-1), short file, or reordered loci:
            # accumulators are poisoned — the caller falls back to the
            # plane loaders, which handle id-remapping exactly
            return None
        _store(s, row_a, row_b)
        samp_mc[s], samp_sum[s] = samp
        tks[s], kss[s] = tk.value, ks.value
        _maybe_cb(s + 1)
    return (
        locus_ids, dist[:L].copy(), wa, wb, site_acc, samp_mc, samp_sum,
        tks, kss,
    )


def _parse_rows(path: str):
    tk = 0
    ks = 0
    rows = []
    with open(path, "r") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            if line[0] == "#":
                if fields[0] == "#@TK":
                    tk = int(fields[1])
                elif fields[0] == "#@KS":
                    ks = int(fields[1])
                continue
            if len(fields) != 7:
                raise SystemExit(
                    f"ntsm eval: {path}:{lineno}: malformed count file row "
                    f"({len(fields)} fields, expected 7: locusID + 6 counts)"
                )
            rows.append(fields)
    return tk, ks, rows


def load_count_files(paths) -> tuple[list, np.ndarray, list[CountFile]]:
    """Load count files the way CompareCounts does.

    Returns (locus_ids, distinct[n_sites,2], [CountFile...]).

    Fast path: the native parser (ntsm_tpu/native) reads the numeric
    columns; when a file's locus column is byte-identical to the first
    file's (the overwhelmingly common case — same site set, same order)
    the arrays are used directly, otherwise rows are re-mapped by id
    exactly like the reference's .at() lookups (CompareCounts.hpp:87-99).
    """
    nat0 = _parse_native(paths[0])
    index_of = None
    if nat0 is not None:
        tk0, ks0, blob0, ints0 = nat0
        locus_ids = blob0.decode("latin-1").splitlines()  # raw-byte ids, as the reference
        distinct = ints0[:, 4:6].copy()
        n = len(locus_ids)
    else:
        tk0, ks0, rows0 = _parse_rows(paths[0])
        locus_ids = [r[0] for r in rows0]
        distinct = np.array(
            [[int(r[5]), int(r[6])] for r in rows0], dtype=np.int64
        )
        n = len(locus_ids)
        blob0 = None

    out = []
    for idx, path in enumerate(paths):
        if nat0 is None:
            nat = None
        else:
            nat = nat0 if idx == 0 else _parse_native(path)
        if nat is not None and nat[2] == blob0:
            tk, ks, _, ints = nat
            mc = ints[:, 0:2].copy()
            sc = ints[:, 2:4].copy()
        else:
            if index_of is None:
                index_of = {lid: i for i, lid in enumerate(locus_ids)}
            tk, ks, rows = _parse_rows(path)
            mc = np.zeros((n, 2), dtype=np.int64)
            sc = np.zeros((n, 2), dtype=np.int64)
            for r in rows:
                i = index_of[r[0]]  # unknown locus raises, like .at() would
                mc[i, 0] = int(r[1])
                mc[i, 1] = int(r[2])
                sc[i, 0] = int(r[3])
                sc[i, 1] = int(r[4])
        out.append(
            CountFile(
                path=path,
                max_counts=mc,
                sum_counts=sc,
                raw_total_kmers=tk,
                k=ks,
                total_counts=int(mc.sum()),
            )
        )
    return locus_ids, distinct, out
