"""In-memory model of a set of count files.

Dense-array replacement for CompareCounts' per-file vectors-of-pairs
(src/CompareCounts.hpp:30-114): counts live in [n_samples, n_sites, 2]
arrays, genotype classes and per-site single-sample likelihood terms are
precomputed vectorized.
"""

from __future__ import annotations

import numpy as np

from ntsm_tpu.io.countfile import load_count_files
from ntsm_tpu.options import Options

# genotype classes (order matters for the relatedness logic)
UNKNOWN, HET, HOM_AT, HOM_CG = 0, 1, 2, 3


class CountData:
    """Count-file cohort.  Two storage modes behind one interface:

    * plane mode — max_counts / sum_counts are [N, L, 2] int arrays (the
      reference's m_counts / m_sum); used by the exact parity oracle and
      whenever the wire loader can't apply.
    * wire mode — only the eval engine's padded u16 upload planes
      (wire_at / wire_cg, [N, Lp]) plus O(L)/O(N) integer accumulators
      are held; max_counts materializes lazily on first access (exact /
      PCA long-double paths), and sum_counts is never reconstructible —
      its only consumers (merge -o, error rate) read the accumulators.

    Wire mode exists because fresh multi-GB allocations first-touch at
    ~60 MB/s on this host; see io/countfile.py:load_count_wires.
    """

    def __init__(
        self,
        filenames: list,
        locus_ids: list,
        distinct: np.ndarray,  # [L, 2]
        max_counts: np.ndarray | None = None,  # [N, L, 2] (m_counts)
        sum_counts: np.ndarray | None = None,  # [N, L, 2] (m_sum)
        raw_total_kmers: np.ndarray = None,  # [N] #@TK per file
        ks: np.ndarray = None,  # [N] #@KS per file
        total_counts: np.ndarray = None,  # [N] sum of max-counts per file
        wire_at: np.ndarray | None = None,  # [N, Lp] u16 (wire mode)
        wire_cg: np.ndarray | None = None,
        site_acc: np.ndarray | None = None,  # [L, 4] i64 mc/sum sums
        samp_sum: np.ndarray | None = None,  # [N] i64 sum of sum_counts
    ):
        self.filenames = filenames
        self.locus_ids = locus_ids
        self.distinct = distinct
        self._max_counts = max_counts
        self._sum_counts = sum_counts
        self.raw_total_kmers = raw_total_kmers
        self.ks = ks
        self.total_counts = total_counts
        self.wire_at = wire_at
        self.wire_cg = wire_cg
        self.site_acc = site_acc
        self.samp_sum = samp_sum
        # derived (filled by prepare())
        self._cls = None
        self._s_single = None
        self._min_cov = 1
        self.hets = None  # [N] over all sites
        self.homs = None
        self.miss = None
        self.error_rate = None  # [N]
        self.cov = None  # [N]

    @property
    def max_counts(self) -> np.ndarray:
        if self._max_counts is None:
            L = len(self.locus_ids)
            N = self.wire_at.shape[0]
            mc = np.empty((N, L, 2), np.int32)
            mc[:, :, 0] = self.wire_at[:, :L]
            mc[:, :, 1] = self.wire_cg[:, :L]
            self._max_counts = mc
        return self._max_counts

    @property
    def sum_counts(self) -> np.ndarray:
        if self._sum_counts is None:
            raise AttributeError(
                "sum_counts is not materialized in wire mode; use site_acc "
                "(per-site sums) or samp_sum (per-sample sums)"
            )
        return self._sum_counts

    def counts_ab(self) -> tuple[np.ndarray, np.ndarray]:
        """The two [N, L] allele count planes without forcing a plane
        materialization in wire mode (views into the padded wires)."""
        if self._max_counts is None and self.wire_at is not None:
            L = len(self.locus_ids)
            return self.wire_at[:, :L], self.wire_cg[:, :L]
        return self.max_counts[:, :, 0], self.max_counts[:, :, 1]

    @property
    def n_samples(self) -> int:
        if self._max_counts is not None:
            return self._max_counts.shape[0]
        return self.wire_at.shape[0]

    @property
    def n_sites(self) -> int:
        return len(self.locus_ids)

    @property
    def s_single(self) -> np.ndarray:
        """[N, L] f64 per-site single-sample likelihood terms
        (computeSumLogPSingle, CompareCounts.hpp:968-991).  Lazy: only the
        exact engine reads it; the device engine derives its decomposed form
        on device.  max(den, 1) is exact — a zero denominator implies both
        masks are false (any min_cov >= 0), and it avoids the FP-invalid
        microtraps that made this ~3x slower on this host."""
        if self._s_single is None:
            a, b = self.counts_ab()
            mc = self._min_cov
            pa = a > mc
            pb = b > mc
            af = a.astype(np.float64)
            bf = b.astype(np.float64)
            den = np.maximum(af + bf, 1.0)
            freq_at = np.where(pa, af / den, 0.0)
            freq_cg = np.where(pb, bf / den, 0.0)
            self._s_single = af * freq_at + bf * freq_cg
        return self._s_single

    @property
    def cls(self) -> np.ndarray:
        """[N, L] genotype class (calcHomHetMiss,
        CompareCounts.hpp:742-768).  Lazy: only the exact engine and the
        PCA projection index per-site classes; the device engine derives its
        indicator planes on device, and materializing [N, L] u8 + three
        masked assignments cost ~1 s per 256 samples of pure load time."""
        if self._cls is None:
            a, b = self.counts_ab()
            pa = a > self._min_cov
            pb = b > self._min_cov
            # HET=1, HOM_AT=2, HOM_CG=3 == pa*2 + pb flipped into the
            # class order: cls = pa&pb -> 1, pa&~pb -> 2, ~pa&pb -> 3
            cls = np.where(
                pa, np.where(pb, HET, HOM_AT), np.where(pb, HOM_CG, UNKNOWN)
            ).astype(np.uint8)
            self._cls = cls
        return self._cls

    def prepare(self, opts: Options) -> "CountData":
        a, b = self.counts_ab()
        mc = opts.min_cov
        pa = a > mc
        pb = b > mc
        self._cls = None  # lazy (see cls property)
        # per-sample tallies straight from the masks (one pass each; the
        # classes themselves are not needed here)
        self.hets = (pa & pb).sum(axis=1)
        self.homs = (pa ^ pb).sum(axis=1)
        self.miss = (~(pa | pb)).sum(axis=1)

        self._min_cov = opts.min_cov
        self._s_single = None  # lazy: only the exact engine needs it

        # error rate (computeErrorRate, CompareCounts.hpp:1198-1217)
        n = self.n_samples
        err = np.full(n, -1.0)
        distinct_kmers = float(self.distinct.sum())
        sums = (
            self.samp_sum.astype(np.float64)
            if self.samp_sum is not None
            else self.sum_counts.sum(axis=(1, 2)).astype(np.float64)
        )
        for i in range(n):
            if self.raw_total_kmers[i] > 0 and self.ks[i] > 0:
                expected = (
                    float(self.raw_total_kmers[i]) * distinct_kmers / float(opts.genome_size)
                )
                err[i] = 1.0 - (sums[i] / expected) ** (1.0 / float(self.ks[i]))
        self.error_rate = err
        self.cov = self.total_counts.astype(np.float64) / float(self.n_sites)
        return self


def load_count_data(paths, opts: Options, try_wires: bool = True) -> CountData:
    """try_wires=False skips the wire-loader attempt — used by
    load_count_data_eval's fallback, which has already run (and failed)
    the identical wire parse; retrying it here would re-read the whole
    cohort a second time before the plane loaders run."""
    from ntsm_tpu.io.countfile import load_count_arrays, load_count_wires

    if try_wires and getattr(opts, "engine", "tpu") != "exact":
        # wire mode: u16 upload planes + accumulators only (the exact
        # engine wants full planes for the bit-parity oracle, so it keeps
        # the plane loaders)
        wires = load_count_wires(paths)
        if wires is not None:
            locus_ids, distinct, wa, wb, site_acc, samp_mc, samp_sum, tks, kss = wires
            return CountData(
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
            ).prepare(opts)

    bulk = load_count_arrays(paths)
    if bulk is not None:
        locus_ids, distinct, mc, sc, tks, kss = bulk
        return CountData(
            filenames=list(paths),
            locus_ids=locus_ids,
            distinct=distinct,
            max_counts=mc,
            sum_counts=sc,
            raw_total_kmers=tks,
            ks=kss,
            total_counts=mc.sum(axis=(1, 2)),
        ).prepare(opts)

    locus_ids, distinct, files = load_count_files(paths)
    mc = np.stack([f.max_counts for f in files])
    sc = np.stack([f.sum_counts for f in files])
    data = CountData(
        filenames=list(paths),
        locus_ids=locus_ids,
        distinct=distinct,
        max_counts=mc,
        sum_counts=sc,
        raw_total_kmers=np.array([f.raw_total_kmers for f in files], dtype=np.int64),
        ks=np.array([f.k for f in files], dtype=np.int64),
        total_counts=np.array([f.total_counts for f in files], dtype=np.int64),
    )
    return data.prepare(opts)
