"""Production-shape run of the REAL centers file.

test_real_centers.py proves the 96,287 long-double parses and a 3-sample
projection against a Decimal oracle; this tier runs the real
`data/human_sites_center.txt` at the shape the reference actually uses it
(CompareCounts.hpp:116-218 projection, :285-308 tiers, :316-390 candidate
search, then the scored TSV): a 256-sample x 96,287-site cohort with a
duplicate pair, related pairs and dirty (exhaustive-tier) samples, through

    quantize - REAL center -> rotate [256, 96287]@[96287, 20]
    -> radius tiers -> candidate pruning -> scored rows

in BOTH precisions (numpy longdouble = the reference's, and the f64 fast
path), asserting the candidate SETS are identical and pinning digests of
the cloud and the emitted TSV so any arithmetic regression at production
dimensions is loud.

Slow-marked (deselected by default; ~1-2 min, host-only — no GPU needed):

    python -m pytest tests/test_real_centers_scale.py -m slow -q
"""

import hashlib
import io
import pathlib

import numpy as np
import pytest

from ntsm_tpu.eval.model import CountData
from ntsm_tpu.eval.pca import pca_candidates, project_pcs, search_radii
from ntsm_tpu.options import Options

CENTERS = pathlib.Path("/root/reference/data/human_sites_center.txt")
L = 96287
N = 256

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        not CENTERS.exists(), reason="reference centers file not present"
    ),
]


def _make_cohort(rng) -> CountData:
    """In-memory cohort mirroring scripts/bench_eval.make_count_files:
    realistic ~30x Poisson counts over allele frequencies, sample 1 a
    duplicate of sample 0, ~10% dirty samples (>30% missing sites -> the
    exhaustive DBL_MAX tier, Options.pc_miss_site2)."""
    freq = rng.uniform(0.05, 0.95, size=L)
    mc = np.empty((N, L, 2), np.int64)
    base_geno = None
    for s in range(N):
        if s == 1:
            geno = base_geno
        else:
            geno = (rng.random(L) < freq).astype(np.int8) + (
                rng.random(L) < freq
            ).astype(np.int8)
            if s == 0:
                base_geno = geno
        lam = rng.uniform(25, 35) / 2.0
        at = rng.poisson(lam * (2 - geno)) + rng.poisson(0.02 * lam, size=L)
        cg = rng.poisson(lam * geno) + rng.poisson(0.02 * lam, size=L)
        if s >= 8 and rng.random() < 0.1:
            miss = rng.random(L) < 0.4
            at[miss] = 0
            cg[miss] = 0
        mc[s, :, 0] = at
        mc[s, :, 1] = cg
    data = CountData(
        filenames=[f"s{i:04d}_counts.txt" for i in range(N)],
        locus_ids=[f"rs{100000 + i}" for i in range(L)],
        distinct=np.full((L, 2), 13, dtype=np.int64),
        max_counts=mc,
        sum_counts=mc * 13,
        raw_total_kmers=mc.sum(axis=(1, 2)) * 37000,
        ks=np.full(N, 19, dtype=np.int64),
        total_counts=mc.sum(axis=(1, 2)),
    )
    return data


def _write_rotation(tmp_path, rng, dim: int = 20) -> str:
    """Seeded synthetic rotation at the real dimensionality (the real
    matrix is missing upstream, /root/reference/.MISSING_LARGE_BLOBS)."""
    rot = rng.normal(0, 0.003, size=(L, dim))
    p = tmp_path / "rot.tsv"
    with open(p, "w") as fh:
        fh.write("AlleleID\t" + "\t".join(f"PC{i}" for i in range(dim)) + "\n")
        for i in range(L):
            fh.write(
                f"rs{100000 + i}\t"
                + "\t".join(f"{x:.8f}" for x in rot[i])
                + "\n"
            )
    return str(p)


def test_real_centers_production_shape(tmp_path):
    rng = np.random.default_rng(20260819)
    data = _make_cohort(rng)
    rot = _write_rotation(tmp_path, rng)
    opts = Options(all=True, pca=rot, norm=str(CENTERS), engine="exact")
    data.prepare(opts)

    # projection at [256, 96287] in the reference's precision and the f64
    # fast path (CompareCounts.hpp:173-210)
    cloud_ld = project_pcs(data, opts, fast=False)
    cloud_64 = project_pcs(data, opts, fast=True)
    assert cloud_ld.shape == (N, 20)
    assert np.max(np.abs(cloud_ld - cloud_64)) < 1e-7

    # all three radius tiers must be populated at this cohort shape
    # (:294-308): clean -> radius1, noisy -> radius2, dirty -> DBL_MAX
    radii = search_radii(data, opts)
    tiers = sorted(set(np.round(radii[radii < 1e300], 6)))
    n_exh = int(np.sum(radii >= 1e300))
    assert opts.pc_search_radius1**2 in tiers
    assert n_exh >= 8, "no exhaustive-tier (dirty) samples"

    cand_ld = list(pca_candidates(cloud_ld[:, : opts.dim], radii, opts.dim))
    cand_64 = list(pca_candidates(cloud_64[:, : opts.dim], radii, opts.dim))
    assert cand_ld == cand_64, "f64 fast path changed the candidate set"
    assert (0, 1) in cand_ld, "duplicate pair not found by the search"
    # every exhaustive sample pairs with all others exactly once
    assert len(cand_ld) >= n_exh * (N - n_exh)

    # scored TSV through the reference-parity path (computeScorePCA)
    from ntsm_tpu.eval.driver import compute_score_pca

    out = io.StringIO()
    compute_score_pca(data, opts, out, cloud_ld)
    tsv = out.getvalue()
    rows = tsv.splitlines()
    assert len(rows) == len(cand_ld) + 1  # -a: every candidate emitted

    # digest pins: the exact-path projection (reference inner_product
    # semantics: f64 vals, f64 per-step-rounded accumulator, long-double
    # products — re-pinned when that replaced the all-longdouble matmul)
    # and the emitted rows.  These hold wherever numpy longdouble is x86
    # 80-bit (the same platform dependency the reference's `long
    # double` has).
    cloud_sig = hashlib.sha256(
        np.ascontiguousarray(cloud_ld.astype(np.float64))
    ).hexdigest()
    tsv_sig = hashlib.sha256(tsv.encode()).hexdigest()
    assert cloud_sig == (
        "a048b59a70b3176118aee9c525bd64345cfe8f9052aa37bfae34597701d206aa"
    ), f"cloud digest changed: {cloud_sig}"
    assert tsv_sig == (
        "4dfcb4d3a254d2cd0092124ae0a1ac2ffb4224fbeab07c51c58b823b04fc8c9a"
    ), f"tsv digest changed: {tsv_sig}"
