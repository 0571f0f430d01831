"""Eval benchmark: all-vs-all sample-pair scoring throughput.

Generates N human-scale synthetic count files (96287 sites, ~30x
coverage, realistic genotype structure incl. duplicate and related pairs),
then measures end-to-end wall time (load + score + format) of:

  * our device engine     (`ntsm eval -a`, compute_score_all_tpu)
  * the reference C++     (`ntsmEval -a -t <T>`) if a binary is given

The generators (make_count_files, make_pca_artifacts) also feed
chip_smoke.py.  Prints the device first (refuses to run the device engine
without a GPU), then one JSON line per engine:
  {"metric": "eval_pairs_per_s", "engine": ..., "n_samples": N,
   "value": pairs/s, "wall_s": ...}

Usage: python scripts/bench_eval.py [N] [--ref /tmp/ntsm_build/ntsmEval]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_SITES = 96287


def make_count_files(outdir: str, n_samples: int, rng, dirty_frac=0.0,
                     spread=None, n_sites: int = N_SITES,
                     start: int = 0) -> list[str]:
    """Write n_samples count files s{start:04d}_counts.txt onward.  The
    cohort's first two samples (start == 0) are a planted duplicate pair.

    spread=(mat, K): population-structured cohort — samples fall into
    K clusters laid out on a grid in the rotation's (PC0, PC1) plane by
    shifting each cluster's allele frequencies along sign(mat[:, 0/1]).
    One-blob cohorts put 79-90% of pairs inside the tier-1 search radius
    (the -p filter's worst case); a spread cohort is the filter's DESIGN
    case (only within-cluster pairs are candidates, ~1/K of all pairs)."""
    from ntsm_tpu.io.countfile import format_counts

    site_ids = [f"rs{100000+i}" for i in range(n_sites)]
    distinct = np.full((n_sites, 2), 13, dtype=np.int64)
    freq = rng.uniform(0.05, 0.95, size=n_sites)
    deltas = None
    if spread is not None:
        mat, K = spread
        side = int(np.ceil(np.sqrt(K)))
        s0 = np.sign(mat[:, 0])
        s1 = np.sign(mat[:, 1])
        deltas = [
            0.04 * ((c % side - (side - 1) / 2) * s0
                    + (c // side - (side - 1) / 2) * s1)
            for c in range(K)
        ]

    paths = []
    base_geno = None
    for s in range(start, start + n_samples):
        fs = freq
        if deltas is not None:
            fs = np.clip(freq + deltas[s % len(deltas)], 0.02, 0.98)
        if s == 1 and base_geno is not None:
            geno = base_geno  # duplicate pair (sample swap)
        else:
            geno = (rng.random(n_sites) < fs).astype(np.int8) + (
                rng.random(n_sites) < fs
            ).astype(np.int8)
            if s == 0:
                base_geno = geno
        cov = rng.uniform(25, 35)
        lam = cov / 2.0
        at = rng.poisson(lam * (2 - geno)).astype(np.int64)
        cg = rng.poisson(lam * geno).astype(np.int64)
        # sequencing-error cross-talk
        at += rng.poisson(0.02 * lam, size=n_sites)
        cg += rng.poisson(0.02 * lam, size=n_sites)
        if dirty_frac and rng.random() < dirty_frac:
            # "dirty" sample: >30% missing sites -> infinite PCA search
            # radius tier (Options.pc_miss_site2), the -p worst case
            miss = rng.random(n_sites) < 0.4
            at[miss] = 0
            cg[miss] = 0
        mx = np.stack([at, cg], axis=1)
        sm = mx * 13
        text = format_counts(
            site_ids, mx, sm, distinct, int(mx.sum() * 37000), 19
        )
        p = os.path.join(outdir, f"s{s:04d}_counts.txt")
        with open(p, "w") as fh:
            fh.write(text)
        paths.append(p)
    return paths


def make_pca_artifacts(outdir: str, rng, dims: int = 20, mat=None,
                       n_sites: int = N_SITES):
    """Synthetic-but-well-formed PCA artifacts at the human-site scale
    (the projection/radius machinery is agnostic to whether the rotation
    came from a real cohort).  Pass mat to pin a rotation generated
    up-front (the spread-cohort path shifts cluster frequencies along
    its sign pattern, so count files and rot.tsv must agree)."""
    norm = os.path.join(outdir, "norm.txt")
    with open(norm, "w") as fh:
        fh.write("\n".join(f"{v:.6f}" for v in rng.uniform(0, 1, n_sites)))
        fh.write("\n")
    rot = os.path.join(outdir, "rot.tsv")
    if mat is None:
        mat = rng.normal(0, 0.003, size=(n_sites, dims))
    with open(rot, "w") as fh:
        fh.write("AlleleID\t" + "\t".join(f"PC{i}" for i in range(dims)) + "\n")
        for i in range(n_sites):
            fh.write(f"rs{100000+i}\t" + "\t".join(f"{x:.8f}" for x in mat[i]) + "\n")
    return rot, norm


def main() -> None:
    pos = [a for i, a in enumerate(sys.argv[1:], 1) if not a.startswith("--")
           and sys.argv[i - 1] not in ("--ref", "--dir")]
    n_samples = int(pos[0]) if pos else 256
    ref_bin = None
    if "--ref" in sys.argv:
        ref_bin = sys.argv[sys.argv.index("--ref") + 1]
    pca_mode = "--pca" in sys.argv
    exact_mode = "--exact" in sys.argv
    dirty_frac = 0.3 if pca_mode else 0.0

    rng = np.random.default_rng(123)
    if "--dir" in sys.argv:  # reuse a previously generated cohort
        import glob

        tmp = sys.argv[sys.argv.index("--dir") + 1]
        paths = sorted(glob.glob(os.path.join(tmp, "s*_counts.txt")))[:n_samples]
        n_samples = len(paths)
        print(f"# reusing {n_samples} count files from {tmp}", file=sys.stderr)
    else:
        tmp = tempfile.mkdtemp(prefix="ntsm_evalbench_")
        t0 = time.perf_counter()
        paths = make_count_files(tmp, n_samples, rng, dirty_frac=dirty_frac)
        print(f"# generated {n_samples} count files in {time.perf_counter()-t0:.1f} s",
              file=sys.stderr)
    n_pairs = n_samples * (n_samples - 1) // 2

    if not exact_mode:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from gpu_check import require_gpu

        print(f"# device: {require_gpu('bench_eval')}", file=sys.stderr)

    # --- our engine, end-to-end through the CLI code path ---
    from ntsm_tpu.eval.tpu import load_count_data_eval as load_count_data
    from ntsm_tpu.options import Options

    if exact_mode:
        from ntsm_tpu.eval.exact import compute_score_all as _score_all
    else:
        from ntsm_tpu.eval.tpu import compute_score_all_tpu as _score_all

    opts = Options(all=True, engine="exact" if exact_mode else "tpu")
    t0 = time.perf_counter()
    data = load_count_data(paths, opts)
    t_load = time.perf_counter() - t0
    out = open(os.path.join(tmp, "ours.tsv"), "w")
    t1 = time.perf_counter()
    _score_all(data, opts, out)
    out.close()
    t_score = time.perf_counter() - t1
    wall = t_load + t_score
    print(f"# ours: load {t_load:.1f} s, score+format {t_score:.1f} s",
          file=sys.stderr)
    print(json.dumps({
        "metric": "eval_pairs_per_s",
        "engine": "exact" if exact_mode else "tpu",
        "n_samples": n_samples,
        "value": round(n_pairs / wall, 1), "wall_s": round(wall, 2),
    }))

    # --- -p (PCA-filtered) on the same (30%-dirty) cohort: the device
    # pair-block scorer should beat -a even when every dirty sample sits
    # in the infinite-radius tier ---
    if pca_mode:
        from ntsm_tpu.eval.pca import pca_candidates, project_pcs, search_radii
        from ntsm_tpu.eval.tpu import compute_score_pca_tpu

        rot, norm = make_pca_artifacts(tmp, rng)
        opts_p = Options(all=True, pca=rot, norm=norm, engine="tpu")
        t1 = time.perf_counter()
        cloud = project_pcs(data, opts_p)
        out = open(os.path.join(tmp, "ours_pca.tsv"), "w")
        t2 = time.perf_counter()
        compute_score_pca_tpu(data, opts_p, out, cloud)
        out.close()
        t_p = time.perf_counter() - t2
        wall_p = t_load + (time.perf_counter() - t1)
        # diagnostics only — enumerated OUTSIDE the timed window (the
        # scorer re-enumerates internally; counting it twice inside the
        # window would skew the published rate)
        n_cand = sum(1 for _ in pca_candidates(
            cloud[:, : opts_p.dim], search_radii(data, opts_p), opts_p.dim))
        print(f"# -p tpu: project {t2-t1:.1f} s, search+score {t_p:.1f} s, "
              f"{n_cand} candidate pairs of {n_pairs}", file=sys.stderr)
        print(json.dumps({
            "metric": "eval_pairs_per_s", "engine": "tpu_pca",
            "n_samples": n_samples, "n_candidates": n_cand,
            "value": round(n_pairs / wall_p, 1), "wall_s": round(wall_p, 2),
        }))

    # --- reference ---
    if ref_bin:
        for t in sorted({1, os.cpu_count() or 1}):
            t0 = time.perf_counter()
            with open(os.path.join(tmp, f"ref_t{t}.tsv"), "wb") as fh:
                subprocess.run([ref_bin, "-a", "-t", str(t), *paths],
                               stdout=fh, stderr=subprocess.DEVNULL, check=True)
            wall = time.perf_counter() - t0
            print(json.dumps({
                "metric": "eval_pairs_per_s", "engine": f"ref_t{t}",
                "n_samples": n_samples, "value": round(n_pairs / wall, 1),
                "wall_s": round(wall, 2),
            }))


if __name__ == "__main__":
    main()
