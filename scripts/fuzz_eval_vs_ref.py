"""Differential eval fuzz: random cohorts of count files through the
reference ntsmEval binary vs `ntsm eval --engine exact`; the summary.tsv
must be byte-identical (the exact engine's bit-parity claim), across flag
combinations (-a, -c, -w, -g, thresholds).

Counts are synthesized with realistic structure: duplicate pairs, a
related pair, missing sites, a low-coverage sample, occasional zero/huge
counts — plus edge cohorts (N=2, single-site overlap).

Usage: python scripts/fuzz_eval_vs_ref.py [trials=20] [--ref /tmp/ntsm_ref/ntsmEval]
Requires a built reference binary; exits 0 with a note when absent.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def make_cohort(tmp, t, rng):
    from ntsm_tpu.io.countfile import format_counts

    L = int(rng.integers(2, 120))
    n = int(rng.integers(2, 7))
    site_ids = [f"rs{100000 + i}" for i in range(L)]
    distinct = np.full((L, 2), int(rng.integers(5, 20)), dtype=np.int64)
    freq = rng.uniform(0.05, 0.95, size=L)
    base_gt = rng.random((n, L))
    paths = []
    for s in range(n):
        gt = np.select(
            [base_gt[s] < freq**2, base_gt[s] < freq],
            [2, 1],
            default=0,
        )
        if s == 1:  # duplicate of sample 0 (same genotypes)
            gt = np.select(
                [base_gt[0] < freq**2, base_gt[0] < freq], [2, 1], default=0
            )
        cov = float(rng.uniform(1.0, 40.0)) if s != n - 1 else 0.8
        lam_a = np.where(gt == 0, cov, np.where(gt == 1, cov / 2, 0.02))
        lam_b = np.where(gt == 2, cov, np.where(gt == 1, cov / 2, 0.02))
        mx = np.stack(
            [rng.poisson(lam_a), rng.poisson(lam_b)], axis=1
        ).astype(np.int64)
        if rng.random() < 0.3:  # missing block
            k = int(rng.integers(0, L))
            mx[k : k + max(1, L // 5)] = 0
        if rng.random() < 0.15:  # one huge count
            mx[int(rng.integers(0, L)), int(rng.integers(0, 2))] = int(
                rng.integers(10_000, 60_000)
            )
        text = format_counts(
            site_ids, mx, mx * int(rng.integers(5, 12)), distinct,
            int(mx.sum() * 37 + 1), 19,
        )
        p = os.path.join(tmp, f"t{t}_s{s}_counts.txt")
        with open(p, "w") as fh:
            fh.write(text)
        paths.append(p)
    return paths


FLAGSETS = (
    ["-a"],
    [],
    ["-a", "-c", "0"],
    ["-a", "-c", "3"],
    ["-a", "-w", "0"],
    ["-a", "-w", "0.5"],
    ["-a", "-g", "120000"],
    ["-s", "2.5", "-a"],
    "qc",  # single-file QC mode (general stats table)
    "pca",  # -p filtered scoring: kd-tree-equivalent candidate parity
    "pca-all",
    "merge",  # -o -e: merged counts file byte parity
)


def main() -> int:
    trials = 20
    ref_bin = "/tmp/ntsm_ref/ntsmEval"
    args = sys.argv[1:]
    if args and args[0].isdigit():
        trials = int(args[0])
    if "--ref" in args:
        ref_bin = args[args.index("--ref") + 1]
    if not os.path.exists(ref_bin):
        print(f"reference binary not found at {ref_bin}; skipping")
        return 0

    rng = np.random.default_rng(20260818)
    tmp = tempfile.mkdtemp(prefix="fuzz_eval_")
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    fails = 0
    for t in range(trials):
        paths = make_cohort(tmp, t, rng)
        flags = FLAGSETS[t % len(FLAGSETS)]
        merge_pair = None
        if flags == "merge":
            ra = os.path.join(tmp, f"t{t}_ref_merged.txt")
            ob = os.path.join(tmp, f"t{t}_our_merged.txt")
            merge_pair = (ra, ob)
            ref = subprocess.run(
                [ref_bin, "-t", "1", "-o", "-e", ra, *paths[:2]],
                capture_output=True,
            )
            ours = subprocess.run(
                [sys.executable, "-m", "ntsm_tpu", "eval", "--engine",
                 "exact", "-o", "-e", ob, *paths[:2]],
                env=env, capture_output=True,
            )
            ok = (ref.returncode == ours.returncode == 0
                  and ref.stdout == ours.stdout
                  and open(ra, "rb").read() == open(ob, "rb").read())
            if not ok:
                fails += 1
                print(f"FAIL trial {t} merge: rc {ref.returncode}/{ours.returncode}")
            continue
        if flags == "qc":
            flags, paths = [], paths[:1]
        elif isinstance(flags, str) and flags.startswith("pca"):
            # synthetic rotation/center matching this cohort's site list
            # (contents arbitrary: parity needs both tools to read the
            # same files; tests/make_fixtures.py does the same)
            with open(paths[0]) as fh:
                ids = [ln.split("\t", 1)[0] for ln in fh
                       if ln[0] != "#" and not ln.startswith("locusID")]
            dims = int(rng.integers(2, 6))
            rot = os.path.join(tmp, f"t{t}_rot.tsv")
            cen = os.path.join(tmp, f"t{t}_center.txt")
            with open(rot, "w") as fh:
                fh.write("AlleleID\t" + "\t".join(map(str, range(dims))) + "\n")
                for sid in ids:
                    fh.write(sid + "\t" + "\t".join(
                        f"{v:.17g}" for v in rng.normal(0, 0.3, dims)) + "\n")
            with open(cen, "w") as fh:
                for _ in ids:
                    fh.write(f"{rng.random() * 0.9 + 0.05:.17g}\n")
            flags = (["-a"] if flags == "pca-all" else []) + [
                "-d", str(dims), "-p", rot, "-n", cen,
            ]
        ref = subprocess.run(
            [ref_bin, "-t", "1", *flags, *paths], capture_output=True
        )
        ours = subprocess.run(
            [sys.executable, "-m", "ntsm_tpu", "eval", "--engine", "exact",
             *flags, *paths],
            env=env,
            capture_output=True,
        )
        ok = ref.returncode == ours.returncode == 0 and ref.stdout == ours.stdout
        if not ok:
            fails += 1
            print(f"FAIL trial {t} {flags}: rc {ref.returncode}/{ours.returncode}")
            print("  files:", paths[0], f"(+{len(paths)-1})")
            rl, ol = ref.stdout.decode().splitlines(), ours.stdout.decode().splitlines()
            for a, b in zip(rl, ol):
                if a != b:
                    print("  ref:", a)
                    print("  our:", b)
                    break
            if len(rl) != len(ol):
                print(f"  row counts differ: {len(rl)} vs {len(ol)}")
    print(f"{trials} trials, {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
