"""Differential VCF-converter fuzz: random genome + multi-sample VCF
through the (patched-oracle) ntsmVCF binary vs `ntsm vcf`; the -p
matrix/center outputs must be byte-identical.

Covers the converter's quirk surface: './.' and half-call genotypes,
multi-base ALT rows (skipped -> all-missing sticky setprecision(19)),
unphased '/', duplicate site windows (first-write-wins), genotype columns
with extra FORMAT subfields, and site windows near the genome edges.

Usage: python scripts/fuzz_vcf_vs_ref.py [trials=20] [--ref /tmp/ntsm_ref/ntsmVCF]
The reference binary must be the oracle build (shipped v1.2.1 segfaults on
any data row; see tests/make_fixtures.py for the two-line patch).
"""

from __future__ import annotations

import filecmp
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

GT_POOL = ["0|0", "0|1", "1|0", "1|1", "./.", "0/0", "1/1", "0/1",
           "./1", "0|0:12:x", "1|1:0"]


def make_world(tmp, t, rng):
    from synth import random_genome

    w, k = 31, 19
    glen = int(rng.integers(900, 3000))
    genome = bytearray(random_genome(rng, glen))
    n_sites = int(rng.integers(2, 16))
    lo, hi = w // 2 + 1, glen - w // 2 - 1
    # sites must not share k-mers: the reference ABORTS on overlapping
    # windows (std::out_of_range "Couldn't find key" / double free after
    # its own collision warnings — found by this fuzzer; ntsm_tpu handles
    # them cleanly).  Its intended input (sitegen output) spaces sites,
    # so the fuzz domain does too.
    step = w + 5
    cands = np.arange(lo, hi, step)
    n_sites = min(n_sites, len(cands))
    positions = sorted(
        (cands + rng.integers(0, 5, size=len(cands)))[
            rng.choice(len(cands), size=n_sites, replace=False)
        ].tolist()
    )
    at, cg = b"AT", b"CG"
    rows, fa_entries = [], []
    # include cohorts well past 8 samples: numpy's pairwise summation
    # equals the reference's sequential center accumulation only for
    # <=8 addends, so small-N trials cannot discriminate the %.19Lg
    # center parity (the round-5 cumsum fix) — mix tiny and wide
    n_samples = int(rng.integers(1, 8) if rng.random() < 0.5
                    else rng.integers(9, 65))
    sample_ids = [f"S{i}" for i in range(n_samples)]
    for s_i, pos in enumerate(positions):
        ref_base = genome[pos - 1]
        if chr(ref_base) in "AT":
            alt = chr(cg[rng.integers(0, 2)])
            at_is_ref = True
        else:
            alt = chr(at[rng.integers(0, 2)])
            at_is_ref = False
        off = pos - w // 2 - 1
        ref_win = bytes(genome[off : off + w])
        var_win = ref_win[: w // 2] + alt.encode() + ref_win[w // 2 + 1 :]
        at_win, cg_win = (ref_win, var_win) if at_is_ref else (var_win, ref_win)
        name = f"rsv{s_i}"
        fa_entries.append(
            f">{name} ref\n{at_win.decode()}\n>{name} var\n{cg_win.decode()}\n"
        )
        if rng.random() < 0.15:  # non-SNP row: skipped, site all-missing
            rows.append(
                f"chr1\t{pos}\t{name}\t{chr(ref_base)}\tAC\t.\t.\t.\tGT\t"
                + "\t".join(["0|0"] * n_samples)
            )
            continue
        gts = [str(rng.choice(GT_POOL)) for _ in range(n_samples)]
        rows.append(
            f"chr1\t{pos}\t{name}\t{chr(ref_base)}\t{alt}\t.\t.\t.\tGT\t"
            + "\t".join(gts)
        )
    d = os.path.join(tmp, f"t{t}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "genome.fa"), "w") as fh:
        fh.write(">chr1\n" + bytes(genome).decode() + "\n")
    with open(os.path.join(d, "sites.fa"), "w") as fh:
        fh.write("".join(fa_entries))
    vcf = (
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(sample_ids) + "\n" + "\n".join(rows) + "\n"
    )
    with open(os.path.join(d, "multi.vcf"), "w") as fh:
        fh.write(vcf)
    return d, k, w


def main() -> int:
    trials = 20
    ref_bin = "/tmp/ntsm_ref/ntsmVCF"
    args = sys.argv[1:]
    if args and args[0].isdigit():
        trials = int(args[0])
    if "--ref" in args:
        ref_bin = args[args.index("--ref") + 1]
    if not os.path.exists(ref_bin):
        print(f"reference binary not found at {ref_bin}; skipping")
        return 0

    rng = np.random.default_rng(20260819)
    tmp = tempfile.mkdtemp(prefix="fuzz_vcf_")
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    fails = 0
    for t in range(trials):
        d, k, w = make_world(tmp, t, rng)
        ref = subprocess.run(
            [ref_bin, "-t", "1", "-k", str(k), "-w", str(w), "-p", "ref_out",
             "-s", "sites.fa", "-r", "genome.fa", "multi.vcf"],
            cwd=d, capture_output=True,
        )
        ours = subprocess.run(
            [sys.executable, "-m", "ntsm_tpu", "vcf", "-t", "1", "-k", str(k),
             "-w", str(w), "-p", "our_out", "-s", "sites.fa", "-r",
             "genome.fa", "multi.vcf"],
            cwd=d, env=env, capture_output=True,
        )
        ok = ref.returncode == ours.returncode == 0
        for suffix in ("_matrix.tsv", "_center.txt"):
            a = os.path.join(d, "ref_out" + suffix)
            b = os.path.join(d, "our_out" + suffix)
            if ok:
                ok = os.path.exists(a) == os.path.exists(b) and (
                    not os.path.exists(a) or filecmp.cmp(a, b, shallow=False)
                )
        if not ok:
            fails += 1
            print(f"FAIL trial {t}: rc {ref.returncode}/{ours.returncode} dir {d}")
            if ref.returncode:
                print("  ref stderr:", ref.stderr.decode()[-200:])
            if ours.returncode:
                print("  our stderr:", ours.stderr.decode()[-300:])
    print(f"{trials} trials, {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
