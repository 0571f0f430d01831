"""Human-scale end-to-end validation: sitegen, device count and device
eval against the host oracles in one command, on the GPU.

Pipeline (all in a temp dir):
  1. sitegen: synthesize a genome + VCF, build a >=10k-site interleaved
     FASTA through the full generate-sites pipeline (uniqueness filter,
     tier assembly) — reference: ntsm-scripts/makefile generate-sites.
  2. count: sample reads for two genotyped samples (~half the requested
     Mbase each) and run `ntsm count` with the device engine; assert the
     counts.txt bytes equal the golden (pure NumPy) oracle on the same
     input.
  3. eval: all-vs-all on the two count files with the device engine;
     assert integer columns equal the exact engine and scores agree to
     1e-6 rel, classification identical.

Usage: python scripts/validate_scale.py [total_mbase] [n_sites]
Defaults: 200 Mbase, 12000 sites; sitegen's host-side uniqueness scan and
the read synthesis dominate the runtime.  Prints the device first and
refuses to run without a GPU.

Exit status 0 = every assertion held.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(msg):
    print(f"[validate_scale +{time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


T0 = time.perf_counter()


def build_sites(d, n_sites, rng):
    """Synthetic genome + VCF -> generate_sites -> site FASTA path."""
    from ntsm_tpu.sitegen.pipeline import generate_sites

    glen = n_sites * 80 + 2000
    alpha = np.array(list(b"ACGT"), dtype=np.uint8)
    genome = alpha[rng.integers(0, 4, size=glen)]
    ref_path = os.path.join(d, "ref.fa")
    with open(ref_path, "w") as fh:
        fh.write(">chr1\n")
        g = genome.tobytes().decode()
        for i in range(0, glen, 80):
            fh.write(g[i : i + 80] + "\n")

    at, cg = b"AT", b"CG"
    rows = []
    for s in range(n_sites):
        pos = 1000 + s * 80  # 1-based
        ref_base = genome[pos - 1]
        if ref_base in at:
            alt = chr(cg[rng.integers(0, 2)])
        else:
            alt = chr(at[rng.integers(0, 2)])
        rows.append(f"chr1\t{pos}\trs{s}\t{chr(ref_base)}\t{alt}\t.\t.\t.")
    vcf_path = os.path.join(d, "sites.vcf")
    with open(vcf_path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.write("\n".join(rows) + "\n")

    prefix = os.path.join(d, "scale_sites")
    generate_sites(prefix, ref_path, vcf_path)
    # pick the densest tier that kept >= 90% of sites (mirrors using
    # human_sites_n10.fa in the reference data layout)
    import glob

    tiers = sorted(glob.glob(prefix + "_n*.fa"))
    assert tiers, "sitegen produced no tiers"
    best = None
    for t in tiers:
        n = sum(1 for line in open(t) if line.startswith(">"))
        if n >= 0.5 * n_sites and (best is None or n > best[1]):
            best = (t, n)
    assert best is not None, "no tier kept enough sites"
    log(f"sitegen: {best[1]} sites in {os.path.basename(best[0])}")
    return best[0]


def main():
    total_mbase = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    n_sites = int(sys.argv[2]) if len(sys.argv) > 2 else 12000
    from gpu_check import require_gpu

    log(f"device: {require_gpu('validate_scale')}")
    rng = np.random.default_rng(20260817)
    d = tempfile.mkdtemp(prefix="ntsm_scale_")
    log(f"workdir {d}")

    sites_fa = build_sites(d, n_sites, rng)

    from tests.synth import make_sample_reads

    from ntsm_tpu.count.engine import run_count
    from ntsm_tpu.count.golden import count_files
    from ntsm_tpu.io.countfile import format_counts
    from ntsm_tpu.io.sites import load_site_table
    from ntsm_tpu.options import Options

    table = load_site_table(sites_fa, 19, allow_dupes=False)
    log(f"site table: {table.n_sites} sites, {table.n_kmers} k-mers")

    # sample reads for two samples from the site windows (coverage chosen
    # to hit the requested Mbase)
    sites = []
    from ntsm_tpu.io.fastx import read_fastx

    recs = list(read_fastx(sites_fa))
    for i in range(0, len(recs), 2):
        sites.append(
            dict(name=recs[i].name, at_win=recs[i].seq, cg_win=recs[i + 1].seq)
        )

    per_sample = total_mbase / 2
    readlen = 150
    # make_sample_reads emits ~coverage * read_len * n_sites bases
    win_bases = sum(readlen for _ in sites)
    coverage = max(2, int(per_sample * 1e6 / max(win_bases, 1)))
    count_paths = []
    gts = []
    for s_i in range(2):
        gt = rng.integers(0, 3, size=len(sites))
        gts.append(gt)
        fq = os.path.join(d, f"sample{s_i}.fq")
        make_sample_reads(
            rng, sites, gt, coverage=coverage, error_rate=0.002,
            path=fq, read_len=readlen,
        )
        sz = os.path.getsize(fq)
        log(f"sample{s_i}: ~{sz / 2 / 1e6:.0f} Mbase written (cov {coverage})")

        t0 = time.perf_counter()
        res = run_count(table, [fq], Options())
        dev_s = time.perf_counter() - t0
        log(
            f"sample{s_i}: device count {res.total_bases / dev_s / 1e6:.1f} "
            f"Mbase/s ({res.total_bases} bases)"
        )
        gold = count_files(table, [fq])
        mx, sm = res.site_max_sum(table)
        gmx, gsm = gold.site_max_sum(table)
        dev_text = format_counts(
            table.site_ids, mx, sm, table.distinct, res.total_kmers, 19
        )
        gold_text = format_counts(
            table.site_ids, gmx, gsm, table.distinct, gold.total_kmers, 19
        )
        assert dev_text == gold_text, "device counts.txt != golden oracle"
        log(f"sample{s_i}: counts byte parity OK")
        p = os.path.join(d, f"sample{s_i}_counts.txt")
        with open(p, "w") as fh:
            fh.write(dev_text)
        count_paths.append(p)

    # eval round trip: device vs exact
    import io

    from ntsm_tpu.eval import exact
    from ntsm_tpu.eval.model import load_count_data
    from ntsm_tpu.eval.tpu import compute_score_all_tpu

    opts = Options(all=True, engine="tpu")
    data = load_count_data(count_paths, opts)
    b_dev, b_ex = io.StringIO(), io.StringIO()
    compute_score_all_tpu(data, opts, b_dev)
    exact.compute_score_all(data, Options(all=True, engine="exact"), b_ex)
    dev_rows = b_dev.getvalue().splitlines()
    ex_rows = b_ex.getvalue().splitlines()
    assert len(dev_rows) == len(ex_rows)
    for l1, l2 in zip(dev_rows[1:], ex_rows[1:]):
        f1, f2 = l1.split("\t"), l2.split("\t")
        # column 2 is the score; integer columns must match exactly
        for c, (x1, x2) in enumerate(zip(f1, f2)):
            if x1 == x2:
                continue
            v1, v2 = float(x1), float(x2)
            assert abs(v1 - v2) <= 1e-6 * max(1.0, abs(v2)), (c, x1, x2)
    log("eval device vs exact: integer columns identical, scores <=1e-6 rel")
    log("ALL CHECKS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
