"""Smoke run of `ntsm count` and `ntsm eval` on the GPU, end to end.

Drives the CLI in this process through ``ntsm_tpu.cli.main`` (the entry
point of ``python -m ntsm_tpu``) at the published site-table shape —
96,287 sites, k=19, ~2.5M site k-mers — on inputs generated from --seed,
and checks every device result against the repository's host oracles:
the golden count engine and the exact float64 eval engine.

  phase 0  device and host: card, JAX, compile cache, native library
  phase 1  ntsm count on two gzipped 150 bp FASTQ samples (~100 Mbase
           each, mostly off-site background) vs --engine golden
  phase 2  -m: the pinned device -m fixture, then -m 10 on a phase-1
           sample (no stop) and a stop part-way through both samples
  phase 3  ntsm eval -a on >= 259 count files (auto engine) vs exact
  phase 4  ntsm eval -a -n -p on the same cohort vs exact -p

Only this process opens the card.  The golden oracle and the input
generators run in worker processes pinned to JAX's CPU backend, so the
host work overlaps the device phases.

    python chip_smoke.py [--seed N] [--four-cards]

--four-cards runs phases 1 and 3 on four local GPUs (the auto-sharded
count mesh and the mesh rect eval engine) and checks that every card
holds its shard.  Any failed check exits non-zero; on success the last
line of standard output is one JSON object naming the device.  Wall
times and peak device memory printed per phase are set-up figures, not
benchmark numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_SITES = 96287  # the published human site set (k=19, 31 bp windows)
READ_LEN = 150
WINDOW = 31
GENOME = 3.1e9  # human genome size, sets the WGS-like site-read share
SAMPLE_MBASE = 100.0  # per phase-1 sample
SAMPLE_PARTS = 8  # gzipped FASTQ files per sample (the oracle runs per file)
SCORE_TOL = 5e-6  # device vs exact score bound the eval fuzz tests assert
DIST_TOL = 1.5e-6  # -p dist column: printed to 6 decimals from two projections


class CheckFailed(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


# ---------------------------------------------------------------- workers


def _pin_cpu() -> None:
    """Worker initializer: keep the worker off the card."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _golden_part(sites: str, fq: str) -> dict:
    """The golden engine on one FASTQ part (worker process)."""
    from ntsm_tpu.count.golden import count_files
    from ntsm_tpu.io.sites import load_site_table

    table = load_site_table(sites, 19, allow_dupes=False)
    r = count_files(table, [fq])
    return dict(counts=r.counts, total_kmers=r.total_kmers,
                total_hits=r.total_hits, total_bases=r.total_bases,
                total_reads=r.total_reads)


def _cohort_part(outdir: str, n: int, start: int, seed: int,
                 n_sites: int) -> list[str]:
    """Count files s{start:04d}.. from scripts/bench_eval (worker)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_eval

    rng = np.random.default_rng([seed, start])
    return bench_eval.make_count_files(outdir, n, rng, n_sites=n_sites,
                                       start=start)


def make_pool(workers: int):
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_pin_cpu,
    )


# ---------------------------------------------------------------- inputs


def make_sites(work: str, n_sites: int, seed: int):
    """Site FASTA (tests/synth.make_site_fasta) -> (path, AT and CG
    windows as [n_sites, 31] byte arrays)."""
    import importlib.util

    # by path: an installed package named `tests` would shadow the repo's
    spec = importlib.util.spec_from_file_location(
        "ntsm_synth", os.path.join(REPO, "tests", "synth.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    make_site_fasta = synth.make_site_fasta

    path = os.path.join(work, "sites.fa")
    _, sites = make_site_fasta(np.random.default_rng([seed, 1]), n_sites,
                               path=path)
    at = np.frombuffer(b"".join(s["at_win"] for s in sites), np.uint8)
    cg = np.frombuffer(b"".join(s["cg_win"] for s in sites), np.uint8)
    return path, at.reshape(n_sites, WINDOW), cg.reshape(n_sites, WINDOW)


_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in (b"AT", b"TA", b"CG", b"GC"):
    _COMP[_a] = _b


def make_sample(work: str, name: str, at, cg, mbase: float, parts: int,
                rng, share: float | None = None) -> list[str]:
    """One sample as `parts` gzipped FASTQ files of 150 bp reads.

    Reads are uniform random background (0.1% N) except a WGS-like share
    that carries a whole site window — n_sites x (150 - 31 + 1) / 3.1e9,
    ~0.37% at the full site set — with a per-site genotype, random
    offset and random strand.  Reads drawn only from site windows would
    overflow the candidate budget and test the retry tier instead."""
    n_sites = at.shape[0]
    n = max(parts, int(mbase * 1e6) // READ_LEN)
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = bases[rng.integers(0, 4, size=(n, READ_LEN), dtype=np.uint8)]
    reads[rng.random((n, READ_LEN)) < 0.001] = ord("N")
    if share is None:
        share = n_sites * (READ_LEN - WINDOW + 1) / GENOME
    n_site = max(1, int(round(n * share)))
    rows = rng.choice(n, size=n_site, replace=False)
    site = rng.integers(0, n_sites, size=n_site)
    geno = rng.integers(0, 3, size=n_sites)  # 0 hom AT, 1 het, 2 hom CG
    use_cg = np.where(geno[site] == 1, rng.random(n_site) < 0.5,
                      geno[site] == 2)
    win = np.where(use_cg[:, None], cg[site], at[site])
    off = rng.integers(0, READ_LEN - WINDOW + 1, size=n_site)
    reads[rows[:, None], off[:, None] + np.arange(WINDOW)] = win
    rc = rows[rng.random(n_site) < 0.5]
    reads[rc] = _COMP[reads[rc][:, ::-1]]

    # fixed-width records: "@r%09d\n" seq "\n+\n" qual "\n"
    rec = np.empty((n, 12 + 2 * READ_LEN + 4), np.uint8)
    rec[:, 0], rec[:, 1], rec[:, 11] = ord("@"), ord("r"), ord("\n")
    ids = np.arange(n, dtype=np.int64)[:, None]
    rec[:, 2:11] = ids // 10 ** np.arange(8, -1, -1) % 10 + ord("0")
    q0 = 12 + READ_LEN
    rec[:, 12:q0] = reads
    rec[:, q0:q0 + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, q0 + 3:-1] = ord("I")
    rec[:, -1] = ord("\n")
    paths = []
    for p, chunk in enumerate(np.array_split(rec, parts)):
        path = os.path.join(work, f"{name}_part{p}.fq.gz")
        with gzip.open(path, "wb", compresslevel=1) as fh:
            fh.write(chunk.tobytes())
        paths.append(path)
    return paths


# ---------------------------------------------------------------- the CLI


def run_cli(argv, out_path: str | None = None) -> str:
    """ntsm_tpu.cli.main(argv) in this process; stdout to out_path,
    returns what it wrote to stderr.  A non-zero exit fails the check."""
    from ntsm_tpu.cli import main

    err = io.StringIO()
    out_fh = open(out_path, "w") if out_path else io.StringIO()
    try:
        with contextlib.redirect_stdout(out_fh), contextlib.redirect_stderr(err):
            rc = main(list(argv))
    finally:
        out_fh.close()
    check(rc == 0, f"ntsm {' '.join(argv[:3])} ... exited {rc}:\n"
          + err.getvalue()[-3000:])
    return err.getvalue()


def summary_value(text: str, key: str) -> int:
    for line in text.splitlines():
        if line.startswith(key + ":"):
            return int(line.split(":", 1)[1])
    raise CheckFailed(f"{key!r} missing from the count summary")


def counts_sum(path: str) -> int:
    """Sum of the sumAT and sumCG columns: every recorded k-mer hit."""
    total = 0
    with open(path) as fh:
        for line in fh:
            if line[:1] in ("#", "\n"):
                continue
            f = line.split("\t")
            total += int(f[3]) + int(f[4])
    return total


def golden_counts_text(sites: str, results: list[dict]) -> str:
    """What `ntsm count --engine golden` prints for these parts: without
    -m the golden engine's result over several files is the sum of its
    per-file results."""
    from ntsm_tpu.count.golden import CountResult
    from ntsm_tpu.io.countfile import format_counts
    from ntsm_tpu.io.sites import load_site_table

    table = load_site_table(sites, 19, allow_dupes=False)
    r = CountResult(
        counts=sum(x["counts"] for x in results),
        total_kmers=sum(x["total_kmers"] for x in results),
        total_hits=sum(x["total_hits"] for x in results),
        total_bases=sum(x["total_bases"] for x in results),
        total_reads=sum(x["total_reads"] for x in results),
        early_term=False,
    )
    mx, sm = r.site_max_sum(table)
    return format_counts(table.site_ids, mx, sm, table.distinct,
                         r.total_kmers, 19)


def compare_summaries(dev: str, exact: str, score_tol: float = SCORE_TOL,
                      dist_tol: float = DIST_TOL) -> dict:
    """Device vs exact eval output: same rows in the same order, every
    column identical except score (within score_tol) and the -p dist
    column (within dist_tol).  Returns the row count and the largest
    differences."""
    a, b = dev.splitlines(), exact.splitlines()
    check(len(a) == len(b), f"row counts differ: {len(a)} vs {len(b)}")
    check(a[:1] == b[:1], "headers differ")
    max_score = max_dist = 0.0
    for ra, rb in zip(a[1:], b[1:]):
        ca, cb = ra.split("\t"), rb.split("\t")
        check(len(ca) == len(cb) and ca[:2] == cb[:2] and ca[3] == cb[3]
              and ca[5:] == cb[5:],
              f"rows differ beyond score/dist:\n  {ra}\n  {rb}")
        for col, tol in ((2, score_tol), (4, dist_tol)):
            if ca[col] != cb[col]:
                d = abs(float(ca[col]) - float(cb[col]))
                check(d <= tol, f"column {col} differs by {d}:\n  {ra}\n  {rb}")
                if col == 2:
                    max_score = max(max_score, d)
                else:
                    max_dist = max(max_dist, d)
    return dict(rows=len(a) - 1, max_score_diff=max_score,
                max_dist_diff=max_dist)


# ---------------------------------------------------------------- phases


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return res.stdout.strip().replace("\n", " | ") or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def peak_bytes() -> list:
    import jax

    out = []
    for d in jax.devices():
        stats = d.memory_stats() or {}
        out.append(stats.get("peak_bytes_in_use"))
    return out


def phase0(n_devices: int) -> dict:
    """Device and host facts; fails unless JAX runs on n_devices GPUs
    and the native host library loads."""
    import jax

    from ntsm_tpu import native
    from ntsm_tpu.utils.machine import compile_cache_dir

    print(f"[phase 0] card: {card_line()}")
    print(f"[phase 0] jax {jax.__version__}, devices {jax.devices()}")
    print("[phase 0] compile cache: "
          + (os.environ.get("JAX_COMPILATION_CACHE_DIR")
             or compile_cache_dir() or "off")
          + f", XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    lib = native.load()
    print(f"[phase 0] native host library: {'loaded' if lib else 'MISSING'}")
    check(lib is not None, "the native host library did not load")
    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"JAX runs on {dev.platform!r}, not on a GPU")
    check(len(jax.devices()) >= n_devices,
          f"{n_devices} GPUs needed, JAX sees {len(jax.devices())}")
    print("[phase 0] passed")
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()))


def phase1(work: str, sites: str, samples: dict, golden_futs: dict) -> dict:
    """Device `ntsm count` per sample vs the golden oracle's counts.txt
    (byte-identical).  Returns per-sample count-file paths and totals."""
    out = {}
    for name, parts in samples.items():
        path = os.path.join(work, f"{name}_counts.txt")
        summ = os.path.join(work, f"{name}_summary.txt")
        err = run_cli(["count", "-v", "-v", "-s", sites, "-o", summ, *parts],
                      path)
        tiers = [ln for ln in err.splitlines() if "overflow:" in ln]
        print(f"[phase 1] {name}: {tiers[-1].strip() if tiers else '?'}")
        check(tiers, "the count engine printed no overflow tier counts")
        n_host = int(tiers[-1].split("device retries, ")[1].split()[0])
        check(n_host == 0, f"{n_host} batches took the host-recount tier")
        with open(summ) as fh:
            text = fh.read()
        out[name] = dict(path=path, parts=parts,
                         hits=summary_value(text, "Total k-mers Recorded"),
                         bases=summary_value(text, "Total Bases Considered"),
                         n_kmers=summary_value(
                             text, "Distinct k-mers in initial set"))
    for name, info in out.items():
        want = golden_counts_text(sites, [f.result() for f in golden_futs[name]])
        with open(info["path"]) as fh:
            got = fh.read()
        check(got == want, f"{name}: counts.txt differs from --engine golden")
        print(f"[phase 1] {name}: counts.txt byte-identical to golden "
              f"({info['bases']} bases, {info['hits']} hits)")
    print("[phase 1] passed")
    return out


def phase2_fixture() -> None:
    """The pinned device -m fixture (tests/test_count_v3.py's config)."""
    from ntsm_tpu.count.engine import EngineConfig, run_count_v3
    from ntsm_tpu.io.countfile import format_counts
    from ntsm_tpu.io.sites import load_site_table
    from ntsm_tpu.options import Options

    fix = os.path.join(REPO, "tests", "fixtures")
    table = load_site_table(os.path.join(fix, "sites.fa"), 19,
                            allow_dupes=False)
    cfg = EngineConfig(batch_reads=64, segment_len=128,
                       early_term_check_every=2)
    res = run_count_v3(table, [os.path.join(fix, "sampleA.fq")],
                       Options(cov_thresh=2.0), cfg)
    mx, sm = res.site_max_sum(table)
    text = format_counts(table.site_ids, mx, sm, table.distinct,
                         res.total_kmers, 19)
    with open(os.path.join(fix, "device_m2_counts.txt")) as fh:
        check(text == fh.read(), "device -m fixture: counts differ")
    with open(os.path.join(fix, "device_m2_meta.txt")) as fh:
        meta = dict(line.split("=") for line in fh.read().splitlines())
    check(res.early_term == (meta["early_term"] == "True")
          and res.total_kmers == int(meta["total_kmers"])
          and res.total_hits == int(meta["total_hits"])
          and res.total_bases == int(meta["total_bases"])
          and res.total_reads == int(meta["total_reads"])
          and int(res.counts.sum()) == res.total_hits,
          "device -m fixture: totals differ from device_m2_meta.txt")
    print("[phase 2] device -m fixture matches device_m2_counts/meta")


def phase2_cli(work: str, sites: str, counted: dict) -> None:
    """-m through the CLI on the phase-1 samples.  -m 10 on one sample is
    too high a threshold to stop on ~100 Mbase, so it must count the
    whole sample exactly as phase 1 did.  On both samples' files in one
    run, a threshold of a quarter of their hits must stop early: the
    device checks -m at drains of 8 batches, so the stop needs more than
    16 batches of input (134 Mbase at the default batch)."""
    a, b = counted["sampleA"], counted["sampleB"]
    path = os.path.join(work, "m10_counts.txt")
    err = run_cli(["count", "-m", "10", "-s", sites, *a["parts"]], path)
    check("Reached desired (-m) threshold" not in err,
          "-m 10 stopped early on a ~100 Mbase sample")
    with open(path) as fh, open(a["path"]) as gh:
        check(fh.read() == gh.read(), "-m 10 counts differ from phase 1")
    print("[phase 2] -m 10: no stop (threshold "
          f"{a['n_kmers'] * 10 / 2:.0f} hits > {a['hits']} in the sample), "
          "counts.txt identical to phase 1")

    m_arg = f"{(a['hits'] + b['hits']) / (2 * a['n_kmers']):.6g}"
    thresh = a["n_kmers"] * float(m_arg) / 2
    path = os.path.join(work, "mstop_counts.txt")
    summ = os.path.join(work, "mstop_summary.txt")
    err = run_cli(["count", "-m", m_arg, "-s", sites, "-o", summ,
                   *a["parts"], *b["parts"]], path)
    with open(summ) as fh:
        text = fh.read()
    hits = summary_value(text, "Total k-mers Recorded")
    bases = summary_value(text, "Total Bases Considered")
    total = a["bases"] + b["bases"]
    check("Reached desired (-m) threshold" in err, f"-m {m_arg} did not stop")
    check(hits > thresh, f"-m {m_arg} stopped at {hits} <= {thresh} hits")
    check(bases < total, f"-m {m_arg} read all {total} bases")
    check(counts_sum(path) == hits,
          f"-m {m_arg}: counts sum {counts_sum(path)} != recorded {hits}")
    print(f"[phase 2] -m {m_arg} on both samples: stopped after {bases} of "
          f"{total} bases, recorded {hits} hits (> {thresh:.0f}) == sum "
          "of counts")
    print("[phase 2] passed")


def phase3(work: str, files: list[str]) -> None:
    """`ntsm eval -a` under the auto engine choice (must pick the device)
    vs --engine exact."""
    dev_out = os.path.join(work, "eval_all_dev.tsv")
    ex_out = os.path.join(work, "eval_all_exact.tsv")
    err = run_cli(["eval", "-a", "-v", *files], dev_out)
    check("ntsm eval: engine tpu" in err,
          "the auto engine choice did not pick the device engine")
    run_cli(["eval", "-a", "--engine", "exact", *files], ex_out)
    with open(dev_out) as fa, open(ex_out) as fb:
        cmp = compare_summaries(fa.read(), fb.read())
    print(f"[phase 3] eval -a, N={len(files)}: {cmp['rows']} rows, integer "
          f"columns identical, largest score difference "
          f"{cmp['max_score_diff']:.3g} (bound {SCORE_TOL})")
    print("[phase 3] passed")


def phase4(work: str, files: list[str], rot: str, norm: str) -> None:
    """`ntsm eval -a -n -p` (streamed -p engine) vs --engine exact -p."""
    dev_out = os.path.join(work, "eval_pca_dev.tsv")
    ex_out = os.path.join(work, "eval_pca_exact.tsv")
    err = run_cli(["eval", "-a", "-v", "-n", norm, "-p", rot, *files],
                  dev_out)
    check("ntsm eval: engine tpu" in err,
          "the auto engine choice did not pick the device engine")
    check("-p stream failed" not in err, "the streamed -p engine failed")
    run_cli(["eval", "-a", "--engine", "exact", "-n", norm, "-p", rot,
             *files], ex_out)
    with open(dev_out) as fa, open(ex_out) as fb:
        cmp = compare_summaries(fa.read(), fb.read())
    check(cmp["rows"] > 0, "eval -p produced no candidate pairs")
    print(f"[phase 4] eval -a -p, N={len(files)}: {cmp['rows']} candidate "
          f"rows, largest score difference {cmp['max_score_diff']:.3g}, "
          f"largest dist difference {cmp['max_dist_diff']:.3g}")
    print("[phase 4] passed")


# ---------------------------------------------------------------- driver


def report(phase: int, t0: float, card: str) -> None:
    print(f"[phase {phase}] set-up figures, not benchmark numbers: wall "
          f"{time.perf_counter() - t0:.1f} s, peak_bytes_in_use so far per "
          f"device {peak_bytes()} ({card})", flush=True)


def check_shards(count_shardings: list, phase: int) -> None:
    """Four cards: the count state was sharded over every device and each
    device's peak memory is a real share, not a bystander's."""
    import jax

    n = len(jax.devices())
    check(count_shardings, "the count engine never merged a device mesh")
    devs = count_shardings[-1]
    check(len(devs) == n, f"count state on {len(devs)} of {n} devices")
    peaks = [p or 0 for p in peak_bytes()]
    check(min(peaks) >= 0.25 * max(peaks) and min(peaks) > 0,
          f"uneven device memory peaks {peaks}: work left on one card")
    print(f"[four cards] after phase {phase}: count state sharded over "
          f"{len(devs)} devices, peak bytes per device {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="phases 1 and 3 on four local GPUs only")
    args = ap.parse_args(argv)

    import jax

    info = phase0(4 if args.four_cards else 1)
    card = card_line()
    count_shardings: list = []
    if args.four_cards:
        check(info["count"] == 4, f"--four-cards needs 4 GPUs, not {info['count']}")
        import ntsm_tpu.parallel.mesh as mesh_mod

        merge = mesh_mod.merge_counts_across_devices

        def recording_merge(c):
            count_shardings.append(
                sorted({s.device.id for s in c.addressable_shards}))
            return merge(c)

        mesh_mod.merge_counts_across_devices = recording_merge

    work = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    pool = make_pool(min(16, os.cpu_count() or 1))
    try:
        t0 = time.perf_counter()
        sites, at, cg = make_sites(work, N_SITES, args.seed)
        rng = np.random.default_rng([args.seed, 2])
        samples = {name: make_sample(work, name, at, cg, SAMPLE_MBASE,
                                     SAMPLE_PARTS, rng)
                   for name in ("sampleA", "sampleB")}
        golden = {name: [pool.submit(_golden_part, sites, p) for p in parts]
                  for name, parts in samples.items()}
        from ntsm_tpu.cli.eval_cmd import AUTO_DEVICE_MIN_SAMPLES

        # > 256 rows (two rect blocks, a ragged last tile) and above the
        # auto cutoff together with the two phase-1 files
        n_cohort = max(257, AUTO_DEVICE_MIN_SAMPLES - 1)
        per = -(-n_cohort // 16)
        cohort = [pool.submit(_cohort_part, work, min(per, n_cohort - s), s,
                              args.seed, N_SITES)
                  for s in range(0, n_cohort, per)]
        print(f"[inputs] {N_SITES} sites, 2 samples x {SAMPLE_PARTS} gzipped "
              f"FASTQ parts of {SAMPLE_MBASE} Mbase each, cohort of "
              f"{n_cohort} count files (seed {args.seed})")

        counted = phase1(work, sites, samples, golden)
        report(1, t0, card)
        if args.four_cards:
            check_shards(count_shardings, 1)
        else:
            t0 = time.perf_counter()
            phase2_fixture()
            phase2_cli(work, sites, counted)
            report(2, t0, card)

        t0 = time.perf_counter()
        files = [p for f in cohort for p in f.result()]
        files += [c["path"] for c in counted.values()]
        phase3(work, files)
        report(3, t0, card)
        if args.four_cards:
            check_shards(count_shardings, 3)
        else:
            t0 = time.perf_counter()
            sys.path.insert(0, os.path.join(REPO, "scripts"))
            import bench_eval

            rot, norm = bench_eval.make_pca_artifacts(
                work, np.random.default_rng([args.seed, 3]))
            phase4(work, files, rot, norm)
            report(4, t0, card)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(work, ignore_errors=True)

    print(f"card: {card}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
