"""``ntsm eval`` — flag-compatible with ntsmEval (src/ntSeqMatchEval.cpp).

Dispatch: 1 file -> QC mode; --only_merge -> merge only; -p absent ->
all-vs-all; -p present (requires -n) -> PCA projection + filtered scoring;
-e merges afterwards (ntSeqMatchEval.cpp:304-341).
"""

from __future__ import annotations

import getopt
import os
import sys
import time

from ntsm_tpu.options import Options

# --engine auto runs the exact host engine up to this many samples and the
# device engine above it: the crossover of whole CLI runs, start-up and
# compilation included, measured by scripts/time_eval_cutoff.py (PERF.md)
AUTO_DEVICE_MIN_SAMPLES = 128

HELP = """Usage: ntsm eval [FILES...]
Processes sets of counts files and compares their similarity.
If only a single file is provided general QC information returned.
  -t, --threads              Number of threads to run.[1]
  -s, --score_thresh = FLOAT Score threshold [0.500000]
  -a, --all                  Output results of all tests tried, not just those that
                             pass the score threshold.
  -w, --skew = FLOAT         Divides the score by coverage. Formula: (cov1*cov2)^skew
                             Set to zero for no skew.[0.200000]
  -c, --min_cov = INT        Keep only sites with this coverage and above.[1]
  -g, --genome_size = INT    Diploid genome size for error rate estimation.
                             [6200000000]
  -e, --merge = STR          After analysis merge counts and output to file.
  -o, --only_merge           Do not perform an analysis. Only functions when
                             -e (--merge) option is specified.
  -p, --pca = STR            Use PCA information to speed up analysis. Input is a
                             set of rotational values from a PCA.
  -d, --dim = INT            Number of dimensions to consider in PCA. [20]
  -n, --norm = STR           Set of values use to center the data before rotation
                             during PCA. [Required if -p is enabled]
  -r, --error_rate = FLOAT   Error rate threshold for PCA based search [0.010000]
  -1, --miss_small = FLOAT   Missing site threshold small for PCA based search [0.010000]
  -2, --miss_large = FLOAT   Missing site threshold large PCA based search [0.300000]
  -S, --small = FLOAT        Search radius for small PCA based search [2.000000]
  -l, --large = FLOAT        Search radius for large PCA based search [15.000000]
  -b, --debug = STR          Debug output with ground-truth same-sample groups.
  -h, --help                 Display this dialog.
  -v, --verbose              Display verbose output.
      --version              Print version information.
      --engine = STR         ntsm_tpu extension: auto (default), exact, tpu.
      --distributed          ntsm_tpu extension: multi-host mode. Initializes
                             jax.distributed; every process loads the count
                             files and the pairwise statistics shard the
                             sample rows over the global device mesh
                             (in-kernel all_gather); process 0 prints.
                             Needs JAX_COORDINATOR_ADDRESS /
                             JAX_NUM_PROCESSES / JAX_PROCESS_ID.
                             NTSM_DISTRIBUTED=1 is equivalent.
"""


def run(argv) -> int:
    opts = Options()
    distributed = bool(os.environ.get("NTSM_DISTRIBUTED"))
    try:
        parsed, files = getopt.gnu_getopt(
            argv,
            "t:vhs:c:m:aw:g:p:n:d:r:e:o1:2:S:l:b:",
            [
                "score_thresh=",
                "all",
                "min_cov=",
                "max_cov=",
                "skew=",
                "genome_size=",
                "threads=",
                "merge=",
                "only_merge",
                "help",
                "pca=",
                "norm=",
                "error_rate=",
                "miss_small=",
                "miss_large=",
                "small=",
                "large=",
                "debug=",
                "version",
                "verbose",
                "dim=",
                "engine=",
                "distributed",
            ],
        )
    except getopt.GetoptError as e:
        print(f"ntsm eval: {e}", file=sys.stderr)
        print("Try '--help' for more information.", file=sys.stderr)
        return 1

    for flag, val in parsed:
        if flag in ("-h", "--help"):
            print(HELP, file=sys.stderr)
            return 0
        elif flag == "--version":
            from ntsm_tpu import __version__

            print(f"ntsm eval (ntsm_tpu) {__version__}", file=sys.stderr)
            return 0
        elif flag in ("-a", "--all"):
            opts = opts.replace(all=True)
        elif flag in ("-s", "--score_thresh"):
            opts = opts.replace(score_thresh=float(val))
        elif flag in ("-w", "--skew"):
            opts = opts.replace(cov_skew=float(val))
        elif flag in ("-c", "--min_cov"):
            opts = opts.replace(min_cov=int(val))
        elif flag in ("-m", "--max_cov"):
            opts = opts.replace(max_cov=int(val))
        elif flag in ("-g", "--genome_size"):
            opts = opts.replace(genome_size=int(val))
        elif flag in ("-t", "--threads"):
            opts = opts.replace(threads=int(val))
        elif flag in ("-e", "--merge"):
            opts = opts.replace(merge=val)
        elif flag in ("-o", "--only_merge"):
            opts = opts.replace(only_merge=True)
        elif flag in ("-p", "--pca"):
            opts = opts.replace(pca=val)
        elif flag in ("-n", "--norm"):
            opts = opts.replace(norm=val)
        elif flag in ("-r", "--error_rate"):
            opts = opts.replace(pc_error_thresh=float(val))
        elif flag in ("-1", "--miss_small"):
            opts = opts.replace(pc_miss_site1=float(val))
        elif flag in ("-2", "--miss_large"):
            opts = opts.replace(pc_miss_site2=float(val))
        elif flag in ("-S", "--small"):
            opts = opts.replace(pc_search_radius1=float(val))
        elif flag in ("-l", "--large"):
            opts = opts.replace(pc_search_radius2=float(val))
        elif flag in ("-d", "--dim"):
            opts = opts.replace(dim=int(val))
        elif flag in ("-b", "--debug"):
            opts = opts.replace(debug=val)
        elif flag in ("-v", "--verbose"):
            opts = opts.replace(verbose=opts.verbose + 1)
        elif flag == "--engine":
            opts = opts.replace(engine=val)
        elif flag == "--distributed":
            distributed = True

    die = False
    for f in files:
        if not os.path.exists(f):
            print(f"ntsm eval: input file {f} does not exist", file=sys.stderr)
            die = True
    if not files:
        print("Error: Need Input File", file=sys.stderr)
        die = True
    if opts.pca and len(files) > 1 and not os.path.exists(opts.norm):
        print("Error: Need normalization file", file=sys.stderr)
        die = True
    if die:
        print("Try '--help' for more information.", file=sys.stderr)
        return 1

    if opts.engine == "auto":
        # exact (host f64, bit parity) runs the native pair kernel; the
        # device engine's fixed start-up and compile cost only pays for
        # itself at cohort scale (AUTO_DEVICE_MIN_SAMPLES).  Without the
        # native kernel the exact engine is the slow Python loop, so the
        # crossover drops to where that stays seconds.
        from ntsm_tpu import native as _native

        _lib = _native.load()
        cutoff = (
            AUTO_DEVICE_MIN_SAMPLES
            if _lib is not None and hasattr(_lib, "ntsm_exact_pairs")
            else 32
        )
        opts = opts.replace(engine="exact" if len(files) <= cutoff else "tpu")
    if opts.verbose > 0:
        print(f"ntsm eval: engine {opts.engine}", file=sys.stderr)
    elif opts.engine == "exact" and len(files) > 1000 and not opts.only_merge:
        n_pairs = len(files) * (len(files) - 1) // 2
        print(
            f"ntsm eval: --engine exact scores ~2800 pairs/s on the host "
            f"(native kernel); {n_pairs} pairs is roughly "
            f"{n_pairs / 2800 / 60:.0f} min. The default device engine "
            "produces identical integer columns and scores within ~1e-9.",
            file=sys.stderr,
        )

    t0 = time.monotonic()
    import contextlib

    from ntsm_tpu.eval.driver import run_eval
    from ntsm_tpu.eval.tpu import load_count_data_eval as load_count_data

    shield = contextlib.nullcontext()
    out = sys.stdout
    emit_after = None
    if distributed:
        import tempfile

        from ntsm_tpu.parallel.distributed import init_distributed, stdout_shield

        try:
            init_distributed()
        except ValueError as e:
            print(e, file=sys.stderr)
            return 1
        import jax

        # every process loads all count files and runs the same dispatch
        # (the global-mesh collectives inside compute_pair_stats_tpu need
        # all processes in lockstep); gloo/collective banners go to stdout,
        # so the whole compute runs under the stdout shield with the table
        # buffered — process 0 emits it afterwards.  The buffer spools to
        # disk past 16 MB so an all-vs-all table (~1 GB at N=3202) never
        # sits in memory alongside the count planes.  Non-zero processes
        # only need to run the collectives: they write into a discarding
        # sink.
        shield = stdout_shield()
        if jax.process_index() == 0:
            out = emit_after = tempfile.SpooledTemporaryFile(
                max_size=16 << 20, mode="w+", encoding="utf-8"
            )
        else:

            class _Discard:
                def write(self, _s):
                    return len(_s)

            out = _Discard()
            emit_after = None
        # the distributed path is the device engine by definition
        opts = opts.replace(engine="tpu")

    if opts.verbose > 0:
        print("Reading count files", file=sys.stderr)
    data = load_count_data(files, opts)
    with shield:
        run_eval(data, opts, out)
    if distributed:
        import jax

        if jax.process_index() != 0:
            return 0
    if emit_after is not None:
        import shutil

        emit_after.seek(0)
        shutil.copyfileobj(emit_after, sys.stdout, 1 << 20)
        emit_after.close()
    from ntsm_tpu.cli.count_cmd import _rss_kb

    print(
        f"Time: {time.monotonic() - t0:g} s Memory: {_rss_kb()} kbytes",
        file=sys.stderr,
    )
    return 0
