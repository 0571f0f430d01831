"""``ntsm count`` — flag-compatible with ntsmCount (src/ntSeqMatchCount.cpp).

Output contract (byte-compatible):
  stdout: #@TK/#@KS header + per-site count table
          (FingerPrint.hpp:261-311)
  stderr: info summary + "Time: ... Memory: ..." line
          (ntSeqMatchCount.cpp:181-183)
"""

from __future__ import annotations

import getopt
import math
import os
import sys
import time

from ntsm_tpu.options import Options

HELP = """Usage: ntsm count -s [FASTA] [OPTION]... [FILES...]
  -t, --threads = INT    Number of threads to run.[1]
  -m, --maxCov = INT     k-mer coverage threshold for early
                         termination. [inf]
  -o, --output = STR     Output for summary file.
  -d, --dupes            Allow shared k-mers between sites to
                         be counted.
  -s, --snp = STR        Interleaved fasta of SNP sites to
                         k-merize. [required]
  -k, --kmer = INT       k-mer size used. [19]
  -h, --help             Display this dialog.
  -v, --verbose          Display verbose output.
      --version          Print version information.
      --engine = STR     ntsm_tpu extension: tpu (default; the device
                         engine) or golden (the NumPy oracle on the host).
      --checkpoint = STR ntsm_tpu extension: restartable snapshot file; an
                         interrupted run resumes from it automatically.
      --checkpoint-every = INT
                         batches between snapshots [64].
      --trace = STR      ntsm_tpu extension: write a jax.profiler trace of
                         the device pipeline to this directory.
      --seglen = INT     ntsm_tpu extension: device segment length [256].
                         512 shaves upload bytes/base (halo + sidecar
                         amortize over more slots) at 2x the per-batch
                         candidate budget pressure; batch rows scale
                         inversely so the bases/step stay constant.
      --distributed      ntsm_tpu extension: multi-host mode. Initializes
                         jax.distributed from JAX_COORDINATOR_ADDRESS /
                         JAX_NUM_PROCESSES / JAX_PROCESS_ID (all three
                         required), shards the input files across hosts,
                         psums the count vector, and prints from process 0
                         only. NTSM_DISTRIBUTED=1 is equivalent.
"""


def run(argv) -> int:
    opts = Options()
    engine = "tpu"
    distributed = bool(os.environ.get("NTSM_DISTRIBUTED"))
    try:
        parsed, files = getopt.gnu_getopt(
            argv,
            "s:t:vhk:m:do:",
            [
                "threads=",
                "maxCov=",
                "output=",
                "dupes",
                "snp=",
                "kmer=",
                "help",
                "version",
                "verbose",
                "engine=",
                "checkpoint=",
                "checkpoint-every=",
                "trace=",
                "seglen=",
                "distributed",
            ],
        )
    except getopt.GetoptError as e:
        print(f"ntsm count: {e}", file=sys.stderr)
        print("Try '--help' for more information.", file=sys.stderr)
        return 1

    for flag, val in parsed:
        if flag in ("-h", "--help"):
            print(HELP, file=sys.stderr)
            return 0
        elif flag == "--version":
            from ntsm_tpu import __version__

            print(f"ntsm count (ntsm_tpu) {__version__}", file=sys.stderr)
            return 0
        elif flag in ("-t", "--threads"):
            opts = opts.replace(threads=int(val))
        elif flag in ("-m", "--maxCov"):
            opts = opts.replace(cov_thresh=float(val))
        elif flag in ("-o", "--output"):
            opts = opts.replace(summary=val)
        elif flag in ("-d", "--dupes"):
            opts = opts.replace(dupes=True)
        elif flag in ("-s", "--snp"):
            opts = opts.replace(snp=val)
        elif flag in ("-k", "--kmer"):
            opts = opts.replace(k=int(val))
        elif flag in ("-v", "--verbose"):
            opts = opts.replace(verbose=opts.verbose + 1)
        elif flag == "--engine":
            if val not in ("tpu", "golden"):
                print(f"ntsm count: unknown --engine {val!r} "
                      "(choices: tpu, golden)", file=sys.stderr)
                return 1
            engine = val
        elif flag == "--checkpoint":
            opts = opts.replace(checkpoint=val)
        elif flag == "--checkpoint-every":
            opts = opts.replace(checkpoint_every=int(val))
        elif flag == "--seglen":
            L = int(val)
            if L < 64 or L % 8:
                print("ntsm count: --seglen must be a multiple of 8, >= 64",
                      file=sys.stderr)
                return 1
            opts = opts.replace(
                segment_len=L,
                batch_reads=max(1, opts.batch_reads * 256 // L),
            )
        elif flag == "--trace":
            opts = opts.replace(trace=val)
        elif flag == "--distributed":
            distributed = True

    die = False
    if opts.k > 32:
        print("Error: k cannot be greater than 32", file=sys.stderr)
        die = True
    if not opts.snp:
        print("Error: Missing variants (-s) file", file=sys.stderr)
        die = True
    for f in files:
        if not os.path.exists(f):
            print(f"ntsm count: input file {f} does not exist", file=sys.stderr)
            die = True
    if not files:
        print("Error: Need input files", file=sys.stderr)
        die = True
    if die:
        print("Try '--help' for more information.", file=sys.stderr)
        return 1

    t0 = time.monotonic()
    from ntsm_tpu.count.engine import format_info_summary, run_count
    from ntsm_tpu.io.countfile import format_counts
    from ntsm_tpu.io.sites import load_site_table

    import contextlib

    shield = contextlib.nullcontext()
    my_files = files
    if distributed:
        from ntsm_tpu.parallel.distributed import (
            host_file_shard,
            init_distributed,
            stdout_shield,
        )

        try:
            init_distributed()
        except ValueError as e:
            print(e, file=sys.stderr)
            return 1
        import jax

        # gloo CPU collectives print their connection banner to stdout;
        # stdout is a byte-parity contract, so shield it for the whole
        # compute phase (local-mesh merges spin up gloo contexts too)
        shield = stdout_shield()
        my_files = host_file_shard(files)
        if opts.checkpoint:
            # per-process snapshots: each host checkpoints its own file
            # shard under a rank-tagged path (the shard's filenames are in
            # the snapshot signature, guarding same-world-size shard
            # mixups).  A resume with a DIFFERENT world size would never
            # match the rank-tagged names and silently recount from zero,
            # so scan for stale tags and error loudly instead.
            import glob as _glob

            tag = f".rank{jax.process_index()}of{jax.process_count()}"
            stale = [
                p
                for p in _glob.glob(f"{opts.checkpoint}.rank*of*")
                if not p.endswith(f"of{jax.process_count()}")
            ]
            if stale:
                print(
                    f"ntsm count: checkpoint {opts.checkpoint} has "
                    f"snapshots from a different world size "
                    f"({os.path.basename(stale[0])}); resume with the "
                    "original process count or delete them",
                    file=sys.stderr,
                )
                return 1
            opts = opts.replace(checkpoint=opts.checkpoint + tag)
        if opts.verbose:
            print(
                f"ntsm count: process {jax.process_index()}/"
                f"{jax.process_count()} counting {len(my_files)}/"
                f"{len(files)} files",
                file=sys.stderr,
            )

    with shield:
        if opts.verbose:
            print(f"Opening {opts.snp}", file=sys.stderr)
        table = load_site_table(opts.snp, opts.k, allow_dupes=opts.dupes)

        if engine == "golden":
            from ntsm_tpu.count.golden import count_files

            result = count_files(table, my_files, cov_thresh=opts.cov_thresh)
            if result.early_term:
                print("Reached desired (-m) threshold", file=sys.stderr)
        else:
            result = run_count(table, my_files, opts)

        if distributed:
            from ntsm_tpu.count.golden import max_counts_threshold
            from ntsm_tpu.parallel.distributed import merge_count_results

            local_early = result.early_term
            result = merge_count_results(
                result,
                max_counts_thresh=max_counts_threshold(
                    table.n_kmers, opts.cov_thresh
                ),
            )
            if result.early_term and not local_early:
                # the merged cohort crossed -m even though this host's
                # local count did not (per-host checks are local-only)
                print("Reached desired (-m) threshold", file=sys.stderr)

    if distributed:
        import jax

        if jax.process_index() != 0:
            return 0  # process 0 owns stdout/summary emission

    mx, sm = result.site_max_sum(table)
    sys.stdout.write(
        format_counts(table.site_ids, mx, sm, table.distinct, result.total_kmers, opts.k)
    )

    summary, warning = format_info_summary(table, result, opts)
    if opts.summary:
        with open(opts.summary, "w") as fh:
            fh.write(summary)
    if warning:
        print(warning, file=sys.stderr)
    print(summary, file=sys.stderr)
    rss_kb = _rss_kb()
    print(
        f"Time: {time.monotonic() - t0:g} s Memory: {rss_kb} kbytes", file=sys.stderr
    )
    return 0


def _rss_kb() -> int:
    """VmRSS in kB, like Util::getRSS (src/Util.h:32-49)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1
