"""Sweep engine pipeline knobs (upload queue depth x drain window) on the
real device: dense 150bp counting, human-scale table.

Usage: python scripts/sweep_pipeline.py [mbase] [reps]
Writes the device, one line per (depth, window, rep) and a ranked
summary.  Refuses to run without a GPU.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    mbases = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    from gpu_check import require_gpu

    print(f"# device: {require_gpu('sweep_pipeline')}", flush=True)
    readlen = 150
    n_reads = mbases * 1_000_000 // readlen
    rng = np.random.default_rng(7)

    d = tempfile.mkdtemp(prefix="ntsm_sweep_")
    fq = os.path.join(d, "reads.fq")
    alpha = np.array([65, 67, 71, 84], dtype=np.uint8)
    with open(fq, "wb") as fh:
        qual = b"I" * readlen
        chunk = 50000
        for c0 in range(0, n_reads, chunk):
            nn = min(chunk, n_reads - c0)
            reads = alpha[rng.integers(0, 4, size=(nn, readlen))]
            fh.write(
                b"".join(
                    b"@r%d\n" % (c0 + i) + reads[i].tobytes() + b"\n+\n" + qual + b"\n"
                    for i in range(nn)
                )
            )

    from ntsm_tpu.count.engine import EngineConfig, run_count_v3
    from ntsm_tpu.io.sites import SiteTable
    from ntsm_tpu.options import Options

    mask38 = (1 << 38) - 1
    hashes = np.unique(rng.integers(0, mask38, size=96287 * 26, dtype=np.uint64))
    n = hashes.shape[0]
    table = SiteTable(
        site_ids=[f"rs{i}" for i in range(96287)],
        kmer_hashes=hashes,
        kmer_site=np.repeat(np.arange(96287), 26)[:n].astype(np.int32),
        kmer_allele=np.tile(np.arange(26) % 2, 96287)[:n].astype(np.uint8),
        distinct=np.full((96287, 2), 13, dtype=np.int64),
        k=19,
    )

    # warm: one run to absorb compile/caches
    run_count_v3(table, [fq], Options(), EngineConfig(dense=True))

    combos = [(3, 8), (2, 4), (4, 4), (2, 8), (4, 8), (3, 16), (2, 2)]
    results = {}
    for depth, window in combos:
        best = 0.0
        for r in range(reps):
            cfg = EngineConfig(
                dense=True, upload_depth=depth, early_term_check_every=window
            )
            t0 = time.perf_counter()
            res = run_count_v3(table, [fq], Options(), cfg)
            dt = time.perf_counter() - t0
            rate = res.total_bases / dt / 1e6
            best = max(best, rate)
            print(f"depth={depth} window={window} rep={r}: {rate:7.1f} Mbase/s",
                  flush=True)
        results[(depth, window)] = best
    print("\n== ranked (best of reps) ==")
    for (depth, window), rate in sorted(results.items(), key=lambda kv: -kv[1]):
        print(f"depth={depth} window={window}: {rate:7.1f} Mbase/s")


if __name__ == "__main__":
    main()
