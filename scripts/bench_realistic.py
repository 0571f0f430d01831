"""Realistic end-to-end count benchmark: 150 bp reads, human-scale table.

Measures `run_count_v3` wall time (host read+pack+feed + device pipeline)
on an N-Mbase synthetic 150bp FASTQ against a 96287-site / 2.5M-k-mer
table, dense row packing on vs off.

Usage: python scripts/bench_realistic.py [mbases] [readlen] [seglen]

seglen (default 256) sets the device row length: longer rows amortize
the k-1 halo + separator packing overhead (0.273 B/base at 256 for
150 bp reads; ~0.26 at 512) against the same windows/step shape when
batch_reads is scaled inversely.  Prints the device first; refuses to run
without a GPU.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    mbases = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    readlen = int(sys.argv[2]) if len(sys.argv) > 2 else 150
    seglen = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    batch = 32768 * 256 // seglen  # keep bases/step (and cand_k) fixed
    n_reads = mbases * 1_000_000 // readlen
    rng = np.random.default_rng(7)

    from gpu_check import require_gpu

    print(f"# device: {require_gpu('bench_realistic')}", flush=True)
    d = tempfile.mkdtemp(prefix="ntsm_realbench_")
    fq = os.path.join(d, "reads.fq")
    alpha = np.array([65, 67, 71, 84], dtype=np.uint8)
    t0 = time.perf_counter()
    with open(fq, "wb") as fh:
        for c0 in range(0, n_reads, 50000):
            r = alpha[rng.integers(0, 4, size=(min(50000, n_reads - c0),
                                               readlen))]
            fh.write(b"".join(
                b"@r%d\n" % (c0 + i) + r[i].tobytes() + b"\n+\n"
                + b"I" * readlen + b"\n" for i in range(r.shape[0])))
    print(f"# wrote {mbases} Mbase ({n_reads} reads) in {time.perf_counter()-t0:.0f}s",
          file=sys.stderr)

    from ntsm_tpu.count.engine import EngineConfig, run_count_v3
    from ntsm_tpu.io.sites import SiteTable
    from ntsm_tpu.options import Options

    # synthetic human-scale site table (bypasses the FASTA parse)
    mask38 = (1 << 38) - 1
    hashes = np.unique(
        rng.integers(0, mask38, size=96287 * 26, dtype=np.uint64)
    )
    n = hashes.shape[0]
    table = SiteTable(
        site_ids=[f"rs{i}" for i in range(96287)],
        kmer_hashes=hashes,
        kmer_site=np.repeat(np.arange(96287), 26)[:n].astype(np.int32),
        kmer_allele=np.tile(np.arange(26) % 2, 96287)[:n].astype(np.uint8),
        distinct=np.full((96287, 2), 13, dtype=np.int64),
        k=19,
    )

    verbose = 2 if os.environ.get("NTSM_BENCH_VERBOSE") else 0

    # Warmup: the FIRST engine run in a process pays one-time costs —
    # the 20 MB hash upload + device table build (TableV3.from_hashes_device)
    # and the executable compile/load, which whichever mode ran first would
    # absorb.  Run a tiny throwaway count first so both timed runs measure
    # the steady-state pipeline.
    warm = os.path.join(d, "warm.fq")
    with open(warm, "wb") as fh:
        r = alpha[rng.integers(0, 4, size=(64, readlen))]
        fh.write(
            b"".join(
                b"@w%d\n" % i + r[i].tobytes() + b"\n+\n" + b"I" * readlen + b"\n"
                for i in range(64)
            )
        )
    t0 = time.perf_counter()
    run_count_v3(table, [warm], Options(),
                 EngineConfig(batch_reads=batch, segment_len=seglen))
    print(f"# warmup (table upload + exec load): {time.perf_counter()-t0:.0f}s",
          file=sys.stderr)

    modes = (True,) if os.environ.get("NTSM_BENCH_DENSE_ONLY") else (
        False, True)
    for dense in modes:
        cfg = EngineConfig(dense=dense, batch_reads=batch,
                           segment_len=seglen)
        t0 = time.perf_counter()
        res = run_count_v3(table, [fq], Options(verbose=verbose), cfg)
        dt = time.perf_counter() - t0
        bpb = res.wire_bytes / max(res.total_bases, 1)
        print(
            f"dense={dense} L={seglen}: {dt:6.1f} s -> "
            f"{res.total_bases/dt/1e6:7.1f} Mbase/s "
            f"(tk={res.total_kmers}, wire {bpb:.3f} B/base)"
        )


if __name__ == "__main__":
    main()
