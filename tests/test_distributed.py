"""Multi-host execution: a real 2-process x 4-CPU-device jax.distributed
cluster (subprocess-spawned, gloo collectives) counting a sharded file set
must match the golden single-process count exactly — the cross-host half
of SURVEY §2.3's distributed-backend row.

The reference has no distributed backend (single-process OpenMP,
src/FingerPrint.hpp:46-87); the semantic contract for the cross-host merge
is its count-file merge (CompareCounts::mergeCounts,
src/CompareCounts.hpp:626-674): counts and #@TK sum, distinct columns
carry over.
"""

import os
import socket
import subprocess
import sys

import pytest

from tests.synth import make_reads_fastq, make_site_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(pid: int, nproc: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        JAX_NUM_CPU_DEVICES="4",
        JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
        JAX_NUM_PROCESSES=str(nproc),
        JAX_PROCESS_ID=str(pid),
        NTSM_DISTRIBUTED="1",
        PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
    )
    return env


def _world(rng, tmp_path, n_files=4):
    sites_path = str(tmp_path / "sites.fa")
    _, sites = make_site_fasta(rng, n_sites=16, path=sites_path)
    paths = []
    for i in range(n_files):
        p = str(tmp_path / f"part{i}.fq")
        make_reads_fastq(
            rng, sites[i::n_files] or sites, coverage=5, genotype="het", path=p
        )
        paths.append(p)
    return sites_path, paths


def _golden_stdout(sites_path, paths):
    from ntsm_tpu.count.golden import count_files
    from ntsm_tpu.io.countfile import format_counts
    from ntsm_tpu.io.sites import load_site_table

    table = load_site_table(sites_path, 19, allow_dupes=False)
    g = count_files(table, paths)
    mx, sm = g.site_max_sum(table)
    return format_counts(
        table.site_ids, mx, sm, table.distinct, g.total_kmers, 19
    )


def _run_cluster(argv_tail, nproc, tmp_path, timeout=300, _retry=True):
    port = _free_port()
    procs = []
    for pid in range(nproc):
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "ntsm_tpu"] + argv_tail,
                env=_env(pid, nproc, port),
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                cwd=str(tmp_path),
            )
        )
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if _retry and any(rc != 0 for rc, _, _ in outs):
        # one retry with a fresh port: on this 1-core host the gloo
        # rendezvous can time out under full-suite load, and the
        # pre-probed port can be stolen between close() and bind()
        return _run_cluster(argv_tail, nproc, tmp_path, timeout, _retry=False)
    return outs


def test_two_process_count_matches_golden(rng, tmp_path):
    sites_path, paths = _world(rng, tmp_path)
    expect = _golden_stdout(sites_path, paths)

    outs = _run_cluster(["count", "-s", sites_path] + paths, 2, tmp_path)
    for rc, out, err in outs:
        assert rc == 0, err.decode()
    # process 0 emits the merged table; process 1 is silent on stdout
    assert outs[0][1].decode() == expect
    assert outs[1][1] == b""


def test_two_process_count_uneven_shards(rng, tmp_path):
    """3 files over 2 hosts: stride sharding gives host0 two files and
    host1 one; the merged result must still equal golden over all 3."""
    sites_path, paths = _world(rng, tmp_path, n_files=3)
    expect = _golden_stdout(sites_path, paths)

    outs = _run_cluster(["count", "-s", sites_path] + paths, 2, tmp_path)
    for rc, out, err in outs:
        assert rc == 0, err.decode()
    assert outs[0][1].decode() == expect


def test_two_process_eval_matches_single(rng, tmp_path):
    """2-process global-mesh eval (-a, device engine): process 0's table
    must be byte-identical to the single-process 8-device mesh output —
    the same shard_map with the same D=8 row split, so even the f32
    compensated sums agree exactly."""
    import io
    import pathlib

    from ntsm_tpu.eval.model import load_count_data
    from ntsm_tpu.eval.tpu import compute_score_all_tpu
    from ntsm_tpu.options import Options

    fix = pathlib.Path(__file__).parent / "fixtures"
    paths = [
        str(fix / f"sample{s}_counts.txt") for s in ("A", "A2", "B", "C")
    ]
    opts = Options(all=True, engine="tpu")
    data = load_count_data(paths, opts)
    buf = io.StringIO()
    compute_score_all_tpu(data, opts, buf)
    expect = buf.getvalue()

    outs = _run_cluster(
        ["eval", "-a", "--engine", "tpu"] + paths, 2, tmp_path
    )
    for rc, out, err in outs:
        assert rc == 0, err.decode()
    got = outs[0][1].decode()
    # strip the Performing-all-to-all banner goes to stderr; stdout is
    # the table only
    assert got == expect
    assert outs[1][1] == b""


def test_host_file_shard_partition():
    """Stride partition covers every file exactly once across processes."""
    from ntsm_tpu.parallel.distributed import host_file_shard

    paths = [f"f{i}" for i in range(7)]
    shards = [host_file_shard(paths, process_id=p, num=3) for p in range(3)]
    flat = sorted(x for s in shards for x in s)
    assert flat == sorted(paths)
    assert shards[0] == ["f0", "f3", "f6"]


def test_merge_count_results_single_process_identity():
    from ntsm_tpu.count.golden import CountResult
    from ntsm_tpu.parallel.distributed import merge_count_results

    import numpy as np

    r = CountResult(
        counts=np.arange(5, dtype=np.int64),
        total_kmers=10,
        total_hits=4,
        total_bases=100,
        total_reads=2,
        early_term=False,
    )
    assert merge_count_results(r) is r


def test_four_process_count_matches_golden(rng, tmp_path):
    """4-process cluster (the multi-host claim beyond pairwise): stride
    sharding over 4 processes x 4 CPU devices, merged output byte-identical
    to the single-process golden count."""
    sites_path, paths = _world(rng, tmp_path, n_files=6)
    expect = _golden_stdout(sites_path, paths)

    outs = _run_cluster(["count", "-s", sites_path] + paths, 4, tmp_path)
    for rc, out, err in outs:
        assert rc == 0, err.decode()
    assert outs[0][1].decode() == expect
    for rc, out, err in outs[1:]:
        assert out == b""


def test_distributed_checkpoint_rank_tagged_and_resumable(rng, tmp_path):
    """--checkpoint under --distributed: each process snapshots its own
    file shard under a rank-tagged path; a re-run against the completed
    snapshots resumes (skipping counted batches) and emits byte-identical
    output."""
    sites_path, paths = _world(rng, tmp_path, n_files=4)
    expect = _golden_stdout(sites_path, paths)
    ck = str(tmp_path / "snap.npz")

    argv = [
        "count", "--checkpoint", ck, "--checkpoint-every", "1",
        "-s", sites_path,
    ] + paths
    outs = _run_cluster(argv, 2, tmp_path)
    for rc, out, err in outs:
        assert rc == 0, err.decode()
    assert outs[0][1].decode() == expect
    assert os.path.exists(ck + ".rank0of2")
    assert os.path.exists(ck + ".rank1of2")
    assert not os.path.exists(ck)

    # resume: snapshots cover the whole run; output identical
    outs2 = _run_cluster(argv, 2, tmp_path)
    for rc, out, err in outs2:
        assert rc == 0, err.decode()
    assert outs2[0][1].decode() == expect
    assert b"Resuming from checkpoint" in outs2[0][2]


def test_distributed_early_term_rechecked_on_merged_totals(rng, tmp_path):
    """-m threshold between the largest per-host hit count and the global
    total: no host terminates early locally, but the merged result must
    report the threshold as reached (global granularity recheck in
    merge_count_results)."""
    from ntsm_tpu.count.golden import count_files
    from ntsm_tpu.io.sites import load_site_table
    from ntsm_tpu.parallel.distributed import host_file_shard

    sites_path, paths = _world(rng, tmp_path, n_files=4)
    table = load_site_table(sites_path, 19, allow_dupes=False)
    shard_hits = [
        count_files(table, host_file_shard(paths, process_id=p, num=2)).total_hits
        for p in range(2)
    ]
    total = sum(shard_hits)
    thr = (max(shard_hits) + total) / 2.0
    assert max(shard_hits) < thr < total
    m = 2.0 * thr / table.n_kmers  # max_counts = n_kmers*m/2 == thr

    outs = _run_cluster(
        ["count", "-m", f"{m:.9f}", "-s", sites_path] + paths, 2, tmp_path
    )
    for rc, out, err in outs:
        assert rc == 0, err.decode()
    assert b"Reached desired (-m) threshold" in outs[0][2]


def test_distributed_checkpoint_world_size_mismatch_errors(rng, tmp_path):
    """Resuming with a different process count must error loudly: the
    rank-tagged snapshot names would never match and the run would
    silently recount from zero (self-review r3 finding)."""
    sites_path, paths = _world(rng, tmp_path, n_files=4)
    ck = str(tmp_path / "snap.npz")
    # stale snapshot from a previous 4-process world
    with open(ck + ".rank0of4", "wb") as fh:
        fh.write(b"stale")

    argv = [
        "count", "--checkpoint", ck, "--checkpoint-every", "1",
        "-s", sites_path,
    ] + paths
    outs = _run_cluster(argv, 2, tmp_path)
    assert all(rc != 0 for rc, _, _ in outs), outs[0][2].decode()
    assert b"different world size" in outs[0][2]
