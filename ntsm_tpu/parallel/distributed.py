"""Multi-host initialization.

The reference is single-process OpenMP (SURVEY §2.3); scaling this
framework across hosts is standard JAX multi-controller: every host runs
the same program, `jax.distributed.initialize()` wires the processes, and
the 1-D data mesh in mesh.py then spans all devices — counting stays
collective-free in steady state (per-device count vectors) with one merge
at the end.

Input sharding across hosts follows the file axis: each host passes its
own shard of the FASTQ list to the counting engine (the count-file merge
contract, eval/merge.py, combines per-host results exactly), or for a
single huge file, hosts use `ParallelFileReader`-style striding by batch
index.

On a single host this module is a no-op; nothing here is required for
single-process runs.
"""

from __future__ import annotations

import os


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  All
    three are required: nothing on a GPU host configures a cluster by
    itself, so a missing one is an error rather than a silent
    single-process run.  Returns True once multi-process mode is
    initialized."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    missing = [
        name
        for name, v in (
            ("JAX_COORDINATOR_ADDRESS", coordinator_address),
            ("JAX_NUM_PROCESSES", num_processes),
            ("JAX_PROCESS_ID", process_id),
        )
        if v is None
    ]
    if missing:
        raise ValueError(
            "ntsm --distributed needs JAX_COORDINATOR_ADDRESS (host:port), "
            "JAX_NUM_PROCESSES and JAX_PROCESS_ID; missing: "
            + ", ".join(missing)
        )
    try:
        # CPU cross-process collectives need gloo (no-op once a backend
        # exists; GPUs use NCCL) — this is what lets the 2-process
        # CPU-mesh tests exercise the same code path as several hosts
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def host_file_shard(paths, process_id: int | None = None, num: int | None = None):
    """This host's shard of the input file list (stride partition)."""
    import jax

    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num is None else num
    return list(paths)[pid::n]


import contextlib


@contextlib.contextmanager
def stdout_shield():
    """Route OS-level stdout to stderr for the duration.

    The gloo CPU-collective backend prints its connection banner to
    stdout; our stdout is a byte-parity output contract (counts.txt /
    summary.tsv), so collective setup noise must go to stderr like every
    other diagnostic."""
    import sys

    sys.stdout.flush()
    saved = os.dup(1)
    try:
        os.dup2(2, 1)
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def allreduce_sum(x_np):
    """Sum a host-local numpy array across all processes; every process
    returns the global total.

    One collective over the global device mesh: the host partial rides its first local device as row 0
    of a [local_devices, ...] block (other rows zero), and a global
    axis-0 sum over the process-spanning array is exactly the cross-host
    reduction.  Single-process: identity.
    """
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if jax.process_count() == 1:
        return x_np
    x_np = np.asarray(x_np)
    mesh = Mesh(np.array(jax.devices()), ("data",))
    n_local = jax.local_device_count()
    local = np.zeros((n_local,) + x_np.shape, x_np.dtype)
    local[0] = x_np
    spec = P("data") if x_np.ndim == 0 else P("data", *([None] * x_np.ndim))
    with stdout_shield():
        garr = jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), local
        )
        out = jax.jit(
            lambda a: a.sum(axis=0),
            out_shardings=NamedSharding(mesh, P()),
        )(garr)
        res = np.asarray(out)
    return res


def merge_count_results(result, max_counts_thresh: float | None = None):
    """Combine per-host CountResults into the global one (counts psum'd,
    totals summed, early-term OR'd) — the cross-host half of the count
    merge; the intra-host half is mesh.merge_counts_across_devices.

    `max_counts_thresh` is the -m early-termination threshold
    (max_counts_threshold(n_kmers, cov_thresh), FingerPrint.hpp:41-43):
    each host only compares it against its LOCAL hit count during the
    run, so a cohort whose merged total crosses the threshold with no
    single host crossing it would otherwise report early_term=False;
    the merged total is rechecked here so the -m verdict has global
    granularity.  (Hosts still *count* to their local threshold — the
    distributed -m run reads up to num_hosts× the single-host bases, a
    documented cost of collective-free steady state.)

    Replaces nothing in the reference (it is single-process,
    SURVEY §2.3); semantically equal to merging per-host count files via
    `ntsm eval --only_merge` (CompareCounts::mergeCounts,
    src/CompareCounts.hpp:626-674).
    """
    import math

    import jax
    import numpy as np

    from ntsm_tpu.count.golden import CountResult

    if jax.process_count() == 1:
        return result
    packed = np.concatenate(
        [
            result.counts.astype(np.int64),
            np.array(
                [
                    result.total_kmers,
                    result.total_hits,
                    result.total_bases,
                    result.total_reads,
                    1 if result.early_term else 0,
                ],
                dtype=np.int64,
            ),
        ]
    )
    total = allreduce_sum(packed)
    early = bool(total[-1] > 0)
    if (
        max_counts_thresh is not None
        and max_counts_thresh != 0
        and not math.isinf(max_counts_thresh)
    ):
        early = early or int(total[-4]) > max_counts_thresh
    return CountResult(
        counts=total[:-5],
        total_kmers=int(total[-5]),
        total_hits=int(total[-4]),
        total_bases=int(total[-3]),
        total_reads=int(total[-2]),
        early_term=early,
    )
