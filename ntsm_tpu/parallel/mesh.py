"""Multi-chip sharding for counting and evaluation.

The reference's only parallelism is single-node OpenMP (thread-per-file
fan-out with atomic counter updates, src/FingerPrint.hpp:46-103).  Here
the layout is a 1-D data mesh over the local devices:

* counting: read batches are sharded over the mesh ("data parallelism");
  every device owns a private count vector (no atomics), and the single
  merge is one psum at the end of the run — counting needs zero steady-state
  communication.
* evaluation: the sample axis is sharded; each device computes the tally /
  score block for its sample rows against the all_gather'ed planes of all
  samples (the [samples, sites] planes are ~0.4 MB/sample, so the
  collective traffic is trivial next to the O(N² sites) compute).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ntsm_tpu.count.kernel import count_step_impl


_USE_DEFAULT = object()  # "caller did not specify" sentinel (None is meaningful)


def data_mesh(devices=None) -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), ("data",))


def make_sharded_count_step(mesh: Mesh, k: int, n_kmers: int):
    """Data-parallel counting step over the mesh.

    codes/lengths are sharded on the batch axis; the lookup table is
    replicated; per-device count vectors are carried as a [D, n_kmers+1]
    array sharded on its leading axis (so no collective per step).
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P(), P(), P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data")),
        check_vma=False,
    )
    def step(codes, lengths, keys, vals, counts, total_kmers, total_hits):
        c, tk, th = count_step_impl(
            codes,
            lengths,
            keys,
            vals,
            counts[0],
            total_kmers[0],
            total_hits[0],
            k=k,
            n_kmers=n_kmers,
        )
        return c[None], tk[None], th[None]

    return jax.jit(step, donate_argnums=(4, 5, 6))


def make_sharded_count_step_v3(
    mesh: Mesh,
    *,
    k: int,
    L: int,
    n_buckets: int,
    slots: int,
    bbits: int,
    cand_k: int | None = None,
    seg_c=_USE_DEFAULT,  # int, None (flat compaction), or kernel_v3.SEG_C
    seg_k1: int | None = None,
):
    """Data-parallel v3 counting step (fingerprint probe, device-resident
    counts) over the mesh.

    packed/vbits are sharded on the batch axis; the fingerprint/key/value
    planes are replicated; count state is [D, n_kmers+1] sharded on its
    leading axis and diag is [D, 3] (per-device, so a shard that overflows
    cand_k can be recounted host-side from just its row slice).  Zero
    steady-state collectives — the one merge is `merge_counts_across_devices`
    at the end of the run.
    """
    from ntsm_tpu.count.kernel_v2 import window_hashes_packed
    from ntsm_tpu.count.kernel_v3 import (
        CAND_K,
        SEG_C,
        SEG_K1,
        probe_and_count,
    )

    if seg_c is _USE_DEFAULT:
        seg_c = SEG_C
    if seg_k1 is None:
        seg_k1 = SEG_K1

    ck = CAND_K if cand_k is None else cand_k

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P(), P(), P(), P("data")),
        out_specs=(P("data"), P("data")),
        check_vma=False,
    )
    def step(packed, vbits, fp_t, keys_t, vals_t, counts):
        h, valid = window_hashes_packed(packed, vbits, k, L)
        c, diag = probe_and_count(
            h,
            valid,
            fp_t,
            keys_t,
            vals_t,
            counts[0],
            n_buckets=n_buckets,
            slots=slots,
            bbits=bbits,
            cand_k=ck,
            seg_c=seg_c,
            seg_k1=seg_k1,
        )
        return c[None], diag[None]

    return jax.jit(step, donate_argnums=(5,))


@functools.partial(jax.jit, static_argnames=())
def merge_counts_across_devices(counts_dk):
    """Final count merge: one reduction of the [D, n_kmers+1] state — the
    device-side equivalent of the reference's per-update `omp atomic`."""
    return counts_dk.sum(axis=0)


def make_sharded_tally(mesh: Mesh):
    """Sample-sharded indicator tally: rows local, columns all_gather'ed."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data", None), P("data", None)),
        out_specs=P("data", None),
    )
    def tally(rows_local, cols_local):
        cols = jax.lax.all_gather(cols_local, "data", axis=0, tiled=True)
        # 0/1 planes: exact at default precision (TF32 keeps 0 and 1)
        return jnp.dot(rows_local, cols.T, preferred_element_type=jnp.float32)

    return jax.jit(tally)
