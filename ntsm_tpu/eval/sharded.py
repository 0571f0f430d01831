"""Mesh-sharded all-vs-all statistics: sample rows sharded over a 1-D
data mesh, each device scoring its row block against the all_gather'ed
planes (SURVEY §5's layout: 0.2-0.4 MB/sample on the wire).

Split out of eval/tpu.py (round 4)."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ntsm_tpu.eval import blob as _blob
from ntsm_tpu.eval.blob import _pack_triangle
from ntsm_tpu.eval.kernels import (
    CHUNK,
    _chunked_matmul_f64,
    _genotype_planes,
    _joint_int_matmuls,
    _joint_tiles,
    _tally_matmuls,
)


def _make_sharded_stats(mesh, *, min_cov: float, chunk: int, n_valid=None):
    """Sample-row-sharded pairwise statistics over a 1-D data mesh.

    Each device holds an [N/D, Lp] row block of the count planes,
    all_gathers the full planes (0.4 MB/sample - SURVEY §5's layout), and
    computes its row block of every [N, N] statistic: indicator-tally
    matmuls, the s1 plane sums, and the joint likelihood pass.  Outputs are
    row-sharded [N, N] arrays; no other collectives.
    """
    import functools as _ft

    from ntsm_tpu.parallel.mesh import P, shard_map

    mc = jnp.float32(min_cov)

    @_ft.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=(
            dict(
                n=P("data"),
                shared_hets=P("data"),
                shared_homs=P("data"),
                ibs0=P("data"),
                hets1=P("data"),
                homs1=P("data"),
            ),
            (P("data"),) * 4,
            (P("data"),) * 4,
        ),
        check_vma=False,
    )
    def stats(a_l, b_l):
        # gather the (possibly u16) wire shards — half the collective bytes —
        # and widen to f32 after the collective
        a = jax.lax.all_gather(a_l, "data", axis=0, tiled=True).astype(
            jnp.float32
        )
        b = jax.lax.all_gather(b_l, "data", axis=0, tiled=True).astype(
            jnp.float32
        )
        a_l = a_l.astype(jnp.float32)
        b_l = b_l.astype(jnp.float32)

        het_l, hat_l, hcg_l, val_l, sint_l, sfrac_l = _genotype_planes(
            a_l, b_l, mc, n_valid
        )
        het, hat, hcg, vall, _, _ = _genotype_planes(a, b, mc, n_valid)
        tallies = _tally_matmuls(het_l, hat_l, hcg_l, val_l, het, hat, hcg, vall)

        nl, Lp = a_l.shape
        C = Lp // chunk
        cl = (nl, C, chunk)
        cf = (a.shape[0], C, chunk)
        v_c = vall.reshape(cf)
        si = _chunked_matmul_f64(sint_l.reshape(cl), v_c)
        sf = _chunked_matmul_f64(sfrac_l.reshape(cl), v_c)

        # joint pass: this device's rows against everyone — the exact
        # integer part as matmuls, the fraction elementwise
        ji = _joint_int_matmuls(
            a_l, b_l, val_l, a, b, vall, float(min_cov), chunk
        )
        jf = _joint_tiles(
            jnp.swapaxes(a_l.reshape(cl), 0, 1),
            jnp.swapaxes(b_l.reshape(cl), 0, 1),
            jnp.swapaxes(val_l.reshape(cl), 0, 1),
            jnp.swapaxes(a.reshape(cf), 0, 1),
            jnp.swapaxes(b.reshape(cf), 0, 1),
            jnp.swapaxes(v_c, 0, 1),
            mc,
        )
        return tallies, (si[0], si[1], sf[0], sf[1]), (ji[0], ji[1], jf[0], jf[1])

    return jax.jit(stats)


def _mesh_stat_planes(data, opts, mesh):
    """Row-sharded pairwise stat planes over the mesh: (tallies dict,
    s1 4-tuple, joint 4-tuple) of [Npad, N] device arrays.  On multi-host
    meshes each process feeds only its local row slice (assembled into
    one global array) and the in-kernel all_gather spans hosts;
    outputs stay row-sharded — run them through _replicate_tree
    before fetching."""
    from ntsm_tpu.eval.wire import _wire_planes

    N = data.n_samples
    a_np, b_np = _wire_planes(data)
    D = mesh.devices.size
    pad_n = (-N) % D
    if pad_n:  # zero-count pad rows produce n=0 pairs, sliced off later
        a_np = np.pad(a_np, ((0, pad_n), (0, 0)))
        b_np = np.pad(b_np, ((0, pad_n), (0, 0)))
    stats_fn = _make_sharded_stats(
        mesh, min_cov=float(opts.min_cov), chunk=CHUNK,
        n_valid=data.n_sites,
    )
    if jax.process_count() > 1 and mesh.devices.size > jax.local_device_count():
        from jax.sharding import NamedSharding

        from ntsm_tpu.parallel.mesh import P

        row_sh = NamedSharding(mesh, P("data", None))
        Npad = a_np.shape[0]
        rows_per = Npad // D
        # local slice: the rows owned by this process's devices (the
        # mesh is jax.devices() order, process-major)
        local_ids = {d.id for d in jax.local_devices()}
        mine = [i for i, d in enumerate(mesh.devices.flat) if d.id in local_ids]
        r_lo, r_hi = mine[0] * rows_per, (mine[-1] + 1) * rows_per
        a_g = jax.make_array_from_process_local_data(
            row_sh, a_np[r_lo:r_hi], a_np.shape
        )
        b_g = jax.make_array_from_process_local_data(
            row_sh, b_np[r_lo:r_hi], b_np.shape
        )
        tallies_d, s1_d, joint_d = stats_fn(a_g, b_g)
    else:
        tallies_d, s1_d, joint_d = stats_fn(
            jnp.asarray(a_np), jnp.asarray(b_np)
        )
    return tallies_d, s1_d, joint_d


def _replicate_tree(mesh, tree):
    """Reshard a tree of mesh outputs to replicated so every process can
    fetch them; no-op on single-process meshes (np.asarray can already
    assemble a row-sharded array there)."""
    if jax.process_count() > 1 and mesh.devices.size > jax.local_device_count():
        from jax.sharding import NamedSharding

        from ntsm_tpu.parallel.mesh import P

        rep = NamedSharding(mesh, P())
        return jax.jit(
            lambda t: t,
            out_shardings=jax.tree_util.tree_map(lambda _: rep, tree),
        )(tree)
    return tree


def _pack_mesh_blob(tallies_d, s1_d, joint_d, N: int, n_sites: int):
    """The packed-triangle blob from mesh stat planes: the same (ll, ints,
    hi) wire as the single-device path, built under one jit over the
    sharded [Npad, N] planes (XLA inserts the gathers/collectives) — the
    fetch drops from fourteen [N, N] f32 planes (~574 MB at N=3202) to
    ~19 B/pair (~97 MB).  Tier bound: n_sites (pads are n_valid-
    masked)."""
    narrow = n_sites <= _blob.NARROW_WIRE_MAX_SITES

    @jax.jit
    def pack(t, s, j):
        sl = lambda x: x[:N, :N]  # noqa: E731
        return _pack_triangle(
            {k: sl(v) for k, v in t.items()},
            tuple(sl(x) for x in s),
            (sl(j[0]), sl(j[1])),
            sl(j[2]),
            sl(j[3]),
            narrow=narrow,
        )

    return pack(tallies_d, s1_d, joint_d)
