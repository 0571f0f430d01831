"""Device time of two XLA stages on the GPU, each beside what contains it.

1. count: the window-hash stage (kernel_v2.window_hashes_packed) in the
   counting step (kernel_v3.count_step_v3) at B=32768, L=256, k=19 against
   a 96,287-site table of ~2.5M k-mers: the step, the probe alone (hashes
   precomputed), the hash stage alone, and the hash stage's marginal share
   of the step (step - probe alone).
2. eval: the fractional joint pass (kernels._joint_tiles) on one rect of
   the -a engine (ROWS x COLS pairs at 96,512 padded sites) beside the
   whole rect kernel (rect._rect_block_stats): its share of a rect.

Times are medians of block_until_ready'd calls after warm-up; each stage
is also set against its bound (bytes over 3.35 TB/s, or f32 operations
over 67 TFLOP/s — an H100 SXM's published peaks).  A jax.profiler trace
of a few calls of each is reduced to its top device kernels.  Prints JSON
lines naming the device; writes the kernel tables to
chiprun_out/profile_kernels.txt.  Refuses to run without a GPU.

    python scripts/profile_kernels.py [count] [eval]
"""

from __future__ import annotations

import functools
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM data sheet, f32 outside the tensor cores


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return res.stdout.strip().splitlines()[0]


def timed(fn, *args, reps: int = 20) -> float:
    """Median seconds of fn(*args), each call ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def top_kernels(trace_dir: str, n: int = 12) -> list[tuple[str, float, int]]:
    """(kernel name, total device ms, calls) from the trace's GPU planes."""
    from jax.profiler import ProfileData

    tot: dict = {}
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True):
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                for ev in line.events:
                    ms, c = tot.get(ev.name, (0.0, 0))
                    tot[ev.name] = (ms + ev.duration_ns / 1e6, c + 1)
    rows = sorted(((k, v[0], v[1]) for k, v in tot.items()),
                  key=lambda r: -r[1])
    return rows[:n]


def trace_top(fn, args, calls: int = 5):
    import jax

    d = tempfile.mkdtemp(prefix="ntsm_trace_")
    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(d):
        for _ in range(calls):
            jax.block_until_ready(fn(*args))
    return top_kernels(d)


def count_stage(dev: dict, out) -> None:
    import jax
    import jax.numpy as jnp

    from ntsm_tpu.count.kernel_v2 import pack_batch, window_hashes_packed
    from ntsm_tpu.count.kernel_v3 import TableV3, count_step_v3, probe_and_count

    rng = np.random.default_rng(7)
    k, B, L = 19, 32768, 256
    hashes = np.unique(rng.integers(0, (1 << 2 * k) - 1, size=96287 * 26,
                                    dtype=np.uint64))
    tab = TableV3.from_hashes_device(hashes)
    kw = dict(n_buckets=tab.n_buckets, slots=tab.slots, bbits=tab.bbits)
    packed, vbits = (jnp.asarray(x) for x in
                     pack_batch(rng.integers(0, 4, size=(B, L), dtype=np.uint8)))
    counts = jnp.zeros(hashes.shape[0] + 1, jnp.int32)
    planes = (tab.fp, tab.keys, tab.vals)

    step = functools.partial(count_step_v3, k=k, L=L, **kw)
    hash_only = jax.jit(functools.partial(window_hashes_packed, k=k, L=L))
    probe_only = jax.jit(functools.partial(probe_and_count, **kw))
    h, valid = hash_only(packed, vbits)

    t_step = timed(step, packed, vbits, *planes, counts)
    t_hash = timed(hash_only, packed, vbits)
    t_probe = timed(probe_only, h, valid, *planes, counts)
    W = L - k + 1
    hash_bytes = packed.nbytes + vbits.nbytes + B * W * (8 + 1)
    rec = dict(
        stage="count_hash", device=dev, B=B, L=L, k=k, n_kmers=int(hashes.shape[0]),
        step_ms=t_step * 1e3, probe_only_ms=t_probe * 1e3,
        hash_alone_ms=t_hash * 1e3,
        hash_marginal_ms=(t_step - t_probe) * 1e3,
        hash_marginal_share=(t_step - t_probe) / t_step,
        hash_alone_share=t_hash / t_step,
        hash_alone_bound_ms=hash_bytes / HBM_BYTES_PER_S * 1e3,
    )
    print(json.dumps(rec), flush=True)
    out.write(json.dumps(rec) + "\ncount_step_v3 top device kernels:\n")
    for name, ms, c in trace_top(step, (packed, vbits, *planes, counts)):
        out.write(f"  {ms:10.3f} ms {c:5d} calls  {name}\n")


def eval_stage(dev: dict, out) -> None:
    import jax
    import jax.numpy as jnp

    from ntsm_tpu.eval.kernels import CHUNK, _joint_tiles
    from ntsm_tpu.eval.rect import COLS, ROWS, _rect_block_stats

    rng = np.random.default_rng(9)
    n_sites = 96287
    Lp = n_sites + (-n_sites) % CHUNK
    C = Lp // CHUNK

    def plane(rows):
        x = rng.poisson(15, size=(rows, Lp)).astype(np.uint8)
        x[:, n_sites:] = 0
        return jnp.asarray(x)

    ra, rb, ca, cb = plane(COLS), plane(COLS), plane(COLS), plane(COLS)
    rect = functools.partial(_rect_block_stats, mc=1.0, chunk=CHUNK,
                             n_valid=n_sites, narrow=True)

    def chunked(x, rows):
        return jnp.swapaxes(x[:rows].astype(jnp.float32).reshape(rows, C, CHUNK),
                            0, 1)

    v = jnp.ones((COLS, Lp), jnp.float32)
    j_args = (chunked(ra, ROWS), chunked(rb, ROWS), chunked(v, ROWS),
              chunked(ca, COLS), chunked(cb, COLS), chunked(v, COLS),
              jnp.float32(1.0))
    joint = jax.jit(_joint_tiles)
    t_rect = timed(rect, ra, rb, 0, ca, cb)
    t_joint = timed(joint, *j_args)
    flops = 15.0 * ROWS * COLS * Lp
    rec = dict(
        stage="eval_joint_tiles", device=dev, rows=ROWS, cols=COLS, Lp=Lp,
        rect_ms=t_rect * 1e3, joint_tiles_ms=t_joint * 1e3,
        joint_share_of_rect=t_joint / t_rect,
        joint_f32_bound_ms=flops / F32_FLOPS * 1e3,
    )
    print(json.dumps(rec), flush=True)
    out.write(json.dumps(rec) + "\n_rect_block_stats top device kernels:\n")
    for name, ms, c in trace_top(rect, (ra, rb, 0, ca, cb)):
        out.write(f"  {ms:10.3f} ms {c:5d} calls  {name}\n")


def main() -> int:
    import jax

    only = sys.argv[1:]  # stage names to run (default: all)

    d = jax.devices()[0]
    if d.platform != "gpu":
        print(f"profile_kernels: needs a GPU, JAX runs on {d.platform}",
              file=sys.stderr)
        return 1
    dev = dict(platform=d.platform, kind=d.device_kind,
               count=len(jax.devices()), card=card())
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_kernels.txt"), "w") as out:
        if not only or "count" in only:
            count_stage(dev, out)
        if not only or "eval" in only:
            eval_stage(dev, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
