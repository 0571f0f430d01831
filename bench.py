"""Device counting-step throughput on one GPU (to be replaced by the
benchmark's cells).

Runs the v3 counting step (kernel_v3.scan_group_v3: window hashing,
fingerprint-filtered site-table probe, exact verification, on-device count
accumulation) as the engine's grouped path does, over a 96,287-site /
~2.5M-k-mer table (the shape of the published human site set) and
uniformly random 256-slot read segments — which hit the table almost
never, so verification and scatter barely run.

Prints ONE JSON line naming the device:
  {"metric": "count_bases_per_s", "value": ..., "unit": "base/s",
   "vs_baseline": ..., "device": {"platform", "kind", "count", "card"}}

vs_baseline divides by the reference C++ ntsmCount v1.2.1 on one CPU
thread: 11.65 Mbase/s (1M x 100 bp reads, same site-table scale, g++ -O2
build).  The reference parallelizes only across input files (one thread
per file, FingerPrint.hpp:47), so per-core throughput is its unit of
scaling.  Each timed group ends in block_until_ready.  Refuses to run
without a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REF_BASES_PER_S = 11.65e6  # reference ntsmCount v1.2.1, 1 thread (see above)


def main() -> int:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ntsm_tpu.count.kernel_v3 import TableV3, pack_batch, scan_group_v3

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX runs on {dev.platform}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    ).stdout.strip().splitlines()[0]

    rng = np.random.default_rng(7)
    k, B, L = 19, 32768, 256  # ~8.4 Mbase per step
    AGG = 4  # the engine runs one scan of AGG steps per aggregated upload
    hashes = np.unique(
        rng.integers(0, (1 << 2 * k) - 1, size=96287 * 26, dtype=np.uint64)
    )
    tab = TableV3.from_hashes_device(hashes)
    kw = dict(k=k, L=L, n_buckets=tab.n_buckets, slots=tab.slots,
              bbits=tab.bbits)
    packed, vbits = pack_batch(rng.integers(0, 4, size=(B, L), dtype=np.uint8))
    fused = jnp.asarray(
        np.stack([np.concatenate([packed, vbits], axis=1)] * AGG)
    )
    counts = jnp.zeros(hashes.shape[0] + 1, dtype=jnp.int32)

    counts, diags = scan_group_v3(fused, tab.fp, tab.keys, tab.vals, counts,
                                  **kw)  # compile + warm-up
    jax.block_until_ready((counts, diags))

    groups = 8
    t0 = time.perf_counter()
    for _ in range(groups):
        counts, diags = scan_group_v3(fused, tab.fp, tab.keys, tab.vals,
                                      counts, **kw)
    jax.block_until_ready((counts, diags))
    dt = time.perf_counter() - t0
    bases_per_s = groups * AGG * B * L / dt

    print(json.dumps({
        "metric": "count_bases_per_s",
        "value": bases_per_s,
        "unit": "base/s",
        "vs_baseline": bases_per_s / REF_BASES_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
