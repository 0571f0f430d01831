"""Where `ntsm eval --engine auto` should switch from exact to the device.

Times whole CLI runs — a fresh `python -m ntsm_tpu eval -a` process per
run, start-up and compilation included, as a user pays them — of the
exact host engine and the device engine at N = 64, 128, 256 and 512
count files at the 96,287-site shape (scripts/bench_eval cohort).  The
device runs share the persistent compile cache, so the first one is
timed cold and N=64 is timed again warm at the end.  One process uses
the GPU at a time; the cohort is generated by CPU-pinned workers.

    python scripts/time_eval_cutoff.py [--seed N]

Prints one JSON line per run and a final line with the smallest N at
which the device run was faster.  Fails without a GPU (the device
engine refuses JAX's CPU fallback).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SIZES = (64, 128, 256, 512)


def run(engine: str, files: list[str]) -> float:
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "ntsm_tpu", "eval", "-a", "--engine", engine,
         *files],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True,
    )
    wall = time.perf_counter() - t
    if res.returncode != 0:
        sys.exit(f"ntsm eval --engine {engine} failed:\n{res.stderr[-3000:]}")
    return wall


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = subprocess.run(
        [sys.executable, "-c", "import jax; d = jax.devices(); "
         "print(d[0].platform, len(d), d[0].device_kind)"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"# device: {dev}; card: {cs.card_line()}", flush=True)
    if not dev.startswith("gpu"):
        print("time_eval_cutoff: needs a GPU", file=sys.stderr)
        return 1

    work = os.path.join(REPO, ".smoke_work", "cutoff")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    n_max, per = max(SIZES), 32
    pool = cs.make_pool(min(16, os.cpu_count() or 1))
    try:
        futs = [pool.submit(cs._cohort_part, work, per, s, args.seed,
                            cs.N_SITES) for s in range(0, n_max, per)]
        files = [p for f in futs for p in f.result()]
    finally:
        pool.shutdown(wait=True)

    faster_at = None
    for i, n in enumerate(SIZES):
        walls = {e: run(e, files[:n]) for e in ("exact", "tpu")}
        print(json.dumps(dict(n_samples=n, exact_s=walls["exact"],
                              device_s=walls["tpu"],
                              device_compile_cache="cold" if i == 0
                              else "warm")), flush=True)
        if faster_at is None and walls["tpu"] < walls["exact"]:
            faster_at = n
    warm = run("tpu", files[:SIZES[0]])
    print(json.dumps(dict(n_samples=SIZES[0], device_s=warm,
                          device_compile_cache="warm")))
    print(json.dumps(dict(device_faster_from_n=faster_at)))
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
