"""Differential parser fuzz: random well-formed + mutated FASTQ/FASTA
through `ntsm count --engine golden` vs the reference ntsmCount binary;
counts.txt plus the stderr tallies (Total Bases/k-mers) must be
byte-identical.  Covers kseq grammar corners reachable by mutation:
leading/inter-record junk, header chars mid-line, truncated records,
quality length mismatches (kseq -2 file abort), empty lines, CR-LF,
line-wrapped FASTA, mixed FASTA/FASTQ.

Usage: python scripts/fuzz_parser_vs_ref.py [trials=50] [--ref /tmp/ntsm_ref/ntsmCount]
Requires a built reference binary; exits 0 with a note when absent.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

MUTATIONS = (
    "none", "leading_junk", "midline_header", "inter_junk", "truncate",
    "qual_long", "qual_short", "empty_lines", "crlf", "del_byte",
    "dup_line", "swap_at_gt", "gz_trunc", "gz_flip",
)


def mutate(text: str, kind: str, rng) -> str:
    lines = text.splitlines(keepends=True)
    if kind == "leading_junk":
        return "; garbage\nmore junk\n" + text
    if kind == "midline_header":
        return "junk bytes " + text  # '@'/'>' of record 1 now mid-line
    if kind == "inter_junk":
        k = int(rng.integers(1, max(2, len(lines) // 4))) * 4
        return "".join(lines[:k]) + "-- junk --\n" + "".join(lines[k:])
    if kind == "truncate":
        cut = int(rng.integers(1, len(text)))
        return text[:cut]
    if kind == "qual_long":
        k = int(rng.integers(0, max(1, len(lines) // 4))) * 4
        return "".join(lines[:k]) + "@bad\nACGT\n+\nIIIIIIIIII\n" + "".join(lines[k:])
    if kind == "qual_short":
        k = int(rng.integers(0, max(1, len(lines) // 4))) * 4
        return "".join(lines[:k]) + "@bad\nACGTACGT\n+\nII\nACGT\n" + "".join(lines[k:])
    if kind == "empty_lines":
        k = int(rng.integers(1, max(2, len(lines) // 4))) * 4
        return "".join(lines[:k]) + "\n\n" + "".join(lines[k:])
    if kind == "crlf":
        return text.replace("\n", "\r\n")
    if kind == "del_byte":
        cut = int(rng.integers(0, len(text) - 1))
        return text[:cut] + text[cut + 1 :]
    if kind == "dup_line":
        k = int(rng.integers(0, len(lines)))
        return "".join(lines[: k + 1]) + lines[k] + "".join(lines[k + 1 :])
    if kind == "swap_at_gt":
        k = int(rng.integers(0, max(1, len(lines) // 4))) * 4
        if lines and lines[k].startswith("@"):
            lines[k] = ">" + lines[k][1:]
        return "".join(lines)
    return text


def main() -> int:
    trials = 50
    ref_bin = "/tmp/ntsm_ref/ntsmCount"
    args = sys.argv[1:]
    if args and args[0].isdigit():
        trials = int(args[0])
    if "--ref" in args:
        ref_bin = args[args.index("--ref") + 1]
    if not os.path.exists(ref_bin):
        print(f"reference binary not found at {ref_bin}; skipping")
        return 0

    from synth import make_reads_fastq, make_site_fasta

    rng = np.random.default_rng(20260817)
    tmp = tempfile.mkdtemp(prefix="fuzz_parse_")
    sites_path = os.path.join(tmp, "sites.fa")
    _, sites = make_site_fasta(rng, n_sites=12, path=sites_path)
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + os.environ.get("PYTHONPATH", ""),
    )
    fails = 0
    for t in range(trials):
        base = os.path.join(tmp, f"t{t}.fq")
        make_reads_fastq(rng, sites, coverage=3, genotype="het", path=base)
        kind = MUTATIONS[t % len(MUTATIONS)]
        if kind in ("gz_trunc", "gz_flip"):
            # truncated gzip: the reference counts whatever zlib inflates
            import gzip as _gz

            blob_io = __import__("io").BytesIO()
            with _gz.GzipFile(fileobj=blob_io, mode="wb") as zf:
                zf.write(open(base, "rb").read())
            blob = blob_io.getvalue()
            path = os.path.join(tmp, f"t{t}_{kind}.fq.gz")
            if kind == "gz_flip":  # bit flip: gzread voids the erroring
                blob = bytearray(blob)  # 16384-byte call window
                blob[int(rng.integers(10, len(blob)))] ^= 1 << int(rng.integers(0, 8))
                blob = bytes(blob)
                cut = len(blob)
            else:
                cut = int(rng.integers(1, len(blob)))
            with open(path, "wb") as fh:
                fh.write(blob[:cut])
        else:
            mutated = mutate(open(base).read(), kind, rng)
            path = os.path.join(tmp, f"t{t}_{kind}.fq")
            with open(path, "w") as fh:
                fh.write(mutated)
        ref = subprocess.run(
            [ref_bin, "-t", "1", "-s", sites_path, path], capture_output=True
        )
        ours = subprocess.run(
            [sys.executable, "-m", "ntsm_tpu", "count", "--engine", "golden",
             "-s", sites_path, path],
            env=env,
            capture_output=True,
        )
        # compare stdout + the tally lines of stderr (not Time/Memory)
        ref_tally = [
            ln for ln in ref.stderr.decode(errors="replace").splitlines()
            if ln.startswith("Total") or ln.startswith("Distinct")
            or ln.startswith("Sites")
        ]
        our_tally = [
            ln for ln in ours.stderr.decode(errors="replace").splitlines()
            if ln.startswith("Total") or ln.startswith("Distinct")
            or ln.startswith("Sites")
        ]
        ok = (
            ref.returncode == ours.returncode == 0
            and ref.stdout == ours.stdout
            and ref_tally == our_tally
        )
        if not ok:
            fails += 1
            print(f"FAIL trial {t} ({kind}): rc {ref.returncode}/{ours.returncode}")
            print("  file:", path)
            if ref.stdout != ours.stdout:
                print("  stdout differs")
            if ref_tally != our_tally:
                print("  ref tally:", ref_tally)
                print("  our tally:", our_tally)
    print(f"{trials} trials, {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
