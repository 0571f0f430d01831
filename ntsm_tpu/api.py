"""Public Python API.

The CLIs (`ntsm count|eval|vcf|sitegen`) wrap these. For pipelines that
want results as arrays/objects instead of files:

    import ntsm_tpu.api as ntsm

    table = ntsm.load_sites("human_sites_n10.fa")
    result = ntsm.count(table, ["sample_R1.fq.gz", "sample_R2.fq.gz"])
    print(result.coverage(table), result.error_rate(table))
    ntsm.write_counts("sample_counts.txt", table, result)

    pairs = ntsm.evaluate(["a_counts.txt", "b_counts.txt"])  # -> list of rows

Everything device-related (one GPU or all local GPUs) is selected
automatically; the device engines refuse to fall back to JAX's CPU backend
unless JAX_PLATFORMS=cpu asks for it.  See docs/DESIGN.md for the
architecture.
"""

from __future__ import annotations

import io as _io

import numpy as np

from ntsm_tpu.count.golden import CountResult
from ntsm_tpu.io.sites import SiteTable
from ntsm_tpu.options import Options

__all__ = [
    "load_sites",
    "count",
    "write_counts",
    "evaluate",
    "merge_counts",
    "CountResult",
    "SiteTable",
    "Options",
]


def load_sites(path: str, k: int = 19, allow_dupes: bool = False) -> SiteTable:
    """Load an interleaved site FASTA (REF/VAR entry per SNP site)."""
    from ntsm_tpu.io.sites import load_site_table

    return load_site_table(path, k=k, allow_dupes=allow_dupes)


def count(
    table: SiteTable,
    fastx_files,
    *,
    max_cov: float | None = None,
    threads: int | None = None,
    checkpoint: str | None = None,
    engine: str = "tpu",
    opts: Options | None = None,
) -> CountResult:
    """Count site k-mers in FASTA/FASTQ(.gz) reads (= ntsmCount).

    engine: "tpu" (default; auto-shards over all local devices) or
    "golden" (pure NumPy oracle).  Keyword conveniences are applied on top
    of `opts` when both are given."""
    opts = opts or Options()
    if max_cov is not None:
        opts = opts.replace(cov_thresh=max_cov)
    if threads is not None:
        opts = opts.replace(threads=threads)
    if checkpoint is not None:
        opts = opts.replace(checkpoint=checkpoint)
    if engine == "golden":
        from ntsm_tpu.count.golden import count_files

        return count_files(table, list(fastx_files), cov_thresh=opts.cov_thresh)
    from ntsm_tpu.count.engine import run_count

    return run_count(table, list(fastx_files), opts)


def write_counts(path_or_file, table: SiteTable, result: CountResult) -> None:
    """Write a reference-byte-compatible counts.txt."""
    from ntsm_tpu.io.countfile import format_counts

    mx, sm = result.site_max_sum(table)
    text = format_counts(
        table.site_ids, mx, sm, table.distinct, result.total_kmers, table.k
    )
    if hasattr(path_or_file, "write"):
        path_or_file.write(text)
    else:
        with open(path_or_file, "w") as fh:
            fh.write(text)


def evaluate(
    count_files,
    *,
    all_pairs: bool = True,
    engine: str = "tpu",
    opts: Options | None = None,
) -> list[dict]:
    """All-vs-all sample comparison (= ntsmEval -a): list of row dicts
    keyed by the reference's 26 column names."""
    from ntsm_tpu.eval.driver import run_eval
    from ntsm_tpu.eval.exact import HEADER
    from ntsm_tpu.eval.model import load_count_data

    opts = opts or Options()
    opts = opts.replace(all=all_pairs, engine=engine)
    data = load_count_data(list(count_files), opts)
    buf = _io.StringIO()
    run_eval(data, opts, buf)
    lines = buf.getvalue().splitlines()
    cols = HEADER.split("\t")
    out = []
    for line in lines[1:]:
        vals = line.split("\t")
        row = dict(zip(cols, vals))
        for key in row:
            if key in ("sample1", "sample2"):
                continue  # filenames stay strings even if numeric
            try:
                row[key] = int(row[key])
            except ValueError:
                try:
                    row[key] = float(row[key])
                except ValueError:
                    pass
        out.append(row)
    return out


def merge_counts(count_files, out_path: str) -> None:
    """Merge sharded count files (= ntsmEval --merge): counts and #@TK sum,
    distinct columns kept."""
    from ntsm_tpu.eval.merge import merge_counts as _merge
    from ntsm_tpu.eval.model import load_count_data

    opts = Options(merge=out_path)
    data = load_count_data(list(count_files), opts)
    _merge(data, out_path)
