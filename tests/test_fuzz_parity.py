"""Randomized parity fuzzing: adversarial FASTQ inputs through every
counting engine must agree with the golden model exactly."""

import gzip

import numpy as np
import pytest

from ntsm_tpu.count.engine import EngineConfig, run_count, run_count_v3
from ntsm_tpu.count.golden import count_files
from ntsm_tpu.io.sites import load_site_table
from ntsm_tpu.options import Options
from tests.synth import make_site_fasta


def _adversarial_fastq(rng, sites, path, gz=False):
    """Reads with heavy Ns, sub-k lengths, exact-k lengths, lowercase, U,
    empty sequences, and site-derived reads mixed in."""
    alpha = "ACGTacgtNu"
    lines = []
    i = 0

    def add(seq):
        nonlocal i
        lines.append(f"@r{i} junk desc\n{seq}\n+\n{'I' * len(seq)}\n")
        i += 1

    for _ in range(40):
        n = int(rng.integers(0, 90))
        add("".join(rng.choice(list(alpha), size=n)) if n else "")
    add("A" * 19)           # exactly k
    add("A" * 18)           # k-1
    add("N" * 50)           # all invalid
    for site in sites[:6]:
        ref = site["at_win"].decode()
        var = site["cg_win"].decode()
        # site windows with Ns sprinkled
        s = list(ref)
        for p in rng.integers(0, len(s), size=2):
            s[int(p)] = "N"
        add("".join(s))
        add(var)
        add(var.lower())
    op = gzip.open if gz else open
    with op(path, "wt") as fh:
        fh.writelines(lines)


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_count_parity_all_engines(rng, tmp_path, trial):
    trng = np.random.default_rng(rng.integers(0, 2**63) + trial)
    sites_path = str(tmp_path / "sites.fa")
    _, sites = make_site_fasta(trng, n_sites=10, path=sites_path)
    fq = str(tmp_path / "adv.fq")
    gz = str(tmp_path / "adv2.fq.gz")
    _adversarial_fastq(trng, sites, fq)
    _adversarial_fastq(trng, sites, gz, gz=True)
    table = load_site_table(sites_path, k=19, allow_dupes=False)
    golden = count_files(table, [fq, gz])
    for version in (1, 2, 3):
        res = run_count(
            table,
            [fq, gz],
            Options(),
            EngineConfig(batch_reads=32, segment_len=64),
            version=version,
        )
        np.testing.assert_array_equal(res.counts, golden.counts)
        assert res.total_kmers == golden.total_kmers, f"v{version}"
        assert res.total_hits == golden.total_hits
        assert res.total_bases == golden.total_bases
        assert res.total_reads == golden.total_reads
