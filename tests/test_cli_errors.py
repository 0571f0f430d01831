"""CLI error-path behavior: bad inputs must produce the reference's clear
errors, not tracebacks."""

import io

import numpy as np
import pytest

from ntsm_tpu.cli import count_cmd, eval_cmd, vcf_cmd
from tests.synth import make_reads_fastq, make_site_fasta


def _run(mod, argv, capsys):
    rc = mod.run(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_count_missing_site_file(capsys):
    rc, _, err = _run(count_cmd, ["reads.fq"], capsys)
    assert rc == 1
    assert "Missing variants (-s)" in err


def test_count_missing_input(capsys, tmp_path, rng):
    sites = str(tmp_path / "s.fa")
    make_site_fasta(rng, n_sites=2, path=sites)
    rc, _, err = _run(count_cmd, ["-s", sites, str(tmp_path / "nope.fq")], capsys)
    assert rc == 1
    assert "does not exist" in err


def test_count_k_too_large(capsys, tmp_path, rng):
    sites = str(tmp_path / "s.fa")
    make_site_fasta(rng, n_sites=2, path=sites)
    rc, _, err = _run(count_cmd, ["-k", "33", "-s", sites, sites], capsys)
    assert rc == 1
    assert "k cannot be greater than 32" in err


def test_eval_missing_file(capsys):
    rc, _, err = _run(eval_cmd, ["missing_counts.txt", "other.txt"], capsys)
    assert rc == 1


def test_eval_malformed_count_file(capsys, tmp_path):
    bad = tmp_path / "bad_counts.txt"
    bad.write_text("#@TK\t5\nnot a count file at all\n")
    ok = tmp_path / "ok_counts.txt"
    ok.write_text(
        "#@TK\t5\n#@KS\t19\n\n#locusID\tcountAT\tcountCG\tsumAT\tsumCG\t"
        "distinctAT\tdistinctCG\nrs1\t1\t2\t3\t4\t5\t6\n"
    )
    with pytest.raises(SystemExit):
        eval_cmd.run(["-a", str(bad), str(ok)])


def test_eval_pca_without_norm(capsys, tmp_path):
    ok = tmp_path / "a_counts.txt"
    ok.write_text(
        "#@TK\t5\n#@KS\t19\n\n#locusID\tcountAT\tcountCG\tsumAT\tsumCG\t"
        "distinctAT\tdistinctCG\nrs1\t1\t2\t3\t4\t5\t6\n"
    )
    b = tmp_path / "b_counts.txt"
    b.write_text(ok.read_text())
    # -p without -n: the reference requires normalization values
    rc, _, err = _run(
        eval_cmd, ["-a", "-p", "rot.tsv", str(ok), str(b)], capsys
    )
    assert rc == 1


def test_vcf_missing_site_file(capsys, tmp_path):
    ref = tmp_path / "ref.fa"
    ref.write_text(">chr1\nACGT\n")
    vcf = tmp_path / "a.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n")
    rc, _, err = _run(vcf_cmd, ["-r", str(ref), str(vcf)], capsys)
    assert rc == 1
    assert "Missing variants (-s)" in err


def test_vcf_nonexistent_site_file(capsys, tmp_path):
    ref = tmp_path / "ref.fa"
    ref.write_text(">chr1\nACGT\n")
    vcf = tmp_path / "a.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n")
    rc, _, err = _run(
        vcf_cmd, ["-s", str(tmp_path / "nope.fa"), "-r", str(ref), str(vcf)],
        capsys,
    )
    assert rc == 1
    assert "Unable to load variants (-s)" in err


def test_vcf_missing_ref(capsys, tmp_path, rng):
    sites = str(tmp_path / "s.fa")
    make_site_fasta(rng, n_sites=2, path=sites)
    vcf = tmp_path / "a.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n")
    rc, _, err = _run(vcf_cmd, ["-s", sites, str(vcf)], capsys)
    assert rc == 1
    assert "Unable to load reference file" in err


def test_vcf_no_input(capsys, tmp_path, rng):
    sites = str(tmp_path / "s.fa")
    make_site_fasta(rng, n_sites=2, path=sites)
    ref = tmp_path / "ref.fa"
    ref.write_text(">chr1\nACGT\n")
    rc, _, err = _run(vcf_cmd, ["-s", sites, "-r", str(ref)], capsys)
    assert rc == 1
    assert "Need Input File" in err


def test_count_summary_file_flag(capsys, tmp_path, rng):
    """-o writes the info summary to a file (FingerPrint.hpp:334-339)."""
    sites = str(tmp_path / "s.fa")
    _, site_list = make_site_fasta(rng, n_sites=4, path=sites)
    fq = str(tmp_path / "r.fq")
    make_reads_fastq(rng, site_list, coverage=3, path=fq)
    out = tmp_path / "summary.txt"
    rc = count_cmd.run(["--engine", "golden", "-o", str(out), "-s", sites, fq])
    captured = capsys.readouterr()
    assert rc in (0, None)
    text = out.read_text()
    assert "Total k-mers Considered:" in text
    assert "Sites Covered by at least one k-mer:" in text
    # stdout still carries the counts table
    assert "#locusID" in captured.out


def test_count_unknown_engine_rejected(capsys, tmp_path, rng):
    """--engine takes tpu or golden; any other name (the removed pallas
    engine included) is a usage error, not a silent default."""
    sites = str(tmp_path / "s.fa")
    make_site_fasta(rng, n_sites=2, path=sites)
    rc, out, err = _run(
        count_cmd, ["--engine", "pallas", "-s", sites, sites], capsys
    )
    assert rc == 1
    assert out == ""
    assert "unknown --engine 'pallas'" in err and "tpu, golden" in err


def test_distributed_without_cluster_variables(monkeypatch):
    """--distributed with no coordinator variables is an error naming the
    missing ones, not a silent single-process run."""
    from ntsm_tpu.parallel.distributed import init_distributed

    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="JAX_COORDINATOR_ADDRESS"):
        init_distributed()
