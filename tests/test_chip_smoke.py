"""chip_smoke.py's phases and its eval comparator at tiny sizes on the CPU
(the script itself refuses a machine without a GPU)."""

import os

import numpy as np
import pytest

import chip_smoke as cs


def _row(score, same="0", dist="-1", ibs0="3"):
    return "\t".join(["a", "b", score, same, dist, "0.5", ibs0, "7"])


HEAD = "sample1\tsample2\tscore\tsame\tdist\trelate\tibs0\tibs2"


def test_compare_summaries_accepts_score_within_bound():
    dev = "\n".join([HEAD, _row("1.000004"), _row("0.250000", dist="2.000001")])
    ex = "\n".join([HEAD, _row("1.000000"), _row("0.250000", dist="2.000000")])
    got = cs.compare_summaries(dev, ex)
    assert got["rows"] == 2
    assert got["max_score_diff"] == pytest.approx(4e-6)
    assert got["max_dist_diff"] == pytest.approx(1e-6)


@pytest.mark.parametrize(
    "dev_row",
    [_row("1.000010"), _row("1.000000", ibs0="4"), _row("1.000000", same="1")],
)
def test_compare_summaries_rejects(dev_row):
    with pytest.raises(cs.CheckFailed):
        cs.compare_summaries("\n".join([HEAD, dev_row]),
                             "\n".join([HEAD, _row("1.000000")]))


def test_phase0_refuses_the_cpu():
    with pytest.raises(cs.CheckFailed, match="not on a GPU"):
        cs.phase0(1)


def test_phases_at_tiny_size(tmp_path, monkeypatch):
    """Phases 1-4 end to end on 60 sites, two small samples and a cohort
    of 6 count files, on the CPU backend the tests name."""
    from ntsm_tpu.cli import count_cmd, eval_cmd
    from ntsm_tpu.options import Options

    work = str(tmp_path)
    n_sites = 60
    sites, at, cg = cs.make_sites(work, n_sites, seed=5)
    rng = np.random.default_rng(6)
    # 0.4 Mbase in 64-row batches: more than 16 batches, so -m can stop
    samples = {name: cs.make_sample(work, name, at, cg, 0.4, 2, rng,
                                    share=0.05)
               for name in ("sampleA", "sampleB")}
    monkeypatch.setattr(count_cmd, "Options", lambda: Options(batch_reads=64))
    monkeypatch.setattr(eval_cmd, "AUTO_DEVICE_MIN_SAMPLES", 4)
    pool = cs.make_pool(2)
    try:
        golden = {n: [pool.submit(cs._golden_part, sites, p) for p in ps]
                  for n, ps in samples.items()}
        cohort = pool.submit(cs._cohort_part, work, 6, 0, 7, n_sites)
        counted = cs.phase1(work, sites, samples, golden)
        cs.phase2_fixture()
        cs.phase2_cli(work, sites, counted)
        files = cohort.result() + [c["path"] for c in counted.values()]
    finally:
        pool.shutdown(wait=True)
    cs.phase3(work, files)
    import sys

    sys.path.insert(0, os.path.join(cs.REPO, "scripts"))
    import bench_eval

    rot, norm = bench_eval.make_pca_artifacts(
        work, np.random.default_rng(8), n_sites=n_sites)
    cs.phase4(work, files, rot, norm)
