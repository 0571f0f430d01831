"""Rect engine specifics: block/tile boundary coverage and the scatter
index map (tests beyond what the shared driver tests exercise — N here
spans multiple 256-row column blocks and 128-row tiles)."""

import io

import numpy as np
import pytest

from ntsm_tpu.eval.exact import pair_score
from ntsm_tpu.eval.model import CountData
from ntsm_tpu.options import Options


def _cohort(rng, N, L):
    mc = rng.integers(0, 25, size=(N, L, 2)).astype(np.int64)
    mc[1] = mc[0] + rng.integers(0, 2, size=(L, 2))  # near-duplicate pair
    mc[rng.random((N, L)) < 0.05] = 0
    data = CountData(
        filenames=[f"s{i}" for i in range(N)],
        locus_ids=[f"rs{i}" for i in range(L)],
        distinct=np.full((L, 2), 9, dtype=np.int64),
        max_counts=mc,
        sum_counts=mc * 2,
        raw_total_kmers=np.full(N, 8_000_000, dtype=np.int64),
        ks=np.full(N, 19, dtype=np.int64),
        total_counts=mc.sum(axis=(1, 2)),
    )
    data.prepare(Options(genome_size=1_000_000))
    return data


def test_rect_multi_block_matches_exact(rng, monkeypatch):
    """N=300 spans two column blocks (256) and three row tiles (128):
    diagonal-slab masking, the cross-block scatter map, and the padded
    tail must all land every pair on the exact oracle."""
    import ntsm_tpu.eval.tpu as T
    from ntsm_tpu.eval.rect import make_scorer_for_planes
    from ntsm_tpu.eval.wire import _device_planes

    monkeypatch.setattr(T, "_auto_mesh", lambda: None)
    N, L = 300, 700
    data = _cohort(rng, N, L)
    opts = Options(all=True, genome_size=1_000_000)
    sc = make_scorer_for_planes(data, opts, _device_planes(data))
    f3, i9 = sc.result(data.cov)
    assert sc.P == N * (N - 1) // 2

    iu, ju = np.triu_indices(N, 1)
    # i9 column order: [ibs0, ibs2, h1, h2, shet, o1, o2, shom, n]
    stats = dict(
        score=f3[:, 0], ibs0=i9[:, 0], hets1=i9[:, 2], hets2=i9[:, 3],
        shared_hets=i9[:, 4], homs2=i9[:, 6], n=i9[:, 8],
    )
    # probe pairs straddling every boundary class: same tile, same block
    # across tiles, across blocks, last (padded) tile, first/last pair
    probes = [(0, 1), (0, 299), (100, 140), (127, 128), (200, 260),
              (255, 256), (256, 299), (298, 299), (5, 256), (129, 257)]
    for i, j in probes:
        k = int(np.flatnonzero((iu == i) & (ju == j))[0])
        score, n, rel = pair_score(data, i, j, opts)
        assert int(stats["n"][k]) == n, (i, j)
        assert int(stats["ibs0"][k]) == rel.ibs0, (i, j)
        assert int(stats["shared_hets"][k]) == rel.shared_hets, (i, j)
        assert int(stats["hets1"][k]) == rel.hets1, (i, j)
        assert int(stats["hets2"][k]) == rel.hets2, (i, j)
        assert int(stats["homs2"][k]) == rel.homs2, (i, j)
        assert float(stats["score"][k]) == pytest.approx(
            score, rel=5e-6, abs=5e-6), (i, j)
    # full coverage: no pair left unscattered (ll==0 AND n==0 only where
    # the oracle agrees n can be 0 — spot-check the n column instead)
    n_exact = np.array(
        [pair_score(data, int(i), int(j), opts)[1]
         for i, j in zip(iu[::971], ju[::971])]
    )
    np.testing.assert_array_equal(
        stats["n"][::971].astype(np.int64), n_exact
    )


def test_rect_driver_output_matches_unstreamed_stats(rng, monkeypatch):
    """compute_score_all_tpu (rect driver) emission at N=300 agrees with
    the old square packed stats path on every column."""
    import ntsm_tpu.eval.tpu as T

    monkeypatch.setattr(T, "_auto_mesh", lambda: None)
    N, L = 300, 500
    data = _cohort(rng, N, L)
    opts = Options(all=True, genome_size=1_000_000)
    out = io.StringIO()
    T.compute_score_all_tpu(data, opts, out)
    rows = out.getvalue().splitlines()[1:]
    assert len(rows) == N * (N - 1) // 2

    stats = T.compute_pair_stats_tpu(data, opts, packed=True)
    iu, ju = stats["iu"], stats["ju"]
    for k in range(0, len(rows), 1237):
        f = rows[k].split("\t")
        assert int(f[6]) == int(stats["ibs0"][k])  # ibs0 col
        assert int(f[9]) == int(stats["hets1"][k])  # het1 col
        assert int(f[15]) == int(stats["n"][k])  # n col
        assert float(f[2]) == pytest.approx(
            float(stats["score"][k]), rel=5e-6, abs=5e-6
        )


def test_fetch_thread_death_raises_not_hangs(rng, monkeypatch):
    """A fetch-thread exception (e.g. a lost device mid-np.asarray) must
    surface from result() — the fetcher keeps consuming to the
    dispatcher's sentinel so the bounded results queue can never wedge
    the dispatcher (the old get_nowait drain deadlocked the run)."""
    import pytest

    import ntsm_tpu.eval.tpu as T
    from ntsm_tpu.eval.rect import RectScorer, make_scorer_for_planes
    from ntsm_tpu.eval.wire import _device_planes

    monkeypatch.setattr(T, "_auto_mesh", lambda: None)
    monkeypatch.setattr(
        RectScorer, "_finalize_scatter",
        lambda self, *a, **k: (_ for _ in ()).throw(
            RuntimeError("simulated fetch failure")
        ),
    )
    N, L = 300, 700
    data = _cohort(rng, N, L)
    opts = Options(all=True, genome_size=1_000_000)
    sc = make_scorer_for_planes(data, opts, _device_planes(data))
    with pytest.raises(RuntimeError, match="simulated fetch failure"):
        sc.result(data.cov)
