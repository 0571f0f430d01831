"""Randomized eval parity: device engine vs exact engine over random cohorts
and flag combinations. Integer columns must be identical; scores within
f32-accumulation error (measured worst 1.5e-5 abs over 30 trials)."""

import io

import numpy as np
import pytest

from ntsm_tpu.eval import exact
from ntsm_tpu.eval.model import CountData
from ntsm_tpu.eval.tpu import compute_score_all_tpu
from ntsm_tpu.options import Options

INT_COLS = {
    "ibs0", "ibs2", "het1", "het2", "sharedHet", "hom1", "hom2",
    "sharedHom", "n", "miss1", "miss2", "allHom1", "allHom2",
    "allHet1", "allHet2", "same",
}


def test_eval_fuzz_tpu_vs_exact(rng):
    from ntsm_tpu.eval.exact import HEADER

    cols = HEADER.split("\t")
    for trial in range(8):
        trng = np.random.default_rng(rng.integers(0, 2**62) + trial)
        N = int(trng.integers(2, 10))
        L = int(trng.integers(5, 300))
        mx = trng.poisson(trng.uniform(0.5, 30), size=(N, L, 2)).astype(np.int32)
        mx[trng.random(mx.shape[:2]) < trng.uniform(0, 0.4)] = 0
        if trng.integers(0, 2):
            mx[1] = mx[0]  # duplicate pair
        opts = Options(
            all=True,
            min_cov=int(trng.choice([0, 1, 2, 5])),
            cov_skew=float(trng.choice([0.2, 0.0, 0.5])),
            genome_size=float(trng.choice([6.2e9, 1e6])),
        )
        data = CountData(
            filenames=[f"s{i}_counts.txt" for i in range(N)],
            locus_ids=[f"rs{i}" for i in range(L)],
            distinct=np.full((L, 2), 13, dtype=np.int64),
            max_counts=mx,
            sum_counts=mx * 13,
            raw_total_kmers=trng.integers(1, 10**10, N),
            ks=np.full(N, 19, dtype=np.int64),
            total_counts=mx.sum(axis=(1, 2)).astype(np.int64),
        ).prepare(opts)
        b1, b2 = io.StringIO(), io.StringIO()
        compute_score_all_tpu(data, opts, b1)
        exact.compute_score_all(data, opts, b2)
        r1 = b1.getvalue().splitlines()
        r2 = b2.getvalue().splitlines()
        assert len(r1) == len(r2)
        for l1, l2 in zip(r1[1:], r2[1:]):
            f1, f2 = l1.split("\t"), l2.split("\t")
            for c, (x1, x2) in enumerate(zip(f1, f2)):
                if x1 == x2:
                    continue
                name = cols[c]
                assert name not in INT_COLS, (trial, name, x1, x2)
                v1, v2 = float(x1), float(x2)
                assert abs(v1 - v2) <= 1e-4 + 1e-3 * abs(v2), (
                    trial, name, x1, x2,
                )


def test_pca_fuzz_tpu_vs_host(rng):
    """-p path: the device pair-block scorer must emit the same pairs in
    the same order as the host loop, with identical integer columns and
    scores within the -a engine's tolerance."""
    from ntsm_tpu.eval.driver import compute_score_pca
    from ntsm_tpu.eval.exact import HEADER
    from ntsm_tpu.eval.tpu import compute_score_pca_tpu

    cols = HEADER.split("\t")
    for trial in range(6):
        trng = np.random.default_rng(rng.integers(0, 2**62) + 77 * trial)
        N = int(trng.integers(3, 12))
        L = int(trng.integers(5, 200))
        mx = trng.poisson(trng.uniform(0.5, 30), size=(N, L, 2)).astype(np.int32)
        mx[trng.random(mx.shape[:2]) < trng.uniform(0, 0.5)] = 0
        if trng.integers(0, 2):
            mx[1] = mx[0]
        dim = int(trng.integers(2, 6))
        cloud = trng.normal(0, trng.uniform(0.5, 10), size=(N, dim))
        opts = Options(
            all=bool(trng.integers(0, 2)),
            min_cov=int(trng.choice([0, 1, 2])),
            dim=dim,
            pca="unused.tsv",
        )
        data = CountData(
            filenames=[f"s{i}_counts.txt" for i in range(N)],
            locus_ids=[f"rs{i}" for i in range(L)],
            distinct=np.full((L, 2), 13, dtype=np.int64),
            max_counts=mx,
            sum_counts=mx * 13,
            raw_total_kmers=trng.integers(1, 10**10, N),
            ks=np.full(N, 19, dtype=np.int64),
            total_counts=mx.sum(axis=(1, 2)).astype(np.int64),
        ).prepare(opts)
        b1, b2 = io.StringIO(), io.StringIO()
        compute_score_pca_tpu(data, opts, b1, cloud)
        compute_score_pca(data, opts, b2, cloud)
        r1 = b1.getvalue().splitlines()
        r2 = b2.getvalue().splitlines()
        assert len(r1) == len(r2), (trial, len(r1), len(r2))
        for l1, l2 in zip(r1[1:], r2[1:]):
            f1, f2 = l1.split("\t"), l2.split("\t")
            assert len(f1) == len(f2)
            for c, (x1, x2) in enumerate(zip(f1, f2)):
                if x1 == x2:
                    continue
                name = cols[c]
                assert name not in INT_COLS, (trial, name, x1, x2)
                v1, v2 = float(x1), float(x2)
                assert abs(v1 - v2) <= 1e-4 + 1e-3 * abs(v2), (
                    trial, name, x1, x2,
                )


@pytest.mark.skipif(
    "not __import__('ntsm_tpu.native', fromlist=['native']).available()",
    reason="native library unavailable",
)
def test_native_row_formatter_matches_python_loop(rng):
    """The native emission path is byte-identical to the Python loop on a
    synthetic stats matrix covering every formatting edge: DBL_MAX scores
    (n == 0 pairs), nan/-nan relatedness (zero denominators), inf
    homConcord, and both -a and thresholded modes."""
    import io

    from ntsm_tpu.eval.exact import DBL_MAX
    from ntsm_tpu.eval import tpu as evt
    from ntsm_tpu.eval.model import CountData
    from ntsm_tpu.options import Options

    N = 23
    stats = {}
    for k in (
        "n", "ibs0", "shared_hets", "shared_homs", "hets1", "homs1",
    ):
        stats[k] = rng.integers(0, 90000, size=(N, N)).astype(np.int64)
    # zero denominators -> nan / inf in relate / homConcord
    stats["hets1"][3, :] = 0
    stats["hets1"][:, 3] = 0
    stats["homs1"][5, :] = 0
    stats["ibs0"][5, :] = 0
    stats["shared_homs"][5, :] = 0  # 0/0 -> nan with x86 sign
    score = rng.uniform(0.0, 3.0, size=(N, N))
    score[2, 7] = DBL_MAX  # n == 0 pair sentinel, 316-char %f output
    stats["score"] = score

    data = CountData.__new__(CountData)
    data._max_counts = np.zeros((N, 1, 2), dtype=np.int64)  # n_samples prop
    data.filenames = [f"s{i}.txt" for i in range(N)]
    data.cov = rng.uniform(10, 40, N)
    data.error_rate = rng.uniform(0, 0.02, N)
    data.miss = rng.integers(0, 50, N)
    data.homs = rng.integers(1000, 9000, N)
    data.hets = rng.integers(1000, 9000, N)

    class _FakeStats:
        pass

    def emit(opts, use_native):
        out = io.StringIO()
        if use_native:
            lib = evt._load_row_formatter()
            assert lib is not None, "native formatter unavailable"
            iu, ju, sc_v, cols = evt._triangle_vectors(stats, N)
            evt._emit_pair_chunk(data, opts, out, iu, ju, sc_v, cols, lib, None)
        else:
            # the Python loop body of compute_score_all_tpu
            from ntsm_tpu.eval.exact import PairResult, Relate, results_row
            from ntsm_tpu.utils.formats import cpp_div

            sc = stats["score"]
            for i in range(N):
                for j in range(i + 1, N):
                    if not (opts.all or sc[i, j] < opts.score_thresh):
                        continue
                    r = Relate(
                        ibs0=int(stats["ibs0"][i, j]),
                        ibs2=int(
                            stats["shared_hets"][i, j]
                            + stats["shared_homs"][i, j]
                        ),
                        shared_homs=int(stats["shared_homs"][i, j]),
                        shared_hets=int(stats["shared_hets"][i, j]),
                        hets1=int(stats["hets1"][i, j]),
                        homs1=int(stats["homs1"][i, j]),
                        hets2=int(stats["hets1"][j, i]),
                        homs2=int(stats["homs1"][j, i]),
                    )
                    r.hom_concord = cpp_div(
                        float(r.shared_homs) - 2.0 * float(r.ibs0),
                        float(min(r.homs1, r.homs2)),
                    )
                    r.relatedness = cpp_div(
                        float(r.shared_hets) - 2.0 * float(r.ibs0),
                        float(min(r.hets1, r.hets2)),
                    )
                    res = PairResult(
                        i=i, j=j, score=float(sc[i, j]),
                        n=int(stats["n"][i, j]), relate=r,
                    )
                    out.write(results_row(data, res, "-1", opts))
                    out.write("\n")
        return out.getvalue()

    for opts in (Options(all=True), Options(all=False)):
        got = emit(opts, use_native=True)
        exp = emit(opts, use_native=False)
        assert got == exp


@pytest.mark.skipif(
    "not __import__('ntsm_tpu.native', fromlist=['native']).available()",
    reason="native library unavailable",
)
def test_pca_native_emission_matches_python_fallback(rng, monkeypatch):
    """compute_score_pca_tpu's native emission block is byte-identical to
    its own per-row Python fallback on the same stats (the -a path has
    this pinned via _write_rows_native; this covers the separately
    assembled -p block: dist column, keep-filtering, same column)."""
    from ntsm_tpu import native
    from ntsm_tpu.eval.tpu import compute_score_pca_tpu

    for trial in range(3):
        trng = np.random.default_rng(500 + trial)
        N = int(trng.integers(4, 10))
        L = int(trng.integers(20, 120))
        mx = trng.poisson(8, size=(N, L, 2)).astype(np.int32)
        mx[trng.random(mx.shape[:2]) < 0.2] = 0
        dim = 3
        cloud = trng.normal(0, 4, size=(N, dim))
        opts = Options(all=bool(trial % 2), dim=dim, pca="unused.tsv")
        data = CountData(
            filenames=[f"s{i}_counts.txt" for i in range(N)],
            locus_ids=[f"rs{i}" for i in range(L)],
            distinct=np.full((L, 2), 13, dtype=np.int64),
            max_counts=mx,
            sum_counts=mx * 13,
            raw_total_kmers=trng.integers(1, 10**9, N),
            ks=np.full(N, 19, dtype=np.int64),
            total_counts=mx.sum(axis=(1, 2)).astype(np.int64),
        ).prepare(opts)
        b_nat = io.StringIO()
        compute_score_pca_tpu(data, opts, b_nat, cloud)
        with monkeypatch.context() as m:
            m.setattr(native, "load", lambda: None)
            b_py = io.StringIO()
            compute_score_pca_tpu(data, opts, b_py, cloud)
        assert b_nat.getvalue() == b_py.getvalue(), trial


def test_streaming_pipeline_fuzz(rng, tmp_path, monkeypatch):
    """Compositional fuzz of the full file->streamed-upload->packed-blob->
    streamed-rows pipeline: random cohorts through load_count_data_eval +
    compute_score_all_tpu vs the exact engine, with randomized upload
    block and fetch chunk sizes.  Integer columns must be byte-identical,
    scores within the device tolerance."""
    import functools

    import ntsm_tpu.eval.tpu as T
    from ntsm_tpu.eval.model import load_count_data
    from ntsm_tpu.io.countfile import format_counts

    monkeypatch.setattr(T, "_auto_mesh", lambda: None)
    for trial in range(3):
        N = int(rng.integers(3, 8))
        L = int(rng.integers(40, 300))
        ids = [f"rs{i}" for i in range(L)]
        distinct = np.full((L, 2), int(rng.integers(5, 20)), dtype=np.int64)
        paths = []
        for s in range(N):
            geno = rng.integers(0, 3, size=L)
            lam = float(rng.uniform(2, 40))
            at = rng.poisson(lam * (2 - geno)).astype(np.int64)
            cg = rng.poisson(lam * geno).astype(np.int64)
            if rng.random() < 0.3:  # dropout rows
                z = rng.random(L) < 0.3
                at[z] = 0
                cg[z] = 0
            mx = np.stack([at, cg], axis=1)
            text = format_counts(
                ids, mx, mx * 3, distinct, int(mx.sum() * 100), 19
            )
            p = tmp_path / f"t{trial}_s{s}_counts.txt"
            p.write_text(text)
            paths.append(str(p))

        monkeypatch.setattr(
            T, "_upload_wires_streaming",
            functools.partial(
                T._upload_wires_streaming.func
                if isinstance(T._upload_wires_streaming, functools.partial)
                else T._upload_wires_streaming,
                block_rows=int(rng.integers(1, N + 2)),
            ),
        )
        monkeypatch.setattr(T, "STREAM_PAIRS", int(rng.integers(2, 12)))
        all_flag = bool(rng.integers(0, 2))
        opts = Options(all=all_flag, engine="tpu")
        d = T.load_count_data_eval(paths, opts)
        assert getattr(d, "dev_planes", None) is not None
        tpu_out = io.StringIO()
        compute_score_all_tpu(d, opts, tpu_out)
        ex_out = io.StringIO()
        exact.compute_score_all(
            load_count_data(paths, opts.replace(engine="exact")), opts, ex_out
        )
        got = tpu_out.getvalue().splitlines()
        want = ex_out.getvalue().splitlines()
        assert len(got) == len(want), (trial, len(got), len(want))
        for a, b in zip(got[1:], want[1:]):
            ca, cb = a.split("\t"), b.split("\t")
            assert ca[:2] == cb[:2] and ca[3:] == cb[3:], (trial, ca, cb)
            if ca[2] != cb[2]:
                assert abs(float(ca[2]) - float(cb[2])) < 5e-6, (trial, ca[2], cb[2])
