"""Device eval engine vs the exact engine: identical integer tallies,
score agreement to tight tolerance, identical classification."""

import io
import pathlib

import numpy as np
import pytest

from ntsm_tpu.eval.exact import pair_score
from ntsm_tpu.eval.model import load_count_data
from ntsm_tpu.eval.tpu import compute_pair_stats_tpu, compute_score_all_tpu
from ntsm_tpu.options import Options

FIX = pathlib.Path(__file__).parent / "fixtures"
COUNT_FILES = [
    str(FIX / "sampleA_counts.txt"),
    str(FIX / "sampleA2_counts.txt"),
    str(FIX / "sampleB_counts.txt"),
    str(FIX / "sampleC_counts.txt"),
    str(FIX / "sampleLow_counts.txt"),
]


@pytest.fixture(scope="module")
def data():
    return load_count_data(COUNT_FILES, Options())


def test_tpu_stats_match_exact(data):
    opts = Options()
    stats = compute_pair_stats_tpu(data, opts)
    N = data.n_samples
    for i in range(N):
        for j in range(i + 1, N):
            score, n, rel = pair_score(data, i, j, opts)
            assert stats["n"][i, j] == n
            assert stats["ibs0"][i, j] == rel.ibs0
            assert stats["shared_hets"][i, j] == rel.shared_hets
            assert stats["shared_homs"][i, j] == rel.shared_homs
            assert stats["hets1"][i, j] == rel.hets1
            assert stats["homs1"][i, j] == rel.homs1
            assert stats["hets1"][j, i] == rel.hets2
            assert stats["homs1"][j, i] == rel.homs2
            if n > 0:
                assert stats["score"][i, j] == pytest.approx(score, rel=2e-6, abs=4e-6)
            else:
                assert stats["score"][i, j] == score


def test_tpu_classification_matches(data):
    opts = Options()
    stats = compute_pair_stats_tpu(data, opts)
    N = data.n_samples
    for i in range(N):
        for j in range(i + 1, N):
            score, _, _ = pair_score(data, i, j, opts)
            assert (stats["score"][i, j] < opts.score_thresh) == (
                score < opts.score_thresh
            )


def test_tpu_output_rows_match_exact_except_score_digits(data):
    """Full -a output: every non-score column byte-identical; score within
    1 ulp of the 6-decimal print."""
    from ntsm_tpu.eval.exact import compute_score_all

    opts = Options(all=True, engine="tpu")
    tpu_out = io.StringIO()
    compute_score_all_tpu(data, opts, tpu_out)
    exact_out = io.StringIO()
    compute_score_all(data, opts, exact_out)
    tl = tpu_out.getvalue().splitlines()
    el = exact_out.getvalue().splitlines()
    assert len(tl) == len(el)
    assert tl[0] == el[0]  # header
    for trow, erow in zip(tl[1:], el[1:]):
        tf = trow.split("\t")
        ef = erow.split("\t")
        assert tf[:2] == ef[:2]
        assert tf[3:] == ef[3:]
        assert float(tf[2]) == pytest.approx(float(ef[2]), abs=4e-6)


def test_tpu_larger_synthetic_cohort(rng):
    """Random 64-sample cohort over 500 sites: tallies exact, scores tight."""
    import ntsm_tpu.eval.model as M

    N, L = 64, 500
    mc = rng.integers(0, 40, size=(N, L, 2)).astype(np.int64)
    # make some same-origin pairs
    mc[1] = mc[0] + rng.integers(0, 3, size=(L, 2))
    mc[2] = np.maximum(mc[0] - rng.integers(0, 3, size=(L, 2)), 0)
    # sprinkle missing sites
    miss = rng.random((N, L)) < 0.05
    mc[miss] = 0
    data = M.CountData(
        filenames=[f"s{i}" for i in range(N)],
        locus_ids=[f"rs{i}" for i in range(L)],
        distinct=np.full((L, 2), 10, dtype=np.int64),
        max_counts=mc,
        sum_counts=mc * 3,
        raw_total_kmers=np.full(N, 10_000_000, dtype=np.int64),
        ks=np.full(N, 19, dtype=np.int64),
        total_counts=mc.sum(axis=(1, 2)),
    )
    opts = Options(genome_size=1_000_000)
    data.prepare(opts)
    stats = compute_pair_stats_tpu(data, opts)
    for i, j in [(0, 1), (0, 2), (5, 9), (30, 63), (0, 63)]:
        score, n, rel = pair_score(data, i, j, opts)
        assert stats["n"][i, j] == n
        assert stats["ibs0"][i, j] == rel.ibs0
        assert stats["shared_hets"][i, j] == rel.shared_hets
        assert stats["score"][i, j] == pytest.approx(score, rel=5e-6, abs=5e-6)


def test_packed_stats_match_full(data):
    """The single-fetch triangle pack carries exactly the full-matrix
    stats: tallies bit-equal, scores within compensated-pair error."""
    from ntsm_tpu.eval.exact import DBL_MAX

    opts = Options()
    full = compute_pair_stats_tpu(data, opts)
    packed = compute_pair_stats_tpu(data, opts, packed=True)
    N = data.n_samples
    iu, ju = np.triu_indices(N, 1)
    np.testing.assert_array_equal(packed["iu"], iu)
    np.testing.assert_array_equal(packed["ju"], ju)
    for kp, kf, swap in [
        ("n", "n", False),
        ("ibs0", "ibs0", False),
        ("shared_hets", "shared_hets", False),
        ("shared_homs", "shared_homs", False),
        ("hets1", "hets1", False),
        ("homs1", "homs1", False),
        ("hets2", "hets1", True),
        ("homs2", "homs1", True),
    ]:
        ref = full[kf][ju, iu] if swap else full[kf][iu, ju]
        np.testing.assert_array_equal(packed[kp], ref, err_msg=kp)
    fs = full["score"][iu, ju]
    finite = fs < DBL_MAX
    np.testing.assert_allclose(
        packed["score"][finite], fs[finite], rtol=1e-6, atol=1e-9
    )
    np.testing.assert_array_equal(packed["score"][~finite], fs[~finite])


@pytest.mark.parametrize("all_flag,stream_pairs", [
    (True, None), (False, None), (True, 3), (False, 3),
])
def test_packed_output_rows_match_exact(data, monkeypatch, all_flag, stream_pairs):
    """End-to-end -a / default output through the packed single-device
    streaming path vs the exact engine: every non-score column
    byte-identical.  stream_pairs=3 forces multi-chunk streaming."""
    import ntsm_tpu.eval.tpu as T
    from ntsm_tpu.eval.exact import compute_score_all

    monkeypatch.setattr(T, "_auto_mesh", lambda: None)
    if stream_pairs is not None:
        monkeypatch.setattr(T, "STREAM_PAIRS", stream_pairs)
    opts = Options(all=all_flag, engine="tpu")
    tpu_out = io.StringIO()
    compute_score_all_tpu(data, opts, tpu_out)
    exact_out = io.StringIO()
    compute_score_all(data, opts, exact_out)
    tl = tpu_out.getvalue().splitlines()
    el = exact_out.getvalue().splitlines()
    assert len(tl) == len(el)
    assert tl[0] == el[0]
    for trow, erow in zip(tl[1:], el[1:]):
        tf = trow.split("\t")
        ef = erow.split("\t")
        assert tf[:2] == ef[:2]
        assert tf[3:] == ef[3:]
        assert float(tf[2]) == pytest.approx(float(ef[2]), abs=4e-6)


def test_packed_tile_boundary(rng):
    """N=97 spans two joint row tiles (ROW_TILE=64) with a padded tail:
    the device-side tile concatenation + triangle gather must agree with
    the full-matrix path on every pair."""
    import ntsm_tpu.eval.model as M

    N, L = 97, 300
    mc = rng.integers(0, 30, size=(N, L, 2)).astype(np.int64)
    mc[rng.random((N, L)) < 0.05] = 0
    data = M.CountData(
        filenames=[f"s{i}" for i in range(N)],
        locus_ids=[f"rs{i}" for i in range(L)],
        distinct=np.full((L, 2), 8, dtype=np.int64),
        max_counts=mc,
        sum_counts=mc * 2,
        raw_total_kmers=np.full(N, 5_000_000, dtype=np.int64),
        ks=np.full(N, 19, dtype=np.int64),
        total_counts=mc.sum(axis=(1, 2)),
    )
    opts = Options(genome_size=1_000_000)
    data.prepare(opts)
    full = compute_pair_stats_tpu(data, opts)
    packed = compute_pair_stats_tpu(data, opts, packed=True)
    iu, ju = np.triu_indices(N, 1)
    np.testing.assert_array_equal(packed["n"], full["n"][iu, ju])
    np.testing.assert_array_equal(packed["ibs0"], full["ibs0"][iu, ju])
    np.testing.assert_array_equal(packed["hets2"], full["hets1"][ju, iu])
    fs = full["score"][iu, ju]
    from ntsm_tpu.eval.exact import DBL_MAX

    finite = fs < DBL_MAX
    np.testing.assert_allclose(
        packed["score"][finite], fs[finite], rtol=1e-6, atol=1e-9
    )


def test_wire_u16_and_overflow_guard():
    """_wire: u8/u16 tiers for small counts, f32 passthrough in between,
    and a loud error (not silent rounding) past 2^24 where f32 loses
    integers."""
    from ntsm_tpu.eval.tpu import _wire

    tiny = np.array([[0.0, 255.0]], dtype=np.float32)
    assert _wire(tiny).dtype == np.uint8

    small = np.array([[0.0, 65535.0]], dtype=np.float32)
    assert _wire(small).dtype == np.uint16

    mid = np.array([[70000.0]], dtype=np.float32)
    out = _wire(mid)
    assert out.dtype == np.float32 and out[0, 0] == 70000.0

    huge = np.array([[2.0**24 + 2.0]], dtype=np.float64)
    with pytest.raises(ValueError, match="2\\^24"):
        _wire(huge)


def test_streaming_loader_blocks_cover_planes():
    """load_count_wires block_cb: contiguous [s0, s1) coverage, views
    that vstack back to the returned planes (pre-u8-downcast values)."""
    from ntsm_tpu.io.countfile import load_count_wires

    seen = []
    blocks_a, blocks_b = [], []

    def cb(s0, s1, wa_blk, wb_blk):
        seen.append((s0, s1))
        blocks_a.append(wa_blk.copy())
        blocks_b.append(wb_blk.copy())

    wires = load_count_wires(COUNT_FILES, block_cb=cb, block_rows=2)
    if wires is None:
        pytest.skip("native wire loader unavailable")
    assert seen == [(0, 2), (2, 4), (4, 5)]
    wa, wb = wires[2], wires[3]
    np.testing.assert_array_equal(
        np.vstack(blocks_a).astype(wa.dtype), wa
    )
    np.testing.assert_array_equal(
        np.vstack(blocks_b).astype(wb.dtype), wb
    )


def test_streaming_loader_output_parity(monkeypatch):
    """End-to-end -a output from load_count_data_eval (upload overlapped
    with the parse, multi-block) is byte-identical to the plain-loader
    path, and the device planes round-trip the wire values."""
    import functools

    import ntsm_tpu.eval.tpu as T
    from ntsm_tpu.eval.model import load_count_data as plain_load

    monkeypatch.setattr(T, "_auto_mesh", lambda: None)
    orig = T._upload_wires_streaming
    monkeypatch.setattr(
        T, "_upload_wires_streaming", functools.partial(orig, block_rows=2)
    )
    opts = Options(all=True, engine="tpu")
    d_stream = T.load_count_data_eval(COUNT_FILES, opts)
    if getattr(d_stream, "dev_planes", None) is None:
        pytest.skip("native wire loader unavailable")
    a_d, b_d = d_stream.dev_planes
    np.testing.assert_array_equal(np.asarray(a_d), d_stream.wire_at)
    np.testing.assert_array_equal(np.asarray(b_d), d_stream.wire_cg)

    d_plain = plain_load(COUNT_FILES, opts)
    s_out, p_out = io.StringIO(), io.StringIO()
    compute_score_all_tpu(d_stream, opts, s_out)
    compute_score_all_tpu(d_plain, opts, p_out)
    assert s_out.getvalue() == p_out.getvalue()


def test_streaming_loader_mixed_u8_u16_blocks(tmp_path, monkeypatch):
    """A cohort whose first sample fits u8 but a later one needs u16:
    per-block wires differ in dtype and the device concat widens to u16
    with values intact."""
    import functools

    import ntsm_tpu.eval.tpu as T
    from ntsm_tpu.io.countfile import format_counts

    rng = np.random.default_rng(5)
    L = 40
    ids = [f"rs{i}" for i in range(L)]
    distinct = np.full((L, 2), 7, dtype=np.int64)
    paths = []
    for s, top in enumerate([40, 300, 50]):
        mx = rng.integers(0, top, size=(L, 2)).astype(np.int64)
        if s == 1:
            mx[3, 0] = 300  # forces the u16 tier for this block
        sm = mx * 7
        text = format_counts(ids, mx, sm, distinct, int(mx.sum() * 100), 19)
        p = tmp_path / f"s{s}_counts.txt"
        p.write_text(text)
        paths.append(str(p))

    monkeypatch.setattr(T, "_auto_mesh", lambda: None)
    orig = T._upload_wires_streaming
    monkeypatch.setattr(
        T, "_upload_wires_streaming", functools.partial(orig, block_rows=1)
    )
    opts = Options(all=True, engine="tpu")
    d = T.load_count_data_eval(paths, opts)
    if getattr(d, "dev_planes", None) is None:
        pytest.skip("native wire loader unavailable")
    a_d, b_d = d.dev_planes
    assert a_d.dtype == np.uint16
    np.testing.assert_array_equal(np.asarray(a_d), d.wire_at)
    np.testing.assert_array_equal(np.asarray(b_d), d.wire_cg)


def test_streaming_loader_fallback_discards_blocks(tmp_path, monkeypatch):
    """A locus-reordered file makes the wire loader bail AFTER earlier
    blocks were already shipped: load_count_data_eval must fall back to
    the plain loaders (no dev_planes) and still produce correct output."""
    import functools

    import ntsm_tpu.eval.tpu as T

    src = [open(p).read() for p in COUNT_FILES[:3]]
    # reorder the data rows of the last sample (keep header lines first)
    lines = src[2].splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    rows = [ln for ln in lines if not ln.startswith("#")]
    reordered = "\n".join(head + rows[::-1]) + "\n"
    paths = []
    for i, text in enumerate([src[0], src[1], reordered]):
        p = tmp_path / f"s{i}_counts.txt"
        p.write_text(text)
        paths.append(str(p))

    monkeypatch.setattr(T, "_auto_mesh", lambda: None)
    orig = T._upload_wires_streaming
    monkeypatch.setattr(
        T, "_upload_wires_streaming", functools.partial(orig, block_rows=1)
    )
    opts = Options(all=True, engine="tpu")
    d = T.load_count_data_eval(paths, opts)
    assert getattr(d, "dev_planes", None) is None  # fell back
    # fallback output matches the plain loader on the original files
    # (row order within a count file must not matter)
    from ntsm_tpu.eval.model import load_count_data

    d_ref = load_count_data(COUNT_FILES[:3], opts)
    got, want = io.StringIO(), io.StringIO()
    compute_score_all_tpu(d, opts, got)
    compute_score_all_tpu(d_ref, opts, want)
    strip = lambda s: [ln.split("\t")[2:] for ln in s.splitlines()[1:]]
    assert strip(got.getvalue()) == strip(want.getvalue())


@pytest.mark.parametrize("all_flag", [True, False])
def test_stream_python_fallback_matches_native(data, monkeypatch, all_flag):
    """_emit_pair_chunk's per-row Python fallback (native lib absent)
    emits byte-identical rows to the native C formatter."""
    import ntsm_tpu.eval.tpu as T

    monkeypatch.setattr(T, "_auto_mesh", lambda: None)
    opts = Options(all=all_flag, engine="tpu")
    native_out = io.StringIO()
    compute_score_all_tpu(data, opts, native_out)
    monkeypatch.setattr(T, "_load_row_formatter", lambda: None)
    py_out = io.StringIO()
    compute_score_all_tpu(data, opts, py_out)
    assert py_out.getvalue() == native_out.getvalue()


def test_wide_wire_matches_narrow(data, monkeypatch):
    """Forcing the wide (all-f32) blob wire produces identical output to
    the narrow u16+highbit wire."""
    import ntsm_tpu.eval.tpu as T

    import ntsm_tpu.eval.blob as B

    monkeypatch.setattr(T, "_auto_mesh", lambda: None)
    opts = Options(all=True, engine="tpu")
    narrow_out = io.StringIO()
    compute_score_all_tpu(data, opts, narrow_out)
    monkeypatch.setattr(B, "NARROW_WIRE_MAX_SITES", 0)
    wide_out = io.StringIO()
    compute_score_all_tpu(data, opts, wide_out)
    assert wide_out.getvalue() == narrow_out.getvalue()


def test_narrow_wire_high_bit(tmp_path, monkeypatch):
    """A cohort with > 65536 sites drives statistics past u16 (n ~ 70000):
    the narrow wire's high-bit byte must reconstruct them exactly —
    integer columns identical to the exact engine."""
    import ntsm_tpu.eval.tpu as T
    from ntsm_tpu.eval.exact import compute_score_all
    from ntsm_tpu.eval.model import load_count_data
    from ntsm_tpu.io.countfile import format_counts

    rng = np.random.default_rng(11)
    L = 70000
    ids = [f"rs{i}" for i in range(L)]
    distinct = np.full((L, 2), 9, dtype=np.int64)
    paths = []
    for s in range(3):
        geno = rng.integers(0, 3, size=L)
        at = rng.poisson(12 * (2 - geno)).astype(np.int64)
        cg = rng.poisson(12 * geno).astype(np.int64)
        mx = np.stack([at, cg], axis=1)
        text = format_counts(ids, mx, mx * 9, distinct, int(mx.sum() * 50), 19)
        p = tmp_path / f"s{s}_counts.txt"
        p.write_text(text)
        paths.append(str(p))

    monkeypatch.setattr(T, "_auto_mesh", lambda: None)
    opts = Options(all=True, engine="tpu")
    d = load_count_data(paths, opts)
    tpu_out = io.StringIO()
    compute_score_all_tpu(d, opts, tpu_out)
    ex_out = io.StringIO()
    compute_score_all(load_count_data(paths, opts.replace(engine="exact")),
                      opts, ex_out)
    got = [ln.split("\t") for ln in tpu_out.getvalue().splitlines()[1:]]
    want = [ln.split("\t") for ln in ex_out.getvalue().splitlines()[1:]]
    assert len(got) == len(want) == 3
    hit_high = False
    for g, w in zip(got, want):
        assert g[3:] == w[3:]  # every column except score byte-identical
        hit_high = hit_high or int(g[15]) >= 65536  # n column
    assert hit_high, "cohort failed to exercise the 2^16 bit"


def test_negative_min_cov_pads_stay_invalid(rng):
    """-c -1 makes zero-count sites pass the strict `> minCov` test
    (CompareCounts.hpp:746) — including the device planes' chunk-pad
    columns, which don't exist in the reference.  The n_valid mask in
    _genotype_planes must keep pads out of every statistic so the device
    engines agree with the (unpadded) exact oracle."""
    import ntsm_tpu.eval.model as M
    import ntsm_tpu.eval.tpu as T

    N, L = 4, 20  # L far below CHUNK: 236 pad columns in play
    mx = rng.integers(0, 12, size=(N, L, 2)).astype(np.int64)
    for mc in (-1, 0):
        opts = Options(min_cov=mc, all=True, genome_size=1_000_000)
        data = M.CountData(
            filenames=[f"s{i}" for i in range(N)],
            locus_ids=[f"rs{i}" for i in range(L)],
            distinct=np.full((L, 2), 10, dtype=np.int64),
            max_counts=mx,
            sum_counts=mx * 3,
            raw_total_kmers=np.full(N, 10_000_000, dtype=np.int64),
            ks=np.full(N, 19, dtype=np.int64),
            total_counts=mx.sum(axis=(1, 2)),
        )
        data.prepare(opts)
        for packed in (False, True):
            st = compute_pair_stats_tpu(data, opts, packed=packed)
            for i, j in [(0, 1), (1, 3)]:
                score, n, rel = pair_score(data, i, j, opts)
                if packed:
                    import numpy as _np

                    k = int(_np.flatnonzero(
                        (st["iu"] == i) & (st["ju"] == j))[0])
                    assert int(st["n"][k]) == n
                    assert int(st["ibs0"][k]) == rel.ibs0
                    assert float(st["score"][k]) == pytest.approx(
                        score, rel=5e-6, abs=5e-6)
                else:
                    assert int(st["n"][i, j]) == n
                    assert int(st["ibs0"][i, j]) == rel.ibs0
                    assert float(st["score"][i, j]) == pytest.approx(
                        score, rel=5e-6, abs=5e-6)

        # the -p pair-block kernels share the pad-mask semantics; check
        # both generations (the fused v2 kernel is the production path)
        import jax.numpy as jnp

        from ntsm_tpu.eval.blob import _unpack_blob
        from ntsm_tpu.eval.kernels import (
            _chunk_planes,
            _pair_block_stats_v2,
            _pair_gather_g,
        )

        A, B = T._device_planes(data)
        blob = np.asarray(
            T._pair_block_stats(
                A, B, jnp.asarray(np.array([0], np.int32)),
                jnp.asarray(np.array([1], np.int32)),
                mc=float(mc), chunk=T.CHUNK, n_valid=data.n_sites,
            )
        )
        _, n_exact, _ = pair_score(data, 0, 1, opts)
        assert int(blob[0, 0]) == n_exact

        g = _pair_gather_g(A.shape[1])
        F_t = _chunk_planes(A, B, g)
        ll, iv, hi = _pair_block_stats_v2(
            F_t, jnp.asarray(np.array([0], np.int32)),
            jnp.asarray(np.array([1], np.int32)),
            mc=float(mc), n_valid=data.n_sites, narrow=True, g=g,
        )
        _, iv8 = _unpack_blob(
            np.asarray(ll), np.asarray(iv), np.asarray(hi)
        )
        assert int(iv8[0][0]) == n_exact


def test_packed_wide_tier_beyond_17_bits(rng):
    """n_sites > 131071 must select the wide (all-f32) blob tier — the
    narrow u16+high-bit wire only carries 17 bits per statistic.  The
    tier bound is the real site count, NOT any plane dimension (the
    chunked [C, N, c] layout's last dim is CHUNK)."""
    import ntsm_tpu.eval.model as M
    import ntsm_tpu.eval.tpu as T

    N, L = 3, T.NARROW_WIRE_MAX_SITES + 29  # 131100 sites
    mx = np.zeros((N, L, 2), dtype=np.int64)
    mx[:, :, 0] = 2  # every site valid at default -c 1: n = L > 2^17
    mx[:, :, 1] = 2
    data = M.CountData(
        filenames=[f"s{i}" for i in range(N)],
        locus_ids=[f"rs{i}" for i in range(L)],
        distinct=np.full((L, 2), 10, dtype=np.int64),
        max_counts=mx,
        sum_counts=mx * 3,
        raw_total_kmers=np.full(N, 10_000_000, dtype=np.int64),
        ks=np.full(N, 19, dtype=np.int64),
        total_counts=mx.sum(axis=(1, 2)),
    )
    opts = Options(all=True, genome_size=1_000_000)
    data.prepare(opts)
    st = compute_pair_stats_tpu(data, opts, packed=True)
    assert int(st["n"][0]) == L  # would be corrupt on the narrow wire
    score, n, rel = pair_score(data, 0, 1, opts)
    assert int(st["n"][0]) == n
    assert float(st["score"][0]) == pytest.approx(score, rel=5e-6, abs=5e-6)


def test_native_quantize_boundary_genotypes():
    """g hits the 0.25/0.75 thresholds EXACTLY (a=1,b=3 and a=3,b=1):
    the native one-sweep quantize must take the same sign-test branches
    as the numpy passes, bitwise."""
    import numpy as np

    import ntsm_tpu.eval.pca as P

    L = 640
    a = np.zeros((4, L), np.uint8)
    b = np.zeros((4, L), np.uint8)
    # row 0: g = 0.25 exactly; row 1: g = 0.75; row 2: g = 0.5; row 3: missing
    a[0], b[0] = 2, 6
    a[1], b[1] = 6, 2
    a[2], b[2] = 4, 4
    normv = np.linspace(0.1, 0.9, L)
    rotT = np.ascontiguousarray(
        np.linspace(-0.5, 0.5, L * 3).reshape(L, 3)
    )
    sc = P._ProjScratch(4, L, fast=True)
    o_native = np.empty((4, 3))
    P._project_rows(sc, a, b, normv, rotT, 1.0, o_native)
    real = P._quantize_vals_native
    try:
        P._quantize_vals_native = lambda *args: False
        sc2 = P._ProjScratch(4, L, fast=True)
        o_np = np.empty((4, 3))
        P._project_rows(sc2, a, b, normv, rotT, 1.0, o_np)
    finally:
        P._quantize_vals_native = real
    np.testing.assert_array_equal(
        o_native.view(np.uint64), o_np.view(np.uint64)
    )
