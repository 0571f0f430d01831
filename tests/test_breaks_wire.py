"""The breaks wire: row_len + explicit invalid
positions replaces the [L/8] validity bitmask on the single-device v3
upload path.  Pins (1) bitwise (codes, valid) parity of the device
unpack against the legacy vbits unpack, (2) the N-rich sidecar
overflow -> legacy fallback, and (3) end-to-end engine parity with
golden under both wires, including a mixed-wire stream."""

import numpy as np
import pytest

from ntsm_tpu.count.engine import EngineConfig, run_count_v3
from ntsm_tpu.count.golden import count_files
from ntsm_tpu.count.kernel_v2 import (
    SIDE_BYTES,
    SIDE_MAXB,
    unpack_codes,
    unpack_codes_breaks,
    window_hashes_breaks,
    window_hashes_packed,
)
from ntsm_tpu.count.kernel_v3 import breaks_sidecar
from ntsm_tpu.count.kernel_v2 import pack_batch
from ntsm_tpu.io.sites import load_site_table
from ntsm_tpu.options import Options
from tests.synth import make_reads_fastq, make_site_fasta


def _random_rows(rng, B=32, L=128, n_prob=0.02):
    """Rows shaped like the dense packer's output: bases up to a random
    row_len, code-4 separators/Ns inside, pad-4 tail beyond."""
    codes = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int32)
    for r in range(B):
        ln = int(rng.integers(0, L + 1))
        lengths[r] = ln
        codes[r, :ln] = rng.integers(0, 4, ln)
        # sprinkle separators/Ns inside the row
        n_inv = int(rng.binomial(ln, n_prob))
        if n_inv:
            pos = rng.choice(ln, size=min(n_inv, ln), replace=False)
            codes[r, pos] = 4
    return codes, lengths


def test_unpack_breaks_bitwise_parity(rng):
    codes, lengths = _random_rows(rng, B=48, L=256, n_prob=0.015)
    packed, vbits = pack_batch(codes)
    side = breaks_sidecar(codes, lengths)
    assert side is not None and side.shape == (48, SIDE_BYTES)
    c1, v1 = (np.asarray(x) for x in unpack_codes(packed, vbits, 256))
    c2, v2 = (np.asarray(x) for x in unpack_codes_breaks(packed, side, 256))
    np.testing.assert_array_equal(c2, c1)
    np.testing.assert_array_equal(v2, v1)
    h1, w1 = (np.asarray(x) for x in window_hashes_packed(packed, vbits, 19, 256))
    h2, w2 = (np.asarray(x) for x in window_hashes_breaks(packed, side, 19, 256))
    np.testing.assert_array_equal(w2, w1)
    # hashes only need to agree where the window is valid
    np.testing.assert_array_equal(h2[w2], h1[w1])


def test_sidecar_overflow_returns_none(rng):
    codes, lengths = _random_rows(rng, B=8, L=128, n_prob=0.0)
    # force > SIDE_MAXB invalids into one in-length stretch
    lengths[3] = 120
    codes[3, :120] = rng.integers(0, 4, 120)
    codes[3, 5 : 5 + SIDE_MAXB + 1] = 4
    assert breaks_sidecar(codes, lengths) is None


def test_sidecar_exactly_maxb_ok(rng):
    codes, lengths = _random_rows(rng, B=4, L=128, n_prob=0.0)
    lengths[0] = 100
    codes[0, :100] = rng.integers(0, 4, 100)
    codes[0, 10 : 10 + SIDE_MAXB] = 4
    side = breaks_sidecar(codes, lengths)
    assert side is not None
    packed, vbits = pack_batch(codes)
    _, v1 = (np.asarray(x) for x in unpack_codes(packed, vbits, 128))
    _, v2 = (np.asarray(x) for x in unpack_codes_breaks(packed, side, 128))
    np.testing.assert_array_equal(v2, v1)


def _world(rng, tmp_path, n_prob=0.0, coverage=8):
    sites_path = str(tmp_path / "sites.fa")
    _, sites = make_site_fasta(rng, n_sites=24, path=sites_path)
    fq = str(tmp_path / "reads.fq")
    make_reads_fastq(rng, sites, coverage=coverage, genotype="het", path=fq)
    if n_prob:
        # inject Ns into half the reads so some rows overflow the sidecar
        lines = open(fq).read().splitlines()
        for i in range(1, len(lines), 8):  # every other read's seq line
            seq = np.frombuffer(lines[i].encode(), np.uint8).copy()
            seq[rng.random(seq.size) < n_prob] = ord("N")
            lines[i] = seq.tobytes().decode()
        open(fq, "w").write("\n".join(lines) + "\n")
    table = load_site_table(sites_path, k=19, allow_dupes=False)
    return table, fq


def test_engine_breaks_vs_vbits_identical(rng, tmp_path, monkeypatch):
    table, fq = _world(rng, tmp_path)
    golden = count_files(table, [fq])
    cfg = EngineConfig(batch_reads=64, segment_len=128)
    res_b = run_count_v3(table, [fq], Options(), cfg)
    monkeypatch.setenv("NTSM_VBITS_WIRE", "1")
    res_v = run_count_v3(table, [fq], Options(), cfg)
    for res in (res_b, res_v):
        np.testing.assert_array_equal(res.counts, golden.counts)
        assert res.total_kmers == golden.total_kmers
        assert res.total_hits == golden.total_hits


def test_engine_mixed_wire_stream(rng, tmp_path):
    """N-rich reads overflow the sidecar mid-stream: some batches ride
    the breaks wire, some fall back to vbits, counts still exact."""
    table, fq = _world(rng, tmp_path, n_prob=0.3, coverage=10)
    golden = count_files(table, [fq])
    cfg = EngineConfig(batch_reads=32, segment_len=128)
    res = run_count_v3(table, [fq], Options(), cfg)
    np.testing.assert_array_equal(res.counts, golden.counts)
    assert res.total_kmers == golden.total_kmers


def test_checkpoint_cadence_survives_wire_flip(rng, tmp_path):
    """A mid-stream breaks->vbits flip flushes a partial group and
    shifts batch_idx off the AGG grid; snapshots must keep firing (the
    engine uses a boundary-crossing check, not `% every == 0`)."""
    table, fq = _world(rng, tmp_path, n_prob=0.3, coverage=40)
    golden = count_files(table, [fq])
    ckpt = str(tmp_path / "snap.npz")
    cfg = EngineConfig(
        batch_reads=16, segment_len=128, checkpoint_path=ckpt,
        checkpoint_every=4,  # divisible by AGG=4 -> group_exec stays on
    )
    res = run_count_v3(table, [fq], Options(), cfg)
    np.testing.assert_array_equal(res.counts, golden.counts)
    with np.load(ckpt) as z:
        n_snap = int(z["n_batches"])
    # the stream must have spanned several checkpoint boundaries and the
    # LAST snapshot must come from beyond the first flip (i.e. cadence
    # did not die after the partial-group flush)
    assert n_snap >= 8, n_snap


def test_segments_past_u16_keep_the_vbits_wire(rng, tmp_path):
    """The sidecar's row_len and positions are u16 with a 0xFFFF pad
    sentinel, so a 65536-slot segment cannot ride the breaks wire; the
    engine keeps vbits for it and long reads still count exactly."""
    sites_path = str(tmp_path / "sites.fa")
    _, sites = make_site_fasta(rng, n_sites=6, path=sites_path)
    fq = str(tmp_path / "long.fq")
    make_reads_fastq(rng, sites, coverage=2, read_len=70000,
                     n_noise_reads=1, path=fq)
    table = load_site_table(sites_path, k=19, allow_dupes=False)
    golden = count_files(table, [fq])
    cfg = EngineConfig(batch_reads=2, segment_len=65536)
    res = run_count_v3(table, [fq], Options(), cfg)
    np.testing.assert_array_equal(res.counts, golden.counts)
    assert res.total_kmers == golden.total_kmers
    assert res.total_hits == golden.total_hits
