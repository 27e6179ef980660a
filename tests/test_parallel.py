"""Multi-device tests on the virtual 8-device CPU mesh: sharded pipeline
and collective stats merges must match single-device results exactly."""

import jax
import numpy as np
import pytest

from fastx_toolkit_tpu.core import codec
from fastx_toolkit_tpu.engine.pipeline import to_device
from fastx_toolkit_tpu.ops import stats as stats_ops
from fastx_toolkit_tpu.parallel import data_mesh, shard_batch, sharded_pipeline, sharded_stats

from util import fixture

# these tests exercise the 8-way sharded programs on the virtual 8-device
# CPU mesh (conftest.py); chip_smoke.py --four value-checks the same
# programs on four GPUs
pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="needs 8 devices (virtual CPU mesh); real rig exposes 1 chip",
)


def _batch(n_copies=8):
    data = fixture("fastq_stats1.fastq") * n_copies
    b = codec.parse(data, filetype=codec.FASTQ_ONLY, q_offset=64)
    (bases, quals, lengths, counts), nb = to_device(b, pad=False)
    # pad rows to a multiple of 8 for even sharding
    B = bases.shape[0]
    Bp = -(-B // 8) * 8
    pad = Bp - B
    bases = np.pad(bases, ((0, pad), (0, 0)))
    quals = np.pad(quals, ((0, pad), (0, 0)))
    lengths = np.pad(lengths, (0, pad))
    counts = np.pad(counts, (0, pad))
    return bases, quals, lengths, counts


def test_devices():
    assert len(jax.devices()) >= 8


def test_sharded_stats_match_single():
    bases, quals, lengths, counts = _batch()
    mesh = data_mesh(8)
    sb = shard_batch(mesh, bases, quals, lengths, counts)
    merged = sharded_stats(mesh, *sb, is_fastq=True)
    single = stats_ops.accumulate(bases, quals, lengths, counts, is_fastq=True)
    for m, s in zip(merged, single):
        np.testing.assert_array_equal(np.asarray(m), np.asarray(s))


def test_sharded_pipeline_runs_and_matches():
    bases, quals, lengths, counts = _batch()
    mesh = data_mesh(8)
    fn = sharded_pipeline(
        mesh, adapter=b"CCTTAAGG", trim_last=30, filter_q=10, filter_p=50,
        trim_q=5, trim_minlen=10, mask_q=3, clip_minlen=5,
    )
    sb = shard_batch(mesh, bases, quals, lengths, counts)
    b, q, l, keep, stat = fn(*sb)
    assert np.asarray(keep).shape == (bases.shape[0],)

    mesh1 = data_mesh(1)
    fn1 = sharded_pipeline(
        mesh1, adapter=b"CCTTAAGG", trim_last=30, filter_q=10, filter_p=50,
        trim_q=5, trim_minlen=10, mask_q=3, clip_minlen=5,
    )
    sb1 = shard_batch(mesh1, bases, quals, lengths, counts)
    b1, q1, l1, keep1, stat1 = fn1(*sb1)
    np.testing.assert_array_equal(np.asarray(keep), np.asarray(keep1))
    np.testing.assert_array_equal(np.asarray(b), np.asarray(b1))
    np.testing.assert_array_equal(np.asarray(stat), np.asarray(stat1))


def test_sharded_packed_pipeline_matches_unpacked():
    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig, pack_batch2
    from fastx_toolkit_tpu.parallel import sharded_packed_pipeline

    bases, quals, lengths, counts = _batch()
    cfg = PipelineConfig(adapter=b"CCTTAAGG", trim_last=30, filter_q=10,
                         filter_p=50, trim_q=5, trim_minlen=10, mask_q=3,
                         clip_minlen=5, with_stats=True)
    mesh = data_mesh(8)
    fn = sharded_pipeline(
        mesh, adapter=b"CCTTAAGG", trim_last=30, filter_q=10, filter_p=50,
        trim_q=5, trim_minlen=10, mask_q=3, clip_minlen=5,
    )
    sb = shard_batch(mesh, bases, quals, lengths, counts)
    _, _, l_ref, keep_ref, stat_ref = fn(*sb)

    b2, planes = pack_batch2(bases, quals, cfg)
    pfn = sharded_packed_pipeline(mesh, cfg, seq_len=bases.shape[1])
    spb = shard_batch(mesh, b2, planes, lengths.astype(np.int16), counts)
    l, keep, stat = pfn(*spb)
    # unpacked zeroes lengths of dropped reads after the keep-mask; both
    # must agree on keep, surviving lengths, and the psum'd stats counts
    np.testing.assert_array_equal(np.asarray(keep), np.asarray(keep_ref))
    l_ref2 = np.where(np.asarray(keep_ref), np.asarray(l_ref), 0)
    got = np.where(np.asarray(keep), np.asarray(l), 0)
    np.testing.assert_array_equal(got, l_ref2)
    np.testing.assert_array_equal(np.asarray(stat), np.asarray(stat_ref))


def test_sharded_collapse_matches_single():
    from fastx_toolkit_tpu.ops import collapse as C
    from fastx_toolkit_tpu.parallel.mesh import sharded_collapse

    rng = np.random.default_rng(5)
    B, L = 64, 16
    seqs = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(8, L))
    bases = seqs[rng.integers(0, 8, B)]  # many duplicates
    counts = rng.integers(1, 5, B).astype(np.int32)
    words = C.pack_words(bases)
    first = np.arange(B, dtype=np.int32)

    uniq_idx, uniq_counts, uniq_first = C.collapse_batch(bases, counts)
    order = C.final_order(uniq_counts, uniq_first)
    want = sorted(zip(uniq_counts[order], uniq_first[order]))

    mesh = data_mesh(8)
    sw, sc, sf = (np.asarray(x) for x in sharded_collapse(
        mesh, *shard_batch(mesh, words, counts, first)))
    heads = sc > 0
    got = sorted(zip(sc[heads].astype(np.int64), sf[heads].astype(np.int64)))
    assert got == [(int(a), int(b)) for a, b in want]


def test_sharded_barcode_counts():
    from fastx_toolkit_tpu.parallel.mesh import sharded_barcode_counts

    rng = np.random.default_rng(6)
    B, L = 64, 20
    barcodes = np.zeros((2, 5), np.uint8)
    barcodes[0, :5] = np.frombuffer(b"GATCT", np.uint8)
    barcodes[1, :5] = np.frombuffer(b"ATCGT", np.uint8)
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    bases[:20, :5] = barcodes[0]
    bases[20:30, :5] = barcodes[1]
    lengths = np.full(B, L, np.int32)
    mesh = data_mesh(8)
    sb, sl = shard_batch(mesh, bases, lengths)
    ident, tally = sharded_barcode_counts(
        mesh, sb, sl, barcodes, np.array([5, 5], np.int32),
        np.array([0, 0], np.int32), bol=True, barcodes_length=5,
        mismatches=1, n_idents=2, ident_of_barcode=np.array([0, 1], np.int32),
    )
    tally = np.asarray(tally)
    assert tally[0] >= 20 and tally[1] >= 10
    assert tally.sum() == B


def test_collapse_hashed_matches_exact():
    """Hash-prefix sort dedup == exact lexsort dedup on duplicate-heavy
    and all-unique lanes (group-set equality: counts + first indices)."""
    from fastx_toolkit_tpu.ops import collapse as C

    rng = np.random.default_rng(11)
    for B, npool in ((256, 17), (128, 128)):
        L = 20
        pool = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(npool, L))
        bases = pool[rng.integers(0, npool, B)]
        counts = rng.integers(1, 5, B).astype(np.int32)
        words = C.pack_words(bases)
        first = np.arange(B, dtype=np.int32)

        pe, he, se, ce, fe = (np.asarray(x) for x in C.collapse(words, counts, first))
        ph, hh, sh, ch, fh, col = (
            np.asarray(x) for x in C.collapse_hashed(words, counts, first)
        )
        assert not bool(col)
        ne, nh = int(he.sum()), int(hh.sum())
        assert ne == nh
        want = sorted(zip(ce[:ne].tolist(), fe[:ne].tolist()))
        got = sorted(zip(ch[:nh].tolist(), fh[:nh].tolist()))
        assert want == got


def test_collapse_hashed_collision_flag_and_fallback():
    """With the weak-hash test hook every distinct adjacent pair is a
    'collision'; the flag must fire, and collapse_batch's fallback path
    must still produce the exact groups."""
    from fastx_toolkit_tpu.ops import collapse as C

    rng = np.random.default_rng(12)
    B, L = 64, 12
    pool = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(5, L))
    bases = pool[rng.integers(0, 5, B)]
    counts = np.ones(B, np.int32)
    words = C.pack_words(bases)
    first = np.arange(B, dtype=np.int32)
    *_, col = C.collapse_hashed(words, counts, first, weak_hash=True)
    assert bool(np.asarray(col))
    # sanity: the real hash does not flag this lane
    *_, col2 = C.collapse_hashed(words, counts, first)
    assert not bool(np.asarray(col2))

    # collapse_batch must be exact regardless (fallback covers collisions)
    uidx, ucnt, ufirst = C.collapse_batch(bases, counts)
    import collections

    truth = collections.Counter(map(bytes, bases))
    got = {bytes(bases[i]): int(c) for i, c in zip(uidx, ucnt)}
    assert got == dict(truth)


def test_collapse_batch_weak_hash_exercises_fallback(monkeypatch):
    """FASTX_COLLAPSE_WEAK_HASH must route collapse_batch itself through
    the collision re-run (the exact lexsort), and the re-run's groups
    must be exact — the fallback branch inside collapse_batch, not just
    the collision flag, is what this covers."""
    from fastx_toolkit_tpu.ops import collapse as C

    rng = np.random.default_rng(13)
    B, L = 48, 10
    pool = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(7, L))
    bases = pool[rng.integers(0, 7, B)]
    counts = rng.integers(1, 4, B).astype(np.int32)

    calls = []
    real = C.collapse_jit

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(C, "collapse_jit", spy)
    monkeypatch.setenv("FASTX_COLLAPSE_WEAK_HASH", "1")
    uidx, ucnt, _ = C.collapse_batch(bases, counts)
    assert calls, "weak-hash collision did not trigger the exact re-run"

    import collections

    truth = collections.Counter()
    for b, c in zip(bases, counts):
        truth[bytes(b)] += int(c)
    got = {bytes(bases[i]): int(c) for i, c in zip(uidx, ucnt)}
    assert got == dict(truth)

    # FASTX_COLLAPSE_EXACT routes straight to the exact engine
    calls.clear()
    monkeypatch.delenv("FASTX_COLLAPSE_WEAK_HASH")
    monkeypatch.setenv("FASTX_COLLAPSE_EXACT", "1")
    uidx2, ucnt2, _ = C.collapse_batch(bases, counts)
    assert calls
    got2 = {bytes(bases[i]): int(c) for i, c in zip(uidx2, ucnt2)}
    assert got2 == dict(truth)
