"""The packed upload path (4-bit bases + 1-bit quality planes) must make
exactly the decisions of the unpacked pipeline on every input."""

import numpy as np
import pytest

from fastx_toolkit_tpu.engine.pipeline import (
    PipelineConfig,
    decisions_pipeline,
    pack_batch,
    packed_decisions_pipeline,
)


def _random_batch(rng, b, l, *, with_n=True, lowercase=False):  # noqa: E741
    alphabet = b"ACGT" + (b"N" if with_n else b"")
    if lowercase:
        alphabet += b"acgtn"
    bases = rng.choice(np.frombuffer(alphabet, np.uint8), size=(b, l))
    quals = rng.integers(-15, 94, size=(b, l)).astype(np.int8)
    lengths = rng.integers(0, l + 1, size=b).astype(np.int32)
    cols = np.arange(l)[None, :]
    bases = np.where(cols < lengths[:, None], bases, 0).astype(np.uint8)
    quals = np.where(cols < lengths[:, None], quals, 0).astype(np.int8)
    counts = np.ones(b, np.int32)
    return bases, quals, lengths, counts


CFGS = [
    PipelineConfig(),
    PipelineConfig(adapter=b"GATCGGAAGAGC", filter_q=25, trim_q=12, mask_q=30,
                   filter_p=80, trim_minlen=10, clip_minlen=8, trim_last=40),
    PipelineConfig(with_stats=True),
]


@pytest.mark.parametrize("cfg_i", range(len(CFGS)))
@pytest.mark.parametrize("l", [100, 31, 8])  # noqa: E741
def test_packed_matches_unpacked(cfg_i, l):  # noqa: E741
    cfg = CFGS[cfg_i]
    rng = np.random.default_rng(cfg_i * 10 + l)
    bases, quals, lengths, counts = _random_batch(
        rng, 64, l, lowercase=(cfg_i == 1)
    )
    ref_len, ref_keep, ref_count = decisions_pipeline(cfg)(
        bases, quals, lengths, counts
    )
    b4, planes = pack_batch(bases, quals, cfg)
    fn = packed_decisions_pipeline(cfg, seq_len=l)
    args = (b4, planes, lengths) + ((counts,) if cfg.with_stats else ())
    got_len, got_keep, got_count = fn(*args)
    np.testing.assert_array_equal(np.asarray(ref_keep), np.asarray(got_keep))
    np.testing.assert_array_equal(np.asarray(ref_len), np.asarray(got_len))
    np.testing.assert_array_equal(np.asarray(ref_count), np.asarray(got_count))


@pytest.mark.parametrize("cfg_i", range(len(CFGS)))
@pytest.mark.parametrize("l", [100, 31, 8])  # noqa: E741
def test_packed2_matches_unpacked(cfg_i, l):  # noqa: E741
    from fastx_toolkit_tpu.engine.pipeline import chunk_is_acgtn, pack_batch2

    cfg = CFGS[cfg_i]
    rng = np.random.default_rng(cfg_i * 100 + l)
    bases, quals, lengths, counts = _random_batch(rng, 64, l)
    assert chunk_is_acgtn(bases)
    ref_len, ref_keep, ref_count = decisions_pipeline(cfg)(
        bases, quals, lengths, counts
    )
    b2, planes = pack_batch2(bases, quals, cfg)
    fn = packed_decisions_pipeline(cfg, seq_len=l, two_bit=True)
    args = (b2, planes, lengths) + ((counts,) if cfg.with_stats else ())
    got_len, got_keep, got_count = fn(*args)
    np.testing.assert_array_equal(np.asarray(ref_keep), np.asarray(got_keep))
    np.testing.assert_array_equal(np.asarray(ref_len), np.asarray(got_len))
    np.testing.assert_array_equal(np.asarray(ref_count), np.asarray(got_count))


def test_native_pack_matches_numpy():
    """The fused C++ pack kernels must be bit-identical to the numpy
    reference layout (which the device unpackers invert)."""
    from fastx_toolkit_tpu.core import native
    from fastx_toolkit_tpu.engine import pipeline as P

    if native.LIB is None:
        pytest.skip("native codec unavailable")

    rng = np.random.default_rng(7)
    for l in (100, 31, 8, 5):  # noqa: E741
        for lower in (False, True):
            bases, quals, lengths, _ = _random_batch(rng, 37, l, lowercase=lower)
            cfg = PipelineConfig(filter_q=25, trim_q=-3, mask_q=90)
            thr = P._thresholds(cfg)
            nb4, npl4 = native.pack4(bases, quals, thr)
            # numpy reference layouts (force the fallback path)
            codes = P._CODE_LUT[bases]
            if l % 2:
                codes = np.concatenate([codes, np.zeros((37, 1), np.uint8)], 1)
            rb4 = (codes[:, 0::2] << 4) | codes[:, 1::2]
            rpl4 = np.stack([np.packbits(quals < t, axis=1) for t in thr], 1)
            np.testing.assert_array_equal(nb4, rb4)
            np.testing.assert_array_equal(npl4, rpl4)
        bases, quals, lengths, _ = _random_batch(rng, 37, l)
        for n_plane in (False, True):
            nb2, npl2 = native.pack2(bases, quals, thr, n_plane)
            codes = np.clip(P._CODE_LUT[bases].astype(np.int16) - 1, 0, 3).astype(np.uint8)
            rem = (-l) % 4
            if rem:
                codes = np.concatenate([codes, np.zeros((37, rem), np.uint8)], 1)
            rb2 = ((codes[:, 0::4] << 6) | (codes[:, 1::4] << 4)
                   | (codes[:, 2::4] << 2) | codes[:, 3::4])
            head = [np.packbits(bases == ord("N"), axis=1)] if n_plane else []
            rpl2 = np.stack(head + [np.packbits(quals < t, axis=1) for t in thr], 1)
            np.testing.assert_array_equal(nb2, rb2)
            np.testing.assert_array_equal(npl2, rpl2)
        pure, has_n = native.scan_alphabet(bases)
        assert pure
        assert has_n == bool((bases == ord("N")).any())


def test_chunk_is_acgtn_rejects_other_letters():
    from fastx_toolkit_tpu.engine.pipeline import chunk_is_acgtn

    ok = np.frombuffer(b"ACGTN", np.uint8)[None, :].copy()
    assert chunk_is_acgtn(ok)
    for bad in b"Uax.":
        arr = ok.copy()
        arr[0, 2] = bad
        assert not chunk_is_acgtn(arr)


def test_pack_roundtrip_bases():
    from fastx_toolkit_tpu.engine.pipeline import _unpack4

    rng = np.random.default_rng(0)
    bases, quals, lengths, _ = _random_batch(rng, 16, 33, lowercase=True)
    cfg = PipelineConfig()
    b4, planes = pack_batch(bases, quals, cfg)
    got_b, got_lt = _unpack4(b4, planes)
    got_b = np.asarray(got_b)[:, : bases.shape[1]]
    np.testing.assert_array_equal(got_b, bases)
    lt = np.asarray(got_lt)[:, 0, : bases.shape[1]]
    np.testing.assert_array_equal(lt, quals < cfg.filter_q)


ADAPTER = b"CTGTAGGCACCATCAAT"
# BASELINE.json's config shapes (subsets of the headline chain)
CONFIG_MATRIX = {
    "headline": PipelineConfig(adapter=ADAPTER),
    "config1": PipelineConfig(
        adapter=ADAPTER, trim_last=80, with_filter=False, with_qtrim=False,
        with_mask=False, with_clip=False, with_artifacts=False,
        to_fasta_discard_n=True,
    ),
    "config2": PipelineConfig(adapter=ADAPTER, with_clip=False,
                              with_artifacts=False),
    "config4": PipelineConfig(
        adapter=ADAPTER, with_filter=False, with_qtrim=False,
        with_mask=False, clip_keep_n=False, clip_minlen=15,
    ),
    "artifacts_only": PipelineConfig(
        adapter=ADAPTER, with_filter=False, with_qtrim=False,
        with_mask=False, with_clip=False,
    ),
}


def _adapter_chunk(rng, B, L, with_n: bool):  # noqa: E741
    """Bench-like chunk: adapters spiked at random offsets, random
    lengths (0 included), zero bases and qualities beyond each length."""
    p = [0.24, 0.24, 0.24, 0.24, 0.04] if with_n else [0.25, 0.25, 0.25, 0.25]
    alpha = np.frombuffer(b"ACGTN" if with_n else b"ACGT", np.uint8)
    bases = rng.choice(alpha, size=(B, L), p=p)
    pos = rng.integers(0, max(1, L - 5), B)
    for j, ch in enumerate(ADAPTER):
        m = (rng.random(B) < 0.35) & (pos + j < L)
        bases[m, (pos + j)[m]] = ch
    quals = rng.integers(2, 41, size=(B, L)).astype(np.int8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    beyond = np.arange(L)[None, :] >= lengths[:, None]
    quals[beyond] = 0
    bases[beyond] = 0
    return bases, quals, lengths


def _check_packed2_vs_unpacked(cfg, bases, quals, lengths, with_n):
    ref_len, ref_keep, _ = decisions_pipeline(cfg)(
        bases, quals, lengths, np.ones(len(lengths), np.int32)
    )
    from fastx_toolkit_tpu.engine.pipeline import pack_batch2

    b2, planes = pack_batch2(bases, quals, cfg, n_plane=with_n)
    fn = packed_decisions_pipeline(cfg, two_bit=True, has_n_plane=with_n)
    got_len, got_keep, _ = fn(b2, planes, lengths.astype(np.int16))
    np.testing.assert_array_equal(np.asarray(ref_keep), np.asarray(got_keep))
    np.testing.assert_array_equal(np.asarray(ref_len), np.asarray(got_len))


@pytest.mark.parametrize("cfg_name", sorted(CONFIG_MATRIX))
@pytest.mark.parametrize("with_n", [False, True])
def test_packed2_config_matrix_matches_unpacked(cfg_name, with_n):
    """Every BASELINE config shape, with and without the N plane: the
    2-bit packed decisions body decides exactly like the unpacked one."""
    rng = np.random.default_rng(sorted(CONFIG_MATRIX).index(cfg_name) * 2 + with_n)
    bases, quals, lengths = _adapter_chunk(rng, 256, 72, with_n)
    _check_packed2_vs_unpacked(CONFIG_MATRIX[cfg_name], bases, quals,
                               lengths, with_n)


def test_packed2_trim_boundaries():
    """Lengths around the plane-byte boundaries (8/16) through the
    packed quality trimmer."""
    rng = np.random.default_rng(7)
    B, L = 256, 24  # noqa: E741
    lengths = np.tile([0, 1, 7, 8, 9, 15, 16, 17, 23, 24, 3, 20, 24, 24, 24, 24],
                      B // 16).astype(np.int32)
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    quals = rng.integers(2, 41, size=(B, L)).astype(np.int8)
    beyond = np.arange(L)[None, :] >= lengths[:, None]
    bases[beyond] = 0
    quals[beyond] = 0
    _check_packed2_vs_unpacked(CONFIG_MATRIX["config2"], bases, quals,
                               lengths, False)
