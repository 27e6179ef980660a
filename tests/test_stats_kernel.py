"""The device stats reductions (ops/stats.py) against independent
references: the native host histogram and exact integer sums."""

import numpy as np
import pytest

from fastx_toolkit_tpu.core import native
from fastx_toolkit_tpu.ops import stats as S

NAMES = ("count", "hist", "qsum", "qmin", "qmax")


def test_counts_only_matches_accumulate():
    import jax.numpy as jnp

    rng = np.random.default_rng(10)
    B, L = 64, 40
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(B, L))
    quals = rng.integers(0, 41, size=(B, L)).astype(np.int8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    counts = rng.integers(1, 7, B).astype(np.int32)
    want = S.accumulate(bases, quals, lengths, counts, is_fastq=True)[0]
    got = S.counts_only(jnp.asarray(bases), jnp.asarray(lengths), jnp.asarray(counts))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))


def test_counts_only_exact_for_large_multiplicities():
    """Collapsed-read counts far above 2**11 and column totals above
    2**24: a float32 (or TF32) product would round, the int32 sums must
    not."""
    rng = np.random.default_rng(12)
    B, L = 2048, 16
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(B, L))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    counts = rng.integers(2049, 1_000_000, B).astype(np.int32)
    got = np.asarray(S.counts_only(bases, lengths, counts)).astype(np.int64)
    valid = np.arange(L)[None, :] < lengths[:, None]
    w = np.where(valid, counts[:, None].astype(np.int64), 0)
    assert w.sum(axis=0).max() > 2**24
    np.testing.assert_array_equal(got[:, 0], w.sum(axis=0))
    for s, ch in enumerate(b"ACGTN", start=1):
        np.testing.assert_array_equal(
            got[:, s], np.where(bases == ch, w, 0).sum(axis=0), err_msg=chr(ch))


@pytest.mark.parametrize("L", [200, 1000])  # noqa: E741
def test_accumulate_jit_matches_native_histogram_long_reads(L):  # noqa: E741
    """The device scatter-add accumulation of fastx_quality_stats equals
    the host C++ histogram engine on long, variable-length reads."""
    if native.LIB is None:
        pytest.skip("native codec unavailable")
    rng = np.random.default_rng(L)
    B = 96
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(B, L))
    quals = rng.integers(-10, 60, size=(B, L)).astype(np.int8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[0] = L
    bases[np.arange(L)[None, :] >= lengths[:, None]] = 0
    counts = np.ones(B, np.int32)
    want = S.host_accumulate(bases, quals, lengths, counts, is_fastq=True)
    got = S.accumulate_jit(bases, quals, lengths, counts, is_fastq=True)
    for name, w, g in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(w, np.int64),
                                      np.asarray(g, np.int64), err_msg=name)


@pytest.mark.gpu
def test_accumulate_on_gpu_matches_cpu(gpu_device):
    """On a card: the scatter-add reduction equals the CPU backend's."""
    import jax

    rng = np.random.default_rng(16)
    B, L = 4096, 150
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(B, L))
    quals = rng.integers(-5, 45, size=(B, L)).astype(np.int8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    counts = rng.integers(1, 5000, B).astype(np.int32)
    args = (bases, quals, lengths, counts)
    got = S.accumulate_jit(*jax.device_put(args, gpu_device), is_fastq=True)
    want = S.accumulate_jit(*jax.device_put(args, jax.devices("cpu")[0]),
                            is_fastq=True)
    for name, w, g in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g), err_msg=name)
