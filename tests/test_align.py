"""Differential tests: batched integer DP vs the float32 numpy oracle
transcribing the reference's sequence_alignment.cpp."""

import numpy as np
import pytest

from fastx_toolkit_tpu.kernels import align

FIELDS = (
    "matches", "mismatches", "gaps", "neutral",
    "query_start", "query_end", "target_start", "target_end",
)


def _oracle_fields(q, t, exact=False):
    r = align.align_oracle(q, t, exact=exact)
    return dict(
        matches=r.matches, mismatches=r.mismatches, gaps=r.gaps,
        neutral=r.neutral_matches, query_start=r.query_start,
        query_end=r.query_end, target_start=r.target_start,
        target_end=r.target_end,
    )


def _batchify(reads, pad_to=None):
    L = pad_to or max(len(r) for r in reads)
    bases = np.zeros((len(reads), L), np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        bases[i, : len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    return bases, lengths


def _check(reads, adapter):
    """N-free reads: float32 oracle is exact -> must match bit-for-bit.
    Reads with N: float accumulation noise makes the reference's argmax
    tie-break nondeterministic, so those compare against the exact-decimal
    oracle (see align_oracle docstring)."""
    bases, lengths = _batchify(reads)
    out = {k: np.asarray(v) for k, v in align.align_batch(bases, lengths, adapter).items()}
    for i, r in enumerate(reads):
        want = _oracle_fields(r, adapter, exact=(b"N" in r))
        got = {k: int(out[k][i]) for k in FIELDS}
        assert got == want, f"read {i} ({r}): got {got} want {want}"


def test_exact_adapter_suffix():
    _check([b"ACGTACGTACCCTTAAGG", b"CCTTAAGGACGTACGTAC"], b"CCTTAAGG")


def test_random_uniform_length():
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    adapter = b"CAATTGGTTAATCCCCCTATATA"
    reads = [bytes(rng.choice(alpha, size=36)) for _ in range(200)]
    _check(reads, adapter)


def test_random_adapter_embedded():
    rng = np.random.default_rng(1)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    adapter = b"CTGTAGGCACCATCAAT"
    reads = []
    for _ in range(100):
        pos = int(rng.integers(0, 30))
        pre = bytes(rng.choice(alpha, size=pos))
        # adapter with sprinkled errors
        ad = bytearray(adapter)
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(0, len(ad)))
            ad[j] = int(rng.choice(alpha))
        read = (pre + bytes(ad) + bytes(rng.choice(alpha, size=10)))[:36]
        reads.append(read.ljust(36, b"A"))
    _check(reads, adapter)


def test_mixed_lengths():
    rng = np.random.default_rng(2)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    adapter = b"CCTTAAGG"
    reads = [bytes(rng.choice(alpha, size=int(rng.integers(5, 64)))) for _ in range(100)]
    _check(reads, adapter)


def test_short_adapter_and_reads():
    _check([b"A", b"AC", b"CCTT"], b"CCTTAAGG")
    _check([b"ACGTACGT"], b"AC")


@pytest.mark.slow
def test_random_large_batch():
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    adapter = b"CAATTGGTTAATCCCCCTATATA"
    reads = [bytes(rng.choice(alpha, size=int(rng.integers(10, 100)))) for _ in range(300)]
    _check(reads, adapter)


def _adversarial_batch(adapter, L, n_frac, B=64):  # noqa: E741
    """Reads with noisy adapters spiked into every third row, Ns at rate
    ``n_frac`` and random lengths including 0 (zero-padded)."""
    rng = np.random.default_rng(L + len(adapter))
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    p = [(1 - n_frac) / 4] * 4 + [n_frac]
    bases = rng.choice(alpha, size=(B, L), p=p)
    for i in range(0, B, 3):
        pos = int(rng.integers(0, max(1, L - len(adapter))))
        ad = bytearray(adapter)
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(0, len(ad)))
            ad[j] = int(rng.choice(alpha[:4]))
        bases[i, pos:pos + len(ad)] = np.frombuffer(bytes(ad), np.uint8)[:L - pos]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    bases[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return bases, lengths


@pytest.mark.parametrize("tie_flag", [False, True])
@pytest.mark.parametrize("adapter,L,n_frac", [  # noqa: E741
    (b"CTGTAGGCACCATCAAT", 100, 0.05),          # headline shape
    (b"CCTTAAGGCCTTAAGGCCTTAAGGCCTTAAG", 100, 0.05),  # 31-mer adapter
    (b"CTGTAGGCACCATCAAT", 511, 0.03),          # long reads
    (b"CCTTAAGG", 8, 0.2),                      # tiny reads
    (b"CTGTAGGCACCATCAAT", 100, 0.0),           # N-free
])
def test_align_batch_matches_exact_oracle(adapter, L, n_frac, tie_flag):  # noqa: E741
    """align_batch, with the tie flag on and off, against the exact
    decimal oracle on adversarial batches (length-0 rows included).
    Rows the tie flag leaves clear must also match the float32 oracle,
    which transcribes the reference's own arithmetic; N-free reads with
    an ACGT adapter have no neutral score, so none can be flagged."""
    bases, lengths = _adversarial_batch(adapter, L, n_frac)
    out = {k: np.asarray(v) for k, v in
           align.align_batch(bases, lengths, adapter, tie_flag=tie_flag).items()}
    assert ("tie_fragile" in out) == tie_flag
    for i in np.flatnonzero(lengths):  # the oracle takes no empty read
        r = bases[i, : lengths[i]].tobytes()
        got = {k: int(out[k][i]) for k in FIELDS}
        assert got == _oracle_fields(r, adapter, exact=True), (i, r)
        if tie_flag and not out["tie_fragile"][i]:
            assert got == _oracle_fields(r, adapter), (i, r)
    if tie_flag and n_frac == 0.0:
        assert not out["tie_fragile"].any()


def test_length0_padding_rows_are_inert():
    """Length-0 rows appended to a batch (how fixed-shape dispatches pad
    their tails) must not disturb the real rows' results."""
    rng = np.random.default_rng(23)
    B, L = 100, 40
    adapter = b"CCTTAAGG"
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(B, L))
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    bases[np.arange(L)[None, :] >= lengths[:, None]] = 0
    pad_b = np.concatenate([bases, np.zeros((28, L), np.uint8)])
    pad_l = np.concatenate([lengths, np.zeros(28, np.int32)])
    out = {k: np.asarray(v)[:B] for k, v in
           align.align_batch(pad_b, pad_l, adapter, tie_flag=True).items()}
    ref = {k: np.asarray(v) for k, v in
           align.align_batch(bases, lengths, adapter, tie_flag=True).items()}
    for k in ref:
        np.testing.assert_array_equal(ref[k], out[k], err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("tie_flag", [False, True])
def test_align_batch_on_gpu_matches_cpu(gpu_device, tie_flag):
    """On a card: the DP's int32 results equal the CPU backend's."""
    import jax

    bases, lengths = _adversarial_batch(b"CTGTAGGCACCATCAAT", 100, 0.05, B=4096)
    cpu = jax.devices("cpu")[0]
    got = align.align_batch_jit(*jax.device_put((bases, lengths), gpu_device),
                                adapter=b"CTGTAGGCACCATCAAT", tie_flag=tie_flag)
    want = align.align_batch_jit(*jax.device_put((bases, lengths), cpu),
                                 adapter=b"CTGTAGGCACCATCAAT", tie_flag=tie_flag)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), np.asarray(got[k]),
                                      err_msg=k)
