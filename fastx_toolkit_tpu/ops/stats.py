"""fastx_quality_stats as a device-side histogram reduction.

The reference accumulates, per cycle (position) and per nucleotide slot
(ALL/A/C/G/T/N), a counting-sort histogram over quality values plus
count/min/max/sum (/root/reference/src/fastx_quality_stats/fastx_quality_stats.c:94-216).
Here the whole accumulation is a batched scatter-add producing

* ``count [L, 6] int64``  — weighted by collapsed reads_count
* ``hist  [L, 6, 109] int64`` — weighted by reads_count (FASTQ only)
* ``qsum  [L, 6] int64``  — UNweighted sum of quality values; the reference
  adds ``quality_value`` once per *sequence* even for collapsed reads
  (fastx_quality_stats.c:200,206), a quirk we reproduce exactly
* ``qmin/qmax [L, 6] int32`` — also unweighted, init 100/-100

Partial results merge associatively (+ / min / max), so multi-host runs
just ``psum``/``pmin``/``pmax`` them (see fastx_toolkit_tpu.parallel).
Quantiles are computed from the merged histogram with the reference's
cumulative walk (get_nth_value, fastx_quality_stats.c:218-247).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.records import BaseCode

NUC_NAMES = ("ALL", "A", "C", "G", "T", "N")
NSLOTS = 6
NBINS = 109  # quality values -15..93 inclusive
MIN_Q = -15

# plain numpy: jit traces it as a constant; a module-level jnp
# array would initialize the XLA backend at import time, which
# must not happen before jax.distributed comes up on a pod
_STATS_LUT = np.asarray(BaseCode.STATS_INDEX)


@dataclasses.dataclass
class StatsAccumulator:
    """Host-side running totals over batches (numpy, merged with +/min/max)."""

    count: np.ndarray  # [L, 6] int64
    hist: np.ndarray  # [L, 6, 109] int64
    qsum: np.ndarray  # [L, 6] int64
    qmin: np.ndarray  # [L, 6] int32
    qmax: np.ndarray  # [L, 6] int32

    @classmethod
    def empty(cls, L: int) -> "StatsAccumulator":
        return cls(
            count=np.zeros((L, NSLOTS), np.int64),
            hist=np.zeros((L, NSLOTS, NBINS), np.int64),
            qsum=np.zeros((L, NSLOTS), np.int64),
            qmin=np.full((L, NSLOTS), 100, np.int32),
            qmax=np.full((L, NSLOTS), -100, np.int32),
        )

    def merge_partial(self, count, hist, qsum, qmin, qmax) -> None:
        L = count.shape[0]
        if L > self.count.shape[0]:
            grown = StatsAccumulator.empty(L)
            grown.merge_partial(self.count, self.hist, self.qsum, self.qmin, self.qmax)
            self.__dict__.update(grown.__dict__)
            L = count.shape[0]
        self.count[:L] += np.asarray(count)
        self.hist[:L] += np.asarray(hist)
        self.qsum[:L] += np.asarray(qsum)
        np.minimum(self.qmin[:L], np.asarray(qmin), out=self.qmin[:L])
        np.maximum(self.qmax[:L], np.asarray(qmax), out=self.qmax[:L])

    def num_cycles(self) -> int:
        nz = np.flatnonzero(self.count[:, 0] == 0)
        return int(nz[0]) if len(nz) else self.count.shape[0]


def accumulate(bases, quals, lengths, counts, *, is_fastq: bool):
    """One batch -> partial (count, hist, qsum, qmin, qmax), jit-friendly."""
    B, L = bases.shape
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    valid = col < lengths[:, None]
    nuc = jnp.asarray(_STATS_LUT)[bases.astype(jnp.int32)].astype(jnp.int32)
    w = jnp.where(valid, counts[:, None], 0).astype(jnp.int32)

    slot_all = jnp.broadcast_to((col * NSLOTS).astype(jnp.int32), (B, L))  # nuc slot 0
    slot_nuc = slot_all + nuc

    count = jnp.zeros(L * NSLOTS, jnp.int32)
    count = count.at[slot_all.ravel()].add(w.ravel())
    count = count.at[slot_nuc.ravel()].add(w.ravel())

    if not is_fastq:
        zero2 = jnp.zeros((L, NSLOTS), jnp.int32)
        return (
            count.reshape(L, NSLOTS),
            jnp.zeros((L, NSLOTS, NBINS), jnp.int32),
            zero2,
            jnp.full((L, NSLOTS), 100, jnp.int32),
            jnp.full((L, NSLOTS), -100, jnp.int32),
        )

    q = quals.astype(jnp.int32)
    qbin = jnp.clip(q - MIN_Q, 0, NBINS - 1)
    hslot_all = slot_all * NBINS + qbin
    hslot_nuc = slot_nuc * NBINS + qbin
    hist = jnp.zeros(L * NSLOTS * NBINS, jnp.int32)
    hist = hist.at[hslot_all.ravel()].add(w.ravel())
    hist = hist.at[hslot_nuc.ravel()].add(w.ravel())

    # sum/min/max are UNweighted (once per sequence)
    w1 = jnp.where(valid, q, 0).astype(jnp.int32)
    qsum = jnp.zeros(L * NSLOTS, jnp.int32)
    qsum = qsum.at[slot_all.ravel()].add(w1.ravel())
    qsum = qsum.at[slot_nuc.ravel()].add(w1.ravel())

    q_for_min = jnp.where(valid, q, 1000)
    q_for_max = jnp.where(valid, q, -1000)
    qmin = jnp.full(L * NSLOTS, 100, jnp.int32)
    qmin = qmin.at[slot_all.ravel()].min(q_for_min.ravel())
    qmin = qmin.at[slot_nuc.ravel()].min(q_for_min.ravel())
    qmax = jnp.full(L * NSLOTS, -100, jnp.int32)
    qmax = qmax.at[slot_all.ravel()].max(q_for_max.ravel())
    qmax = qmax.at[slot_nuc.ravel()].max(q_for_max.ravel())
    # padding contributed sentinel 1000/-1000 only at masked slots via the
    # where() above; but masked positions still scattered -> clamp back
    qmin = jnp.minimum(qmin, 100)
    qmax = jnp.maximum(qmax, -100)

    return (
        count.reshape(L, NSLOTS),
        hist.reshape(L, NSLOTS, NBINS),
        qsum.reshape(L, NSLOTS),
        qmin.reshape(L, NSLOTS),
        qmax.reshape(L, NSLOTS),
    )


accumulate_jit = jax.jit(accumulate, static_argnames=("is_fastq",))


# ---------------------------------------------------------------------------
# host-side report generation (exact integer semantics)
# ---------------------------------------------------------------------------

# The reference's histogram is bases_values_count[QUALITY_VALUES_RANGE]
# == int[108] (quality 93 would index one past the end); the walk
# (fastx_quality_stats.c:237-245) has NO bounds check, so on FASTA input
# (empty histograms, count > 0) it marches through the adjacent struct
# fields.  That memory is fully determined by the accumulator state plus
# the struct layout: fastx.h's `#pragma pack(1)` (fastx.h:61) is never
# popped and leaks into every file that includes it, so nucleotide_data
# is PACKED -- int min; int max; int count; unsigned long long sum;
# int bases_values_count[108]; -> 113 int32 slots, hist at int-offset 5 --
# 6 structs per cycle, 25000 cycles zero/100/-100-initialized
# (init_values, fastx_quality_stats.c:139-164).  _OOBView serves that
# int32 view so the emergent quantiles are reproduced exactly
# (verified differentially against the compiled reference).
_C_HIST_LEN = 108
_STRUCT_INTS = 113
_C_MAX_CYCLES = 25000


class _OOBView:
    """int32 view of the reference's cycles[] memory starting at one
    struct's bases_values_count[0]."""

    def __init__(self, acc: "StatsAccumulator", cyc: int, nuc: int):
        self.acc = acc
        self.base = (cyc * NSLOTS + nuc) * _STRUCT_INTS + 5
        self.limit = _C_MAX_CYCLES * NSLOTS * _STRUCT_INTS - self.base

    def __getitem__(self, pos: int) -> int:
        g = self.base + pos
        struct_idx, off = divmod(g, _STRUCT_INTS)
        cyc, nuc = divmod(struct_idx, NSLOTS)
        acc = self.acc
        in_acc = cyc < acc.count.shape[0]
        if off == 0:
            return int(acc.qmin[cyc, nuc]) if in_acc else 100
        if off == 1:
            return int(acc.qmax[cyc, nuc]) if in_acc else -100
        def as_i32(v):
            v &= 0xFFFFFFFF
            return v - 0x100000000 if v >= 0x80000000 else v

        if off == 2:
            return as_i32(int(acc.count[cyc, nuc])) if in_acc else 0
        if off == 3:
            return as_i32(int(acc.qsum[cyc, nuc])) if in_acc else 0
        if off == 4:
            return as_i32(int(acc.qsum[cyc, nuc]) >> 32) if in_acc else 0
        h = off - 5
        if not in_acc or h >= NBINS:
            return 0
        return int(acc.hist[cyc, nuc, h])


def _get_nth_value(acc: "StatsAccumulator", cyc: int, nuc: int, n: int) -> int:
    """The reference's counting-sort walk (fastx_quality_stats.c:218-247),
    including its out-of-bounds continuation for empty histograms."""
    if n == 0:
        return int(acc.qmin[cyc, nuc])
    arr = _OOBView(acc, cyc, nuc)
    pos = 0
    guard = arr.limit
    while n > 0 and pos < guard:
        v = arr[pos]
        if v > n:
            break
        n -= v
        pos += 1
        while pos < guard and arr[pos] == 0:
            pos += 1
    return pos + MIN_Q


def _fmt_mean(qsum: int, count: int) -> str:
    """%3.2f of sum/count; the reference hits 0.0/0.0 -> '-nan' for empty
    per-nucleotide slots (x86 SSE negative qNaN).

    The reference's ``sum`` field is ``unsigned long long``
    (fastx_quality_stats.c:120): a NEGATIVE per-slot total (possible,
    qualities go down to -15) wraps mod 2^64.  The ``%lld`` sum column
    reinterprets it back to the signed value, but the mean is computed
    from the UNSIGNED value — ``(double)sum/(double)count``
    (:305,:392) — so e.g. sum=-5, count=1 prints mean
    18446744073709551616.00.  Deterministic, so reproduced here
    (found by tests/fuzz_differential.py)."""
    if count == 0:
        return "-nan"
    if qsum < 0:
        qsum += 1 << 64  # the reference's unsigned wraparound
    return "%3.2f" % (float(qsum) / float(count))


def _slot_numbers(acc: StatsAccumulator, cyc: int, nuc: int):
    count = int(acc.count[cyc, nuc])
    qmin = int(acc.qmin[cyc, nuc])
    qmax = int(acc.qmax[cyc, nuc])
    qsum = int(acc.qsum[cyc, nuc])
    q1 = _get_nth_value(acc, cyc, nuc, count // 4)
    med = _get_nth_value(acc, cyc, nuc, count // 2)
    q3 = _get_nth_value(acc, cyc, nuc, count * 3 // 4)
    iqr = q3 - q1
    # C's IQR*3/2 truncates toward zero (matters only if IQR < 0)
    half3 = int(iqr * 3 / 2) if iqr < 0 else iqr * 3 // 2
    lw = qmin if (q1 - half3) < qmin else (q1 - half3)
    rw = qmax if (q3 + half3) > qmax else (q3 + half3)
    return count, qmin, qmax, qsum, q1, med, q3, iqr, lw, rw


def render_old_format(acc: StatsAccumulator) -> str:
    """print_old_statistics (fastx_quality_stats.c:349-417)."""
    out = [
        "column\tcount\tmin\tmax\tsum\tmean\tQ1\tmed\tQ3\tIQR\tlW\trW\t"
        "A_Count\tC_Count\tG_Count\tT_Count\tN_Count\tMax_count\n"
    ]
    ncyc = acc.num_cycles()
    max_count = int(acc.count[0, 0]) if ncyc else 0
    for i in range(ncyc):
        count, qmin, qmax, qsum, q1, med, q3, iqr, lw, rw = _slot_numbers(acc, i, 0)
        out.append(
            "%d\t%d\t%d\t%d\t%d\t%s\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\n"
            % (
                i + 1, count, qmin, qmax, qsum, _fmt_mean(qsum, count),
                q1, med, q3, iqr, lw, rw,
                int(acc.count[i, 1]), int(acc.count[i, 2]), int(acc.count[i, 3]),
                int(acc.count[i, 4]), int(acc.count[i, 5]), max_count,
            )
        )
    return "".join(out)


def render_new_format(acc: StatsAccumulator) -> str:
    """print_statistics, the -N format (fastx_quality_stats.c:316-344)."""
    hdr = ["cycle\tmax_count"]
    stat_names = ("count", "min", "max", "sum", "mean", "Q1", "med", "Q3", "IQR", "lW", "rW")
    for nuc in NUC_NAMES:
        for s in stat_names:
            hdr.append("\t%s_%s" % (nuc, s))
    out = ["".join(hdr) + "\n"]
    ncyc = acc.num_cycles()
    max_count = int(acc.count[0, 0]) if ncyc else 0
    for i in range(ncyc):
        row = ["%d\t%d" % (i + 1, max_count)]
        for nuc in range(NSLOTS):
            count, qmin, qmax, qsum, q1, med, q3, iqr, lw, rw = _slot_numbers(acc, i, nuc)
            row.append(
                "\t%d\t%d\t%d\t%d\t%s\t%d\t%d\t%d\t%d\t%d\t%d"
                % (count, qmin, qmax, qsum, _fmt_mean(qsum, count),
                   q1, med, q3, iqr, lw, rw)
            )
        out.append("".join(row) + "\n")
    return "".join(out)


def derive_from_hist(pernuc_hist: np.ndarray):
    """FASTQ statistics from the per-(pos, nuc, qval) histogram alone.

    get_reads_count is always 1 for FASTQ (fastx.c:479-481), so the
    weighted and unweighted accumulators coincide and count/qsum/min/max
    are exact functions of the histogram.  Slot 0 of the input counts
    unknown bytes (STATS_INDEX==0); the reference adds every base to ALL
    *and* to its nuc slot, so ALL = sum over slots + the slot-0 adds.
    Returns (count, hist, qsum, qmin, qmax) matching accumulate()'s
    layout.
    """
    pernuc_hist = np.asarray(pernuc_hist, dtype=np.int64)
    L = pernuc_hist.shape[0]
    hist = pernuc_hist.copy()
    hist[:, 0] = pernuc_hist.sum(axis=1) + pernuc_hist[:, 0]
    count = hist.sum(axis=2)
    vals = np.arange(MIN_Q, MIN_Q + NBINS, dtype=np.int64)
    qsum = (hist * vals[None, None, :]).sum(axis=2)
    nz = hist > 0
    any_nz = nz.any(axis=2)
    qmin = np.where(any_nz, vals[np.argmax(nz, axis=2)], 100).astype(np.int32)
    qmax = np.where(
        any_nz, vals[NBINS - 1 - np.argmax(nz[:, :, ::-1], axis=2)], -100
    ).astype(np.int32)
    return count, hist, qsum, qmin, qmax


def host_accumulate(bases, quals, lengths, counts, *, is_fastq: bool):
    """Host-native (C++) accumulation — identical results to accumulate().

    One int64 increment per base into the per-(cycle, nucleotide, quality)
    histogram (native/fastx_codec.cpp fx_stats_hist_q); everything else
    (ALL slot, count, sum, min, max) derives from it because FASTQ
    multiplicity is always 1 (fastx.c:479-481).  FASTA accumulates the
    weighted per-nucleotide counts only (the reference skips the quality
    block for FASTA, fastx_quality_stats.c:194)."""
    from ..core import native

    bases = np.ascontiguousarray(bases, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    if is_fastq:
        pernuc = native.stats_hist_q(
            bases, np.ascontiguousarray(quals, np.int8), lengths
        )
        return derive_from_hist(pernuc)
    pn = native.stats_counts(
        bases, lengths, np.ascontiguousarray(counts, np.int32)
    )
    L = pn.shape[0]
    count = pn.copy()
    count[:, 0] = pn.sum(axis=1) + pn[:, 0]
    return (
        count,
        np.zeros((L, NSLOTS, NBINS), np.int64),
        np.zeros((L, NSLOTS), np.int64),
        np.full((L, NSLOTS), 100, np.int32),
        np.full((L, NSLOTS), -100, np.int32),
    )


def stats_path() -> str:
    """'host' or 'device' accumulation for the stats CLI.

    FASTX_STATS_PATH=host|device overrides the shared backend policy
    (engine.policy).  Both paths produce bit-identical accumulators
    (tests/test_stats_kernel.py).
    """
    import os

    from ..engine import policy

    return policy.resolve("stats", os.environ.get("FASTX_STATS_PATH"))


def counts_only(bases, lengths, counts):
    """Per-cycle nucleotide counts [L, 6] without the quality histogram:
    masked int32 column sums, exact for any count (a float32 product
    could round above 2**24, or above 2**11 where a GPU runs it as TF32).
    Used by the fused pipeline's stats stage where only counts are
    consumed."""
    L = bases.shape[1]
    valid = jnp.arange(L, dtype=jnp.int32)[None, :] < lengths[:, None]
    nuc = jnp.asarray(_STATS_LUT)[bases.astype(jnp.int32)]
    w = jnp.where(valid, counts.astype(jnp.int32)[:, None], 0)
    per_slot = [jnp.sum(jnp.where(nuc == s, w, 0), axis=0, dtype=jnp.int32)
                for s in range(NSLOTS)]
    # the reference adds every base to ALL and to its slot; unknown bytes
    # have slot 0 == ALL, so ALL gets them twice
    all_c = jnp.sum(w, axis=0, dtype=jnp.int32) + per_slot[0]
    return jnp.stack([all_c] + per_slot[1:], axis=1)
