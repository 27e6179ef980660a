"""Host<->device batch plumbing + the fused preprocessing pipeline.

Keeps jit recompiles bounded by padding every batch to bucketed static
shapes: B to the next power of two (>=16), L to a multiple of 32.  Padding
rows have length 0 (all-PAD) and count 0 so masked transforms and
reductions ignore them by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.records import ReadBatch
from ..ops import stats as stats_ops
from ..ops import transforms
from ..ops.clipper import clip_batch


def bucket_shape(b: int, l: int) -> tuple[int, int]:  # noqa: E741
    bb = 16
    while bb < b:
        bb *= 2
    ll = max(32, -(-l // 32) * 32)
    return bb, ll


def to_device(batch: ReadBatch, *, pad: bool = True):
    """ReadBatch -> (bases, quals, lengths, counts) padded numpy arrays
    ready for jnp; returns (arrays, real_B)."""
    b, l = batch.bases.shape  # noqa: E741
    if pad:
        bb, ll = bucket_shape(max(b, 1), max(l, 1))
    else:
        bb, ll = b, l
    bases = np.zeros((bb, ll), dtype=np.uint8)
    quals = np.zeros((bb, ll), dtype=np.int8)
    bases[:b, :l] = batch.bases
    quals[:b, :l] = batch.quals
    lengths = np.zeros(bb, dtype=np.int32)
    lengths[:b] = batch.lengths
    counts = np.zeros(bb, dtype=np.int32)
    counts[:b] = batch.counts
    return (bases, quals, lengths, counts), b


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Parameters of the flagship fused preprocessing step (the
    BASELINE.json headline config: trim + quality filter/trim/mask +
    adapter clip + artifacts filter + stats reduction)."""

    adapter: bytes = b"CTGTAGGCACCATCAAT"
    trim_last: int = 0
    filter_q: int = 20
    filter_p: int = 50
    trim_q: int = 20
    trim_minlen: int = 0
    mask_q: int = 20
    clip_minlen: int = 5
    # include the per-cycle stats reduction in the fused step (the
    # reference's headline chain has no stats stage; scatter-adds are the
    # most expensive non-DP op, so bench parity keeps this off)
    with_stats: bool = False
    # stage toggles: BASELINE.json's configs 1/2/4 are subsets of the
    # headline chain; disabling a quality stage also removes its
    # threshold bit-plane from the packed upload (see _thresholds)
    with_filter: bool = True
    with_qtrim: bool = True
    with_mask: bool = True
    with_clip: bool = True
    with_artifacts: bool = True
    # fastx_clipper -n (keep reads with N); the headline chain runs the
    # clipper after the masker, whose output the reference pipes with -n
    clip_keep_n: bool = True
    # trailing fastq_to_fasta stage: default-discard reads containing N
    # (fastq_to_fasta.c:81-82); rendering as FASTA is the caller's job
    to_fasta_discard_n: bool = False


def pipeline_body(bases, quals, lengths, counts, cfg: PipelineConfig,
                  psum_axis: Optional[str] = None, tie_flag: bool = False):
    """One fused device step over a read batch: every per-read tool of the
    reference applied back-to-back with no host round-trips, plus the
    per-cycle count reduction (psum'd over ``psum_axis`` when running
    under shard_map)."""
    b, q, l, c = bases, quals, lengths, counts  # noqa: E741
    b, q, l, keep = transforms.trimmer(b, q, l, last=cfg.trim_last)  # noqa: E741
    if cfg.with_filter:
        keep &= transforms.quality_filter_keep(
            q, l, min_quality=cfg.filter_q, min_percent=cfg.filter_p
        )
    if cfg.with_qtrim:
        b, q, l, k2 = transforms.quality_trimmer(  # noqa: E741
            b, q, l, threshold=cfg.trim_q, min_len=cfg.trim_minlen
        )
        keep &= k2
    if cfg.with_mask:
        b, _, _ = transforms.masker(b, q, l, threshold=cfg.mask_q, mask_char=ord("N"))
    fragile = jnp.zeros(b.shape[0], bool)
    if cfg.with_clip:
        out = clip_batch(
            b, q, l, adapter=cfg.adapter, min_length=cfg.clip_minlen, keep_delta=0,
            discard_non_clipped=False, discard_clipped=False, keep_n=cfg.clip_keep_n,
            show_adapter_only=False, min_adapter_len=0, tie_flag=tie_flag,
        )
        if tie_flag:
            b, q, l, wrote, _cat, fragile = out  # noqa: E741
        else:
            b, q, l, wrote, _cat = out  # noqa: E741
        keep &= wrote
    if cfg.with_artifacts:
        keep &= transforms.artifacts_keep(b, l)
    if cfg.to_fasta_discard_n:
        keep &= ~transforms.contains_n(b, l)
    l = jnp.where(keep, l, 0)  # noqa: E741
    if cfg.with_stats:
        count = stats_ops.counts_only(b, l, c)
    else:
        count = jnp.zeros((b.shape[1], stats_ops.NSLOTS), jnp.int32)
    if psum_axis is not None:
        count = jax.lax.psum(count, psum_axis)
    if tie_flag:
        return b, q, l, keep, count, fragile
    return b, q, l, keep, count


def fused_pipeline(cfg: PipelineConfig):
    """Single-device jitted pipeline step."""

    def step(bases, quals, lengths, counts):
        return pipeline_body(bases, quals, lengths, counts, cfg)

    return jax.jit(step)


# ---------------------------------------------------------------------------
# Packed upload path: 4-bit base codes + 1-bit quality planes
# ---------------------------------------------------------------------------
#
# The upload of the raw batch (1 byte/base + 1 byte/qual) is the largest
# transfer of the pipeline.  But the decisions pipeline never needs raw
# quality values on device:
#
# * quality_filter: "the n-th smallest quality >= q" is equivalent to
#   "|{qual < q}| <= n" (see quality_filter_keep), so a `qual < q` bit
#   suffices;
# * quality_trimmer / masker compare against a static threshold — again
#   one bit per base;
# * bases draw from the reference's allowed alphabet (ACGTN + optional
#   U/lowercase, fastx.c:56-84) — at most 12 letters + PAD = 4 bits.
#
# So the host ships 4 bits/base + one bit-plane per distinct threshold
# (~0.5+0.125*t bytes/base instead of 2), and the device unpacks with a
# few shift/mask ops.  Byte-level edits (masking) are re-applied on
# host during rendering exactly as in the unpacked decisions path.

_ALPHABET = b"ACGTNUacgtnu"
_CODE_LUT = np.zeros(256, np.uint8)
for _i, _ch in enumerate(_ALPHABET, start=1):
    _CODE_LUT[_ch] = _i
_ASCII_LUT = np.zeros(16, np.uint8)
_ASCII_LUT[1 : len(_ALPHABET) + 1] = np.frombuffer(_ALPHABET, np.uint8)


def _thresholds(cfg: PipelineConfig) -> tuple[int, ...]:
    ts = []
    if cfg.with_filter:
        ts.append(cfg.filter_q)
    if cfg.with_qtrim:
        ts.append(cfg.trim_q)
    if cfg.with_mask:
        ts.append(cfg.mask_q)
    return tuple(dict.fromkeys(ts))


# 2-bit variant: when a chunk is pure uppercase ACGTN (codes 0..5 — the
# overwhelmingly common case for sequencer output), bases fit in 2 bits
# with Ns carried as one extra bit-plane alongside the quality planes.
_IS_ACGTN = np.zeros(256, bool)
for _ch in b"\0ACGTN":
    _IS_ACGTN[_ch] = True


def chunk_is_acgtn(bases: np.ndarray) -> bool:
    """True iff every byte is PAD/A/C/G/T/N (the 2-bit pack domain)."""
    return scan_alphabet(bases)[0]


def scan_alphabet(bases: np.ndarray) -> tuple[bool, bool]:
    """(pure_acgtn, has_n) for a chunk, one pass (native when available)."""
    if _native_ok(bases):
        from ..core import native

        return native.scan_alphabet(bases)
    return bool(_IS_ACGTN[bases].all()), bool((bases == ord("N")).any())


def pack_batch2(bases: np.ndarray, quals: np.ndarray, cfg: PipelineConfig,
                n_plane: bool = True):
    """2-bit pack for pure-ACGTN chunks: bases -> [B, ceil(L/4)] uint8
    (A=0 C=1 G=2 T=3; N/PAD positions carry garbage), planes ->
    [B, 1+T, ceil(L/8)] with plane 0 = `base == N` and planes 1.. the
    `qual < t` thresholds of pack_batch.  With ``n_plane=False`` (chunk
    verified N-free) the N plane is omitted entirely.  Uses the fused
    one-pass C++ kernel when available (fx_pack2); the numpy fallback is
    layout-identical."""
    if _native_ok(bases, quals):
        from ..core import native

        return native.pack2(bases, quals, _thresholds(cfg), n_plane)
    B, L = bases.shape  # noqa: E741
    codes = np.clip(_CODE_LUT[bases].astype(np.int16) - 1, 0, 3).astype(np.uint8)
    rem = (-L) % 4
    if rem:
        codes = np.concatenate([codes, np.zeros((B, rem), np.uint8)], axis=1)
    b2 = (
        (codes[:, 0::4] << 6) | (codes[:, 1::4] << 4)
        | (codes[:, 2::4] << 2) | codes[:, 3::4]
    )
    head = [np.packbits(bases == ord("N"), axis=1)] if n_plane else []
    planes = np.stack(
        head + [np.packbits(quals < t, axis=1) for t in _thresholds(cfg)],
        axis=1,
    )
    return b2, planes


def _unpack2(b2, planes, has_n_plane: bool = True):
    """Invert pack_batch2 -> (ascii bases [B, Le], q_lt [B, T, Le]) with
    Le = 4*b2.shape[1]; positions beyond the true L hold garbage letters
    that every consumer masks out via lengths."""
    B = b2.shape[0]
    le = b2.shape[1] * 4
    codes = jnp.stack(
        [(b2 >> 6) & 3, (b2 >> 4) & 3, (b2 >> 2) & 3, b2 & 3], axis=2
    ).reshape(B, le).astype(jnp.int32)
    bases = jnp.where(
        codes < 2,
        jnp.where(codes == 0, ord("A"), ord("C")),
        jnp.where(codes == 2, ord("G"), ord("T")),
    ).astype(jnp.uint8)
    if planes.shape[1] == 0:  # no thresholds and no N plane shipped
        return bases, jnp.zeros((B, 0, le), bool)
    shifts = jnp.arange(7, -1, -1, dtype=planes.dtype)
    bits = (planes[:, :, :, None] >> shifts) & 1
    all_planes = bits.reshape(B, planes.shape[1], -1)[:, :, :le].astype(bool)
    if has_n_plane:
        bases = jnp.where(all_planes[:, 0], jnp.uint8(ord("N")), bases)
        return bases, all_planes[:, 1:]
    return bases, all_planes


def _native_ok(*arrays) -> bool:
    from ..core import native

    return native.LIB is not None and all(
        a.flags["C_CONTIGUOUS"] for a in arrays
    )


def pack_batch(bases: np.ndarray, quals: np.ndarray, cfg: PipelineConfig):
    """Host side: bases -> 4-bit codes [B, ceil(L/2)] uint8, quals -> one
    `qual < t` bit-plane per distinct threshold [B, T, ceil(L/8)] uint8
    (MSB-first).  Uses the fused one-pass C++ kernel when available
    (native/fastx_codec.cpp fx_pack4); the numpy fallback is
    layout-identical (tests/test_packed.py)."""
    if _native_ok(bases, quals):
        from ..core import native

        return native.pack4(bases, quals, _thresholds(cfg))
    B, L = bases.shape  # noqa: E741
    codes = _CODE_LUT[bases]
    if L % 2:
        codes = np.concatenate([codes, np.zeros((B, 1), np.uint8)], axis=1)
    b4 = (codes[:, 0::2] << 4) | codes[:, 1::2]
    planes = np.stack(
        [np.packbits(quals < t, axis=1) for t in _thresholds(cfg)], axis=1
    )
    return b4, planes


def _unpack4(b4, planes):
    """Device side: invert pack_batch -> (ascii bases [B, Le], q_lt bool
    [B, T, Le]) with Le = 2*b4.shape[1] (>= true L; the surplus column is
    PAD and masked out by lengths everywhere)."""
    B = b4.shape[0]
    le = b4.shape[1] * 2
    hi = (b4 >> 4) & 0xF
    lo = b4 & 0xF
    codes = jnp.stack([hi, lo], axis=2).reshape(B, le).astype(jnp.int32)
    # 16-entry LUT via a select tree, not a gather
    lut = _ASCII_LUT
    bases = jnp.full(codes.shape, lut[0], jnp.uint8)
    for ci in range(1, 16):
        if lut[ci]:
            bases = jnp.where(codes == ci, jnp.uint8(lut[ci]), bases)
    if planes.shape[1] == 0:  # no thresholds shipped
        return bases, jnp.zeros((B, 0, le), bool)
    shifts = jnp.arange(7, -1, -1, dtype=planes.dtype)
    bits = (planes[:, :, :, None] >> shifts) & 1
    q_lt = bits.reshape(B, planes.shape[1], -1)[:, :, :le].astype(bool)
    return bases, q_lt


def packed_pipeline_body(b4, planes, lengths, counts, cfg: PipelineConfig,
                         psum_axis: Optional[str] = None,
                         seq_len: Optional[int] = None,
                         two_bit: bool = False,
                         has_n_plane: Optional[bool] = None,
                         tie_flag: bool = False):
    """pipeline_body on the packed representation; decisions-identical to
    the unpacked version (tests/test_packed.py).  ``seq_len`` is the true
    (pre-packing) L — only needed when L is not a multiple of the pack
    width, to shape the per-cycle count output like the unpacked
    pipeline.  ``two_bit`` selects the pack_batch2 layout;
    ``has_n_plane=False`` (2-bit only) means the chunk was verified
    N-free and the N plane was not shipped.  ``counts=None`` is allowed
    when ``cfg.with_stats`` is off (they are only read by the stats
    reduction; not shipping them saves 4 bytes/read)."""
    if has_n_plane is None:
        has_n_plane = two_bit
    lengths = lengths.astype(jnp.int32)
    b, q_lt = (
        _unpack2(b4, planes, has_n_plane) if two_bit else _unpack4(b4, planes)
    )
    if seq_len is not None and seq_len < b.shape[1]:
        b = b[:, :seq_len]
        q_lt = q_lt[:, :, :seq_len]
    thr = {t: i for i, t in enumerate(_thresholds(cfg))}
    l = lengths  # noqa: E741
    iota = jnp.arange(b.shape[1], dtype=jnp.int32)[None, :]
    keep = jnp.ones(b.shape[0], dtype=bool)

    if cfg.trim_last != 0:  # fastx_trimmer -l (positional; quals untouched)
        l = jnp.minimum(l, cfg.trim_last)  # noqa: E741
    in_len = iota < l[:, None]

    if cfg.with_filter:
        # fastq_quality_filter: |{qual < q}| <= len*(100-p)/100
        below = (in_len & q_lt[:, thr[cfg.filter_q]]).sum(axis=1, dtype=jnp.int32)
        keep &= below <= (l * (100 - cfg.filter_p)) // 100

    if cfg.with_qtrim:
        # fastq_quality_trimmer: drop the 3' run of qual < t
        passing = in_len & ~q_lt[:, thr[cfg.trim_q]]
        new_len = jnp.max(jnp.where(passing, iota + 1, 0), axis=1).astype(jnp.int32)
        keep &= (new_len > 0) & (new_len >= cfg.trim_minlen)
        l = new_len  # noqa: E741
        in_len = iota < l[:, None]

    if cfg.with_mask:
        # fastq_masker: the clipper/artifacts stages see the masked bases
        masked = in_len & q_lt[:, thr[cfg.mask_q]]
        b = jnp.where(masked, jnp.uint8(ord("N")), b)
    b = jnp.where(in_len, b, 0).astype(jnp.uint8)

    fragile = jnp.zeros(b.shape[0], bool)
    if cfg.with_clip:
        dummy_q = jnp.zeros(b.shape, jnp.int8)  # decisions never read quals
        out = clip_batch(
            b, dummy_q, l, adapter=cfg.adapter, min_length=cfg.clip_minlen,
            keep_delta=0, discard_non_clipped=False, discard_clipped=False,
            keep_n=cfg.clip_keep_n, show_adapter_only=False, min_adapter_len=0,
            tie_flag=tie_flag,
        )
        if tie_flag:
            b, _, l, wrote, _cat, fragile = out  # noqa: E741
        else:
            b, _, l, wrote, _cat = out  # noqa: E741
        keep &= wrote
    if cfg.with_artifacts:
        keep &= transforms.artifacts_keep(b, l)
    if cfg.to_fasta_discard_n:
        keep &= ~transforms.contains_n(b, l)
    l = jnp.where(keep, l, 0)  # noqa: E741
    if cfg.with_stats:
        assert counts is not None, "with_stats needs the counts column"
        count = stats_ops.counts_only(b, l, counts)
    else:
        count = jnp.zeros((b.shape[1], stats_ops.NSLOTS), jnp.int32)
    if psum_axis is not None:
        count = jax.lax.psum(count, psum_axis)
    if tie_flag:
        return l, keep, count, fragile
    return l, keep, count


def packed_decisions_pipeline(cfg: PipelineConfig,
                              seq_len: Optional[int] = None,
                              two_bit: bool = False,
                              has_n_plane: Optional[bool] = None,
                              tie_flag: bool = False):
    """decisions_pipeline over the packed upload (see pack_batch /
    pack_batch2).  When ``cfg.with_stats`` is off the step takes no
    counts argument (it would be dead weight on the device link)."""

    if cfg.with_stats:
        def step(b4, planes, lengths, counts):
            return packed_pipeline_body(b4, planes, lengths, counts, cfg,
                                        seq_len=seq_len, two_bit=two_bit,
                                        has_n_plane=has_n_plane)
    else:
        def step(b4, planes, lengths):
            return packed_pipeline_body(b4, planes, lengths, None, cfg,
                                        seq_len=seq_len, two_bit=two_bit,
                                        has_n_plane=has_n_plane,
                                        tie_flag=tie_flag)

    return jax.jit(step)


def decisions_pipeline(cfg: PipelineConfig, tie_flag: bool = False):
    """Ship decisions, not data: same fused step but returning ONLY small
    per-read scalars (final length, keep mask, per-cycle counts).

    Rationale: every byte-level edit of this pipeline (the masker's
    N-substitutions) is recomputable on host in one vectorized pass from
    data the host already holds, while the expensive decisions (alignment
    cutoff, filters, trim lengths) need the device.  Returning 5 bytes per
    read instead of the 2 x L transformed tensors makes the device->host
    copy a non-factor.  The host renderer
    applies ``quals < mask_q`` masking itself (see render path in bench.py
    and the CLI masker).
    """

    def step(bases, quals, lengths, counts):
        out = pipeline_body(bases, quals, lengths, counts, cfg,
                            tie_flag=tie_flag)
        if tie_flag:
            _b, _q, l, keep, count, fragile = out  # noqa: E741
            return l, keep, count, fragile
        _b, _q, l, keep, count = out  # noqa: E741
        return l, keep, count

    return jax.jit(step)
