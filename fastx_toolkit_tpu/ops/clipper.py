"""fastx_clipper decision logic, vectorized.

adapter_cutoff_index heuristics (/root/reference/src/fastx_clipper/
fastx_clipper.cpp:159-241) + the clip/discard cascade (:282-319).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..kernels.align import align_batch
from . import transforms


def adapter_cutoff_index(res, lengths, *, min_adapter_len: int):
    """Vectorized adapter_cutoff_index: -1 = no acceptable alignment,
    else the query index to cut at (== query_start of the alignment)."""
    size = res["neutral"] + res["matches"] + res["mismatches"] + res["gaps"]
    m = res["matches"]
    pct = jnp.where(size > 0, (m * 100) // jnp.maximum(size, 1), 0)
    qsize = lengths
    ok = size != 0
    if min_adapter_len > 0:
        ok &= size >= min_adapter_len
    r1 = (res["query_end"] == qsize - 1) & (res["mismatches"] == 0)
    r2 = (size > 5) & (res["target_start"] == 0) & (pct >= 75)
    r3 = (size > 11) & (pct >= 80)
    r4 = (res["query_end"] >= qsize - 2) & (size <= 5) & (m >= 3)
    accept = ok & (r1 | r2 | r3 | r4)
    return jnp.where(accept, res["query_start"], -1)


def legacy_effective_query(bases, lengths, carry=None):
    """Emulate the reference's grow-only DP matrix + reused query buffer.

    The C++ engine's matrices only grow (sequence_alignment.cpp:131-153)
    and its _query_sequence member string is assigned per record into the
    same heap buffer, so for a read shorter than the widest read seen so
    far the DP scans STALE BYTES of earlier reads beyond the current
    read's terminator.  That is deterministic: position x of record i
    holds the byte written by the last record j <= i with len_j >= x
    (record j writes read[0..len_j-1] plus '\\0' at len_j, and a padded
    row is already 0 there).  Returns (effective_bases, widths, carry')
    where widths[i] is the running max length (the matrix width the C
    used for record i) and carry' = (last_row_bytes, width) seeds the
    next streamed chunk.

    numpy, host-side; only the CLI clipper uses this (the clean batch API
    treats reads independently — set FASTX_TPU_CLIPPER_CLEAN=1 to get the
    clean semantics in the CLI too).
    """
    import numpy as _np

    bases = _np.asarray(bases)
    lengths = _np.asarray(lengths, dtype=_np.int64)
    B, L = bases.shape
    run_max = _np.maximum.accumulate(lengths)
    if carry is not None:
        prev_row, prev_w = carry
        run_max = _np.maximum(run_max, prev_w)
    W = int(run_max.max()) if B else 0
    if bases.shape[1] < W:
        bases = _np.pad(bases, ((0, 0), (0, W - bases.shape[1])))
    col = _np.arange(W)
    # last writer index per (row, column); -1 = none yet
    writer = _np.where(lengths[:, None] >= col[None, :], _np.arange(B)[:, None], -1)
    writer = _np.maximum.accumulate(writer, axis=0)
    eff = _np.where(writer >= 0, bases[_np.maximum(writer, 0), col[None, :]], 0)
    if carry is not None:
        prev_row, prev_w = carry
        seed = _np.zeros(W, _np.uint8)
        seed[: min(len(prev_row), W)] = prev_row[: min(len(prev_row), W)]
        eff = _np.where(writer >= 0, eff, seed[None, :]).astype(_np.uint8)
    eff = eff.astype(_np.uint8)
    new_carry = (eff[-1].copy(), int(run_max[-1])) if B else carry
    return eff, run_max.astype(_np.int32), new_carry


def clip_batch(bases, quals, lengths, *, adapter: bytes, min_length: int,
               keep_delta: int, discard_non_clipped: bool,
               discard_clipped: bool, keep_n: bool,
               show_adapter_only: bool, min_adapter_len: int,
               align_bases=None, align_lengths=None, tie_flag: bool = False):
    """Full clipper pipeline on device.

    Returns (bases, quals, new_lengths, write_mask, category) where
    category codes the discard class for the verbose report:
    0=written, 1=adapter-at-zero, 2=too-short, 3=non-clipped(-c),
    4=clipped(-C), 5=contains-N.  With -k, adapter-at-zero reads are
    written instead of the normal survivors (fastx_clipper.cpp:288-319).

    ``align_bases``/``align_lengths`` optionally feed the DP a different
    view of the reads (the legacy stale-matrix emulation,
    :func:`legacy_effective_query`); the cutoff heuristics and the clip
    itself always use the true reads/lengths, like the reference
    (query_size is the current string's length even though the matrix is
    wider, fastx_clipper.cpp:265-285).
    """
    ab = bases if align_bases is None else align_bases
    al = lengths if align_lengths is None else align_lengths
    res = align_batch(ab, al, adapter, tie_flag=tie_flag)
    i = adapter_cutoff_index(res, lengths, min_adapter_len=min_adapter_len)

    # keep_delta already includes len(adapter) when > 0 (parse_commandline,
    # fastx_clipper.cpp:153-155)
    cut = jnp.where(i > 0, i + keep_delta, i)
    new_len = jnp.where(cut > 0, jnp.minimum(lengths, cut), lengths).astype(jnp.int32)

    has_n = transforms.contains_n(bases, new_len)

    cat = jnp.zeros(bases.shape[0], jnp.int32)
    # cascade order matters; first matching class wins
    c_zero = i == 0
    c_short = ~c_zero & (new_len < min_length)
    c_nonclip = ~c_zero & ~c_short & (i == -1) & discard_non_clipped
    c_clip = ~c_zero & ~c_short & ~c_nonclip & (i > 0) & discard_clipped
    c_n = ~c_zero & ~c_short & ~c_nonclip & ~c_clip & has_n & (not keep_n)
    cat = jnp.where(c_zero, 1, cat)
    cat = jnp.where(c_short, 2, cat)
    cat = jnp.where(c_nonclip, 3, cat)
    cat = jnp.where(c_clip, 4, cat)
    cat = jnp.where(c_n, 5, cat)

    if show_adapter_only:
        write = c_zero
    else:
        write = cat == 0

    bases, quals = transforms._zero_pad(bases, quals, new_len)
    if tie_flag:
        return bases, quals, new_len, write, cat, res["tie_fragile"]
    return bases, quals, new_len, write, cat


clip_batch_jit = jax.jit(
    clip_batch,
    static_argnames=(
        "adapter", "min_length", "keep_delta", "discard_non_clipped",
        "discard_clipped", "keep_n", "show_adapter_only", "min_adapter_len",
        "tie_flag",
    ),
)
