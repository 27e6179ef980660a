"""fastx_collapser as a device-side sort + segment-reduce dedup.

The reference accumulates a hash map sequence -> reads_count
(/root/reference/src/fastx_collapser/fastx_collapser.cpp:112-114), sorts
ascending by count and prints in descending-count order renamed
``>rank-count`` (:116-122).  Tie order among equal counts in the
reference is libstdc++ hash-bucket iteration order — implementation-
defined.  Our deterministic contract: count DESCENDING, ties broken by
FIRST APPEARANCE in the input (ascending).  Parity tests compare
equal-count groups order-insensitively.

Device algorithm: pack each read's bytes into big-endian uint32 words
(lexicographic word order == byte order, PAD=0 sorts shortest-first),
multi-key stable sort, mark segment boundaries, segment-sum the
collapsed counts.  Partial (sequence, count) tables from different hosts
merge by concatenation + re-collapse, so multi-host reduction is an
all-gather followed by the same kernel (see fastx_toolkit_tpu.parallel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_words(bases: np.ndarray) -> np.ndarray:
    """uint8 [B, L] -> uint32 [B, ceil(L/4)] big-endian packed words."""
    B, L = bases.shape
    L4 = -(-L // 4) * 4
    if L4 != L:
        bases = np.pad(bases, ((0, 0), (0, L4 - L)))
    return bases.reshape(B, L4 // 4, 4).astype(np.uint32) @ np.array(
        [1 << 24, 1 << 16, 1 << 8, 1], dtype=np.uint32
    )


def collapse(words, counts, first_idx):
    """Device dedup.

    words uint32 [B, W], counts int32 [B], first_idx int32 [B] (original
    positions for the first-appearance tie-break).

    Returns (order, seg_counts, seg_first, uniq_mask, perm) where ``perm``
    sorts rows lexicographically, ``uniq_mask`` marks segment heads in
    sorted order, ``seg_counts``/``seg_first`` are per-row totals valid at
    segment heads.
    """
    words = jnp.asarray(words)
    counts = jnp.asarray(counts)
    first_idx = jnp.asarray(first_idx)
    B, W = words.shape
    # lexsort: LAST key is primary -> word 0 last, first_idx as the
    # least-significant tie-break so equal sequences stay in input order
    keys = (first_idx,) + tuple(words[:, w] for w in range(W - 1, -1, -1))
    perm = jnp.lexsort(keys)
    sw = words[perm]
    head = jnp.concatenate(
        [jnp.ones((1,), bool), (sw[1:] != sw[:-1]).any(axis=1)]
    )
    seg_id = jnp.cumsum(head) - 1
    seg_counts = jnp.zeros(B, counts.dtype).at[seg_id].add(counts[perm])
    seg_first = jnp.full(B, jnp.iinfo(jnp.int32).max, jnp.int32).at[seg_id].min(
        first_idx[perm]
    )
    return perm, head, seg_id, seg_counts, seg_first


collapse_jit = jax.jit(collapse)


def collapse_hashed(words, counts, first_idx, weak_hash: bool = False,
                    unit_counts: bool = False):
    """collapse() with a hash-prefix sort: rows are ordered by two
    independent 32-bit rolling hashes of the key words (+ first_idx as
    the deterministic tie-break — every caller passes unique indices, so
    the sort keys are all-distinct and the permutation is deterministic
    without is_stable) instead of the full W-word lexicographic key, so
    the bitonic sort network streams 3 key words per compare-exchange
    pass instead of W+1 (the dedup only needs equal rows CONTIGUOUS, not
    any particular order, and the CLI re-orders output by count/first-
    appearance afterwards - final_order).

    Segment boundaries come from material CARRIED THROUGH THE SORT as
    payload — the first two true word columns (the reads' first 8 bytes)
    plus a second independent 64-bit hash family (h3, h4) — replacing
    a post-sort ``words[perm]`` row-gather + exact compare, so the sort
    is the only pass that moves whole rows.  Failure analysis:

    * equal sequences can never split (all carried material is a
      function of the words);
    * different adjacent sequences merge only if they agree on the sort
      hashes, the prefix words AND the second family — four independent
      32-bit mixes over the differing tail, ~B^2/2^129 per chunk;
    * a sort-key (h1, h2) collision between different rows — the case
      that can interleave two groups — is still DETECTED exactly as in
      round 4 (adjacent rows with equal sort hashes but differing
      carried material) and returned as ``collision``; callers fall
      back to the exact collapse() (collapse_batch does).

    The exact gather-based adjacent compare (unconditional correctness,
    ~2.2x slower) remains available: FASTX_COLLAPSE_EXACT=1 routes
    collapse_batch through collapse().  Reviewed risk acceptance: the
    four mixes share the multiply+xorshift structure (they differ in
    multiplier, shift and per-word salt, not in family), so the
    ~B^2/2^129 figure assumes non-adversarial input; a caller that must
    collapse ATTACKER-CONTROLLED sequences should set
    FASTX_COLLAPSE_EXACT=1 (round 4's behavior, which verified the true
    words for every adjacent pair).

    ``weak_hash`` (test hook) degrades the two SORT hashes to a constant
    so the collision-detect path is exercisable under pytest (the second
    family stays real, so the detector sees the differing material).
    ``unit_counts`` (static): the caller guarantees counts == 1
    everywhere (plain FASTQ input — get_reads_count is always 1,
    fastx.c:479-481), so the counts column need not ride the sort
    network; segment counts are segment sizes.

    Returns (perm, head, seg_id, seg_counts, seg_first, collision);
    ``perm`` is None — no consumer needs the permutation since the
    boundary material rides the sort (it existed for the round-4
    ``words[perm]`` gather).
    """
    words = jnp.asarray(words)
    counts = jnp.asarray(counts)
    first_idx = jnp.asarray(first_idx)
    B, W = words.shape
    wu = words.astype(jnp.uint32)
    # two independent multiplicative rolling hashes with xorshift mixing
    # (nonlinear, so structured base patterns do not cancel mod 2^32),
    # plus a second family for the carried boundary material
    h1 = jnp.full(B, 0x811C9DC5, jnp.uint32)
    h2 = jnp.full(B, 0x9E3779B9, jnp.uint32)
    h3 = jnp.full(B, 0xC2B2AE35, jnp.uint32)
    h4 = jnp.full(B, 0x27D4EB2F, jnp.uint32)
    for w in range(W):
        col = wu[:, w]
        h1 = h1 * jnp.uint32(0x01000193) + col
        h1 = h1 ^ (h1 >> 15)
        h2 = h2 * jnp.uint32(0x85EBCA6B) + (col ^ jnp.uint32((w * 0x9E3779B9) & 0xFFFFFFFF))
        h2 = h2 ^ (h2 >> 13)
        h3 = h3 * jnp.uint32(0x9E3779B1) + (col ^ jnp.uint32((w * 0x632BE5AB) & 0xFFFFFFFF))
        h3 = h3 ^ (h3 >> 16)
        h4 = h4 * jnp.uint32(0x2545F491) + col
        h4 = h4 ^ (h4 >> 11)
    if weak_hash:
        h1 = jnp.zeros(B, jnp.uint32)
        h2 = jnp.zeros(B, jnp.uint32)
    w0 = wu[:, 0] if W > 0 else jnp.zeros(B, jnp.uint32)
    w1 = wu[:, 1] if W > 1 else jnp.zeros(B, jnp.uint32)
    # one lax.sort carries keys, tie-break, counts and the boundary
    # material through the network together — no post-sort gathers at
    # all (each network pass reads AND writes every operand, so every
    # dropped column saves 8 B/row/pass)
    ops = (h1, h2, first_idx) + (() if unit_counts else (counts,)) + (
        w0, w1, h3, h4)
    sorted_ops = jax.lax.sort(ops, num_keys=3)
    sh1, sh2, sfirst = sorted_ops[:3]
    scnt = (jnp.ones(B, counts.dtype) if unit_counts else sorted_ops[3])
    sw0, sw1, sh3, sh4 = sorted_ops[-4:]
    neq = (
        (sh1[1:] != sh1[:-1]) | (sh2[1:] != sh2[:-1])
        | (sw0[1:] != sw0[:-1]) | (sw1[1:] != sw1[:-1])
        | (sh3[1:] != sh3[:-1]) | (sh4[1:] != sh4[:-1])
    )
    head = jnp.concatenate([jnp.ones((1,), bool), neq])
    samehash = (sh1[1:] == sh1[:-1]) & (sh2[1:] == sh2[:-1])
    collision = jnp.any(samehash & neq)
    seg_id = jnp.cumsum(head) - 1
    seg_counts = jnp.zeros(B, counts.dtype).at[seg_id].add(scnt)
    seg_first = jnp.full(B, jnp.iinfo(jnp.int32).max, jnp.int32).at[seg_id].min(
        sfirst
    )
    return None, head, seg_id, seg_counts, seg_first, collision


collapse_hashed_jit = jax.jit(collapse_hashed,
                              static_argnames=("weak_hash", "unit_counts"))


def collapse_batch(bases: np.ndarray, counts: np.ndarray):
    """Host wrapper: returns (uniq_row_indices, uniq_counts, uniq_first)
    where uniq_row_indices point into the ORIGINAL batch (first-appearance
    representative of each distinct sequence)."""
    import os

    B = bases.shape[0]
    if B == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    words = pack_words(np.asarray(bases, dtype=np.uint8))
    first_idx = np.arange(B, dtype=np.int32)
    if os.environ.get("FASTX_COLLAPSE_EXACT"):
        res = collapse_jit(words, counts, first_idx) + (False,)
    else:
        weak = bool(os.environ.get("FASTX_COLLAPSE_WEAK_HASH"))
        res = collapse_hashed_jit(words, counts, first_idx, weak_hash=weak,
                                  unit_counts=bool((counts == 1).all()))
    if bool(np.asarray(res[5])):  # sort-hash collision: exact re-run
        res = collapse_jit(words, counts, first_idx)
    head, seg_id, seg_counts, seg_first = (
        np.asarray(x) for x in res[1:5]
    )
    nseg = int(head.sum())
    uniq_first = seg_first[:nseg]
    uniq_counts = seg_counts[:nseg]
    return uniq_first.astype(np.int64), uniq_counts.astype(np.int64), uniq_first


def final_order(uniq_counts: np.ndarray, uniq_first: np.ndarray) -> np.ndarray:
    """Output order: count descending, first-appearance ascending."""
    return np.lexsort((uniq_first, -uniq_counts.astype(np.int64)))


def _dec_digits(x: np.ndarray):
    """Vectorized base-10: -> (digits uint8 [U, D] right-aligned with
    leading zeros, ndig int64 [U])."""
    x = np.asarray(x, np.int64)
    U = len(x)
    maxv = int(x.max()) if U else 0
    D = max(1, len(str(max(maxv, 0))))
    digs = np.empty((U, D), np.uint8)
    v = x.copy()
    for d in range(D - 1, -1, -1):
        digs[:, d] = (v % 10) + 48
        v //= 10
    if D > 1:
        p10 = 10 ** np.arange(1, D, dtype=np.int64)
        ndig = 1 + (x[:, None] >= p10[None, :]).sum(axis=1)
    else:
        ndig = np.ones(U, np.int64)
    return digs, ndig


def ordinal_column(start: int, n: int):
    """Sequential decimal ids ``start+1 .. start+n`` as a StringColumn's
    innards (flat uint8 buffer, int64 offsets) — the vectorized form of
    ``[b"%d" % (start + i + 1) ...]`` used by fastx_renamer COUNT mode,
    the uncollapser, and fastq_to_fasta -r."""
    vals = np.arange(start + 1, start + n + 1, dtype=np.int64)
    digs, ndig = _dec_digits(vals)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(ndig, out=offs[1:])
    flat = np.empty(int(offs[-1]), np.uint8)
    rows = np.arange(n, dtype=np.int64)
    D = digs.shape[1]
    for k in range(D):
        m = k < ndig
        flat[offs[:-1][m] + k] = digs[rows[m], D - ndig[m] + k]
    return flat, offs


def rank_count_column(counts: np.ndarray):
    """The collapser's ``rank-count`` id column, vectorized (the Python
    b"%d-%d" loop is ~2 s per million records; this is ~20 numpy passes).

    counts are in output order; ranks are 1-based positions.  Returns
    (flat uint8 buffer, int64 offsets [U+1]) — a StringColumn's innards.
    """
    counts = np.asarray(counts, np.int64)
    U = len(counts)
    ranks = np.arange(1, U + 1, dtype=np.int64)
    dr, nr = _dec_digits(ranks)
    dc, nc = _dec_digits(counts)
    lens = nr + 1 + nc
    offs = np.zeros(U + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    flat = np.empty(int(offs[-1]), np.uint8)
    rows = np.arange(U, dtype=np.int64)
    Dr = dr.shape[1]
    for k in range(Dr):  # k-th significant digit of the rank
        m = k < nr
        flat[offs[:-1][m] + k] = dr[rows[m], Dr - nr[m] + k]
    flat[offs[:-1] + nr] = ord("-")
    Dc = dc.shape[1]
    base = offs[:-1] + nr + 1
    for k in range(Dc):
        m = k < nc
        flat[base[m] + k] = dc[rows[m], Dc - nc[m] + k]
    return flat, offs
