"""Half-local adapter alignment: the clipper's DP engine, batched.

The reference engine (/root/reference/src/libfastx/sequence_alignment.cpp,
class HalfLocalSequenceAlignment) fills an |query| x |target| score matrix
with float penalties (gap -5, match +1, mismatch -1, neutral +0.1,
N-vs-N 0), borders query_border[x]=0 and target_border[y] = (y<=3) ? 0 :
gap*(y-3), a banned from-left move when target_index-3 > query_index,
then tracebacks from the global max cell (first in x-major scan order on
ties) counting matches/mismatches/gaps/neutral and recording
query/target start/end.  All of ``find_optimal_alignment``'s heuristic
branches assign that same traceback result (sequence_alignment.cpp:606-650),
so the observable contract is exactly: DP fill -> argmax -> traceback.

Two implementations:

* :func:`align_oracle` — per-read numpy transcription with float32
  arithmetic, used as the differential-test reference.
* :func:`align_batch` — vectorized jnp version over a whole read batch.
  Scores are scaled x10 to integers (match +10, mismatch -10, gap -50,
  neutral +1, N/N 0) making the DP exact int32 arithmetic; every decimal
  score level of the reference differs by >= 0.1 while float32 error is
  ~1e-5, so comparisons and the argmax agree with the float engine (tested
  differentially against the oracle).  The column dependency
  cur[y] = max(base[y], cur[y-1]+gap) is solved as a cumulative max of
  base[y]-gap*y (exact in integers), so each scan step over x is fully
  vectorized over [B, Lt].
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

GAP = -50
MATCH = 10
MISMATCH = -10
NEUTRAL = 1
_N = ord("N")

FROM_UPPER = 1
FROM_LEFT = 2
FROM_UPPER_LEFT = 3


# ---------------------------------------------------------------------------
# numpy oracle (float32, faithful transcription)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AlignResult:
    query_size: int = 0
    query_start: int = 0
    query_end: int = 0
    target_size: int = 0
    target_start: int = 0
    target_end: int = 0
    gaps: int = 0
    neutral_matches: int = 0
    matches: int = 0
    mismatches: int = 0


def align_oracle(query: bytes, target: bytes, exact: bool = False) -> AlignResult:
    """Transcription of HalfLocalSequenceAlignment.

    With ``exact=False`` this uses float32 like the C (bit-faithful modulo
    FMA).  With ``exact=True`` scores are x10 integers — exact decimal
    arithmetic.  The two differ ONLY when reads contain N: the neutral
    +0.1 makes float sums inexact, so cells whose decimal scores tie can
    compare unequal in float and the argmax tie-break becomes accumulation
    noise (e.g. 4.3999996 vs 4.4).  That noise is not a semantic of the
    reference (it varies with compiler/FPU); the batched engine implements
    the exact-decimal semantics.

    Measured divergence rate (2026-08-20, 1M synthetic reads EVERY one of
    which carried 1-4 N bases, 50% adapter-spiked, vs the -O3 reference
    clipper with -n): 7 of 1,000,000 reads clipped differently
    (0.0007%); identical keep/discard counts.  ACGT-only reads are
    bit-identical (tests/test_differential_c.py).
    """
    if exact:
        return _align_oracle_int(query, target)
    W, H = len(query), len(target)
    gap = np.float32(-5.0)
    q = np.frombuffer(query, np.uint8)
    t = np.frombuffer(target, np.uint8)

    target_border = np.where(
        np.arange(H) <= 3, np.float32(0), gap * (np.arange(H) - 3).astype(np.float32)
    ).astype(np.float32)

    score = np.zeros((W, H), np.float32)
    origin = np.zeros((W, H), np.int8)

    def delta(x, y):
        if q[x] == _N and t[y] == _N:
            return np.float32(0.0)
        if q[x] == _N or t[y] == _N:
            return np.float32(0.1)
        return np.float32(1.0) if q[x] == t[y] else np.float32(-1.0)

    best = np.float32(-1000000)
    bx = by = 0
    for x in range(W):
        for y in range(H):
            # safe_score(): query_index==-1 -> target_border[target_index],
            # target_index==-1 -> query_border[query_index]==0.  At (0,0)
            # the C reads target_border[-1], an out-of-bounds vector access
            # that in practice lands on heap metadata ~ 0 (denormal); we
            # model it as 0.
            up = (score[x, y - 1] if y > 0 else np.float32(0.0)) + gap
            left = (score[x - 1, y] if x > 0 else target_border[y]) + gap
            if x > 0 and y > 0:
                ul_src = score[x - 1, y - 1]
            elif x == 0 and y > 0:
                ul_src = target_border[y - 1]
            else:
                ul_src = np.float32(0.0)
            upleft = ul_src + delta(x, y)
            if y > 3 and y - 3 > x:
                left = np.float32(-100000)
            s = np.float32(-100000000)
            o = FROM_LEFT
            if upleft > s:
                s, o = upleft, FROM_UPPER_LEFT
            if up > s:
                s, o = up, FROM_UPPER
            if left > s:
                s, o = left, FROM_LEFT
            score[x, y] = s
            origin[x, y] = o
            if s > best:
                best, bx, by = s, x, y

    # NOTE on borders in the C: safe_score(x-1, y) with x==0 returns
    # target_border[y]; safe_score(x, y-1) with y==0 returns
    # query_border[x] == 0; safe_score(x-1, y-1) with either -1 returns the
    # corresponding border -- for x==0 that's target_border[y-1], for y==0
    # query_border[x-1] == 0, and for both it's target_border[-1]
    # (query_border? no: query_index==-1 checked first -> target_border[-1],
    # an out-of-bounds read of the vector; libstdc++ returns the element
    # before the data pointer...).  In practice target_border[-1] on x==0,
    # y==0 reads vector data minus one.  We model safe_score(-1,-1) as
    # query_border path value 0, which equals target_border[0..3]=0 region
    # anyway; divergence would need a negative index read to differ from 0.
    r = AlignResult()
    r.query_size, r.target_size = W, H
    r.query_end, r.target_end = bx, by
    x, y = bx, by
    while x >= 0 and y >= 0:
        o = origin[x, y]
        r.query_start, r.target_start = x, y
        if o == FROM_LEFT:
            r.gaps += 1
            x -= 1
        elif o == FROM_UPPER:
            r.gaps += 1
            y -= 1
        else:
            if q[x] == _N or t[y] == _N:
                r.neutral_matches += 1
            elif q[x] == t[y]:
                r.matches += 1
            else:
                r.mismatches += 1
            x -= 1
            y -= 1
    return r


def _align_oracle_int(query: bytes, target: bytes) -> AlignResult:
    """Exact-decimal (x10 integer) per-read reference implementation."""
    W, H = len(query), len(target)
    q = np.frombuffer(query, np.uint8)
    t = np.frombuffer(target, np.uint8)
    tb = np.where(np.arange(H) <= 3, 0, GAP * (np.arange(H) - 3))
    score = np.zeros((W, H), np.int64)
    origin = np.zeros((W, H), np.int8)

    def delta(x, y):
        if q[x] == _N and t[y] == _N:
            return 0
        if q[x] == _N or t[y] == _N:
            return NEUTRAL
        return MATCH if q[x] == t[y] else MISMATCH

    best = -(10**9)
    bx = by = 0
    for x in range(W):
        for y in range(H):
            up = (score[x, y - 1] if y > 0 else 0) + GAP
            left = (int(score[x - 1, y]) if x > 0 else int(tb[y])) + GAP
            if x > 0 and y > 0:
                ul = int(score[x - 1, y - 1])
            elif x == 0 and y > 0:
                ul = int(tb[y - 1])
            else:
                ul = 0
            ul += delta(x, y)
            if y > 3 and y - 3 > x:
                left = -1000000
            s, o = -(10**8), FROM_LEFT
            if ul > s:
                s, o = ul, FROM_UPPER_LEFT
            if up > s:
                s, o = up, FROM_UPPER
            if left > s:
                s, o = left, FROM_LEFT
            score[x, y] = s
            origin[x, y] = o
            if s > best:
                best, bx, by = s, x, y

    r = AlignResult()
    r.query_size, r.target_size = W, H
    r.query_end, r.target_end = bx, by
    x, y = bx, by
    while x >= 0 and y >= 0:
        o = origin[x, y]
        r.query_start, r.target_start = x, y
        if o == FROM_LEFT:
            r.gaps += 1
            x -= 1
        elif o == FROM_UPPER:
            r.gaps += 1
            y -= 1
        else:
            if q[x] == _N or t[y] == _N:
                r.neutral_matches += 1
            elif q[x] == t[y]:
                r.matches += 1
            else:
                r.mismatches += 1
            x -= 1
            y -= 1
    return r


# ---------------------------------------------------------------------------
# batched jnp engine (integer scores)
# ---------------------------------------------------------------------------

def _match_delta(qc, tc):
    """Integer-scaled nucleotide_match_score (sequence_alignment.h:157-169)."""
    both_n = (qc == _N) & (tc == _N)
    one_n = (qc == _N) | (tc == _N)
    return jnp.where(
        both_n, 0, jnp.where(one_n, NEUTRAL, jnp.where(qc == tc, MATCH, MISMATCH))
    ).astype(jnp.int32)


def align_batch(bases, lengths, adapter: bytes, tie_flag: bool = False):
    """Batched half-local alignment of every read against one adapter.

    bases uint8 [B, L] (PAD=0 beyond lengths), adapter length H <= 100.
    Returns dict of int32 [B] arrays: matches, mismatches, gaps, neutral,
    query_start, query_end, target_start, target_end.

    With ``tie_flag=True`` the dict also carries ``tie_fragile`` [B]
    bool: True for reads where some max-relevant comparison was an EXACT
    decimal tie with a neutral (N) score on a tying path.  Those are
    precisely the reads whose outcome the reference's float32 engine can
    resolve differently (neutral +0.1 is inexact in float; all other
    score levels differ by >= 0.1 >> the ~1e-5 float error, so non-tied
    comparisons can never flip — see align_oracle's docstring).  Callers
    wanting bit-parity with the C re-run flagged reads through
    align_batch_float32.  The flag is conservative (a flagged read need
    not actually diverge) and propagates along paths: a fragile
    resolution taints every later cell whose stats inherited it.

    Design: instead of materializing an origin matrix and
    walking it backwards per read (the reference's traceback,
    sequence_alignment.cpp:496-604 — a serial pointer chase), every DP
    cell carries its PATH STATISTICS forward: (matches, mismatches, gaps,
    neutral, query_start, target_start) propagate through the same
    max-selects that pick the cell's origin.  The in-column dependency
    cur[y] = max(base[y], cur[y-1]+gap) becomes an associative scan whose
    combine key is (gap-adjusted score, winner-was-upper-left): the C
    resolves candidate ties with priority UPPER_LEFT > UPPER > LEFT
    (sequence_alignment.cpp:394-407), which in chain form means a later
    cell wins an equal-score tie against the running up-chain iff its own
    winner was the upper-left move.  Gap counts ride the scan as g-y so
    pure-up chains need no per-step updates.  All state is laid out
    [H, B] so the big batch dimension rides the 128-wide lane axis.

    Cells at x >= lengths[b] are excluded from the argmax so each read's
    matrix is exactly |read| x |adapter| like the reference's (the
    reference's grow-only matrix can scan stale heap bytes for
    mixed-length inputs -- undefined behavior we do not reproduce).
    """
    bases = jnp.asarray(bases)
    lengths = jnp.asarray(lengths)
    B, L = bases.shape
    t = jnp.asarray(np.frombuffer(adapter, np.uint8)).astype(jnp.int32)
    H = len(adapter)
    ys = jnp.arange(H, dtype=jnp.int32)[:, None]  # [H, 1]
    target_border = jnp.where(ys <= 3, 0, GAP * (ys - 3)).astype(jnp.int32)  # [H,1]
    NEG = jnp.int32(-1000000)
    basesT = bases.T  # [L, B] so per-step slices are contiguous rows

    tc = t[:, None]  # [H, 1]
    t_is_n = tc == _N

    def comb(a, b):
        """Associative up-chain combine; b is the later block.  b wins a
        score tie only if its winner was an upper-left move."""
        ywins = (b[0] > a[0]) | ((b[0] == a[0]) & b[1])
        return tuple(jnp.where(ywins, yb, ya) for ya, yb in zip(a, b))

    def comb_flag(a, b):
        """comb + fragility: a score tie between chain candidates with a
        neutral on either tying path marks the winner fragile (the float
        engine could resolve it the other way).  Tuple slot 5 is the
        neutral count, slot 8 the flag."""
        ywins = (b[0] > a[0]) | ((b[0] == a[0]) & b[1])
        # a tie is fragile if either side carries neutrals OR an inherited
        # fragile bit (a fragile cell's float VALUE can differ from the
        # exact value even with its own neutral count at 0)
        tie = (b[0] == a[0]) & (((a[5] + b[5]) > 0) | a[8] | b[8])
        out = tuple(jnp.where(ywins, yb, ya) for ya, yb in zip(a, b))
        return out[:8] + (out[8] | tie,)

    def step(carry, x):
        # prev column state, all [H, B] int32 (absolute counters)
        (psc, pm, pmm, pg, pnm, pqs, pts, pfl, best, bm, bmm, bg, bnm, bqs,
         bts, bx, by, bfl) = carry
        qc = basesT[x].astype(jnp.int32)[None, :]  # [1, B]
        q_is_n = qc == _N
        one_n = q_is_n | t_is_n
        eq = qc == tc
        delta = jnp.where(
            q_is_n & t_is_n, 0,
            jnp.where(one_n, NEUTRAL, jnp.where(eq, MATCH, MISMATCH)),
        )
        inc_m = (~one_n & eq).astype(jnp.int32)
        inc_mm = (~one_n & ~eq).astype(jnp.int32)
        inc_nm = one_n.astype(jnp.int32)

        first_col = x == 0

        def shift_down(a, top):
            return jnp.concatenate([top, a[:-1]], axis=0)

        # --- upper-left candidate ---
        zrow = jnp.zeros((1, B), jnp.int32)
        ul_src_sc = jnp.where(
            first_col,
            shift_down(jnp.broadcast_to(target_border, (H, B)), zrow),
            shift_down(psc, zrow),
        )
        fresh_ul = first_col | (ys == 0)  # path starts at this cell
        ul_sc = ul_src_sc + delta
        ul_m = jnp.where(fresh_ul, 0, shift_down(pm, zrow)) + inc_m
        ul_mm = jnp.where(fresh_ul, 0, shift_down(pmm, zrow)) + inc_mm
        ul_nm = jnp.where(fresh_ul, 0, shift_down(pnm, zrow)) + inc_nm
        ul_g = jnp.where(fresh_ul, 0, shift_down(pg, zrow))
        ul_qs = jnp.where(fresh_ul, x, shift_down(pqs, zrow))
        ul_ts = jnp.where(fresh_ul, jnp.broadcast_to(ys, (H, B)), shift_down(pts, zrow))
        ul_fl = ~fresh_ul & shift_down(pfl, zrow.astype(bool))

        # --- left candidate (banned off-diagonal) ---
        ban = (ys > 3) & (ys - 3 > x)
        left_sc = jnp.where(
            ban, NEG, jnp.where(first_col, target_border, psc) + GAP
        )
        left_g = jnp.where(first_col, 1, pg + 1)
        left_m = jnp.where(first_col, 0, pm)
        left_mm = jnp.where(first_col, 0, pmm)
        left_nm = jnp.where(first_col, 0, pnm)
        left_qs = jnp.where(first_col, x, pqs)
        left_ts = jnp.where(first_col, jnp.broadcast_to(ys, (H, B)), pts)
        left_fl = ~first_col & pfl

        # --- resolve UL vs LEFT (UL wins ties: C checks UL first) ---
        lw = left_sc > ul_sc
        e_sc = jnp.where(lw, left_sc, ul_sc)
        e_ul = ~lw  # element winner was the upper-left move
        e_m = jnp.where(lw, left_m, ul_m)
        e_mm = jnp.where(lw, left_mm, ul_mm)
        e_g = jnp.where(lw, left_g, ul_g)
        e_nm = jnp.where(lw, left_nm, ul_nm)
        e_qs = jnp.where(lw, left_qs, ul_qs)
        e_ts = jnp.where(lw, left_ts, ul_ts)
        if tie_flag:
            # an exact UL/LEFT tie with a neutral on either path is
            # float-fragile whichever side the priority rule picked
            t1 = (left_sc == ul_sc) & (
                ((ul_nm + left_nm) > 0) | ul_fl | left_fl
            )
            e_fl = jnp.where(lw, left_fl, ul_fl) | t1
        else:
            e_fl = jnp.zeros((H, B), bool)

        # --- y==0 border-up candidate (query_border[x] + GAP), priority
        #     UP: beats LEFT ties, loses UL ties ---
        up0_sc = jnp.int32(GAP)
        row0 = ys == 0
        up0_better = row0 & (
            (up0_sc > e_sc) | ((up0_sc == e_sc) & ~e_ul)
        )
        e_sc = jnp.where(up0_better, up0_sc, e_sc)
        e_ul = jnp.where(up0_better, False, e_ul)
        e_m = jnp.where(up0_better, 0, e_m)
        e_mm = jnp.where(up0_better, 0, e_mm)
        e_g = jnp.where(up0_better, 1, e_g)
        e_nm = jnp.where(up0_better, 0, e_nm)
        e_qs = jnp.where(up0_better, x, e_qs)
        e_ts = jnp.where(up0_better, 0, e_ts)
        if tie_flag:
            t2 = row0 & (up0_sc == e_sc) & ((e_nm > 0) | e_fl)
            e_fl = jnp.where(up0_better, False, e_fl) | t2

        # --- up-chain via associative scan over y ---
        gap_y = GAP * ys
        adj = e_sc - gap_y
        g_adj = e_g - ys  # g rides as g - y
        if tie_flag:
            out = jax.lax.associative_scan(
                comb_flag,
                (adj, e_ul, e_m, e_mm, g_adj, e_nm, e_qs, e_ts, e_fl),
                axis=0,
            )
            c_adj, _, c_m, c_mm, c_gadj, c_nm, c_qs, c_ts, c_fl = out
        else:
            out = jax.lax.associative_scan(
                comb, (adj, e_ul, e_m, e_mm, g_adj, e_nm, e_qs, e_ts), axis=0
            )
            c_adj, _, c_m, c_mm, c_gadj, c_nm, c_qs, c_ts = out
            c_fl = jnp.zeros((H, B), bool)
        cur = c_adj + gap_y
        c_g = c_gadj + ys

        # --- global argmax (x-major then y order, strict >) ---
        col_best = jnp.max(cur, axis=0)  # [B]
        ymask = cur == col_best[None, :]
        col_by = jnp.argmax(ymask, axis=0).astype(jnp.int32)  # first y
        sel = ys == col_by[None, :]

        def pick(a):
            return jnp.sum(jnp.where(sel, a, 0), axis=0)

        improve = (x < lengths) & (col_best > best)

        def upd(old, new):
            return jnp.where(improve, new, old)

        if tie_flag:
            # inter-row exact tie at the column max with a neutral on any
            # tied row: the first-y rule is float-fragile
            cfl_sel = pick(c_fl.astype(jnp.int32)) > 0
            t5 = (jnp.sum(ymask, axis=0) > 1) & (
                (jnp.sum(jnp.where(ymask, c_nm, 0), axis=0) > 0)
                | (jnp.sum(jnp.where(ymask, c_fl, False).astype(jnp.int32),
                           axis=0) > 0)
            )
            # exact tie against the running global best with neutrals or
            # inherited fragility on either side: keep-old is float-fragile
            t4 = (x < lengths) & (col_best == best) & (
                ((pick(c_nm) + bnm) > 0) | cfl_sel | bfl
            )
            bfl = jnp.where(improve, cfl_sel | t5, bfl) | t4
        best = upd(best, col_best)
        bm = upd(bm, pick(c_m))
        bmm = upd(bmm, pick(c_mm))
        bg = upd(bg, pick(c_g))
        bnm = upd(bnm, pick(c_nm))
        bqs = upd(bqs, pick(c_qs))
        bts = upd(bts, pick(c_ts))
        bx = upd(bx, x)
        by = upd(by, col_by)

        return (cur, c_m, c_mm, c_g, c_nm, c_qs, c_ts, c_fl, best,
                bm, bmm, bg, bnm, bqs, bts, bx, by, bfl), None

    zhb = jnp.zeros((H, B), jnp.int32)
    zb = jnp.zeros((B,), jnp.int32)
    init = (zhb, zhb, zhb, zhb, zhb, zhb, zhb, jnp.zeros((H, B), bool),
            jnp.full((B,), -10000000, jnp.int32),
            zb, zb, zb, zb, zb, zb, zb, zb, jnp.zeros((B,), bool))
    final, _ = jax.lax.scan(step, init, jnp.arange(L, dtype=jnp.int32))
    (_, _, _, _, _, _, _, _, best, bm, bmm, bg, bnm, bqs, bts, bx, by,
     bfl) = final
    out = {
        "matches": bm,
        "mismatches": bmm,
        "gaps": bg,
        "neutral": bnm,
        "query_start": bqs,
        "query_end": bx,
        "target_start": bts,
        "target_end": by,
    }
    if tie_flag:
        out["tie_fragile"] = bfl
    return out


align_batch_jit = jax.jit(align_batch, static_argnames=("adapter", "tie_flag"))


def align_batch_float32(bases, lengths, adapter: bytes):
    """float32 batch engine, bit-faithful to the C (numpy, host).

    Reproduces /root/reference/src/libfastx/sequence_alignment.cpp's
    float arithmetic exactly: per-cell score = float32 candidate max in
    the C's priority order (UL checked first, then UP, then LEFT), with
    the same accumulation order as the sequential fill — so its results
    match the reference binary bit for bit, including the N-read ties the
    exact-decimal engines resolve deterministically (align_oracle
    docstring).  Vectorized over the batch: the (x, y) cell loops are
    Python, every op is a [B]-vector — meant for the small tie_fragile
    subset of a batch, not whole lanes.

    Path statistics are carried forward per cell exactly like
    align_batch (the forward decisions ARE the traceback: the C's
    traceback walks the origin matrix recorded during the fill)."""
    bases = np.asarray(bases, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    B, L = bases.shape
    t = np.frombuffer(adapter, np.uint8)
    H = len(adapter)
    gap = np.float32(-5.0)
    ys = np.arange(H)
    tb = np.where(ys <= 3, np.float32(0),
                  (gap * (ys - 3).astype(np.float32)).astype(np.float32))
    tb = tb.astype(np.float32)
    t_is_n = t == _N

    # previous-column state
    psc = np.zeros((H, B), np.float32)
    pstat = np.zeros((6, H, B), np.int32)  # m, mm, g, nm, qs, ts
    best = np.full(B, np.float32(-1000000), np.float32)
    bstat = np.zeros((7, B), np.int32)  # m, mm, g, nm, qs, ts + bx
    b_y = np.zeros(B, np.int32)

    NEGBAN = np.float32(-100000)
    for x in range(L):
        qc = bases[:, x]
        q_is_n = qc == _N
        cur = np.empty((H, B), np.float32)
        cstat = np.empty((6, H, B), np.int32)
        up_sc = np.full(B, np.float32(0.0), np.float32)  # query border
        up_stat = None  # fresh at y==0
        for y in range(H):
            if t_is_n[y]:
                delta = np.where(q_is_n, np.float32(0.0), np.float32(0.1))
                inc = 3  # neutral
            else:
                delta = np.where(
                    q_is_n, np.float32(0.1),
                    np.where(qc == t[y], np.float32(1.0), np.float32(-1.0)),
                ).astype(np.float32)
                inc = None  # depends on q
            # candidate scores, exactly the C's operand order
            if x == 0:
                ul_src = tb[y - 1] if y > 0 else np.float32(0.0)
                ul = np.float32(ul_src) + delta
                left = np.float32(tb[y] + gap)
                left = np.full(B, left, np.float32)
            else:
                ul_src = psc[y - 1] if y > 0 else np.float32(0.0)
                ul = (ul_src + delta).astype(np.float32)
                left = (psc[y] + gap).astype(np.float32)
            up = (up_sc + gap).astype(np.float32)
            banned = y > 3 and y - 3 > x
            if banned:
                left = np.full(B, NEGBAN, np.float32)
            # priority max: UL, then UP, then LEFT (strict >)
            s = np.maximum(ul, np.float32(-100000000))
            o = np.zeros(B, np.int8)  # 0=UL
            m_up = up > s
            s = np.where(m_up, up, s).astype(np.float32)
            o = np.where(m_up, 1, o)
            m_left = left > s
            s = np.where(m_left, left, s).astype(np.float32)
            o = np.where(m_left, 2, o)
            cur[y] = s
            # forward stats per origin
            is_match = (~q_is_n) & ~t_is_n[y] & (qc == t[y])
            is_mm = (~q_is_n) & ~t_is_n[y] & (qc != t[y])
            is_nm = q_is_n | t_is_n[y]
            if x == 0 or y == 0:  # UL source is a border: fresh path
                ul_m = is_match.astype(np.int32)
                ul_mm = is_mm.astype(np.int32)
                ul_g = np.zeros(B, np.int32)
                ul_nm = is_nm.astype(np.int32)
                ul_qs = np.full(B, x, np.int32)
                ul_ts = np.full(B, y, np.int32)
            else:
                ul_m = pstat[0, y - 1] + is_match
                ul_mm = pstat[1, y - 1] + is_mm
                ul_g = pstat[2, y - 1]
                ul_nm = pstat[3, y - 1] + is_nm
                ul_qs = pstat[4, y - 1]
                ul_ts = pstat[5, y - 1]
            if y == 0:  # UP source is the query border: fresh
                up_m = np.zeros(B, np.int32)
                up_mm = np.zeros(B, np.int32)
                up_g = np.ones(B, np.int32)
                up_nm = np.zeros(B, np.int32)
                up_qs = np.full(B, x, np.int32)
                up_ts = np.zeros(B, np.int32)
            else:
                up_m = cstat[0, y - 1]
                up_mm = cstat[1, y - 1]
                up_g = cstat[2, y - 1] + 1
                up_nm = cstat[3, y - 1]
                up_qs = cstat[4, y - 1]
                up_ts = cstat[5, y - 1]
            if x == 0:  # LEFT source is the target border: fresh
                lf_m = np.zeros(B, np.int32)
                lf_mm = np.zeros(B, np.int32)
                lf_g = np.ones(B, np.int32)
                lf_nm = np.zeros(B, np.int32)
                lf_qs = np.full(B, x, np.int32)
                lf_ts = np.full(B, y, np.int32)
            else:
                lf_m = pstat[0, y]
                lf_mm = pstat[1, y]
                lf_g = pstat[2, y] + 1
                lf_nm = pstat[3, y]
                lf_qs = pstat[4, y]
                lf_ts = pstat[5, y]
            for k, (a, b, c) in enumerate((
                (ul_m, up_m, lf_m), (ul_mm, up_mm, lf_mm),
                (ul_g, up_g, lf_g), (ul_nm, up_nm, lf_nm),
                (ul_qs, up_qs, lf_qs), (ul_ts, up_ts, lf_ts),
            )):
                cstat[k, y] = np.where(o == 0, a, np.where(o == 1, b, c))
            # global best: strict >, (x, y) fill order, x < read length
            improve = (s > best) & (x < lengths)
            best = np.where(improve, s, best).astype(np.float32)
            for k in range(6):
                bstat[k] = np.where(improve, cstat[k, y], bstat[k])
            bstat[6] = np.where(improve, x, bstat[6])
            b_y = np.where(improve, y, b_y)
            up_sc = s
        psc = cur
        pstat = cstat
    return {
        "matches": bstat[0],
        "mismatches": bstat[1],
        "gaps": bstat[2],
        "neutral": bstat[3],
        "query_start": bstat[4],
        "query_end": bstat[6],
        "target_start": bstat[5],
        "target_end": b_y,
    }


# ---------------------------------------------------------------------------
# debug/inspection utilities (seqalign_test + fastx_clipper -D)
# ---------------------------------------------------------------------------

def align_oracle_full(query: bytes, target: bytes):
    """Oracle + full matrices and alignment strings, for the debug
    printers (print_matrix, sequence_alignment.cpp:169-228, and
    SequenceAlignmentResults::print, :15-86)."""
    W, H = len(query), len(target)
    q = np.frombuffer(query, np.uint8)
    t = np.frombuffer(target, np.uint8)
    r = align_oracle(query, target)
    # rebuild matrices (float path)
    gap = np.float32(-5.0)
    tb = np.where(np.arange(H) <= 3, np.float32(0),
                  gap * (np.arange(H) - 3).astype(np.float32)).astype(np.float32)
    score = np.zeros((W, H), np.float32)
    origin = np.zeros((W, H), np.int8)
    match = np.zeros((W, H), np.uint8)

    def delta(x, y):
        if q[x] == _N and t[y] == _N:
            return np.float32(0.0)
        if q[x] == _N or t[y] == _N:
            return np.float32(0.1)
        return np.float32(1.0) if q[x] == t[y] else np.float32(-1.0)

    for x in range(W):
        for y in range(H):
            match[x, y] = (
                ord("N") if (q[x] == _N or t[y] == _N)
                else (ord("M") if q[x] == t[y] else ord("x"))
            )
            up = (score[x, y - 1] if y > 0 else np.float32(0.0)) + gap
            left = (score[x - 1, y] if x > 0 else tb[y]) + gap
            if x > 0 and y > 0:
                ul = score[x - 1, y - 1]
            elif x == 0 and y > 0:
                ul = tb[y - 1]
            else:
                ul = np.float32(0.0)
            ul = ul + delta(x, y)
            if y > 3 and y - 3 > x:
                left = np.float32(-100000)
            s, o = np.float32(-100000000), FROM_LEFT
            if ul > s:
                s, o = ul, FROM_UPPER_LEFT
            if up > s:
                s, o = up, FROM_UPPER
            if left > s:
                s, o = left, FROM_LEFT
            score[x, y], origin[x, y] = s, o

    # alignment strings via traceback
    qa, ta = [], []
    x, y = r.query_end, r.target_end
    acc = 0.0
    while x >= 0 and y >= 0:
        o = origin[x, y]
        if o == FROM_LEFT:
            ta.append("-")
            qa.append(chr(q[x]))
            acc += -5.0
            x -= 1
        elif o == FROM_UPPER:
            ta.append(chr(t[y]))
            qa.append("-")
            acc += -5.0
            y -= 1
        else:
            ta.append(chr(t[y]))
            qa.append(chr(q[x]))
            mv = chr(match[x, y])
            acc += {"N": 0.1, "M": 1.0, "x": -1.0}[mv]
            x -= 1
            y -= 1
    return r, score, origin, match, tb, "".join(reversed(qa)), "".join(reversed(ta)), acc


def format_matrix(query: bytes, target: bytes) -> str:
    """print_matrix (sequence_alignment.cpp:192-228)."""
    _, score, origin, match, tb, _, _, _ = align_oracle_full(query, target)
    W, H = len(query), len(target)
    out = ["Score-Matrix:\n"]
    line = "%-2s%-7s" % ("-", "-")
    for x in range(W):
        line += "%-9c" % chr(query[x])
    out.append(line + "\n")
    line = "%-2s%-7s" % ("-", "-")
    for x in range(W):
        line += "%-9s" % "0"  # query_border is all zeros
    out.append(line + "\n")
    ochar = {FROM_UPPER: "|", FROM_LEFT: "-", FROM_UPPER_LEFT: "\\", 4: "="}
    for y in range(H):
        line = "%-2c%6s " % (chr(target[y]), ("%g" % tb[y]))
        for x in range(W):
            line += "%c%c%-7.1f" % (
                chr(match[x, y]), ochar.get(int(origin[x, y]), "*"), score[x, y]
            )
        out.append(line.rstrip() + "\n")
    return "".join(out)


def format_results(query: bytes, target: bytes) -> str:
    """SequenceAlignmentResults::print (sequence_alignment.cpp:15-86)."""
    r, _, _, _, _, qa, ta, acc = align_oracle_full(query, target)
    out = []
    out.append("Query-Alingment = %s\n" % qa)
    out.append("target-Alingment= %s\n" % ta)
    out.append("Alignment NOT found\n")  # alignment_found is never set
    out.append(
        "Score = %g (%d matches, %d neutral-matches, %d mismatches, %d gaps) \n"
        % (acc, r.matches, r.neutral_matches, r.mismatches, r.gaps)
    )
    out.append(
        "Query = %s(qsize %d qstart %d qend %d\n"
        % (query.decode(), r.query_size, r.query_start, r.query_end)
    )
    out.append(
        "Target= %s(tsize %d tstart %d tend %d\n"
        % (target.decode(), r.target_size, r.target_start, r.target_end)
    )
    out.append("\n")
    delta = max(r.target_start, r.query_start)
    line = ""
    if delta - r.query_start > 0:
        line += " " * (delta - r.query_start - 1)
    if r.query_start > 0:
        line += query.decode()[: r.query_start - 1]
    line += "(%s)" % qa
    if r.query_end < len(query):
        line += query.decode()[r.query_end + 1 :]
    out.append(line + "\n")
    line = " " * (delta - 1) if delta > 0 else ""
    line += "(" + "".join(
        "*" if a == b else "|" for a, b in zip(qa, ta)
    ) + ")"
    out.append(line + "\n")
    line = ""
    if delta - r.target_start > 0:
        line += " " * (delta - r.target_start)
    if r.target_start > 0:
        line += target.decode()[: r.target_start - 1]
    line += "(%s)" % ta
    if r.target_end < len(target):
        line += target.decode()[r.target_end + 1 :]
    out.append(line + "\n")
    return "".join(out)
