"""Streaming raw-line pipeline engine: the package's fastest host path.

Runs a fused preprocessing chain (engine.pipeline.PipelineConfig) over a
FASTQ stream the way the headline benchmark does, as library code:

* chunks are framed into raw line spans (codec.frame_fastq_fast) and
  validated natively — the padded [B, L] base/quality matrices are never
  built for clean chunks;
* the 2-bit packed upload is produced straight from the spans
  (native.pack2_lines) and dispatched to the device in fixed-size,
  exactly-CHUNK-row batches (one compiled shape), with a bounded number
  of chunks in flight and a dedicated drainer thread so the device
  round-trip overlaps parsing;
* the device returns only (new_length, keep) per read; output is
  rendered from the original spans + decisions with the masker's byte
  edit fused in (native.render_lines);
* any chunk the fast path cannot take — numeric qualities, framing or
  byte errors (the full parser then raises the reference's exact error
  text), non-ACGTN alphabets — is parsed classically and dispatched
  through the unpacked decisions program IN ORDER, so a single stream
  can mix both paths with identical results.

The reference equivalent is a shell pipeline of per-record C filters
(e.g. /root/reference/src/fastq_quality_trimmer/fastq_quality_trimmer.c);
here the whole chain is one device program fed by span-native host legs.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional

import numpy as np

from ..core import codec, native
from .pipeline import (
    PipelineConfig,
    _thresholds,
    bucket_shape,
    decisions_pipeline,
    packed_decisions_pipeline,
)

CHUNK = int(os.environ.get("FASTX_TPU_CHUNK", 262144))

# env knobs whose values are read while TRACING the decisions step (the
# tie-fix default).  The jitted programs LineEngines memoizes bake these
# in, so the memo must be invalidated when any of them changes
# mid-process (tests and differential harnesses toggle them).
_TRACE_ENV_KNOBS = ("FASTX_TPU_NO_TIE_FIX",)


def _trace_env_snapshot():
    return tuple(os.environ.get(k) for k in _TRACE_ENV_KNOBS)


class LineEngines:
    """Lazily-built jitted programs for one PipelineConfig.  Reuse one
    instance across calls so repeated streams hit the same traced
    executables (jax.jit caches per wrapper function).

    When the chain includes the clipper, the engines run with the DP
    tie-fragility flag on (kernels/align*.py tie_fragile) and the
    streaming consumer re-decides flagged reads with the bit-faithful
    float32 host engine (engine/hostfix.py) — output then matches the
    reference byte for byte even on N-bearing lanes.
    FASTX_TPU_NO_TIE_FIX=1 turns the machinery off."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self._env = _trace_env_snapshot()
        self.tie = bool(cfg.with_clip) and not os.environ.get(
            "FASTX_TPU_NO_TIE_FIX"
        )
        self._fn2_clean = self._fn2 = self._unpacked = None

    def _check_env(self):
        """Drop memoized programs if a trace-time env knob changed."""
        env = _trace_env_snapshot()
        if env != self._env:
            self._env = env
            self.tie = bool(self.cfg.with_clip) and not os.environ.get(
                "FASTX_TPU_NO_TIE_FIX"
            )
            self._fn2_clean = self._fn2 = self._unpacked = None

    def fn2(self, has_n: bool):
        self._check_env()
        if has_n:
            if self._fn2 is None:
                self._fn2 = packed_decisions_pipeline(
                    self.cfg, two_bit=True, tie_flag=self.tie
                )
            return self._fn2
        if self._fn2_clean is None:
            self._fn2_clean = packed_decisions_pipeline(
                self.cfg, two_bit=True, has_n_plane=False, tie_flag=self.tie
            )
        return self._fn2_clean

    def unpacked(self):
        self._check_env()
        if self._unpacked is None:
            self._unpacked = decisions_pipeline(self.cfg, tie_flag=self.tie)
        return self._unpacked


def stream_pipeline_lines(reader, cfg: PipelineConfig, *, out_fastq: bool,
                          q_offset: int, write, arena: Optional[np.ndarray] = None,
                          chunk_rows: int = CHUNK,
                          engines: Optional[LineEngines] = None,
                          chunks=None):
    """Stream ``reader`` through the fused chain; emit rendered bytes.

    ``write(b)`` receives the output in input order (ignored when
    ``arena`` is given — then bytes land in the arena and the total count
    is returned).  ``chunks`` optionally supplies the (chunk, line_base)
    iterator — callers that already consumed the head of
    ``reader.iter_chunks()`` (e.g. to detect the format) pass the
    rechained iterator here.  Returns
    ``(n_records_in, n_records_out, bytes_out)``.
    """
    if native.LIB is None:
        raise RuntimeError("stream_pipeline_lines requires the native codec")
    if engines is None:
        engines = LineEngines(cfg)
    if chunks is None:
        chunks = reader.iter_chunks()
    thresholds = _thresholds(cfg)
    allowed = codec.allowed_table_u8(reader.allow_n, reader.allow_u, False)
    inflight_max = int(os.environ.get("FASTX_BENCH_INFLIGHT", 2))

    blocks_q: "queue.Queue" = queue.Queue()
    futs_q: "queue.Queue" = queue.Queue(maxsize=32)
    inflight_q: "queue.Queue" = queue.Queue(maxsize=max(1, inflight_max - 1))
    err = []

    tie = getattr(engines, "tie", False)

    # per-leg trace (FASTX_LINES_TRACE=1): cumulative seconds per leg;
    # frame/pack/dispatch-stall run on the producer thread, drain on the
    # drainer, render on the caller's thread — wall-clock overlap means
    # the legs need not sum to the elapsed time
    trace = bool(os.environ.get("FASTX_LINES_TRACE"))
    tr = {"frame+scan": 0.0, "pack": 0.0, "dispatch_stall": 0.0,
          "drain(link)": 0.0, "render": 0.0}

    def _timed(leg, f, *a, **k):
        if not trace:
            return f(*a, **k)
        t0 = time.perf_counter()
        r = f(*a, **k)
        tr[leg] += time.perf_counter() - t0
        return r

    def drain():
        try:
            while True:
                item = inflight_q.get()
                if item is None:
                    break
                nrows, fut = item
                futs_q.put((
                    nrows, _timed("drain(link)", np.asarray, fut[0]),
                    np.asarray(fut[1]),
                    np.asarray(fut[3]) if tie else None,
                ))
        except BaseException as e:
            err.append(e)
            # keep consuming (discarding futures) so the producer can
            # never block forever on the bounded queue after a device
            # failure — the error re-raises in the consuming thread
            while True:
                item = inflight_q.get()
                if item is None:
                    break
        finally:
            futs_q.put(None)

    def produce():
        segs = []  # (frame, lo, hi) awaiting a full dispatch chunk
        pend = 0
        any_n = False
        w_run = [8]  # grow-only dispatch width (multiple of 8)

        def flush(rows, pad_rows=0):
            nonlocal segs
            take, got = [], 0
            while got < rows:
                fr, lo, hi = segs[0]
                need = rows - got
                if hi - lo <= need:
                    take.append(segs.pop(0))
                    got += hi - lo
                else:
                    take.append((fr, lo, lo + need))
                    segs[0] = (fr, lo + need, hi)
                    got = rows
            W = max(int(fr.seq_lens[lo:hi].max()) if hi > lo else 1
                    for fr, lo, hi in take)
            # grow-only width rounded to a multiple of 8: variable-length
            # lanes converge to one compiled shape instead of retracing
            # the jitted program per distinct chunk width
            w_run[0] = max(w_run[0], -(-W // 8) * 8)
            W = w_run[0]
            B = rows + pad_rows
            n_planes = len(thresholds) + (1 if any_n else 0)
            b2 = np.zeros((B, (W + 3) // 4), np.uint8)
            planes = np.zeros((B, n_planes, (W + 7) // 8), np.uint8)
            lengths = np.zeros(B, np.int16)
            r0 = 0
            for fr, lo, hi in take:
                nseg = hi - lo
                _timed(
                    "pack", native.pack2_lines,
                    fr.buf, fr.seq_starts[lo:hi], fr.qual_starts[lo:hi],
                    fr.seq_lens[lo:hi], W, q_offset, thresholds, any_n,
                    b2_out=b2, planes_out=planes, row0=r0,
                )
                lengths[r0:r0 + nseg] = fr.seq_lens[lo:hi]
                r0 += nseg
            fut = engines.fn2(any_n)(b2, planes, lengths)
            _timed("dispatch_stall", inflight_q.put, (rows, fut))

        def flush_all():
            nonlocal pend
            while pend >= chunk_rows:
                pend -= chunk_rows
                flush(chunk_rows)
            if pend:
                flush(pend, chunk_rows - pend)
                pend = 0

        try:
            for chunk, line_base in chunks:
                fr = None
                has_n = False
                if reader.is_fastq:
                    fr = _timed("frame+scan", codec.frame_fastq_fast, chunk)
                if fr is not None and _timed(
                    "frame+scan", native.validate_records,
                    fr.buf, fr.seq_starts, fr.seq_lens, fr.qual_starts,
                    allowed, q_offset,
                ) != -1:
                    fr = None  # byte error: the full parser raises exactly
                if fr is not None and len(fr) and int(fr.seq_lens.max()) > 25000:
                    # beyond the reference's MAX_SEQ_LINE_LENGTH
                    # (fastx.h:33-35) the dispatch's int16 length column
                    # could wrap; such reads take the classic int32 path
                    fr = None
                if fr is not None:
                    pure, has_n = native.scan_lines(
                        fr.buf, fr.seq_starts, fr.seq_lens
                    )
                    if not pure:
                        fr = None
                if fr is None:
                    # classic chunk: flush pending spans first so the
                    # decisions futures stay in read order, then dispatch
                    # the parsed batch through the unpacked program
                    flush_all()
                    batch = reader.parse_chunk(chunk, line_base)
                    (bases, quals, lengths, counts), nb = _pad(batch)
                    fut = engines.unpacked()(bases, quals, lengths, counts)
                    blocks_q.put(("classic", batch))
                    inflight_q.put((nb, fut))
                    continue
                if has_n and not any_n and pend:
                    # an N-bearing chunk after N-free ones changes the
                    # packed-plane layout; flush so dispatches stay uniform
                    flush_all()
                any_n = any_n or has_n
                blocks_q.put(("fast", fr))
                segs.append((fr, 0, len(fr)))
                pend += len(fr)
                while pend >= chunk_rows:
                    pend -= chunk_rows
                    flush(chunk_rows)
            if pend:
                flush(pend, chunk_rows - pend)
        except BaseException as e:
            err.append(e)
        finally:
            blocks_q.put(None)
            inflight_q.put(None)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    t_drain = threading.Thread(target=drain, daemon=True)
    t_drain.start()

    n_total = 0
    n_out = 0
    out_pos = 0
    cur = None  # [kind, block, new_len, keep, fill, fragile]
    spill_len = spill_keep = spill_frag = None
    mask_thr = cfg.mask_q if cfg.with_mask else None

    def next_block():
        nonlocal cur, spill_len, spill_keep, spill_frag
        b = blocks_q.get()
        if b is None:
            cur = None
            return False
        kind, blk = b
        n = len(blk)
        cur = [kind, blk, np.empty(n, np.int32), np.empty(n, bool), 0,
               np.zeros(n, bool) if tie else None]
        if spill_len is not None:
            take = min(len(spill_len), n)
            cur[2][:take] = spill_len[:take]
            cur[3][:take] = spill_keep[:take]
            if tie:
                cur[5][:take] = spill_frag[:take]
            cur[4] = take
            more = take < len(spill_len)
            spill_len = spill_len[take:] if more else None
            spill_keep = spill_keep[take:] if more else None
            spill_frag = spill_frag[take:] if (more and tie) else (
                spill_frag if more else None
            )
        return True

    def render_block(kind, blk, new_len, keep):
        nonlocal out_pos, n_out
        n_out += int(keep.sum())
        if kind == "fast":
            r = native.render_lines(
                blk.buf, blk.name_starts, blk.name_lens, blk.seq_starts,
                blk.qual_starts, blk.name2_starts, blk.name2_lens,
                new_len, keep.astype(np.uint8), out_fastq=out_fastq,
                q_offset=q_offset, mask_thr=mask_thr,
                out=arena, out_off=out_pos if arena is not None else 0,
            )
        else:
            blk.lengths = new_len
            # preserve each record's quality representation: a classic
            # chunk may carry numeric-quality FASTQ records the reference
            # re-emits numerically (fastx.c:382-390, write :449-468)
            ascii_q = (
                blk.qual_ascii
                if (blk.is_fastq and blk.qual_ascii is not None)
                else True
            )
            r = codec.render(
                blk, out_fastq=out_fastq, ascii_qual=ascii_q,
                q_offset=q_offset, keep=keep, mask_thr=mask_thr,
                out=arena, out_off=out_pos if arena is not None else 0,
            )
        if arena is not None:
            out_pos += r
        else:
            out_pos += len(r)
            write(r)

    # tie-fragile fixes run on a single worker thread so the float32
    # re-decides overlap the consumer's idle waits on the device link;
    # `ready` holds completed blocks in render order, each with its
    # pending fix (or None)
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    fixpool = ThreadPoolExecutor(max_workers=1) if tie else None
    ready: "deque" = deque()

    def drain_ready(block: bool):
        nonlocal n_total
        while ready:
            kind, blk, new_len, keep, fut = ready[0]
            if fut is not None and not block and not fut.done():
                return
            if fut is not None:
                fut.result()  # re-raises fixer errors in the consumer
            ready.popleft()
            _timed("render", render_block, kind, blk, new_len, keep)
            n_total += len(blk)

    def flush_if_done():
        nonlocal cur
        while cur is not None and cur[4] == len(cur[1]):
            kind, blk, new_len, keep, _, frag = cur
            fut = None
            if tie and frag is not None and frag.any():
                fut = fixpool.submit(
                    _fix_fragile, cfg, kind, blk, new_len, keep, frag,
                    q_offset,
                )
            ready.append((kind, blk, new_len, keep, fut))
            if not next_block():
                break
        drain_ready(block=False)

    try:
        if not next_block():
            t.join()
            t_drain.join()
            if err:
                raise err[0]
            return 0, 0, 0
        while True:
            item = futs_q.get()
            if item is None:
                break
            nrows, l, k, fg = item
            dlen = l[:nrows]
            dkeep = k[:nrows]
            dfrag = fg[:nrows] if tie else None
            pos = 0
            while pos < nrows and cur is not None:
                room = len(cur[1]) - cur[4]
                take = min(room, nrows - pos)
                cur[2][cur[4]:cur[4] + take] = dlen[pos:pos + take]
                cur[3][cur[4]:cur[4] + take] = dkeep[pos:pos + take]
                if tie:
                    cur[5][cur[4]:cur[4] + take] = dfrag[pos:pos + take]
                cur[4] += take
                pos += take
                flush_if_done()
            if pos < nrows:
                spill_len = dlen[pos:]
                spill_keep = dkeep[pos:]
                spill_frag = dfrag[pos:] if tie else None
        drain_ready(block=True)
    finally:
        if fixpool is not None:
            fixpool.shutdown(wait=False)
    t.join()
    t_drain.join()
    if err:
        raise err[0]
    if trace:
        import sys as _sys

        print(
            "lines trace: "
            + "  ".join("%s=%.3fs" % (k, v) for k, v in tr.items())
            + "  (frame/pack/stall on producer, drain on drainer, "
            "render on caller; legs overlap across threads)",
            file=_sys.stderr,
        )
    return n_total, n_out, out_pos


def _fix_fragile(cfg, kind, blk, new_len, keep, frag, q_offset):
    """Re-decide tie-fragile rows with the float32 host engine and patch
    the decisions in place (see LineEngines docstring)."""
    from . import hostfix

    idx = np.nonzero(frag)[0]
    if kind == "classic":
        b = np.ascontiguousarray(blk.bases[idx])
        q = np.ascontiguousarray(blk.quals[idx]).astype(np.int16)
        ln = np.asarray(blk.lengths)[idx].astype(np.int32)
    else:
        lens = np.ascontiguousarray(blk.seq_lens[idx])
        lm = max(int(lens.max()), 1)
        buf = np.frombuffer(blk.buf, np.uint8)
        b = native.gather_rows(
            buf, np.ascontiguousarray(blk.seq_starts[idx]), lens, lm
        )
        qa = native.gather_rows(
            buf, np.ascontiguousarray(blk.qual_starts[idx]), lens, lm
        )
        # beyond-length cells are unset; every consumer masks by length
        q = qa.astype(np.int16) - q_offset
        ln = lens.astype(np.int32)
    l_fix, k_fix = hostfix.host_decide(cfg, b, q, ln)
    new_len[idx] = l_fix
    keep[idx] = k_fix


def _pad(batch):
    """Pad a parsed batch to bucketed shapes for the unpacked decisions
    program (mirrors engine.pipeline.to_device)."""
    b, l = batch.bases.shape  # noqa: E741
    bb, ll = bucket_shape(max(b, 1), max(l, 1))
    bases = np.zeros((bb, ll), np.uint8)
    quals = np.zeros((bb, ll), np.int8)
    bases[:b, :l] = batch.bases
    quals[:b, :l] = batch.quals
    lengths = np.zeros(bb, np.int32)
    lengths[:b] = batch.lengths
    counts = np.zeros(bb, np.int32)
    counts[:b] = batch.counts
    return (bases, quals, lengths, counts), b
