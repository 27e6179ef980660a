"""Benchmark harness: reads/sec on the trim+filter+clip pipeline.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "reads/sec", "vs_baseline": N}

The default workload is BASELINE.json's headline config: the full fused
preprocessing chain (fastx_trimmer -> fastq_quality_filter ->
fastq_quality_trimmer -> fastq_masker -> fastx_clipper ->
fastx_artifacts_filter + per-cycle stats), end to end: FASTQ bytes are
parsed on the host, the fused step runs on device, surviving records are
rendered back to FASTQ bytes.

vs_baseline compares against the reference C tools compiled -O3 and run
as a shell pipeline (bench.py --cbaseline); headline: 56,085 reads/sec,
measured on an earlier development host's CPU.

Extra modes (VERDICT round-1 item #2):
  --config N     measure BASELINE.json config N (1..5) end to end
  --device       device-resident throughput (per-chip compute ceiling);
                 combine with --config N for that config's kernel
  --cbaseline    (re)measure the reference C pipelines for every config
                 with the exact commands recorded in C_CMDS below
  --scaling      multi-host scaling efficiency: fastx_quality_stats as
                 1 vs N cooperating fastx_pod processes (CPU backend,
                 core-pinned), merged output byte-verified
  --host         host-codec-only throughput: the exact run_once loop
                 (parse -> pack -> render, fused keep/mask) with the
                 device stubbed out; min(--host, --device) bounds the
                 end-to-end rate, and this measures the host leg of it.

The default, --device and --config modes measure the device and exit
with an error when JAX's default device is not a GPU.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

C_BASELINE_READS_PER_SEC = 56085.0
REPO = os.path.dirname(os.path.abspath(__file__))

N_READS = int(os.environ.get("FASTX_BENCH_READS", 1_000_000))
READ_LEN = int(os.environ.get("FASTX_BENCH_LEN", 100))
CHUNK = int(os.environ.get("FASTX_BENCH_CHUNK", 262144))
ADAPTER = b"CTGTAGGCACCATCAAT"


def synth_lane_bytes(n, read_len, seed=42) -> bytes:
    """Same generator as the C-baseline lane (seeded, adapter spiked)."""
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(n, read_len))
    has_ad = rng.random(n) < 0.3
    pos = rng.integers(30, read_len - 5, n)
    for j, ch in enumerate(ADAPTER):
        m = has_ad & (pos + j < read_len)
        bases[m, (pos + j)[m]] = ch
    cols = np.arange(read_len)
    quals = np.clip(rng.normal(36, 4, (n, read_len)) - (cols[None, :] / read_len) * 12, 2, 40)
    qual_ascii = (quals + 33).astype(np.uint8)

    # vectorized FASTQ assembly
    from fastx_toolkit_tpu.core.records import ReadBatch, StringColumn
    from fastx_toolkit_tpu.core import codec

    names = StringColumn.from_list([b"r%d" % i for i in range(n)])
    batch = ReadBatch(
        bases=bases.astype(np.uint8),
        quals=(qual_ascii.astype(np.int16) - 33).astype(np.int8),
        lengths=np.full(n, read_len, np.int32),
        counts=np.ones(n, np.int32),
        names=names,
        names2=StringColumn.from_list([b""] * n),
        is_fastq=True,
        qual_ascii=np.ones(n, bool),
    )
    return codec.render(batch, out_fastq=True, ascii_qual=True, q_offset=33)


BLOCK_BYTES = int(os.environ.get("FASTX_BENCH_BLOCK", 32 * 1024 * 1024))


def _dispatch_chunk(bases, quals, lengths, fns, cfg):
    """Pack one exactly-CHUNK-row chunk and dispatch it (async).
    Layout choice per chunk: 2-bit bases for pure-ACGTN chunks (the N
    bit-plane shipped only if the chunk has any N), 4-bit bases
    otherwise; 1-bit quality planes and int16 lengths either way.  The
    headline config needs no counts upload (stats off)."""
    from fastx_toolkit_tpu.engine.pipeline import (
        pack_batch,
        pack_batch2,
        scan_alphabet,
    )

    fn2_clean, fn2, fn4 = fns
    pure, has_n = scan_alphabet(bases)
    if pure:
        b2, planes = pack_batch2(bases, quals, cfg, n_plane=has_n)
        fn = fn2 if has_n else fn2_clean
        return fn(b2, planes, lengths)
    b4, planes = pack_batch(bases, quals, cfg)
    return fn4(b4, planes, lengths)


def run_once(data: bytes, fns, cfg, arena, *, out_fastq: bool = True) -> tuple[int, int]:
    """Parse -> device pipeline (chunked, decisions only) -> host render,
    fully overlapped and padding-free.

    A producer thread block-parses the byte stream (BatchReader record
    framing) and accumulates reads across block boundaries so every
    dispatched chunk is exactly CHUNK rows — no padding inflation on the
    device link (only the final chunk of the lane is padded).  The main
    thread walks the decision futures in order, scatters them back onto
    the parsed blocks, and renders each block as soon as its last
    decision arrives, while later blocks are still parsing/packing/
    transferring.  The device returns only (final_length, keep, stats)
    per read; the masker's byte edits are re-applied during the native
    render pass."""
    import io
    import queue
    import threading
    from types import SimpleNamespace

    from fastx_toolkit_tpu.cli.tools._shared import BatchReader
    from fastx_toolkit_tpu.core import codec

    args = SimpleNamespace(input_filename="<bench>", q_offset=33)
    reader = BatchReader(
        None, args, filetype=codec.FASTQ_ONLY,
        block_bytes=BLOCK_BYTES, stream=io.BytesIO(data),
    )

    # per-leg waterfall (FASTX_BENCH_WATERFALL=1): cumulative seconds in
    # each leg; parse/pack/drain live on the producer thread, render on
    # the main thread, so legs on different threads overlap in wall time
    waterfall = os.environ.get("FASTX_BENCH_WATERFALL")
    wf = {"parse": 0.0, "pack+dispatch": 0.0, "drain(link)": 0.0,
          "render": 0.0}

    def timed(leg, f, *a):
        if not waterfall:
            return f(*a)
        t0 = time.perf_counter()
        r = f(*a)
        wf[leg] += time.perf_counter() - t0
        return r

    blocks_q: "queue.Queue" = queue.Queue()
    futs_q: "queue.Queue" = queue.Queue(maxsize=32)
    err = []

    def assemble(pieces, pad_rows=0):
        """Stack (bases, quals, lengths) pieces of possibly different
        widths into one chunk, zero-padding narrow pieces on the right
        and optionally adding pad_rows all-PAD rows at the bottom."""
        w = max(p[0].shape[1] for p in pieces)
        cb = np.concatenate(
            [np.pad(p[0], ((0, 0), (0, w - p[0].shape[1]))) for p in pieces]
        )
        cq = np.concatenate(
            [np.pad(p[1], ((0, 0), (0, w - p[1].shape[1]))) for p in pieces]
        )
        cl = np.concatenate([p[2] for p in pieces])
        if pad_rows:
            cb = np.pad(cb, ((0, pad_rows), (0, 0)))
            cq = np.pad(cq, ((0, pad_rows), (0, 0)))
            cl = np.pad(cl, (0, pad_rows))
        return cb, cq, cl

    # Keep a small fixed number of chunks in flight: upload of chunk i+1
    # overlaps compute+readback of chunk i, nothing more.  The bounded
    # inflight queue enforces the pacing; a dedicated drainer thread
    # blocks on the device readback so the link wait overlaps the
    # producer's parse/pack instead of serializing with it (the round-2
    # waterfall showed parse ~1.0s and drain ~0.8s back to back on one
    # thread).
    inflight_max = int(os.environ.get("FASTX_BENCH_INFLIGHT", 2))
    # total dispatched-but-undrained chunks = queue depth + the one the
    # drainer holds, so the queue is one slot smaller than the budget
    inflight_q: "queue.Queue" = queue.Queue(maxsize=max(1, inflight_max - 1))

    def drain():
        try:
            while True:
                item = inflight_q.get()
                if item is None:
                    break
                nrows, fut = item
                futs_q.put((nrows, timed("drain(link)", np.asarray, fut[0]),
                            np.asarray(fut[1])))
        except BaseException as e:
            err.append(e)
            # keep consuming so the producer can't block on the bounded
            # queue after a device failure
            while True:
                item = inflight_q.get()
                if item is None:
                    break
        finally:
            futs_q.put(None)

    def produce():
        carry = []  # [(bases, quals, lengths_i16)] awaiting a full chunk
        pend = 0

        def next_batch(it):
            try:
                return timed("parse", next, it)
            except StopIteration:
                return None

        try:
            batches = iter(reader)
            while True:
                batch = next_batch(batches)
                if batch is None:
                    break
                blocks_q.put(batch)
                carry.append((
                    np.asarray(batch.bases),
                    np.asarray(batch.quals),
                    np.asarray(batch.lengths, np.int16),
                ))
                pend += len(batch)
                while pend >= CHUNK:
                    pend -= CHUNK
                    take, got = [], 0
                    while got < CHUNK:
                        b, q, l = carry[0]  # noqa: E741
                        need = CHUNK - got
                        if len(b) <= need:
                            take.append(carry.pop(0))
                            got += len(b)
                        else:
                            take.append((b[:need], q[:need], l[:need]))
                            carry[0] = (b[need:], q[need:], l[need:])
                            got = CHUNK
                    cb, cq, cl = assemble(take)
                    inflight_q.put(
                        (CHUNK,
                         timed("pack+dispatch", _dispatch_chunk, cb, cq, cl,
                               fns, cfg))
                    )
            if pend:
                cb, cq, cl = assemble(carry, pad_rows=CHUNK - pend)
                inflight_q.put(
                    (pend,
                     timed("pack+dispatch", _dispatch_chunk, cb, cq, cl,
                           fns, cfg))
                )
        except BaseException as e:  # surface in the main thread
            err.append(e)
        finally:
            blocks_q.put(None)
            inflight_q.put(None)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    t_drain = threading.Thread(target=drain, daemon=True)
    t_drain.start()

    # consumer: futures arrive in global read order; fill each block's
    # decision buffers and render the moment a block completes
    n_total = 0
    out_pos = 0  # write cursor into the preallocated output arena
    cur = None  # (batch, new_len buf, keep buf, fill pos)
    spill_len = spill_keep = None  # decision rows awaiting the next block

    def next_block():
        nonlocal cur, spill_len, spill_keep
        b = blocks_q.get()
        if b is None:
            cur = None
            return False
        n = len(b)
        cur = [b, np.empty(n, np.int32), np.empty(n, bool), 0]
        if spill_len is not None:
            take = min(len(spill_len), n)
            cur[1][:take] = spill_len[:take]
            cur[2][:take] = spill_keep[:take]
            cur[3] = take
            spill_len = spill_len[take:] if take < len(spill_len) else None
            spill_keep = spill_keep[take:] if spill_len is not None else None
        return True

    def flush_if_done():
        nonlocal cur, n_total, out_pos
        while cur is not None and cur[3] == len(cur[0]):
            batch, new_len, keep, _ = cur
            batch.lengths = new_len
            # the masker's byte edits and the keep-filter are fused into
            # the native render loop (zero extra passes), which writes
            # straight into the output arena (no bytes objects, no join)
            out_pos += timed(
                "render", lambda: codec.render(
                    batch, out_fastq=out_fastq, ascii_qual=True, q_offset=33,
                    keep=keep, mask_thr=cfg.mask_q if cfg.with_mask else None,
                    out=arena, out_off=out_pos,
                )
            )
            n_total += len(batch)
            if not next_block():
                break

    if not next_block():
        t.join()
        t_drain.join()
        if err:
            raise err[0]
        return 0, 0
    while True:
        item = futs_q.get()
        if item is None:
            break
        nrows, l, k = item
        dlen = l[:nrows]
        dkeep = k[:nrows]
        pos = 0
        while pos < nrows and cur is not None:
            room = len(cur[0]) - cur[3]
            take = min(room, nrows - pos)
            cur[1][cur[3]:cur[3] + take] = dlen[pos:pos + take]
            cur[2][cur[3]:cur[3] + take] = dkeep[pos:pos + take]
            cur[3] += take
            pos += take
            flush_if_done()
        if pos < nrows:  # block not parsed yet (can't happen: futures
            # trail blocks) or stream ended — keep as spill
            spill_len = dlen[pos:]
            spill_keep = dkeep[pos:]
    t.join()
    t_drain.join()
    if err:
        raise err[0]
    if waterfall:
        print(
            "waterfall: "
            + "  ".join("%s=%.3fs" % (k, v) for k, v in wf.items())
            + "  (parse/pack/drain on producer thread, render on main; "
            "legs overlap)",
            file=sys.stderr,
        )
    return n_total, out_pos


def run_once_auto(data: bytes, engines, cfg, arena, *,
                  out_fastq: bool = True) -> tuple[int, int]:
    """The package's raw-line streaming engine
    (fastx_toolkit_tpu.engine.lines.stream_pipeline_lines): frame +
    validate line spans, pack the 2-bit upload straight from them,
    render from spans + device decisions, with per-chunk classic
    fallback — bench measures library code, not a bench-local loop.
    ``engines`` is a LineEngines (or stub duck-type) reused across
    iterations so jitted programs are traced once."""
    import io
    from types import SimpleNamespace

    from fastx_toolkit_tpu.cli.tools._shared import BatchReader
    from fastx_toolkit_tpu.core import codec, native
    from fastx_toolkit_tpu.engine.lines import stream_pipeline_lines

    if native.LIB is None:
        raise RuntimeError("bench requires the native codec library")
    args = SimpleNamespace(input_filename="<bench>", q_offset=33)
    reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                         block_bytes=BLOCK_BYTES, stream=io.BytesIO(data))
    n_in, _n_out, nbytes = stream_pipeline_lines(
        reader, cfg, out_fastq=out_fastq, q_offset=33, write=None,
        arena=arena, chunk_rows=CHUNK, engines=engines,
    )
    return n_in, nbytes


class StubEngines:
    """Device stub for --host: identity decisions, zero device work."""

    def fn2(self, has_n):
        def stub(b2, planes, lengths):
            lens = np.asarray(lengths, np.int32)
            return lens, np.ones(len(lens), bool)
        return stub

    def unpacked(self):
        def stub(bases, quals, lengths, counts):
            lens = np.asarray(lengths, np.int32)
            return lens, np.ones(len(lens), bool), None
        return stub


# ---------------------------------------------------------------------------
# BASELINE.json configs 1-5 (VERDICT round-1 item #2)
# ---------------------------------------------------------------------------
#
# The exact reference commands measured by --cbaseline (these ARE the
# recorded baseline workloads; C_BASELINE holds their measured reads/sec
# on an earlier development host's CPU):

C_CMDS = {
    0: "{bin}/fastx_trimmer -Q 33 -i {lane} | {bin}/fastq_quality_filter -Q 33 -q 20 -p 50"
       " | {bin}/fastq_quality_trimmer -Q 33 -t 20 | {bin}/fastq_masker -Q 33 -q 20"
       " | {bin}/fastx_clipper -Q 33 -a CTGTAGGCACCATCAAT -n"
       " | {bin}/fastx_artifacts_filter -Q 33 > /dev/null",
    1: "{bin}/fastx_trimmer -Q 33 -f 1 -l 80 -i {lane} | {bin}/fastq_to_fasta -Q 33 > /dev/null",
    2: "{bin}/fastq_quality_filter -Q 33 -q 20 -p 50 -i {lane}"
       " | {bin}/fastq_quality_trimmer -Q 33 -t 20"
       " | {bin}/fastq_masker -Q 33 -q 20 > /dev/null",
    3: "{bin}/fastx_quality_stats -Q 33 -i {lane} > /dev/null",
    4: "{bin}/fastx_clipper -Q 33 -a CTGTAGGCACCATCAAT -l 15 -i {lane100k}"
       " | {bin}/fastx_artifacts_filter -Q 33 > /dev/null",
    5: "{bin}/fastx_collapser -Q 33 -i {lane} > /dev/null",
}

# measured reads/sec of the commands above (bench.py --cbaseline,
# best-of-3, reference compiled -O3; this machine, 2026-08-20).  The
# headline (config 0) keeps the round-1 measurement 56,085 r/s for
# artifact continuity; the same chain re-measured with the recorded
# command gave 48,642 r/s, so 56,085 is the stricter baseline.
C_BASELINE = {
    0: C_BASELINE_READS_PER_SEC,
    1: 261572.0,
    2: 122531.0,
    3: 1001903.0,
    4: 66551.0,
    5: 280649.0,
}

METRIC = {
    0: "reads_per_sec_trim_filter_clip_pipeline",
    1: "reads_per_sec_config1_trim_tofasta",
    2: "reads_per_sec_config2_quality_chain",
    3: "reads_per_sec_config3_quality_stats",
    4: "reads_per_sec_config4_clip_artifacts",
    5: "reads_per_sec_config5_collapser",
}

CONFIG_READS = {4: min(N_READS, 100_000)}  # clipper C baseline uses 100k


def config_cfg(n: int):
    """(PipelineConfig, render_fastq) for the decision-pipeline configs."""
    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig

    if n == 1:  # fastx_trimmer -f 1 -l 80 | fastq_to_fasta
        return PipelineConfig(
            adapter=ADAPTER, trim_last=80, with_filter=False, with_qtrim=False,
            with_mask=False, with_clip=False, with_artifacts=False,
            to_fasta_discard_n=True,
        ), False
    if n == 2:  # quality filter | trimmer | masker at Q20
        return PipelineConfig(adapter=ADAPTER, with_clip=False,
                              with_artifacts=False), True
    if n == 4:  # fastx_clipper -l 15 | fastx_artifacts_filter
        return PipelineConfig(
            adapter=ADAPTER, with_filter=False, with_qtrim=False,
            with_mask=False, clip_keep_n=False, clip_minlen=15,
        ), True
    return PipelineConfig(adapter=ADAPTER), True  # headline (config 0)


def emit(config_n: int, rps: float, suffix: str = ""):
    print(json.dumps({
        "metric": METRIC[config_n] + suffix,
        "value": round(rps, 1),
        "unit": "reads/sec",
        "vs_baseline": round(rps / C_BASELINE[config_n], 3),
    }))


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def emit_times(config_n: int, n_reads: int, times, suffix: str = "",
               extra: dict | None = None):
    """Official per-config artifact line: the parsed value is the
    MEDIAN-of-N reads/sec; best and the iteration spread ride alongside
    for context."""
    med = n_reads / _median(times)
    print(json.dumps({
        "metric": METRIC[config_n] + suffix,
        "value": round(med, 1),
        "unit": "reads/sec",
        "vs_baseline": round(med / C_BASELINE[config_n], 3),
        "stat": "median_of_%d" % len(times),
        "best_reads_per_sec": round(n_reads / min(times), 1),
        "iter_secs": [round(t, 3) for t in sorted(times)],
        **(extra or {}),
    }))


def run_config_pipeline(config_n: int):
    """End-to-end measurement for the decision-pipeline configs 0/1/2/4:
    the package streaming engine (frame -> packed upload -> fused device
    step -> span-native render)."""
    from fastx_toolkit_tpu.engine.lines import LineEngines

    cfg, out_fastq = config_cfg(config_n)
    eng = LineEngines(cfg)
    n_reads = CONFIG_READS.get(config_n, N_READS)
    data = synth_lane_bytes(n_reads, READ_LEN)
    print("config %d lane: %d reads, %d bytes" % (config_n, n_reads, len(data)),
          file=sys.stderr)
    arena = np.empty(len(data) + (1 << 20), np.uint8)
    arena[::4096] = 0
    t0 = time.perf_counter()
    run_once_auto(synth_lane_bytes(2048, READ_LEN, seed=7), eng, cfg, arena,
                  out_fastq=out_fastq)
    print("warmup %.1fs" % (time.perf_counter() - t0), file=sys.stderr)
    times = []
    for it in range(int(os.environ.get("FASTX_BENCH_ITERS", 7))):
        t0 = time.perf_counter()
        n, nbytes = run_once_auto(data, eng, cfg, arena, out_fastq=out_fastq)
        dt = time.perf_counter() - t0
        times.append(dt)
        print("iter %d: %.3fs  (%.0f reads/s, %d bytes out)"
              % (it, dt, n / dt, nbytes), file=sys.stderr)
    _maybe_dump(bytes(arena[:nbytes]))
    emit_times(config_n, n_reads, times)


def _maybe_dump(out: bytes):
    """FASTX_BENCH_DUMP=path writes the final iteration's output bytes so
    the bench workload itself can be byte-compared against the reference
    C pipeline."""
    path = os.environ.get("FASTX_BENCH_DUMP")
    if path:
        with open(path, "wb") as fh:
            fh.write(out)


def run_config_stats(device_resident: bool = False):
    """Config 3: fastx_quality_stats over the lane.

    Engine choice like the CLI (ops/stats.py stats_path): the host C++
    histogram kernel (one int64 increment per base, threaded) or the
    device scatter-add reduction (accumulate_jit) on padded batches."""
    import io
    from collections import deque
    from types import SimpleNamespace

    import jax

    from fastx_toolkit_tpu.cli.tools._shared import BatchReader
    from fastx_toolkit_tpu.core import codec
    from fastx_toolkit_tpu.ops import stats as stats_ops

    if not device_resident and stats_ops.stats_path() == "host":
        run_config_stats_host()
        return

    def fn(bases, quals, lengths):
        return stats_ops.accumulate_jit(bases, quals, lengths,
                                        np.ones(len(lengths), np.int32),
                                        is_fastq=True)

    if device_resident:
        rng = np.random.default_rng(0)
        bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(CHUNK, READ_LEN))
        quals = rng.integers(2, 41, size=(CHUNK, READ_LEN)).astype(np.int8)
        lengths = np.full(CHUNK, READ_LEN, np.int32)
        xs = [jax.device_put(a) for a in (bases, quals, lengths)]
        jax.block_until_ready(fn(*xs))  # compile
        best = timed_device_chain(fn, xs, jax.block_until_ready)
        emit(3, CHUNK / best, suffix="_device_resident")
        return

    n_reads = CONFIG_READS.get(3, N_READS)
    data = synth_lane_bytes(n_reads, READ_LEN)
    print("config 3 lane: %d reads, %d bytes" % (n_reads, len(data)), file=sys.stderr)
    inflight_max = int(os.environ.get("FASTX_BENCH_INFLIGHT", 2))
    TILE = 512  # batch-row padding: a few compiled shapes, not one per block

    def once() -> bytes:
        args = SimpleNamespace(input_filename="<bench>", q_offset=33)
        reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                             block_bytes=BLOCK_BYTES, stream=io.BytesIO(data))
        total = None
        inflight = deque()

        def drain_one():
            nonlocal total
            parts = [np.asarray(p) for p in inflight.popleft()]
            if total is None:
                total = stats_ops.StatsAccumulator.empty(parts[0].shape[0])
            total.merge_partial(*parts)

        for batch in reader:
            bases = np.asarray(batch.bases)
            quals = np.ascontiguousarray(batch.quals, np.int8)
            lengths = np.asarray(batch.lengths, np.int32)
            B = len(lengths)
            pad = -(-B // TILE) * TILE - B
            if pad:
                bases = np.pad(bases, ((0, pad), (0, 0)))
                quals = np.pad(quals, ((0, pad), (0, 0)))
                lengths = np.pad(lengths, (0, pad))
            inflight.append(fn(bases, quals, lengths))
            if len(inflight) >= inflight_max:
                drain_one()
        while inflight:
            drain_one()
        return stats_ops.render_old_format(total).encode()

    t0 = time.perf_counter()
    out = once()
    print("iter 0 (compile): %.3fs" % (time.perf_counter() - t0), file=sys.stderr)
    times = []
    for it in range(int(os.environ.get("FASTX_BENCH_ITERS", 7))):
        t0 = time.perf_counter()
        out = once()
        dt = time.perf_counter() - t0
        times.append(dt)
        print("iter %d: %.3fs  (%.0f reads/s, %d bytes out)"
              % (it + 1, dt, n_reads / dt, len(out)), file=sys.stderr)
    _maybe_dump(out)
    emit_times(3, n_reads, times)


def run_config_stats_host():
    """Config 3, host path: the CLI's fused raw-line engine — frame the
    chunk's line spans, validate, and accumulate the per-(cycle, nuc,
    quality) histogram straight from the byte buffer (fx_stats_lines_q);
    no padded matrices, no device link."""
    import io
    from types import SimpleNamespace

    from fastx_toolkit_tpu.cli.tools._shared import BatchReader
    from fastx_toolkit_tpu.core import codec, native
    from fastx_toolkit_tpu.ops import stats as stats_ops

    n_reads = CONFIG_READS.get(3, N_READS)
    data = synth_lane_bytes(n_reads, READ_LEN)
    print("config 3 lane: %d reads, %d bytes (host path)" % (n_reads, len(data)),
          file=sys.stderr)
    allowed = codec.allowed_table_u8()

    def once() -> bytes:
        from fastx_toolkit_tpu.cli.tools._shared import prefetch_iter

        args = SimpleNamespace(input_filename="<bench>", q_offset=33)
        reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                             block_bytes=BLOCK_BYTES, stream=io.BytesIO(data))

        def framed():
            for chunk, line_base in reader.iter_chunks():
                yield chunk, line_base, codec.frame_fastq_fast(chunk)

        total = None
        for chunk, line_base, fr in prefetch_iter(framed()):
            if fr is not None:
                buf, ss, sl, qs = fr
                if native.validate_records(buf, ss, sl, qs, allowed, 33) == -1:
                    width = int(sl.max()) if len(sl) else 0
                    h = native.stats_lines_q(buf, ss, qs, sl, width, 33)
                else:
                    raise RuntimeError("bench lane failed validation")
            else:  # fallback: full parse + padded-matrix kernel
                batch = reader.parse_chunk(chunk, line_base)
                h = native.stats_hist_q(
                    np.ascontiguousarray(batch.bases, np.uint8),
                    np.ascontiguousarray(batch.quals, np.int8),
                    np.ascontiguousarray(batch.lengths, np.int32),
                )
            if total is None:
                total = h
            elif h.shape[0] <= total.shape[0]:
                total[: h.shape[0]] += h
            else:
                h[: total.shape[0]] += total
                total = h
        acc = stats_ops.StatsAccumulator.empty(total.shape[0])
        acc.merge_partial(*stats_ops.derive_from_hist(total))
        return stats_ops.render_old_format(acc).encode()

    t0 = time.perf_counter()
    out = once()
    print("iter 0 (warm): %.3fs" % (time.perf_counter() - t0), file=sys.stderr)
    times = []
    for it in range(int(os.environ.get("FASTX_BENCH_ITERS", 7))):
        t0 = time.perf_counter()
        out = once()
        dt = time.perf_counter() - t0
        times.append(dt)
        print("iter %d: %.3fs  (%.0f reads/s, %d bytes out)"
              % (it + 1, dt, n_reads / dt, len(out)), file=sys.stderr)
    _maybe_dump(out)
    emit_times(3, n_reads, times)


def _collapse_chunks_fn(n_chunks: int):
    import jax
    import jax.numpy as jnp

    from fastx_toolkit_tpu.ops.collapse import collapse

    @jax.jit
    def f(n_real, *chunks):
        words = jnp.concatenate(chunks, axis=0)
        B = words.shape[0]
        idx = jnp.arange(B, dtype=jnp.int32)
        counts = (idx < n_real).astype(jnp.int32)
        perm, head, seg_id, seg_counts, seg_first = collapse(words, counts, idx)
        return head, seg_counts, seg_first

    return f


def _block_keys(bases: np.ndarray, lengths: np.ndarray, width: int):
    """Injective per-read sort keys as uint32 words: 2-bit packed bases
    (+ N bit-plane words when the block has any N) + the length word.
    Equality of keys == equality of sequences over the ACGTN alphabet."""
    from fastx_toolkit_tpu.engine.pipeline import (
        PipelineConfig,
        pack_batch2,
        scan_alphabet,
    )

    B, L = bases.shape
    if L < width:
        bases = np.pad(bases, ((0, 0), (0, width - L)))
    cfg0 = PipelineConfig(with_filter=False, with_qtrim=False, with_mask=False)
    pure, has_n = scan_alphabet(bases)
    dummy_q = np.zeros(bases.shape, np.int8)
    if pure:
        b2, planes = pack_batch2(bases, dummy_q, cfg0, n_plane=True)
    else:  # full-alphabet fallback: one byte per base is still injective
        from fastx_toolkit_tpu.ops.collapse import pack_words

        w = pack_words(bases)
        return np.concatenate(
            [w, lengths.astype(np.uint32)[:, None]], axis=1
        ).astype(np.uint32)
    parts = [b2]
    if has_n:
        parts.append(planes[:, 0])
    cols = []
    for p in parts:
        pw = p.shape[1]
        pad = (-pw) % 4
        if pad:
            p = np.pad(p, ((0, 0), (0, pad)))
        cols.append(p.reshape(B, -1, 4).view(np.uint32).reshape(B, -1))
    cols.append(lengths.astype(np.uint32)[:, None])
    return np.ascontiguousarray(np.concatenate(cols, axis=1))


def run_config_collapse_host():
    """Config 5, host path: the CLI's fused raw-line engine — frame +
    validate the chunk, insert keys into the native hash table straight
    from the byte buffer (fx_dedup_insert_lines), rank-count FASTA render
    at the end."""
    import io
    from types import SimpleNamespace

    from fastx_toolkit_tpu.cli.tools._shared import BatchReader
    from fastx_toolkit_tpu.core import codec, native
    from fastx_toolkit_tpu.core.records import ReadBatch, StringColumn
    from fastx_toolkit_tpu.ops.collapse import final_order

    n_reads = CONFIG_READS.get(5, N_READS)
    data = synth_lane_bytes(n_reads, READ_LEN)
    print("config 5 lane: %d reads, %d bytes (host path)" % (n_reads, len(data)),
          file=sys.stderr)
    arena = np.empty(len(data) + (1 << 20), np.uint8)
    arena[::4096] = 0
    allowed = codec.allowed_table_u8()

    def once() -> int:
        from fastx_toolkit_tpu.cli.tools._shared import prefetch_iter

        args = SimpleNamespace(input_filename="<bench>", q_offset=33)
        reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                             block_bytes=BLOCK_BYTES, stream=io.BytesIO(data))

        def framed():
            for chunk, line_base in reader.iter_chunks():
                yield chunk, line_base, codec.frame_fastq_fast(chunk)

        table = native.DedupTable()
        rec_base = 0
        for chunk, line_base, fr in prefetch_iter(framed()):
            if fr is not None:
                buf, ss, sl, qs = fr
                if native.validate_records(buf, ss, sl, qs, allowed, 33) == -1:
                    table.insert_lines(buf, ss, sl, rec_base)
                    rec_base += len(ss)
                    continue
                raise RuntimeError("bench lane failed validation")
            batch = reader.parse_chunk(chunk, line_base)
            table.insert(batch.bases, batch.lengths, None, rec_base)
            rec_base += len(batch)
        key_offs, key_buf, uniq_counts, uniq_first = table.extract()
        table.close()
        order = final_order(uniq_counts, uniq_first)
        oc = uniq_counts[order]
        key_lens = np.diff(key_offs)
        starts = np.ascontiguousarray(key_offs[:-1][order])
        lens = np.ascontiguousarray(key_lens[order])
        width = int(lens.max()) if len(lens) else 0
        out_bases = native.gather_rows(key_buf, starts, lens, width)
        from fastx_toolkit_tpu.ops.collapse import rank_count_column

        nb, no = rank_count_column(oc)
        names = StringColumn(nb, no)
        U = len(oc)
        out_batch = ReadBatch(
            bases=out_bases, quals=np.zeros((U, 0), np.int8),
            lengths=lens.astype(np.int32), counts=np.asarray(oc, np.int32),
            names=names, names2=StringColumn.from_list([b""] * U),
            is_fastq=False, qual_ascii=np.ones(U, bool),
        )
        return codec.render(out_batch, out_fastq=False, ascii_qual=True,
                            q_offset=33, out=arena, out_off=0)

    t0 = time.perf_counter()
    nbytes = once()
    print("iter 0 (warm): %.3fs" % (time.perf_counter() - t0), file=sys.stderr)
    times = []
    for it in range(int(os.environ.get("FASTX_BENCH_ITERS", 7))):
        t0 = time.perf_counter()
        nbytes = once()
        dt = time.perf_counter() - t0
        times.append(dt)
        print("iter %d: %.3fs  (%.0f reads/s, %d bytes out)"
              % (it + 1, dt, n_reads / dt, nbytes), file=sys.stderr)
    _maybe_dump(bytes(arena[:nbytes]))
    emit_times(5, n_reads, times)


def run_config_collapse(device_resident: bool = False):
    """Config 5: fastx_collapser over the lane — parse -> packed sort keys
    -> device lexsort + segment-reduce -> rank-count FASTA render.
    Link-aware like the CLI (cli/tools/fastx_collapser.py collapse_path):
    the default is the native hash-table engine;
    FASTX_COLLAPSE_PATH=device selects the device sort path."""
    import io
    from types import SimpleNamespace

    import jax

    from fastx_toolkit_tpu.cli.tools._shared import BatchReader
    from fastx_toolkit_tpu.core import codec
    from fastx_toolkit_tpu.core.records import ReadBatch, StringColumn
    from fastx_toolkit_tpu.ops.collapse import final_order

    if not device_resident:
        from fastx_toolkit_tpu.cli.tools.fastx_collapser import collapse_path

        if collapse_path() == "host":
            run_config_collapse_host()
            return

    if device_resident:
        import functools as _ft

        from fastx_toolkit_tpu.ops.collapse import collapse_hashed_jit

        rng = np.random.default_rng(0)
        bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(CHUNK, READ_LEN))
        words = _block_keys(bases, np.full(CHUNK, READ_LEN, np.int32), READ_LEN)
        xs = [jax.device_put(a) for a in
              (words, np.ones(CHUNK, np.int32), np.arange(CHUNK, dtype=np.int32))]
        _ = [np.asarray(x[:1]) for x in xs]
        # unit_counts: the lane is plain FASTQ (counts all 1), the same
        # static fast path collapse_batch takes for it
        fn = _ft.partial(collapse_hashed_jit, unit_counts=True)
        out = fn(*xs)
        _ = np.asarray(out[1][:1])  # compile + sync
        assert not bool(np.asarray(out[5])), "hash collision on bench lane"
        best = timed_device_chain(fn, xs, jax.block_until_ready)
        emit(5, CHUNK / best, suffix="_device_resident")
        return

    n_reads = CONFIG_READS.get(5, N_READS)
    data = synth_lane_bytes(n_reads, READ_LEN)
    print("config 5 lane: %d reads, %d bytes" % (n_reads, len(data)), file=sys.stderr)
    arena = np.empty(len(data) + (1 << 20), np.uint8)
    arena[::4096] = 0
    fn_cache: dict = {}

    def once() -> int:
        args = SimpleNamespace(input_filename="<bench>", q_offset=33)
        reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                             block_bytes=BLOCK_BYTES, stream=io.BytesIO(data))
        blocks = []  # (bases, lengths) kept for the final gather/render
        dev_chunks = []
        carry = []
        pend = 0
        width = READ_LEN

        def flush_chunk(rows_needed):
            nonlocal pend
            take, got = [], 0
            while got < rows_needed and carry:
                k = carry[0]
                need = rows_needed - got
                if len(k) <= need:
                    take.append(carry.pop(0))
                    got += len(k)
                else:
                    take.append(k[:need])
                    carry[0] = k[need:]
                    got = rows_needed
            chunk = np.concatenate(take) if len(take) > 1 else take[0]
            if len(chunk) < CHUNK:  # tail: pad with count-0 rows
                chunk = np.pad(chunk, ((0, CHUNK - len(chunk)), (0, 0)))
            dev_chunks.append(jax.device_put(chunk))
            pend -= min(rows_needed, CHUNK)

        for batch in reader:
            bases = np.asarray(batch.bases)
            lengths = np.asarray(batch.lengths, np.int32)
            blocks.append((bases, lengths))
            carry.append(_block_keys(bases, lengths, width))
            pend += len(lengths)
            while pend >= CHUNK:
                flush_chunk(CHUNK)
        if pend:
            flush_chunk(pend)

        fn = fn_cache.setdefault(len(dev_chunks), _collapse_chunks_fn(len(dev_chunks)))
        head, seg_counts, seg_first = (
            np.asarray(x) for x in fn(np.int32(n_reads), *dev_chunks)
        )
        nseg = int(head.sum())
        uniq_counts = seg_counts[:nseg]
        uniq_first = seg_first[:nseg]
        real = uniq_counts > 0  # drop the padding segment
        uniq_counts = uniq_counts[real]
        uniq_first = uniq_first[real]
        order = final_order(uniq_counts, uniq_first)
        oc = uniq_counts[order]
        of = uniq_first[order]
        # gather representative rows from the stored blocks
        all_bases = np.concatenate([b for b, _ in blocks]) if len(blocks) > 1 else blocks[0][0]
        all_lens = np.concatenate([l for _, l in blocks]) if len(blocks) > 1 else blocks[0][1]
        out_bases = all_bases[of]
        out_lens = all_lens[of]
        names = StringColumn.from_list(
            [b"%d-%d" % (r, c) for r, c in enumerate(oc.tolist(), start=1)]
        )
        U = len(oc)
        out_batch = ReadBatch(
            bases=out_bases, quals=np.zeros((U, 0), np.int8),
            lengths=out_lens, counts=np.asarray(oc, np.int32),
            names=names, names2=StringColumn.from_list([b""] * U),
            is_fastq=False, qual_ascii=np.ones(U, bool),
        )
        return codec.render(out_batch, out_fastq=False, ascii_qual=True,
                            q_offset=33, out=arena, out_off=0)

    t0 = time.perf_counter()
    nbytes = once()
    print("iter 0 (compile): %.3fs" % (time.perf_counter() - t0), file=sys.stderr)
    times = []
    for it in range(int(os.environ.get("FASTX_BENCH_ITERS", 7))):
        t0 = time.perf_counter()
        nbytes = once()
        dt = time.perf_counter() - t0
        times.append(dt)
        print("iter %d: %.3fs  (%.0f reads/s, %d bytes out)"
              % (it + 1, dt, n_reads / dt, nbytes), file=sys.stderr)
    _maybe_dump(bytes(arena[:nbytes]))
    emit_times(5, n_reads, times)


def cbaseline():
    """(Re)measure the reference C pipelines (compiled -O3) for every
    config with the exact C_CMDS commands; prints one JSON line each."""
    import subprocess
    import tempfile

    R = "/root/reference/src"
    bindir = "/tmp/fastx_refbin_O3"
    if not os.path.exists(os.path.join(bindir, "fastx_collapser")):
        os.makedirs(bindir, exist_ok=True)
        with open(os.path.join(bindir, "config.h"), "w") as fh:
            fh.write('#define PACKAGE_STRING "FASTX Toolkit 0.0.14"\n')
        objs = []
        for src in ("fastx.c", "fastx_args.c", "chomp.c"):
            o = os.path.join(bindir, src + ".o")
            subprocess.run(["gcc", "-O3", "-I", bindir, "-I", f"{R}/libfastx",
                            "-c", f"{R}/libfastx/{src}", "-o", o],
                           check=True, capture_output=True)
            objs.append(o)
        for t in ("fastq_to_fasta", "fastq_quality_filter", "fastq_quality_trimmer",
                  "fastq_masker", "fastx_trimmer", "fastx_artifacts_filter",
                  "fastx_quality_stats"):
            subprocess.run(["gcc", "-O3", "-I", bindir, "-I", f"{R}/libfastx",
                            f"{R}/{t}/{t}.c", *objs, "-o", os.path.join(bindir, t)],
                           check=True, capture_output=True)
        subprocess.run(["g++", "-O3", "-I", bindir, "-I", f"{R}/libfastx",
                        f"{R}/fastx_clipper/fastx_clipper.cpp",
                        f"{R}/libfastx/sequence_alignment.cpp", *objs,
                        "-o", os.path.join(bindir, "fastx_clipper")],
                       check=True, capture_output=True)
        subprocess.run(["g++", "-O3", "-std=c++11", "-I", bindir, "-I", f"{R}/libfastx",
                        f"{R}/fastx_collapser/fastx_collapser.cpp", *objs,
                        "-o", os.path.join(bindir, "fastx_collapser")],
                       check=True, capture_output=True)

    lane = "/tmp/fastx_bench_lane.fastq"
    lane100k = "/tmp/fastx_bench_lane100k.fastq"
    if not os.path.exists(lane):
        with open(lane, "wb") as fh:
            fh.write(synth_lane_bytes(N_READS, READ_LEN))
    if not os.path.exists(lane100k):
        with open(lane100k, "wb") as fh:
            fh.write(synth_lane_bytes(100_000, READ_LEN))

    for n in sorted(C_CMDS):
        cmd = C_CMDS[n].format(bin=bindir, lane=lane, lane100k=lane100k)
        n_reads = 100_000 if "{lane100k}" in C_CMDS[n] else N_READS
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            subprocess.run(["bash", "-c", cmd], check=True)
            times.append(time.perf_counter() - t0)
        rps = n_reads / min(times)
        print(json.dumps({
            "metric": "c_baseline_config%d" % n,
            "value": round(rps, 1),
            "unit": "reads/sec",
            "seconds_best_of_3": round(min(times), 3),
            "reads": n_reads,
            "cmd": cmd.replace(bindir + "/", ""),
        }))


def timed_device_chain(fn, xs, sync, *, chain: int | None = None,
                       budget_s: float = 25.0):
    """Per-dispatch seconds for a device-resident step: each timed
    repetition submits `chain` dispatches back-to-back (async — they
    queue on the device) and syncs ONCE at the end, so the per-call
    submit latency overlaps kernel execution instead of being measured
    as kernel time.  Returns best-of-reps mean-of-chain seconds.
    `sync(out)` must force completion (jax.block_until_ready)."""
    chain = chain or int(os.environ.get("FASTX_DEVICE_CHAIN", 16))
    # calibrate: one chained rep tells us how many reps fit the budget
    t0 = time.perf_counter()
    out = None
    for _ in range(chain):
        out = fn(*xs)
    sync(out)
    first = (time.perf_counter() - t0) / chain
    best = first
    reps = max(1, min(10, int(budget_s / max(first * chain, 1e-3))))
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(chain):
            out = fn(*xs)
        sync(out)
        best = min(best, (time.perf_counter() - t0) / chain)
    return best


def device_only(config_n: int = 0):
    """Measure the fused step on device-resident data: the per-card
    compute ceiling with no host leg in the loop.  `python bench.py
    --device [--config N]`."""
    import jax

    from fastx_toolkit_tpu.engine.pipeline import (
        pack_batch2,
        packed_decisions_pipeline,
    )

    if config_n == 3:
        run_config_stats(device_resident=True)
        return
    if config_n == 5:
        run_config_collapse(device_resident=True)
        return
    cfg, _ = config_cfg(config_n)
    fn = packed_decisions_pipeline(cfg, two_bit=True, has_n_plane=False)
    fn_tie = (packed_decisions_pipeline(cfg, two_bit=True,
                                        has_n_plane=False, tie_flag=True)
              if cfg.with_clip else None)
    rng = np.random.default_rng(0)
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(CHUNK, READ_LEN))
    quals = rng.integers(2, 41, size=(CHUNK, READ_LEN)).astype(np.int8)
    lengths = np.full(CHUNK, READ_LEN, np.int16)
    b2, planes = pack_batch2(bases, quals, cfg, n_plane=False)
    xs = [jax.device_put(a) for a in (b2, planes, lengths)]
    jax.block_until_ready(fn(*xs))  # compile
    dt = timed_device_chain(fn, xs, jax.block_until_ready)
    dt_tie = None
    if fn_tie is not None:
        jax.block_until_ready(fn_tie(*xs))  # compile
        dt_tie = timed_device_chain(fn_tie, xs, jax.block_until_ready,
                                    budget_s=12.0)
    rps = CHUNK / dt
    if config_n == 0:
        print(
            json.dumps(
                {
                    "metric": "reads_per_sec_device_resident_fused_step",
                    "value": round(rps, 1),
                    "unit": "reads/sec",
                    "vs_baseline": round(rps / C_BASELINE_READS_PER_SEC, 3),
                    **(
                        {"with_tie_flag_reads_per_sec":
                         round(CHUNK / dt_tie, 1)}
                        if dt_tie else {}
                    ),
                }
            )
        )
    else:
        emit(config_n, rps, suffix="_device_resident")
    # stage decomposition: the same step with the DP disabled isolates
    # the clipper kernel's share of the device time
    if config_n == 0:
        cfg_noclip = dataclasses.replace(cfg, with_clip=False)
        fn2 = packed_decisions_pipeline(cfg_noclip, two_bit=True,
                                        has_n_plane=False)
        jax.block_until_ready(fn2(*xs))
        b2t = timed_device_chain(fn2, xs, jax.block_until_ready,
                                 budget_s=12.0)
        print(json.dumps({
            "metric": "device_stage_decomposition",
            "fused_step_sec": round(dt, 4),
            "without_clip_sec": round(b2t, 4),
            "dp_share_pct": round(100.0 * max(dt - b2t, 0) / dt, 1),
        }))


def host_only():
    """Host-codec-only throughput: the exact run_once overlapped loop
    (BatchReader parse -> scan_alphabet + pack_batch2 -> fused
    keep/mask native render into the arena) with the device step
    replaced by an identity stub.  This is the host leg of a
    deployment: whichever of --host/--device is smaller bounds
    end-to-end throughput.  Conservative in one
    way: the stub keeps every read, so the render pass writes ~15%
    more bytes than the real pipeline does.

    `python bench.py --host`"""
    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig

    cfg = PipelineConfig(adapter=ADAPTER)

    def stub(b2_or_b4, planes, lengths):
        lens = np.asarray(lengths, np.int32)
        return lens, np.ones(len(lens), bool)

    fns = (stub, stub, stub)
    data = synth_lane_bytes(N_READS, READ_LEN)
    print("host lane: %d reads, %d bytes" % (N_READS, len(data)), file=sys.stderr)
    arena = np.empty(len(data) + (1 << 20), np.uint8)
    arena[::4096] = 0
    for name, runner, dev in (("classic", run_once, fns),
                              ("lines", run_once_auto, StubEngines())):
        runner(synth_lane_bytes(2048, READ_LEN, seed=7), dev, cfg, arena)
        times = []
        for it in range(int(os.environ.get("FASTX_BENCH_ITERS", 5))):
            t0 = time.perf_counter()
            n, nbytes = runner(data, dev, cfg, arena)
            dt = time.perf_counter() - t0
            times.append(dt)
            print("%s iter %d: %.3fs  (%.0f reads/s, %d bytes out)"
                  % (name, it, dt, n / dt, nbytes), file=sys.stderr)
        rps = N_READS / min(times)
        print(json.dumps({
            "metric": "reads_per_sec_host_codec_only"
                      + ("" if name == "classic" else "_lines"),
            "value": round(rps, 1),
            "unit": "reads/sec",
            "vs_baseline": round(rps / C_BASELINE_READS_PER_SEC, 3),
            "note": "parse+pack+render only, device stubbed; production "
                    "end-to-end ~ min(this, --device)",
        }))


def scaling(n_procs: int = 2):
    """Multi-host scaling efficiency on this machine: run a tool over the
    lane as 1 process and as N cooperating processes (fastx_pod, CPU
    backend so both sides use the same compute), byte-verify the merged output, and report
    median T1/(N*TN) over >= 5 repeats.

    FASTX_SCALING_WORKLOAD picks the workload:
      stats (default) — fastx_quality_stats; with the host engine this is
        memory-BANDWIDTH-bound on this VM (a single process already
        saturates the bus), so its efficiency reading bounds the bus
        share, not the front-end overhead.
      pipeline — the fused headline chain (quality filter | clipper |
        artifacts) whose per-read DP makes it compute-bound; this
        isolates the distributed front-end (sharded reads + collective
        merges), which is what the >= 90%% target is about.

    `python bench.py --scaling [--procs N]`"""
    import shutil
    import subprocess

    workload = os.environ.get("FASTX_SCALING_WORKLOAD", "stats")
    lane = "/tmp/fastx_bench_lane_%d.fastq" % N_READS
    if not os.path.exists(lane):
        with open(lane, "wb") as fh:
            fh.write(synth_lane_bytes(N_READS, READ_LEN))

    _CHAIN = ("fastq_quality_filter -q 20 -p 50 | "
              "fastx_clipper -a CTGTAGGCACCATCAAT -n -l 15 | "
              "fastx_artifacts_filter")
    lane_ref = [lane]  # scaling_slope() swaps in the half-size lane

    def tool_argv():
        if workload == "pipeline":
            return ["fastx_pipeline", "-Q", "33", "-i", lane_ref[0], _CHAIN]
        return ["fastx_quality_stats", "-Q", "33", "-i", lane_ref[0]]

    tool_module = ("fastx_toolkit_tpu.cli.tools.fastx_pipeline"
                   if workload == "pipeline"
                   else "fastx_toolkit_tpu.cli.tools.fastx_quality_stats")

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    # level the field on a small host: one native-codec thread and one
    # BLAS/OMP thread per process for BOTH the 1-proc and N-proc runs, so
    # the measurement isolates the front-end overhead (sharded reads +
    # collective merges) instead of comparing different threadings
    env["FASTX_NATIVE_THREADS"] = "1"
    env["OMP_NUM_THREADS"] = "1"
    # dispatch chunk must be far below the lane so compute scales with
    # reads: the engine pads every dispatch to a full chunk, so with the
    # default 262144-row chunk an 80k lane and a 160k lane run the SAME
    # padded device program and the marginal-slope method reads ~0
    env.setdefault("FASTX_TPU_CHUNK", "16384")
    for k in ("FASTX_TPU_NUM_SHARDS", "FASTX_TPU_SHARD_ID",
              "FASTX_TPU_NUM_PROCESSES", "FASTX_TPU_PROCESS_ID", "XLA_FLAGS"):
        env.pop(k, None)

    # pin every worker (and the single-process run) to its own core so
    # the comparison is core-for-core: a real pod gives each process its
    # own host, but on this one box an unpinned single process already
    # spills onto the second core
    pin = shutil.which("taskset") is not None

    def run_single(out):
        ta = tool_argv()
        flags = ta[1:-1] if workload == "pipeline" else ta[1:]
        argv = [sys.executable, "-m", tool_module, *flags, "-o", out]
        if workload == "pipeline":
            argv.append(_CHAIN)
        if pin:
            argv = ["taskset", "-c", "0", *argv]
        t0 = time.perf_counter()
        subprocess.run(argv, check=True, env=env, cwd=REPO)
        return time.perf_counter() - t0

    def run_pod(out):
        import glob as _glob

        # stale shards from older runs (possibly a different -n) must not
        # leak into the byte-verify concat
        for f in _glob.glob(out + ".shard-*"):
            os.remove(f)
        argv = [sys.executable, "-m", "fastx_toolkit_tpu.cli.pod", "-n",
                str(n_procs), "--cpu"]
        if pin:
            argv += ["--pin-cores"]
        ta = tool_argv()
        argv += ["--", *(ta[:-1] if workload == "pipeline" else ta),
                 "-o", out]
        if workload == "pipeline":
            argv.append(_CHAIN)
        t0 = time.perf_counter()
        subprocess.run(argv, check=True, env=env, cwd=REPO)
        return time.perf_counter() - t0

    def measure_startup():
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-c",
             "import jax; jax.config.update('jax_platforms','cpu'); "
             "import fastx_toolkit_tpu.cli.tools.fastx_quality_stats"],
            check=True, env=env, cwd=REPO)
        return time.perf_counter() - t0

    # one warmup run each (jit cache), then >= 5 timed repeats; report
    # the MEDIAN with the spread so single-run variance on this shared
    # 2-core host can't manufacture an efficiency above 1.0 (VERDICT r2
    # item #6: a >1.0 reading is a measurement artifact by construction
    # and must not be published)
    reps = int(os.environ.get("FASTX_BENCH_SCALE_REPS", 7))
    slope_mode = bool(os.environ.get("FASTX_SCALING_SLOPE"))
    if slope_mode:
        scaling_slope(n_procs, workload, reps, lane, lane_ref,
                      run_single, run_pod)
        return
    run_single("/tmp/scale_1.out")
    t1s = sorted(run_single("/tmp/scale_1.out") for _ in range(reps))
    run_pod("/tmp/scale_n.out")
    tns = sorted(run_pod("/tmp/scale_n.out") for _ in range(reps))
    startup = min(measure_startup() for _ in range(3))
    single_bytes = open("/tmp/scale_1.out", "rb").read()
    if workload == "pipeline":
        # per-read tools write FILE.shard-<k>-of-<n>; in-order concat ==
        # the single-process output
        import glob

        shards = sorted(glob.glob(
            "/tmp/scale_n.out.shard-*-of-%05d" % n_procs
        ))
        assert len(shards) == n_procs, shards
        pod_bytes = b"".join(open(p, "rb").read() for p in shards)
    else:
        pod_bytes = open("/tmp/scale_n.out", "rb").read()
    assert single_bytes == pod_bytes, "merged multi-process output differs!"

    def median(xs):
        return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (
            xs[len(xs) // 2 - 1] + xs[len(xs) // 2]
        )

    t1 = median(t1s)
    tn = median(tns)
    eff = t1 / (n_procs * tn)
    # a real pod job runs minutes-to-hours per process; the ~3s python+jax
    # startup each worker pays here is a constant, so report the work-time
    # efficiency alongside the raw wall-clock one
    eff_work = (t1 - startup) / (n_procs * (tn - startup))
    oversub = n_procs > os.cpu_count()
    print(json.dumps({
        "metric": "multihost_scaling_efficiency_%s_%dproc" % (workload, n_procs),
        "value": round(eff_work, 3),
        "unit": "median T1/(N*TN), python+jax startup excluded",
        "raw_wallclock_efficiency": round(eff, 3),
        "t1_sec_median": round(t1, 2),
        "t1_sec_spread": [round(t1s[0], 2), round(t1s[-1], 2)],
        "tn_sec_median": round(tn, 2),
        "tn_sec_spread": [round(tns[0], 2), round(tns[-1], 2)],
        "startup_sec": round(startup, 2),
        "repeats": reps,
        "reads": N_READS,
        "host_cores": os.cpu_count(),
        "note": "CPU backend both sides, 1 core + 1 native thread per process;"
                " merged output byte-identical to single-process"
                + ("; N > cores: processes share cores, efficiency is"
                   " core-bound, not front-end-bound" if oversub else "")
                + ("; WARNING: efficiency > 1.0 is a noise-saturated"
                   " reading on this rig, not evidence"
                   if eff_work > 1.0 else ""),
    }))


def scaling_slope(n_procs, workload, reps, big_lane, lane_ref,
                  run_single, run_pod):
    """Marginal-throughput scaling efficiency (FASTX_SCALING_SLOPE=1).

    Per-process fixed costs — interpreter+jax import, jax.distributed
    init, per-shape jit compiles — are seconds each and do not shrink
    with the lane, so a plain T1/(N*TN) on lanes this host can process in
    under a minute under-reports the front-end's true efficiency (on a
    real pod those costs amortize over hours).  The slope method cancels
    every fixed cost exactly: run each configuration at N_READS and
    N_READS/2 reads and compare MARGINAL times,

        eff = (T1(big) - T1(small)) / (N * (TN(big) - TN(small))).

    Medians over `reps` repeats per point; the small lane is generated
    once next to the big one.
    """
    small_n = N_READS // 2
    small_lane = "/tmp/fastx_bench_lane_%d.fastq" % small_n
    if not os.path.exists(small_lane):
        with open(small_lane, "wb") as fh:
            fh.write(synth_lane_bytes(small_n, READ_LEN))

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (
            xs[len(xs) // 2 - 1] + xs[len(xs) // 2]
        )

    results = {}
    for tag, lane_path in (("big", big_lane), ("small", small_lane)):
        lane_ref[0] = lane_path
        run_single("/tmp/scale_1.out")  # warm
        results["t1_" + tag] = median(
            [run_single("/tmp/scale_1.out") for _ in range(reps)]
        )
        run_pod("/tmp/scale_n.out")
        results["tn_" + tag] = median(
            [run_pod("/tmp/scale_n.out") for _ in range(reps)]
        )
    d1 = results["t1_big"] - results["t1_small"]
    dn = results["tn_big"] - results["tn_small"]
    eff = d1 / (n_procs * dn) if dn > 0 else float("nan")
    print(json.dumps({
        "metric": "multihost_scaling_efficiency_%s_%dproc_marginal" % (
            workload, n_procs),
        "value": round(eff, 3),
        "unit": "marginal T1/(N*TN) between %d and %d reads" % (
            N_READS, N_READS // 2),
        "t1_sec_medians": [round(results["t1_small"], 2),
                           round(results["t1_big"], 2)],
        "tn_sec_medians": [round(results["tn_small"], 2),
                           round(results["tn_big"], 2)],
        "repeats_per_point": reps,
        "host_cores": os.cpu_count(),
        "note": "slope cancels per-process fixed costs (imports, "
                "distributed init, jit compiles) that a real pod job "
                "amortizes; outputs byte-verified by the non-slope mode",
    }))


PER_READ_TOOLS = [
    # (tool, extra argv) — the six raw-line-capable per-read CLIs
    ("fastq_quality_filter", ["-q", "20", "-p", "80"]),
    ("fastq_quality_trimmer", ["-t", "20", "-l", "16"]),
    ("fastq_masker", ["-q", "20"]),
    ("fastx_trimmer", ["-f", "5", "-l", "80"]),
    ("fastq_to_fasta", []),
    ("fastx_artifacts_filter", []),
]


def pertool(n_reads: int | None = None):
    """Per-tool engine table backing engine/policy.py's per-read
    host-wins default (VERDICT r4 item #7): for each of the six raw-line
    tools, measure (a) the host raw-line path (FASTX_LINEPATH=on),
    (b) the classic parse->device path (FASTX_LINEPATH=off), and (c) the classic path's host-side floor —
    the padded-matrix parse + pack + render legs with the device stubbed
    (JAX irrelevant) — which lower-bounds the classic path on any
    device.  If host(a) beats floor(c) for a tool, the
    host default is right even with a free chip.

    `python bench.py --pertool`; outputs byte-compared between modes.
    """
    import subprocess
    import tempfile

    n = n_reads or int(os.environ.get("FASTX_PERTOOL_READS", 200_000))
    data = synth_lane_bytes(n, READ_LEN)
    lane = tempfile.NamedTemporaryFile(suffix=".fastq", delete=False)
    lane.write(data)
    lane.close()
    reps = int(os.environ.get("FASTX_PERTOOL_REPS", 3))
    bindir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bin")

    # per-process python+jax import startup (a constant a long-running
    # job amortizes): measured once and subtracted so the per-tool rates
    # reflect processing, not interpreter boot
    startup_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c",
                        "import jax; import fastx_toolkit_tpu.cli.common"],
                       check=True,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
        startup_times.append(time.perf_counter() - t0)
    startup = min(startup_times)
    # per-(tool, mode) fixed overhead: the SAME tool on a 256-read lane
    # pays the same import + trace + compile the timed reps pay, so
    # (t_full - t_tiny) isolates steady-state processing — the
    # import-only probe above under-subtracts for the classic mode,
    # whose per-process jit compile would otherwise be billed as
    # processing time (review finding, round 5)
    tiny = tempfile.NamedTemporaryFile(suffix=".fastq", delete=False)
    tiny.write(synth_lane_bytes(256, READ_LEN, seed=5))
    tiny.close()
    rows = []
    for tool, extra in PER_READ_TOOLS:
        row = {"tool": tool}
        outs = {}
        for mode, env_val in (("host", "on"), ("classic", "off")):
            env = dict(os.environ)
            env["FASTX_LINEPATH"] = env_val
            env["PATH"] = bindir + os.pathsep + env.get("PATH", "")
            out_path = lane.name + ".%s.%s.out" % (tool, mode)
            argv = [os.path.join(bindir, tool), "-Q", "33",
                    *extra, "-i", lane.name, "-o", out_path]
            tiny_out = tiny.name + ".%s.%s.out" % (tool, mode)
            tiny_times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                subprocess.run([os.path.join(bindir, tool), "-Q", "33",
                                *extra, "-i", tiny.name, "-o", tiny_out],
                               env=env, check=True,
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL)
                tiny_times.append(time.perf_counter() - t0)
            fixed = min(tiny_times)
            os.unlink(tiny_out)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                subprocess.run(argv, env=env, check=True,
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL)
                times.append(time.perf_counter() - t0)
            row[mode + "_rps"] = round(n / _median(times), 1)
            row[mode + "_rps_startup_adjusted"] = round(
                n / max(_median(times) - startup, 1e-3), 1)
            row[mode + "_fixed_sec"] = round(fixed, 2)
            # steady-state = processing time with the per-process fixed
            # cost (import + trace + compile, = the tiny run) removed;
            # when the lane is too small to resolve the difference
            # against run-to-run noise, say so instead of emitting a
            # clamped nonsense rate
            steady_denom = _median(times) - fixed
            row[mode + "_rps_steady"] = (
                round(n / steady_denom, 1) if steady_denom > 0.1 else None)
            row[mode + "_secs"] = [round(t, 2) for t in sorted(times)]
            with open(out_path, "rb") as f:
                outs[mode] = f.read()
            os.unlink(out_path)
        row["outputs_identical"] = outs["host"] == outs["classic"]
        rows.append(row)
        print(json.dumps(row), file=sys.stderr)

    # (c) the classic path's host-side floor, shared by every tool: the
    # padded-matrix parse + 2-bit pack the device path cannot avoid
    # (render differs per tool but adds further host work on top)
    import io
    from types import SimpleNamespace

    from fastx_toolkit_tpu.cli.tools._shared import BatchReader
    from fastx_toolkit_tpu.core import codec
    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig, pack_batch2

    cfg0 = PipelineConfig()
    floor_times = []
    for _ in range(reps):
        args = SimpleNamespace(input_filename="<bench>", q_offset=33)
        t0 = time.perf_counter()
        reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                             stream=io.BytesIO(data))
        for batch in reader:
            pack_batch2(np.asarray(batch.bases),
                        np.ascontiguousarray(batch.quals, np.int8), cfg0,
                        n_plane=False)
        floor_times.append(time.perf_counter() - t0)
    floor_rps = n / _median(floor_times)
    os.unlink(lane.name)
    os.unlink(tiny.name)
    print(json.dumps({
        "metric": "per_tool_engine_table",
        "n_reads": n,
        "startup_sec": round(startup, 2),
        "classic_parse_pack_floor_rps": round(floor_rps, 1),
        "note": "floor = classic path's mandatory host parse+pack with "
                "the device free; host_rps > floor means host wins on "
                "any link (engine/policy.py per-read default); *_steady "
                "subtracts each mode's own tiny-lane run (import + "
                "trace + compile), the fair steady-state comparison",
        "tools": rows,
    }))


def meshsweep():
    """Collective/sharding overhead vs device count on the virtual CPU
    mesh (VERDICT r4 item #6): the sharded flagship pipeline and the
    sharded stats reduction at 1/2/4/8 devices with FIXED PER-DEVICE
    work.  On this 2-core host the virtual devices share cores, so
    absolute times grow with n — the meaningful reading is the jitted
    program's sharding/collective structure compiling and the per-device
    work scaling, which this rig CAN resolve (unlike 2-process wall-time
    efficiency, which its core count saturates).  We therefore report
    per-device-work time normalized by the n=1 point alongside the raw
    times, and flag that n>2 points include core oversubscription.

    `python bench.py --meshsweep` (re-execs itself onto the CPU backend
    with 8 virtual devices)."""
    import subprocess

    if not os.environ.get("FASTX_MESHSWEEP_CHILD"):
        env = dict(os.environ)
        env["FASTX_MESHSWEEP_CHILD"] = "1"
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=8")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--meshsweep"], env=env, check=True)
        return

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from fastx_toolkit_tpu.parallel import mesh as pmesh

    per_dev = int(os.environ.get("FASTX_MESHSWEEP_PERDEV", 8192))
    reps = int(os.environ.get("FASTX_MESHSWEEP_REPS", 5))
    devs = jax.devices()
    rng = np.random.default_rng(0)
    rows = []
    for n in (1, 2, 4, 8):
        if n > len(devs):
            break
        B = per_dev * n
        m = Mesh(np.array(devs[:n]), ("data",))
        bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                           size=(B, READ_LEN))
        quals = rng.integers(2, 41, size=(B, READ_LEN)).astype(np.int8)
        lengths = np.full(B, READ_LEN, np.int32)
        counts = np.ones(B, np.int32)
        fn = pmesh.sharded_pipeline(m, adapter=ADAPTER)
        out = fn(bases, quals, lengths, counts)
        jax.block_until_ready(out)
        t_pipe = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(bases, quals, lengths, counts))
            t_pipe.append(time.perf_counter() - t0)
        t_st = []
        out = pmesh.sharded_stats(m, bases, quals, lengths, counts,
                                  is_fastq=True)
        jax.block_until_ready(out)
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(
                pmesh.sharded_stats(m, bases, quals, lengths, counts,
                                    is_fastq=True)
            )
            t_st.append(time.perf_counter() - t0)
        rows.append({
            "devices": n, "rows_total": B, "rows_per_device": per_dev,
            "pipeline_sec_median": round(_median(t_pipe), 4),
            "stats_sec_median": round(_median(t_st), 4),
        })
        print(json.dumps(rows[-1]), file=sys.stderr)
    base_p = rows[0]["pipeline_sec_median"]
    base_s = rows[0]["stats_sec_median"]
    for r in rows:
        r["pipeline_overhead_vs_1dev"] = round(
            r["pipeline_sec_median"] / base_p, 3)
        r["stats_overhead_vs_1dev"] = round(r["stats_sec_median"] / base_s, 3)
    print(json.dumps({
        "metric": "virtual_mesh_devicecount_sweep",
        "read_len": READ_LEN,
        "repeats": reps,
        "host_cores": os.cpu_count(),
        "note": "fixed per-device work; overhead_vs_1dev ~ 1.0 means the "
                "sharding/collective structure adds no per-device cost; "
                "n > cores points include core oversubscription on this "
                "2-core host",
        "points": rows,
    }))


def require_gpu():
    """Exit with an error unless JAX's default device is a GPU: a device
    figure from another backend is not a figure of this system."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("bench.py: this mode measures the GPU, but JAX's default "
                 "device is %r (platform %s)" % (dev, dev.platform))
    print("bench device: %s (%s, %d visible)"
          % (dev, dev.device_kind, len(jax.devices())), file=sys.stderr)


def main():
    from fastx_toolkit_tpu.cli.common import configure_compile_cache

    configure_compile_cache()
    config_n = 0
    if "--config" in sys.argv:
        config_n = int(sys.argv[sys.argv.index("--config") + 1])
    if "--cbaseline" in sys.argv:
        cbaseline()
        return
    if "--scaling" in sys.argv:
        n_procs = 2
        if "--procs" in sys.argv:
            n_procs = int(sys.argv[sys.argv.index("--procs") + 1])
        scaling(n_procs)
        return
    if "--host" in sys.argv:
        host_only()
        return
    if "--pertool" in sys.argv:
        pertool()
        return
    if "--meshsweep" in sys.argv:
        meshsweep()
        return
    require_gpu()
    if "--device" in sys.argv:
        device_only(config_n)
        return
    if config_n == 3:
        run_config_stats()
        return
    if config_n == 5:
        run_config_collapse()
        return
    if config_n != 0:
        run_config_pipeline(config_n)
        return
    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig

    data = synth_lane_bytes(N_READS, READ_LEN)
    print("lane: %d reads, %d bytes" % (N_READS, len(data)), file=sys.stderr)

    cfg = PipelineConfig(adapter=ADAPTER)
    from fastx_toolkit_tpu.engine.lines import LineEngines

    eng = LineEngines(cfg)

    # output arena: the whole lane renders into one preallocated buffer
    # (pages touched once here, reused every iteration — the C baseline's
    # pipe writes likewise recycle a warm kernel buffer)
    arena = np.empty(len(data) + (1 << 20), np.uint8)
    arena[::4096] = 0  # fault every page in now, outside the timed runs

    # warmup (compile) on a small lane; padding makes the device shape
    # identical to the timed runs so the executable is reused
    t0 = time.perf_counter()
    run_once_auto(synth_lane_bytes(2048, READ_LEN, seed=7), eng, cfg, arena)
    print("warmup %.1fs" % (time.perf_counter() - t0), file=sys.stderr)
    times = []
    for it in range(int(os.environ.get("FASTX_BENCH_ITERS", 11))):
        t0 = time.perf_counter()
        n, nbytes = run_once_auto(data, eng, cfg, arena)
        dt = time.perf_counter() - t0
        times.append(dt)
        print(
            "iter %d: %.3fs  (%.0f reads/s, %d bytes out)"
            % (it, dt, n / dt, nbytes),
            file=sys.stderr,
        )
    _maybe_dump(bytes(arena[:nbytes]))
    rps = N_READS / _median(times)

    print(
        json.dumps(
            {
                "metric": "reads_per_sec_trim_filter_clip_pipeline",
                "value": round(rps, 1),
                "unit": "reads/sec",
                "vs_baseline": round(rps / C_BASELINE_READS_PER_SEC, 3),
                "stat": "median_of_%d" % len(times),
                "best_reads_per_sec": round(N_READS / min(times), 1),
                "iter_secs": [round(t, 3) for t in sorted(times)],
                "iter_reads_per_sec": [round(N_READS / t, 1) for t in times],
            }
        )
    )


if __name__ == "__main__":
    main()
