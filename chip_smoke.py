#!/usr/bin/env python3
"""Bring-up check of the fused read-preprocessing path on NVIDIA GPUs.

    python chip_smoke.py            # one card: phases 1-6 below
    python chip_smoke.py --four     # four cards: the multi-card paths only

One process owns the card(s); every phase that fails raises, and the
script then exits non-zero without printing a result.  Phases:

1. card     nvidia-smi's name and power limit, read by a child process
            that stays off JAX; then exit unless JAX's default device is
            a GPU.
2. dp       kernels/align.py::align_batch at 262,144 reads x 100 bp with
            the headline adapter, tie flag off and on, ~2% of reads
            carrying Ns: int32 results exactly equal to the same call on
            the CPU backend and, on sampled reads, to align_oracle.
            Prints the device time of one call.
3. pipeline a 2,097,152-read lane (bench.synth_lane_bytes plus an
            N-bearing share) through the fastx_pipeline CLI entry point in
            this process, byte-compared with the six tools of the chain run
            one after another as CLI processes under JAX_PLATFORMS=cpu.
            Prints wall time and reads/s.
4. engines  fastx_quality_stats and fastx_collapser on the lane with the
            device and the host engine: byte-identical outputs, both times.
5. stats    exact per-cycle counts above 2**11 through the with_stats
            pipeline and sharded_pipeline on a one-card mesh.
6. memory   compiled.memory_analysis() of the decisions step and the
            card's peak_bytes_in_use.

--four runs only: fastx_pod -n 4 (one card per worker) for
fastx_quality_stats and fastx_pipeline against single-process runs, then
sharded_pipeline, its packed variant and sharded_stats over data_mesh(4)
at 4 x 262,144 reads against single-card runs.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".smoke_work")

ADAPTER = b"CTGTAGGCACCATCAAT"
READ_LEN = 100
DP_READS = 262_144
LANE_READS = 2_097_152
FOUR_POD_READS = 262_144
N_READ_FRAC = 0.02
SEED = 42
ORACLE_SAMPLE = 2000
STATS_READS = 65_536

# the headline chain (README): the fused CLI takes it as one argument, the
# CPU reference runs each stage as its own tool
CHAIN = (
    ("fastx_trimmer", ["-l", "70"]),
    ("fastq_quality_filter", ["-q", "20", "-p", "50"]),
    ("fastq_quality_trimmer", ["-t", "20"]),
    ("fastq_masker", ["-q", "20"]),
    ("fastx_clipper", ["-a", ADAPTER.decode(), "-l", "15"]),
    ("fastx_artifacts_filter", []),
)
CHAIN_SPEC = " | ".join(" ".join([t, *a]) for t, a in CHAIN)

DP_FIELDS = ("matches", "mismatches", "gaps", "neutral",
             "query_start", "query_end", "target_start", "target_end")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: the card


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` from a child process;
    raises when nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    return out


def require_gpu(min_count: int = 1):
    """Exit non-zero unless JAX's default device is a GPU and at least
    ``min_count`` are visible; returns jax.devices()."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit("chip_smoke: JAX's default device is %r (platform %s), "
                 "not a GPU" % (devs[0], devs[0].platform))
    if len(devs) < min_count:
        sys.exit("chip_smoke: needs %d GPUs, JAX sees %d"
                 % (min_count, len(devs)))
    return devs


def result_line(devs) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


# ---------------------------------------------------------------------------
# inputs, made from a seed


def dp_inputs(n: int, read_len: int = READ_LEN, seed: int = SEED,
              n_read_frac: float = N_READ_FRAC):
    """[n, read_len] ASCII reads for the DP: noisy adapters spiked into
    30% of reads, 1-4 Ns in ``n_read_frac`` of them, a quarter of the
    reads shorter than read_len (zero-padded)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    bases = rng.choice(acgt, size=(n, read_len))
    has_ad = rng.random(n) < 0.3
    pos = rng.integers(0, read_len - 5, n)
    for j, ch in enumerate(ADAPTER):
        m = has_ad & (pos + j < read_len) & (rng.random(n) > 0.05)
        bases[m, (pos + j)[m]] = ch
    idx = np.flatnonzero(rng.random(n) < n_read_frac)
    for k in range(4):
        col = rng.integers(0, read_len, len(idx))
        sel = idx[rng.random(len(idx)) < (1.0 if k == 0 else 0.5)]
        bases[sel, col[: len(sel)]] = ord("N")
    lengths = np.where(rng.random(n) < 0.25,
                       rng.integers(1, read_len + 1, n),
                       read_len).astype(np.int32)
    bases[np.arange(read_len)[None, :] >= lengths[:, None]] = 0
    return bases, lengths


def inject_ns(lane: bytes, frac: float = N_READ_FRAC, seed: int = SEED) -> bytes:
    """Put 1-3 Ns into the sequence lines of ``frac`` of a FASTQ lane's
    records (qualities untouched)."""
    from fastx_toolkit_tpu.core import codec

    fr = codec.frame_fastq_fast(lane)
    if fr is None:
        raise ValueError("lane does not frame as clean FASTQ")
    rng = np.random.default_rng(seed)
    buf = np.frombuffer(lane, np.uint8).copy()
    idx = np.flatnonzero(rng.random(len(fr)) < frac)
    starts = np.asarray(fr.seq_starts, np.int64)[idx]
    lens = np.asarray(fr.seq_lens, np.int64)[idx]
    for k in range(3):
        off = (rng.random(len(idx)) * lens).astype(np.int64)
        keep = rng.random(len(idx)) < (1.0 if k == 0 else 0.5)
        buf[(starts + off)[keep]] = ord("N")
    return buf.tobytes()


def make_lane(n: int, read_len: int = READ_LEN, seed: int = SEED,
              n_frac: float = N_READ_FRAC) -> bytes:
    """The bench lane generator plus an N-bearing share."""
    from bench import synth_lane_bytes

    return inject_ns(synth_lane_bytes(n, read_len, seed=seed), n_frac, seed)


# ---------------------------------------------------------------------------
# comparison helpers


def first_diff(a: bytes, b: bytes):
    """None when equal, else the first differing byte offset."""
    if a == b:
        return None
    n = min(len(a), len(b))
    x = np.frombuffer(a[:n], np.uint8)
    y = np.frombuffer(b[:n], np.uint8)
    d = np.flatnonzero(x != y)
    return int(d[0]) if len(d) else n


def check_same_bytes(what: str, got: bytes, want: bytes) -> None:
    off = first_diff(got, want)
    if off is not None:
        raise AssertionError(
            "%s: outputs differ at byte %d (%d vs %d bytes): %r vs %r"
            % (what, off, len(got), len(want), got[off:off + 60],
               want[off:off + 60]))


def dp_mismatches(got: dict, want: dict) -> list:
    """Names of the DP result fields that are not exactly equal."""
    return [k for k in want
            if not np.array_equal(np.asarray(got[k]), np.asarray(want[k]))]


def oracle_mismatches(bases, lengths, res: dict, rows) -> list:
    """Rows whose DP fields differ from align_oracle(exact=True)."""
    from fastx_toolkit_tpu.kernels.align import align_oracle

    names = dict(neutral="neutral_matches")
    bad = []
    for i in rows:
        r = align_oracle(bases[i, : lengths[i]].tobytes(), ADAPTER, exact=True)
        if any(int(np.asarray(res[k])[i]) != getattr(r, names.get(k, k))
               for k in DP_FIELDS):
            bad.append(int(i))
    return bad


def run_tool(module, argv, stdin: bytes = b"", env: dict | None = None):
    """Run a CLI tool's entry point in this process; returns
    (status, stdout bytes, stderr text)."""
    from fastx_toolkit_tpu.cli.common import CliContext, ExitWithStatus

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    out, err, rep = io.BytesIO(), io.StringIO(), io.StringIO()
    ctx = CliContext(prog=module.__name__.rsplit(".", 1)[-1],
                     stdin=io.BytesIO(stdin), stdout=out, stderr=err,
                     stdout_text=rep)
    try:
        status = module.tool_main(ctx, list(argv))
    except ExitWithStatus as e:
        status = e.status
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return status, out.getvalue(), err.getvalue() + rep.getvalue()


def cpu_env(**extra) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=HERE, **extra)
    env.pop("XLA_FLAGS", None)
    return env


def cpu_chain(lane_path: str, workdir: str) -> bytes:
    """The headline chain as six CLI processes on the CPU backend, one
    after another.  The standalone clipper runs with independent-read
    semantics (FASTX_TPU_CLIPPER_CLEAN), as the fused chain does."""
    env = cpu_env(FASTX_TPU_CLIPPER_CLEAN="1")
    src = lane_path
    for k, (tool, argv) in enumerate(CHAIN):
        dst = os.path.join(workdir, "chain_%d.out" % k)
        subprocess.run(
            [sys.executable, "-m", "fastx_toolkit_tpu.cli.tools." + tool,
             "-Q", "33", *argv, "-i", src, "-o", dst],
            env=env, check=True, timeout=900,
        )
        if src != lane_path:
            os.remove(src)
        src = dst
    with open(src, "rb") as f:
        out = f.read()
    os.remove(src)
    return out


@contextlib.contextmanager
def work_dir():
    """A fresh scratch directory inside the checkout, removed afterwards."""
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        yield WORK
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


def timed(fn, *a, **k):
    t0 = time.perf_counter()
    r = fn(*a, **k)
    return time.perf_counter() - t0, r


# ---------------------------------------------------------------------------
# phases


def phase_dp(card: str, n: int = DP_READS) -> None:
    import jax

    from fastx_toolkit_tpu.kernels.align import align_batch_jit

    bases, lengths = dp_inputs(n)
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    rng = np.random.default_rng(SEED + 1)
    n_rows = np.flatnonzero((bases == ord("N")).any(axis=1))
    rows = np.concatenate([
        rng.choice(n, ORACLE_SAMPLE // 2, replace=False),
        rng.choice(n_rows, min(len(n_rows), ORACLE_SAMPLE // 2), replace=False),
    ])
    xg = jax.device_put((bases, lengths), gpu)
    xc = jax.device_put((bases, lengths), cpu)
    for tie in (False, True):
        def call(x):
            return jax.block_until_ready(
                align_batch_jit(*x, adapter=ADAPTER, tie_flag=tie))

        t_compile, _ = timed(call, xg)
        times = [timed(call, xg)[0] for _ in range(5)]
        got = {k: np.asarray(v) for k, v in call(xg).items()}
        want = {k: np.asarray(v) for k, v in call(xc).items()}
        bad = dp_mismatches(got, want)
        if bad:
            raise AssertionError("dp tie_flag=%s: GPU != CPU in %s" % (tie, bad))
        bad_rows = oracle_mismatches(bases, lengths, got, rows)
        if bad_rows:
            raise AssertionError("dp tie_flag=%s: %d of %d sampled reads "
                                 "differ from align_oracle, e.g. %s"
                                 % (tie, len(bad_rows), len(rows), bad_rows[:5]))
        log("dp: align_batch %d x %d, adapter %d, tie_flag=%d: device "
            "%.3f ms median of 5 (min %.3f, first call with compile %.1f s) "
            "on %s; equal to CPU backend (%d reads, %d tie-fragile); "
            "%d sampled reads equal to align_oracle"
            % (n, READ_LEN, len(ADAPTER), tie,
               1e3 * float(np.median(times)), 1e3 * min(times), t_compile,
               card, n, int(got["tie_fragile"].sum()) if tie else 0,
               len(rows)))


def phase_pipeline(card: str, lane: bytes, workdir: str) -> None:
    from fastx_toolkit_tpu.cli.tools import fastx_pipeline

    n = lane.count(b"\n") // 4
    argv = ["-Q", "33", CHAIN_SPEC]
    t_cold, (st, out_cold, err) = timed(run_tool, fastx_pipeline, argv, lane)
    if st != 0:
        raise RuntimeError("fastx_pipeline exited %d: %s" % (st, err[-2000:]))
    t_warm, (st, out, err) = timed(run_tool, fastx_pipeline, argv, lane)
    if st != 0:
        raise RuntimeError("fastx_pipeline exited %d: %s" % (st, err[-2000:]))
    check_same_bytes("fastx_pipeline cold vs warm run", out, out_cold)
    log("pipeline: fastx_pipeline %d reads x %d bp in process: %.3f s warm "
        "= %.0f reads/s (first run with compile %.3f s) on %s; %d bytes out"
        % (n, READ_LEN, t_warm, n / t_warm, t_cold, card, len(out)))
    lane_path = os.path.join(workdir, "lane.fq")
    with open(lane_path, "wb") as f:
        f.write(lane)
    t_cpu, want = timed(cpu_chain, lane_path, workdir)
    check_same_bytes("fastx_pipeline on GPU vs six CPU tools", out, want)
    log("pipeline: byte-identical to the six-tool chain on the CPU backend "
        "(%.1f s, %d records out)" % (t_cpu, out.count(b"\n+\n")))


def phase_engines(card: str, lane: bytes) -> dict:
    """Device and host engine of the stats and collapse tools; returns
    {kind: (device_s, host_s)} of the warm runs."""
    from fastx_toolkit_tpu.cli.tools import fastx_collapser, fastx_quality_stats

    n = lane.count(b"\n") // 4
    times = {}
    for kind, mod, var in (("stats", fastx_quality_stats, "FASTX_STATS_PATH"),
                           ("collapse", fastx_collapser, "FASTX_COLLAPSE_PATH")):
        outs = {}
        for path in ("device", "host"):
            env = {var: path}
            run_tool(mod, ["-Q", "33"], lane, env)  # compile / warm caches
            t, (st, out, err) = timed(run_tool, mod, ["-Q", "33"], lane, env)
            if st != 0:
                raise RuntimeError("%s %s exited %d: %s"
                                   % (mod.__name__, path, st, err[-2000:]))
            outs[path] = (t, out)
        check_same_bytes("%s device vs host" % kind, outs["device"][1],
                         outs["host"][1])
        times[kind] = (outs["device"][0], outs["host"][0])
        log("engines: %s %d reads: device %.3f s (%.0f reads/s), host %.3f s "
            "(%.0f reads/s) on %s; outputs byte-identical (%d bytes)"
            % (kind, n, outs["device"][0], n / outs["device"][0],
               outs["host"][0], n / outs["host"][0], card,
               len(outs["host"][1])))
    return times


def stats_counts_reference(bases, lengths, counts):
    """numpy per-cycle nucleotide counts [L, 6] (ALL, A, C, G, T, N)."""
    from fastx_toolkit_tpu.ops import stats as stats_ops

    lut = np.asarray(stats_ops._STATS_LUT)
    B, L = bases.shape
    valid = np.arange(L)[None, :] < lengths[:, None]
    w = np.where(valid, counts[:, None].astype(np.int64), 0)
    nuc = lut[bases]
    out = np.zeros((L, stats_ops.NSLOTS), np.int64)
    for s in range(stats_ops.NSLOTS):
        out[:, s] = np.where(nuc == s, w, 0).sum(axis=0)
    out[:, 0] += w.sum(axis=0)
    return out


def phase_stats_exact(card: str, n: int = STATS_READS) -> None:
    import jax

    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig, fused_pipeline
    from fastx_toolkit_tpu.parallel import data_mesh, shard_batch, sharded_pipeline

    bases, lengths = dp_inputs(n, seed=SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    quals = rng.integers(2, 41, size=bases.shape).astype(np.int8)
    # collapsed-read multiplicities above 2**11 (where TF32 would round);
    # the column totals stay below 2**31
    counts = rng.integers(2049, 30000, n).astype(np.int32)
    fused = fused_pipeline(PipelineConfig(with_stats=True))
    b, _q, l, _k, count = (np.asarray(x) for x in fused(bases, quals, lengths, counts))
    want = stats_counts_reference(b, l, counts)
    if not np.array_equal(count.astype(np.int64), want):
        raise AssertionError("with_stats counts differ from numpy")
    mesh = data_mesh(1)
    out = sharded_pipeline(mesh)(*shard_batch(mesh, bases, quals, lengths, counts))
    jax.block_until_ready(out)
    if not np.array_equal(np.asarray(out[4]).astype(np.int64), want):
        raise AssertionError("sharded_pipeline counts differ from numpy")
    log("stats: per-cycle counts of %d reads with multiplicities 2049-29999 "
        "(column max %d) exact through the with_stats pipeline and "
        "sharded_pipeline on %s" % (n, int(want.max()), card))


def phase_memory(card: str) -> None:
    import jax

    from fastx_toolkit_tpu.engine.lines import CHUNK, LineEngines
    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig, _thresholds

    cfg = PipelineConfig(adapter=ADAPTER, trim_last=70, clip_minlen=15,
                         clip_keep_n=False)
    fn = LineEngines(cfg).fn2(True)
    W = -(-READ_LEN // 8) * 8
    args = (jax.ShapeDtypeStruct((CHUNK, (W + 3) // 4), np.uint8),
            jax.ShapeDtypeStruct((CHUNK, len(_thresholds(cfg)) + 1,
                                  (W + 7) // 8), np.uint8),
            jax.ShapeDtypeStruct((CHUNK,), np.int16))
    ma = fn.lower(*args).compile().memory_analysis()
    log("memory: decisions step %d x %d (N plane, tie flag): %s" % (CHUNK, W, ma))
    stats = jax.devices()[0].memory_stats() or {}
    log("memory: peak_bytes_in_use %s of bytes_limit %s on %s"
        % (stats.get("peak_bytes_in_use"), stats.get("bytes_limit"), card))


def phase_pod(card: str, workdir: str, n: int = FOUR_POD_READS) -> None:
    """fastx_pod -n 4, one card per worker, against one process that
    owns the cards alone (the parent stays off JAX meanwhile)."""
    lane_path = os.path.join(workdir, "lane.fq")
    with open(lane_path, "wb") as f:
        f.write(make_lane(n))
    env = dict(os.environ, PYTHONPATH=HERE, FASTX_STATS_PATH="device")
    for tool, args in (("fastx_quality_stats", []),
                       ("fastx_pipeline", [CHAIN_SPEC])):
        single = os.path.join(workdir, tool + ".single")
        pod = os.path.join(workdir, tool + ".pod")
        t1, _ = timed(subprocess.run,
                      [sys.executable, "-m", "fastx_toolkit_tpu.cli.tools." + tool,
                       "-Q", "33", "-i", lane_path, "-o", single, *args],
                      env=env, check=True, timeout=600)
        tn, _ = timed(subprocess.run,
                      [sys.executable, "-m", "fastx_toolkit_tpu.cli.pod", "-n", "4",
                       "--", tool, "-Q", "33", "-i", lane_path, "-o", pod, *args],
                      env=env, check=True, timeout=600)
        with open(single, "rb") as f:
            want = f.read()
        if tool == "fastx_pipeline":
            parts = [pod + ".shard-%05d-of-00004" % k for k in range(4)]
        else:
            parts = [pod]
        got = b""
        for p in parts:
            with open(p, "rb") as f:
                got += f.read()
        check_same_bytes("fastx_pod -n 4 %s" % tool, got, want)
        log("pod: fastx_pod -n 4 %s over %d reads byte-identical to one "
            "process (%.1f s vs %.1f s wall, process start and compile "
            "included) on 4 x %s" % (tool, n, tn, t1, card))


def phase_mesh(card: str, n_per_card: int = DP_READS) -> None:
    import jax

    from fastx_toolkit_tpu.engine.pipeline import (
        PipelineConfig,
        fused_pipeline,
        pack_batch2,
        packed_decisions_pipeline,
    )
    from fastx_toolkit_tpu.ops import stats as stats_ops
    from fastx_toolkit_tpu.parallel import (
        data_mesh,
        shard_batch,
        sharded_packed_pipeline,
        sharded_pipeline,
        sharded_stats,
    )

    n = 4 * n_per_card
    bases, lengths = dp_inputs(n, seed=SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    quals = rng.integers(2, 41, size=bases.shape).astype(np.int8)
    counts = np.ones(n, np.int32)
    mesh = data_mesh(4)
    cfg = PipelineConfig(with_stats=True)

    sb = shard_batch(mesh, bases, quals, lengths, counts)
    t4, got = timed(lambda: jax.block_until_ready(sharded_pipeline(mesh)(*sb)))
    t1, want = timed(lambda: jax.block_until_ready(
        fused_pipeline(cfg)(bases, quals, lengths, counts)))
    for name, a, b in zip(("bases", "quals", "lengths", "keep", "stats"), got, want):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError("sharded_pipeline %s != one card" % name)
    log("mesh: sharded_pipeline over data_mesh(4), %d reads, equal to one "
        "card (first calls with compile: %.1f s vs %.1f s)" % (n, t4, t1))

    b2, planes = pack_batch2(bases, quals, cfg)
    sp = shard_batch(mesh, b2, planes, lengths.astype(np.int16), counts)
    got = jax.block_until_ready(
        sharded_packed_pipeline(mesh, cfg, seq_len=READ_LEN)(*sp))
    want = jax.block_until_ready(packed_decisions_pipeline(
        cfg, seq_len=READ_LEN, two_bit=True)(b2, planes, lengths, counts))
    for name, a, b in zip(("lengths", "keep", "stats"), got, want):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError("sharded_packed_pipeline %s != one card" % name)
    log("mesh: sharded_packed_pipeline over data_mesh(4) equal to one card")

    got = sharded_stats(mesh, *sb, is_fastq=True)
    want = stats_ops.accumulate_jit(bases, quals, lengths, counts, is_fastq=True)
    for name, a, b in zip(("count", "hist", "qsum", "qmin", "qmax"), got, want):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError("sharded_stats %s != one card" % name)
    log("mesh: sharded_stats over data_mesh(4) equal to one card on 4 x %s"
        % card)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (fastx_pod, data_mesh(4))")
    args = ap.parse_args(argv)

    card = card_line()
    log(card)
    card = card.splitlines()[0]
    if args.four:
        # the workers of fastx_pod each take one card: the parent opens
        # none until they are done
        probe = subprocess.run(
            [sys.executable, "-c", "import jax; d = jax.devices(); "
             "print(d[0].platform, len(d))"],
            capture_output=True, text=True, timeout=300, check=True,
        ).stdout.split()
        if probe != ["gpu", "4"]:
            sys.exit("chip_smoke --four: needs 4 GPUs, JAX sees %s" % probe)
        with work_dir() as work:
            phase_pod(card, work)
        devs = require_gpu(4)
        phase_mesh(card)
    else:
        devs = require_gpu(1)
        from fastx_toolkit_tpu.cli.common import configure_compile_cache

        configure_compile_cache()
        log("jax: %s, %d device(s), %s" % (devs[0].device_kind, len(devs), devs[0]))
        phase_dp(card)
        t, lane = timed(make_lane, LANE_READS)
        log("lane: %d reads x %d bp, %d bytes, made in %.1f s"
            % (LANE_READS, READ_LEN, len(lane), t))
        with work_dir() as work:
            phase_pipeline(card, lane, work)
        phase_engines(card, lane)
        phase_stats_exact(card)
        phase_memory(card)
    log(result_line(devs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
