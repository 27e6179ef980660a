"""Multi-host execution tests.

* record-boundary resync unit tests (exhaustive over byte offsets)
* shard-only mode: in-process byte-range sharding, shard outputs
  concatenate to the single-process output
* true multi-process jax.distributed tests: two OS processes, each
  streaming its own byte-range shard of one input file through real
  tool front-ends, with collective merges — byte-identical to a
  single-process run (the actual multi-host pod execution model,
  simulated with CPU devices).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from fastx_toolkit_tpu.parallel import multihost

import util
from fastx_toolkit_tpu.cli.tools import (
    fastq_quality_trimmer,
    fastx_collapser,
    fastx_quality_stats,
    fastx_uncollapser,
)


def _synth_fastq(n, seed=7, tricky=True):
    """FASTQ bytes + list of record byte offsets.  Quality strings are
    crafted to include lines *starting* with '@' and '+' (the resync
    hazard cases) when tricky."""
    rng = np.random.default_rng(seed)
    out = []
    offsets = []
    pos = 0
    for i in range(n):
        L = int(rng.integers(4, 30))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), L))
        q = rng.integers(2, 41, L) + 33
        if tricky and i % 3 == 0:
            q[0] = ord("@")  # quality line starts like a header
        if tricky and i % 5 == 0:
            q[0] = ord("+")
        qual = bytes(int(x) for x in q)
        plus = b"+HWI-%d" % i if i % 2 else b"+"
        rec = b"@read%d x\n%s\n%s\n%s\n" % (i, seq, plus, qual)
        offsets.append(pos)
        out.append(rec)
        pos += len(rec)
    return b"".join(out), offsets


def _synth_fasta(n, seed=3):
    rng = np.random.default_rng(seed)
    out, offsets, pos = [], [], 0
    for i in range(n):
        L = int(rng.integers(4, 40))
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), L))
        rec = b">seq%d-%d\n%s\n" % (i, int(rng.integers(1, 5)), seq)
        offsets.append(pos)
        out.append(rec)
        pos += len(rec)
    return b"".join(out), offsets


def _check_resync(tmp_path, data, offsets, is_fastq):
    p = tmp_path / "in.dat"
    p.write_bytes(data)
    size = len(data)
    bounds = sorted(offsets)
    with open(p, "rb") as f:
        for off in range(size + 1):
            got = multihost.resync_to_record(f, off, size, is_fastq)
            expect = next((b for b in bounds if b >= off), size)
            assert got == expect, (off, got, expect)


def test_resync_fastq_tricky(tmp_path):
    data, offsets = _synth_fastq(25)
    _check_resync(tmp_path, data, offsets, True)


def test_resync_fastq_numeric_quals(tmp_path):
    # numeric (space-separated) quality lines start with digits/minus
    recs, offsets, pos = [], [], 0
    rng = np.random.default_rng(11)
    for i in range(12):
        L = int(rng.integers(3, 9))
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), L))
        qual = b" ".join(b"%d" % int(x) for x in rng.integers(-10, 40, L))
        rec = b"@r%d\n%s\n+\n%s\n" % (i, seq, qual)
        offsets.append(pos)
        recs.append(rec)
        pos += len(rec)
    _check_resync(tmp_path, b"".join(recs), offsets, True)


def test_resync_fasta(tmp_path):
    data, offsets = _synth_fasta(25)
    _check_resync(tmp_path, data, offsets, False)


def test_shard_ranges_partition(tmp_path):
    """For any N, the resynced shard ranges partition the file into
    record-aligned, in-order, non-overlapping pieces."""
    data, offsets = _synth_fastq(41, seed=19)
    p = tmp_path / "in.fastq"
    p.write_bytes(data)
    size = len(data)
    with open(p, "rb") as f:
        for n in (1, 2, 3, 5, 8, 64):
            cuts = []
            for k in range(n):
                lo, hi = multihost.byte_range(size, k, n)
                lo = multihost.resync_to_record(f, lo, size, True)
                hi = multihost.resync_to_record(f, hi, size, True)
                cuts.append((lo, hi))
            assert cuts[0][0] == 0 and cuts[-1][1] == size
            for (a, b), (c, d) in zip(cuts, cuts[1:]):
                assert b == c  # contiguous
            for lo, hi in cuts:
                assert lo <= hi
                assert lo in offsets or lo == size
                assert hi in offsets or hi == size


def _run_sharded_inprocess(monkeypatch, tool, argv, nshards, stdin=b""):
    """Run a tool once per shard (shard-only mode) and return results."""
    results = []
    for k in range(nshards):
        monkeypatch.setenv("FASTX_TPU_NUM_SHARDS", str(nshards))
        monkeypatch.setenv("FASTX_TPU_SHARD_ID", str(k))
        multihost._reset_for_tests()
        try:
            results.append(util.run_tool(tool, argv, stdin=stdin))
        finally:
            multihost._reset_for_tests()
    monkeypatch.delenv("FASTX_TPU_NUM_SHARDS")
    monkeypatch.delenv("FASTX_TPU_SHARD_ID")
    multihost._reset_for_tests()
    return results


def test_shard_only_concat_equals_single(tmp_path, monkeypatch):
    data, _ = _synth_fastq(57, seed=23, tricky=False)
    p = tmp_path / "in.fastq"
    p.write_bytes(data)
    single = util.run_tool(fastq_quality_trimmer, ["-t", "20", "-l", "5", "-i", str(p)])
    assert single.status == 0
    for n in (2, 3, 4):
        shards = _run_sharded_inprocess(
            monkeypatch, fastq_quality_trimmer,
            ["-t", "20", "-l", "5", "-i", str(p)], n,
        )
        assert all(r.status == 0 for r in shards)
        assert b"".join(r.stdout for r in shards) == single.stdout


def test_shard_only_file_output_suffix(tmp_path, monkeypatch):
    data, _ = _synth_fastq(30, seed=5, tricky=False)
    p = tmp_path / "in.fastq"
    p.write_bytes(data)
    out = tmp_path / "out.fastq"
    single = util.run_tool(fastq_quality_trimmer, ["-t", "15", "-i", str(p)])
    shards = _run_sharded_inprocess(
        monkeypatch, fastq_quality_trimmer,
        ["-t", "15", "-i", str(p), "-o", str(out)], 2,
    )
    assert all(r.status == 0 for r in shards)
    parts = [
        (tmp_path / ("out.fastq.shard-%05d-of-00002" % k)).read_bytes()
        for k in range(2)
    ]
    assert b"".join(parts) == single.stdout
    assert not out.exists()


def test_shard_only_stdin_rejected(monkeypatch):
    monkeypatch.setenv("FASTX_TPU_NUM_SHARDS", "2")
    monkeypatch.setenv("FASTX_TPU_SHARD_ID", "0")
    multihost._reset_for_tests()
    try:
        r = util.run_tool(fastq_quality_trimmer, ["-t", "20"], stdin=b"@a\nAC\n+\nII\n")
        assert r.status == 1
        assert "seekable" in r.stderr
    finally:
        multihost._reset_for_tests()

WORKER = textwrap.dedent(
    """
    import os, sys, functools
    rank = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                               num_processes=nproc, process_id=rank)
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from jax.experimental import multihost_utils
    from fastx_toolkit_tpu.ops import stats as S

    devs = jax.devices()
    assert len(devs) == nproc
    mesh = Mesh(np.array(devs), ("data",))
    rng = np.random.default_rng(100 + rank)
    B, L = 32, 16
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    quals = rng.integers(0, 41, size=(B, L)).astype(np.int8)
    lengths = np.full(B, L, np.int32)
    counts = np.ones(B, np.int32)
    gb = multihost_utils.host_local_array_to_global_array(
        (bases, quals, lengths, counts), mesh,
        (P("data", None), P("data", None), P("data"), P("data")))

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("data"), P("data"), P("data"), P("data")),
                       out_specs=P(), check_vma=False)
    def go(b, q, l, c):
        count, *_ = S.accumulate(b, q, l, c, is_fastq=True)
        return jax.lax.psum(count, "data")

    out = jax.jit(go)(*gb)
    total = int(np.asarray(out)[0, 0])
    assert total == B * nproc, total
    print("OK rank", rank)
    """
)


TOOL_WORKER = textwrap.dedent(
    """
    import json, sys
    import importlib
    from fastx_toolkit_tpu.cli import common
    cmds = json.load(open(sys.argv[1]))
    for tool, argv in cmds:
        mod = importlib.import_module("fastx_toolkit_tpu.cli.tools." + tool)
        sys.argv = [tool]
        st = common.run_tool_main(mod.tool_main, argv)
        assert st == 0, (tool, st)
    print("ALL-OK")
    """
)


@pytest.mark.skipif(sys.platform != "linux", reason="linux only")
def test_two_process_tools_end_to_end(tmp_path):
    """The full multi-host front-end, 2 real processes on one input file:
    quality-stats (psum-style histogram merge), collapser (global table
    merge incl. cross-shard duplicates), a streaming filter (shard
    outputs + merged -v report), and the uncollapser (global sequential
    IDs via prefix-sum).  Process 0's outputs and reports must be
    byte-identical to a single-process run; process 1 must print no
    report."""
    rng = np.random.default_rng(77)
    # FASTQ lane for stats + trimmer
    fq, _ = _synth_fastq(401, seed=41, tricky=False)
    fq_path = tmp_path / "lane.fastq"
    fq_path.write_bytes(fq)
    # FASTA with duplicates straddling the shard boundary for the collapser
    seqs = ["".join(rng.choice(list("ACGT"), 12)) for _ in range(40)]
    recs = []
    for i in range(300):
        s = seqs[int(rng.integers(0, len(seqs)))]
        recs.append(">r%d\n%s\n" % (i, s))
    fa_path = tmp_path / "dups.fasta"
    fa_path.write_bytes("".join(recs).encode())
    # collapsed FASTA for the uncollapser
    col = util.run_tool(fastx_collapser, ["-i", str(fa_path)])
    assert col.status == 0
    col_path = tmp_path / "collapsed.fasta"
    col_path.write_bytes(col.stdout)

    cmds = [
        ["fastx_quality_stats", ["-i", str(fq_path), "-o", str(tmp_path / "stats.out")]],
        ["fastx_collapser", ["-v", "-i", str(fa_path), "-o", str(tmp_path / "col.out")]],
        ["fastq_quality_trimmer", ["-v", "-t", "20", "-l", "5",
                                   "-i", str(fq_path), "-o", str(tmp_path / "trim.out")]],
        ["fastx_uncollapser", ["-v", "-i", str(col_path), "-o", str(tmp_path / "unc.out")]],
        # the fused packed pipeline (one device program for the chain)
        ["fastx_pipeline", ["-v", "-Q", "33", "-i", str(fq_path),
                            "-o", str(tmp_path / "pipe.out"),
                            "fastx_trimmer -f 2 -l 60 | fastq_quality_trimmer -t 20 -l 5 | fastq_masker -q 20"]],
    ]
    cmds_path = tmp_path / "cmds.json"
    cmds_path.write_text(json.dumps(cmds))
    w = tmp_path / "toolworker.py"
    w.write_text(TOOL_WORKER)

    def env_for(rank):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            PYTHONPATH=util.REPO,
            FASTX_TPU_COORDINATOR="127.0.0.1:19857",
            FASTX_TPU_NUM_PROCESSES="2",
            FASTX_TPU_PROCESS_ID=str(rank),
        )
        for k in ("XLA_FLAGS", "FASTX_TPU_NUM_SHARDS", "FASTX_TPU_SHARD_ID"):
            env.pop(k, None)
        return env

    procs = [
        subprocess.Popen(
            [sys.executable, str(w), str(cmds_path)],
            env=env_for(r), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(2)
    ]
    raw = [p.communicate(timeout=480) for p in procs]
    # the Gloo transport prints a connection banner; drop it
    outs = [
        "".join(
            ln for ln in o.decode().splitlines(keepends=True)
            if not ln.startswith("[Gloo]")
        )
        for o, _ in raw
    ]
    for p, o, (_, e) in zip(procs, outs, raw):
        assert p.returncode == 0, (o, e.decode())
        assert "ALL-OK" in o

    # single-process expectations (in this pytest process)
    exp_stats = util.run_tool(fastx_quality_stats, ["-i", str(fq_path)])
    exp_col = util.run_tool(fastx_collapser, ["-v", "-i", str(fa_path), "-o", "-"])
    exp_trim = util.run_tool(
        fastq_quality_trimmer,
        ["-v", "-t", "20", "-l", "5", "-i", str(fq_path), "-o", "-"],
    )
    exp_unc = util.run_tool(fastx_uncollapser, ["-v", "-i", str(col_path), "-o", "-"])
    from fastx_toolkit_tpu.cli.tools import fastx_pipeline

    exp_pipe = util.run_tool(
        fastx_pipeline,
        ["-v", "-Q", "33", "-i", str(fq_path), "-o", "-",
         "fastx_trimmer -f 2 -l 60 | fastq_quality_trimmer -t 20 -l 5 | fastq_masker -q 20"],
    )

    assert (tmp_path / "stats.out").read_bytes() == exp_stats.stdout
    assert (tmp_path / "col.out").read_bytes() == exp_col.stdout
    trim_parts = b"".join(
        (tmp_path / ("trim.out.shard-%05d-of-00002" % k)).read_bytes()
        for k in range(2)
    )
    assert trim_parts == exp_trim.stdout
    unc_parts = b"".join(
        (tmp_path / ("unc.out.shard-%05d-of-00002" % k)).read_bytes()
        for k in range(2)
    )
    assert unc_parts == exp_unc.stdout
    pipe_parts = b"".join(
        (tmp_path / ("pipe.out.shard-%05d-of-00002" % k)).read_bytes()
        for k in range(2)
    )
    assert pipe_parts == exp_pipe.stdout

    # merged -v reports print once, on process 0, with global counters.
    # reports went to stdout (-o given); worker stdout = reports in command
    # order + ALL-OK
    rank0_reports = outs[0].replace("ALL-OK\n", "")
    expected_reports = (exp_col.report + exp_trim.report + exp_unc.report
                        + exp_pipe.report)
    assert rank0_reports == expected_reports
    assert outs[1].replace("ALL-OK\n", "") == ""


@pytest.mark.skipif(sys.platform != "linux", reason="linux only")
def test_two_process_psum(tmp_path):
    w = tmp_path / "worker.py"
    w.write_text(WORKER)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=util.REPO)
    env.pop("XLA_FLAGS", None)
    port = "19841"
    procs = [
        subprocess.Popen(
            [sys.executable, str(w), str(r), "2", port],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(2)
    ]
    outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
        assert "OK rank" in o
