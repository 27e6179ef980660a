"""Streaming must be invisible: tiny block sizes produce byte-identical
output and reports, and -z gzip output round-trips."""

import gzip
import io
import os

import pytest

from util import REPO, fixture, run_tool


def run_tool_blocksize(tool_module, argv, stdin, block):
    os.environ["FASTX_TPU_BLOCK_BYTES"] = str(block)
    try:
        return run_tool(tool_module, argv, stdin)
    finally:
        del os.environ["FASTX_TPU_BLOCK_BYTES"]


@pytest.mark.parametrize("block", [64, 256, 4096])
def test_trimmer_streaming_equivalence(block):
    from fastx_toolkit_tpu.cli.tools import fastx_trimmer

    data = fixture("fastx_trimmer2.fastq")
    whole = run_tool(fastx_trimmer, ["-Q", "64", "-f", "2", "-l", "20", "-v"], data)
    small = run_tool_blocksize(
        fastx_trimmer, ["-Q", "64", "-f", "2", "-l", "20", "-v"], data, block
    )
    assert small.stdout == whole.stdout
    assert small.stderr == whole.stderr


@pytest.mark.parametrize("block", [64, 4096])
def test_clipper_streaming_keeps_legacy_state(block):
    """The legacy stale-matrix carry must survive chunk boundaries."""
    from fastx_toolkit_tpu.cli.tools import fastx_clipper

    import numpy as np

    rng = np.random.default_rng(23)
    rows = []
    for i in range(60):
        L = int(rng.integers(8, 40))
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L))
        rows.append(b">r%d\n%s\n" % (i, seq))
    data = b"".join(rows)
    argv = ["-a", "CTGTAG", "-v", "-l", "0"]
    whole = run_tool(fastx_clipper, argv, data)
    small = run_tool_blocksize(fastx_clipper, argv, data, block)
    assert small.stdout == whole.stdout
    assert small.stderr == whole.stderr


def test_stats_streaming_equivalence():
    from fastx_toolkit_tpu.cli.tools import fastx_quality_stats

    data = fixture("fastq_stats1.fastq")
    whole = run_tool(fastx_quality_stats, ["-Q", "64"], data)
    small = run_tool_blocksize(fastx_quality_stats, ["-Q", "64"], data, 128)
    assert small.stdout == whole.stdout


def test_collapser_streaming_equivalence():
    from fastx_toolkit_tpu.cli.tools import fastx_collapser

    data = fixture("fasta_collapser1.fasta")
    whole = run_tool(fastx_collapser, ["-v"], data)
    small = run_tool_blocksize(fastx_collapser, ["-v"], data, 100)
    assert small.stdout == whole.stdout
    assert small.stderr == whole.stderr


def test_gzip_output():
    from fastx_toolkit_tpu.cli.tools import fastq_to_fasta

    data = fixture("fastq_to_fasta1.fastq")
    plain = run_tool(fastq_to_fasta, ["-Q", "64"], data)
    import subprocess, sys, tempfile

    # -z pipes through the system gzip like the reference's fork+execlp;
    # run via a real process so the subprocess plumbing is exercised
    with tempfile.TemporaryDirectory() as d:
        inf = os.path.join(d, "in.fastq")
        outf = os.path.join(d, "out.fa.gz")
        open(inf, "wb").write(data)
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, "bin/fastq_to_fasta", "-Q", "64", "-z",
             "-i", inf, "-o", outf],
            capture_output=True, cwd=REPO, env=env, timeout=300,
        )
        assert r.returncode == 0, r.stderr
        assert gzip.open(outf).read() == plain.stdout


@pytest.mark.parametrize("block", [16, 512])
def test_formatter_streaming_equivalence(block):
    from fastx_toolkit_tpu.cli.tools import fasta_formatter

    data = fixture("fasta_formatter1.fasta")
    for argv in (["-w", "0"], ["-w", "60"], ["-t"], ["-e"]):
        whole = run_tool(fasta_formatter, argv, data)
        small = run_tool_blocksize(fasta_formatter, argv, data, block)
        assert small.stdout == whole.stdout, argv
