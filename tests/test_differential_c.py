"""Differential parity vs the actual reference C binaries.

Compiles the reference tools from /root/reference with -O3 (skipped when
the reference tree or gcc is unavailable) and byte-compares outputs on
randomized inputs — far stronger than the fixed golden files.

The clipper is covered on ACGT-only AND N-heavy lanes: the DP engines
flag float-fragile ties (kernels/align*.py tie_fragile) and the CLI
re-decides them with the bit-faithful float32 engine, so N-bearing
output matches the C byte for byte too (the N tests at the bottom).
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from util import run_tool

R = "/root/reference/src"

pytestmark = pytest.mark.skipif(
    not (os.path.isdir(R) and shutil.which("gcc")),
    reason="reference sources or gcc unavailable",
)


@pytest.fixture(scope="module")
def refbin(tmp_path_factory):
    # other modules import this fixture without this module's skip mark
    if not (os.path.isdir(R) and shutil.which("gcc")):
        pytest.skip("reference sources or gcc unavailable")
    d = tmp_path_factory.mktemp("refbin")
    (d / "config.h").write_text('#define PACKAGE_STRING "FASTX Toolkit 0.0.14"\n')
    objs = []
    for src in ("fastx.c", "fastx_args.c", "chomp.c"):
        o = d / (src + ".o")
        subprocess.run(
            ["gcc", "-O3", "-I", str(d), "-I", f"{R}/libfastx", "-c",
             f"{R}/libfastx/{src}", "-o", str(o)],
            check=True, capture_output=True,
        )
        objs.append(str(o))
    c_tools = ("fastq_to_fasta", "fastq_quality_filter", "fastq_quality_trimmer",
               "fastq_masker", "fastx_trimmer", "fastx_artifacts_filter",
               "fastx_reverse_complement", "fastq_quality_converter",
               "fastx_renamer", "fasta_nucleotide_changer", "fastx_quality_stats")
    for t in c_tools:
        subprocess.run(
            ["gcc", "-O3", "-I", str(d), "-I", f"{R}/libfastx",
             f"{R}/{t}/{t}.c", *objs, "-o", str(d / t)],
            check=True, capture_output=True,
        )
    subprocess.run(
        ["g++", "-O3", "-I", str(d), "-I", f"{R}/libfastx",
         f"{R}/fastx_clipper/fastx_clipper.cpp",
         f"{R}/libfastx/sequence_alignment.cpp", *objs,
         "-o", str(d / "fastx_clipper")],
        check=True, capture_output=True,
    )
    subprocess.run(
        ["g++", "-O3", "-std=c++11", "-I", str(d), "-I", f"{R}/libfastx",
         f"{R}/fastx_collapser/fastx_collapser.cpp", *objs,
         "-o", str(d / "fastx_collapser")],
        check=True, capture_output=True,
    )
    # the two gtextutils-dependent C++ tools, compiled against the
    # minimal shim in tests/gtextutils_shim (VERDICT round-1 item #6)
    shim = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "gtextutils_shim")
    subprocess.run(
        ["g++", "-O3", "-I", str(d), "-I", f"{R}/libfastx", "-I", shim,
         f"{R}/fastx_uncollapser/fastx_uncollapser.cpp", *objs,
         "-o", str(d / "fastx_uncollapser")],
        check=True, capture_output=True,
    )
    # fasta_formatter uses its own getopt, not libfastx (SURVEY §2.2)
    subprocess.run(
        ["g++", "-O3", "-I", str(d), "-I", f"{R}/libfastx", "-I", shim,
         "-I", f"{R}/fasta_formatter",
         f"{R}/fasta_formatter/fasta_formatter.cpp",
         "-o", str(d / "fasta_formatter")],
        check=True, capture_output=True,
    )
    return d


def run_c(refbin, tool, argv, stdin: bytes):
    p = subprocess.run(
        [str(refbin / tool), *argv], input=stdin, capture_output=True, timeout=120
    )
    return p.returncode, p.stdout, p.stderr


def synth_fastq(n, lmin, lmax, seed, alpha=b"ACGTN", pn=0.03, q_offset=33,
                qmax=40):
    rng = np.random.default_rng(seed)
    p = [(1 - pn) / 4] * 4 + [pn]
    out = []
    for i in range(n):
        L = int(rng.integers(lmin, lmax + 1))
        seq = bytes(rng.choice(np.frombuffer(alpha, np.uint8), size=L, p=p))
        qual = bytes((rng.integers(0, qmax + 1, L) + q_offset).astype(np.uint8))
        out.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, qual))
    return b"".join(out)


def synth_fasta(n, lmin, lmax, seed, collapsed=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(lmin, lmax + 1))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L,
                               p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        name = b"r%d-%d" % (i, rng.integers(1, 9)) if collapsed else b"r%d" % i
        out.append(b">%s\n%s\n" % (name, seq))
    return b"".join(out)


def _compare(refbin, tool_mod, tool_name, argv, data):
    crc, cout, cerr = run_c(refbin, tool_name, argv, data)
    r = run_tool(tool_mod, list(argv), data, prog=tool_name)
    assert r.status == crc, (r.stderr, cerr)
    assert r.stdout == cout
    return r, cerr


CASES = [
    ("fastq_to_fasta", ["-Q", "33", "-v"]),
    ("fastq_to_fasta", ["-Q", "33", "-n", "-r", "-v"]),
    ("fastq_quality_filter", ["-Q", "33", "-q", "20", "-p", "70", "-v"]),
    ("fastq_quality_trimmer", ["-Q", "33", "-t", "25", "-l", "10", "-v"]),
    ("fastq_masker", ["-Q", "33", "-q", "22", "-r", "x", "-v"]),
    ("fastx_trimmer", ["-Q", "33", "-f", "3", "-l", "40", "-v"]),
    ("fastx_trimmer", ["-Q", "33", "-t", "5", "-m", "20", "-v"]),
    ("fastx_artifacts_filter", ["-Q", "33", "-v"]),
    ("fastx_reverse_complement", ["-Q", "33", "-v"]),
    ("fastq_quality_converter", ["-Q", "33", "-n"]),
    ("fastx_renamer", ["-Q", "33", "-n", "SEQ"]),
    ("fastx_renamer", ["-Q", "33", "-n", "COUNT"]),
    ("fastx_quality_stats", ["-Q", "33"]),
    ("fastx_quality_stats", ["-Q", "33", "-N"]),
]


@pytest.mark.parametrize("tool_name,argv", CASES)
def test_fastq_tools_differential(refbin, tool_name, argv):
    import importlib

    mod = importlib.import_module("fastx_toolkit_tpu.cli.tools." + tool_name)
    data = synth_fastq(300, 5, 80, seed=hash(tool_name + str(argv)) % 2**31)
    r, cerr = _compare(refbin, mod, tool_name, argv, data)
    if "-v" in argv:
        assert r.stderr == cerr.decode()


def test_clipper_differential_acgt(refbin):
    from fastx_toolkit_tpu.cli.tools import fastx_clipper

    adapter = "CTGTAGGCACCATCAAT"
    rng = np.random.default_rng(11)
    out = []
    for i in range(400):
        L = int(rng.integers(10, 70))
        seq = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L))
        if rng.random() < 0.5:
            pos = int(rng.integers(0, max(L - 4, 1)))
            ins = adapter.encode()[: int(rng.integers(3, len(adapter) + 1))]
            seq[pos : pos + len(ins)] = ins[: max(0, L - pos)]
        qual = bytes((rng.integers(0, 41, len(seq)) + 33).astype(np.uint8))
        out.append(b"@r%d\n%s\n+\n%s\n" % (i, bytes(seq), qual))
    data = b"".join(out)
    for argv in (
        ["-Q", "33", "-a", adapter, "-v"],
        ["-Q", "33", "-a", adapter, "-l", "10", "-c", "-v"],
        ["-Q", "33", "-a", adapter, "-C", "-n", "-v"],
        ["-Q", "33", "-a", adapter, "-d", "2", "-M", "6", "-v"],
        ["-Q", "33", "-a", adapter, "-k", "-v"],
    ):
        r, cerr = _compare(refbin, fastx_clipper, "fastx_clipper", argv, data)
        assert r.stderr == cerr.decode()


def test_fasta_tools_differential(refbin):
    from fastx_toolkit_tpu.cli.tools import (
        fasta_nucleotide_changer,
        fastx_quality_stats,
        fastx_trimmer,
    )

    data = synth_fasta(200, 5, 60, seed=3, collapsed=True)
    _compare(refbin, fastx_trimmer, "fastx_trimmer", ["-f", "2", "-l", "30", "-v"], data)
    _compare(refbin, fastx_quality_stats, "fastx_quality_stats", [], data)
    # changer requires no U in DNA->RNA mode; synth has none
    _compare(
        refbin, fasta_nucleotide_changer, "fasta_nucleotide_changer", ["-r", "-v"], data
    )


def test_collapser_counts_differential(refbin):
    """Collapser: counts and ranks must match; tie order is hash-order in
    the reference (order-insensitive compare within count groups)."""
    from fastx_toolkit_tpu.cli.tools import fastx_collapser

    rng = np.random.default_rng(17)
    pool = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=20))
            for _ in range(40)]
    data = b"".join(
        b">s%d\n%s\n" % (i, pool[int(rng.integers(0, 40))]) for i in range(500)
    )
    crc, cout, _ = run_c(refbin, "fastx_collapser", [], data)
    r = run_tool(fastx_collapser, [], data)
    assert r.status == crc == 0

    def parse(b):
        lines = b.decode().splitlines()
        recs = [(lines[i], lines[i + 1]) for i in range(0, len(lines), 2)]
        rank_count = [tuple(map(int, h[1:].split("-"))) for h, _ in recs]
        groups = {}
        for (rk, c), (_, s) in zip(rank_count, recs):
            groups.setdefault(c, set()).add(s)
        return rank_count, groups

    crk, cgr = parse(cout)
    ork, ogr = parse(r.stdout)
    assert crk == ork
    assert cgr == ogr


@pytest.mark.parametrize("tool_name", [
    "fastq_to_fasta", "fastq_quality_filter", "fastq_quality_trimmer",
    "fastq_masker", "fastx_trimmer", "fastx_artifacts_filter",
    "fastx_reverse_complement", "fastq_quality_converter", "fastx_renamer",
    "fasta_nucleotide_changer", "fastx_quality_stats", "fastx_clipper",
    "fastx_collapser",
])
def test_usage_text_differential(refbin, tool_name):
    """-h prints the exact reference usage text and exits 1."""
    import importlib

    mod = importlib.import_module("fastx_toolkit_tpu.cli.tools." + tool_name)
    crc, cout, _ = run_c(refbin, tool_name, ["-h"], b"")
    r = run_tool(mod, ["-h"], b"", prog=tool_name)
    assert r.status == crc == 1
    assert r.report.encode() == cout


def test_mixed_quality_format_differential(refbin):
    """OUTPUT_SAME_AS_INPUT preserves each record's own ASCII/numeric
    quality encoding (fastx.c:296-306,392-395)."""
    from fastx_toolkit_tpu.cli.tools import fastx_trimmer

    data = (
        b"@r0\nACGTACGTAC\n+\nIIIIIHHHHH\n"
        b"@r1\nACGTACGT\n+\n30 31 32 33 34 35 36 37\n"
        b"@r2\nTTTT\n+\nABCD\n"
        b"@r3\nGG\n+\n10 11\n"
    )
    r, cerr = _compare(
        refbin, fastx_trimmer, "fastx_trimmer", ["-Q", "33", "-f", "2", "-v"], data
    )
    assert r.stderr == cerr.decode()
    # numeric record stays numeric, ascii stays ascii
    assert b"31 32 33" in r.stdout and b"IIIIHHHHH"[-5:] in r.stdout


# ---------------------------------------------------------------------------
# gtextutils-dependent tools (compiled against tests/gtextutils_shim)
# ---------------------------------------------------------------------------

def synth_collapsed_fasta(seed, n=200):
    """Collapsed-style FASTA exercising every get_reads_count branch
    (fastx.c:475-495): plain 'rank-count' ids, ids with no dash, dash as
    last char, and non-numeric suffixes (all parse as count 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(1, 60))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L,
                               p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        kind = rng.integers(0, 5)
        if kind == 0:
            name = b"%d-%d" % (i + 1, rng.integers(1, 50))
        elif kind == 1:
            name = b"seq%d" % i            # no dash -> count 1
        elif kind == 2:
            name = b"%d-" % (i + 1)        # trailing dash -> count 1
        elif kind == 3:
            name = b"%d-abc" % (i + 1)     # non-numeric -> count 1
        else:
            name = b"x-%d-%d" % (i, rng.integers(1, 9))  # first dash wins
        out.append(b">%s\n%s\n" % (name, seq))
    return b"".join(out)


def test_uncollapser_fasta_differential(refbin):
    from fastx_toolkit_tpu.cli.tools import fastx_uncollapser

    data = synth_collapsed_fasta(seed=91)
    r, cerr = _compare(refbin, fastx_uncollapser, "fastx_uncollapser",
                       ["-v"], data)
    assert r.stderr == cerr.decode()


def synth_tabular(seed, n=150, with_empty_fields=True):
    """PSL-ish tabular lines whose column 4 holds a collapsed id;
    includes consecutive tabs (gtextutils' tokenizer collapses them) and
    varying column counts >= 4."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ncol = int(rng.integers(4, 9))
        fields = [b"f%d_%d" % (i, j) for j in range(ncol)]
        fields[3] = b"%d-%d" % (i + 1, rng.integers(1, 6))
        line = b"\t".join(fields)
        if with_empty_fields and rng.random() < 0.2:
            # extra tab: an empty token the reference tokenizer drops
            line = line.replace(b"\t", b"\t\t", 1)
        out.append(line + b"\n")
    return b"".join(out)


def test_uncollapser_tabular_differential(refbin):
    from fastx_toolkit_tpu.cli.tools import fastx_uncollapser

    data = synth_tabular(seed=92)
    r, cerr = _compare(refbin, fastx_uncollapser, "fastx_uncollapser",
                       ["-c", "4", "-v"], data)
    assert r.stderr == cerr.decode()


def test_uncollapser_tabular_too_few_columns(refbin):
    """A line with fewer columns than -c: identical error text on stderr
    and exit code 1 (fastx_uncollapser.cpp:153-160)."""
    from fastx_toolkit_tpu.cli.tools import fastx_uncollapser

    data = b"a\tb\t3-2\tz\na\tb\n"
    crc, cout, cerr = run_c(refbin, "fastx_uncollapser", ["-c", "3"], data)
    r = run_tool(fastx_uncollapser, ["-c", "3"], data, prog="fastx_uncollapser")
    assert r.status == crc == 1
    assert r.stdout == cout          # first line was emitted before the error
    assert r.stderr == cerr.decode()


def synth_multiline_fasta(seed, n=120):
    """Multi-line FASTA with empty records, blank lines, weird widths,
    and an unterminated final line — fasta_formatter's own parser
    territory (fasta_formatter.cpp:163-196)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(b">rec%d some description %d\n" % (i, i))
        if rng.random() < 0.15:
            continue  # empty record
        L = int(rng.integers(1, 200))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L))
        w = int(rng.integers(1, 80))
        for j in range(0, len(seq), w):
            out.append(seq[j:j + w] + b"\n")
        if rng.random() < 0.1:
            out.append(b"\n")  # stray blank line
    data = b"".join(out)
    if rng.random() < 0.5:
        data = data.rstrip(b"\n")  # unterminated final line
    return data


@pytest.mark.parametrize("argv", [
    ["-w", "0"], ["-w", "60"], ["-w", "7"], ["-t"], ["-w", "0", "-e"],
    ["-t", "-e"],
], ids=lambda a: " ".join(a))
def test_fasta_formatter_differential(refbin, argv):
    from fastx_toolkit_tpu.cli.tools import fasta_formatter

    data = synth_multiline_fasta(seed=93 + len(argv))
    _compare(refbin, fasta_formatter, "fasta_formatter", argv, data)


def test_fasta_formatter_empty_input_differential(refbin):
    """EOF before any record: the reference still calls write() once
    (fasta_formatter.cpp:197-198)."""
    from fastx_toolkit_tpu.cli.tools import fasta_formatter

    for argv in (["-w", "0"], ["-w", "0", "-e"], ["-t"]):
        _compare(refbin, fasta_formatter, "fasta_formatter", argv, b"")


def test_fasta_formatter_empty_input_tabular_e_divergence(refbin):
    """-t -e on EMPTY input: the reference ABORTS (TabulatedFastaWriter
    does sequence_id.substr(1) on the empty final write,
    sequence_writers.h:100 -> std::out_of_range -> SIGABRT).  We stay
    graceful and emit what the writer would have printed had substr(1)
    returned empty — a deliberate divergence from reference UB."""
    from fastx_toolkit_tpu.cli.tools import fasta_formatter

    crc, cout, cerr = run_c(refbin, "fasta_formatter", ["-t", "-e"], b"")
    assert crc == -6 and b"out_of_range" in cerr  # reference crash
    r = run_tool(fasta_formatter, ["-t", "-e"], b"", prog="fasta_formatter")
    assert r.status == 0
    assert r.stdout == b"\n"


# ---------------------------------------------------------------------------
# N-bearing float-tie parity (VERDICT r3 item #6): the DP kernels flag
# tie-fragile reads and the CLI re-decides them with the bit-faithful
# float32 engine, so even N-heavy lanes must now match the C byte for
# byte.  (The module docstring's old ACGT-only caveat no longer applies.)
# ---------------------------------------------------------------------------

def _n_heavy_clipper_lane(seed, n=500, adapter=b"CTGTAGGCACCATCAAT"):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(10, 70))
        seq = bytearray(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L,
                                   p=[0.22, 0.22, 0.22, 0.22, 0.12]))
        if rng.random() < 0.5:
            pos = int(rng.integers(0, max(L - 4, 1)))
            ins = bytearray(adapter[: int(rng.integers(3, len(adapter) + 1))])
            # sprinkle Ns into the adapter hit too: neutral-on-the-path
            for k in range(len(ins)):
                if rng.random() < 0.1:
                    ins[k] = ord("N")
            seq[pos:pos + len(ins)] = ins[: max(0, L - pos)]
        qual = bytes((rng.integers(0, 41, len(seq)) + 33).astype(np.uint8))
        out.append(b"@r%d\n%s\n+\n%s\n" % (i, bytes(seq), qual))
    return b"".join(out)


@pytest.mark.slow
def test_stats_negative_sum_unsigned_mean_differential(refbin):
    """A per-slot quality sum can go NEGATIVE (qualities reach -15); the
    reference stores sum as unsigned long long, so the mean column is
    computed from the WRAPPED value (e.g. sum=-5, count=1 -> mean
    18446744073709551616.00) while the %lld sum column reinterprets it
    back to the signed value.  Found by tests/fuzz_differential.py;
    emulated in ops/stats._fmt_mean.  Both output formats compared."""
    from fastx_toolkit_tpu.cli.tools import fastx_quality_stats

    # one N with quality -5 at a cycle nothing else reaches -> the N
    # slot's sum is -5 with count 1; a second lane drives the ALL slot
    # negative too
    rec = b"@a\nACGTN\n+\n" + bytes([33 + 30] * 4 + [33 - 5]) + b"\n"
    lane1 = rec * 3
    lane2 = b"@b\nNN\n+\n" + bytes([33 - 5, 33 - 4]) + b"\n"
    for data in (lane1, lane2, lane1 + lane2):
        for argv in (["-Q", "33", "-N"], ["-Q", "33"]):
            _compare(refbin, fastx_quality_stats, "fastx_quality_stats",
                     argv, data)


def test_clipper_differential_n_reads(refbin):
    from fastx_toolkit_tpu.cli.tools import fastx_clipper

    adapter = "CTGTAGGCACCATCAAT"
    for seed in (41, 42, 43):
        data = _n_heavy_clipper_lane(seed)
        for argv in (
            ["-Q", "33", "-a", adapter, "-n", "-v"],
            ["-Q", "33", "-a", adapter, "-n", "-l", "10", "-v"],
        ):
            r, cerr = _compare(refbin, fastx_clipper, "fastx_clipper",
                               argv, data)
            assert r.stderr == cerr.decode()


@pytest.mark.slow
def test_pipeline_differential_n_reads(refbin):
    """The fused pipeline chain vs the C shell pipeline on an N-heavy
    lane — masker-created Ns feed the clipper DP, the exact case the
    tie-fragility machinery exists for.

    The lane is uniform-length and the chain carries no length-changing
    stage before the clipper: with equal-width records the reference's
    grow-only DP matrix has no stale region, so the C's output is free
    of its stale-heap-bytes UB (sequence_alignment.cpp:131-153 + the
    reused query buffer) and the comparison isolates the float-tie
    machinery.  (With mixed widths the C scans stale bytes of earlier
    reads — undefined behavior the fused pipeline deliberately does not
    reproduce; the standalone fastx_clipper CLI does emulate it and its
    own N-heavy differential above is byte-exact.)"""
    from fastx_toolkit_tpu.cli.tools import fastx_pipeline

    adapter = "CTGTAGGCACCATCAAT"
    rng = np.random.default_rng(7)
    out = []
    for i in range(800):
        L = 60
        seq = bytearray(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L,
                                   p=[0.22, 0.22, 0.22, 0.22, 0.12]))
        if rng.random() < 0.5:
            pos = int(rng.integers(0, L - 4))
            ins = bytearray(adapter.encode()[: int(rng.integers(3, 18))])
            for k in range(len(ins)):
                if rng.random() < 0.1:
                    ins[k] = ord("N")
            seq[pos:pos + len(ins)] = ins[: max(0, L - pos)]
        qual = bytes((rng.integers(0, 41, L) + 33).astype(np.uint8))
        out.append(b"@r%d\n%s\n+\n%s\n" % (i, bytes(seq), qual))
    data = b"".join(out)
    stages = [
        ("fastq_quality_filter", ["-Q", "33", "-q", "12", "-p", "40"]),
        ("fastq_masker", ["-Q", "33", "-q", "8"]),
        ("fastx_clipper", ["-Q", "33", "-a", adapter, "-n"]),
        ("fastx_artifacts_filter", ["-Q", "33"]),
    ]
    cdata = data
    for tool, argv in stages:
        rc, cdata, _ = run_c(refbin, tool, argv, cdata)
        assert rc == 0
    chain = ("fastq_quality_filter -q 12 -p 40"
             " | fastq_masker -q 8 | fastx_clipper -a %s -n"
             " | fastx_artifacts_filter" % adapter)
    r = run_tool(fastx_pipeline, ["-Q", "33", chain], data)
    assert r.status == 0, r.stderr
    assert r.stdout == cdata


@pytest.mark.slow
def test_pipeline_classic_path_differential_n_reads(refbin, monkeypatch):
    """The pipeline CLI's classic per-batch fallback (-v / no line path)
    must ALSO match the C on N-heavy uniform-width lanes: its clipper
    stages flag tie-fragile rows and host_replay_chain re-decides them
    with the float32 engine."""
    from fastx_toolkit_tpu.cli.tools import fastx_pipeline

    adapter = "CTGTAGGCACCATCAAT"
    rng = np.random.default_rng(19)
    out = []
    for i in range(600):
        L = 60
        seq = bytearray(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L,
                                   p=[0.22, 0.22, 0.22, 0.22, 0.12]))
        if rng.random() < 0.5:
            pos = int(rng.integers(0, L - 4))
            ins = bytearray(adapter.encode()[: int(rng.integers(3, 18))])
            for k in range(len(ins)):
                if rng.random() < 0.1:
                    ins[k] = ord("N")
            seq[pos:pos + len(ins)] = ins[: max(0, L - pos)]
        qual = bytes((rng.integers(0, 41, L) + 33).astype(np.uint8))
        out.append(b"@r%d" % i + b"\n" + bytes(seq) + b"\n+\n" + qual + b"\n")
    data = b"".join(out)
    stages = [
        ("fastq_masker", ["-Q", "33", "-q", "8"]),
        ("fastx_clipper", ["-Q", "33", "-a", adapter, "-n"]),
        ("fastx_artifacts_filter", ["-Q", "33"]),
    ]
    cdata = data
    for tool, argv in stages:
        rc, cdata, _ = run_c(refbin, tool, argv, cdata)
        assert rc == 0
    chain = ("fastq_masker -q 8 | fastx_clipper -a %s -n"
             " | fastx_artifacts_filter" % adapter)
    monkeypatch.setenv("FASTX_TPU_NO_LINEPATH", "1")  # force the classic path
    r = run_tool(fastx_pipeline, ["-Q", "33", chain], data)
    assert r.status == 0, r.stderr
    assert r.stdout == cdata


@pytest.mark.slow
def test_pipeline_classic_replay_trimmer_revcomp(refbin, monkeypatch):
    """host_replay_chain's trimmer-shift and reverse-complement branches
    against the C chain (classic path, N-heavy uniform-width lane)."""
    from fastx_toolkit_tpu.cli.tools import fastx_pipeline

    adapter = "CTGTAGGCACCATCAAT"
    rng = np.random.default_rng(29)
    out = []
    for i in range(500):
        L = 64
        seq = bytearray(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L,
                                   p=[0.22, 0.22, 0.22, 0.22, 0.12]))
        if rng.random() < 0.5:
            pos = int(rng.integers(0, L - 4))
            ins = bytearray(adapter.encode()[: int(rng.integers(3, 18))])
            seq[pos:pos + len(ins)] = ins[: max(0, L - pos)]
        qual = bytes((rng.integers(0, 41, L) + 33).astype(np.uint8))
        out.append(b"@r%d" % i + b"\n" + bytes(seq) + b"\n+\n" + qual + b"\n")
    data = b"".join(out)
    stages = [
        ("fastx_trimmer", ["-Q", "33", "-f", "3", "-l", "60"]),
        ("fastx_reverse_complement", ["-Q", "33"]),
        ("fastx_clipper", ["-Q", "33", "-a", adapter, "-n"]),
    ]
    cdata = data
    for tool, argv in stages:
        rc, cdata, _ = run_c(refbin, tool, argv, cdata)
        assert rc == 0
    chain = ("fastx_trimmer -f 3 -l 60 | fastx_reverse_complement"
             " | fastx_clipper -a %s -n" % adapter)
    monkeypatch.setenv("FASTX_TPU_NO_LINEPATH", "1")
    r = run_tool(fastx_pipeline, ["-Q", "33", chain], data)
    assert r.status == 0, r.stderr
    assert r.stdout == cdata
