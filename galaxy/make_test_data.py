#!/usr/bin/env python3
"""Generate galaxy/test-data/ (functional-test fixtures + golden outputs)
and galaxy/static/fastx_icons/ (help-page example charts).

The reference ships ~58 hand-made fixture files consumed by the tool
XMLs' <tests> blocks (SURVEY §2.4).  Here both sides of every test pair
are *generated*: inputs are deterministic synthetic libraries (seeded,
realistic: adapter-spiked reads, N bases, homopolymer artifacts,
collapsed ids, multi-line FASTA, a PSL table), and each golden output is
produced by running this package's own tool in-process with exactly the
flags the XML <command> template would build.  The tools themselves are
byte-verified against the reference C binaries elsewhere
(tests/test_differential_c.py, tests/test_tools_golden.py), and
tests/test_galaxy_testdata.py re-runs a sample of these pairs against
the compiled reference binaries directly.

usage: python galaxy/make_test_data.py [DEST_DIR]   (default: galaxy/)
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

ADAPTER = b"CAATTGGTTAATCCCCCTATATA"


# ---------------------------------------------------------------------------
# input synthesis
# ---------------------------------------------------------------------------

def _seqs(rng, n, lmin, lmax, alphabet=b"ACGT", p=None):
    out = []
    for _ in range(n):
        L = int(rng.integers(lmin, lmax + 1))
        out.append(bytes(rng.choice(np.frombuffer(alphabet, np.uint8), size=L, p=p)))
    return out


def make_fastq(n, lmin, lmax, seed, offset=64, n_frac=0.0, adapter=None,
               numeric=False, qmax=40):
    rng = np.random.default_rng(seed)
    recs = []
    for i, seq in enumerate(_seqs(rng, n, lmin, lmax)):
        seq = bytearray(seq)
        if n_frac and rng.random() < n_frac:
            seq[int(rng.integers(0, len(seq)))] = ord("N")
        if adapter is not None and rng.random() < 0.5:
            pos = int(rng.integers(0, max(1, len(seq) - 4)))
            ins = adapter[: len(seq) - pos]
            seq[pos : pos + len(ins)] = ins
        quals = rng.integers(2, qmax + 1, len(seq))
        if numeric:
            qline = b" ".join(b"%d" % q for q in quals)
        else:
            qline = bytes((quals + offset).astype(np.uint8))
        recs.append(b"@FXT_%d\n%s\n+FXT_%d\n%s\n" % (i, bytes(seq), i, qline))
    return b"".join(recs)


def make_fasta(n, lmin, lmax, seed, n_frac=0.0, wrap=0, dup_pool=0,
               collapsed=False, alphabet=b"ACGT", artifact_every=0):
    rng = np.random.default_rng(seed)
    seqs = _seqs(rng, n, lmin, lmax, alphabet=alphabet)
    if dup_pool:
        pool = seqs[:dup_pool]
        seqs = [pool[int(rng.integers(0, dup_pool))] for _ in range(n)]
    recs = []
    for i, seq in enumerate(seqs):
        seq = bytearray(seq)
        if artifact_every and i % artifact_every == 0:
            seq = bytearray(b"A" * len(seq))  # homopolymer artifact
            if len(seq) > 6:
                seq[2] = ord("C")
        if n_frac and rng.random() < n_frac:
            seq[int(rng.integers(0, len(seq)))] = ord("N")
        name = b"%d-%d" % (i + 1, rng.integers(1, 7)) if collapsed else b"FXT_%d" % i
        body = bytes(seq)
        if wrap:
            body = b"\n".join(body[j : j + wrap] for j in range(0, len(body), wrap))
        recs.append(b">%s\n%s\n" % (name, body))
    return b"".join(recs)


def make_psl(n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ident = b"%d-%d" % (i + 1, rng.integers(1, 5))
        cols = [b"21", b"0", b"0", b"0", b"0", b"0", b"0", b"0", b"-", ident,
                b"22", b"0", b"21", b"GENE%d" % i, b"22", b"1", b"22", b"1",
                b"21,", b"1,", b"1"]
        rows.append(b"\t".join(cols) + b"\n")
    return b"".join(rows)


INPUTS = {
    "fastq_to_fasta1.fastq": lambda: make_fastq(40, 20, 30, seed=1, n_frac=0.3),
    "fastq_qual_conv1.fastq": lambda: make_fastq(20, 15, 25, seed=2),
    "fastq_qual_conv2.fastq": lambda: make_fastq(20, 15, 25, seed=3, numeric=True),
    "fastq_qual_filter1.fastq": lambda: make_fastq(50, 20, 30, seed=4),
    "fastq_quality_trimmer.fastq": lambda: make_fastq(40, 18, 36, seed=5),
    "fastq_masker.fastq": lambda: make_fastq(30, 20, 30, seed=6),
    "fastx_trimmer1.fasta": lambda: make_fasta(25, 30, 45, seed=7),
    "fastx_trimmer2.fastq": lambda: make_fastq(25, 27, 36, seed=8),
    "fastx_trimmer_from_end1.fasta": lambda: make_fasta(25, 14, 30, seed=9),
    "fastx_clipper1.fastq": lambda: make_fastq(40, 25, 40, seed=10, n_frac=0.2,
                                               adapter=ADAPTER),
    "fastx_artifacts1.fasta": lambda: make_fasta(30, 20, 30, seed=11,
                                                 artifact_every=5),
    "fastx_artifacts2.fastq": lambda: make_fastq(30, 20, 30, seed=12),
    "fastx_rev_comp1.fasta": lambda: make_fasta(15, 15, 30, seed=13, n_frac=0.2),
    "fastx_rev_comp2.fastq": lambda: make_fastq(15, 15, 30, seed=14, n_frac=0.2),
    "fasta_collapser1.fasta": lambda: make_fasta(40, 12, 12, seed=15, dup_pool=9),
    "fasta_uncollapser1.fasta": lambda: make_fasta(15, 12, 20, seed=16,
                                                   collapsed=True),
    "fastx_seqid_uncollapse1.psl": lambda: make_psl(15, seed=17),
    "fastx_renamer1.fastq": lambda: make_fastq(20, 15, 25, seed=18),
    "fasta_nuc_changer1.fasta": lambda: make_fasta(15, 18, 30, seed=19),
    "fasta_nuc_changer2.fasta": lambda: make_fasta(15, 18, 30, seed=20,
                                                   alphabet=b"ACGU"),
    "fasta_formatter1.fasta": lambda: make_fasta(12, 40, 150, seed=21, wrap=50),
    "fastq_stats1.fastq": lambda: make_fastq(100, 36, 36, seed=22),
    # barcode splitter (galaxy wrapper test material)
    "fastx_barcode_splitter1.txt": lambda: (
        b"#ident\tbarcode\nBC1\tGATC\nBC2\tTCAG\nBC3\tAACC\n"
    ),
    "fastx_barcode_splitter1.fastq": lambda: make_fastq(30, 20, 30, seed=23),
}

# (tool module name, argv, input fixture, golden output)
GOLDENS = [
    ("fastq_to_fasta", ["-Q", "64", "-v"], "fastq_to_fasta1.fastq", "fastq_to_fasta1a.out"),
    ("fastq_to_fasta", ["-Q", "64", "-n", "-r", "-v"], "fastq_to_fasta1.fastq", "fastq_to_fasta1b.out"),
    ("fastq_quality_converter", ["-n", "-Q", "64"], "fastq_qual_conv1.fastq", "fastq_qual_conv1.out"),
    ("fastq_quality_converter", ["-a", "-Q", "64"], "fastq_qual_conv1.fastq", "fastq_qual_conv1a.out"),
    ("fastq_quality_converter", ["-a", "-Q", "64"], "fastq_qual_conv2.fastq", "fastq_qual_conv2.out"),
    ("fastq_quality_converter", ["-n", "-Q", "64"], "fastq_qual_conv2.fastq", "fastq_qual_conv2n.out"),
    ("fastq_quality_filter", ["-Q", "64", "-q", "33", "-p", "100", "-v"], "fastq_qual_filter1.fastq", "fastq_qual_filter1a.out"),
    ("fastq_quality_filter", ["-Q", "64", "-q", "20", "-p", "80", "-v"], "fastq_qual_filter1.fastq", "fastq_qual_filter1b.out"),
    ("fastq_quality_trimmer", ["-Q", "64", "-v", "-t", "30", "-l", "16"], "fastq_quality_trimmer.fastq", "fastq_quality_trimmer.out"),
    ("fastq_masker", ["-Q", "64", "-v", "-q", "29", "-r", "x"], "fastq_masker.fastq", "fastq_masker.out"),
    ("fastx_trimmer", ["-Q", "64", "-v", "-f", "5", "-l", "36"], "fastx_trimmer1.fasta", "fastx_trimmer1.out"),
    ("fastx_trimmer", ["-Q", "64", "-v", "-f", "1", "-l", "27"], "fastx_trimmer2.fastq", "fastx_trimmer2.out"),
    ("fastx_trimmer", ["-Q", "64", "-v", "-t", "2", "-m", "16"], "fastx_trimmer_from_end1.fasta", "fastx_trimmer_from_end1.out"),
    ("fastx_clipper", ["-Q", "64", "-l", "15", "-a", ADAPTER.decode(), "-d", "0", "-v", "-n", "-c"], "fastx_clipper1.fastq", "fastx_clipper1a.out"),
    ("fastx_artifacts_filter", ["-Q", "64", "-v"], "fastx_artifacts1.fasta", "fastx_artifacts1.out"),
    ("fastx_artifacts_filter", ["-Q", "64", "-v"], "fastx_artifacts2.fastq", "fastx_artifacts2.out"),
    ("fastx_reverse_complement", ["-Q", "64", "-v"], "fastx_rev_comp1.fasta", "fastx_reverse_complement1.out"),
    ("fastx_reverse_complement", ["-Q", "64", "-v"], "fastx_rev_comp2.fastq", "fastx_reverse_complement2.out"),
    ("fastx_collapser", ["-Q", "64", "-v"], "fasta_collapser1.fasta", "fasta_collapser1.out"),
    ("fastx_uncollapser", ["-v"], "fasta_uncollapser1.fasta", "fasta_uncollapser1.out"),
    ("fastx_uncollapser", ["-c", "10", "-v"], "fastx_seqid_uncollapse1.psl", "fastx_seqid_uncollapse1.out"),
    ("fastx_renamer", ["-Q", "64", "-n", "SEQ", "-v"], "fastx_renamer1.fastq", "fastx_renamer1.out"),
    ("fasta_nucleotide_changer", ["-r", "-v"], "fasta_nuc_changer1.fasta", "fasta_nuc_changer1.out"),
    ("fasta_nucleotide_changer", ["-d", "-v"], "fasta_nuc_changer2.fasta", "fasta_nuc_changer2.out"),
    ("fasta_formatter", ["-w", "0"], "fasta_formatter1.fasta", "fasta_formatter1.out"),
    ("fasta_formatter", ["-w", "60"], "fasta_formatter1.fasta", "fasta_formatter2.out"),
    ("fastx_quality_stats", ["-Q", "64"], "fastq_stats1.fastq", "fastq_stats1.out"),
    ("fastx_quality_stats", ["-Q", "64", "-N"], "fastq_stats1.fastq", "fastq_stats1_ng.out"),
]


def run_tool(tool_name, argv, stdin_bytes) -> bytes:
    import importlib

    from fastx_toolkit_tpu.cli.common import CliContext, ExitWithStatus

    mod = importlib.import_module("fastx_toolkit_tpu.cli.tools." + tool_name)
    out, err, rep = io.BytesIO(), io.StringIO(), io.StringIO()
    ctx = CliContext(prog=tool_name, stdin=io.BytesIO(stdin_bytes),
                     stdout=out, stderr=err, stdout_text=rep)
    try:
        status = mod.tool_main(ctx, list(argv))
    except ExitWithStatus as e:
        status = e.status
    if status != 0:
        raise RuntimeError("%s %s failed: %s" % (tool_name, argv, err.getvalue()))
    return out.getvalue()


def make_barcode_html_golden(test_data):
    """fastx_barcode_splitter1.out — the Galaxy wrapper's HTML summary
    for the splitter <tests> block (reference analog:
    galaxy/test-data/fastx_barcode_splitter1.out, regenerated because the
    reference's copy predates its own current wrapper: it embeds 2009
    date-stamped tango.cshl.edu URLs the shipped wrapper.sh no longer
    emits).  Our wrapper is byte-tested against the reference wrapper.sh
    in tests/test_scripts.py."""
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(HERE) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env["JAX_PLATFORMS"] = "cpu"
    with tempfile.TemporaryDirectory() as files_path:
        r = subprocess.run(
            [sys.executable,
             os.path.join(HERE, "fastx_barcode_splitter_galaxy_wrapper.py"),
             os.path.join(test_data, "fastx_barcode_splitter1.txt"),
             os.path.join(test_data, "fastx_barcode_splitter1.fastq"),
             "fastx_barcode_splitter1.fastq", files_path,
             "--mismatches", "2", "--partial", "0", "--bol"],
            capture_output=True, check=True, env=env,
        )
    with open(os.path.join(test_data, "fastx_barcode_splitter1.out"), "wb") as f:
        f.write(r.stdout)


def make_icons(dest_icons, test_data):
    """Help-page example charts, rendered by this package's own plot
    tools from the generated fixtures (the reference ships hand-made
    screenshots here)."""
    os.makedirs(dest_icons, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    bindir = os.path.join(os.path.dirname(HERE), "bin")

    stats_old = os.path.join(test_data, "fastq_stats1.out")
    stats_ng = os.path.join(test_data, "fastq_stats1_ng.out")
    jobs = [
        (["fastq_quality_boxplot_graph.sh", "-i", stats_old, "-t", "example",
          "-o", os.path.join(dest_icons, "fastq_quality_boxplot_1.png")], None),
        (["fastx_nucleotide_distribution_graph.sh", "-i", stats_old, "-t",
          "example", "-o",
          os.path.join(dest_icons, "fastq_nucleotides_distribution_1.png")], None),
        (["fastx_nucleotide_distribution_line_graph.sh", "-i", stats_ng, "-t",
          "example", "-o",
          os.path.join(dest_icons, "fastq_nucleotides_distribution_line_graph.png")], None),
        (["fasta_clipping_histogram.pl",
          os.path.join(test_data, "fasta_collapser1.fasta"),
          os.path.join(dest_icons, "fasta_clipping_histogram_1.png")], None),
    ]
    for argv, _ in jobs:
        argv[0] = os.path.join(bindir, argv[0])
        subprocess.run(argv, check=True, env=env, capture_output=True)


def make_plot_goldens(test_data):
    """PNG goldens for the four plotter tools' <tests> blocks (compared
    by Galaxy with sim_size — pixel identity is not stable across
    matplotlib versions)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    bindir = os.path.join(os.path.dirname(HERE), "bin")
    stats_old = os.path.join(test_data, "fastq_stats1.out")
    stats_ng = os.path.join(test_data, "fastq_stats1_ng.out")
    jobs = [
        ["fastq_quality_boxplot_graph.sh", "-i", stats_old,
         "-t", "fastq_stats1.out", "-o",
         os.path.join(test_data, "fastq_quality_boxplot1.png")],
        ["fastx_nucleotide_distribution_graph.sh", "-i", stats_old,
         "-t", "fastq_stats1.out", "-o",
         os.path.join(test_data, "fastq_nucleotides_distribution1.png")],
        ["fastx_nucleotide_distribution_line_graph.sh", "-i", stats_ng,
         "-o", os.path.join(test_data, "fastq_nucleotides_distribution_line1.png")],
        ["fasta_clipping_histogram.pl",
         os.path.join(test_data, "fasta_collapser1.fasta"),
         os.path.join(test_data, "fasta_clipping_histogram1.png")],
    ]
    for argv in jobs:
        argv[0] = os.path.join(bindir, argv[0])
        subprocess.run(argv, check=True, env=env, capture_output=True)


def main():
    dest = sys.argv[1] if len(sys.argv) > 1 else HERE
    test_data = os.path.join(dest, "test-data")
    os.makedirs(test_data, exist_ok=True)

    fixtures = {}
    for name, gen in INPUTS.items():
        data = gen()
        fixtures[name] = data
        with open(os.path.join(test_data, name), "wb") as f:
            f.write(data)
    for tool, argv, inp, golden in GOLDENS:
        out = run_tool(tool, argv, fixtures[inp])
        with open(os.path.join(test_data, golden), "wb") as f:
            f.write(out)
    make_barcode_html_golden(test_data)
    make_plot_goldens(test_data)
    print("wrote %d fixtures + %d goldens (+ barcode HTML + 4 plot PNGs) to %s"
          % (len(INPUTS), len(GOLDENS), test_data))
    make_icons(os.path.join(dest, "static", "fastx_icons"), test_data)
    print("wrote example charts to %s" % os.path.join(dest, "static", "fastx_icons"))


if __name__ == "__main__":
    main()
