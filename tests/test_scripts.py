"""Tests for the plotting scripts, seqalign_test and the galaxy wrapper."""

import io
import os
import shutil
import subprocess
import sys

import pytest

from util import REPO, TEST_DATA, fixture, run_tool


def test_seqalign_test_output():
    from fastx_toolkit_tpu.cli.tools import seqalign_test

    r = run_tool(seqalign_test, [])
    assert r.status == 0
    assert "Score-Matrix:" in r.report
    assert "Query-Alingment" in r.report  # the reference's typo, kept


def test_boxplot_png(tmp_path):
    from fastx_toolkit_tpu.cli.tools import fastx_quality_stats
    from fastx_toolkit_tpu.scripts import quality_boxplot

    stats = run_tool(fastx_quality_stats, ["-Q", "64"], fixture("fastq_stats1.fastq"))
    statf = tmp_path / "stats.txt"
    statf.write_bytes(stats.stdout)
    out = tmp_path / "plot.png"
    rc = quality_boxplot.main_io(["-i", str(statf), "-t", "test", "-o", str(out)])
    assert rc == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_boxplot_rejects_fastq(tmp_path, capsys):
    from fastx_toolkit_tpu.scripts import quality_boxplot

    f = tmp_path / "x.fastq"
    f.write_bytes(fixture("fastq_stats1.fastq"))
    rc = quality_boxplot.main_io(["-i", str(f)])
    assert rc == 1


def test_nucdist_png(tmp_path):
    from fastx_toolkit_tpu.cli.tools import fastx_quality_stats
    from fastx_toolkit_tpu.scripts import nucleotide_distribution

    stats = run_tool(fastx_quality_stats, ["-Q", "64"], fixture("fastq_stats1.fastq"))
    statf = tmp_path / "stats.txt"
    statf.write_bytes(stats.stdout)
    out = tmp_path / "plot.png"
    rc = nucleotide_distribution.main_io(
        ["-i", str(statf), "-o", str(out)], line_graph=False, prog="t")
    assert rc == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"

    stats_new = run_tool(
        fastx_quality_stats, ["-Q", "64", "-N"], fixture("fastq_stats1.fastq"))
    statf.write_bytes(stats_new.stdout)
    rc = nucleotide_distribution.main_io(
        ["-i", str(statf), "-o", str(out)], line_graph=True, prog="t")
    assert rc == 0


def test_clipping_histogram_png(tmp_path):
    from fastx_toolkit_tpu.scripts import clipping_histogram

    fa = tmp_path / "in.fa"
    fa.write_bytes(fixture("fasta_collapser1.out"))
    out = tmp_path / "hist.png"
    rc = clipping_histogram.main_io([str(fa), str(out)])
    assert rc == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_galaxy_barcode_wrapper(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    fastq = tmp_path / "in.fastq"
    fastq.write_bytes(fixture("fastx_barcode_splitter1.fastq"))
    outdir = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "galaxy/fastx_barcode_splitter_galaxy_wrapper.py",
         os.path.join(TEST_DATA, "fastx_barcode_splitter1.txt"),
         str(fastq), "testlib", str(outdir), "--bol", "--mismatches", "2"],
        capture_output=True, text=True, cwd=REPO, timeout=600, env=env,
    )
    assert r.returncode == 0, r.stderr
    assert "<html><body><table border=1>" in r.stdout
    assert "BC1</td><td>11" in r.stdout.replace("\n", "")
    assert (outdir / "testlib__BC1.txt").exists()


def test_galaxy_barcode_wrapper_differential_vs_reference_sh(tmp_path):
    """Byte-compare our wrapper's HTML + every split file against the
    actual reference shell wrapper (fastx_barcode_splitter_galaxy_wrapper
    .sh:46-89 — libname sanitization, sed HTML table, link rewriting),
    which runs the real Perl splitter underneath."""
    ref_sh = ("/root/reference/galaxy/tools/fastx_toolkit/"
              "fastx_barcode_splitter_galaxy_wrapper.sh")
    if not (shutil.which("perl") and shutil.which("bash")
            and os.path.exists(ref_sh)):
        pytest.skip("reference wrapper prerequisites unavailable")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    bc = os.path.join(TEST_DATA, "fastx_barcode_splitter1.txt")
    fq = os.path.join(TEST_DATA, "fastx_barcode_splitter1.fastq")
    # libname exercises the sanitizer: .txt strip + non-alnum deletion
    libname = "my lib-1.2.txt"
    for args in (["--bol", "--mismatches", "2"],
                 ["--eol", "--mismatches", "1", "--partial", "1"]):
        refdir = tmp_path / ("ref" + args[0])
        ourdir = tmp_path / ("our" + args[0])
        r_ref = subprocess.run(
            ["bash", ref_sh, bc, fq, libname, str(refdir), *args],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PATH="/root/reference/scripts:"
                     + os.environ["PATH"]),
        )
        r_our = subprocess.run(
            [sys.executable, "galaxy/fastx_barcode_splitter_galaxy_wrapper.py",
             bc, fq, libname, str(ourdir), *args],
            capture_output=True, text=True, cwd=REPO, timeout=600,
            env=env,
        )
        assert r_our.returncode == r_ref.returncode == 0, (r_our.stderr,
                                                           r_ref.stderr)
        # links carry only basenames, so the HTML is path-independent
        assert r_our.stdout == r_ref.stdout
        ref_files = sorted(os.listdir(refdir))
        assert sorted(os.listdir(ourdir)) == ref_files
        assert ref_files and ref_files[0].startswith("mylib12__")
        for f in ref_files:
            assert (ourdir / f).read_bytes() == (refdir / f).read_bytes(), f


def test_galaxy_layer_covers_reference_tool_list():
    """Every reference Galaxy wrapper XML has a same-named counterpart here
    (SURVEY §2.4), and the section conf only references files that exist."""
    ref_dir = "/root/reference/galaxy/tools/fastx_toolkit"
    our_dir = os.path.join(REPO, "galaxy", "tools", "fastx_toolkit_tpu")
    ref_xmls = {f for f in os.listdir(ref_dir) if f.endswith(".xml")}
    our_xmls = set(os.listdir(our_dir))
    missing = ref_xmls - our_xmls
    assert not missing, f"galaxy wrappers missing vs reference: {sorted(missing)}"

    with open(os.path.join(REPO, "galaxy", "fastx_toolkit_tpu_conf.xml")) as f:
        conf = f.read()
    import re
    for m in re.finditer(r'file="fastx_toolkit_tpu/([^"]+)"', conf):
        assert m.group(1) in our_xmls, f"conf references missing XML {m.group(1)}"
