"""The generated Galaxy functional-test pairs (galaxy/make_test_data.py)
must be deterministic, committed in sync, and reference-faithful: running
the compiled reference C binary on a generated input must reproduce the
generated golden byte for byte (for every tool the reference suite
covers and that has deterministic output)."""

import importlib.util
import os
import subprocess
import sys

import pytest

from test_differential_c import refbin  # noqa: F401  (fixture reuse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(REPO, "galaxy", "test-data")


def _mod():
    spec = importlib.util.spec_from_file_location(
        "make_test_data", os.path.join(REPO, "galaxy", "make_test_data.py")
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_generator_is_deterministic_and_committed(tmp_path):
    m = _mod()
    for name, gen in m.INPUTS.items():
        with open(os.path.join(TD, name), "rb") as f:
            committed = f.read()
        assert gen() == committed, "fixture %s out of sync; rerun make_test_data.py" % name
    # spot-check a couple of goldens too (full set is covered by the
    # C-binary comparison below; this catches tool drift)
    for tool, argv, inp, golden in m.GOLDENS[:6]:
        out = m.run_tool(tool, argv, m.INPUTS[inp]())
        with open(os.path.join(TD, golden), "rb") as f:
            assert out == f.read(), "golden %s out of sync" % golden


# every generated pair whose tool exists as a compiled C binary and whose
# output is deterministic in the reference (collapser tie order is not)
_C_CHECKED = [
    ("fastq_to_fasta", ["-Q", "64", "-v"], "fastq_to_fasta1.fastq", "fastq_to_fasta1a.out"),
    ("fastq_to_fasta", ["-Q", "64", "-n", "-r", "-v"], "fastq_to_fasta1.fastq", "fastq_to_fasta1b.out"),
    ("fastq_quality_converter", ["-n", "-Q", "64"], "fastq_qual_conv1.fastq", "fastq_qual_conv1.out"),
    ("fastq_quality_converter", ["-a", "-Q", "64"], "fastq_qual_conv2.fastq", "fastq_qual_conv2.out"),
    ("fastq_quality_filter", ["-Q", "64", "-q", "20", "-p", "80", "-v"], "fastq_qual_filter1.fastq", "fastq_qual_filter1b.out"),
    ("fastq_quality_trimmer", ["-Q", "64", "-v", "-t", "30", "-l", "16"], "fastq_quality_trimmer.fastq", "fastq_quality_trimmer.out"),
    ("fastq_masker", ["-Q", "64", "-v", "-q", "29", "-r", "x"], "fastq_masker.fastq", "fastq_masker.out"),
    ("fastx_trimmer", ["-Q", "64", "-v", "-f", "5", "-l", "36"], "fastx_trimmer1.fasta", "fastx_trimmer1.out"),
    ("fastx_trimmer", ["-Q", "64", "-v", "-t", "2", "-m", "16"], "fastx_trimmer_from_end1.fasta", "fastx_trimmer_from_end1.out"),
    ("fastx_clipper", ["-Q", "64", "-l", "15", "-a", "CAATTGGTTAATCCCCCTATATA", "-d", "0", "-v", "-n", "-c"], "fastx_clipper1.fastq", "fastx_clipper1a.out"),
    ("fastx_artifacts_filter", ["-Q", "64", "-v"], "fastx_artifacts1.fasta", "fastx_artifacts1.out"),
    ("fastx_reverse_complement", ["-Q", "64", "-v"], "fastx_rev_comp2.fastq", "fastx_reverse_complement2.out"),
    ("fastx_renamer", ["-Q", "64", "-n", "SEQ", "-v"], "fastx_renamer1.fastq", "fastx_renamer1.out"),
    ("fasta_nucleotide_changer", ["-r", "-v"], "fasta_nuc_changer1.fasta", "fasta_nuc_changer1.out"),
    ("fasta_nucleotide_changer", ["-d", "-v"], "fasta_nuc_changer2.fasta", "fasta_nuc_changer2.out"),
    ("fastx_quality_stats", ["-Q", "64"], "fastq_stats1.fastq", "fastq_stats1.out"),
    ("fastx_quality_stats", ["-Q", "64", "-N"], "fastq_stats1.fastq", "fastq_stats1_ng.out"),
]


@pytest.mark.parametrize("tool,argv,inp,golden", _C_CHECKED,
                         ids=[g for _, _, _, g in _C_CHECKED])
def test_generated_goldens_match_reference_binaries(refbin, tool, argv, inp, golden):  # noqa: F811
    with open(os.path.join(TD, inp), "rb") as f:
        data = f.read()
    p = subprocess.run([str(refbin / tool), *argv], input=data,
                       capture_output=True, timeout=120)
    assert p.returncode == 0, p.stderr
    with open(os.path.join(TD, golden), "rb") as f:
        assert p.stdout == f.read()


def test_icons_are_png():
    icons = os.path.join(REPO, "galaxy", "static", "fastx_icons")
    names = os.listdir(icons)
    assert len(names) >= 4
    for n in names:
        with open(os.path.join(icons, n), "rb") as f:
            assert f.read(4) == b"\x89PNG"


def test_every_xml_has_tests_and_fixtures_exist():
    """23/23 tool XMLs carry a <tests> block (the reference leaves the
    four plotters untested; we cover them with sim_size PNG goldens),
    and every file a test references exists in test-data."""
    import re

    xml_dir = os.path.join(REPO, "galaxy", "tools", "fastx_toolkit_tpu")
    xmls = sorted(f for f in os.listdir(xml_dir) if f.endswith(".xml"))
    assert len(xmls) == 23
    td_files = set(os.listdir(TD))
    for name in xmls:
        with open(os.path.join(xml_dir, name)) as f:
            xml = f.read()
        assert "<tests>" in xml, "%s has no <tests> block" % name
        for m in re.finditer(r'(?<!from_)(?:value|file)="([^"]+\.(?:fastq|fasta|txt|out|psl|png))"', xml):
            assert m.group(1) in td_files, "%s references missing %s" % (name, m.group(1))


def test_clipper_xml_sources_prebuilt_adapter_list():
    """The prebuilt-adapter <conditional> sources fastx_clipper_sequences
    .txt like the reference (fastx_clipper.xml:20-40), and the shipped
    tool-data file parses as (sequence TAB name) rows."""
    with open(os.path.join(REPO, "galaxy", "tools", "fastx_toolkit_tpu",
                           "fastx_clipper.xml")) as f:
        xml = f.read()
    assert '<conditional name="clip_source">' in xml
    assert 'from_file="fastx_clipper_sequences.txt"' in xml
    assert "'$clip_source.clip_sequence'" in xml
    with open(os.path.join(REPO, "galaxy", "tool-data",
                           "fastx_clipper_sequences.txt")) as f:
        rows = [l.split("\t") for l in f.read().splitlines()
                if l.strip() and not l.startswith("#")]
    assert rows and all(len(r) >= 2 for r in rows)
    import re
    assert all(re.fullmatch(r"[ACGTN]+", r[0]) for r in rows)


def test_barcode_splitter_html_golden_matches_wrapper():
    """fastx_barcode_splitter1.out is exactly what the Galaxy wrapper
    prints for the XML's test parameters."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as files_path:
        r = subprocess.run(
            [sys.executable,
             os.path.join(REPO, "galaxy", "fastx_barcode_splitter_galaxy_wrapper.py"),
             os.path.join(TD, "fastx_barcode_splitter1.txt"),
             os.path.join(TD, "fastx_barcode_splitter1.fastq"),
             "fastx_barcode_splitter1.fastq", files_path,
             "--mismatches", "2", "--partial", "0", "--bol"],
            capture_output=True, timeout=600, env=env,
        )
    assert r.returncode == 0, r.stderr
    with open(os.path.join(TD, "fastx_barcode_splitter1.out"), "rb") as f:
        assert r.stdout == f.read()


def test_plot_goldens_are_png():
    for n in ("fastq_quality_boxplot1.png", "fastq_nucleotides_distribution1.png",
              "fastq_nucleotides_distribution_line1.png",
              "fasta_clipping_histogram1.png"):
        with open(os.path.join(TD, n), "rb") as f:
            assert f.read(4) == b"\x89PNG", n
