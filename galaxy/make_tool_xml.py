#!/usr/bin/env python3
"""Generate the Galaxy tool XML wrappers for fastx_toolkit_tpu.

One template, one spec per tool; command lines, parameters and the
golden-file tests mirror the reference wrappers
(/root/reference/galaxy/tools/fastx_toolkit/*.xml) so a Galaxy instance
using the reference toolkit can switch tool_conf entries directly.  Run
from the repo root:  python galaxy/make_tool_xml.py
"""

import os
import textwrap

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "fastx_toolkit_tpu")

Q_SWITCH = """#if $input.ext == "fastqsanger":
 -Q 33
#elif $input.ext == "fastq":
 -Q 64
#end if"""

FASTX_INPUT = '<param format="fastqsanger,fastq,fasta" name="input" type="data" label="Library to process" />'

# (id, name, description, command, inputs, outputs_format, tests)
TOOLS = [
    ("cshl_fastq_to_fasta_tpu", "FASTQ to FASTA",
     "converter (JAX engine)",
     "cat '$input' |\nfastq_to_fasta\n" + Q_SWITCH + "\n $SKIPN $RENAMESEQ -o '$output' -v",
     FASTX_INPUT + """
		<param name="SKIPN" type="select" label="Discard sequences with unknown (N) bases">
			<option value="">yes</option>
			<option value="-n">no</option>
		</param>
		<param name="RENAMESEQ" type="select" label="Rename sequence names in output file">
			<option value="-r">yes</option>
			<option value="">no</option>
		</param>""",
     "fasta",
     [({"input": "fastq_to_fasta1.fastq", "SKIPN": "", "RENAMESEQ": ""}, "fastq_to_fasta1a.out"),
      ({"input": "fastq_to_fasta1.fastq", "SKIPN": "-n", "RENAMESEQ": "-r"}, "fastq_to_fasta1b.out")]),

    ("cshl_fastq_quality_converter_tpu", "Quality format converter",
     "(ASCII-Numeric) (JAX engine)",
     "cat '$input' |\nfastq_quality_converter $QUAL_FORMAT -o '$output' -Q $offset",
     """<param format="fastqsanger,fastq" name="input" type="data" label="Library to convert" />
		<param name="QUAL_FORMAT" type="select" label="Desired output format">
			<option value="-a">ASCII (letters) quality scores</option>
			<option value="-n">Numeric quality scores</option>
		</param>
		<param name="offset" type="integer" value="64" label="ASCII offset" />""",
     "input",
     [({"input": "fastq_qual_conv1.fastq", "QUAL_FORMAT": "-n", "offset": "64"}, "fastq_qual_conv1.out"),
      ({"input": "fastq_qual_conv1.fastq", "QUAL_FORMAT": "-a", "offset": "64"}, "fastq_qual_conv1a.out"),
      ({"input": "fastq_qual_conv2.fastq", "QUAL_FORMAT": "-a", "offset": "64"}, "fastq_qual_conv2.out"),
      ({"input": "fastq_qual_conv2.fastq", "QUAL_FORMAT": "-n", "offset": "64"}, "fastq_qual_conv2n.out")]),

    ("cshl_fastq_quality_filter_tpu", "Filter by quality",
     "(JAX engine)",
     "cat '$input' |\nfastq_quality_filter\n" + Q_SWITCH + "\n -q $quality -p $percent -v -o '$output'",
     """<param format="fastqsanger,fastq" name="input" type="data" label="Library to filter" />
		<param name="quality" type="integer" value="20" label="Quality cut-off value" />
		<param name="percent" type="integer" value="90" label="Percent of bases in sequence that must have quality equal to / higher than cut-off value" />""",
     "input",
     [({"input": "fastq_qual_filter1.fastq", "quality": "33", "percent": "100"}, "fastq_qual_filter1a.out"),
      ({"input": "fastq_qual_filter1.fastq", "quality": "20", "percent": "80"}, "fastq_qual_filter1b.out")]),

    ("cshl_fastq_quality_trimmer_tpu", "Quality trimmer",
     "trim 3' low-quality run (JAX engine)",
     "cat '$input' |\nfastq_quality_trimmer\n" + Q_SWITCH + "\n -v -t $cutoff -l $minlen -o '$output'",
     """<param format="fastqsanger,fastq" name="input" type="data" label="Library to trim" />
		<param name="cutoff" type="integer" value="20" label="Quality cut-off value" />
		<param name="minlen" type="integer" value="0" label="Minimum sequence length after trimming" />""",
     "input",
     [({"input": "fastq_quality_trimmer.fastq", "cutoff": "30", "minlen": "16"}, "fastq_quality_trimmer.out")]),

    ("cshl_fastq_masker_tpu", "Mask low-quality bases",
     "(JAX engine)",
     "cat '$input' |\nfastq_masker\n" + Q_SWITCH + "\n -v -q $cutoff -r '$maskchar' -o '$output'",
     """<param format="fastqsanger,fastq" name="input" type="data" label="Library to mask" />
		<param name="cutoff" type="integer" value="20" label="Quality cut-off value" />
		<param name="maskchar" type="text" value="N" label="Mask character" />""",
     "input",
     [({"input": "fastq_masker.fastq", "cutoff": "29", "maskchar": "x"}, "fastq_masker.out")]),

    ("cshl_fastx_trimmer_tpu", "Trim sequences",
     "(JAX engine)",
     "cat '$input' |\nfastx_trimmer\n" + Q_SWITCH + "\n -v -f $first -l $last -o '$output'",
     FASTX_INPUT + """
		<param name="first" type="integer" value="1" label="First base to keep" />
		<param name="last" type="integer" value="21" label="Last base to keep" />""",
     "input",
     [({"input": "fastx_trimmer1.fasta", "first": "5", "last": "36"}, "fastx_trimmer1.out"),
      ({"input": "fastx_trimmer2.fastq", "first": "1", "last": "27"}, "fastx_trimmer2.out")]),

    ("cshl_fastx_trimmer_from_end_tpu", "Trim sequences from 3' end",
     "(JAX engine)",
     "cat '$input' |\nfastx_trimmer\n" + Q_SWITCH + "\n -v -t $trimnum -m $minlen -o '$output'",
     FASTX_INPUT + """
		<param name="trimnum" type="integer" value="2" label="Number of 3' bases to trim" />
		<param name="minlen" type="integer" value="16" label="Discard sequences shorter than" />""",
     "input",
     [({"input": "fastx_trimmer_from_end1.fasta", "trimnum": "2", "minlen": "16"}, "fastx_trimmer_from_end1.out")]),

    ("cshl_fastx_clipper_tpu", "Clip adapter sequences",
     "(JAX DP engine)",
     "cat '$input' |\nfastx_clipper\n" + Q_SWITCH + "\n -l $minlength -a '$clip_source.clip_sequence' -d $keepdelta -o '$output' -v $KEEP_N $DISCARD_OPTIONS",
     FASTX_INPUT + """
		<param name="minlength" type="integer" value="15" label="Minimum sequence length (after clipping)" />
		<conditional name="clip_source">
			<param name="clip_source_list" type="select" label="Source">
				<option value="prebuilt" selected="true">Standard (select from the list below)</option>
				<option value="user">Enter custom sequence</option>
			</param>
			<when value="user">
				<param name="clip_sequence" type="text" value="AATTGGCC" label="Enter custom clipping sequence" />
			</when>
			<when value="prebuilt">
				<param name="clip_sequence" type="select" label="Choose Adapter">
					<options from_file="fastx_clipper_sequences.txt">
						<column name="name" index="1"/>
						<column name="value" index="0"/>
					</options>
				</param>
			</when>
		</conditional>
		<param name="keepdelta" type="integer" value="0" label="Keep the adapter and N bases after it" />
		<param name="KEEP_N" type="select" label="Discard sequences with unknown (N) bases">
			<option value="">yes</option>
			<option value="-n">no</option>
		</param>
		<param name="DISCARD_OPTIONS" type="select" label="Output options">
			<option value="-c">Output only clipped sequences</option>
			<option value="-C">Output only non-clipped sequences</option>
			<option value="">Output both</option>
		</param>""",
     "input",
     [({"input": "fastx_clipper1.fastq", "minlength": "15",
        "clip_source_list": "user",
        "clip_sequence": "CAATTGGTTAATCCCCCTATATA", "keepdelta": "0",
        "KEEP_N": "-n", "DISCARD_OPTIONS": "-c"}, "fastx_clipper1a.out")]),

    ("cshl_fastx_artifacts_filter_tpu", "Remove sequencing artifacts",
     "(JAX engine)",
     "cat '$input' |\nfastx_artifacts_filter\n" + Q_SWITCH + "\n -v -o '$output'",
     FASTX_INPUT,
     "input",
     [({"input": "fastx_artifacts1.fasta"}, "fastx_artifacts1.out"),
      ({"input": "fastx_artifacts2.fastq"}, "fastx_artifacts2.out")]),

    ("cshl_fastx_reverse_complement_tpu", "Reverse-Complement",
     "(JAX engine)",
     "cat '$input' |\nfastx_reverse_complement\n" + Q_SWITCH + "\n -v -o '$output'",
     FASTX_INPUT,
     "input",
     [({"input": "fastx_rev_comp1.fasta"}, "fastx_reverse_complement1.out"),
      ({"input": "fastx_rev_comp2.fastq"}, "fastx_reverse_complement2.out")]),

    ("cshl_fastx_collapser_tpu", "Collapse",
     "sequences (sort+segment-reduce)",
     "cat '$input' |\nfastx_collapser\n" + Q_SWITCH + "\n -v -o '$output'",
     FASTX_INPUT,
     "fasta",
     [({"input": "fasta_collapser1.fasta"}, "fasta_collapser1.out")]),

    ("cshl_fastx_uncollapser_tpu", "Uncollapse",
     "sequences (JAX engine)",
     "cat '$input' |\nfastx_uncollapser -v -o '$output'",
     '<param format="fasta" name="input" type="data" label="Library to uncollapse" />',
     "fasta",
     [({"input": "fasta_uncollapser1.fasta"}, "fasta_uncollapser1.out")]),

    ("cshl_seqid_uncollapser_tpu", "Uncollapse tabular",
     "sequence ids in tabular files (JAX engine)",
     "cat '$input' |\nfastx_uncollapser -c $idcol -v -o '$output'",
     """<param format="tabular" name="input" type="data" label="Tabular file" />
		<param name="idcol" type="integer" value="1" label="Column with collapsed sequence identifier" />""",
     "input",
     [({"input": "fastx_seqid_uncollapse1.psl", "idcol": "10"}, "fastx_seqid_uncollapse1.out")]),

    ("cshl_fastx_renamer_tpu", "Rename sequences",
     "(JAX engine)",
     "cat '$input' |\nfastx_renamer\n" + Q_SWITCH + "\n -n $TYPE -o '$output' -v",
     FASTX_INPUT + """
		<param name="TYPE" type="select" label="Rename type">
			<option value="SEQ">Nucleotide sequence</option>
			<option value="COUNT">Numeric counter</option>
		</param>""",
     "input",
     [({"input": "fastx_renamer1.fastq", "TYPE": "SEQ"}, "fastx_renamer1.out")]),

    ("cshl_fasta_nucleotides_changer_tpu", "RNA/DNA",
     "converter (JAX engine)",
     "cat '$input' |\nfasta_nucleotide_changer $mode -v -o '$output'",
     """<param format="fasta" name="input" type="data" label="Library to convert" />
		<param name="mode" type="select" label="Conversion direction">
			<option value="-r">DNA to RNA (T to U)</option>
			<option value="-d">RNA to DNA (U to T)</option>
		</param>""",
     "fasta",
     [({"input": "fasta_nuc_changer1.fasta", "mode": "-r"}, "fasta_nuc_changer1.out"),
      ({"input": "fasta_nuc_changer2.fasta", "mode": "-d"}, "fasta_nuc_changer2.out")]),

    ("cshl_fasta_formatter_tpu", "FASTA Width formatter",
     "(JAX engine)",
     "cat '$input' |\nfasta_formatter -w $width -o '$output'",
     """<param format="fasta" name="input" type="data" label="Library to re-format" />
		<param name="width" type="integer" value="0" label="New width for nucleotide strings (0 = single line)" />""",
     "fasta",
     [({"input": "fasta_formatter1.fasta", "width": "0"}, "fasta_formatter1.out"),
      ({"input": "fasta_formatter1.fasta", "width": "60"}, "fasta_formatter2.out")]),

    ("cshl_fastx_quality_statistics_tpu", "Compute quality statistics",
     "(scatter-add reduction)",
     "cat '$input' |\nfastx_quality_stats\n" + Q_SWITCH + "\n -o '$output'",
     '<param format="fastqsanger,fastq,fasta" name="input" type="data" label="Library to analyse" />',
     "tabular",
     [({"input": "fastq_stats1.fastq"}, "fastq_stats1.out")]),

    ("cshl_fastx_quality_statistics_ng_tpu", "Compute quality statistics",
     "(improved) (scatter-add reduction)",
     "cat '$input' |\nfastx_quality_stats\n" + Q_SWITCH + "\n -N -o '$output'",
     '<param format="fasta,fastq,fastqsanger" name="input" type="data" label="Library to analyse" />',
     "tabular",
     [({"input": "fastq_stats1.fastq"}, "fastq_stats1_ng.out")]),

    # plotter goldens are rendered PNGs; pixel identity is not stable
    # across matplotlib versions, so Galaxy's sim_size comparison is used
    ("cshl_fastq_quality_boxplot_tpu", "Draw quality score boxplot",
     "",
     "fastq_quality_boxplot_graph.sh -t '$input.name' -i $input -o '$output'",
     '<param format="txt,tabular" name="input" type="data" label="Statistics report file" />',
     "png",
     [({"input": "fastq_stats1.out"},
       ("fastq_quality_boxplot1.png", 'compare="sim_size" delta="20000"'))]),

    ("cshl_fastx_nucleotides_distribution_tpu", "Draw nucleotides distribution chart",
     "",
     "fastx_nucleotide_distribution_graph.sh -t '$input.name' -i $input -o '$output'",
     '<param format="txt,tabular" name="input" type="data" label="Statistics report file" />',
     "png",
     [({"input": "fastq_stats1.out"},
       ("fastq_nucleotides_distribution1.png", 'compare="sim_size" delta="20000"'))]),

    ("cshl_fastx_nucleotides_distribution_line_plot_tpu",
     "Draw nucleotides distribution line chart",
     "",
     "fastx_nucleotide_distribution_line_graph.sh -i '$input' -o '$output'",
     '<param format="txt,tabular" name="input" type="data" label="Statistics report file (new -N format)" />',
     "png",
     [({"input": "fastq_stats1_ng.out"},
       ("fastq_nucleotides_distribution_line1.png", 'compare="sim_size" delta="20000"'))]),

    ("cshl_fasta_clipping_histogram_tpu", "Length distribution chart",
     "",
     "fasta_clipping_histogram.pl $input $outfile",
     '<param format="fasta" name="input" type="data" label="Library to analyze" />',
     "png",
     [({"input": "fasta_collapser1.fasta"},
       ("fasta_clipping_histogram1.png", 'compare="sim_size" delta="20000"',
        "outfile"))]),

    ("cshl_fastx_barcode_splitter_tpu", "Barcode Splitter",
     "(hamming matcher)",
     'fastx_barcode_splitter_galaxy_wrapper.py $BARCODE $input "$input.name" '
     '"$output.files_path" --mismatches $mismatches --partial $partial $EOL > $output',
     """<param format="txt" name="BARCODE" type="data" label="Barcodes to use" />
		<param format="fasta,fastq,fastqsanger" name="input" type="data" label="Library to split" />
		<param name="EOL" type="select" label="Barcodes found at">
			<option value="--bol">Start of sequence (5' end)</option>
			<option value="--eol">End of sequence (3' end)</option>
		</param>
		<param name="mismatches" type="integer" value="2" label="Number of allowed mismatches" />
		<param name="partial" type="integer" value="0" label="Number of allowed barcodes nucleotide deletions" />""",
     "html",
     [({"BARCODE": "fastx_barcode_splitter1.txt",
        "input": "fastx_barcode_splitter1.fastq", "EOL": "--bol",
        "mismatches": "2", "partial": "0"}, "fastx_barcode_splitter1.out")]),
]


def render(tool):
    tid, name, desc, command, inputs, outfmt, tests = tool
    out_elem = (
        '<data format="%s" name="output" metadata_source="input" />' % outfmt
        if outfmt != "input"
        else '<data format="input" name="output" metadata_source="input" />'
    )
    if tid == "cshl_fasta_clipping_histogram_tpu":
        out_elem = '<data format="png" name="outfile" metadata_source="input" />'
    tests_xml = []
    for params, golden in tests:
        # golden: "file" or ("file", extra output attrs[, output name])
        attrs, out_name = "", "output"
        if isinstance(golden, tuple):
            if len(golden) == 3:
                out_name = golden[2]
            golden, attrs = golden[0], " " + golden[1]
        rows = "\n".join(
            '\t\t\t<param name="%s" value="%s" />' % (k, v) for k, v in params.items()
        )
        tests_xml.append(
            "\t\t<test>\n%s\n\t\t\t<output name=\"%s\" file=\"%s\"%s />\n\t\t</test>"
            % (rows, out_name, golden, attrs)
        )
    tests_block = "\t<tests>\n%s\n\t</tests>\n" % "\n".join(tests_xml) if tests_xml else ""
    return """<tool id="%s" name="%s" version="0.1.0">
	<description>%s</description>
	<command>
%s
	</command>
	<inputs>
		%s
	</inputs>
	<outputs>
		%s
	</outputs>
%s	<help>
Part of the JAX FASTX toolkit (fastx_toolkit_tpu); behavior matches
the classic FASTX-Toolkit tool of the same name byte for byte.
	</help>
</tool>
""" % (tid, name, desc, command, inputs, out_elem, tests_block)


# filenames that differ from the tool-id stem, matching the reference tree
# (galaxy/tools/fastx_toolkit/) so a tool_conf.xml switch is a pure rename
FILENAMES = {
    "cshl_fasta_nucleotides_changer_tpu": "fasta_nucleotide_changer.xml",
    "cshl_fastx_nucleotides_distribution_line_plot_tpu": "fastx_nucleotides_distribution_line.xml",
}


def main():
    os.makedirs(OUT, exist_ok=True)
    for tool in TOOLS:
        name = FILENAMES.get(
            tool[0], tool[0].removeprefix("cshl_").removesuffix("_tpu") + ".xml"
        )
        with open(os.path.join(OUT, name), "w") as f:
            f.write(render(tool))
    print("wrote %d tool XMLs to %s" % (len(TOOLS), OUT))


if __name__ == "__main__":
    main()
