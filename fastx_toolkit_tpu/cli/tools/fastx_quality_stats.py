"""fastx_quality_stats — per-cycle quality/nucleotide statistics.

Reference: /root/reference/src/fastx_quality_stats/fastx_quality_stats.c
The accumulation runs on device as a scatter-add reduction
(fastx_toolkit_tpu.ops.stats); report rendering is host-side with the
reference's exact integer semantics.
"""

from __future__ import annotations

import os
import sys

import numpy as np

import dataclasses

from ...core import codec
from ...engine.pipeline import to_device
from ...ops import stats as stats_ops
from ...parallel import multihost
from .. import common
from ..common import CliContext
from . import _shared

USAGE = (
    "usage: fastx_quality_stats [-h] [-N] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h] = This helpful help screen.\n"
    "   [-i INFILE]  = FASTQ input file. default is STDIN.\n"
    "   [-o OUTFILE] = TEXT output file. default is STDOUT.\n"
    "   [-N]         = New output format (with more information per nucleotide/cycle).\n"
    "\n"
    "The *OLD* output TEXT file will have the following fields (one row per column):\n"
    "	column	= column number (1 to 36 for a 36-cycles read solexa file)\n"
    "	count   = number of bases found in this column.\n"
    "	min     = Lowest quality score value found in this column.\n"
    "	max     = Highest quality score value found in this column.\n"
    "	sum     = Sum of quality score values for this column.\n"
    "	mean    = Mean quality score value for this column.\n"
    "	Q1	= 1st quartile quality score.\n"
    "	med	= Median quality score.\n"
    "	Q3	= 3rd quartile quality score.\n"
    "	IQR	= Inter-Quartile range (Q3-Q1).\n"
    "	lW	= 'Left-Whisker' value (for boxplotting).\n"
    "	rW	= 'Right-Whisker' value (for boxplotting).\n"
    "	A_Count	= Count of 'A' nucleotides found in this column.\n"
    "	C_Count	= Count of 'C' nucleotides found in this column.\n"
    "	G_Count	= Count of 'G' nucleotides found in this column.\n"
    "	T_Count	= Count of 'T' nucleotides found in this column.\n"
    "	N_Count = Count of 'N' nucleotides found in this column.\n"
    "	max-count = max. number of bases (in all cycles)\n"
    "\n"
    "\n"
    "The *NEW* output format:\n"
    "	cycle (previously called 'column') = cycle number\n"
    "	max-count\n"
    "	For each nucleotide in the cycle (ALL/A/C/G/T/N):\n"
    "		count   = number of bases found in this column.\n"
    "		min     = Lowest quality score value found in this column.\n"
    "		max     = Highest quality score value found in this column.\n"
    "		sum     = Sum of quality score values for this column.\n"
    "		mean    = Mean quality score value for this column.\n"
    "		Q1	= 1st quartile quality score.\n"
    "		med	= Median quality score.\n"
    "		Q3	= 3rd quartile quality score.\n"
    "		IQR	= Inter-Quartile range (Q3-Q1).\n"
    "		lW	= 'Left-Whisker' value (for boxplotting).\n"
    "		rW	= 'Right-Whisker' value (for boxplotting).\n"
    "\n"
    "\n"
)


def tool_main(ctx: CliContext, argv) -> int:
    st = {"new_format": False}

    def cb(args, opt, arg):
        if opt == "N":
            st["new_format"] = True

    args = common.parse_cmdline(ctx, argv, "N", cb, USAGE)
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTA_OR_FASTQ)
    acc = stats_ops.StatsAccumulator.empty(0)
    path = stats_ops.stats_path()
    allowed = codec.allowed_table_u8() if path == "host" else None
    for chunk, line_base in reader.iter_chunks():
        # engine choice (see stats_ops.stats_path): the host C++
        # histogram kernel or the device scatter-add reduction
        parts = None
        if (path == "host" and reader.is_fastq
                and not os.environ.get("FASTX_TPU_NO_LINEPATH")):
            # fused raw-line fast path: frame + validate + accumulate with
            # no padded-matrix build; any anomaly (numeric quals, framing
            # or byte errors) re-parses for the reference's exact errors.
            # FASTQ multiplicity is always 1 (fastx.c:479-481), so the
            # full stats table derives from this histogram exactly.
            fr = codec.frame_fastq_fast(chunk)
            if fr is not None:
                from ...core import native

                buf, ss, sl, qs = fr
                if native.validate_records(
                    buf, ss, sl, qs, allowed, args.q_offset
                ) == -1:
                    width = int(sl.max()) if len(sl) else 0
                    pernuc = native.stats_lines_q(
                        buf, ss, qs, sl, width, args.q_offset
                    )
                    parts = stats_ops.derive_from_hist(pernuc)
        if parts is None:
            batch = reader.parse_chunk(chunk, line_base)
            use_host = path == "host" and (
                not batch.is_fastq
                or bool((np.asarray(batch.counts) == 1).all())
            )
            if use_host:
                parts = stats_ops.host_accumulate(
                    batch.bases, batch.quals, batch.lengths, batch.counts,
                    is_fastq=batch.is_fastq,
                )
            else:
                (bases, quals, lengths, counts), nb = to_device(batch)
                parts = stats_ops.accumulate_jit(
                    bases, quals, lengths, counts, is_fastq=batch.is_fastq
                )
        acc.merge_partial(*[np.asarray(p) for p in parts])

    # multi-host: every process accumulated its own input shard; the
    # histograms merge with +/min/max across the process group and only
    # process 0 renders (byte-identical to a single-process run)
    acc = multihost.merge_stats_accumulators(acc)
    text = (
        stats_ops.render_new_format(acc)
        if st["new_format"]
        else stats_ops.render_old_format(acc)
    )
    # the reference writes stats through plain fopen — -z is accepted but
    # never compresses here (fastx_quality_stats.c:443-448)
    writer = common.OutputWriter(
        ctx, dataclasses.replace(args, compress=False), role="merged"
    )
    writer.write(text.encode())
    writer.close()
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()
