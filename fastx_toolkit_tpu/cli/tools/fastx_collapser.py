"""fastx_collapser — collapse identical sequences to >rank-count records.

Reference: /root/reference/src/fastx_collapser/fastx_collapser.cpp
Tie order among equal counts: the reference exposes libstdc++ hash-table
iteration order (implementation-defined); we use first-appearance order
(documented deterministic choice, see ops/collapse.py).

Two dedup engines with identical observable output:

* host — native C++ hash table (native/fastx_codec.cpp fx_dedup_*), the
  reference's own data structure vectorized and sharded; nothing ships
  over the device link.  Default whenever the native codec is available:
  dedup is pointer-chasing over unique keys, which a hash table does in
  O(bytes) while the device engine pays a full sort — the device only
  wins when the data is already resident (fused pipelines, --device
  benches).
* device — sort + segment-reduce (ops/collapse.py), used when the native
  library is unavailable and by the device-resident benchmarks; also the
  primitive behind parallel.mesh.sharded_collapse.

FASTX_COLLAPSE_PATH=host|device overrides the choice.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ...core import codec, native
from ...core.records import ReadBatch, StringColumn
from ...engine.pipeline import to_device
from ...ops import collapse
from ...parallel import multihost
from .. import common
from ..common import CliContext
from . import _shared

USAGE = (
    "usage: fastx_collapser [-h] [-v] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-v]         = verbose: print short summary of input/output counts\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Q output file. default is STDOUT.\n"
    "\n"
)


def collapse_path() -> str:
    """FASTX_COLLAPSE_PATH=host|device overrides the shared backend
    policy (engine.policy: device sort+segment-reduce or the native
    sharded hash).  Outputs are identical either way
    (tests/test_host_native.py)."""
    from ...engine import policy

    return policy.resolve("collapse", os.environ.get("FASTX_COLLAPSE_PATH"))


def tool_main(ctx: CliContext, argv) -> int:
    args = common.parse_cmdline(ctx, argv, "", None, USAGE)
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTA_OR_FASTQ)
    path = collapse_path()

    n_in_seq = 0
    n_in_reads = 0
    rec_base = 0

    if path == "host":
        table_native = native.DedupTable()
        # raw-line fast path (frame + validate, _shared.line_fast_path):
        # validation runs before insertion — the persistent table must
        # not see rows from a chunk the full parser would reject
        fast = _shared.line_fast_path(reader, args)
        for chunk, line_base in reader.iter_chunks():
            fr = fast(chunk) if fast is not None else None
            if fr is not None:
                if reader.is_fastq:
                    counts = None
                    n_in_reads += len(fr)  # FASTQ multiplicity is 1
                else:
                    # collapsed multiplicities from the '>id-count'
                    # names (get_reads_count, fastx.c:475-495)
                    counts = native.counts_from_names(
                        fr.buf, fr.name_starts, fr.name_lens
                    )
                    n_in_reads += int(counts.sum())
                table_native.insert_lines(
                    fr.buf, fr.seq_starts, fr.seq_lens, rec_base,
                    counts=counts,
                )
                n_in_seq += len(fr)
                rec_base += len(fr)
                continue
            batch = reader.parse_chunk(chunk, line_base)
            table_native.insert(
                batch.bases, batch.lengths, batch.counts, rec_base
            )
            n_in_seq += len(batch)
            n_in_reads += int(batch.counts.sum())
            rec_base += len(batch)
        key_offs, key_buf, uniq_counts, uniq_first = table_native.extract()
        table_native.close()
    else:
        # streaming accumulation: per-chunk device dedup (sort+segment-
        # reduce) shrinks each chunk to its unique sequences; a host table
        # merges chunks (count sum, min first-appearance)
        table: dict = {}
        for batch in reader:
            (bases, quals, lengths, counts), nb = to_device(batch)
            uniq_idx, uc, uf = collapse.collapse_batch(
                np.asarray(bases), np.asarray(counts)
            )
            real = (uniq_idx < nb) & (uc > 0)
            uniq_idx, uc, uf = uniq_idx[real], uc[real], uf[real]
            bmat = np.asarray(batch.bases)
            blens = np.asarray(batch.lengths)
            for ridx, c, f in zip(uniq_idx, uc, uf):
                seq = bmat[ridx, : blens[ridx]].tobytes()
                ent = table.get(seq)
                if ent is None:
                    table[seq] = [int(c), rec_base + int(f)]
                else:
                    ent[0] += int(c)
            n_in_seq += nb
            n_in_reads += int(batch.counts.sum())
            rec_base += nb
        seqs = list(table.keys())
        uniq_counts = np.array([table[s][0] for s in seqs], np.int64)
        uniq_first = np.array([table[s][1] for s in seqs], np.int64)
        key_buf = (
            np.frombuffer(b"".join(seqs), np.uint8)
            if seqs else np.zeros(0, np.uint8)
        )
        key_offs = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum([len(s) for s in seqs], out=key_offs[1:])

    # multi-host: each process collapsed its own byte-range shard; shift
    # first-appearance indices by the global record offset (shards are
    # file-ordered), allgather the (seq -> count, first) tables and merge
    # associatively — every process ends with the identical global table,
    # so the rank/count/tie-break order matches a single-process run.
    info = multihost.shard_info()
    if info.active and info.collective:
        offset = multihost.global_record_offset(rec_base)
        local = [
            (key_buf[key_offs[i]:key_offs[i + 1]].tobytes(),
             int(uniq_counts[i]), int(uniq_first[i]) + offset)
            for i in range(len(uniq_counts))
        ]
        merged: dict = {}
        for part in multihost.allgather_object(local):
            for s, c, f in part:
                ent = merged.get(s)
                if ent is None:
                    merged[s] = [c, f]
                else:
                    ent[0] += c
                    ent[1] = min(ent[1], f)
        n_in_seq, n_in_reads = multihost.allsum(n_in_seq, n_in_reads)
        seqs = list(merged.keys())
        uniq_counts = np.array([merged[s][0] for s in seqs], np.int64)
        uniq_first = np.array([merged[s][1] for s in seqs], np.int64)
        key_buf = (
            np.frombuffer(b"".join(seqs), np.uint8)
            if seqs else np.zeros(0, np.uint8)
        )
        key_offs = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum([len(s) for s in seqs], out=key_offs[1:])

    uniq_counts = np.asarray(uniq_counts, np.int64)
    uniq_first = np.asarray(uniq_first, np.int64)
    n_uniq = len(uniq_counts)
    order = collapse.final_order(uniq_counts, uniq_first)
    uniq_counts = uniq_counts[order]

    # vectorized output assembly: gather ordered keys into a padded
    # matrix, synthesize the rank-count id column without Python loops
    key_lens = np.diff(key_offs)
    starts = np.ascontiguousarray(key_offs[:-1][order])
    lens = np.ascontiguousarray(key_lens[order])
    width = int(lens.max()) if n_uniq else 0
    if native.LIB is not None and n_uniq:
        out_bases = native.gather_rows(key_buf, starts, lens, width)
    else:
        out_bases = codec._gather_padded(key_buf, starts, lens, width)
    name_buf, name_offs = collapse.rank_count_column(uniq_counts)

    out = ReadBatch(
        bases=out_bases,
        quals=np.zeros((n_uniq, width), np.int8),
        lengths=lens.astype(np.int32),
        counts=uniq_counts.astype(np.int32),
        names=StringColumn(name_buf, name_offs),
        names2=None,
        is_fastq=False,
    )
    writer = common.OutputWriter(ctx, args, role="merged")
    writer.write(codec.render(out, out_fastq=False))
    writer.close()

    if args.verbose:
        rep = common.report_stream(ctx, args)
        rep.write(
            "Input: %d sequences (representing %d reads)\n"
            % (n_in_seq, n_in_reads)
        )
        rep.write(
            "Output: %d sequences (representing %d reads)\n"
            % (n_uniq, int(uniq_counts.sum()))
        )
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()
