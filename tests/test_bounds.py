"""Stress tests at the reference's documented limits:
MAX_SEQ_LINE_LENGTH = 25,000 bases (fastx.h:33-35).

* A > 64 MB stream (bigger than BatchReader's default block size) of
  maximum-length records, parsed chunk by chunk and re-rendered
  byte-identically.
* The raw-line stats/dedup fast paths at maximum-length records.
"""

import io
from types import SimpleNamespace

import numpy as np
import pytest

from fastx_toolkit_tpu.cli.tools._shared import BatchReader
from fastx_toolkit_tpu.core import codec

MAX_LEN = 25000


@pytest.mark.slow
def test_batchreader_stream_larger_than_block():
    """> 64 MB of maximum-length records through the default 64 MB block
    size: chunk boundaries fall inside records, every record round-trips
    byte-identically."""
    rng = np.random.default_rng(37)
    nrec = 2600  # ~73 MB at ~28 KB per (average) record
    recs = []
    for i in range(nrec):
        ln = MAX_LEN if i % 7 == 0 else int(rng.integers(1, MAX_LEN))
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=ln)
        q = (rng.integers(0, 41, ln) + 33).astype(np.uint8)
        recs.append(
            b"@read_%d\n%s\n+\n%s\n" % (i, seq.tobytes(), q.tobytes())
        )
    data = b"".join(recs)
    assert len(data) > 64 * 1024 * 1024
    args = SimpleNamespace(input_filename="<big>", q_offset=33)
    reader = BatchReader(
        None, args, filetype=codec.FASTQ_ONLY, stream=io.BytesIO(data)
    )
    out = []
    total = 0
    nchunks = 0
    for batch in reader:
        total += len(batch)
        nchunks += 1
        out.append(
            codec.render(batch, out_fastq=True, ascii_qual=True, q_offset=33)
        )
    assert total == nrec
    assert nchunks >= 2  # the stream really spanned multiple blocks
    assert b"".join(out) == data


@pytest.mark.slow
def test_fused_line_paths_at_max_length():
    """The raw-line stats/dedup fast paths at 25,000-base records."""
    from fastx_toolkit_tpu.core import native
    from fastx_toolkit_tpu.ops import stats as stats_ops

    if native.LIB is None:
        pytest.skip("native codec unavailable")
    rng = np.random.default_rng(41)
    recs = []
    for i in range(6):
        ln = MAX_LEN if i % 2 == 0 else int(rng.integers(1, MAX_LEN))
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=ln)
        q = (rng.integers(0, 41, ln) + 33).astype(np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), q.tobytes()))
    data = b"".join(recs) * 2  # duplicates for the dedup
    fr = codec.frame_fastq_fast(data)
    assert fr is not None
    buf, ss, sl, qs = fr
    assert native.validate_records(
        buf, ss, sl, qs, codec.allowed_table_u8(), 33
    ) == -1
    width = int(sl.max())
    assert width == MAX_LEN
    pernuc = native.stats_lines_q(buf, ss, qs, sl, width, 33)
    got = stats_ops.derive_from_hist(pernuc)
    batch = codec.parse(data, q_offset=33)
    ref = stats_ops.accumulate_jit(
        batch.bases, batch.quals, batch.lengths, batch.counts, is_fastq=True
    )
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r, np.int64), np.asarray(g, np.int64))
    tbl = native.DedupTable()
    tbl.insert_lines(buf, ss, sl, 0)
    offs, keys, uc, uf = tbl.extract()
    assert len(uc) == 6 and (np.asarray(uc) == 2).all()
    tbl.close()
