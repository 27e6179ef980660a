"""Multi-chip execution: data-parallel sharding + collective merges.

The reference is a single-threaded, single-process streaming program
(SURVEY §5); reads are independent, so the only parallelism axis in this
domain is DATA parallelism over reads, plus collective reductions for the
global operators:

* per-read transforms (trim/filter/mask/clip/...) — embarrassingly
  parallel, sharded over the batch axis of a 1-D ``Mesh(('data',))``;
  no communication at all.
* fastx_quality_stats — per-shard scatter-add histograms merged with
  ``psum``/``pmin``/``pmax`` over 'data' (NVLink within a host, the
  network across hosts).
* fastx_collapser — per-shard sort+segment dedup, then an all-gather of
  (key words, counts) and a re-collapse (associative merge).
* barcode splitter — sharded hamming matrix + argmin; per-barcode counts
  merged with psum.

Multi-host entry: see ``parallel.multihost`` — the CLI front-ends bring
the process group up from FASTX_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID,
the streaming loader (cli.tools._shared.BatchReader) splits the input
file by record-aligned byte ranges so each process owns a contiguous
slice of the records, and global results (stats histograms, collapse
tables, verbose counters) are merged across processes with host-level
allgathers so process 0's output is byte-identical to a single-process
run.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import stats as stats_ops
from ..ops import transforms
from ..ops.clipper import clip_batch


def distributed_init(**kwargs) -> None:
    """Initialize the multi-host process group (jax.distributed).

    No-op when running single-process."""
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        pass


def data_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise RuntimeError(
            "data_mesh(%d) needs %d devices but only %d are visible; for CPU "
            "simulation set XLA_FLAGS=--xla_force_host_platform_device_count=%d "
            "JAX_PLATFORMS=cpu before jax initializes" % (n, n, len(devs), n)
        )
    return Mesh(np.array(devs[:n]), ("data",))


def shard_batch(mesh: Mesh, *arrays):
    """Place arrays with the batch axis sharded over 'data'."""
    out = []
    for a in arrays:
        spec = P("data") if a.ndim == 1 else P("data", *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


def sharded_stats(mesh: Mesh, bases, quals, lengths, counts, *, is_fastq: bool):
    """Quality-stats reduction over a device mesh: per-shard scatter-add,
    explicit collective merge over 'data'."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data")),
        out_specs=(P(), P(), P(), P(), P()),
        check_vma=False,
    )
    def _go(b, q, l, c):  # noqa: E741
        count, hist, qsum, qmin, qmax = stats_ops.accumulate(
            b, q, l, c, is_fastq=is_fastq
        )
        return (
            jax.lax.psum(count, "data"),
            jax.lax.psum(hist, "data"),
            jax.lax.psum(qsum, "data"),
            jax.lax.pmin(qmin, "data"),
            jax.lax.pmax(qmax, "data"),
        )

    return jax.jit(_go)(bases, quals, lengths, counts)


def sharded_pipeline(mesh: Mesh, *, adapter: bytes = b"CTGTAGGCACCATCAAT",
                     trim_last: int = 0, filter_q: int = 20, filter_p: int = 50,
                     trim_q: int = 20, trim_minlen: int = 0, mask_q: int = 20,
                     clip_minlen: int = 5):
    """The flagship fused read-preprocessing step, data-parallel over the
    mesh: fastx_trimmer -> fastq_quality_filter -> fastq_quality_trimmer ->
    fastq_masker -> fastx_clipper -> fastx_artifacts_filter, plus a psum'd
    per-cycle stats reduction — one compiled program, no host round-trips.

    Returns a jitted fn (bases, quals, lengths, counts) ->
    (bases, quals, lengths, keep, stats_count).
    """
    from ..engine.pipeline import PipelineConfig, pipeline_body

    cfg = PipelineConfig(
        adapter=adapter, trim_last=trim_last, filter_q=filter_q,
        filter_p=filter_p, trim_q=trim_q, trim_minlen=trim_minlen,
        mask_q=mask_q, clip_minlen=clip_minlen,
        # the sharded step keeps the stats reduction on so the psum
        # collective is part of the compiled program (cheap: einsum counts)
        with_stats=True,
    )

    def _shard_body(b, q, l, c):  # noqa: E741
        return pipeline_body(b, q, l, c, cfg, psum_axis="data")

    sharded = jax.shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data"), P("data"), P()),
        # the align kernel's scan carries are created fresh inside the
        # shard (zeros), which trips the varying-manual-axes check; the
        # computation is per-shard pure map + explicit psum, so VMA
        # checking is safely disabled here
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_packed_pipeline(mesh: Mesh, cfg=None, *, two_bit: bool = True,
                            has_n_plane: Optional[bool] = None,
                            seq_len: Optional[int] = None):
    """sharded_pipeline over the packed host->device representation
    (engine.pipeline.pack_batch/pack_batch2: 2- or 4-bit bases + 1-bit
    quality threshold planes).  On a pod each host packs its own input
    shard, so the host-to-device feed carries ~4x fewer bytes; the
    device step unpacks with a few shift/mask ops and psums the stats counts
    over 'data' exactly like the unpacked variant.

    Returns a jitted fn (packed_bases, planes, lengths, counts) ->
    (new_lengths, keep, stats_count)."""
    from ..engine.pipeline import PipelineConfig, packed_pipeline_body

    if cfg is None:
        cfg = PipelineConfig(with_stats=True)

    def _shard_body(b, p, l, c):  # noqa: E741
        return packed_pipeline_body(b, p, l, c, cfg, psum_axis="data",
                                    two_bit=two_bit, has_n_plane=has_n_plane,
                                    seq_len=seq_len)

    sharded = jax.shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_collapse(mesh: Mesh, words, counts, first_idx):
    """fastx_collapser over a device mesh.

    Each shard dedups its rows locally (sort + segment-reduce), zeroing
    the counts of non-head rows; an all-gather over 'data' then brings the
    (still sorted-within-shard) tables together and a global re-collapse
    merges them — the collapse operator is associative, so the result is
    identical to a single-device collapse.  Returns replicated
    (words_sorted, seg_counts, seg_first) full-size arrays; rows with
    seg_counts == 0 are non-heads/padding.
    """
    from ..ops.collapse import collapse as _collapse

    def _local(w, c, f):
        perm, head, seg_id, seg_counts, seg_first = _collapse(w, c, f)
        sw = w[perm]
        # per-segment totals at head rows, zero elsewhere
        counts_at_head = jnp.where(head, seg_counts[seg_id], 0)
        first_at_head = jnp.where(head, seg_first[seg_id], jnp.iinfo(jnp.int32).max)
        return sw, counts_at_head.astype(c.dtype), first_at_head.astype(jnp.int32)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def _go(w, c, f):
        sw, ch, fh = _local(w, c, f)
        gw = jax.lax.all_gather(sw, "data", tiled=True)
        gc = jax.lax.all_gather(ch, "data", tiled=True)
        gf = jax.lax.all_gather(fh, "data", tiled=True)
        # global merge: re-collapse the gathered table
        perm, head, seg_id, seg_counts, seg_first = _collapse(gw, gc, gf)
        sw2 = gw[perm]
        counts2 = jnp.where(head, seg_counts[seg_id], 0)
        first2 = jnp.where(head, seg_first[seg_id], jnp.iinfo(jnp.int32).max)
        return sw2, counts2, first2

    return jax.jit(_go)(words, counts, first_idx)


def sharded_barcode_counts(mesh: Mesh, bases, lengths, barcodes, barcode_lens,
                           penalties, *, bol: bool, barcodes_length: int,
                           mismatches: int, n_idents: int, ident_of_barcode):
    """Barcode splitter tallies over a device mesh: sharded hamming
    matching + psum'd per-identifier counts (the record scatter itself is
    host-side file IO)."""

    ident_map = jnp.asarray(ident_of_barcode)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P()),
        check_vma=False,
    )
    def _go(b, l):  # noqa: E741
        best_idx, best_mm = transforms.barcode_match(
            b, l, barcodes, barcode_lens, penalties,
            bol=bol, barcodes_length=barcodes_length,
        )
        matched = (best_idx >= 0) & (best_mm <= mismatches)
        ident = jnp.where(matched, ident_map[jnp.maximum(best_idx, 0)], n_idents)
        tally = jnp.zeros(n_idents + 1, jnp.int32).at[ident].add(1)
        return jnp.where(matched, ident, -1), jax.lax.psum(tally, "data")

    return jax.jit(_go)(bases, lengths)
