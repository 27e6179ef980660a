"""fastx_toolkit_tpu — a FASTA/FASTQ read-preprocessing framework in JAX.

A from-scratch re-design of the capabilities of FASTX-Toolkit
(reference: agordon/fastx_toolkit v0.0.14) built on jax/XLA, running
on NVIDIA GPUs or JAX's CPU backend:

* Records are parsed once (host, vectorized numpy / native codec) into a
  ``ReadBatch`` of padded int8 tensors (``bases [B,L]``, ``quals [B,L]``,
  ``lengths [B]``, ``counts [B]``).
* Every per-read tool of the reference is a pure, vmapped/jitted batch
  transform over the ReadBatch (see ``fastx_toolkit_tpu.ops``).
* The adapter clipper's DP alignment is an integer-scaled dynamic program
  (lax.scan) reproducing the reference scoring exactly
  (see ``fastx_toolkit_tpu.kernels.align``).
* Reductions (quality stats, collapser counts, barcode tallies) are
  device-side scatter-adds merged across hosts with ``psum``/all-gather
  (see ``fastx_toolkit_tpu.parallel``).
* Byte-identical text output is rendered host-side from the device
  results (see ``fastx_toolkit_tpu.core.codec``).
"""

__version__ = "0.1.0"
