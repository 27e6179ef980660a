"""One engine-dispatch policy for every dual-engine surface.

Several tools have two byte-identical engines — a fused host-native C++
pass and a device (XLA) program — and the default depends on the
backend JAX runs on, not on the tool:

* ``stats``      — fastx_quality_stats histogram accumulation
                   (ops/stats.py: fx_stats_lines_q vs the accumulate_jit
                   scatter-add; reference loop
                   fastx_quality_stats.c:166-216)
* ``collapse``   — fastx_collapser dedup (native sharded hash fx_dedup_*
                   vs the device hash sort + segment-sum; reference
                   fastx_collapser.cpp:112-122)
* ``per-read``   — the six per-read CLI tools' raw-line fast path
                   (native decide+render from line spans) vs the classic
                   parse -> device-transform path.

Policy (the auto mode):

* **cpu** -> ``host`` whenever the native library is available: the
  device engines would run on the same cores, behind a padded parse.
* **gpu** -> the reductions take the engine in ``GPU_AUTO``, set from
  the host and device times that ``chip_smoke.py``'s engine phase
  measures on the card (recorded in CHANGES.md).
* **per-read tools** -> ``host`` on every backend: the classic path pays
  the same framing and rendering legs as the raw-line path plus a padded
  parse and pack on top, so it cannot come out ahead for a single tool.
  The device wins when many stages fuse into one program — that is the
  fastx_pipeline CLI, which always runs on the device.
  ``FASTX_LINEPATH=off`` forces the classic device path for
  differential testing.

Every surface keeps its env override (FASTX_STATS_PATH,
FASTX_COLLAPSE_PATH, FASTX_TPU_NO_LINEPATH) on top of this shared auto.
"""

from __future__ import annotations

_KINDS = ("stats", "collapse", "per-read")

# auto engine of each reduction on a GPU backend, from chip_smoke.py's
# engines phase: on an H100 (700 W limit) over a 2M-read lane the host
# engines took 0.92 s (stats) and 2.33 s (collapse) against the device
# engines' 2.10 s and 11.37 s
GPU_AUTO = {"stats": "host", "collapse": "host"}


def backend_kind() -> str:
    """'gpu' or 'cpu': the platform of JAX's default device."""
    import jax

    return "gpu" if jax.devices()[0].platform == "gpu" else "cpu"


def engine_auto(kind: str) -> str:
    """'host' or 'device' for a dual-engine surface (the shared auto
    policy; see module docstring for the rationale)."""
    from ..core import native

    if kind not in _KINDS:
        raise ValueError("unknown engine kind %r" % (kind,))
    if native.LIB is None:
        return "device"
    if kind == "per-read" or backend_kind() != "gpu":
        return "host"
    return GPU_AUTO[kind]


def resolve(kind: str, override: str | None) -> str:
    """Apply an explicit override ('host'/'device') over the auto policy.

    Unrecognized override strings fall back to auto (matching the
    historical FASTX_STATS_PATH/FASTX_COLLAPSE_PATH tolerance — a typo'd
    env var must not crash a streaming tool); a forced host engine
    without the native library is the one hard error, as before."""
    from ..core import native

    if override == "host":
        if native.LIB is None:
            raise RuntimeError(
                "engine override 'host' for %s requires the native codec "
                "library" % kind
            )
        return "host"
    if override == "device":
        return "device"
    return engine_auto(kind)
