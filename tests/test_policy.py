"""The shared engine-dispatch policy (engine/policy.py): one policy
function governs stats, collapser, and the per-read raw-line fast path."""

import io
from types import SimpleNamespace

import pytest

from fastx_toolkit_tpu.core import native
from fastx_toolkit_tpu.engine import policy

needs_native = pytest.mark.skipif(
    native.LIB is None, reason="native codec library unavailable"
)


def test_backend_kind_cpu():
    # the test harness runs on the CPU backend (JAX_PLATFORMS=cpu)
    assert policy.backend_kind() == "cpu"


def _fake_platform(monkeypatch, platform):
    import jax

    class Dev:
        pass

    d = Dev()
    d.platform = platform
    monkeypatch.setattr(jax, "devices", lambda *a: [d])


@pytest.mark.parametrize("platform,kind", [
    ("gpu", "gpu"), ("cpu", "cpu"), ("rocm", "cpu"),
])
def test_backend_kind_from_default_device(monkeypatch, platform, kind):
    """backend_kind reads jax.devices()[0].platform: a GPU is its own
    answer, every other platform is treated as the CPU."""
    _fake_platform(monkeypatch, platform)
    assert policy.backend_kind() == kind


@needs_native
def test_auto_reductions_host_on_cpu_and_tunnel(monkeypatch):
    # (the name predates the removal of the tunnel backend kind: every
    # backend but a GPU is now the CPU case)
    for kind in ("stats", "collapse", "per-read"):
        assert policy.engine_auto(kind) == "host"


@needs_native
def test_auto_engines_on_gpu(monkeypatch):
    """On a GPU the reductions take the measured GPU_AUTO engine and the
    per-read tools stay on the host."""
    _fake_platform(monkeypatch, "gpu")
    for kind in ("stats", "collapse"):
        assert policy.engine_auto(kind) == policy.GPU_AUTO[kind]
        for engine in ("host", "device"):
            monkeypatch.setitem(policy.GPU_AUTO, kind, engine)
            assert policy.engine_auto(kind) == engine
    assert policy.engine_auto("per-read") == "host"


def test_auto_device_without_native(monkeypatch):
    monkeypatch.setattr(native, "LIB", None)
    for kind in ("stats", "collapse", "per-read"):
        assert policy.engine_auto(kind) == "device"


def test_resolve_overrides(monkeypatch):
    assert policy.resolve("stats", "device") == "device"
    if native.LIB is not None:
        assert policy.resolve("collapse", "host") == "host"
    monkeypatch.setattr(native, "LIB", None)
    with pytest.raises(RuntimeError):
        policy.resolve("stats", "host")
    # unrecognized override strings (typo'd env vars) fall back to auto
    assert policy.resolve("stats", "bogus") == policy.engine_auto("stats")
    with pytest.raises(ValueError):
        policy.engine_auto("bogus")


@needs_native
def test_stats_and_collapse_paths_follow_policy(monkeypatch):
    from fastx_toolkit_tpu.cli.tools.fastx_collapser import collapse_path
    from fastx_toolkit_tpu.ops.stats import stats_path

    monkeypatch.delenv("FASTX_STATS_PATH", raising=False)
    monkeypatch.delenv("FASTX_COLLAPSE_PATH", raising=False)
    assert stats_path() == "host"  # CPU backend
    assert collapse_path() == "host"
    monkeypatch.setattr(policy, "backend_kind", lambda: "gpu")
    monkeypatch.setattr(policy, "GPU_AUTO", {"stats": "device",
                                             "collapse": "device"})
    assert stats_path() == "device"
    assert collapse_path() == "device"
    monkeypatch.setenv("FASTX_STATS_PATH", "host")
    monkeypatch.setenv("FASTX_COLLAPSE_PATH", "host")
    assert stats_path() == "host"
    assert collapse_path() == "host"
    monkeypatch.setattr(policy, "backend_kind", lambda: "cpu")
    monkeypatch.setenv("FASTX_STATS_PATH", "device")
    monkeypatch.setenv("FASTX_COLLAPSE_PATH", "device")
    assert stats_path() == "device"
    assert collapse_path() == "device"


def _mk_reader(data: bytes):
    from fastx_toolkit_tpu.cli.tools._shared import BatchReader
    from fastx_toolkit_tpu.core import codec

    args = SimpleNamespace(input_filename="<test>", q_offset=33)
    return BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                       stream=io.BytesIO(data))


@needs_native
def test_line_fast_path_follows_policy(monkeypatch):
    from fastx_toolkit_tpu.cli.tools import _shared

    data = b"@r1\nACGT\n+\nIIII\n"
    args = SimpleNamespace(input_filename="<test>", q_offset=33)
    monkeypatch.delenv("FASTX_LINEPATH", raising=False)
    monkeypatch.delenv("FASTX_TPU_NO_LINEPATH", raising=False)
    assert _shared.line_fast_path(_mk_reader(data), args) is not None
    # both historical and new off-switches force the classic path
    monkeypatch.setenv("FASTX_TPU_NO_LINEPATH", "1")
    assert _shared.line_fast_path(_mk_reader(data), args) is None
    monkeypatch.delenv("FASTX_TPU_NO_LINEPATH")
    monkeypatch.setenv("FASTX_LINEPATH", "off")
    assert _shared.line_fast_path(_mk_reader(data), args) is None
    monkeypatch.setenv("FASTX_LINEPATH", "on")
    assert _shared.line_fast_path(_mk_reader(data), args) is not None
