"""The GPU bring-up surface that the CPU suite can check: the compile-cache
rule, fastx_pod's one-card-per-worker assignment, and chip_smoke.py's
inputs, comparison helpers and refusal to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

from util import REPO

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

from fastx_toolkit_tpu.cli import pod  # noqa: E402


def _python(code, **env):
    e = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    e.pop("JAX_COMPILATION_CACHE_DIR", None)
    e.update(env)
    return subprocess.run([sys.executable, "-c", code], env=e, cwd=REPO,
                          capture_output=True, text=True, timeout=300)


_SHOW_CACHE = (
    "from fastx_toolkit_tpu.cli.common import configure_compile_cache\n"
    "configure_compile_cache()\n"
    "import jax; print(jax.config.jax_compilation_cache_dir)\n"
)


def test_compile_cache_defaults_to_checkout():
    r = _python(_SHOW_CACHE)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_honours_env(tmp_path):
    r = _python(_SHOW_CACHE, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path)


class _FakePopen:
    envs = []

    def __init__(self, cmd, env=None):
        self.envs.append(env)

    def wait(self):
        return 0


@pytest.fixture
def fake_popen(monkeypatch):
    _FakePopen.envs = []
    monkeypatch.setattr(pod.subprocess, "Popen", _FakePopen)
    return _FakePopen.envs


def test_pod_gives_each_worker_its_own_card(monkeypatch, fake_popen):
    monkeypatch.setattr(pod, "visible_cards", lambda: 4)
    assert pod.main(["-n", "4", "--", "fastx_quality_stats", "-i", "x"]) == 0
    assert [e["JAX_LOCAL_DEVICE_IDS"] for e in fake_popen] == ["0", "1", "2", "3"]
    assert [e["FASTX_TPU_PROCESS_ID"] for e in fake_popen] == ["0", "1", "2", "3"]
    assert all(e["FASTX_TPU_NUM_PROCESSES"] == "4" for e in fake_popen)


def test_pod_refuses_more_workers_than_cards(monkeypatch, capsys, fake_popen):
    monkeypatch.setattr(pod, "visible_cards", lambda: 2)
    assert pod.main(["-n", "3", "--", "fastx_quality_stats"]) == 1
    assert "one card per worker" in capsys.readouterr().err
    assert fake_popen == []


def test_pod_cpu_workers_take_no_card(monkeypatch, fake_popen):
    monkeypatch.setattr(pod, "visible_cards", lambda: 0)
    monkeypatch.setenv("JAX_LOCAL_DEVICE_IDS", "0")
    assert pod.main(["-n", "3", "--cpu", "--", "fastx_quality_stats"]) == 0
    assert len(fake_popen) == 3
    for e in fake_popen:
        assert e["JAX_PLATFORMS"] == "cpu"
        assert "JAX_LOCAL_DEVICE_IDS" not in e


def test_visible_cards_without_opening_one(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,2")
    assert pod.visible_cards() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert pod.visible_cards() == 0
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\nprintf '0\\n1\\n2\\n'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert pod.visible_cards() == 3
    fake.unlink()
    assert pod.visible_cards() == 0


def test_smoke_lane_is_seeded_and_carries_ns():
    from bench import synth_lane_bytes
    from fastx_toolkit_tpu.core import codec

    lane = chip_smoke.make_lane(2000)
    assert lane == chip_smoke.make_lane(2000)
    plain = synth_lane_bytes(2000, chip_smoke.READ_LEN, seed=chip_smoke.SEED)
    assert len(lane) == len(plain)
    a = codec.parse(lane, filetype=codec.FASTQ_ONLY, q_offset=33)
    b = codec.parse(plain, filetype=codec.FASTQ_ONLY, q_offset=33)
    assert len(a) == 2000
    np.testing.assert_array_equal(a.quals, b.quals)
    changed = (a.bases != b.bases).any(axis=1)
    assert (a.bases[a.bases != b.bases] == ord("N")).all()
    assert 0.01 < changed.mean() < 0.04  # ~2% of reads carry Ns


def test_smoke_dp_inputs():
    bases, lengths = chip_smoke.dp_inputs(4096, seed=3)
    again, _ = chip_smoke.dp_inputs(4096, seed=3)
    np.testing.assert_array_equal(bases, again)
    assert bases.shape == (4096, chip_smoke.READ_LEN)
    assert lengths.min() >= 1 and lengths.max() == chip_smoke.READ_LEN
    beyond = np.arange(chip_smoke.READ_LEN)[None, :] >= lengths[:, None]
    assert (bases[beyond] == 0).all()
    assert set(np.unique(bases[~beyond])) <= set(b"ACGTN")
    assert 0.005 < (bases == ord("N")).any(axis=1).mean() < 0.04


def test_smoke_comparison_helpers():
    assert chip_smoke.first_diff(b"abc", b"abc") is None
    assert chip_smoke.first_diff(b"abc", b"abd") == 2
    assert chip_smoke.first_diff(b"ab", b"abc") == 2
    chip_smoke.check_same_bytes("same", b"xy", b"xy")
    with pytest.raises(AssertionError, match="at byte 1"):
        chip_smoke.check_same_bytes("diff", b"xy", b"xz")
    a = {"matches": np.array([1, 2]), "gaps": np.array([0, 0])}
    b = {"matches": np.array([1, 2]), "gaps": np.array([0, 1])}
    assert chip_smoke.dp_mismatches(a, b) == ["gaps"]


def test_smoke_stats_reference_matches_accumulate():
    from fastx_toolkit_tpu.ops import stats as S

    bases, lengths = chip_smoke.dp_inputs(512, seed=5)
    counts = np.random.default_rng(5).integers(1, 4000, 512).astype(np.int32)
    quals = np.zeros(bases.shape, np.int8)
    want = np.asarray(S.accumulate(bases, quals, lengths, counts, is_fastq=False)[0])
    np.testing.assert_array_equal(
        chip_smoke.stats_counts_reference(bases, lengths, counts), want)


def test_chip_smoke_refuses_cpu(tmp_path):
    """Past a card listing (a stand-in nvidia-smi), the script still
    refuses a CPU backend: non-zero exit and no result line."""
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'Stand-in card, 1.00 W'\n")
    fake.chmod(0o755)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PATH=str(tmp_path) + os.pathsep + os.environ.get("PATH", ""))
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "Stand-in card, 1.00 W" in r.stdout
    assert "not a GPU" in r.stderr
    assert '"ok"' not in r.stdout
