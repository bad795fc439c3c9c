"""Device-facing configuration: compile-cache placement and the memory
probe that sizes the staging budget."""

import os
import subprocess
import sys

import pytest

import bella_tpu
from bella_tpu.config import CPU_MEMORY_MB, BellaConfig, device_memory_mb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c",
         "import bella_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=300, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_cache_dir_env_is_honoured(tmp_path):
    assert _cache_dir(str(tmp_path / "cc")) == str(tmp_path / "cc")


def test_cache_dir_default_is_fixed_inside_checkout():
    got = _cache_dir(None)
    assert got == os.path.join(ROOT, ".jax_cache") == bella_tpu.CACHE_DIR
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_memory_probe_reads_bytes_limit(platform):
    dev = _FakeDevice(platform, {"bytes_limit": 60_000_000_000})
    assert device_memory_mb(dev) == 60_000.0


def test_memory_probe_cpu_default():
    assert device_memory_mb(_FakeDevice("cpu", None)) == CPU_MEMORY_MB


def test_memory_probe_refuses_unknown_size():
    with pytest.raises(RuntimeError, match="bytes_limit"):
        device_memory_mb(_FakeDevice("gpu", {"bytes_in_use": 1}))


def test_memory_flag_overrides_probe():
    assert BellaConfig(total_memory_mb=1234).effective_memory_mb == 1234
