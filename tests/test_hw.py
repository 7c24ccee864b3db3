"""The platform module (tpujoin.utils.hw) and the entry points' refusal to
measure without a GPU."""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from tpujoin.utils import hw

REPO = Path(__file__).resolve().parent.parent


def test_hbm_peak_h100():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    assert hw.hbm_peak_gbps(dev) == 3350.0


def test_hbm_peak_unknown_gpu_raises():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA Imaginary 1GB")
    with pytest.raises(ValueError, match="Imaginary"):
        hw.hbm_peak_gbps(dev)


def test_cpu_has_no_roofline_peak():
    assert hw.hbm_peak_gbps() is None
    with pytest.raises(SystemExit):
        hw.require_gpu("test")


def _run(args, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


_CACHE_PROBE = ("import jax; from tpujoin.utils.hw import "
                "enable_compile_cache as e; p = e(); "
                "print(p); print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_follows_env(tmp_path):
    out = _run(["-c", _CACHE_PROBE],
               {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_compile_cache_defaults_to_repo_dir():
    out = _run(["-c", _CACHE_PROBE], drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    path = str(REPO / ".jax_cache")
    assert out.stdout.split() == [path, path]


@pytest.mark.parametrize("argv", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four-cards"],
                                  ["bench.py"],
                                  ["bench.py", "--op", "filter"],
                                  ["bench/dist_bench.py"]])
def test_entry_points_refuse_cpu(argv):
    out = _run(argv)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU found" in out.stderr
