"""Backend setup (theora_tpu/runtime.py) and the device entry points'
refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

from tests.conftest import REPO_ROOT
from theora_tpu import runtime


def _run(args, cwd, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def _assert_refused(r):
    assert r.returncode != 0, r.stdout
    lines = r.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1], lines[-1]


@pytest.mark.parametrize("args", [
    ["chip_smoke.py"],
    ["chip_smoke.py", "--four-cards"],
    ["-m", "theora_tpu.tools.profile", "--size", "64x48", "--frames", "2"],
])
def test_device_entry_points_fail_without_gpu(args):
    """With JAX on the CPU, the smoke test and the device tools exit
    non-zero, and chip_smoke.py never prints its ok line."""
    _assert_refused(_run(args, REPO_ROOT))


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py copied into a directory that holds nothing else of
    the repo exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    _assert_refused(r)
    assert r.stdout.strip() == ""


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    assert runtime.setup_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_dir_default_is_checkout(monkeypatch):
    import jax

    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    want = os.path.join(REPO_ROOT, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.setup_compile_cache()
        assert os.path.realpath(got) == os.path.realpath(want)
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_roofline_peaks_by_device_kind():
    from theora_tpu.tools.roofline import device_peaks

    h100 = device_peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_bytes_per_s"] == 3.35e12
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(ValueError, match="no published peaks"):
            device_peaks(kind)
