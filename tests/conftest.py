import os
import sys

# Hermetic CPU-only JAX for tests: an 8-device virtual mesh exercises the
# multi-device sharding paths without accelerators (SURVEY.md section 4).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

TESTDATA = os.path.join(REPO_ROOT, "testdata")


def _ref_tools_fixture():
    import pytest

    if not ensure_ref_oracle():
        pytest.skip("reference oracle unavailable")
    return (
        os.path.join(REPO_ROOT, "refbuild", "build", "ref_enc"),
        os.path.join(REPO_ROOT, "refbuild", "build", "ref_dec"),
    )


try:
    import pytest as _pytest

    ref_tools = _pytest.fixture(name="ref_tools")(_ref_tools_fixture)
except ImportError:
    pass


def ensure_ref_oracle() -> bool:
    """Build the reference oracle binaries if missing; True when usable."""
    import subprocess

    dec = os.path.join(REPO_ROOT, "refbuild", "build", "ref_dec")
    enc = os.path.join(REPO_ROOT, "refbuild", "build", "ref_enc")
    if os.path.exists(dec) and os.path.exists(enc):
        return True
    try:
        subprocess.run(
            ["make", "-C", os.path.join(REPO_ROOT, "refbuild")],
            check=True, capture_output=True, timeout=300,
        )
    except Exception:
        return False
    return os.path.exists(dec) and os.path.exists(enc)
