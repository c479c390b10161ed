"""Backend setup for entry points that drive the GPU: the device check
and the persistent compile cache, in one place.

Library code and tests never call these; `chip_smoke.py`, `bench.py`
and the device tools do, before their first JAX computation.
"""
from __future__ import annotations

import os
import subprocess

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def require_gpu():
    """The JAX devices; raises RuntimeError unless JAX runs on a GPU.

    There is no CPU fallback: a run that measures or checks the device
    path must fail where there is no device."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devices[0].platform} "
            f"({devices[0].device_kind})"
        )
    return devices


def cards() -> list[str]:
    """`name, power limit` of each GPU, as nvidia-smi reports them.  A
    card may be set below its maximum power limit, and then runs slower
    under load, so numbers measured on it are printed beside its line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory:
    `$JAX_COMPILATION_CACHE_DIR` when set (JAX reads the variable itself,
    so nothing is set here), else `<checkout>/.jax_cache`.  The default
    is a fixed path: it is part of the cache's key, so a directory that
    moved between runs would never hit."""
    path = os.environ.get(CACHE_ENV)
    if path:
        return path
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
