"""Debug/tracing subsystem (SURVEY section 5 sanitizer + profiler
analogues): wraparound assertions under THEORA_TPU_DEBUG and named-scope
stage labels in the device programs."""
import os

import numpy as np
import pytest


def test_i16_wrap_check_fires_on_overflow(monkeypatch):
    """With the debug flag armed, an int16 wrap that changes a value
    raises OverflowError; legal values pass untouched."""
    import theora_tpu.ops.transforms_jax as tj

    monkeypatch.setattr(tj, "_DBG", True)
    monkeypatch.setattr("theora_tpu.debug.DEBUG", True)
    import jax.numpy as jnp

    ok = tj._i16(jnp.asarray([100, -32768, 32767], jnp.int32))
    np.testing.assert_array_equal(
        np.asarray(ok), [100, -32768, 32767]
    )
    with pytest.raises(OverflowError, match="int16 overflow"):
        np.asarray(tj._i16(jnp.asarray([40000], jnp.int32)))


def test_i16_wrap_check_off_by_default():
    """Without the env flag the wrap stays silent wraparound (the spec
    semantics) and costs nothing."""
    if os.environ.get("THEORA_TPU_DEBUG", "") not in ("", "0"):
        pytest.skip("suite running with debug armed")
    import jax.numpy as jnp

    import theora_tpu.ops.transforms_jax as tj

    v = np.asarray(tj._i16(jnp.asarray([40000], jnp.int32)))
    assert v[0] == 40000 - 65536


def test_named_scopes_in_lowered_encode_scan():
    """The encode scan's HLO carries the per-stage scope labels, so
    profiler traces group by codec stage."""
    import jax
    import jax.numpy as jnp

    from theora_tpu.encode.tpu_gop import make_plane_scan

    nv = nh = 4
    n = nv * nh
    F = 2
    pad = 16
    scan = make_plane_scan(nv, nh, pad, pad)
    init = jnp.full((nv * 8 + 2 * pad, nh * 8 + 2 * pad), 0x80,
                    jnp.uint8)
    args = (
        init, init,
        jnp.zeros((F, n, 8, 8), jnp.uint8),
        jnp.zeros((F, n), jnp.int8),
        jnp.zeros((F, n), jnp.int8), jnp.zeros((F, n), jnp.int8),
        jnp.zeros((F, n), jnp.int8), jnp.zeros((F, n), jnp.int8),
        jnp.zeros((F, n), bool), jnp.zeros((F, n), bool),
        jnp.zeros((F,), bool),
        jnp.ones((F, 64), jnp.int32), jnp.ones((F, 64), jnp.int32),
        jnp.zeros((F, 256), jnp.int32),
        jnp.ones((F,), jnp.float32), jnp.ones((F,), jnp.float32),
        jnp.ones((F,), jnp.float32),
    )
    hlo = jax.jit(scan).lower(*args).as_text(debug_info=True)
    for stage in ("mc", "fdct", "quantize_rd", "idct_recon",
                  "skip_rd", "loopfilter", "borders"):
        assert stage in hlo, stage


def test_profile_tool_writes_trace(tmp_path):
    """tools/profile.py records a JAX profiler trace end-to-end (its
    record step, on the CPU: the command itself requires a GPU)."""
    import subprocess
    import sys

    out = tmp_path / "trace"
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; from theora_tpu.tools import profile; "
         "sys.exit(profile.record(profile.parse_args(sys.argv[1:])))",
         "--size", "64x48", "--frames", "2", "--out", str(out)],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    dumped = list(out.rglob("*"))
    assert any(p.is_file() for p in dumped), r.stderr
