"""Debug + tracing utilities -- the device-tier analogues of the reference's
auxiliary subsystems (SURVEY.md section 5):

- the reference ships sanitizer/valgrind CI builds (configure.ac
  --enable-gcc-sanitizers); here `THEORA_TPU_DEBUG=1` arms wraparound
  assertions inside the integer transform kernels.  The codec's int16
  stores are implemented as explicit wraparound (`_i16`) -- on any legal
  stream the values are in range and the wrap is the identity, so a wrap
  that actually changes a value means out-of-spec data or a kernel bug.
  In debug mode each wrap site reports through `jax.debug.callback`,
  which works under jit on any backend.
- the reference has no profiler hooks (telemetry overlays only); here
  the hot device stages carry `jax.named_scope` labels (mc / fdct /
  quantize_rd / idct / loopfilter / borders / me) so JAX profiler traces
  and HLO dumps group by codec stage, and `trace(logdir)` wraps
  `jax.profiler.trace` for TensorBoard/Perfetto viewing
  (tools/profile.py drives it).
"""
from __future__ import annotations

import os

DEBUG = os.environ.get("THEORA_TPU_DEBUG", "") not in ("", "0")


def named_scope(name: str):
    """jax.named_scope, importable without paying the jax import at
    module load of callers that may run numpy-only."""
    import jax

    return jax.named_scope(name)


def check_wrap(wrapped, original, where: str):
    """Debug-mode assertion that an int16 wraparound was the identity.

    Returns `wrapped` unchanged; when THEORA_TPU_DEBUG=1 a host callback
    raises OverflowError if any lane actually wrapped.  Zero cost when
    the flag is off (the call is pruned before tracing).
    """
    if not DEBUG:
        return wrapped
    import jax

    def _chk(w, o, _where=where):
        import numpy as _np

        bad = _np.asarray(w) != _np.asarray(o)
        if bad.any():
            idx = tuple(int(i[0]) for i in _np.nonzero(bad))
            raise OverflowError(
                f"{_where}: int16 overflow at {idx}: "
                f"{_np.asarray(o)[idx]} wrapped to {_np.asarray(w)[idx]} "
                "(out-of-spec input or kernel bug)"
            )

    jax.debug.callback(_chk, wrapped, original)
    return wrapped


def trace(logdir: str):
    """Context manager: record a JAX profiler trace under `logdir`
    (view with TensorBoard's profile plugin or Perfetto)."""
    import jax

    return jax.profiler.trace(logdir)
