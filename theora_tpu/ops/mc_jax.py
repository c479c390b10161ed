"""Motion compensation primitives without per-fragment gathers.

Per-fragment dynamic indexing (`plane[ay+mvy, ax+mvx]`) lowers to element
gathers. These helpers reformulate the hot patterns as layout ops plus
masked shifts over a small static window instead:

- `block_neighborhoods`: the UMV-padded plane reorganized into one
  per-fragment neighborhood tensor [n, wy, wx] via static block-grid
  shifts (pure slices/reshapes). Window size covers the codec's MV
  range: +/-16 full-pel on full-resolution axes (mv in [-31,31] half-pel,
  state.c:901-928), halved per chroma decimation -- exactly the UMV
  padding, so the static shifts never leave the padded plane.
- `mc_select2`: two per-fragment 8x8 extractions at dynamic (dy, dx)
  offsets, as separable masked shifts over the neighborhood (one select
  per row offset, then one per column offset). Integer throughout, so
  exact.
- `blocks_to_plane`: the inverse of the block-grid view -- a reshape +
  pad instead of a scatter (the write positions are a regular grid).

Bit-exact with the gather formulation (asserted in tests/test_jax_ops).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def window_shifts(pad: int) -> int:
    """Number of 8-px block shifts needed to cover the MV offset range
    on an axis with this UMV padding (16 -> +/-16 -> 5; 8 -> +/-8 -> 3)."""
    return 5 if pad >= 16 else 3


def block_neighborhoods(plane, nv, nh, pad_y, pad_x):
    """[Hp, Wp] padded plane -> [nv*nh, wy, wx] neighborhood tensor,
    where entry (b, base_y+dy, base_x+dx) is the pixel at offset
    (dy, dx) from fragment b's top-left corner. Static slices only."""
    n_sy = window_shifts(pad_y)
    n_sx = window_shifts(pad_x)
    Hp, Wp = plane.shape
    wy, wx = 8 * n_sy, 8 * n_sx
    oy = pad_y - 8 * (n_sy // 2)
    ox = pad_x - 8 * (n_sx // 2)
    # Band-major construction: overlapping windows at stride 8 are
    # contiguous reshapes concatenated on a trailing axis (rows, then
    # columns), then ONE transpose -- the n_sy*n_sx grid of strided
    # slice+transpose+concat ops it replaces was ~3x slower (round-5
    # roofline; same fix as me_jax._mb_neighborhoods).
    bands = jnp.concatenate(
        [
            plane[oy + 8 * k : oy + 8 * k + 8 * nv, :].reshape(nv, 8, Wp)
            for k in range(n_sy)
        ],
        axis=1,
    )  # [nv, wy, Wp]
    cols = jnp.concatenate(
        [
            bands[:, :, ox + 8 * k : ox + 8 * k + 8 * nh].reshape(
                nv, wy, nh, 8
            )
            for k in range(n_sx)
        ],
        axis=3,
    )  # [nv, wy, nh, wx]
    return cols.transpose(0, 2, 1, 3).reshape(nv * nh, wy, wx)


def mc_select2(nb, yo1, xo1, yo2, xo2, pad_y, pad_x):
    """Extract TWO 8x8 blocks per fragment from the neighborhood tensor
    at offsets (yo1, xo1) and (yo2, xo2) (full-pel ints in
    [-base, base]), via masked shifts (separable: 2*shifts elementwise passes
    instead of shifts^2; no gathers, no batched-tiny matmuls).
    Returns ([n,8,8], [n,8,8]) int32."""
    n_sy = window_shifts(pad_y)
    n_sx = window_shifts(pad_x)
    base_y = 8 * (n_sy // 2)
    base_x = 8 * (n_sx // 2)
    n, wy, wx = nb.shape
    y1 = yo1.astype(jnp.int32)
    y2 = yo2.astype(jnp.int32)
    x1 = xo1.astype(jnp.int32)
    x2 = xo2.astype(jnp.int32)
    a1 = jnp.zeros((n, 8, wx), jnp.int32)
    a2 = jnp.zeros((n, 8, wx), jnp.int32)
    for dy in range(-base_y, base_y + 1):
        sl = nb[:, base_y + dy:base_y + dy + 8, :].astype(jnp.int32)
        a1 = a1 + jnp.where((y1 == dy)[:, None, None], sl, 0)
        a2 = a2 + jnp.where((y2 == dy)[:, None, None], sl, 0)
    s1 = jnp.zeros((n, 8, 8), jnp.int32)
    s2 = jnp.zeros((n, 8, 8), jnp.int32)
    for dx in range(-base_x, base_x + 1):
        s1 = s1 + jnp.where(
            (x1 == dx)[:, None, None],
            a1[:, :, base_x + dx:base_x + dx + 8], 0,
        )
        s2 = s2 + jnp.where(
            (x2 == dx)[:, None, None],
            a2[:, :, base_x + dx:base_x + dx + 8], 0,
        )
    return s1, s2


def blocks_to_plane(blocks, nv, nh, pad_y, pad_x):
    """[nv*nh, 8, 8] block grid -> [Hp, Wp] plane with zeroed padding
    (reshape + pad; replaces the scatter `.at[ay, ax].set(blocks)`)."""
    interior = (
        blocks.reshape(nv, nh, 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(nv * 8, nh * 8)
    )
    return jnp.pad(interior, ((pad_y, pad_y), (pad_x, pad_x)))


def plane_to_blocks(plane, nv, nh, pad_y, pad_x):
    """[Hp, Wp] padded plane -> [nv*nh, 8, 8] interior block grid."""
    interior = jax.lax.dynamic_slice(
        plane, (pad_y, pad_x), (nv * 8, nh * 8)
    )
    return (
        interior.reshape(nv, 8, nh, 8)
        .transpose(0, 2, 1, 3)
        .reshape(nv * nh, 8, 8)
    )
