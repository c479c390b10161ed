"""JAX port of the exact-order vectorized loop filter.

Same within-row phase decomposition as ops/loopfilter_vec.py (see its
docstring for the derivation), extended to a fully BATCHED cross-row
formulation: instead of a lax.scan over fragment rows (~60 tiny ops
per iteration, run once per fragment row), the whole plane is filtered
in three globally vectorized phases:

  P1  all rows' interior horizontal filters (rows y0+1..y0+6)
  B   all rows' bottom-edge chains (writes rows y0+7, y0+8)
  A   all rows' top-edge chains (writes rows y0-1, y0)

This ordering reproduces the scalar VP3 raster order exactly because:
- P1 rows are disjoint across fragment rows and within-row independent;
- chain B of row r reads only pre-P1 snapshots (rows y0+8, y0+9 -- the
  next row's top rows, untouched until its own chain A) and the
  post-P1 row y0+6; B rows are disjoint writers (y0+7, y0+8);
- chain A of row r reads rows y0-2 (post-P1 of r-1), y0-1 and y0
  (post-B of r-1 -- phase B completes first), plus pre-P1 snapshots of
  rows y0, y0+1; A rows are disjoint writers (y0-1, y0);
- a bottom edge (vE: coded above, uncoded below) and the same boundary's
  top edge (vL: coded below) fire on mutually exclusive columns, so the
  B-then-A write order preserves the scalar result; the h-filter write
  priorities at block corners are the same masked variants the within-
  row decomposition already encodes.

Device mapping notes: all column addressing is in blocked [.., W/8, 8]
coordinates so every access is a static slice and every update lowers
to dynamic-update-slice, instead of the gathers and scatters of the
original `ecols`-indexed formulation.
The bounding-value table is evaluated in closed form
(sign(R)*max(0, min(|R|, 2*limit-|R|)), identical by construction to
build_bounding_values -- state.c:1036-1045) for the same reason.

Bit-exact with the scalar VP3 edge ordering (state.c:1055-1105);
validated against the numpy implementation by fuzzing.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _resp(f, limit):
    r = (f + 4) >> 3
    a = jnp.abs(r)
    return jnp.sign(r) * jnp.maximum(0, jnp.minimum(a, 2 * limit - a))


def _f4(p0, p1, p2, p3):
    return (
        p0.astype(jnp.int32)
        - p3.astype(jnp.int32)
        + 3 * (p2.astype(jnp.int32) - p1.astype(jnp.int32))
    )


def _clamp(x):
    return jnp.clip(x, 0, 255)


def _shift_right(v):
    """Shift [nv, nh] by one block column with zero fill."""
    return jnp.pad(v[:, :-1], ((0, 0), (1, 0)))


@functools.partial(jax.jit, static_argnames=("nv", "nh", "pad_y", "pad_x"))
def loop_filter_plane_jax(plane, coded, bv, nv, nh, pad_y, pad_x):
    """plane: [Hp, Wp] uint8; coded: [nv, nh] bool; bv: [256] int32.
    Returns the filtered plane."""
    W = plane.shape[1]
    Wb = W // 8
    pb = pad_x // 8
    lo = pb - 1
    # The table's peak IS the filter limit (bv[127+L] = L).
    limit = jnp.max(bv)

    I = plane.astype(jnp.int32)
    # Blocked interior: R[r, k, c, j] = plane pixel
    # (pad_y + 8r + k, 8c + j).
    R = I[pad_y:pad_y + 8 * nv].reshape(nv, 8, Wb, 8)
    orig = R                                        # pre-filter snapshot
    top2 = I[pad_y - 2].reshape(Wb, 8)              # y0-2 of row 0
    top1 = I[pad_y - 1].reshape(Wb, 8)              # y0-1 of row 0
    bot0 = I[pad_y + 8 * nv].reshape(Wb, 8)         # y0+8 of last row
    bot1 = I[pad_y + 8 * nv + 1].reshape(Wb, 8)     # y0+9 of last row

    def m0(V, k):
        """Block columns c=0..nh-1, intra column k (V [..., Wb, 8])."""
        return V[..., pb:pb + nh, k]

    def mm1(V, k):
        """Block columns c-1, intra column k."""
        return V[..., lo:lo + nh, k]

    def setk(V, lo_, k, new):
        """V[..., lo_:lo_+nh, k] = new, slices only."""
        blk = V[..., lo_:lo_ + nh, :]
        blk = jnp.where(np.arange(8) == k, new[..., None], blk)
        return V.at[..., lo_:lo_ + nh, :].set(blk)

    c = coded
    zcol = jnp.zeros((nv, 1), bool)
    hfire = jnp.concatenate([zcol, c[:, 1:] | c[:, :-1]], axis=1)
    left_fired = jnp.concatenate([zcol, c[:, 1:]], axis=1)
    below = jnp.concatenate([c[1:], jnp.zeros((1, nh), bool)])
    first_row = jnp.arange(nv)[:, None] == 0
    last_row = jnp.arange(nv)[:, None] == nv - 1
    vL = c & ~first_row
    vE = c & ~below & ~last_row
    nxt_coded = jnp.concatenate(
        [c[:, 1:], jnp.zeros((nv, 1), bool)], axis=1
    )

    # ---- Phase P1: h filters, rows y0+1..y0+6, all fragment rows -----
    R16 = R[:, 1:7]                                 # [nv, 6, Wb, 8]
    p0 = mm1(R16, 6)
    p1 = mm1(R16, 7)
    p2 = m0(R16, 0)
    p3 = m0(R16, 1)
    rsp = _resp(_f4(p0, p1, p2, p3), limit)
    m = hfire[:, None, :]
    R16 = setk(R16, lo, 7, jnp.where(m, _clamp(p1 + rsp), p1))
    R16 = setk(R16, pb, 0, jnp.where(m, _clamp(p2 - rsp), p2))
    R = R.at[:, 1:7].set(R16)

    # ---- Phase B: bottom-edge chains, all rows ------------------------
    S6 = orig[:, 6]                                 # [nv, Wb, 8] pre-P1
    S7 = orig[:, 7]
    band8 = R[:, 6]                                 # post-P1 row y0+6
    # Rows y0+8, y0+9 = next row's rows 0, 1, PRE-P1 (scalar order runs
    # B(r) before any of row r+1's processing).
    band10 = jnp.concatenate([orig[1:, 0], bot0[None]])
    band11 = jnp.concatenate([orig[1:, 1], bot1[None]])
    fS = _f4(mm1(S7, 6), mm1(S7, 7), m0(S7, 0), m0(S7, 1))
    rS = _resp(fS, limit)
    h7S_m1 = _clamp(mm1(S7, 7) + rS)
    h7S_0 = _clamp(m0(S7, 0) - rS)
    fe6 = _f4(m0(S6, 6), m0(S7, 6), m0(band10, 6), m0(band11, 6))
    ve6_row7 = _clamp(m0(S7, 6) + _resp(fe6, limit))
    in6 = jnp.where(nxt_coded, m0(S6, 7), m0(band8, 7))
    in7 = jnp.where(
        nxt_coded,
        m0(S7, 7),
        jnp.concatenate([h7S_m1[:, 1:], m0(S7, 7)[:, -1:]], axis=1),
    )
    fe7 = _f4(in6, in7, m0(band10, 7), m0(band11, 7))
    ve7_row7 = _clamp(in7 + _resp(fe7, limit))
    prev_vE = jnp.concatenate([zcol, vE[:, :-1]], axis=1)
    use_post = prev_vE & left_fired
    in_m2b = jnp.where(use_post, _shift_right(ve6_row7), mm1(S7, 6))
    in_m1b = jnp.where(use_post, _shift_right(ve7_row7), mm1(S7, 7))
    fP = _f4(in_m2b, in_m1b, m0(S7, 0), m0(S7, 1))
    rP = _resp(fP, limit)
    h7P_m1 = _clamp(in_m1b + rP)
    h7P_0 = _clamp(m0(S7, 0) - rP)
    h7_m1 = jnp.where(left_fired, h7P_m1, h7S_m1)
    h7_0 = jnp.where(left_fired, h7P_0, h7S_0)
    _c8 = np.arange(8)
    r_6 = S6[:, pb:pb + nh, :]                      # [nv, nh, 8]
    r_7 = S7[:, pb:pb + nh, :]
    r_8 = band10[:, pb:pb + nh, :]
    r_9 = band11[:, pb:pb + nh, :]
    r_6 = jnp.where(_c8 == 0, m0(band8, 0)[..., None], r_6)  # post-P1
    r_7 = jnp.where(
        _c8 == 0,
        jnp.where(hfire, h7_0, r_7[:, :, 0])[..., None], r_7,
    )
    r_6 = jnp.where(
        _c8 == 7,
        jnp.where(~nxt_coded, m0(band8, 7), m0(S6, 7))[..., None], r_6,
    )
    h_next_m1 = jnp.concatenate(
        [h7_m1[:, 1:], m0(S7, 7)[:, -1:]], axis=1
    )
    hfire_next = jnp.concatenate(
        [hfire[:, 1:], jnp.zeros((nv, 1), bool)], axis=1
    )
    r_7 = jnp.where(
        _c8 == 7,
        jnp.where(~nxt_coded & hfire_next, h_next_m1, r_7[:, :, 7])[
            ..., None
        ],
        r_7,
    )
    re = _resp(_f4(r_6, r_7, r_8, r_9), limit)
    out_7 = _clamp(r_7 + re)
    out_8 = _clamp(r_8 - re)
    mve = vE[:, :, None]
    # Row y0+7 writes (vE full application, then corner h writes).
    row7 = R[:, 7]
    row7 = row7.at[:, pb:pb + nh, :].set(
        jnp.where(mve, out_7, row7[:, pb:pb + nh, :])
    )
    keep_m1 = hfire & ~(prev_vE & ~left_fired)
    row7 = setk(row7, lo, 7,
                jnp.where(keep_m1, h7_m1, mm1(row7, 7)))
    row7 = setk(row7, pb, 0,
                jnp.where(hfire & ~vE, h7_0, m0(row7, 0)))
    R = R.at[:, 7].set(row7)
    # Row y0+8 = next row's row 0 (vE of the last row is masked off).
    row0_below = jnp.where(mve, out_8, band10[:, pb:pb + nh, :])
    R = R.at[1:, 0, pb:pb + nh, :].set(row0_below[:-1])

    # ---- Phase A: top-edge chains, all rows ---------------------------
    b0 = jnp.concatenate([top2[None], R[:-1, 6]])   # y0-2, post-P1
    b1 = jnp.concatenate([top1[None], R[:-1, 7]])   # y0-1, post-B
    S0 = R[:, 0]                                    # y0, post-B
    S1 = orig[:, 1]                                 # y0+1 pre-P1
    f6 = _f4(m0(b0, 6), m0(b1, 6), m0(S0, 6), m0(S1, 6))
    vb6_row0 = _clamp(m0(S0, 6) - _resp(f6, limit))
    f7 = _f4(m0(b0, 7), m0(b1, 7), m0(S0, 7), m0(S1, 7))
    vb7_row0 = _clamp(m0(S0, 7) - _resp(f7, limit))
    prev_vL = jnp.concatenate([zcol, vL[:, :-1]], axis=1)
    in_m2 = jnp.where(prev_vL, _shift_right(vb6_row0), mm1(S0, 6))
    in_m1 = jnp.where(prev_vL, _shift_right(vb7_row0), mm1(S0, 7))
    fh0 = _f4(in_m2, in_m1, m0(S0, 0), m0(S0, 1))
    rh0 = _resp(fh0, limit)
    h0_m1 = _clamp(in_m1 + rh0)
    h0_0 = _clamp(m0(S0, 0) - rh0)
    r_m2 = b0[:, pb:pb + nh, :]
    r_m1 = b1[:, pb:pb + nh, :]
    r_0 = S0[:, pb:pb + nh, :]
    r_1 = S1[:, pb:pb + nh, :]
    r_0 = jnp.where(
        _c8 == 0,
        jnp.where(hfire, h0_0, r_0[:, :, 0])[..., None], r_0,
    )
    r_1 = jnp.where(
        _c8 == 0, m0(R[:, 1], 0)[..., None], r_1    # post-P1 row y0+1
    )
    rv = _resp(_f4(r_m2, r_m1, r_0, r_1), limit)
    out_m1 = _clamp(r_m1 + rv)
    out_0 = _clamp(r_0 - rv)
    mvl = vL[:, :, None]
    # Row y0-1 = previous row's row 7 (vL of row 0 is masked off).
    rowm1 = jnp.where(mvl, out_m1, r_m1)
    R = R.at[:-1, 7, pb:pb + nh, :].set(rowm1[1:])
    # Row y0 (vL full application, then corner h writes).
    row0 = R[:, 0]
    row0 = row0.at[:, pb:pb + nh, :].set(
        jnp.where(mvl, out_0, row0[:, pb:pb + nh, :])
    )
    row0 = setk(row0, lo, 7, jnp.where(hfire, h0_m1, mm1(row0, 7)))
    row0 = setk(row0, pb, 0,
                jnp.where(hfire & ~vL, h0_0, m0(row0, 0)))
    R = R.at[:, 0].set(row0)

    I = I.at[pad_y:pad_y + 8 * nv].set(R.reshape(8 * nv, W))
    return I.astype(jnp.uint8)
