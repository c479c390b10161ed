"""Jitted frame-level compute cores.

These are the device entry points: whole-frame batched tensor programs that XLA
compiles once per frame geometry. Host code (entropy coding, DC prediction)
runs around them; see SURVEY.md section 7 for the split rationale.

  - encode_core: pixels -> zig-zag quantized coefficients + reconstruction
    residuals for a batch of independent frames (keyframe path) or one frame
    (inter path, given per-fragment predictions).
  - recon_core: quantized coefficients -> reconstructed plane (decode path).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from theora_tpu.ops import transforms_jax as tj


def _gather_blocks(plane, by, bx):
    """Gather 8x8 blocks at (by, bx) top-left coords: [N, 8, 8]."""
    ay = by[:, None, None] + jnp.arange(8)[None, :, None]
    ax = bx[:, None, None] + jnp.arange(8)[None, None, :]
    return plane[ay, ax]


def _scatter_blocks(plane, by, bx, blocks):
    ay = by[:, None, None] + jnp.arange(8)[None, :, None]
    ax = bx[:, None, None] + jnp.arange(8)[None, None, :]
    return plane.at[ay, ax].set(blocks)


@jax.jit
def intra_encode_core(plane_blocks, dequant_zz):
    """Keyframe encode compute for one plane's fragments.

    plane_blocks: [..., N, 8, 8] uint8 source blocks (any leading batch dims)
    dequant_zz: [64] int32 intra dequant factors.
    Returns (qdct [..., N, 64] int32 zig-zag quantized coefficients,
             recon [..., N, 8, 8] uint8 reconstruction assuming full coding).

    The reconstruction reproduces the decoder exactly: blocks whose only
    nonzero coefficient is DC take the (dc*q+15)>>5 fill path
    (state.c:967-975).
    """
    res = plane_blocks.astype(jnp.int32) - 128
    dct = tj.fdct8x8(res)
    qdct = tj.quantize(dct, dequant_zz)
    dc_only = (qdct[..., 1:] == 0).all(axis=-1)
    residual = tj.dequantize_idct(
        qdct.reshape(-1, 64),
        jnp.broadcast_to(dequant_zz, (qdct.reshape(-1, 64).shape[0], 64)),
        qdct.reshape(-1, 64)[:, 0],
        jnp.broadcast_to(dequant_zz[0], (qdct.reshape(-1, 64).shape[0],)),
        dc_only.reshape(-1),
    ).reshape(plane_blocks.shape)
    recon = tj.recon_intra(residual)
    return qdct, recon


@jax.jit
def inter_encode_core(cur_blocks, pred_blocks, is_intra, dequant_intra,
                      dequant_inter):
    """Inter-frame encode compute for one plane.

    cur_blocks/pred_blocks: [N, 8, 8]; is_intra: [N] bool;
    dequant_*: [64] int32.
    Returns qdct [N, 64] int32.
    """
    pred = jnp.where(is_intra[:, None, None], 128, pred_blocks.astype(jnp.int32))
    res = cur_blocks.astype(jnp.int32) - pred
    dct = tj.fdct8x8(res)
    deq = jnp.where(is_intra[:, None], dequant_intra, dequant_inter)
    return tj.quantize(dct, deq)


@jax.jit
def recon_core(
    self_plane,
    prev_plane,
    gold_plane,
    by,
    bx,
    coeffs_zz,
    dequant_zz,
    dc,
    dc_quant,
    dc_only,
    refsel,
    o1y,
    o1x,
    o2y,
    o2x,
    use2,
):
    """Decode-side reconstruction of one plane's coded fragments.

    self_plane is pre-initialized with the PREV frame contents (covers
    uncoded-fragment copy); coded blocks are overwritten.
    refsel: [N] 0=intra, 1=prev, 2=gold.
    """
    residual = tj.dequantize_idct(coeffs_zz, dequant_zz, dc, dc_quant, dc_only)
    p1 = _gather_blocks(prev_plane, by + o1y, bx + o1x).astype(jnp.int32)
    p2 = _gather_blocks(prev_plane, by + o2y, bx + o2x).astype(jnp.int32)
    g1 = _gather_blocks(gold_plane, by + o1y, bx + o1x).astype(jnp.int32)
    g2 = _gather_blocks(gold_plane, by + o2y, bx + o2x).astype(jnp.int32)
    pred_prev = jnp.where(use2[:, None, None], (p1 + p2) >> 1, p1)
    pred_gold = jnp.where(use2[:, None, None], (g1 + g2) >> 1, g1)
    pred = jnp.where(
        (refsel == 0)[:, None, None],
        128,
        jnp.where((refsel == 1)[:, None, None], pred_prev, pred_gold),
    )
    blocks = jnp.clip(residual + pred, 0, 255).astype(jnp.uint8)
    return _scatter_blocks(self_plane, by, bx, blocks)


@functools.partial(jax.jit, static_argnames=("h", "w", "vpad", "hpad"))
def fill_borders(plane, h, w, vpad, hpad):
    """UMV border replication (state.c:770-835) for a padded plane."""
    # left/right
    plane = plane.at[vpad : vpad + h, :hpad].set(
        jnp.broadcast_to(plane[vpad : vpad + h, hpad : hpad + 1], (h, hpad))
    )
    plane = plane.at[vpad : vpad + h, hpad + w :].set(
        jnp.broadcast_to(
            plane[vpad : vpad + h, hpad + w - 1 : hpad + w], (h, hpad)
        )
    )
    # top/bottom caps
    plane = plane.at[:vpad, :].set(
        jnp.broadcast_to(plane[vpad : vpad + 1, :], (vpad, plane.shape[1]))
    )
    plane = plane.at[vpad + h :, :].set(
        jnp.broadcast_to(
            plane[vpad + h - 1 : vpad + h, :], (vpad, plane.shape[1])
        )
    )
    return plane
