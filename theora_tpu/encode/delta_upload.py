"""Lossless sparse temporal-delta pixel upload (encode side).

Where the host->device link bounds the end-to-end encode, a dense raw
YUV upload is its ceiling.  This module
multiplies the effective upload bandwidth on temporally redundant
content while keeping the uploaded pixel stacks BYTE-IDENTICAL to a
dense device_put (so every packet the encoder emits is unchanged):

- The host computes, per plane, the mod-256 frame-vs-previous deltas of
  a GOP stack (frame 0 differenced against the previous GOP's last
  uploaded frame, carried both host- and device-side between calls).
- Changed 8x8 blocks are flat-compacted into two 1-D arrays (int32
  block positions, uint8 delta bytes; 1-D so no device layout pads a narrow
  minor dim into the transfer) padded to a quarter-octave capacity bucket, and expanded on
  device by one scatter plus a cumulative mod-256 sum across frames.
- When the changed-block fraction makes sparse no cheaper than dense
  (noise-like content), the stack falls back to the dense upload --
  still feeding the carry, so the next GOP can delta against it.

This is the encode-side twin of the decode path's sparse coefficient
upload (decode/tpu_batch.py).  The reference has no analogue: it is a
single-process library with no device link (SURVEY.md section 2.7).
"""
from __future__ import annotations

import functools

import numpy as np

from theora_tpu.encode.tpu_gop import _cap_bucket


@functools.lru_cache(None)
def _expand_fn(F, nbv, nbh):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def expand(pos, vals, last):
        """pos [cap] i32 (changed-block index in the [F*nbv*nbh] grid,
        pads = nblk), vals [cap*64] u8 (row-major 8x8 delta bytes),
        last [h, w] u8 (previous uploaded frame): returns the exact
        [F, h, w] u8 pixel stack."""
        nblk = F * nbv * nbh
        dense = (
            jnp.zeros((nblk + 1, 64), jnp.uint8)
            .at[pos].set(vals.reshape(-1, 64), mode="drop")[:nblk]
        )
        delta = (
            dense.reshape(F, nbv, nbh, 8, 8)
            .transpose(0, 1, 3, 2, 4)
            .reshape(F, nbv * 8, nbh * 8)
        )
        csum = jnp.cumsum(delta.astype(jnp.int32), axis=0)
        return ((last.astype(jnp.int32)[None] + csum) & 0xFF).astype(
            jnp.uint8
        )

    return expand


@functools.lru_cache(None)
def _expand_nibble_fn():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def expand(packed, last):
        """packed [F, h, w//2] u8 (two 4-bit mod-16 delta residues per
        byte, even column in the low nibble), last [h, w] u8: returns
        the exact [F, h, w] u8 stack for deltas whose signed residue
        lies in [-8, 7] (d = s mod 256 and s mod 16 = nibble, so
        s = ((nibble + 8) & 15) - 8 recovers it exactly)."""
        lo = packed & 0xF
        hi = (packed >> 4) & 0xF
        n = jnp.stack([lo, hi], axis=-1).reshape(
            packed.shape[0], packed.shape[1], packed.shape[2] * 2
        )
        s = (((n.astype(jnp.int32) + 8) & 0xF) - 8)
        csum = jnp.cumsum(s, axis=0)
        return ((last.astype(jnp.int32)[None] + csum) & 0xFF).astype(
            jnp.uint8
        )

    return expand


class DeltaUploader:
    """Per-plane sparse-delta upload with host/device frame carry.

    upload() is lossless and order-sensitive: each key's calls must
    arrive in clip order (they do -- the GOP queues in encode_clip /
    transcode are FIFO per plane).  A shape change or reset() drops the
    carry and the next upload goes dense."""

    def __init__(self):
        self._carry = {}
        self.stats = {"sparse": 0, "dense": 0, "bytes_sparse": 0,
                      "bytes_dense": 0, "bytes_raw": 0}

    def reset(self):
        self._carry.clear()

    def upload(self, key, stack_np):
        """stack_np [F, h, w] uint8 (h, w multiples of 8) -> device
        uint8 [F, h, w], byte-identical to jax.device_put(stack_np)."""
        import jax

        F, h, w = stack_np.shape
        self.stats["bytes_raw"] += stack_np.nbytes
        carry = self._carry.get(key)

        def dense():
            dev = jax.device_put(stack_np)
            self._carry[key] = (stack_np[-1].copy(), dev[-1])
            self.stats["dense"] += 1
            self.stats["bytes_dense"] += stack_np.nbytes
            return dev

        if carry is None or carry[0].shape != (h, w):
            return dense()
        host_last, dev_last = carry
        refs = np.concatenate([host_last[None], stack_np[:-1]], axis=0)
        delta = (
            stack_np.astype(np.int16) - refs.astype(np.int16)
        ).astype(np.uint8)
        nbv, nbh = h // 8, w // 8
        blocks = delta.reshape(F, nbv, 8, nbh, 8)
        changed = blocks.any(axis=(2, 4))  # [F, nbv, nbh]
        K = int(changed.sum())
        # 68 bytes/block on the wire (64 values + 4 position) vs 64
        # dense; the flat threshold keeps borderline content dense.
        sparse_cost = K * 68
        if sparse_cost >= stack_np.nbytes // 2 and w % 2 == 0:
            # Dense but small-amplitude delta (slow dissolves, drifting
            # chroma gradients): two 4-bit mod-16 residues per byte if
            # every signed residue fits [-8, 7].
            signed_small = (((delta.astype(np.int32) + 8) & 0xFF) < 16)
            if signed_small.all():
                self.stats["nibble"] = self.stats.get("nibble", 0) + 1
                self.stats["bytes_nibble"] = (
                    self.stats.get("bytes_nibble", 0) + stack_np.nbytes // 2
                )
                d = delta.reshape(F, h, w // 2, 2)
                packed = ((d[..., 0] & 0xF) | ((d[..., 1] & 0xF) << 4))
                dev = _expand_nibble_fn()(
                    jax.device_put(np.ascontiguousarray(packed)), dev_last
                )
                self._carry[key] = (stack_np[-1].copy(), dev[-1])
                return dev
        if sparse_cost >= stack_np.nbytes * 7 // 8:
            return dense()
        cap = _cap_bucket(max(K, 4))
        nblk = F * nbv * nbh
        pos = np.flatnonzero(changed.reshape(-1)).astype(np.int32)
        vals = (
            blocks.transpose(0, 1, 3, 2, 4).reshape(nblk, 64)[pos]
        )
        pos_pad = np.full(cap, nblk, np.int32)
        pos_pad[:K] = pos
        val_pad = np.zeros(cap * 64, np.uint8)
        val_pad[: K * 64] = vals.reshape(-1)
        dev = _expand_fn(F, nbv, nbh)(
            jax.device_put(pos_pad), jax.device_put(val_pad), dev_last
        )
        self._carry[key] = (stack_np[-1].copy(), dev[-1])
        self.stats["sparse"] += 1
        self.stats["bytes_sparse"] += pos_pad.nbytes + val_pad.nbytes
        return dev
