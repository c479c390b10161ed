"""Device-batched intra (all-keyframe) encoder.

The device computes fDCT + round-to-nearest quantization for EVERY block
of EVERY frame of a batch in one jitted dispatch (bit-exact integer
semantics, ops/transforms_jax.py); the host then runs the sequential
bit-serial stages per frame (trellis planning, DC prediction, token
packing) through the normal Encoder — so the output is byte-identical to
a pure-host encode, and the batch amortizes device dispatch and transfer
across frames. This is the encode-side counterpart of TpuDecoder and the
usable API over pipeline.intra_encode_core.

All-keyframe batches are the natural device unit because frames become
fully independent (SURVEY §2.7); inter GOPs shard across hosts/processes
instead (parallel/).
"""
from __future__ import annotations

import functools

import numpy as np

from theora_tpu.encode.encoder import Encoder
from theora_tpu.info import TheoraInfo
from theora_tpu.tpkt import Packet


@functools.lru_cache(maxsize=8)
def _jit_fdct_quant():
    import jax
    import jax.numpy as jnp

    from theora_tpu.ops import transforms_jax as tj

    @jax.jit
    def fdct_quant(blocks, dq):
        # blocks: [B, N, 8, 8] uint8 source; dq: [64] int32.
        res = blocks.astype(jnp.int32) - 128
        dct = tj.fdct8x8(res)
        return dct.astype(jnp.int16), tj.quantize(dct, dq).astype(jnp.int16)

    return fdct_quant


def _to_blocks(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return (
        plane.reshape(h // 8, 8, w // 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 8, 8)
    )


class TpuBatchIntraEncoder:
    """Encode a batch of frames as keyframes with the transform/quantize
    stage on the default JAX device."""

    def __init__(self, info: TheoraInfo):
        self.info = info
        self.enc = Encoder(info)
        self.enc.keyframe_freq = 1

    def flush_headers(self) -> list[Packet]:
        return self.enc.flush_headers()

    def encode(self, frames: list) -> list[Packet]:
        """frames: list of [y, u, v] display-orientation planes.
        Returns one keyframe packet per frame, byte-identical to the host
        Encoder at keyframe_freq=1."""
        import jax.numpy as jnp

        if not frames:
            return []
        enc = self.enc
        qi = enc.qi
        fdct_quant = _jit_fdct_quant()
        # One device dispatch per plane kind, batched over frames.
        dev = {}
        for pli in range(3):
            blocks = np.stack(
                [_to_blocks(fr[pli][::-1]) for fr in frames]
            )
            dq = jnp.asarray(enc.dequant[qi, pli, 0].astype(np.int32))
            dct, qdct = fdct_quant(jnp.asarray(blocks), dq)
            dev[pli] = (np.asarray(dct), np.asarray(qdct))
        # Host bit-serial stages per frame, injecting the device results.
        pkts = []
        for fi, fr in enumerate(frames):
            enc._precomputed_tq = {
                pli: (dev[pli][0][fi], dev[pli][1][fi]) for pli in range(3)
            }
            try:
                pkts.append(enc.encode_frame(fr))
            finally:
                enc._precomputed_tq = None
        return pkts
