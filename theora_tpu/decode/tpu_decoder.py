"""Per-frame device decoder: reference planes stay resident on device; per
frame, host entropy produces dense per-fragment arrays and one jitted
program per plane performs dequant + iDCT + MC + reconstruction + loop
filter + border fill.

The formulation is dense: every fragment position computes a block --
uncoded fragments carry zero coefficients with a zero-MV PREV reference,
which makes "copy from the previous frame" fall out of the same MC path
(replacing the reference's uncoded-fragment copy lists, decode.c:1598-1606).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from theora_tpu.constants import FRAME_GOLD, FRAME_PREV, FRAME_SELF
from theora_tpu.decode.decoder import Decoder, _MVMAP, _MVMAP2
from theora_tpu.info import INTRA_FRAME
from theora_tpu.ops import mc_jax as mc
from theora_tpu.ops import transforms_jax as tj
from theora_tpu.ops.loopfilter_jax import loop_filter_plane_jax
from theora_tpu.pipeline import fill_borders


@functools.partial(
    jax.jit, static_argnames=("nv", "nh", "pad_y", "pad_x", "do_filter")
)
def decode_plane_device(
    prev_plane,
    gold_plane,
    qz,          # [nfrags, 64] int32 zig-zag quantized
    deq_rows,    # [nfrags, 64] int32
    dc,          # [nfrags] int32 (predicted)
    dc_quant,    # [nfrags] int32
    dc_only,     # [nfrags] bool
    refsel,      # [nfrags] int32: 0=intra, 1=prev, 2=gold
    o1y, o1x, o2y, o2x, use2,   # [nfrags] MC offsets
    coded,       # [nv, nh] bool (for the loop filter)
    bv,          # [256] int32
    nv, nh, pad_y, pad_x, do_filter,
):
    residual = tj.dequantize_idct(qz, deq_rows, dc, dc_quant, dc_only)
    # MC via masked shifts over block neighborhoods (ops/mc_jax.py), not
    # per-element gathers and scatters.
    nb_p = mc.block_neighborhoods(prev_plane, nv, nh, pad_y, pad_x)
    nb_g = mc.block_neighborhoods(gold_plane, nv, nh, pad_y, pad_x)
    nb = jnp.where((refsel == 2)[:, None, None], nb_g, nb_p)
    s1, s2 = mc.mc_select2(nb, o1y, o1x, o2y, o2x, pad_y, pad_x)
    sel = jnp.where(use2[:, None, None], (s1 + s2) >> 1, s1)
    pred = jnp.where((refsel == 0)[:, None, None], 128, sel)
    blocks = jnp.clip(residual + pred, 0, 255).astype(jnp.uint8)
    plane = mc.blocks_to_plane(blocks, nv, nh, pad_y, pad_x)
    if do_filter:
        plane = loop_filter_plane_jax(plane, coded, bv, nv, nh, pad_y, pad_x)
    h, w = nv * 8, nh * 8
    plane = fill_borders(plane, h, w, pad_y, pad_x)
    return plane


class TpuDecoder(Decoder):
    """Decoder whose pixel pipeline runs on the default JAX device with
    resident reference planes. Host side: entropy + side-info (C++ tier)."""

    def __init__(self, info, setup, use_native=True):
        super().__init__(info, setup, use_native=use_native)
        # Device-resident planes per buffer slot.
        self._dev = [
            [jnp.asarray(p) for p in buf.planes] for buf in self.buffers
        ]
        from theora_tpu.ops.loopfilter_np import build_bounding_values

        self._bv_cache = {
            fl: jnp.asarray(build_bounding_values(fl).astype(np.int32))
            for fl in set(self.setup.qinfo["loop_filter_limits"])
        }

    # The numpy stages are replaced wholesale.
    def decode_packet(self, packet: bytes) -> int:
        g = self.geometry
        nfrags = g.nfrags
        if len(packet) == 0:
            self.frame_type = 1
            self._update_granpos()
            return 1
        sideinfo = self._parse_sideinfo_native(packet)
        coded = sideinfo["coded"]
        ncoded_total = int(coded.sum())
        if self.frame_type != INTRA_FRAME and (
            self.ref_idx[FRAME_GOLD] < 0 or self.ref_idx[FRAME_PREV] < 0
        ):
            gray = [jnp.full_like(p, 0x80) for p in self._dev[0]]
            self._dev[0] = gray
            self.ref_idx[FRAME_GOLD] = 0
            self.ref_idx[FRAME_PREV] = 0
            self.ref_idx[FRAME_SELF] = 0
        if ncoded_total <= 0:
            self._update_granpos()
            return 1
        refi = 0
        while refi in (self.ref_idx[FRAME_GOLD], self.ref_idx[FRAME_PREV]):
            refi += 1
        self.ref_idx[FRAME_SELF] = refi
        if self.frame_type == INTRA_FRAME:
            self.keyframe_num = self.curframe_num
        frag_refi = sideinfo["refi"]
        frag_mv = sideinfo["mv"]
        frag_qii = sideinfo["qii"]

        coded_fragis_per_plane = []
        for pli in range(3):
            sel = g.scan_pli == pli
            fr = g.scan_fragis[sel]
            coded_fragis_per_plane.append(fr[coded[fr]])
        ncoded_per_plane = [len(f) for f in coded_fragis_per_plane]
        order = np.concatenate(coded_fragis_per_plane).astype(np.int32)
        qzc, last_zzi_c, dc_coded, _ = self._native.decode_frame_tokens(
            packet, sideinfo["bitpos"], ncoded_per_plane
        )
        self._update_granpos()

        # Dense per-fragment arrays.
        qz = np.zeros((nfrags, 64), dtype=np.int32)
        qz[order] = qzc
        last_zzi = np.full(nfrags, 64, dtype=np.int32)
        last_zzi[order] = last_zzi_c
        dc_full = np.zeros(nfrags, dtype=np.int32)
        dc_full[order] = dc_coded

        # DC prediction (host, C++).
        from theora_tpu.native import dc_predict_native

        pred_last = [[0, 0, 0] for _ in range(3)]
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            shape = (pl.nvfrags, pl.nhfrags)
            dc_pl = np.ascontiguousarray(dc_full[sl].reshape(shape))
            dc_predict_native(
                0,
                coded[sl].reshape(shape),
                frag_refi[sl].reshape(shape),
                dc_pl,
                pred_last[pli],
            )
            dc_full[sl] = dc_pl.reshape(-1)

        frame_dequant = np.stack(
            [
                np.stack([self.dequant[qi, pli] for qi in self.qis])
                for pli in range(3)
            ]
        )
        frag_is_inter = (frag_refi != FRAME_SELF).astype(np.int32)
        # Uncoded fragments: zero coeffs, PREV ref, zero MV.
        refsel = np.where(
            frag_refi == FRAME_SELF,
            0,
            np.where(frag_refi == FRAME_GOLD, 2, 1),
        ).astype(np.int32)
        deq_rows = frame_dequant[
            g.frag_pli, frag_qii, frag_is_inter
        ].astype(np.int32)
        dc_quant = frame_dequant[g.frag_pli, 0, frag_is_inter, 0].astype(
            np.int32
        )
        dc_only = last_zzi < 2
        # Uncoded: force the dense-copy path (dc==0 + dc_only -> residual 0).
        dc_only = dc_only | ~coded

        flimit = self.setup.qinfo["loop_filter_limits"][self.qis[0]]
        prev_i = self.ref_idx[FRAME_PREV]
        gold_i = self.ref_idx[FRAME_GOLD]
        new_planes = []
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            vpad, hpad = g.plane_padding(pli)
            qpx = 1 if (pli != 0 and not (self.info.pixel_fmt & 1)) else 0
            qpy = 1 if (pli != 0 and not (self.info.pixel_fmt & 2)) else 0
            dx = frag_mv[sl, 0]
            dy = frag_mv[sl, 1]
            mx = _MVMAP[qpx][dx + 31]
            mx2 = _MVMAP2[qpx][dx + 31]
            my = _MVMAP[qpy][dy + 31]
            my2 = _MVMAP2[qpy][dy + 31]
            use2 = ((mx2 != 0) | (my2 != 0)) & (refsel[sl] != 0)
            dcq = dc_quant[sl]
            plane = decode_plane_device(
                self._dev[prev_i][pli],
                self._dev[gold_i][pli],
                jnp.asarray(qz[sl]),
                jnp.asarray(deq_rows[sl]),
                jnp.asarray(dc_full[sl]),
                jnp.asarray(dcq),
                jnp.asarray(dc_only[sl]),
                jnp.asarray(refsel[sl]),
                jnp.asarray(my), jnp.asarray(mx),
                jnp.asarray(my + my2), jnp.asarray(mx + mx2),
                jnp.asarray(use2),
                jnp.asarray(coded[sl].reshape(pl.nvfrags, pl.nhfrags)),
                self._bv_cache.get(flimit)
                if flimit
                else jnp.zeros(256, jnp.int32),
                pl.nvfrags, pl.nhfrags, vpad, hpad, bool(flimit),
            )
            new_planes.append(plane)
        self._dev[refi] = new_planes
        self._out_dev = new_planes
        self._out_frame = None
        if self.frame_type == INTRA_FRAME:
            self.ref_idx[FRAME_GOLD] = refi
            self.ref_idx[FRAME_PREV] = refi
        else:
            self.ref_idx[FRAME_PREV] = refi
        return 0

    def ycbcr_out(self):
        out = []
        for pli in range(3):
            vpad, hpad = self.geometry.plane_padding(pli)
            h, w = self.geometry.plane_shape(pli)
            p = np.asarray(self._out_dev[pli])[
                vpad : vpad + h, hpad : hpad + w
            ]
            out.append(p[::-1].copy())
        return out
