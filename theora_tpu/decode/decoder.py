"""Frame decoder: bit-exact Theora decode over batched fragment tensors.

Host tier: packet parsing, token streams, DC prediction (numpy).
Compute tier: batched iDCT / reconstruction / loop filter; the numpy ops in
theora_tpu/ops are the bit-exactness reference, with JAX twins for
device execution (theora_tpu/ops/*_jax.py).

Frames are stored in bitstream orientation (row 0 = display bottom) in
padded planes; see theora_tpu/geometry.py. Reference behavior:
lib/decode.c (th_decode_packetin:2740-2986).
"""
from __future__ import annotations

import numpy as np

from theora_tpu.bitio import BitReader
from theora_tpu.constants import (
    ZIGZAG_TO_NAT,
    FRAME_FOR_MODE,
    FRAME_GOLD,
    FRAME_NONE,
    FRAME_PREV,
    FRAME_SELF,
    MB_MAP_IDXS,
    MODE_ALPHABETS,
    MODE_INTER_MV,
    MODE_INTER_MV_FOUR,
    MODE_INTER_MV_LAST,
    MODE_INTER_MV_LAST2,
    MODE_GOLDEN_MV,
    MODE_INTRA,
    MODE_INTER_NOMV,
    MODE_INVALID,
)
from theora_tpu.decode.dcpred import dc_unpredict_plane
from theora_tpu.decode.tokens import replay_coefficients, residual_tokens_unpack
from theora_tpu.geometry import get_geometry
from theora_tpu.headers import SetupInfo
from theora_tpu.huffman import (
    CLC_MODE_BOOK,
    MV_CLC_BOOK,
    MV_VLC_BOOK,
    RUN_CODER,
    VLC_MODE_BOOK,
)
from theora_tpu.info import INTRA_FRAME, INTER_FRAME, TheoraInfo
from theora_tpu.ops.idct_np import dc_fill_batch, idct8x8_batch
from theora_tpu.ops.loopfilter_np import build_bounding_values
from theora_tpu.ops.loopfilter_vec import loop_filter_plane_vec
from theora_tpu.quant import dequant_tables_init

# Integer and half-pel components of MV offsets (state.c:901-928):
# index by (precision, mv_component+31).
_MVMAP = np.array(
    [
        [
            -15, -15, -14, -14, -13, -13, -12, -12, -11, -11, -10, -10, -9,
            -9, -8, -8, -7, -7, -6, -6, -5, -5, -4, -4, -3, -3, -2, -2, -1,
            -1, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
            9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15,
        ],
        [
            -7, -7, -7, -7, -6, -6, -6, -6, -5, -5, -5, -5, -4, -4, -4, -4,
            -3, -3, -3, -3, -2, -2, -2, -2, -1, -1, -1, -1, 0, 0, 0, 0, 0,
            0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5,
            5, 6, 6, 6, 6, 7, 7, 7, 7,
        ],
    ],
    dtype=np.int32,
)
_MVMAP2 = np.array(
    [
        [
            -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0,
            -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, 1, 0, 1, 0, 1,
            0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0,
            1, 0, 1, 0, 1,
        ],
        [
            -1, -1, -1, 0, -1, -1, -1, 0, -1, -1, -1, 0, -1, -1, -1, 0, -1,
            -1, -1, 0, -1, -1, -1, 0, -1, -1, -1, 0, -1, -1, -1, 0, 1, 1,
            1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1,
            0, 1, 1, 1, 0, 1, 1, 1,
        ],
    ],
    dtype=np.int32,
)


def mv_offsets(dx: int, dy: int, qpx: int, qpy: int):
    """MV -> one or two (dy, dx) integer offsets (state.c:846-957)."""
    mx = int(_MVMAP[qpx][dx + 31])
    mx2 = int(_MVMAP2[qpx][dx + 31])
    my = int(_MVMAP[qpy][dy + 31])
    my2 = int(_MVMAP2[qpy][dy + 31])
    if mx2 or my2:
        return (my, mx), (my + my2, mx + mx2)
    return (my, mx), None


class RefFrame:
    """One reference frame: 3 padded uint8 planes in bitstream orientation."""

    def __init__(self, geometry):
        self.planes = []
        for pli in range(3):
            h, w = geometry.plane_shape(pli)
            vpad, hpad = geometry.plane_padding(pli)
            self.planes.append(np.zeros((h + 2 * vpad, w + 2 * hpad), dtype=np.uint8))
        self.geometry = geometry

    def fill_borders(self) -> None:
        for pli, p in enumerate(self.planes):
            vpad, hpad = self.geometry.plane_padding(pli)
            h, w = self.geometry.plane_shape(pli)
            # left/right replication (state.c:770-791)
            p[vpad : vpad + h, :hpad] = p[vpad : vpad + h, hpad : hpad + 1]
            p[vpad : vpad + h, hpad + w :] = p[vpad : vpad + h, hpad + w - 1 : hpad + w]
            # top/bottom caps (state.c:799-822)
            p[:vpad, :] = p[vpad : vpad + 1, :]
            p[vpad + h :, :] = p[vpad + h - 1 : vpad + h, :]

    def fill_gray(self) -> None:
        for p in self.planes:
            p.fill(0x80)


class Decoder:
    """Theora decoder (th_decode_* analogue).

    Entropy decoding uses the native C++ tier when available (falling back
    to the Python tier); pixel reconstruction runs through the batched ops
    in theora_tpu/ops.
    """

    def __init__(self, info: TheoraInfo, setup: SetupInfo, use_native=True):
        info.validate()
        self.info = info
        self.setup = setup
        self.geometry = get_geometry(
            info.frame_width, info.frame_height, int(info.pixel_fmt)
        )
        self.dequant = dequant_tables_init(setup.qinfo)  # [64,3,2,64]
        self.codebooks = setup.codebooks
        g = self.geometry
        # Three reconstruction buffers; indices per reference slot.
        self.buffers = [RefFrame(g) for _ in range(3)]
        self.ref_idx = {FRAME_GOLD: -1, FRAME_PREV: -1, FRAME_SELF: -1}
        self.keyframe_num = 0
        self.curframe_num = 0
        self.granpos = -1
        self.frame_type = -1
        # Persistent per-fragment state (refi survives for DC prediction of
        # skipped rows? no -- rebuilt per frame; dc/qii rebuilt per frame).
        self._out_frame = None
        # Telemetry overlay flags (TH_DECCTL_SET_TELEMETRY_*; rendering in
        # decode/telemetry.py).
        self.telemetry = {"mbmode": 0, "mv": 0, "qi": 0, "bits": 0}
        self._telemetry_state = None
        # Per-fragment bit accounting independent of overlays (used by the
        # encoder's R-D metrics collection, collect.c analogue).
        self.want_frag_bits = False
        self._native = None
        if use_native:
            try:
                from theora_tpu.native import NativeEntropy

                self._native = NativeEntropy(self.codebooks)
            except Exception:
                self._native = None
        # Striped-decode callback (delivered whole-frame).
        self.stripe_callback = None
        # Out-of-loop postprocessor state (decode.c:1204-1325).
        self.pp_level = 0
        self._pp_dc_qis = None
        self._pp_planes = None
        # PERSISTENT per-fragment qii and 3-slot qi list: the reference
        # updates frag->qii only for CODED fragments (decode.c:916 and
        # the qi-RLE unpack) and state.qis[1..2] only when the frame
        # carries them, so dering strength on an uncoded fragment reads
        # the qii it had when last coded, indexed into a qis array whose
        # upper slots may also be stale (decode.c:1928).  Regenerating
        # either per frame diverges (found by the synthetic-plan
        # conformance direction, round 4).
        self._pp_qii_state = np.zeros(self.geometry.nfrags, np.uint8)
        self._pp_qis_state = np.zeros(3, np.uint8)
        from theora_tpu.quant import pp_dc_scale_init

        self._pp_dc_scale = pp_dc_scale_init(setup.qinfo)
        # pp_sharp_mod (decode.c:399-409).
        sharp = np.zeros(64, dtype=np.int32)
        for qi in range(64):
            qsum = 0
            for qti in range(2):
                for pli in range(3):
                    d = self.dequant[qi, pli, qti]
                    qsum += (
                        int(d[12]) + int(d[17]) + int(d[18]) + int(d[24])
                    ) << (1 if pli == 0 else 0)
            sharp[qi] = -(qsum >> 11)
        self._pp_sharp_mod = sharp

    # ------------------------------------------------------------------
    def set_pplevel(self, level: int) -> None:
        """TH_DECCTL_SET_PPLEVEL analogue: 0=off .. 7=max
        (decode.c:31-48)."""
        if not 0 <= level <= 7:
            raise ValueError("pp level must be 0..7")
        self.pp_level = level

    # ------------------------------------------------------------------
    def _postprocess(self, coded, frag_qii) -> None:
        """Whole-frame deblock + dering into the pp buffers
        (decode.c:2893-2915, 1204-1325)."""
        g = self.geometry
        level = self.pp_level
        if level < 1:
            self._pp_dc_qis = None
            self._pp_planes = None
            return
        # DC qi tracking starts at the first INTRA frame (decode.c:1220-1244).
        if self._pp_dc_qis is None:
            if self.frame_type != INTRA_FRAME:
                self._pp_planes = None
                return
            self._pp_dc_qis = np.full(g.nfrags, self.qis[0], dtype=np.uint8)
        else:
            self._pp_dc_qis[coded] = self.qis[0]
        if level < 2:
            self._pp_planes = None
            return
        from theora_tpu.ops import postproc_np
        from theora_tpu.native import pp_postprocess_plane

        native_pp = pp_postprocess_plane()  # None without the .so
        self._pp_planes = [None, None, None]
        self_frame = self.buffers[self.ref_idx[FRAME_SELF]]
        dc_scale = np.asarray(self._pp_dc_scale, dtype=np.int32)
        sharp = np.asarray(self._pp_sharp_mod, dtype=np.int32)
        # Persistent 3-slot qi list: slots beyond this frame's nqis keep
        # their last-written values (the reference never clears them).
        qis_arr = self._pp_qis_state
        nplanes = 3 if level >= 5 else 1
        for pli in range(nplanes):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            h, w = g.plane_shape(pli)
            vpad, hpad = g.plane_padding(pli)
            src = np.ascontiguousarray(
                self_frame.planes[pli][vpad : vpad + h, hpad : hpad + w]
            )
            dqs = self._pp_dc_qis[sl].reshape(pl.nvfrags, pl.nhfrags)
            dering_min = 3 if pli == 0 else 6
            strong = level >= (4 if pli == 0 else 7)
            # Persistent per-fragment qii: uncoded fragments keep the
            # qii from the frame they were last coded in.
            qpf = qis_arr[self._pp_qii_state[sl]].reshape(
                pl.nvfrags, pl.nhfrags
            )
            fn = native_pp or postproc_np.postprocess_plane
            self._pp_planes[pli] = fn(
                src, dqs, qpf, dc_scale, sharp,
                dering=level >= dering_min, strong=strong, pli=pli,
            )

    # ------------------------------------------------------------------
    def decode_packet(self, packet: bytes) -> int:
        """Decode one data packet. Returns 0 on a new frame, 1 (DUPFRAME)
        for a dropped/duplicate frame."""
        g = self.geometry
        info = self.info
        nfrags = g.nfrags
        sideinfo = None
        if len(packet) == 0:
            self.frame_type = INTER_FRAME
            coded = np.zeros(nfrags, dtype=bool)
            ncoded_total = 0
            br = None
        elif self._native is not None:
            sideinfo = self._parse_sideinfo_native(packet)
            coded = sideinfo["coded"]
            ncoded_total = int(coded.sum())
            br = None
        else:
            br = BitReader(packet)
            if br.read1() != 0:
                raise ValueError("not a data packet")
            self.frame_type = br.read1()
            qis = [br.read(6)]
            if br.read1():
                qis.append(br.read(6))
                if br.read1():
                    qis.append(br.read(6))
            self.qis = qis
            if self.frame_type == INTRA_FRAME:
                if br.read(3) != 0:
                    raise ValueError("unsupported INTRA config bits")
                coded = np.zeros(nfrags, dtype=bool)
                coded[g.scan_fragis] = True
                mb_modes = None
            else:
                coded, mb_luma_coded = self._coded_flags_unpack(br)
            ncoded_total = int(coded.sum())

        # Dummy gray reference if the stream starts on an inter frame
        # (decode.c:2053-2080).
        if self.frame_type != INTRA_FRAME and (
            self.ref_idx[FRAME_GOLD] < 0 or self.ref_idx[FRAME_PREV] < 0
        ):
            self.buffers[0].fill_gray()
            self.ref_idx[FRAME_GOLD] = 0
            self.ref_idx[FRAME_PREV] = 0
            self.ref_idx[FRAME_SELF] = 0
            self._out_frame = self.buffers[0]

        if ncoded_total <= 0:
            # Dropped/duplicate frame (decode.c:2763-2772).
            self._update_granpos()
            return 1

        # Select a free buffer for SELF (decode.c:2789-2794).
        refi = 0
        while refi in (self.ref_idx[FRAME_GOLD], self.ref_idx[FRAME_PREV]):
            refi += 1
        self.ref_idx[FRAME_SELF] = refi
        self_frame = self.buffers[refi]

        if sideinfo is not None:
            frag_refi = sideinfo["refi"]
            frag_mode = sideinfo["mode"]
            frag_mv = sideinfo["mv"]
            frag_qii = sideinfo["qii"]
            if self.frame_type == INTRA_FRAME:
                self.keyframe_num = self.curframe_num
        else:
            frag_refi = np.full(nfrags, FRAME_NONE, dtype=np.int32)
            frag_mode = np.zeros(nfrags, dtype=np.int32)
            frag_mv = np.zeros((nfrags, 2), dtype=np.int32)  # (dx, dy)
            if self.frame_type == INTRA_FRAME:
                self.keyframe_num = self.curframe_num
                frag_refi[coded] = FRAME_SELF
                frag_mode[coded] = MODE_INTRA
            else:
                mb_modes = self._mb_modes_unpack(br, mb_luma_coded)
                self._mv_unpack_and_fill(
                    br, mb_modes, coded, frag_refi, frag_mode, frag_mv
                )
            frag_qii = self._block_qis_unpack(br, coded)

        # Coded fragment lists per plane, in canonical scan order.
        coded_fragis_per_plane = []
        for pli in range(3):
            sel = g.scan_pli == pli
            fr = g.scan_fragis[sel]
            coded_fragis_per_plane.append(fr[coded[fr]])
        ncoded_per_plane = [len(f) for f in coded_fragis_per_plane]

        order = (
            np.concatenate(coded_fragis_per_plane).astype(np.int32)
            if ncoded_total
            else np.zeros(0, np.int32)
        )
        if self._native is not None:
            bitpos = sideinfo["bitpos"] if sideinfo is not None else br.pos
            want_bits = bool(self.telemetry["bits"]) or self.want_frag_bits
            res = self._native.decode_frame_tokens(
                packet, bitpos, ncoded_per_plane, want_bits=want_bits
            )
            qz, last_zzi, dc_coded, _end = res[:4]
            self._frag_bits = res[4] if want_bits else None
            qz = qz.astype(np.int32)
            dc_full = np.zeros(nfrags, dtype=np.int32)
            dc_full[order] = dc_coded
            self._last_token_order = order
        else:
            streams = residual_tokens_unpack(
                br, self.codebooks, ncoded_per_plane, coded_fragis_per_plane,
                nfrags,
            )
            qz, last_zzi, order = replay_coefficients(
                streams, coded_fragis_per_plane
            )
            dc_full = streams.dc  # [nfrags]
        self._update_granpos()

        # DC prediction reversal, per plane, row-scan (decode.c:1392-1500).
        pred_last = [[0, 0, 0] for _ in range(3)]
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            shape = (pl.nvfrags, pl.nhfrags)
            dc_pl = np.ascontiguousarray(dc_full[sl].reshape(shape))
            if self._native is not None:
                from theora_tpu.native import dc_predict_native

                dc_predict_native(
                    0,
                    coded[sl].reshape(shape),
                    frag_refi[sl].reshape(shape),
                    dc_pl,
                    pred_last[pli],
                )
            else:
                dc_unpredict_plane(
                    coded[sl].reshape(shape),
                    frag_refi[sl].reshape(shape),
                    dc_pl,
                    pred_last[pli],
                )
            dc_full[sl] = dc_pl.reshape(-1)

        # Condensed dequant tables for this frame's qis
        # [3][nqis][2][64] (decode.c:1358-1365).
        frame_dequant = np.stack(
            [
                np.stack([self.dequant[qi, pli] for qi in self.qis])
                for pli in range(3)
            ]
        )
        frag_is_inter = (frag_mode != MODE_INTRA).astype(np.int32)

        # Per-fragment dequant rows (zig-zag) and batched dequantization.
        deq_rows = frame_dequant[
            g.frag_pli[order], frag_qii[order], frag_is_inter[order]
        ].astype(np.int64)
        # DC always dequantizes with qii=0 (decode.c:1530).
        dc_quant = frame_dequant[
            g.frag_pli[order], 0, frag_is_inter[order], 0
        ].astype(np.int64)
        dcs = dc_full[order].astype(np.int64)
        dc_only = last_zzi < 2
        if self._native is not None:
            from theora_tpu.native import residuals_native

            residual = residuals_native(qz, deq_rows, dcs, dc_quant, dc_only)
        else:
            residual = np.empty((len(order), 8, 8), dtype=np.int32)
            if dc_only.any():
                residual[dc_only] = dc_fill_batch(
                    dcs[dc_only], dc_quant[dc_only]
                )
            full = ~dc_only
            if full.any():
                deq = qz[full].astype(np.int64) * deq_rows[full]
                deq[:, 0] = dcs[full] * dc_quant[full]
                # int16 wraparound on all dequantized coefficients, then
                # de-zig-zag into natural order.
                deq = ((deq + 0x8000) % 0x10000 - 0x8000).astype(np.int32)
                nat = np.zeros_like(deq)
                nat[:, ZIGZAG_TO_NAT[:64]] = deq
                residual[full] = idct8x8_batch(nat.reshape(-1, 8, 8))

        # Reconstruction (state.c:959-1000).
        self._reconstruct(order, residual, frag_refi, frag_mv, self_frame)

        # Copy uncoded fragments from PREV (decode.c:1598-1606).
        prev_frame = self.buffers[self.ref_idx[FRAME_PREV]]
        self._copy_uncoded(coded, prev_frame, self_frame)

        # Loop filter (state.c:1055-1105), striped when a stripe callback
        # is installed (decode.c:2858-2943).
        flimit = self.setup.qinfo["loop_filter_limits"][self.qis[0]]
        self._out_frame = self_frame
        self.ref_idx[FRAME_SELF] = refi  # ensure set before postprocess
        striped = (
            self.stripe_callback is not None
            and self.pp_level == 0
            and not any(self.telemetry.values())
        )
        if striped:
            self._pp_planes = None
            self._filter_and_deliver_striped(self_frame, coded, flimit)
        elif flimit:
            bv = build_bounding_values(flimit)
            for pli in range(3):
                pl = g.planes[pli]
                sl = slice(pl.froffset, pl.froffset + pl.nfrags)
                cm = coded[sl].reshape(pl.nvfrags, pl.nhfrags)
                vpad, hpad = g.plane_padding(pli)
                if self._native is not None:
                    from theora_tpu.native import loop_filter_native

                    loop_filter_native(
                        self_frame.planes[pli], cm, bv, vpad, hpad
                    )
                else:
                    loop_filter_plane_vec(self_frame.planes[pli], cm, bv)

        self_frame.fill_borders()
        self._pp_qis_state[: len(self.qis)] = self.qis
        self._pp_qii_state[coded] = frag_qii[coded]
        if self.pp_level > 0:
            self._postprocess(coded, frag_qii)
        # Per-frame decode metrics.
        self.last_frame_metrics = {
            "frame": self.curframe_num,
            "keyframe": self.frame_type == INTRA_FRAME,
            "qis": list(self.qis),
            "ncoded": int(ncoded_total),
            "granulepos": self.granpos,
        }
        if any(self.telemetry.values()):
            self._telemetry_state = {
                "coded": coded,
                "mode": frag_mode,
                "mv": frag_mv,
                "qii": frag_qii,
                "order": order,
                "frag_bits": getattr(self, "_frag_bits", None),
            }
        if self.stripe_callback is not None and not striped:
            # Postproc/telemetry paths run whole-frame (the reference
            # instead threads each pp stage through the stripe pipeline
            # with extra row delays, decode.c:2894-2915); deliver the
            # finished rows in reference-sized stripes, bottom-to-top.
            nvy = g.planes[0].nvfrags
            ycbcr = self.ycbcr_out()
            for a in range(nvy, 0, -4):
                self.stripe_callback(ycbcr, max(a - 4, 0), a)

        # Reference rotation (decode.c:2947-2962).
        if self.frame_type == INTRA_FRAME:
            self.ref_idx[FRAME_GOLD] = refi
            self.ref_idx[FRAME_PREV] = refi
        else:
            self.ref_idx[FRAME_PREV] = refi
        return 0

    # ------------------------------------------------------------------
    def reconstruct_from_state(self, frame_type, qis, coded, frag_refi,
                               frag_mode, frag_mv, frag_qii, qz_order):
        """Reconstruct a frame directly from already-known side info and
        quantized coefficients, skipping the entropy stages -- the
        encoder\'s closed-loop fast path (the reference instead duplicates
        reconstruction in the encoder, analyze.c:667-882). The caller
        guarantees the arrays equal what decoding the packed packet would
        produce; qz_dense holds zig-zag quantized coefficients with the
        ORIGINAL (unpredicted) DC in slot 0.

        Produces byte-identical reference state to decode_packet on the
        corresponding packet (asserted by the closed-loop tests)."""
        g = self.geometry
        self.frame_type = frame_type
        self.qis = list(qis)
        ncoded_total = int(coded.sum())
        if frame_type != INTRA_FRAME and (
            self.ref_idx[FRAME_GOLD] < 0 or self.ref_idx[FRAME_PREV] < 0
        ):
            self.buffers[0].fill_gray()
            self.ref_idx[FRAME_GOLD] = 0
            self.ref_idx[FRAME_PREV] = 0
            self.ref_idx[FRAME_SELF] = 0
            self._out_frame = self.buffers[0]
        if ncoded_total <= 0:
            self._update_granpos()
            return 1
        refi = 0
        while refi in (self.ref_idx[FRAME_GOLD], self.ref_idx[FRAME_PREV]):
            refi += 1
        self.ref_idx[FRAME_SELF] = refi
        self_frame = self.buffers[refi]
        if frame_type == INTRA_FRAME:
            self.keyframe_num = self.curframe_num
        self._update_granpos()

        order = []
        for pli in range(3):
            sel = g.scan_pli == pli
            fr = g.scan_fragis[sel]
            order.append(fr[coded[fr]])
        order = (
            np.concatenate(order).astype(np.int32)
            if ncoded_total
            else np.zeros(0, np.int32)
        )
        qz = np.ascontiguousarray(qz_order, dtype=np.int32)
        frame_dequant = np.stack(
            [
                np.stack([self.dequant[qi, pli] for qi in self.qis])
                for pli in range(3)
            ]
        )
        frag_is_inter = (frag_mode != MODE_INTRA).astype(np.int32)
        deq_rows = frame_dequant[
            g.frag_pli[order], frag_qii[order], frag_is_inter[order]
        ].astype(np.int64)
        dc_quant = frame_dequant[
            g.frag_pli[order], 0, frag_is_inter[order], 0
        ].astype(np.int64)
        dcs = qz[:, 0].astype(np.int64)
        # AC-all-zero blocks take the DC-fill path: both our tokenizers
        # only emit zero runs ahead of a nonzero value, so the decoder\'s
        # last_zzi < 2 exactly when the AC vector is zero.
        dc_only = (qz[:, 1:] == 0).all(axis=1)
        from theora_tpu.native import residuals_native

        residual = residuals_native(qz, deq_rows, dcs, dc_quant, dc_only)
        self._reconstruct(order, residual, frag_refi, frag_mv, self_frame)
        prev_frame = self.buffers[self.ref_idx[FRAME_PREV]]
        self._copy_uncoded(coded, prev_frame, self_frame)
        flimit = self.setup.qinfo["loop_filter_limits"][self.qis[0]]
        if flimit:
            bv = build_bounding_values(flimit)
            from theora_tpu.native import loop_filter_native

            for pli in range(3):
                pl = g.planes[pli]
                sl = slice(pl.froffset, pl.froffset + pl.nfrags)
                cm = coded[sl].reshape(pl.nvfrags, pl.nhfrags)
                vpad, hpad = g.plane_padding(pli)
                loop_filter_native(self_frame.planes[pli], cm, bv, vpad, hpad)
        self_frame.fill_borders()
        self._out_frame = self_frame
        self._pp_qis_state[: len(self.qis)] = self.qis
        self._pp_qii_state[coded] = frag_qii[coded]
        if self.pp_level > 0:
            self._postprocess(coded, frag_qii)
        self.last_frame_metrics = {
            "frame": self.curframe_num,
            "keyframe": frame_type == INTRA_FRAME,
            "qis": list(self.qis),
            "ncoded": ncoded_total,
            "granulepos": self.granpos,
        }
        if frame_type == INTRA_FRAME:
            self.ref_idx[FRAME_GOLD] = refi
            self.ref_idx[FRAME_PREV] = refi
        else:
            self.ref_idx[FRAME_PREV] = refi
        return 0

    # ------------------------------------------------------------------
    def _parse_sideinfo_native(self, packet: bytes) -> dict:
        """Frame side-info parse via the C++ tier (decode.c:442-981)."""
        import ctypes

        from theora_tpu.native import get_lib

        lib = get_lib()
        if not hasattr(lib, "_sideinfo_setup"):
            lib.th_parse_frame_sideinfo.restype = ctypes.c_int64
            lib.th_parse_frame_sideinfo.argtypes = [ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            lib._sideinfo_setup = True
        g = self.geometry
        if not hasattr(self, "_si_arrays"):
            self._si_arrays = (
                np.ascontiguousarray(g.scan_fragis, dtype=np.int32),
                np.ascontiguousarray(g.scan_sbi, dtype=np.int32),
                np.ascontiguousarray(g.scan_quadi, dtype=np.int32),
                np.ascontiguousarray(g.mb_maps.reshape(-1), dtype=np.int32),
                np.ascontiguousarray(g.mb_valid, dtype=np.uint8),
            )
        sf, ssb, sq, mbm, mbv = self._si_arrays
        buf = np.frombuffer(packet, dtype=np.uint8)
        ft = np.zeros(1, np.int32)
        qis = np.zeros(3, np.int32)
        nqis = np.zeros(1, np.int32)
        coded = np.zeros(g.nfrags, np.uint8)
        refi = np.zeros(g.nfrags, np.int32)
        mode = np.zeros(g.nfrags, np.int32)
        mv = np.zeros((g.nfrags, 2), np.int32)
        qii = np.zeros(g.nfrags, np.int32)
        pos = lib.th_parse_frame_sideinfo(
            buf.ctypes.data, len(packet), g.nfrags, g.nsbs, g.nmbs,
            int(self.info.pixel_fmt), sf.ctypes.data, ssb.ctypes.data,
            sq.ctypes.data, len(sf), g.planes[0].nsbs, mbm.ctypes.data,
            mbv.ctypes.data, ft.ctypes.data, qis.ctypes.data,
            nqis.ctypes.data, coded.ctypes.data, refi.ctypes.data,
            mode.ctypes.data, mv.ctypes.data, qii.ctypes.data,
        )
        if pos < 0:
            raise ValueError("bad frame packet")
        self.frame_type = int(ft[0])
        self.qis = [int(q) for q in qis[: int(nqis[0])]]
        return {
            "coded": coded.astype(bool),
            "refi": refi,
            "mode": mode,
            "mv": mv,
            "qii": qii,
            "bitpos": int(pos),
        }

    # ------------------------------------------------------------------
    def _update_granpos(self) -> None:
        shift = self.info.keyframe_granule_shift
        bias = 1  # streams are version 3.2.1 (state.c:748-752)
        self.granpos = ((self.keyframe_num + bias) << shift) + (
            self.curframe_num - self.keyframe_num
        )
        self.curframe_num += 1

    # ------------------------------------------------------------------
    def _coded_flags_unpack(self, br: BitReader):
        """Partial/full SB flags + block runs (decode.c:523-671).

        Returns (coded [nfrags] bool, mb_luma_coded [nmbs] bool)."""
        g = self.geometry
        nsbs = g.nsbs
        sb_partial = np.zeros(nsbs, dtype=bool)
        sb_full = np.zeros(nsbs, dtype=bool)
        # partially-coded SB flags
        flag = br.read1()
        npartial = 0
        sbi = 0
        while sbi < nsbs:
            run = RUN_CODER.read_sb_run(br)
            full_run = run >= 4129
            while run > 0 and sbi < nsbs:
                sb_partial[sbi] = flag
                npartial += flag
                sbi += 1
                run -= 1
            if full_run and sbi < nsbs:
                flag = br.read1()
            else:
                flag = not flag
        # fully-coded SB flags for non-partial SBs
        if npartial < nsbs:
            sbi = 0
            while sb_partial[sbi]:
                sbi += 1
            flag = br.read1()
            while sbi < nsbs:
                run = RUN_CODER.read_sb_run(br)
                full_run = run >= 4129
                while sbi < nsbs:
                    if sb_partial[sbi]:
                        sbi += 1
                        continue
                    if run <= 0:
                        break
                    sb_full[sbi] = flag
                    sbi += 1
                    run -= 1
                if full_run and sbi < nsbs:
                    flag = br.read1()
                else:
                    flag = not flag
        # block-level flags within partial SBs
        if npartial > 0:
            flag = not br.read1()
        else:
            flag = False
        coded = np.zeros(g.nfrags, dtype=bool)
        mb_luma_coded = np.zeros(g.nmbs, dtype=bool)
        run = 0
        for i in range(len(g.scan_fragis)):
            fragi = g.scan_fragis[i]
            sbi = g.scan_sbi[i]
            quadi = g.scan_quadi[i]
            if sb_full[sbi]:
                c = True
            elif not sb_partial[sbi]:
                c = False
            else:
                if run <= 0:
                    run = RUN_CODER.read_block_run(br)
                    flag = not flag
                run -= 1
                c = flag
            coded[fragi] = c
            if c and sbi < g.planes[0].nsbs:
                mb_luma_coded[sbi << 2 | quadi] = True
        return coded, mb_luma_coded

    # ------------------------------------------------------------------
    def _mb_modes_unpack(self, br: BitReader, mb_luma_coded: np.ndarray):
        """(decode.c:702-739)"""
        g = self.geometry
        scheme = br.read(3)
        if scheme == 0:
            alphabet = np.zeros(8, dtype=np.int32)
            for mi in range(8):
                alphabet[br.read(3)] = MODE_ALPHABETS[6][mi]
        else:
            alphabet = MODE_ALPHABETS[scheme - 1]
        book = CLC_MODE_BOOK if scheme == 7 else VLC_MODE_BOOK
        mb_modes = np.where(g.mb_valid, 0, MODE_INVALID).astype(np.int32)
        for mbi in range(g.nmbs):
            if g.mb_valid[mbi] and mb_luma_coded[mbi]:
                mb_modes[mbi] = alphabet[book.decode(br)]
        return mb_modes

    # ------------------------------------------------------------------
    def _mv_unpack_and_fill(
        self, br, mb_modes, coded, frag_refi, frag_mode, frag_mv
    ):
        """(decode.c:806-900)"""
        g = self.geometry
        pf = int(self.info.pixel_fmt)
        map_idxs = MB_MAP_IDXS[pf]
        book = MV_CLC_BOOK if br.read1() else MV_VLC_BOOK

        def read_mv():
            dx = book.decode(br) - 32
            dy = book.decode(br) - 32
            return dx, dy

        def div_round(v, shift, rval):
            return (v + (-1 if v < 0 else 0) + rval) >> shift

        last_mv = (0, 0)
        prior_mv = (0, 0)
        for mbi in range(g.nmbs):
            mode = int(mb_modes[mbi])
            if mode == MODE_INVALID:
                continue
            if mode == MODE_INTER_MV_FOUR:
                lbmvs = [(0, 0)] * 4
                prior_mv = last_mv
                for bi in range(4):
                    fragi = g.mb_maps[mbi, 0, bi]
                    if fragi >= 0 and coded[fragi]:
                        mv = read_mv()
                        last_mv = mv
                        lbmvs[bi] = mv
                        frag_refi[fragi] = FRAME_PREV
                        frag_mode[fragi] = MODE_INTER_MV_FOUR
                        frag_mv[fragi] = mv
                # Chroma MVs (state.c:33-97)
                cbmvs = [(0, 0)] * 4
                if pf == 0:
                    dx = sum(v[0] for v in lbmvs)
                    dy = sum(v[1] for v in lbmvs)
                    cbmvs[0] = (div_round(dx, 2, 2), div_round(dy, 2, 2))
                elif pf == 2:
                    for k, (a, b) in enumerate(((0, 1), (2, 3))):
                        dx = lbmvs[a][0] + lbmvs[b][0]
                        dy = lbmvs[a][1] + lbmvs[b][1]
                        cbmvs[k * 2] = (div_round(dx, 1, 1), div_round(dy, 1, 1))
                elif pf == 1:
                    for k, (a, b) in enumerate(((0, 2), (1, 3))):
                        dx = lbmvs[a][0] + lbmvs[b][0]
                        dy = lbmvs[a][1] + lbmvs[b][1]
                        cbmvs[k] = (div_round(dx, 1, 1), div_round(dy, 1, 1))
                else:
                    cbmvs = list(lbmvs)
                for mapii in range(4, len(map_idxs)):
                    mapi = map_idxs[mapii]
                    bi = mapi & 3
                    fragi = g.mb_maps[mbi, mapi >> 2, bi]
                    if fragi >= 0 and coded[fragi]:
                        frag_refi[fragi] = FRAME_PREV
                        frag_mode[fragi] = MODE_INTER_MV_FOUR
                        frag_mv[fragi] = cbmvs[bi]
            else:
                if mode == MODE_INTER_MV:
                    prior_mv = last_mv
                    mbmv = read_mv()
                    last_mv = mbmv
                elif mode == MODE_INTER_MV_LAST:
                    mbmv = last_mv
                elif mode == MODE_INTER_MV_LAST2:
                    mbmv = prior_mv
                    prior_mv = last_mv
                    last_mv = mbmv
                elif mode == MODE_GOLDEN_MV:
                    mbmv = read_mv()
                else:
                    mbmv = (0, 0)
                refi = FRAME_FOR_MODE[mode]
                for mapii in range(len(map_idxs)):
                    mapi = map_idxs[mapii]
                    fragi = g.mb_maps[mbi, mapi >> 2, mapi & 3]
                    if fragi >= 0 and coded[fragi]:
                        frag_refi[fragi] = refi
                        frag_mode[fragi] = mode
                        frag_mv[fragi] = mbmv
        # Coded fragments of luma-uncoded MBs default to INTER_NOMV/PREV
        # (the reference's zero-initialized frag state; decode.c:736-804
        # never touches them).
        orphan = coded & (frag_refi == FRAME_NONE)
        frag_refi[orphan] = FRAME_PREV
        frag_mode[orphan] = MODE_INTER_NOMV

    # ------------------------------------------------------------------
    def _block_qis_unpack(self, br, coded):
        """(decode.c:902-981)"""
        g = self.geometry
        frag_qii = np.zeros(g.nfrags, dtype=np.int32)
        nqis = len(self.qis)
        coded_order = []
        for pli in range(3):
            sel = g.scan_pli == pli
            fr = g.scan_fragis[sel]
            coded_order.append(fr[coded[fr]])
        coded_order = (
            np.concatenate(coded_order) if coded_order else np.zeros(0, np.int32)
        )
        n = len(coded_order)
        if n == 0 or nqis == 1:
            return frag_qii
        qii = np.zeros(n, dtype=np.int32)
        flag = br.read1()
        nqi1 = 0
        i = 0
        while i < n:
            run = RUN_CODER.read_sb_run(br)
            full_run = run >= 4129
            while run > 0 and i < n:
                qii[i] = flag
                nqi1 += flag
                i += 1
                run -= 1
            if full_run and i < n:
                flag = br.read1()
            else:
                flag = not flag
        if nqis == 3 and nqi1 > 0:
            i = 0
            while qii[i] == 0:
                i += 1
            flag = br.read1()
            while i < n:
                run = RUN_CODER.read_sb_run(br)
                full_run = run >= 4129
                while i < n:
                    if qii[i] == 0:
                        i += 1
                        continue
                    if run <= 0:
                        break
                    qii[i] += flag
                    i += 1
                    run -= 1
                if full_run and i < n:
                    flag = br.read1()
                else:
                    flag = not flag
        frag_qii[coded_order] = qii
        return frag_qii

    # ------------------------------------------------------------------
    def _reconstruct(self, order, residual, frag_refi, frag_mv, self_frame):
        """Batched per-fragment reconstruction (state.c:959-1000,
        fragment.c:49-80)."""
        g = self.geometry
        info = self.info
        if self._native is not None:
            from theora_tpu.native import recon_plane_native

            prev_frame = self.buffers[self.ref_idx[FRAME_PREV]]
            gold_frame = self.buffers[self.ref_idx[FRAME_GOLD]]
            pli_of = g.frag_pli[order]
            for pli in range(3):
                sel = pli_of == pli
                fragis = order[sel]
                vpad, hpad = g.plane_padding(pli)
                qpx = 1 if (pli != 0 and not (info.pixel_fmt & 1)) else 0
                qpy = 1 if (pli != 0 and not (info.pixel_fmt & 2)) else 0
                recon_plane_native(
                    self_frame.planes[pli],
                    prev_frame.planes[pli],
                    gold_frame.planes[pli],
                    vpad, hpad,
                    g.frag_y[fragis], g.frag_x[fragis],
                    frag_refi[fragis],
                    frag_mv[fragis, 0], frag_mv[fragis, 1],
                    residual[sel], qpx, qpy,
                    np.zeros(0, np.int32), np.zeros(0, np.int32),
                )
            return
        for pli in range(3):
            pl = g.planes[pli]
            sel = (g.frag_pli[order] == pli)
            if not sel.any():
                continue
            idx = np.where(sel)[0]
            fragis = order[idx]
            res = residual[idx]
            vpad, hpad = g.plane_padding(pli)
            fy = g.frag_y[fragis] * 8 + vpad
            fx = g.frag_x[fragis] * 8 + hpad
            dst = self_frame.planes[pli]
            refi = frag_refi[fragis]
            intra_m = refi == FRAME_SELF
            ay = fy[:, None, None] + np.arange(8)[None, :, None]
            ax = fx[:, None, None] + np.arange(8)[None, None, :]
            out = np.empty((len(fragis), 8, 8), dtype=np.int32)
            # Intra: residual + 128
            if intra_m.any():
                out[intra_m] = res[intra_m] + 128
            # Inter: vectorized MV offsets + batched block gathers.
            for rf in (FRAME_PREV, FRAME_GOLD):
                m = refi == rf
                if not m.any():
                    continue
                qpx = 1 if (pli != 0 and not (info.pixel_fmt & 1)) else 0
                qpy = 1 if (pli != 0 and not (info.pixel_fmt & 2)) else 0
                src = self.buffers[self.ref_idx[rf]].planes[pli]
                dx = frag_mv[fragis[m], 0]
                dy = frag_mv[fragis[m], 1]
                mx = _MVMAP[qpx][dx + 31]
                mx2 = _MVMAP2[qpx][dx + 31]
                my = _MVMAP[qpy][dy + 31]
                my2 = _MVMAP2[qpy][dy + 31]
                use2 = (mx2 != 0) | (my2 != 0)
                gy = (fy[m] + my)[:, None, None] + np.arange(8)[None, :, None]
                gx = (fx[m] + mx)[:, None, None] + np.arange(8)[None, None, :]
                blk = src[gy, gx].astype(np.int32)
                if use2.any():
                    g2y = (fy[m] + my + my2)[:, None, None] + np.arange(8)[
                        None, :, None
                    ]
                    g2x = (fx[m] + mx + mx2)[:, None, None] + np.arange(8)[
                        None, None, :
                    ]
                    blk2 = src[g2y, g2x].astype(np.int32)
                    blk = np.where(use2[:, None, None], (blk + blk2) >> 1, blk)
                out[m] = res[m] + blk
            np.clip(out, 0, 255, out=out)
            dst[ay, ax] = out.astype(np.uint8)

    # ------------------------------------------------------------------
    def _copy_uncoded(self, coded, prev_frame, self_frame):
        g = self.geometry
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            cm = coded[sl].reshape(pl.nvfrags, pl.nhfrags)
            if cm.all():
                continue
            vpad, hpad = g.plane_padding(pli)
            src = prev_frame.planes[pli]
            dst = self_frame.planes[pli]
            ys, xs = np.where(~cm)
            if self._native is not None:
                from theora_tpu.native import recon_plane_native

                z = np.zeros(0, np.int32)
                recon_plane_native(
                    dst, src, src, vpad, hpad, z, z, z, z, z,
                    np.zeros((0, 64), np.int32), 0, 0, ys, xs,
                )
            else:
                ay = (vpad + ys * 8)[:, None, None] + np.arange(8)[None, :, None]
                ax = (hpad + xs * 8)[:, None, None] + np.arange(8)[None, None, :]
                dst[ay, ax] = src[ay, ax]

    # ------------------------------------------------------------------
    def set_telemetry(self, mbmode=None, mv=None, qi=None, bits=None):
        """Enable/disable debug overlays on decoded output
        (TH_DECCTL_SET_TELEMETRY_{MBMODE,MV,QI,BITS} analogue)."""
        for k, v in (("mbmode", mbmode), ("mv", mv), ("qi", qi),
                     ("bits", bits)):
            if v is not None:
                self.telemetry[k] = int(v)

    def _filter_and_deliver_striped(self, self_frame, coded, flimit):
        """Loop-filter the frame in superblock-row stripes, firing the
        striped-decode callback as rows become final mid-decode
        (decode.c:2858-2943, th_stripe_decoded_func theoradec.h:110-141).

        Callback arguments match the reference exactly: (ycbcr, yfrag0,
        yfrag_end) delivers luma fragment rows [yfrag0, yfrag_end) of the
        display-oriented frame; frames decode bottom-to-top in display
        coordinates (our buffers, like the reference's, store the image
        flipped), so yfrag0 decreases to 0 across calls, at which point
        the frame is complete. When chroma is vertically subsampled both
        bounds are even. The ycbcr buffer is a live view: rows outside
        the union of delivered ranges are not yet final.

        The filter itself is the whole-row vectorized kernel restricted
        to the stripe's fragment rows -- splitting the sequential outer
        row loop preserves bit-exactness; availability lags one fragment
        row behind filtering per the VP3 edge order (a row's bottom
        pixels are final only once the next row's top-edge filters have
        fired)."""
        g = self.geometry
        nvy = g.planes[0].nvfrags
        bv = build_bounding_values(flimit) if flimit else None
        cms = []
        views = []
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            cms.append(coded[sl].reshape(pl.nvfrags, pl.nhfrags))
            vpad, hpad = g.plane_padding(pli)
            h, w = g.plane_shape(pli)
            p = self_frame.planes[pli][vpad : vpad + h, hpad : hpad + w]
            views.append(p[::-1])
        shift = [0] + [1 if g.planes[1].nvfrags < nvy else 0] * 2
        done = [0, 0, 0]
        delivered = 0
        for y1 in range(4, nvy + 4, 4):
            y1 = min(y1, nvy)
            avail = nvy
            for pli in range(3):
                pl = g.planes[pli]
                r1 = min(y1 >> shift[pli], pl.nvfrags)
                if bv is not None and r1 > done[pli]:
                    loop_filter_plane_vec(
                        self_frame.planes[pli], cms[pli], bv, done[pli], r1
                    )
                done[pli] = r1
                edelay = 1 if (bv is not None and r1 < pl.nvfrags) else 0
                avail = min(avail, (r1 - edelay) << shift[pli])
            if avail > delivered:
                self.stripe_callback(views, nvy - avail, nvy - delivered)
                delivered = avail

    def ycbcr_out(self):
        """Full-frame planes in display orientation (top-down), like
        th_decode_ycbcr_out (decode.c:2988-2992). Postprocessed planes are
        returned when the postprocessor ran for this frame."""
        out = []
        frame = self._out_frame
        pp = getattr(self, "_pp_planes", None)
        for pli in range(3):
            if pp is not None and pp[pli] is not None:
                out.append(pp[pli][::-1].copy())
                continue
            vpad, hpad = self.geometry.plane_padding(pli)
            h, w = self.geometry.plane_shape(pli)
            p = frame.planes[pli][vpad : vpad + h, hpad : hpad + w]
            out.append(p[::-1].copy())
        if any(self.telemetry.values()) and self._telemetry_state is not None:
            from theora_tpu.decode.telemetry import render_telemetry

            render_telemetry(self.geometry, out, self._telemetry_state,
                             **self.telemetry)
        return out
