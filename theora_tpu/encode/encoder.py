"""Theora encoder (th_encode_* analogue).

Host tier: bitstream packing, token streams, DC prediction.
Compute tier: batched fDCT/quantize (numpy reference ops; JAX/Pallas twins
under theora_tpu/ops/).

The encoder is closed-loop through the decoder: each packed packet is decoded
by an embedded theora_tpu Decoder to produce the reconstructed reference
frames, guaranteeing encoder/decoder state sync by construction (the
reference instead duplicates the reconstruction in the encoder,
analyze.c:667-882).

Reference behavior: lib/encode.c (oc_enc_frame_pack:908-935,
th_encode_ycbcr_in:1640-1784).
"""
from __future__ import annotations

import numpy as np

from theora_tpu.bitio import BitWriter
from theora_tpu.constants import (
    FRAME_NONE,
    FRAME_SELF,
    HUFF_LIST_MAX,
    MODE_INTRA,
    DCT_TOKEN_EXTRA_BITS,
)
from theora_tpu.decode.dcpred import dc_predict_plane_enc
from theora_tpu.decode.decoder import Decoder
from theora_tpu.encode.tokenize import TokenLog
from theora_tpu.geometry import get_geometry
from theora_tpu.headers import (
    SetupInfo,
    pack_comment_header,
    pack_info_header,
    pack_setup_header,
)
from theora_tpu.huffman import Codebook
from theora_tpu.info import INTRA_FRAME, INTER_FRAME, TheoraInfo
from theora_tpu.ops.fdct_np import fdct8x8_batch, quantize_batch
from theora_tpu.quant import dequant_tables_init
from theora_tpu import tables
from theora_tpu.tpkt import Packet

# zzi -> Huffman group (0 DC, 1..4 AC bands; decode.c huff group layout).
_ZZI_GROUP = np.searchsorted(np.asarray(HUFF_LIST_MAX), np.arange(64),
                             side="right")

# Super-block run codes (encode.c:383-388).
_SB_RUN_VAL_MIN = [1, 2, 4, 6, 10, 18, 34, 4130]
_SB_RUN_CODE_PREFIX = [0, 4, 0xC, 0x38, 0xF0, 0x3E0, 0x3F000]
_SB_RUN_CODE_NBITS = [1, 3, 4, 6, 8, 10, 18]

# Block run codes (encode.c:433-441).
_BLOCK_RUN_CODE_NBITS = [2, 2, 3, 3, 4, 4, 6, 6, 6, 6, 7, 7, 7, 7] + [9] * 16
_BLOCK_RUN_CODE_PATTERN = [
    0x000, 0x001, 0x004, 0x005, 0x00C, 0x00D, 0x038,
    0x039, 0x03A, 0x03B, 0x078, 0x079, 0x07A, 0x07B, 0x1F0,
    0x1F1, 0x1F2, 0x1F3, 0x1F4, 0x1F5, 0x1F6, 0x1F7, 0x1F8,
    0x1F9, 0x1FA, 0x1FB, 0x1FC, 0x1FD, 0x1FE, 0x1FF,
]


def sb_run_pack(bw: BitWriter, run: int, flag: int, done: bool) -> None:
    """(encode.c:405-421)"""
    if run >= 4129:
        while run >= 4129:
            bw.write(0x3FFFF, 18)
            run -= 4129
            if run > 0:
                bw.write(flag, 1)
            elif not done:
                bw.write(0 if flag else 1, 1)
        if run <= 0:
            return
    i = 0
    while run >= _SB_RUN_VAL_MIN[i + 1]:
        i += 1
    bw.write(_SB_RUN_CODE_PREFIX[i] + run - _SB_RUN_VAL_MIN[i], _SB_RUN_CODE_NBITS[i])


def block_run_pack(bw: BitWriter, run: int) -> None:
    bw.write(_BLOCK_RUN_CODE_PATTERN[run - 1], _BLOCK_RUN_CODE_NBITS[run - 1])


def _book_to_codes(book: Codebook, n: int) -> list[tuple[int, int]]:
    per = [(0, 0)] * n
    for t, p, nb in book.codes:
        if per[t] == (0, 0):
            per[t] = (p, nb)
    return per


class Encoder:
    """Theora encoder; v1 supports intra frames and basic inter coding."""

    def __init__(
        self,
        info: TheoraInfo,
        qinfo: dict | None = None,
        huff_codes: list[list[tuple[int, int]]] | None = None,
    ):
        info.validate()
        self.info = info
        self.qinfo = qinfo if qinfo is not None else tables.DEF_QUANT_INFO
        self.huff_codes = (
            huff_codes if huff_codes is not None else tables.VP31_HUFF_CODES
        )
        self.geometry = get_geometry(
            info.frame_width, info.frame_height, int(info.pixel_fmt)
        )
        self.dequant = dequant_tables_init(self.qinfo)
        # Embedded decoder for closed-loop reconstruction.
        books = [Codebook([(t, p, n) for t, (p, n) in enumerate(tb)])
                 for tb in self.huff_codes]
        self._setup = SetupInfo(qinfo=self.qinfo, codebooks=books)
        self._dec = Decoder(info, self._setup)
        self.qi = max(0, min(63, info.quality))
        # R/D-aware quantization (the trellis-lite pass); strength scales
        # the lambda.
        self.rd_quant = True
        self.rd_strength = 3.0
        # Skip-decision lambda multiplier on top of rd_strength*4.
        # Swept on smooth/textured/noise content (round 2): 2.5 RD-
        # dominates 1.0 at every qi and closes the q40 equal-PSNR gap
        # vs the reference (30503 vs ref 30835 bytes at +0.03 dB).
        self.skip_lambda_scale = 2.5
        # Reference-style coupled mode/skip rollback (analyze.c:859-882,
        # 933-956): implemented in _coupled_transform_skip, default OFF --
        # measured RD-negative in this architecture at every lambda tried
        # (the aggressive NOMV skip above already harvests the economy).
        self.coupled_skip = False
        # Viterbi trellis tokenizer with exact Huffman bit costs
        # (tokenize.c:457-744 analogue); supersedes rd_quant on
        # single-qi frames.
        self.use_trellis = True
        # Speed level (OC_SP_LEVEL_*, encint.h:216-227): 0 = everything,
        # 1 = early skip, 2 = fast analysis (no trellis, no 4MV, single
        # quantizer), 3 = plain quantizer, 4 = no motion compensation.
        # Set via set_splevel(); default 0 (the reference defaults to 1,
        # encode.c:1208 -- we default to best quality since the host tier
        # already matches the reference's speed there).
        self.sp_level = 0
        # AC Huffman table indices chosen when packing the previous frame
        # of each type ([ftype][y,c]); the trellis' cost model
        # (encode.c:838-858 carry).
        self._huff_pred = [[0, 0], [0, 0]]
        self._nb_cache = {}
        self._cur_fti = 0
        # R-D metrics collection (collect.c analogue): when set to a list,
        # every coded fragment appends (qi, pli, qti, satd, bits, ssd).
        self.collect = None
        # SATD + fitted-table mode decision (modedec analogue; requires
        # generated modedec_tables).  Off by default -- closed question,
        # after a full bisection: after fixing the
        # missing skip coupling, a 16x distortion-domain bug, the SATD
        # bin blindness below 512 (log-spaced edges now), the greedy
        # chain-seeding failure (multi-level walks, cheapest full-price
        # plan), and one step of policy iteration on the training data,
        # mode_rd ties or beats the SAD+bias policy on synthetic and
        # held-out synthetic content (-0.2%..-3.1% at equal PSNR) but
        # still loses 15-37% on held-out natural content at every qi and
        # every rate scale: a per-block (satd -> rate, rmse) regression
        # cannot see the cross-block token-run/skip economy that
        # dominates natural content.  Kept for study + collect tooling.
        self.mode_rd = False
        # Rate-aggressiveness multiplier on the mode-decision lambda
        # (the reference's OC_BIT_SCALE convention makes its mode costs
        # ~16x more rate-aggressive than our trellis-lambda units;
        # swept empirically).
        self.mode_rd_rate_scale = 1.0
        # MV-bit discount levels tried when scoring MV-bearing modes
        # (chain-seeding value of the last-MV predictor): one greedy
        # walk per level, cheapest full-price plan wins.  See
        # _mode_decide_rd.
        self.mode_rd_seed_levels = (1.0, 0.25, 0.0)
        self._trellis_scan = None
        # Device-precomputed (dct, qdct) per plane (TpuBatchIntraEncoder).
        self._precomputed_tq = None
        # Entropy-free closed-loop reconstruction (the reference's
        # encoder-side recon, analyze.c:667-882): byte-identical to
        # decoding the packet.  "auto" engages it for INTRA frames only
        # -- there it skips the token re-decode (~25% of all-intra
        # encode: 13.0 -> 14.9 Mpix/s measured) while for inter frames
        # the C++ full decode still beats the Python-side MC recon
        # (16.8 vs 14.4).  True forces it everywhere, False never.
        self.fast_recon: bool | str = "auto"
        self._recon_state = None
        # Adaptive quantization: 3-qi frames, reference-spec quantizer
        # triple (log_qavg -0.6/+0.7 clusters, rate.c:175-201 -- see
        # _adaptive_qi_triple), per-block qii by exact trellis R/D.
        # Default "auto": ON in the quality-saturation region
        # (log_qavg below ~4.8 inter / ~4.0 intra, i.e. the high-qi
        # range), where it rescues
        # exactly the failure the round-3 sweep exposed -- dense
        # texture at q56 is +3.7 dB at equal qi, a point the single-qi
        # ladder cannot reach at ANY byte count -- and OFF below, where
        # it measured PSNR-neutral-to-negative while costing ~2x
        # encode throughput.  True forces masking at every qi (the
        # reference's default, perceptually motivated); False disables.
        # Gated off under vp3_compatible, sp_level >= 2, and
        # log_qavg >= 7 (low rates), as in the reference.
        self.adaptive_quant = "auto"
        # Estimate-first qii margin (bits): with a float value, FINER
        # quantizer rows run the exact trellis only on blocks whose
        # cheap-model cost (th_quantize_estimate) lands within this
        # many lambda-bits of beating the base row.  Default None =
        # exact everywhere: measured at CIF scale the estimator costs
        # about as much as the trellis it tries to avoid (both are
        # 64-coefficient walks), so the exact path -- already cut from
        # ~2.1x to 1.5-1.8x of single-qi by the threaded native
        # batches -- stays ahead.
        self.aq_estimate_margin: float | None = None
        # Lambda multiplier for the per-block qii R/D chooser.  1.0 =
        # the frame's trellis lambda (reference-coherent).  Swept round
        # 3: 0.25 lifts iid-noise content above the single-qi RD curve
        # but overshoots (RD-negative) on textured/real content; 1.0
        # wins where it matters and stays on-curve elsewhere.
        self.aq_lambda_scale = 1.0
        # VP3 compatibility: explicit drop-frame packets instead of 0-byte
        # dups (encode.c:865-906); pair with VP31 quant/Huffman tables for
        # full compatibility.
        self.vp3_compatible = False
        # CBR rate control when a target bitrate is configured.
        self.rc = None
        self.curframe_num = -1
        self.keyframe_num = 0
        self.packetno = 0
        self.keyframe_freq = 64
        self._frames_since_keyframe = -1
        self.granpos = -1
        self._prev_orig = None
        self._gold_orig = None
        # Scene-cut fallback: re-encode an inter frame as a keyframe when
        # it comes out bigger than the last keyframe (the frame-level
        # intra-vs-inter comparison of analyze.c:2690-2711).
        self.auto_keyframe = True
        self._last_kf_size = 0
        self._frag_mv4 = np.zeros((self.geometry.nfrags, 2), dtype=np.int32)
        # Native token packer (C++ tier); None -> pure-Python path.
        self._packer = None
        try:
            from theora_tpu.native import NativeTokenPacker

            self._packer = NativeTokenPacker(self.huff_codes)
        except Exception:
            self._packer = None

    # ------------------------------------------------------------------
    def _pack_tokens(self, bw: BitWriter, vecs_by_plane, ftype) -> bytes:
        """Tokenize + pack the residual section after the prefix in `bw`.

        vecs_by_plane: per-plane [n, 64] int16 zig-zag coefficient vectors
        (DC residual at slot 0) in coded order. Returns the full packet.
        """
        ncoded = [len(v) for v in vecs_by_plane]
        if self._trellis_scan is not None:
            return self._pack_tokens_trellis(bw, vecs_by_plane, ftype)
        if self._packer is not None:
            vecs = (
                np.concatenate(vecs_by_plane)
                if sum(ncoded)
                else np.zeros((0, 64), np.int16)
            )
            return self._packer.pack_frame(
                vecs.astype(np.int16), ncoded, bw.bytes(), bw.bitpos
            )
        log = TokenLog()
        for pli in range(3):
            for vec in vecs_by_plane[pli]:
                log.tokenize_block(pli, vec)
        log.finish()
        self._residual_tokens_pack(bw, log, ftype)
        return bw.bytes()

    # ------------------------------------------------------------------
    def _pack_tokens_trellis(self, bw: BitWriter, vecs_by_plane, ftype):
        """Emit the cached trellis plans (computed in _transform_quantize)
        and pack; stores the chosen AC Huffman indices for the next
        frame\'s cost model (encode.c:838-858)."""
        fti = 0 if ftype == INTRA_FRAME else 1
        if self._packer is not None and all(
            isinstance(p, tuple) for p in self._trellis_scan
        ):
            pkt, chosen = self._packer.pack_frame_trellis_perm(
                [p[0] for p in self._trellis_scan],
                [p[1] for p in self._trellis_scan],
                [p[2] for p in self._trellis_scan],
                bw.bytes(), bw.bitpos,
            )
            self._huff_pred[fti] = chosen[2:]
            return pkt
        log = TokenLog()
        for pli in range(3):
            plans = self._trellis_scan[pli]
            vecs = vecs_by_plane[pli]
            if isinstance(plans, tuple):
                paths, perm, dc_scan = plans
                for bi in range(len(perm)):
                    log.emit_trellis(
                        pli, int(dc_scan[bi]), paths[perm[bi]]
                    )
            else:
                for bi in range(len(vecs)):
                    log.emit_trellis(pli, int(vecs[bi][0]), plans[bi])
        log.finish()
        self._huff_pred[fti] = self._residual_tokens_pack(bw, log, ftype)
        return bw.bytes()

    # ------------------------------------------------------------------
    def flush_headers(self) -> list[Packet]:
        pkts = [
            Packet(pack_info_header(self.info), b_o_s=True, granulepos=0,
                   packetno=0),
            Packet(pack_comment_header(), granulepos=0, packetno=1),
            Packet(pack_setup_header(self.qinfo, self.huff_codes),
                   granulepos=0, packetno=2),
        ]
        self.packetno = 3
        return pkts

    # ------------------------------------------------------------------
    def set_splevel(self, lvl: int) -> None:
        """Map a speed level onto the R/D- and search-effort knobs
        (TH_ENCCTL_SET_SPLEVEL; reference semantics encint.h:216-227,
        gates in analyze.c:709,782,2392-2430 and mcenc.c:506).

        0: full trellis + R/D quantizer + full-/half-pel ME + 4MV.
        1: + early skip (blocks whose uncoded SSD can't beat any coded
           version bypass transform/tokenize).
        2: fast analysis: heuristic R/D quantizer instead of the trellis,
           no 4MV search, single quantizer.
        3: plain round-to-nearest quantizer.
        4: no motion compensation (MV modes priced out; no search)."""
        if not 0 <= lvl <= 4:
            raise ValueError("speed level out of range")
        self.sp_level = lvl
        self.use_trellis = lvl < 2
        self.rd_quant = lvl < 3

    # ------------------------------------------------------------------
    def encode_frame(self, ycbcr: list[np.ndarray], e_o_s: bool = False) -> Packet:
        """Encode one frame (display-orientation planes) -> Packet."""
        self.curframe_num += 1
        self._frames_since_keyframe += 1
        self._recon_state = None
        self._recon_done = False
        # Rate control: lazy init.
        if self.info.target_bitrate > 0 and self.rc is None:
            from theora_tpu.encode.rate import RateControl

            self.rc = RateControl(self.info, self.dequant, self.keyframe_freq)
        is_key = (
            self._prev_orig is None
            or self._frames_since_keyframe >= self.keyframe_freq
        )
        if self.rc is not None and self.rc.twopass == 2:
            # Pass 2 replays pass 1's keyframe positions
            # (rc.twopass_force_kf; encode.c:1753-1764).
            is_key = self._prev_orig is None or self.rc.twopass_force_kf
        if is_key:
            self._frames_since_keyframe = 0
        # Flip to bitstream orientation.
        planes = [p[::-1].astype(np.uint8) for p in ycbcr]
        if self.rc is not None:
            ftype = 0 if is_key else 1
            self.qi = self.rc.select_qi(
                ftype, self.qi,
                frames_since_kf=self._frames_since_keyframe,
            )
        if self.collect is not None:
            self._satd_frame = np.zeros(self.geometry.nfrags, dtype=np.int64)
            self._qti_frame = np.zeros(self.geometry.nfrags, dtype=np.int32)
            self._dec.want_frag_bits = True
        if is_key:
            # GOP-local trellis cost-model state so GOP-parallel encoding
            # is byte-identical to sequential.
            self._huff_pred = [[0, 0], [0, 0]]
            data = self._encode_intra(planes)
            self.keyframe_num = self.curframe_num
        else:
            # Snapshot the embedded decoder's bookkeeping: the inter
            # path may reconstruct EARLY (overlapped under the C++
            # pack, _finish_inter), and if the auto-keyframe retry then
            # replaces the frame with an intra encode, the counters and
            # ref rotation must rewind first (buffer CONTENTS need no
            # rewind -- the intra recon overwrites whole planes and
            # rotates both refs onto its own slot).
            dsnap = (
                self._dec.curframe_num, self._dec.keyframe_num,
                self._dec.granpos, list(self._dec.ref_idx),
            )
            data = self._encode_inter(planes)
            if (
                self.auto_keyframe
                and self._last_kf_size
                and len(data) >= self._last_kf_size
            ):
                if getattr(self, "_recon_done", False):
                    (self._dec.curframe_num, self._dec.keyframe_num,
                     self._dec.granpos) = dsnap[:3]
                    self._dec.ref_idx[:] = dsnap[3]
                    self._recon_done = False
                is_key = True
                self._frames_since_keyframe = 0
                self._huff_pred = [[0, 0], [0, 0]]
                data = self._encode_intra(planes)
                self.keyframe_num = self.curframe_num
        dropped = False
        if self.rc is not None:
            # Post-encode drop decision: a frame that busts the budget
            # is replaced by a 0-byte dup (or an explicit VP3 drop
            # packet) and the decoded reference frames stay put
            # (rate.c:825-832, encode.c:1259-1271).
            dropped = self.rc.update(
                0 if is_key else 1, self.qi, len(data) * 8,
                droppable=not is_key,
            )
            if dropped:
                data = (
                    self._drop_frame_pack() if self.vp3_compatible else b""
                )
                self._recon_state = None
        if is_key and not dropped:
            self._last_kf_size = len(data)
        # Track original frames for motion estimation (the *_ORIG refs,
        # mcenc.c:314-316).
        self._prev_orig = planes
        if is_key:
            self._gold_orig = planes
        # Feed the packet through the embedded decoder to update refs --
        # via the entropy-free fast path when the trellis state allows.
        rs = getattr(self, "_recon_state", None)
        if getattr(self, "_recon_done", False):
            # _encode_intra already reconstructed, overlapped with the
            # bit-pack; nothing left to feed through.
            self._recon_done = False
        elif rs is not None and len(data) and self.collect is None:
            self._dec.reconstruct_from_state(*rs)
            self._recon_state = None
        else:
            self._dec.decode_packet(data)
        if self.collect is not None and len(data):
            self._collect_frame_metrics(planes)
        shift = self.info.keyframe_granule_shift
        self.granpos = ((self.keyframe_num + 1) << shift) + (
            self.curframe_num - self.keyframe_num
        )
        pkt = Packet(
            data,
            granulepos=self.granpos,
            packetno=self.packetno,
            e_o_s=e_o_s,
        )
        self.packetno += 1
        # Structured per-frame metrics (the observability the reference
        # lacks; SURVEY.md section 5).
        self.last_frame_metrics = {
            "frame": self.curframe_num,
            "keyframe": bool(is_key),
            "qi": self.qi,
            "qis": list(self.frame_qis),
            "bytes": len(data),
            "granulepos": self.granpos,
            "reservoir": self.rc.fullness if self.rc else None,
        }
        return pkt

    # ------------------------------------------------------------------
    def _drop_frame_pack(self) -> bytes:
        """Explicit drop frame: an inter frame with no coded blocks
        (encode.c:875-906)."""
        g = self.geometry
        bw = BitWriter()
        bw.write(0, 1)
        bw.write(1, 1)  # inter
        bw.write(self.qi, 6)
        bw.write(0, 1)
        # No partially coded SBs, then no fully coded SBs.
        bw.write(0, 1)
        sb_run_pack(bw, g.nsbs, 0, True)
        bw.write(0, 1)
        sb_run_pack(bw, g.nsbs, 0, True)
        # Mode scheme 7 (no modes to code), MV scheme 1.
        bw.write(7, 3)
        bw.write(1, 1)
        # DC and AC Huffman table choices (unused; no tokens follow).
        for _ in range(4):
            bw.write(0, 4)
        return bw.bytes()

    # ------------------------------------------------------------------
    def _frame_header_pack(self, bw: BitWriter, frame_type: int, qis) -> None:
        bw.write(0, 1)
        bw.write(frame_type, 1)
        bw.write(qis[0], 6)
        if len(qis) > 1:
            bw.write(1, 1)
            bw.write(qis[1], 6)
            if len(qis) > 2:
                bw.write(1, 1)
                bw.write(qis[2], 6)
            else:
                bw.write(0, 1)
        else:
            bw.write(0, 1)
        if frame_type == INTRA_FRAME:
            bw.write(0, 3)

    # ------------------------------------------------------------------
    def _transform_quantize(self, planes, coded, frag_refi, residual_fn,
                            frag_qii=None):
        """fDCT + quantize all coded fragments; returns per-plane qdct
        arrays in scan layout plus the DC-residual token vectors.

        residual_fn(pli, fragis) -> [n, 8, 8] int16 residual blocks.
        frag_qii: optional [nfrags] qi-index per fragment (adaptive quant);
        the DC coefficient always quantizes with qis[0] (matching the
        decoder's dc_quant, decode.c:1530).
        """
        g = self.geometry
        qis = self.frame_qis
        out = {}
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            coded_pl = coded[sl]
            fragis = np.where(coded_pl)[0] + pl.froffset
            if len(fragis) == 0:
                out[pli] = (
                    fragis, np.zeros((0, 64), np.int32),
                    np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros((0, 64), np.int16), np.zeros(0, np.int32),
                ) + ((np.zeros((0, 66, 4), np.int16),
                      np.zeros(0, np.int64))
                     if self.use_trellis and len(qis) == 1 else ())
                continue
            res = residual_fn(pli, fragis)
            qti = (frag_refi[fragis] != FRAME_SELF).astype(np.int32)
            if self.collect is not None and len(fragis):
                from theora_tpu.native import hadamard_batch_native

                satd, _dcv = hadamard_batch_native(np.asarray(res))
                self._satd_frame[fragis] = satd
                self._qti_frame[fragis] = qti
            # The trellis tokenizer replaces the heuristic R/D quantizer:
            # quantize round-to-nearest here and keep the raw DCT around.
            # Multi-qi frames choose each block's qii by exact trellis cost
            # (the activity-masking analogue, decided by R/D instead of a
            # variance heuristic).
            trellis = self.use_trellis
            rd_qii = trellis and len(qis) > 1 and getattr(
                self, "_frag_qii_rd", None
            ) is not None
            if rd_qii:
                try:
                    out[pli] = self._tq_trellis_multi_qi(
                        pli, fragis, res, qti, qis
                    )
                    continue
                except (ImportError, RuntimeError):
                    trellis = False
            # Fast path: single-qi frames via the C++ tier.
            if len(qis) == 1:
                pre = getattr(self, "_precomputed_tq", None)
                if trellis and pre is not None and pre.get(pli) is not None:
                    # Device-computed fDCT + quantize (TpuBatchIntraEncoder):
                    # raster block order == fragis order on intra frames.
                    local = fragis - pl.froffset
                    dct16 = np.ascontiguousarray(pre[pli][0][local])
                    qdct = pre[pli][1][local].astype(np.int32)
                    err2 = np.zeros(len(fragis), dtype=np.int64)
                    res2 = (
                        (res.astype(np.int64) ** 2)
                        .reshape(len(fragis), -1)
                        .sum(axis=1)
                        * 16
                    )
                    paths, acbits = self._trellis_plan_blocks(
                        pli, qdct, dct16, qti, err2
                    )
                    out[pli] = (
                        fragis, qdct, err2, res2, dct16, qti, paths, acbits,
                    )
                    continue
                try:
                    from theora_tpu.native import fdct_quantize_rd_native
                    from theora_tpu.ops.fdct_np import rd_lambda

                    qdct = np.empty((len(fragis), 64), dtype=np.int32)
                    err2 = np.zeros(len(fragis), dtype=np.int64)
                    res2 = np.zeros(len(fragis), dtype=np.int64)
                    dct16 = (
                        np.empty((len(fragis), 64), dtype=np.int16)
                        if trellis
                        else None
                    )
                    for t in (0, 1):
                        m = qti == t
                        if not m.any():
                            continue
                        dq = self.dequant[qis[0], pli, t]
                        lam = (
                            rd_lambda(qis[0], int(dq[1])) * self.rd_strength
                        )
                        if trellis:
                            qz, e2, r2, dc16 = fdct_quantize_rd_native(
                                res[m], dq, lam, rd=False, want_dct=True
                            )
                            dct16[m] = dc16
                        else:
                            qz, e2, r2 = fdct_quantize_rd_native(
                                res[m], dq, lam, rd=self.rd_quant
                            )
                        qdct[m] = qz
                        err2[m] = e2
                        res2[m] = r2
                    if trellis:
                        paths, acbits = self._trellis_plan_blocks(
                            pli, qdct, dct16, qti, err2
                        )
                        out[pli] = (
                            fragis, qdct, err2, res2, dct16, qti,
                            paths, acbits,
                        )
                    else:
                        out[pli] = (fragis, qdct, err2, res2, dct16, qti)
                    continue
                except (ImportError, RuntimeError):
                    pass
            dct = fdct8x8_batch(res)
            qiis = (
                frag_qii[fragis]
                if frag_qii is not None
                else np.zeros(len(fragis), np.int32)
            )
            qdct = np.empty_like(dct)
            err2 = np.zeros(len(fragis), dtype=np.int64)
            for t in (0, 1):
                for qii in range(len(qis)):
                    m = (qti == t) & (qiis == qii)
                    if not m.any():
                        continue
                    dq = self.dequant[qis[qii], pli, t]
                    if self.rd_quant and not trellis:
                        from theora_tpu.ops.fdct_np import (
                            quantize_rd_batch,
                            rd_lambda,
                        )

                        lam = rd_lambda(qis[qii], int(dq[1])) * self.rd_strength
                        qdct[m] = quantize_rd_batch(dct[m], dq, lam)
                    else:
                        qdct[m] = quantize_batch(dct[m], dq)
                # DC always uses qis[0]'s quantizer.
                m = qti == t
                if m.any() and len(qis) > 1:
                    dq0 = self.dequant[qis[0], pli, t]
                    qdct[m, 0] = quantize_batch(
                        dct[m][:, :1], dq0[:1]
                    ).reshape(-1)
            # Coefficient-domain coding error (for R/D skip decisions).
            for t in (0, 1):
                for qii in range(len(qis)):
                    m = (qti == t) & (qiis == qii)
                    if not m.any():
                        continue
                    dq = self.dequant[qis[qii], pli, t].astype(np.int64)
                    d = dct[m].astype(np.int64) - qdct[m].astype(np.int64) * dq
                    err2[m] = (d * d).sum(axis=1)
            # Squared pixel-domain residual, scaled into DCT units
            # (the transform is x4 orthonormal => energies scale by 16).
            res2 = (res.astype(np.int64) ** 2).reshape(len(fragis), -1).sum(
                axis=1
            ) * 16
            if trellis:
                dct16 = dct.astype(np.int16)
                paths, acbits = self._trellis_plan_blocks(
                    pli, qdct, dct16, qti, err2
                )
                out[pli] = (
                    fragis, qdct, err2, res2, dct16, qti, paths, acbits,
                )
            else:
                out[pli] = (fragis, qdct, err2, res2, None, qti)
        return out

    # ------------------------------------------------------------------
    def _tq_trellis_multi_qi(self, pli, fragis, res, qti, qis):
        """fDCT once, then per-qii quantize + trellis plan; choose each
        block\'s qii by exact R/D cost (cost = err2 + lambda*(acbits +
        signaling)). DC always quantizes with qis[0] (decoder semantics,
        decode.c:1530)."""
        from theora_tpu.native import (
            fdct_quantize_rd_native,
            trellis_plan_blocks_native,
        )

        n = len(fragis)
        fti = self._cur_fti
        fmt = int(self.info.pixel_fmt)
        lam = (
            tables.RD_LAMBDA.get(fmt, tables.RD_LAMBDA[0])[fti][qis[0]]
            * getattr(self, "_aq_scale_frame", self.aq_lambda_scale)
        )
        # Per-block chooser lambda: on mixed frames the activity iscale
        # modulates WHERE the triple spends (busy blocks -> larger
        # lambda -> coarser row; calm blocks -> smaller -> finer), the
        # reference's rd_iscale role in its qii selection
        # (analyze.c:1415-1560).  The trellis itself keeps the frame
        # lambda; only the row CHOICE is masked.
        scale = getattr(self, "_frag_lam_scale", None)
        lam_b = lam * scale[fragis] if scale is not None else lam
        nbt = self._nb_table(pli, fti)
        res_a = np.asarray(res)
        # Base row (qis[0]): exact trellis for every block -- this is
        # the single tokenization the frame pays regardless.
        qdct0 = np.empty((n, 64), dtype=np.int16)
        dct16 = np.empty((n, 64), dtype=np.int16)
        for t in (0, 1):
            m = qti == t
            if not m.any():
                continue
            dq = self.dequant[qis[0], pli, t]
            qz, _e2, _r2, dc16 = fdct_quantize_rd_native(
                res_a[m], dq, 0.0, rd=False, want_dct=True
            )
            qdct0[m] = qz
            dct16[m] = dc16
        dq0r = self.dequant[qis[0], pli, 0].astype(np.int64)
        dq1r = self.dequant[qis[0], pli, 1].astype(np.int64)
        paths0, acbits0, err20 = trellis_plan_blocks_native(
            dct16, qdct0, dq0r, dq1r, qti, lam_b, nbt
        )
        qdcts = [qdct0]
        pathss = [paths0]
        acbitss = [acbits0]
        err2s = [err20]
        # Extra rows.  FINER rows (qi > qis[0]) go estimate-first /
        # exact-confirm (the reference's shape: qii from estimates, one
        # tokenization -- analyze.c qii flow + rate.c:175-201): the
        # cheap model (R/D-swept quantize + greedy tokenization,
        # th_quantize_estimate) predicts the finer row's exact decision
        # with corr ~0.99 / +-6-bit bias on textured saturation content
        # (measured), so the exact trellis runs only on blocks whose
        # estimate lands within aq_estimate_margin bits of winning --
        # the blocks that switch rows and need token paths anyway.
        # COARSER rows stay exact: their decision balances large bit
        # savings against large error increases and the cheap model
        # carries almost no signal there (corr ~0.2 measured) -- an
        # estimate-steered coarser row silently destroys the masking
        # gain.  Pruning (stage 1) applies to both: a coarser row only
        # wins by saving bits (base plans spending <= 1 AC bit are
        # out); a finer row only wins by cutting error (base error <=
        # lambda is out).
        from theora_tpu.ops.fdct_np import quantize_batch

        margin = getattr(self, "aq_estimate_margin", 8.0)
        big = np.int64(1) << 62
        for qii in range(1, len(qis)):
            qi = qis[qii]
            finer = qi > qis[0]
            cand = err20 > lam_b if finer else acbits0 > 1
            idx = np.nonzero(cand)[0]
            qdct = qdct0.copy()
            paths = paths0.copy()
            acb = acbits0.copy()
            err = np.full(n, big, np.int64)
            if len(idx) and finer and margin is not None:
                # Estimate pass -> shrink idx to likely winners.
                from theora_tpu.native import quantize_estimate_native

                d16 = np.ascontiguousarray(dct16[idx])
                qtis = np.ascontiguousarray(qti[idx])
                ni = len(idx)
                bits_r = np.empty(ni, dtype=np.int64)
                err_r = np.empty(ni, dtype=np.int64)
                bits_b = np.empty(ni, dtype=np.int64)
                for t in (0, 1):
                    m = qtis == t
                    if not m.any():
                        continue
                    dq_r = self.dequant[qi, pli, t].astype(np.int32)
                    dq_b = self.dequant[qis[0], pli, t].astype(np.int32)
                    dq0_dc = int(dq_b[0])
                    _, b_, e_ = quantize_estimate_native(
                        d16[m], dq_r, dq0_dc, lam, nbt
                    )
                    bits_r[m], err_r[m] = b_, e_
                    _, bb_, _ = quantize_estimate_native(
                        d16[m], dq_b, dq0_dc, lam, nbt
                    )
                    bits_b[m] = bb_
                # Model bits anchored to the base row's exact bits (the
                # greedy-vs-trellis gap cancels between rows; measured
                # +6-bit residual bias, corr 0.99 for finer rows).
                est_bits = acbits0[idx] + (bits_r - bits_b)
                dcost = (
                    err_r
                    + (lam * (est_bits + 1.0)).astype(np.int64)
                ) - (err20[idx] + (lam * acbits0[idx]).astype(np.int64))
                idx = idx[dcost < lam * float(margin)]
            if len(idx):
                d16c = np.ascontiguousarray(dct16[idx])
                qtis = np.ascontiguousarray(qti[idx])
                qsub = np.empty((len(idx), 64), dtype=np.int16)
                for t in (0, 1):
                    m = qtis == t
                    if not m.any():
                        continue
                    dq = self.dequant[qi, pli, t].astype(np.int64)
                    qsub[m] = quantize_batch(
                        d16c[m].astype(np.int64), dq
                    ).astype(np.int16)
                    # DC re-quantizes with qis[0] for every qii.
                    dq0 = self.dequant[qis[0], pli, t].astype(np.int64)
                    qsub[m, 0] = quantize_batch(
                        d16c[m][:, :1].astype(np.int64), dq0[:1]
                    ).reshape(-1).astype(np.int16)
                p_s, a_s, e_s = trellis_plan_blocks_native(
                    d16c, qsub,
                    self.dequant[qi, pli, 0].astype(np.int64),
                    self.dequant[qi, pli, 1].astype(np.int64),
                    qtis,
                    lam_b[idx] if isinstance(lam_b, np.ndarray) else lam,
                    nbt,
                )
                qdct[idx] = qsub
                paths[idx] = p_s
                acb[idx] = a_s
                err[idx] = e_s
            qdcts.append(qdct)
            pathss.append(paths)
            acbitss.append(acb)
            err2s.append(err)
        # Per-block qii by R/D (qii signaling ~1 bit for base, ~2 others).
        sig = np.array([1.0, 2.0, 2.0])
        costs = np.stack(
            [
                err2s[q] + (lam_b * (acbitss[q] + sig[q])).astype(np.int64)
                for q in range(len(qis))
            ]
        )
        best = np.argmin(costs, axis=0).astype(np.int32)
        rows = np.arange(n)
        qdct = np.stack(qdcts)[best, rows].astype(np.int32)
        paths = np.stack(pathss)[best, rows]
        acbits = np.stack(acbitss)[best, rows]
        err2 = np.stack(err2s)[best, rows]
        self._frag_qii_rd[fragis] = best
        res2 = (res_a.astype(np.int64) ** 2).reshape(n, -1).sum(axis=1) * 16
        return (fragis, qdct, err2, res2, dct16, qti, paths, acbits)

    def _nb_table(self, pli, fti):
        key = (fti, "nbt", self._huff_pred[fti][(pli + 1) >> 1],
               (pli + 1) >> 1)
        nbt = self._nb_cache.get(key)
        if nbt is None:
            idx = self._huff_pred[fti][(pli + 1) >> 1]
            nbt = np.zeros((5, 32), dtype=np.int64)
            for gi in range(5):
                for t in range(32):
                    nbt[gi, t] = (
                        self.huff_codes[(gi << 4) + idx][t][1]
                        + DCT_TOKEN_EXTRA_BITS[t]
                    )
            self._nb_cache[key] = nbt
        return nbt

    # ------------------------------------------------------------------
    def _trellis_nb(self, pli, fti):
        """Per-(zzi-group, token) bit-cost closure for the trellis, using
        the AC Huffman indices chosen for the previous frame of this type
        (encode.c:838-858 carry)."""
        key = (fti, (pli + 1) >> 1, self._huff_pred[fti][(pli + 1) >> 1])
        tab = self._nb_cache.get(key)
        if tab is None:
            idx = key[2]
            tab = np.zeros((5, 32), dtype=np.int64)
            for gi in range(5):
                for t in range(32):
                    tab[gi, t] = (
                        self.huff_codes[(gi << 4) + idx][t][1]
                        + DCT_TOKEN_EXTRA_BITS[t]
                    )
            self._nb_cache[key] = tab
        zg = _ZZI_GROUP

        def nb(zzi, token, _tab=tab, _zg=zg):
            return int(_tab[_zg[zzi], token])

        return nb

    def _trellis_plan_blocks(self, pli, qdct, dct16, qti, err2):
        """Run trellis_plan over every block; rewrites the AC values of
        qdct and err2 in place. Returns (paths, acbits)."""
        from theora_tpu.encode.tokenize import trellis_plan

        fti = self._cur_fti
        fmt = int(self.info.pixel_fmt)
        lam = tables.RD_LAMBDA.get(fmt, tables.RD_LAMBDA[0])[fti][
            self.frame_qis[0]
        ]
        nb = self._trellis_nb(pli, fti)
        qi0 = self.frame_qis[0]
        dq_rows = [
            self.dequant[qi0, pli, 0].astype(np.int64),
            self.dequant[qi0, pli, 1].astype(np.int64),
        ]
        n = len(qdct)
        try:
            from theora_tpu.native import trellis_plan_blocks_native

            key = (fti, "nbt", self._huff_pred[fti][(pli + 1) >> 1],
                   (pli + 1) >> 1)
            nbt = self._nb_cache.get(key)
            if nbt is None:
                idx = self._huff_pred[fti][(pli + 1) >> 1]
                nbt = np.zeros((5, 32), dtype=np.int64)
                for gi in range(5):
                    for t in range(32):
                        nbt[gi, t] = (
                            self.huff_codes[(gi << 4) + idx][t][1]
                            + DCT_TOKEN_EXTRA_BITS[t]
                        )
                self._nb_cache[key] = nbt
            qd16 = np.ascontiguousarray(qdct, dtype=np.int16)
            paths, acbits, e2 = trellis_plan_blocks_native(
                dct16, qd16, dq_rows[0], dq_rows[1], qti, lam, nbt
            )
            qdct[:] = qd16
            err2[:] = e2
            return paths, acbits
        except (ImportError, RuntimeError):
            pass
        paths = [None] * n
        acbits = np.zeros(n, dtype=np.int64)
        dct64 = dct16.astype(np.int64)
        for bi in range(n):
            t = int(qti[bi])
            dq = dq_rows[t]
            path, bits, vals = trellis_plan(
                dct64[bi], qdct[bi], dq, lam, 0 if t else 3, nb
            )
            paths[bi] = path
            acbits[bi] = bits
            row = qdct[bi]
            row[1:] = 0
            for pos, qc in vals:
                row[pos] = qc
        # Coding error with the final values (for R/D skip decisions).
        dq_all = np.stack([dq_rows[int(t)] for t in qti]) if n else \
            np.zeros((0, 64), np.int64)
        d = dct64 - qdct.astype(np.int64) * dq_all
        err2[:] = (d * d).sum(axis=1)
        return paths, acbits

    # ------------------------------------------------------------------
    @property
    def frame_qis(self):
        return getattr(self, "_frame_qis", None) or [self.qi]

    def _adaptive_qi_triple(self, qti):
        """The frame's (base, finer, coarser) quantizer list under the
        reference's masking spec (oc_enc_calc_lambda, rate.c:175-201):
        additional quantizers sit at log_qavg offsets of -0.6 (finer)
        and +0.7 (coarser) base-2 from the base qi's log_qavg -- the
        K-means cluster centers of the R-D optimal block-AC quantizer
        distribution -- selected by nearest log_qavg over the full qi
        range; masking is off entirely when log_qavg >= 7.0 (low
        rates, where greedy qii optimization stops paying).  Returns
        None when masking is inactive.  The round-2 triple used mean
        log-AC-quant with smaller offsets and was far too timid: at
        textured q56 the reference's [56, coarser 46, finer 63] triple
        buys +3.6 dB over a single-qi encode (BASELINE.md round 3)."""
        base = self.qi
        if (
            not self.adaptive_quant
            or self.vp3_compatible
            or self.sp_level >= 2  # FAST_ANALYSIS drops masking (ref)
        ):
            return None
        from theora_tpu.encode.qavg_tables import LOG_QAVG

        fmt = int(self.info.pixel_fmt)
        lqa = LOG_QAVG.get(fmt, LOG_QAVG[0])[qti]
        lq = lqa[base]
        if lq >= 7.0:
            return None
        # "auto": engage only where masking measurably wins.  Two
        # regimes (both adjudicated on PSNR and SSIM, BASELINE round
        # 4): (a) the quality-saturation region -- crossover at
        # log_qavg ~4.78 inter (textured q54: +2.6 dB; q50-52 neutral
        # at 2x cost) / ~3.9 intra (q56 kf-only: +5.1 dB), swept round
        # 3; (b) NOISE-LIKE frames at mid-q, where the reference's
        # default masking lands ~1 dB above our single-qi curve on
        # both metrics (noise q24: ref 31.73 dB / 0.9958 SSIM vs ours
        # 30.68 / 0.9945) -- there the qi triple engages with the
        # cheaper chooser lambda (0.25, swept round 3: above-curve on
        # iid noise, overshoots on structured content) gated by a
        # lag-1 luma autocorrelation test that separates iid noise
        # (ac ~0) from texture (ac ~0.2+) and smooth content
        # (ac ~1.0).
        # Round 5 adds regime (c): spatially MIXED frames (the
        # heterogeneity gate, _mixed_frame) at mid/high quality engage
        # the triple with per-block activity-scaled chooser lambdas
        # (_frag_lam_scale) -- the per-MB masking analogue
        # (analyze.c:1152-1340).  Measured on halfmix CIF: closes the
        # matched-rate SSIM deficit vs the reference (round-5 sweep).
        self._aq_scale_frame = self.aq_lambda_scale
        if self.adaptive_quant == "auto" and lq >= (
            4.0 if qti == 0 else 4.8
        ):
            if getattr(self, "_frame_noise_like", False):
                self._aq_scale_frame = 0.25
            elif (
                getattr(self, "_frame_mixed", False)
                and getattr(self, "_frag_lam_scale", None) is not None
                and lq < (4.7 if qti == 0 else 5.2)
            ):
                # Mixed-frame masking engages at the base lambda, in a
                # window just above saturation (swept on halfmix: wins
                # both metrics rate-matched at q48-56, loses at q32-40
                # where the unmasked encode already dominates).
                pass
            else:
                return None

        def find_qi(target, qi_old):
            best_qi, best_d = 0, abs(lqa[0] - target)
            for qi in range(1, 64):
                d = abs(lqa[qi] - target)
                if d < best_d or (
                    d == best_d and abs(qi - qi_old) < abs(best_qi - qi_old)
                ):
                    best_qi, best_d = qi, d
            return best_qi

        coarser = find_qi(lq + 0.7, max(base - 1, 0))
        finer = find_qi(lq - 0.6, min(base + 1, 63))
        qis = [base]
        if coarser != base:
            qis.append(coarser)
        if finer != base and finer != coarser:
            qis.append(finer)
        if len(qis) < 2:
            return None
        return qis

    @staticmethod
    def _luma_activity(y) -> np.ndarray:
        """Per-8x8-block activity of the luma plane: 64*sum(c^2) -
        (sum c)^2 (= 4096 * variance), flat-clamped exactly like the
        reference (analyze.c:1152-1197: act < 8<<12 is "flat" and
        clamps to 5<<12).  Feeds the per-block masking scales and the
        mixed-frame gate."""
        try:
            from theora_tpu.native import activity8_plane_native

            return activity8_plane_native(y)
        except (ImportError, RuntimeError, OSError):
            pass
        H, W = y.shape
        b = (
            y.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3)
            .reshape(-1, 64).astype(np.int64)
        )
        x = b.sum(axis=1)
        x2 = (b * b).sum(axis=1)
        act = (x2 << 6) - x * x
        flat = act < (8 << 12)
        act[flat] = np.minimum(act[flat], 5 << 12)
        return act

    @staticmethod
    def _mixed_frame(act: np.ndarray, spread_octaves: float = 4.0) -> bool:
        """Is the frame spatially HETEROGENEOUS?  True when the
        p90/p10 spread of per-block log2-activity exceeds
        `spread_octaves` (a 16x activity ratio between the busy and
        calm deciles).  Homogeneous classes (all-smooth, all-texture,
        iid noise) measure ~0-2 octaves; half-smooth/half-texture and
        small-mover-on-flat frames measure 5+ (round-5 sweep corpus).
        Gates the per-MB masking engage so the homogeneous-grid
        defaults are untouched."""
        la = np.log2(np.maximum(act.astype(np.float64), 1.0))
        p10, p90 = np.percentile(la, [10, 90])
        return bool(p90 - p10 > spread_octaves)

    def _activity_iscale(self, act: np.ndarray) -> np.ndarray:
        """Per-luma-fragment lambda scale (the reference's rd_iscale
        analogue, analyze.c:1256-1340): iscale = (4*act + avg) /
        (act + 4*avg), ~0.25 for flat blocks (spend rate on quality
        where distortion is visible) up to ~4 for busy blocks (texture
        masks distortion; prefer saving bits).  Applied as lambda_b =
        lambda * iscale_b in the per-block qii R/D chooser, the
        D + iscale*lambda*R form of D*rd_scale + lambda*R."""
        avg = float(np.mean(act))
        a = act.astype(np.float64)
        sc = (4.0 * a + avg) / (a + 4.0 * avg)
        # Contrast exponent 1.5, swept on halfmix q56 (round 5): at
        # gamma 1.0 the equal-qi SSIM sat 0.0003 under the reference;
        # 1.5 closes it to parity (-12% bytes) without moving the
        # other classes (the gate keeps homogeneous frames out).
        return np.clip(sc ** 1.5, 0.1, 8.0)

    @staticmethod
    def _noise_like(y, thresh: float = 0.10) -> bool:
        """Is the luma plane iid-noise-like?  Lag-1 horizontal
        autocorrelation on subsampled rows: ~0 for iid noise, ~0.2+
        for structured texture, ~1.0 for smooth content (measured on
        the sweep corpus).  Drives the mid-q noise-masking engage in
        _adaptive_qi_triple."""
        ys = y[::4].astype(np.float64)
        yc = ys - ys.mean()
        denom = float((yc * yc).sum())
        if denom < 1e-6:
            return False
        ac = float((yc[:, :-1] * yc[:, 1:]).sum()) / denom
        return ac < thresh

    def _select_adaptive_qis(self, planes, coded):
        """Pick the frame's qi list and a per-fragment qii from luma
        activity -- the activity-masking analogue (rate.c:175-201,
        analyze.c:1152-1300): textured blocks take a coarser quantizer,
        smooth blocks a finer one (with the trellis, the per-block qii
        is chosen by exact R/D instead)."""
        g = self.geometry
        self._frame_noise_like = self._noise_like(planes[0])
        act = self._luma_activity(planes[0])
        self._frame_mixed = self._mixed_frame(act)
        # Per-fragment lambda scales for the qii chooser: luma from its
        # own activity; chroma stays at 1.0 (the chooser's masking
        # lives in luma, where SSIM/HVS weight is).  Only engaged on
        # mixed frames -- homogeneous frames keep the uniform lambda
        # that the 18-point grid adjudicated.
        self._frag_lam_scale = None
        if self._frame_mixed and self.adaptive_quant:
            sc = np.ones(g.nfrags, np.float64)
            sc[: g.planes[0].nfrags] = self._activity_iscale(act)
            self._frag_lam_scale = sc
        qis = self._adaptive_qi_triple(self._cur_fti)
        if qis is None:
            self._frame_qis = None
            return None
        if self.use_trellis:
            # Per-block qii chosen by exact trellis R/D inside
            # _transform_quantize (supersedes the activity heuristic).
            self._frame_qis = qis
            self._frag_qii_rd = np.zeros(g.nfrags, dtype=np.int32)
            return self._frag_qii_rd
        # Luma block variance -> activity terciles (non-trellis
        # fallback).  qis is [base, coarser?, finer?]; map low-variance
        # blocks to the finer qi and high-variance to the coarser when
        # each is present.
        coarser_i = next(
            (i for i in range(1, len(qis)) if qis[i] < qis[0]), 0
        )
        finer_i = next(
            (i for i in range(1, len(qis)) if qis[i] > qis[0]), 0
        )
        y = planes[0]
        H, W = y.shape
        blocks = (
            y.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
        ).astype(np.float64)
        var = blocks.var(axis=1)
        lo, hi = np.quantile(var, [0.10, 0.55])
        frag_qii = np.zeros(g.nfrags, dtype=np.int32)
        yq = np.where(
            var <= lo, finer_i, np.where(var >= hi, coarser_i, 0)
        ).astype(np.int32)
        frag_qii[: g.planes[0].nfrags] = yq
        # Chroma keeps the base qi.
        self._frame_qis = qis
        return frag_qii

    # ------------------------------------------------------------------
    def _block_qis_pack(self, bw: BitWriter, frag_qii, coded) -> None:
        """qi-index RLE over coded fragments (encode.c:685-725)."""
        qis = self.frame_qis
        if len(qis) <= 1:
            return
        g = self.geometry
        order = []
        for pli in range(3):
            sel = g.scan_pli == pli
            fr = g.scan_fragis[sel]
            order.append(fr[coded[fr]])
        order = np.concatenate(order)
        if len(order) == 0:
            return
        qii = frag_qii[order]
        flags = (qii > 0).astype(int)
        flag = int(flags[0])
        bw.write(flag, 1)
        i = 0
        n = len(flags)
        nqi0 = int((qii == 0).sum())
        while i < n:
            run = 0
            while i < n and flags[i] == flag:
                run += 1
                i += 1
            sb_run_pack(bw, run, flag, i >= n)
            flag = 1 - flag
        if len(qis) < 3 or nqi0 >= n:
            return
        sub = qii[qii > 0] - 1
        flag = int(sub[0])
        bw.write(flag, 1)
        i = 0
        n = len(sub)
        while i < n:
            run = 0
            while i < n and sub[i] == flag:
                run += 1
                i += 1
            sb_run_pack(bw, run, flag, i >= n)
            flag = 1 - flag

    # ------------------------------------------------------------------
    def _encode_intra(self, planes) -> bytes:
        self._cur_fti = 0
        g = self.geometry
        info = self.info
        nfrags = g.nfrags
        coded = np.zeros(nfrags, dtype=bool)
        coded[g.scan_fragis] = True
        frag_refi = np.full(nfrags, FRAME_SELF, dtype=np.int32)
        frag_qii = self._select_adaptive_qis(planes, coded)

        def residual(pli, fragis):
            pl = g.planes[pli]
            p = planes[pli]
            if len(fragis) == pl.nfrags:
                # All fragments coded in raster order (the intra norm):
                # a reshape beats the per-fragment fancy-index gather.
                h, w = pl.nvfrags * 8, pl.nhfrags * 8
                return (
                    p[:h, :w].reshape(pl.nvfrags, 8, pl.nhfrags, 8)
                    .transpose(0, 2, 1, 3)
                    .reshape(-1, 8, 8)
                    .astype(np.int32)
                    - 128
                )
            fy = g.frag_y[fragis] * 8
            fx = g.frag_x[fragis] * 8
            ay = fy[:, None, None] + np.arange(8)[None, :, None]
            ax = fx[:, None, None] + np.arange(8)[None, None, :]
            return p[ay, ax].astype(np.int32) - 128

        per_plane = self._transform_quantize(
            planes, coded, frag_refi, residual, frag_qii
        )

        # DC prediction per plane (raster order), then tokenize in coded
        # (scan) order.
        vecs_by_plane = self._dc_predict_and_order(per_plane, coded, frag_refi)
        bw = BitWriter()
        self._frame_header_pack(bw, INTRA_FRAME, self.frame_qis)
        if frag_qii is not None:
            self._block_qis_pack(bw, frag_qii, coded)
        # Entropy-free closed loop for keyframes too: without this stash
        # every keyframe re-decodes its own packed packet (the token
        # re-decode alone is ~25% of all-intra encode time on the host).
        from theora_tpu.constants import MODE_INTRA

        can_fast = (
            self.fast_recon
            and self.collect is None
            and self._trellis_scan is not None
            and all(isinstance(p, tuple) for p in self._trellis_scan)
        )
        if not can_fast:
            self._stash_recon_state(
                INTRA_FRAME, coded, frag_refi,
                np.full(nfrags, MODE_INTRA, dtype=np.int32),
                np.zeros((nfrags, 2), dtype=np.int32), frag_qii,
                per_plane,
            )
            return self._pack_tokens(bw, vecs_by_plane, INTRA_FRAME)
        # Overlap the serial C++ bit-pack (GIL released inside the
        # native call) with the closed-loop reconstruction: the two read
        # disjoint trellis outputs, and keyframes are never dropped by
        # rate control, so the reference update cannot need undoing.
        # The stash (its coefficient gather included) also runs under
        # the pack, keeping it off the critical path.
        import threading

        result = {}

        def pack():
            result["data"] = self._pack_tokens(
                bw, vecs_by_plane, INTRA_FRAME
            )

        t = threading.Thread(target=pack)
        t.start()
        try:
            self._stash_recon_state(
                INTRA_FRAME, coded, frag_refi,
                np.full(nfrags, MODE_INTRA, dtype=np.int32),
                np.zeros((nfrags, 2), dtype=np.int32), frag_qii,
                per_plane,
            )
            rs = self._recon_state
            if rs is not None:
                self._dec.reconstruct_from_state(*rs)
                self._recon_state = None
                self._recon_done = True
        finally:
            t.join()
        return result["data"]

    # ------------------------------------------------------------------
    def _dc_predict_and_order(self, per_plane, coded, frag_refi):
        """DC-predict all planes (raster) and order coefficient vectors in
        coded (scan) order; returns per-plane [n, 64] int16 vecs with the
        DC residual in slot 0.

        Trellis fast path: when native plan tensors exist, vecs collapse to
        DC-only columns and the scan ordering becomes a permutation handed
        to the native packer (no path-tensor scatter/gather)."""
        g = self.geometry
        out = []
        trellis_scan = []
        for pli in range(3):
            pl = g.planes[pli]
            fragis, qdct = per_plane[pli][:2]
            shape = (pl.nvfrags, pl.nhfrags)
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            dc_plane = np.zeros(shape, dtype=np.int32)
            local = fragis - pl.froffset
            dc_plane.reshape(-1)[local] = qdct[:, 0]
            coded_plane = coded[sl].reshape(shape)
            refi_plane = np.ascontiguousarray(
                frag_refi[sl].reshape(shape), dtype=np.int32
            )
            try:
                from theora_tpu.native import dc_predict_native

                dc_resid = dc_predict_native(
                    1, coded_plane, refi_plane, dc_plane, [0, 0, 0]
                ).reshape(-1)
            except Exception:
                dc_resid = dc_predict_plane_enc(
                    coded_plane, refi_plane, dc_plane, [0, 0, 0]
                ).reshape(-1)
            sel = g.scan_pli == pli
            scan = g.scan_fragis[sel]
            scan = scan[coded[scan]] - pl.froffset
            plans = per_plane[pli][6] if len(per_plane[pli]) > 6 else None
            if (
                plans is not None
                and trellis_scan is not None
                and isinstance(plans, np.ndarray)
            ):
                # Permutation into the raster-ordered plan tensor.
                perm = np.searchsorted(fragis, scan + pl.froffset).astype(
                    np.int32
                )
                dc_scan = dc_resid[scan].astype(np.int32)
                trellis_scan.append((plans, perm, dc_scan))
                out.append(dc_scan.reshape(-1, 1).astype(np.int16))
                continue
            qdct_by_frag = np.zeros((pl.nfrags, 64), dtype=np.int16)
            qdct_by_frag[local] = qdct.astype(np.int16)
            vecs = qdct_by_frag[scan]
            vecs[:, 0] = dc_resid[scan]
            out.append(vecs)
            if plans is not None and trellis_scan is not None:
                by_local = np.empty(pl.nfrags, dtype=object)
                for k, li in enumerate(local):
                    by_local[li] = plans[k]
                trellis_scan.append(by_local[scan])
            else:
                trellis_scan = None
        self._trellis_scan = trellis_scan
        return out

    # ------------------------------------------------------------------
    def _encode_inter(self, planes) -> bytes:
        """Inter frame: ME + mode decision + skip + pack
        (analyze.c:2288-2711 in spirit; v1 uses simplified heuristics)."""
        self._cur_fti = 1
        from theora_tpu.constants import (
            FRAME_FOR_MODE,
            FRAME_GOLD,
            FRAME_PREV,
            MODE_GOLDEN_NOMV,
            MODE_INTER_MV,
            MODE_INTER_MV_LAST,
            MODE_INTER_MV_LAST2,
            MODE_INTER_NOMV,
        )
        from theora_tpu.encode import mcenc

        g = self.geometry
        info = self.info
        nfrags = g.nfrags

        # --- Motion estimation on the luma plane (original refs) ----------
        cur_y = planes[0]
        prev_o = self._pad_plane(self._prev_orig[0])
        gold_o = self._pad_plane(self._gold_orig[0])
        mb_list = np.where(g.mb_valid)[0]
        # MB top-left in luma pixels: from the MB's block 0 fragment.
        mb_fy = g.frag_y[g.mb_maps[mb_list, 0, 0]] * 8
        mb_fx = g.frag_x[g.mb_maps[mb_list, 0, 0]] * 8
        sp_level = self.sp_level
        if sp_level >= 4:
            # OC_SP_LEVEL_NOMC (encint.h:224): no motion search at all;
            # MV-mode SADs are filled in after the NOMV SADs below.
            full_mvs = np.zeros((len(mb_list), 2), np.int32)
            mvs = np.zeros((len(mb_list), 2), np.int32)
            sad_mv = None
        else:
            try:
                from theora_tpu.native import motion_estimate_native

                mvs, sad_mv = motion_estimate_native(
                    cur_y, prev_o, mb_fy, mb_fx
                )
                full_mvs = np.stack(
                    [mvs[:, 0] // 2, mvs[:, 1] // 2], axis=1
                ).astype(np.int32)
            except Exception:
                full_mvs, full_sads = mcenc.full_pel_search(
                    cur_y, prev_o, mb_fy, mb_fx
                )
                full_mvs, full_sads = mcenc.propagate_mvs(
                    cur_y, prev_o, mb_fy, mb_fx, full_mvs, full_sads
                )
                mvs, sad_mv = mcenc.half_pel_refine(
                    cur_y, prev_o, full_mvs, mb_fy, mb_fx
                )
        try:
            from theora_tpu.native import sad_batch_native

            zz = np.zeros(len(mb_list), np.int32)
            sad_nomv = sad_batch_native(cur_y, prev_o, mb_fy, mb_fx, zz, zz)
            sad_gold = sad_batch_native(cur_y, gold_o, mb_fy, mb_fx, zz, zz)
        except (ImportError, RuntimeError):
            sad_nomv = mcenc._per_mb_sad(
                cur_y, prev_o, np.zeros(len(mb_list), int),
                np.zeros(len(mb_list), int), mb_fy, mb_fx,
            )
            sad_gold = mcenc._per_mb_sad(
                cur_y, gold_o, np.zeros(len(mb_list), int),
                np.zeros(len(mb_list), int), mb_fy, mb_fx,
            )
        # Crude intra cost: deviation from per-block means.
        ay = mb_fy[:, None, None] + np.arange(16)[None, :, None]
        ax = mb_fx[:, None, None] + np.arange(16)[None, None, :]
        blocks = cur_y[ay, ax].astype(np.int32)
        b8 = (
            blocks.reshape(len(mb_list), 2, 8, 2, 8)
            .transpose(0, 1, 3, 2, 4)
            .reshape(len(mb_list), 4, 64)
        )
        # Integer block mean: >>6 floors, identical to the truncated
        # float mean for non-negative pixels.
        sad_intra = (
            np.abs(b8 - (b8.sum(axis=2, keepdims=True) >> 6))
            .sum(axis=(1, 2))
            .astype(np.int64)
        )
        if sad_mv is None:
            sad_mv = sad_nomv.copy()

        # --- Per-block MVs for the 4MV mode (mcenc.c:430-496 analogue) -----
        from theora_tpu.constants import MODE_INTER_MV_FOUR

        nmb = len(mb_list)
        if sp_level >= 2:
            # OC_SP_LEVEL_FAST_ANALYSIS / NOMC: skip the per-block 4MV
            # search; the mode is priced out of the decision.
            bmvs = np.zeros((nmb, 4, 2), np.int32)
            sad_4mv = np.full(nmb, np.int64(1) << 40)
            if sp_level >= 4:
                sad_mv = np.full(nmb, np.int64(1) << 40)
        else:
            blk_off = np.array([(0, 0), (0, 8), (8, 0), (8, 8)])  # (dy, dx)
            blk_fy = (mb_fy[:, None] + blk_off[None, :, 0]).reshape(-1)
            blk_fx = (mb_fx[:, None] + blk_off[None, :, 1]).reshape(-1)
            seed_dy = np.repeat(full_mvs[:, 1], 4)
            seed_dx = np.repeat(full_mvs[:, 0], 4)
            try:
                from theora_tpu.native import me_block_refine_native

                bmvs, bsad = me_block_refine_native(
                    cur_y, prev_o, blk_fy, blk_fx,
                    np.stack([seed_dx, seed_dy], axis=1), bs=8,
                )
            except Exception:
                bsad = mcenc._per_block_sad(
                    cur_y, prev_o, blk_fy, blk_fx, 8, seed_dy, seed_dx
                )
                bdy, bdx, bsad = mcenc._refine(
                    cur_y, prev_o, blk_fy, blk_fx, 8, seed_dy, seed_dx,
                    bsad, 15, 1
                )
                bmvs, bsad = mcenc.half_pel_refine_blocks(
                    cur_y, prev_o, np.stack([bdx, bdy], axis=1),
                    blk_fy, blk_fx, 8
                )
            sad_4mv = bsad.reshape(nmb, 4).sum(axis=1)
            bmvs = bmvs.reshape(nmb, 4, 2)

        # --- Native fast path: mode decision + fragment fill in C++ --------
        _native_md = None
        try:
            from theora_tpu.native import mode_decide_fill_native

            _native_md = mode_decide_fill_native
        except Exception:
            pass
        # Mode-decision rate biases are calibrated at qi=40; scale with the
        # quantizer step (rate cost in SAD units tracks the step size, the
        # SAD-domain analogue of the reference's lambda*rate,
        # analyze.c:1063-1076).
        bias_scale = min(
            1.0,
            float(self.dequant[self.qi, 0, 1, 1])
            / float(self.dequant[40, 0, 1, 1]),
        )
        from theora_tpu.encode import modedec as _modedec

        use_rd_modes = self.mode_rd and _modedec.tables_available()
        if _native_md is not None and not use_rd_modes:
            mb_modes_n, mb_mvs_n, frag_refi, frag_mode, frag_mv = _native_md(
                cur_y, prev_o, mb_list, mb_fy, mb_fx,
                sad_nomv, sad_gold, sad_intra, sad_mv, sad_4mv,
                mvs, bmvs.reshape(-1, 2), g.mb_maps, int(info.pixel_fmt),
                28 * int(self.rd_strength * 4 + 4) * bias_scale, nfrags,
                bias_scale=bias_scale,
            )
            mb_modes = np.full(g.nmbs, 0, dtype=np.int32)
            mb_modes[g.mb_valid == False] = -1  # noqa: E712
            mb_modes[mb_list] = mb_modes_n
            mb_mvs = np.zeros((g.nmbs, 2), dtype=np.int32)
            mb_mvs[mb_list] = mb_mvs_n
            self._frag_mv4 = frag_mv
            return self._encode_inter_tail(
                planes, coded_seed=None, frag_refi=frag_refi,
                frag_mode=frag_mode, frag_mv=frag_mv, mb_modes=mb_modes,
                mb_mvs=mb_mvs, mb_list=mb_list,
            )

        # --- Mode decision with MV-predictor state machine ----------------
        # The LAST/LAST2 modes cost no MV bits, so the best MV is compared
        # against reusing the predictors (the reference gets spatial MV
        # coherence from its neighbor-candidate search, mcenc.c:90-165; we
        # evaluate the predictors explicitly).
        mb_modes = np.full(g.nmbs, 0, dtype=np.int32)
        mb_mvs = np.zeros((g.nmbs, 2), dtype=np.int32)
        last_mv = (0, 0)
        prior_mv = (0, 0)
        one = np.zeros(1, dtype=np.int64)
        pad16 = (prev_o.shape[0] - cur_y.shape[0]) // 2

        try:
            from theora_tpu.native import sad_halfpel_native

            cur_c = np.ascontiguousarray(cur_y)
            prev_c = np.ascontiguousarray(prev_o)

            def sad_at(i, mvt):
                return sad_halfpel_native(
                    cur_c, prev_c, int(mb_fy[i]), int(mb_fx[i]), pad16,
                    int(mvt[0]), int(mvt[1]),
                )
        except Exception:

            def sad_at(i, mvt):
                pred = mcenc._halfpel_pred_batch(
                    prev_o,
                    np.array([mvt[0]]),
                    np.array([mvt[1]]),
                    np.array([mb_fy[i] + pad16]),
                    np.array([mb_fx[i] + pad16]),
                )
                blk = cur_y[
                    mb_fy[i] : mb_fy[i] + 16, mb_fx[i] : mb_fx[i] + 16
                ].astype(np.int32)
                return int(np.abs(blk - pred[0]).sum())

        MV_BITS_SAD = 28 * int(self.rd_strength * 4 + 4) * bias_scale
        if use_rd_modes:
            self._mode_decide_rd(
                cur_y, prev_o, gold_o, mb_list, mb_fy, mb_fx, mvs, bmvs,
                blk_fy, blk_fx, mb_modes, mb_mvs,
            )
        else:
          for i, mbi in enumerate(mb_list):
            mv = (int(mvs[i, 0]), int(mvs[i, 1]))
            costs = {
                MODE_INTER_NOMV: int(sad_nomv[i]),
                MODE_INTRA: int(sad_intra[i]) + 350 * bias_scale,
                MODE_GOLDEN_NOMV: int(sad_gold[i]) + 80 * bias_scale,
                MODE_INTER_MV_FOUR: int(sad_4mv[i]) + 640 * bias_scale
                + 4 * MV_BITS_SAD,
            }
            if mv != (0, 0):
                costs[MODE_INTER_MV] = int(sad_mv[i]) + MV_BITS_SAD
            if last_mv != (0, 0):
                s = (
                    int(sad_mv[i])
                    if mv == last_mv
                    else sad_at(i, last_mv)
                )
                costs[MODE_INTER_MV_LAST] = s + 16 * bias_scale
            if prior_mv != (0, 0) and prior_mv != last_mv:
                s = (
                    int(sad_mv[i])
                    if mv == prior_mv
                    else sad_at(i, prior_mv)
                )
                costs[MODE_INTER_MV_LAST2] = s + 24 * bias_scale
            mode = min(costs, key=costs.get)
            mb_modes[mbi] = mode
            if mode == MODE_INTER_MV:
                mb_mvs[mbi] = mv
                prior_mv = last_mv
                last_mv = mv
            elif mode == MODE_INTER_MV_LAST:
                mb_mvs[mbi] = last_mv
            elif mode == MODE_INTER_MV_LAST2:
                mb_mvs[mbi] = prior_mv
                prior_mv, last_mv = last_mv, prior_mv
            elif mode == MODE_INTER_MV_FOUR:
                # The decoder updates last/prior from the per-block MVs
                # (decode.c:841-866); all 4 luma blocks stay coded.
                prior_mv = last_mv
                last_mv = (int(bmvs[i, 3, 0]), int(bmvs[i, 3, 1]))
        # NOTE: the decoder's last/prior state only advances on transmitted
        # modes; MBs that end up with no coded luma blocks don't transmit.
        # We conservatively avoid LAST/LAST2 modes becoming untransmitted by
        # keeping all luma blocks of MV-mode MBs coded (see skip rule).

        # --- Per-fragment mode/MV/refi fill -------------------------------
        frag_refi = np.full(nfrags, FRAME_NONE, dtype=np.int32)
        frag_mode = np.zeros(nfrags, dtype=np.int32)
        frag_mv = np.zeros((nfrags, 2), dtype=np.int32)

        def div_round(v, shift, rval):
            return (int(v) + (-1 if v < 0 else 0) + rval) >> shift

        pf = int(info.pixel_fmt)
        for i, mbi in enumerate(mb_list):
            mode = int(mb_modes[mbi])
            refi = int(FRAME_FOR_MODE[mode])
            if mode == MODE_INTER_MV_FOUR:
                lb = bmvs[i]
                for bi in range(4):
                    fragi = g.mb_maps[mbi, 0, bi]
                    if fragi >= 0:
                        frag_refi[fragi] = refi
                        frag_mode[fragi] = mode
                        frag_mv[fragi] = lb[bi]
                # Chroma MVs from the luma block MVs (state.c:33-97).
                cb = [(0, 0)] * 4
                if pf == 0:
                    dx = int(lb[:, 0].sum())
                    dy = int(lb[:, 1].sum())
                    cb[0] = (div_round(dx, 2, 2), div_round(dy, 2, 2))
                elif pf == 2:
                    for k, (a, b) in enumerate(((0, 1), (2, 3))):
                        cb[k * 2] = (
                            div_round(int(lb[a, 0] + lb[b, 0]), 1, 1),
                            div_round(int(lb[a, 1] + lb[b, 1]), 1, 1),
                        )
                else:
                    cb = [tuple(v) for v in lb]
                for pli in (1, 2):
                    for bi in range(4):
                        fragi = g.mb_maps[mbi, pli, bi]
                        if fragi >= 0:
                            frag_refi[fragi] = refi
                            frag_mode[fragi] = mode
                            frag_mv[fragi] = cb[bi]
                continue
            for pli in range(3):
                for bi in range(4):
                    fragi = g.mb_maps[mbi, pli, bi]
                    if fragi >= 0:
                        frag_refi[fragi] = refi
                        frag_mode[fragi] = mode
                        frag_mv[fragi] = mb_mvs[mbi]
        self._frag_mv4 = frag_mv
        return self._encode_inter_tail(
            planes, coded_seed=None, frag_refi=frag_refi,
            frag_mode=frag_mode, frag_mv=frag_mv, mb_modes=mb_modes,
            mb_mvs=mb_mvs, mb_list=mb_list,
        )

    # ------------------------------------------------------------------
    def _mode_decide_rd(self, cur_y, prev_o, gold_o, mb_list, mb_fy,
                        mb_fx, mvs, bmvs, blk_fy, blk_fx, mb_modes, mb_mvs):
        """SATD + fitted-R/D-table mode decision (analyze.c:1968-2450
        analogue over our collect-fitted tables); fills mb_modes/mb_mvs.
        Returns the per-block SATD arrays for reuse."""
        from theora_tpu.constants import (
            FRAME_PREV,
            MODE_GOLDEN_NOMV,
            MODE_INTER_MV,
            MODE_INTER_MV_FOUR,
            MODE_INTER_MV_LAST,
            MODE_INTER_MV_LAST2,
            MODE_INTER_NOMV,
            MODE_INTRA,
        )
        from theora_tpu.encode import modedec
        from theora_tpu.huffman import MV_VLC_BOOK
        from theora_tpu.native import (
            hadamard_batch_native,
            satd_halfpel_batch_native,
        )

        g = self.geometry
        n = len(mb_list)
        qi = self.frame_qis[0]
        fmt = int(self.info.pixel_fmt)
        lam = float(
            tables.RD_LAMBDA.get(fmt, tables.RD_LAMBDA[0])[1][qi]
        ) * float(self.mode_rd_rate_scale)
        rows = {
            qti: modedec.interp_rows(self.dequant, qi, qti, 0)
            for qti in (0, 1)
        }
        z4 = np.zeros(4 * n, np.int32)
        satd_nomv, _ = satd_halfpel_batch_native(
            cur_y, prev_o, blk_fy, blk_fx, z4, z4, bs=8
        )
        satd_gold, _ = satd_halfpel_batch_native(
            cur_y, gold_o, blk_fy, blk_fx, z4, z4, bs=8
        )
        ay = blk_fy[:, None, None] + np.arange(8)[None, :, None]
        ax = blk_fx[:, None, None] + np.arange(8)[None, None, :]
        satd_intra, _ = hadamard_batch_native(
            cur_y[ay, ax].astype(np.int32)
        )
        mv_rep = np.repeat(mvs, 4, axis=0)
        satd_mv, _ = satd_halfpel_batch_native(
            cur_y, prev_o, blk_fy, blk_fx, mv_rep[:, 0], mv_rep[:, 1], bs=8
        )
        b2 = bmvs.reshape(-1, 2)
        satd_4mv, _ = satd_halfpel_batch_native(
            cur_y, prev_o, blk_fy, blk_fx, b2[:, 0], b2[:, 1], bs=8
        )
        # Uncoded (skip) SSD vs the reconstructed PREV, x16 domain, with
        # the reference\'s motion penalty (analyze.c:2010-2014).
        prev_rec = self._dec.buffers[self._dec.ref_idx[FRAME_PREV]]
        pl = g.planes[0]
        vpad, hpad = g.plane_padding(0)
        h, w = pl.nvfrags * 8, pl.nhfrags * 8
        dd = cur_y.astype(np.int64) - prev_rec.planes[0][
            vpad : vpad + h, hpad : hpad + w
        ]
        grid = (dd * dd).reshape(pl.nvfrags, 8, pl.nhfrags, 8).sum(
            axis=(1, 3)
        )
        # x16 coefficient domain (the fitted tables' RMSE is sqrt of
        # 16*pixel-SSD, collect.py fit()), so the per-block skip-vs-code
        # min compares like with like.  No motion penalty: only NOMV MBs
        # consume this (their skip IS the zero-MV prev copy measured
        # here).
        skip_ssd = 16.0 * grid[blk_fy // 8, blk_fx // 8].astype(np.float64)

        if not hasattr(self, "_mv_len"):
            lens = {}
            for t, p, nb in MV_VLC_BOOK.codes:
                lens.setdefault(t - 32, nb)
            self._mv_len = lens
        mv_len = self._mv_len

        def blocks_cost(satds, qti, skips, may_skip=False):
            tot = 0.0
            r_row, m_row = rows[qti]
            for s, sk in zip(satds, skips):
                r, ssd = modedec.dct_cost(r_row, m_row, int(s))
                # x16-domain distortion + lambda*bits: the same convention
                # as the trellis and skip decisions in this pipeline.
                c = ssd + lam * r
                # Skip coupling (oc_cost_inter's per-block min with the
                # uncoded SSD, analyze.c:1275-1304): a block this
                # pipeline's skip pass may actually drop (luma skips only
                # in NOMV MBs -- mode transmission rides coded luma)
                # contributes the cheaper of coding and skipping, so
                # NOMV stops being charged for blocks it won't code.
                if may_skip and sk < c:
                    c = sk
                tot += c
            return tot

        cur_c = np.ascontiguousarray(cur_y)
        satd_cache: dict = {}

        def last_satd(i, mvt, mv, s4):
            """SATD of MB i predicted with a candidate LAST/LAST2 vector
            (cached across walks)."""
            if mvt == mv:
                return satd_mv[s4]
            key = (i, mvt)
            s_l = satd_cache.get(key)
            if s_l is None:
                mvx = np.full(4, mvt[0], np.int32)
                mvy = np.full(4, mvt[1], np.int32)
                s_l, _ = satd_halfpel_batch_native(
                    cur_c, prev_o, blk_fy[s4], blk_fx[s4], mvx, mvy,
                    bs=8,
                )
                satd_cache[key] = s_l
            return s_l

        def walk(seed_discount):
            """One greedy pass over the MBs.  seed_discount < 1 makes
            MV-bearing modes cheaper AT DECISION TIME only (their full
            bits still accrue to the returned total): choosing INTER_MV
            or 4MV seeds the decoder's last-MV predictor, which makes
            LAST (0 MV bits) available to every following MB of a pan --
            chain value a 1-step greedy walk cannot see (measured: at
            full price the seed never happens on smooth pans and the
            decision collapses to all-NOMV, +76% bytes / -3.7 dB at
            q40).  The caller runs several aggressiveness levels and
            keeps the plan whose FULL-price model total is least, so the
            discount can only ever reveal better plans, not distort the
            chosen one."""
            chooser = modedec.SchemeChooser()
            last_mv = (0, 0)
            prior_mv = (0, 0)
            plan = []
            total = 0.0
            for i, mbi in enumerate(mb_list):
                s4 = slice(4 * i, 4 * i + 4)
                sk = skip_ssd[s4]
                mv = (int(mvs[i, 0]), int(mvs[i, 1]))
                # costs: mode -> (decision cost, full-price cost).
                costs = {}

                def add(mode, bc, mv_bits=0.0):
                    sc = chooser.cost(mode)
                    costs[mode] = (
                        bc + lam * (sc + mv_bits * seed_discount),
                        bc + lam * (sc + mv_bits),
                    )

                add(MODE_INTER_NOMV,
                    blocks_cost(satd_nomv[s4], 1, sk, may_skip=True))
                add(MODE_INTRA, blocks_cost(satd_intra[s4], 0, sk))
                add(MODE_GOLDEN_NOMV, blocks_cost(satd_gold[s4], 1, sk))
                add(MODE_INTER_MV_FOUR,
                    blocks_cost(satd_4mv[s4], 1, sk),
                    sum(mv_len[int(b2[4 * i + bi, 0])]
                        + mv_len[int(b2[4 * i + bi, 1])]
                        for bi in range(4)))
                if mv != (0, 0):
                    add(MODE_INTER_MV, blocks_cost(satd_mv[s4], 1, sk),
                        mv_len[mv[0]] + mv_len[mv[1]])
                for m_last, mvt in (
                    (MODE_INTER_MV_LAST, last_mv),
                    (MODE_INTER_MV_LAST2, prior_mv),
                ):
                    if mvt == (0, 0) or (
                        m_last == MODE_INTER_MV_LAST2 and mvt == last_mv
                    ):
                        continue
                    add(m_last, blocks_cost(last_satd(i, mvt, mv, s4),
                                            1, sk))
                mode = min(costs, key=lambda m: costs[m][0])
                total += costs[mode][1]
                chooser.update(mode)
                if mode == MODE_INTER_MV:
                    vec = mv
                    prior_mv = last_mv
                    last_mv = mv
                elif mode == MODE_INTER_MV_LAST:
                    vec = last_mv
                elif mode == MODE_INTER_MV_LAST2:
                    vec = prior_mv
                    prior_mv, last_mv = last_mv, prior_mv
                elif mode == MODE_INTER_MV_FOUR:
                    vec = (0, 0)
                    prior_mv = last_mv
                    last_mv = (int(bmvs[i, 3, 0]), int(bmvs[i, 3, 1]))
                else:
                    vec = (0, 0)
                plan.append((mode, vec))
            return total, plan

        best_total, best_plan = None, None
        for d in self.mode_rd_seed_levels:
            total, plan = walk(d)
            if best_total is None or total < best_total:
                best_total, best_plan = total, plan
        for (mode, vec), mbi in zip(best_plan, mb_list):
            mb_modes[mbi] = mode
            mb_mvs[mbi] = vec

    def _encode_inter_tail(self, planes, coded_seed, frag_refi, frag_mode,
                           frag_mv, mb_modes, mb_mvs, mb_list):
        """Transform/quantize/skip + packing tail of inter encoding."""
        from theora_tpu.constants import (
            FRAME_GOLD,
            FRAME_PREV,
            MODE_INTER_NOMV,
        )

        g = self.geometry
        info = self.info
        nfrags = g.nfrags

        # --- Transform + quantize + skip ----------------------------------
        prev_rec = self._dec.buffers[self._dec.ref_idx[FRAME_PREV]]
        gold_rec = self._dec.buffers[self._dec.ref_idx[FRAME_GOLD]]

        from theora_tpu.decode.decoder import _MVMAP, _MVMAP2

        def residual(pli, fragis):
            p = planes[pli]
            vpad, hpad = g.plane_padding(pli)
            qpx = 1 if (pli != 0 and not (info.pixel_fmt & 1)) else 0
            qpy = 1 if (pli != 0 and not (info.pixel_fmt & 2)) else 0
            fy = g.frag_y[fragis] * 8
            fx = g.frag_x[fragis] * 8
            try:
                from theora_tpu.native import enc_residuals_native

                refi = frag_refi[fragis]
                refsel = np.where(
                    refi == FRAME_SELF, 0,
                    np.where(refi == FRAME_GOLD, 2, 1),
                ).astype(np.int32)
                dx = frag_mv[fragis, 0]
                dy = frag_mv[fragis, 1]
                mx = _MVMAP[qpx][dx + 31]
                mx2 = _MVMAP2[qpx][dx + 31]
                my = _MVMAP[qpy][dy + 31]
                my2 = _MVMAP2[qpy][dy + 31]
                use2 = ((mx2 != 0) | (my2 != 0)) & (refsel != 0)
                return enc_residuals_native(
                    p, prev_rec.planes[pli], gold_rec.planes[pli],
                    fy, fx, refsel, my, mx, my + my2, mx + mx2, use2,
                    vpad, hpad,
                )
            except (ImportError, RuntimeError):
                pass
            ay = fy[:, None, None] + np.arange(8)[None, :, None]
            ax = fx[:, None, None] + np.arange(8)[None, None, :]
            cur = p[ay, ax].astype(np.int32)
            out = np.empty((len(fragis), 8, 8), dtype=np.int32)
            refi = frag_refi[fragis]
            m_intra = refi == FRAME_SELF
            if m_intra.any():
                out[m_intra] = cur[m_intra] - 128
            for rf, rec in ((FRAME_PREV, prev_rec), (FRAME_GOLD, gold_rec)):
                m = refi == rf
                if not m.any():
                    continue
                ref = rec.planes[pli]
                dx = frag_mv[fragis[m], 0]
                dy = frag_mv[fragis[m], 1]
                mx = _MVMAP[qpx][dx + 31]
                mx2 = _MVMAP2[qpx][dx + 31]
                my = _MVMAP[qpy][dy + 31]
                my2 = _MVMAP2[qpy][dy + 31]
                gy = (fy[m] + vpad + my)[:, None, None] + np.arange(8)[None, :, None]
                gx = (fx[m] + hpad + mx)[:, None, None] + np.arange(8)[None, None, :]
                blk = ref[gy, gx].astype(np.int32)
                use2 = (mx2 != 0) | (my2 != 0)
                if use2.any():
                    g2y = (fy[m] + vpad + my + my2)[:, None, None] + np.arange(8)[
                        None, :, None
                    ]
                    g2x = (fx[m] + hpad + mx + mx2)[:, None, None] + np.arange(8)[
                        None, None, :
                    ]
                    blk2 = ref[g2y, g2x].astype(np.int32)
                    blk = np.where(use2[:, None, None], (blk + blk2) >> 1, blk)
                out[m] = cur[m] - blk
            return out

        # First pass: everything potentially coded.
        coded = np.zeros(nfrags, dtype=bool)
        coded[g.scan_fragis] = True
        coded &= frag_refi != FRAME_NONE
        frag_qii = (
            self._select_adaptive_qis(planes, coded)
            if self.sp_level < 2 else None  # single quantizer at FAST_ANALYSIS
        )

        from theora_tpu.ops.fdct_np import rd_lambda

        lam = (
            rd_lambda(self.qi, int(self.dequant[self.qi, 0, 1, 1]))
            * self.rd_strength * 4.0
            * getattr(self, "skip_lambda_scale", 1.0)
        )
        if self.sp_level >= 1:
            # Early skip (OC_SP_LEVEL_EARLY_SKIP, analyze.c:708-715):
            # blocks whose uncoded SSD cannot beat any coded version
            # (minimum coded cost is ~2 bits at zero coded error) bypass
            # the transform/tokenize stages entirely. At level 1 the
            # threshold makes this a strict subset of the post-transform
            # R/D skip, so the output stream is unchanged; levels >= 2
            # widen the threshold (speed/quality trade).
            widen = 1.0 if self.sp_level == 1 else 4.0
            thresh = np.int64(lam * 2.0 * widen)
            for pli in range(3):
                pl = g.planes[pli]
                sl = slice(pl.froffset, pl.froffset + pl.nfrags)
                cand = coded[sl].copy()
                if pli == 0:
                    cand &= frag_mode[sl] == MODE_INTER_NOMV
                if not cand.any():
                    continue
                unc = self._uncoded_ssd_plane(planes, prev_rec, pli)
                early = cand & (unc <= thresh)
                if early.any():
                    coded[np.where(early)[0] + pl.froffset] = False
        if getattr(self, "coupled_skip", True):
            per_plane = self._coupled_transform_skip(
                planes, coded, frag_refi, frag_mode, frag_mv, mb_modes,
                residual, frag_qii, prev_rec, lam,
            )
            return self._finish_inter(
                planes, per_plane, coded, frag_refi, frag_mode, frag_mv,
                frag_qii, mb_modes, mb_mvs, mb_list,
            )
        per_plane = self._transform_quantize(
            planes, coded, frag_refi, residual, frag_qii
        )

        # R/D skip (analyze.c:859-867): a NOMV block stays uncoded when the
        # coded version doesn't beat the plain PREV copy by more than its
        # bit cost (uncoded semantics == NOMV prediction). Extending the
        # skip to other modes was tried and measured an RD loss without a
        # modedec-grade cost model; revisit with SATD-based rate fits.
        for pli in range(3):
            fragis, qdct, err2, res2 = per_plane[pli][:4]
            if len(fragis) == 0:
                continue
            extra = per_plane[pli][4:]
            if len(extra) >= 4 and extra[2] is not None:
                # Trellis: exact AC bits (+~2 DC/flag bits).
                bits_est = extra[3] + 2
            else:
                nnz = (qdct != 0).sum(axis=1)
                bits_est = 6 * nnz + 2
            if pli == 0:
                if getattr(self, "luma_ext_skip", False):
                    pl = g.planes[0]
                    vpad, hpad = g.plane_padding(0)
                    h, w = pl.nvfrags * 8, pl.nhfrags * 8
                    prev_w = prev_rec.planes[0][
                        vpad : vpad + h, hpad : hpad + w
                    ].astype(np.int64)
                    d = planes[0].astype(np.int64) - prev_w
                    unc = (
                        (d * d)
                        .reshape(pl.nvfrags, 8, pl.nhfrags, 8)
                        .sum(axis=(1, 3))
                        .reshape(-1)
                        * 16
                    )[fragis - pl.froffset]
                    from theora_tpu.constants import (
                        MODE_INTER_MV as _MV,
                        MODE_INTER_MV_LAST as _ML,
                        MODE_INTER_MV_LAST2 as _ML2,
                    )
                    ok_mode = np.isin(
                        frag_mode[fragis], (MODE_INTER_NOMV, _MV, _ML, _ML2)
                    )
                    skip = ok_mode & (
                        unc <= err2 + (lam * bits_est).astype(np.int64)
                    )
                    # Guard: keep >=1 coded luma block per non-NOMV MB that
                    # still has any coded fragment depending on its mode.
                    self._luma_skip_guard(fragis, skip, coded, frag_mode)
                else:
                    skip_rd = res2 <= err2 + (lam * bits_est).astype(np.int64)
                    skip = skip_rd & (frag_mode[fragis] == MODE_INTER_NOMV)
            else:
                # Chroma blocks of ANY mode may go uncoded (prev copy at
                # zero MV) without affecting mode transmission, which rides
                # on coded luma; compare against the actual uncoded
                # prediction, not the mode prediction.
                pl = g.planes[pli]
                vpad, hpad = g.plane_padding(pli)
                h, w = pl.nvfrags * 8, pl.nhfrags * 8
                prev_w = prev_rec.planes[pli][
                    vpad : vpad + h, hpad : hpad + w
                ]
                d = planes[pli].astype(np.int32) - prev_w
                unc = (
                    (d * d)
                    .reshape(pl.nvfrags, 8, pl.nhfrags, 8)
                    .sum(axis=(1, 3), dtype=np.int64)
                    .reshape(-1)
                    * 16
                )[fragis - pl.froffset]
                skip = unc <= err2 + (lam * bits_est).astype(np.int64)
            if skip.any():
                keep = ~skip
                coded[fragis[skip]] = False
                kept = [fragis[keep], qdct[keep], err2[keep], res2[keep]]
                if len(extra) >= 4 and extra[2] is not None:
                    plans = extra[2]
                    plans = (
                        plans[keep]
                        if isinstance(plans, np.ndarray)
                        else [p for p, k in zip(plans, keep) if k]
                    )
                    kept += [
                        extra[0][keep] if extra[0] is not None else None,
                        extra[1][keep], plans, extra[3][keep],
                    ]
                per_plane[pli] = tuple(kept)

        return self._finish_inter(
            planes, per_plane, coded, frag_refi, frag_mode, frag_mv,
            frag_qii, mb_modes, mb_mvs, mb_list,
        )

    # ------------------------------------------------------------------
    def _finish_inter(self, planes, per_plane, coded, frag_refi, frag_mode,
                      frag_mv, frag_qii, mb_modes, mb_mvs, mb_list) -> bytes:
        """DC prediction + tokenization + packing tail shared by the
        legacy and coupled skip paths."""
        g = self.geometry
        ncoded_total = int(coded.sum())
        if ncoded_total == 0:
            # 0-byte dup-frame packet, or an explicit no-coded-blocks inter
            # frame in VP3 mode (encode.c:865-906, 926-928).
            return self._drop_frame_pack() if self.vp3_compatible else b""

        # Uncoded fragments keep FRAME_NONE so DC prediction skips them.
        frag_refi[~coded] = FRAME_NONE

        vecs_by_plane = self._dc_predict_and_order(per_plane, coded, frag_refi)
        bw = BitWriter()
        self._frame_header_pack(bw, INTER_FRAME, self.frame_qis)
        self._coded_flags_pack(bw, coded)
        mb_luma_coded = np.zeros(g.nmbs, dtype=bool)
        for mbi in mb_list:
            for bi in range(4):
                fragi = g.mb_maps[mbi, 0, bi]
                if fragi >= 0 and coded[fragi]:
                    mb_luma_coded[mbi] = True
        coded_mbis = [mbi for mbi in range(g.nmbs) if mb_luma_coded[mbi]]
        self._mb_modes_pack(bw, mb_modes, coded_mbis)
        self._mvs_pack(bw, mb_modes, mb_mvs, coded_mbis, coded)
        if frag_qii is not None:
            self._block_qis_pack(bw, frag_qii, coded)
        can_overlap = (
            self.fast_recon
            and self.rc is None  # a dropped frame must not advance refs
            and self.collect is None
            and self._trellis_scan is not None
            and all(isinstance(p, tuple) for p in self._trellis_scan)
        )  # auto-keyframe retry is safe: encode_frame rewinds the
        # decoder bookkeeping before re-encoding as intra
        if not can_overlap:
            self._stash_recon_state(
                INTER_FRAME, coded, frag_refi, frag_mode, frag_mv,
                frag_qii, per_plane,
            )
            return self._pack_tokens(bw, vecs_by_plane, INTER_FRAME)
        # Same pack/recon overlap as the intra path: with no rate
        # control this frame cannot be dropped or replaced, so the
        # closed-loop reconstruction may run under the serial C++
        # bit-pack.  (fast_recon "auto" skips the stash for inter when
        # run SEQUENTIALLY -- the C++ full decode beats the Python MC
        # recon -- but overlapped under the pack the recon is free.)
        import threading

        saved_fr = self.fast_recon
        result = {}

        def pack():
            result["data"] = self._pack_tokens(
                bw, vecs_by_plane, INTER_FRAME
            )

        t = threading.Thread(target=pack)
        t.start()
        try:
            self.fast_recon = True  # allow the inter stash under "auto"
            self._stash_recon_state(
                INTER_FRAME, coded, frag_refi, frag_mode, frag_mv,
                frag_qii, per_plane,
            )
            rs = self._recon_state
            if rs is not None:
                self._dec.reconstruct_from_state(*rs)
                self._recon_state = None
                self._recon_done = True
        finally:
            self.fast_recon = saved_fr
            t.join()
        return result["data"]

    # ------------------------------------------------------------------
    def _uncoded_ssd_plane(self, planes, prev_rec, pli):
        """Per-fragment SSD (scaled x16 to the DCT domain) of the uncoded
        prediction: a zero-MV copy from the reconstructed previous frame
        (the skip_ssd array of analyze.c:529-531)."""
        g = self.geometry
        pl = g.planes[pli]
        vpad, hpad = g.plane_padding(pli)
        h, w = pl.nvfrags * 8, pl.nhfrags * 8
        try:
            from theora_tpu.native import ssd8_plane_native

            return ssd8_plane_native(
                planes[pli][:h, :w], prev_rec.planes[pli], vpad, hpad
            )
        except (ImportError, RuntimeError, OSError):
            pass
        prev_w = prev_rec.planes[pli][vpad : vpad + h, hpad : hpad + w]
        d = planes[pli].astype(np.int32) - prev_w
        return (
            (d * d)
            .reshape(pl.nvfrags, 8, pl.nhfrags, 8)
            .sum(axis=(1, 3), dtype=np.int64)
            .reshape(-1)
            * 16
        )

    # ------------------------------------------------------------------
    def _apply_skip(self, per_plane, pli, skip, coded):
        """Drop skipped rows from a per_plane tuple and clear coded."""
        fragis, qdct, err2, res2 = per_plane[pli][:4]
        extra = per_plane[pli][4:]
        keep = ~skip
        coded[fragis[skip]] = False
        kept = [fragis[keep], qdct[keep], err2[keep], res2[keep]]
        if len(extra) >= 4 and extra[2] is not None:
            plans = extra[2]
            plans = (
                plans[keep]
                if isinstance(plans, np.ndarray)
                else [p for p, k in zip(plans, keep) if k]
            )
            kept += [
                extra[0][keep] if extra[0] is not None else None,
                extra[1][keep], plans, extra[3][keep],
            ]
        per_plane[pli] = tuple(kept)

    # ------------------------------------------------------------------
    def _coupled_transform_skip(self, planes, coded, frag_refi, frag_mode,
                                frag_mv, mb_modes, residual, frag_qii,
                                prev_rec, lam):
        """Coupled mode/skip R-D: the reference's retroactive skip with
        rollback (analyze.c:859-882, 933-956), reformulated for the
        batched pipeline as luma-first coding:

          1. transform+tokenize luma; per-block skip for ANY mode against
             the true uncoded (prev-copy) SSD, priced with trellis-exact
             bits;
          2. MB-level rollback: skip a whole MB's remaining luma when the
             uncoded SSD beats coded SSD + lambda*(ac bits + mode/flag
             overhead) -- the mode-cost/skip coupling;
          3. mode forcing: an MB with no coded luma transmits nothing, so
             its mode becomes INTER_NOMV (analyze.c:956) and its chroma
             re-predicts accordingly -- THEN chroma is transformed.

        Decoder-state safety: the decoder's last/prior MV predictors
        advance only on transmitted modes, and our mode decisions were
        made assuming transmission.  Full-luma skip (and the MB rollback)
        is therefore only allowed for modes that do not advance that
        state: NOMV, GOLDEN_NOMV, INTRA and INTER_MV_LAST.  MV / LAST2 /
        4MV macroblocks keep at least one coded luma block
        (_luma_skip_guard), exactly like the non-coupled path.
        """
        from theora_tpu.constants import (
            FRAME_PREV,
            MODE_INTER_MV_FOUR,
            MODE_INTER_MV_LAST,
            MODE_INTER_NOMV,
            MODE_GOLDEN_NOMV as _GOLD,
        )

        g = self.geometry
        pl0 = g.planes[0]
        nfrags = g.nfrags

        luma_mask = np.zeros(nfrags, bool)
        luma_mask[: pl0.nfrags] = True
        luma_coded = coded & luma_mask
        per_plane = self._transform_quantize(
            planes, luma_coded, frag_refi, residual, frag_qii
        )

        fragis, qdct, err2, res2 = per_plane[0][:4]
        extra = per_plane[0][4:]
        if len(extra) >= 4 and extra[2] is not None:
            bits_est = extra[3] + 2
        else:
            bits_est = 6 * (qdct != 0).sum(axis=1) + 2
        unc = self._uncoded_ssd_plane(planes, prev_rec, 0)[fragis]
        modes_f = frag_mode[fragis]
        # Per-block skip.  NOMV blocks keep the proven aggressive lambda
        # (skipping them only drops the residual refinement -- prediction
        # is the prev copy either way).  For motion/intra modes skipping
        # REPLACES the prediction with a zero-MV copy and the damage
        # compounds through the closed loop, so those use a conservative
        # lambda.  4MV blocks never skip (per-block MVs ride on coded
        # flags and feed chroma MV derivation).
        lam_other = lam * getattr(self, "skip_other_scale", 0.25)
        is_nomv = modes_f == MODE_INTER_NOMV
        lam_blk = np.where(is_nomv, lam, lam_other)
        skip = (unc <= err2 + (lam_blk * bits_est).astype(np.int64)) & (
            modes_f != MODE_INTER_MV_FOUR
        )
        if not getattr(self, "skip_nonnomv", True):
            skip &= is_nomv
        # Keep >=1 coded luma block in MBs whose mode must stay
        # transmitted for MV-predictor consistency.
        self._luma_skip_guard_modes(fragis, skip, coded, frag_mode)

        # MB-level rollback with mode overhead for state-safe modes.
        safe = np.isin(
            mb_modes, (MODE_INTER_NOMV, _GOLD, MODE_INTRA,
                       MODE_INTER_MV_LAST),
        )
        ov = getattr(self, "mb_skip_overhead_bits", 6.0)
        if not getattr(self, "mb_rollback", True):
            safe &= False
        pos = {int(f): i for i, f in enumerate(fragis)}
        for mbi in np.where(safe & g.mb_valid)[0]:
            idx = [pos[f] for f in g.mb_maps[mbi, 0, :4]
                   if f >= 0 and f in pos]
            live = [i for i in idx if not skip[i]]
            if not live:
                continue
            lam_mb = lam if mb_modes[mbi] == MODE_INTER_NOMV else lam_other
            unc_s = int(unc[live].sum())
            cod_s = int(err2[live].sum())
            bits_s = float(np.asarray(bits_est)[live].sum())
            if unc_s <= cod_s + int(lam_mb * (bits_s + ov)):
                for i in live:
                    skip[i] = True
        self._apply_skip(per_plane, 0, skip, coded)

        # Mode forcing: no coded luma -> INTER_NOMV, chroma re-predicts.
        for mbi in np.where(g.mb_valid)[0]:
            lum = [f for f in g.mb_maps[mbi, 0, :4] if f >= 0]
            if not lum or any(coded[f] for f in lum):
                continue
            if mb_modes[mbi] == MODE_INTER_NOMV:
                continue
            mb_modes[mbi] = MODE_INTER_NOMV
            for pli in (1, 2):
                for f in g.mb_maps[mbi, pli]:
                    if f >= 0 and coded[f]:
                        frag_refi[f] = FRAME_PREV
                        frag_mode[f] = MODE_INTER_NOMV
                        frag_mv[f] = 0

        # Chroma: transform with the (possibly re-predicted) refs, then
        # the any-mode chroma skip against the uncoded prediction.
        chroma_coded = coded & ~luma_mask
        per_chroma = self._transform_quantize(
            planes, chroma_coded, frag_refi, residual, frag_qii
        )
        for pli in (1, 2):
            per_plane[pli] = per_chroma[pli]
            fragis, qdct, err2, res2 = per_plane[pli][:4]
            if len(fragis) == 0:
                continue
            extra = per_plane[pli][4:]
            if len(extra) >= 4 and extra[2] is not None:
                bits_est = extra[3] + 2
            else:
                bits_est = 6 * (qdct != 0).sum(axis=1) + 2
            unc = self._uncoded_ssd_plane(planes, prev_rec, pli)[
                fragis - g.planes[pli].froffset
            ]
            skip = unc <= err2 + (lam * bits_est).astype(np.int64)
            if skip.any():
                self._apply_skip(per_plane, pli, skip, coded)
        return per_plane

    # ------------------------------------------------------------------
    def _luma_skip_guard_modes(self, fragis, skip, coded, frag_mode) -> None:
        """Un-skip one luma block of any MB whose mode advances the
        decoder's MV-predictor state (MV/LAST2/4MV) and would otherwise
        lose all coded luma -- its mode must stay transmitted."""
        from theora_tpu.constants import (
            MODE_INTER_MV as _MV,
            MODE_INTER_MV_FOUR as _M4,
            MODE_INTER_MV_LAST2 as _ML2,
        )

        g = self.geometry
        skipmap = np.zeros(g.nfrags, dtype=bool)
        skipmap[fragis] = skip
        pos = {int(f): i for i, f in enumerate(fragis)}
        for mbi in np.where(g.mb_valid)[0]:
            lum = [f for f in g.mb_maps[mbi, 0, :4] if f >= 0 and coded[f]]
            if not lum or frag_mode[lum[0]] not in (_MV, _ML2, _M4):
                continue
            if not all(skipmap[f] for f in lum):
                continue
            keep = min(lum, key=lambda f: 0)
            skip[pos[keep]] = False
            skipmap[keep] = False

    # ------------------------------------------------------------------
    def pack_frame_plan(self, ftype, coded, frag_refi, mb_modes, mb_mvs,
                        qdct_by_frag, qis=None, frag_qii=None) -> bytes:
        """Pack one frame from an externally computed coding plan.

        The device GOP encoder (encode/tpu_gop.py) makes every decision
        (modes, MVs, skip, quantized coefficients + closed-loop recon) on
        device; this entry runs only the bit-serial stages: DC
        prediction, tokenization, Huffman selection and packing -- the
        split of SURVEY.md section 7 (entropy is host work by nature).

        coded: [nfrags] bool; frag_refi: [nfrags] FRAME_* (FRAME_NONE for
        uncoded); qdct_by_frag: [nfrags, 64] int (zig-zag, actual DC in
        slot 0 -- prediction happens here).  mb_modes/mb_mvs as packed.
        qis/frag_qii: adaptive-quant frame qi list (>1 entries) and the
        per-fragment qi index, packed as the block-qi RLE.
        """
        g = self.geometry
        self._cur_fti = 0 if ftype == INTRA_FRAME else 1
        self._frame_qis = list(qis) if qis and len(qis) > 1 else None
        per_plane = {}
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            fragis = np.where(coded[sl])[0] + pl.froffset
            per_plane[pli] = (fragis, qdct_by_frag[fragis].astype(np.int32))
        vecs_by_plane = self._dc_predict_and_order(per_plane, coded, frag_refi)
        bw = BitWriter()
        self._frame_header_pack(bw, ftype, self.frame_qis)
        if ftype == INTRA_FRAME:
            if self._frame_qis is not None:
                self._block_qis_pack(bw, frag_qii, coded)
            return self._pack_tokens(bw, vecs_by_plane, INTRA_FRAME)
        self._coded_flags_pack(bw, coded)
        mb_luma_coded = np.zeros(g.nmbs, dtype=bool)
        lum = g.mb_maps[:, 0, :]
        has = (lum >= 0) & coded[np.clip(lum, 0, None)]
        mb_luma_coded = has.any(axis=1) & g.mb_valid
        coded_mbis = list(np.where(mb_luma_coded)[0])
        self._mb_modes_pack(bw, mb_modes, coded_mbis)
        self._mvs_pack(bw, mb_modes, mb_mvs, coded_mbis, coded)
        if self._frame_qis is not None:
            self._block_qis_pack(bw, frag_qii, coded)
        return self._pack_tokens(bw, vecs_by_plane, INTER_FRAME)

    # ------------------------------------------------------------------
    def _luma_skip_guard(self, fragis, skip, coded, frag_mode) -> None:
        """Un-skip the least-beneficial luma block of any non-NOMV MB whose
        entire coded luma would otherwise vanish (its mode would not be
        transmitted while mode-dependent fragments remain)."""
        from theora_tpu.constants import MODE_INTER_NOMV as _NOMV

        g = self.geometry
        skipmap = np.zeros(g.nfrags, dtype=bool)
        skipmap[fragis] = skip
        pos = {int(f): i for i, f in enumerate(fragis)}
        for mbi in np.where(g.mb_valid)[0]:
            lum = [f for f in g.mb_maps[mbi, 0, :4] if f >= 0 and coded[f]]
            if not lum or frag_mode[lum[0]] == _NOMV:
                continue
            if not all(skipmap[f] for f in lum):
                continue
            others = [
                f
                for pj in (1, 2)
                for f in g.mb_maps[mbi, pj]
                if f >= 0 and coded[f] and not skipmap[f]
            ]
            if others:
                keep = lum[0]
                skip[pos[keep]] = False
                skipmap[keep] = False

    # ------------------------------------------------------------------
    def _collect_frame_metrics(self, planes) -> None:
        """Append per-coded-fragment (qi, pli, qti, satd, bits, ssd) rows
        to self.collect -- the OC_COLLECT_METRICS analogue (collect.c) used
        to fit the mode-decision R-D tables."""
        from theora_tpu.constants import FRAME_SELF as _SELF

        dec = self._dec
        order = getattr(dec, "_last_token_order", None)
        bits = getattr(dec, "_frag_bits", None)
        if order is None or bits is None or len(order) == 0:
            return
        g = self.geometry
        recon = dec.buffers[dec.ref_idx[_SELF]]
        ssd_full = np.zeros(g.nfrags, dtype=np.int64)
        for pli in range(3):
            pl = g.planes[pli]
            vpad, hpad = g.plane_padding(pli)
            h, w = pl.nvfrags * 8, pl.nhfrags * 8
            d = planes[pli].astype(np.int64) - recon.planes[pli][
                vpad : vpad + h, hpad : hpad + w
            ]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            ssd_full[sl] = (
                (d * d)
                .reshape(pl.nvfrags, 8, pl.nhfrags, 8)
                .sum(axis=(1, 3))
                .reshape(-1)
            )
        # Causal neighborhood context: mean CHOSEN-mode SATD of the
        # left and up neighbor fragments (0 where uncoded/absent) --
        # the block-context feature the round-3 mode_rd closure said a
        # reopening would need (cross-block token-run/skip economy).
        ctx = np.zeros(g.nfrags, dtype=np.int64)
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            s = self._satd_frame[sl].reshape(pl.nvfrags, pl.nhfrags)
            left = np.zeros_like(s)
            left[:, 1:] = s[:, :-1]
            up = np.zeros_like(s)
            up[1:, :] = s[:-1, :]
            ctx[sl] = ((left + up) // 2).reshape(-1)
        self.collect.append(
            np.stack(
                [
                    np.full(len(order), self.qi, dtype=np.int64),
                    g.frag_pli[order].astype(np.int64),
                    self._qti_frame[order].astype(np.int64),
                    self._satd_frame[order],
                    bits.astype(np.int64),
                    ssd_full[order],
                    ctx[order],
                ],
                axis=1,
            )
        )

    # ------------------------------------------------------------------
    def _stash_recon_state(self, ftype, coded, frag_refi, frag_mode,
                           frag_mv, frag_qii, per_plane) -> None:
        """Capture the state needed for the closed loop\'s entropy-free
        reconstruction (Decoder.reconstruct_from_state); only available
        when the trellis path built scan permutations."""
        self._recon_state = None
        if not self.fast_recon:
            return
        if self.fast_recon == "auto" and ftype != INTRA_FRAME:
            return
        scan = self._trellis_scan
        if scan is None or not all(isinstance(p, tuple) for p in scan):
            return
        qz = [
            per_plane[pli][1][scan[pli][1]]
            for pli in range(3)
            if len(scan[pli][1])
        ]
        qz_order = (
            np.concatenate(qz) if qz else np.zeros((0, 64), np.int32)
        )
        g = self.geometry
        qii = (
            frag_qii
            if frag_qii is not None
            else np.zeros(g.nfrags, dtype=np.int32)
        )
        self._recon_state = (
            0 if ftype == INTRA_FRAME else 1,
            list(self.frame_qis), coded, frag_refi, frag_mode, frag_mv,
            qii, qz_order,
        )

    # ------------------------------------------------------------------
    def _pad_plane(self, plane: np.ndarray, pad: int = 16) -> np.ndarray:
        return np.pad(plane, pad, mode="edge")

    # ------------------------------------------------------------------
    def _coded_flags_pack(self, bw: BitWriter, coded: np.ndarray) -> None:
        """(encode.c:487-589)"""
        g = self.geometry
        try:
            from theora_tpu.native import coded_flags_pack_native

            buf, nbits, sb_partial = coded_flags_pack_native(
                coded, g.scan_fragis, g.scan_sbi, g.nsbs
            )
            bw.append_bits(buf, nbits)
            self._sb_partial = sb_partial
            return
        except (ImportError, RuntimeError):
            pass
        # SB classification.
        sb_any = np.zeros(g.nsbs, dtype=bool)
        sb_all = np.ones(g.nsbs, dtype=bool)
        for i in range(len(g.scan_fragis)):
            c = coded[g.scan_fragis[i]]
            sbi = g.scan_sbi[i]
            sb_any[sbi] |= c
            sb_all[sbi] &= c
        has_frags = np.zeros(g.nsbs, dtype=bool)
        has_frags[g.scan_sbi] = True
        sb_partial = sb_any & ~(sb_all & has_frags)
        sb_full = sb_all & has_frags & ~sb_partial
        # partial flags
        flag = int(sb_partial[0])
        bw.write(flag, 1)
        sbi = 0
        while sbi < g.nsbs:
            run = 0
            while sbi < g.nsbs and int(sb_partial[sbi]) == flag:
                run += 1
                sbi += 1
            sb_run_pack(bw, run, flag, sbi >= g.nsbs)
            flag = 1 - flag
        # full flags (for non-partial SBs)
        if sb_partial.sum() < g.nsbs:
            order = [s for s in range(g.nsbs) if not sb_partial[s]]
            flag = int(sb_full[order[0]])
            bw.write(flag, 1)
            i = 0
            while i < len(order):
                run = 0
                while i < len(order) and int(sb_full[order[i]]) == flag:
                    run += 1
                    i += 1
                sb_run_pack(bw, run, flag, i >= len(order))
                flag = 1 - flag
        # block flags within partial SBs
        if sb_partial.any():
            scan_sel = sb_partial[g.scan_sbi]
            flags = coded[g.scan_fragis[scan_sel]].astype(int)
            flag = int(flags[0])
            bw.write(flag, 1)
            i = 0
            while i < len(flags):
                run = 0
                while i < len(flags) and flags[i] == flag:
                    run += 1
                    i += 1
                # Runs cannot exceed 30: a partial SB has <= 15 same-flag
                # blocks, and a run can span at most 2 partial SBs
                # (encode.c:425-452).
                assert run <= 30, "impossible block run length"
                block_run_pack(bw, run)
                flag = 1 - flag
        self._sb_partial = sb_partial

    # ------------------------------------------------------------------
    def _mb_modes_pack(self, bw: BitWriter, mb_modes, coded_mbis) -> None:
        """Scheme selection by exact bit count + emission
        (encode.c:591-621)."""
        from theora_tpu.constants import MODE_ALPHABETS

        try:
            from theora_tpu.native import mb_modes_pack_native

            modes = [int(mb_modes[mbi]) for mbi in coded_mbis]
            buf, nbits = mb_modes_pack_native(
                modes, np.asarray(MODE_ALPHABETS, dtype=np.int32)
            )
            bw.append_bits(buf, nbits)
            return
        except (ImportError, RuntimeError):
            pass

        vlc_bits = [1, 2, 3, 4, 5, 6, 7, 7]
        hist = np.zeros(8, dtype=np.int64)
        for mbi in coded_mbis:
            hist[mb_modes[mbi]] += 1
        # Scheme 0: custom ranking by descending frequency.
        order0 = np.argsort(-hist, kind="stable")
        ranks0 = np.empty(8, dtype=np.int64)
        ranks0[order0] = np.arange(8)
        cost0 = 24 + int(sum(hist[m] * vlc_bits[ranks0[m]] for m in range(8)))
        costs = [cost0]
        for scheme in range(1, 7):
            alpha = MODE_ALPHABETS[scheme - 1]
            rank = {int(alpha[r]): r for r in range(8)}
            costs.append(int(sum(hist[m] * vlc_bits[rank[m]] for m in range(8))))
        costs.append(3 * int(hist.sum()))  # scheme 7 CLC
        scheme = int(np.argmin(costs))
        bw.write(scheme, 3)
        if scheme == 0:
            for m in range(8):
                bw.write(int(ranks0[m]), 3)
            rank = {m: int(ranks0[m]) for m in range(8)}
        elif scheme == 7:
            rank = {m: m for m in range(8)}
        else:
            alpha = MODE_ALPHABETS[scheme - 1]
            rank = {int(alpha[r]): r for r in range(8)}
        vlc_codes = [0b0, 0b10, 0b110, 0b1110, 0b11110, 0b111110, 0b1111110,
                     0b1111111]
        for mbi in coded_mbis:
            r = rank[int(mb_modes[mbi])]
            if scheme == 7:
                bw.write(r, 3)
            else:
                bw.write(vlc_codes[r], vlc_bits[r])

    # ------------------------------------------------------------------
    def _mvs_pack(self, bw: BitWriter, mb_modes, mb_mvs, coded_mbis, coded) -> None:
        """(encode.c:623-683)"""
        from theora_tpu.constants import (
            MODE_GOLDEN_MV,
            MODE_INTER_MV,
            MODE_INTER_MV_FOUR,
        )
        from theora_tpu.huffman import MV_VLC_BOOK

        # Build encode tables from the decode books.
        if not hasattr(self, "_mv_vlc_codes"):
            codes = {}
            for t, p, n in MV_VLC_BOOK.codes:
                codes.setdefault(t - 32, (p, n))
            self._mv_vlc_codes = codes
        g = self.geometry
        mvs_to_code = []
        for mbi in coded_mbis:
            mode = int(mb_modes[mbi])
            if mode in (MODE_INTER_MV, MODE_GOLDEN_MV):
                mvs_to_code.append(tuple(mb_mvs[mbi]))
            elif mode == MODE_INTER_MV_FOUR:
                for bi in range(4):
                    fragi = g.mb_maps[mbi, 0, bi]
                    if fragi >= 0 and coded[fragi]:
                        mvs_to_code.append(
                            (int(self._frag_mv4[fragi, 0]),
                             int(self._frag_mv4[fragi, 1]))
                        )
        vlc_total = sum(
            self._mv_vlc_codes[dx][1] + self._mv_vlc_codes[dy][1]
            for dx, dy in mvs_to_code
        )
        clc_total = 12 * len(mvs_to_code)
        scheme = 1 if clc_total < vlc_total else 0
        bw.write(scheme, 1)
        for dx, dy in mvs_to_code:
            for v in (dx, dy):
                if scheme == 0:
                    p, n = self._mv_vlc_codes[v]
                    bw.write(p, n)
                else:
                    bw.write(2 * abs(v) + (1 if v < 0 else 0), 6)

    # ------------------------------------------------------------------
    def _residual_tokens_pack(self, bw: BitWriter, log: TokenLog, ftype) -> None:
        """Huffman table selection + token emission (encode.c:816-863)."""
        neb = DCT_TOKEN_EXTRA_BITS

        def count_bits(counts, hgi):
            bits = np.zeros(16, dtype=np.int64)
            for huffi in range(16):
                nb = np.array(
                    [self.huff_codes[huffi + (hgi << 4)][t][1] for t in range(32)]
                )
                bits[huffi] = int((counts * nb).sum())
            return bits

        # DC group.
        cy, cc = log.count_tokens(0, 1)
        huff_y = int(np.argmin(count_bits(cy, 0)))
        huff_c = int(np.argmin(count_bits(cc, 0)))
        bw.write(huff_y, 4)
        bw.write(huff_c, 4)
        self._emit_group(bw, log, 0, 1, [huff_y, huff_c])
        # AC groups share one index pair across all 4 groups.
        bits_y = np.zeros(16, dtype=np.int64)
        bits_c = np.zeros(16, dtype=np.int64)
        for hgi in range(1, 5):
            cy, cc = log.count_tokens(HUFF_LIST_MAX[hgi - 1], HUFF_LIST_MAX[hgi])
            bits_y += count_bits(cy, hgi)
            bits_c += count_bits(cc, hgi)
        huff_y = int(np.argmin(bits_y))
        huff_c = int(np.argmin(bits_c))
        bw.write(huff_y, 4)
        bw.write(huff_c, 4)
        for hgi in range(1, 5):
            self._emit_group(
                bw,
                log,
                HUFF_LIST_MAX[hgi - 1],
                HUFF_LIST_MAX[hgi],
                [huff_y + (hgi << 4), huff_c + (hgi << 4)],
            )
        return [huff_y, huff_c]

    def _emit_group(self, bw, log, zzi_start, zzi_end, huff_idxs) -> None:
        neb = DCT_TOKEN_EXTRA_BITS
        for zzi in range(zzi_start, zzi_end):
            for pli in range(3):
                codes = self.huff_codes[huff_idxs[(pli + 1) >> 1]]
                offs = int(log.token_offs[pli, zzi])
                toks = log.tokens[pli][zzi]
                ebs = log.ebs[pli][zzi]
                for ti in range(offs, len(toks)):
                    t = toks[ti]
                    pattern, nbits = codes[t]
                    bw.write(pattern, nbits)
                    if neb[t]:
                        bw.write(ebs[ti], int(neb[t]))
