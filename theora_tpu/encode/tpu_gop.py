"""Device-resident GOP encoder.

The entire per-frame decision pipeline runs on device: batched motion
estimation on original refs (ops/me_jax.py), per-MB mode decision, MC
residual, fDCT + quantization, R/D skip, and the bit-exact closed-loop
reconstruction (dequant + iDCT + recon + loop filter + UMV borders)
carried across the GOP by one lax.scan per plane -- the encode-side
counterpart of decode/tpu_batch.py.  The host runs only the bit-serial
entropy stages per frame (DC prediction, tokenization, Huffman
selection, packing) through Encoder.pack_frame_plan, which cannot change
the reconstruction, so encoder and decoder stay in sync by construction.

This is the batched-tensor redesign of the reference's sequential MB
loop (analyze.c:2288-2711, encode.c:1640-1784): decisions that the
reference interleaves with coding (neighbor-dependent mode costs, token
rollback skip) are reformulated order-free so every fragment of every
frame is one tensor program.  ME legality comes from the reference's own
*_ORIG design (mcenc.c:314-316): search references are source frames,
never reconstructions, so whole-GOP ME has no sequential dependency.

Mode set: the full 8-mode alphabet -- INTER_NOMV / INTER_MV /
INTER_MV_LAST / INTER_MV_LAST2 / INTER_MV_FOUR / GOLDEN_NOMV /
GOLDEN_MV / INTRA (analyze.c:2288-2711).  The LAST modes (and 4MV's
last-block update of the decoder's MV predictor) need sequential
state; the split here keeps the expensive part batched: the device
scores every MB against the frame's top-K shared candidate vectors,
the golden-frame search, and the per-block 4MV refine in one dispatch
(me_jax.plan_from_gop), then a trivial host pass walks MBs in
transmission order consulting those precomputed SADs -- arithmetic
only, no pixels touched on host.
"""
from __future__ import annotations

import functools

import numpy as np

from theora_tpu.constants import (
    FRAME_GOLD,
    FRAME_NONE,
    FRAME_PREV,
    FRAME_SELF,
    MODE_INTRA,
    MODE_GOLDEN_MV,
    MODE_GOLDEN_NOMV,
    MODE_INTER_MV,
    MODE_INTER_MV_FOUR,
    MODE_INTER_MV_LAST,
    MODE_INTER_MV_LAST2,
    MODE_INTER_NOMV,
)
from theora_tpu.decode.decoder import _MVMAP, _MVMAP2
from theora_tpu.encode.encoder import Encoder
from theora_tpu.info import INTRA_FRAME, INTER_FRAME, TheoraInfo
from theora_tpu.tpkt import Packet

# Device mode-decision ids (argmin order fixes deterministic ties).
_M_NOMV, _M_MV, _M_GOLD, _M_INTRA = 0, 1, 2, 3
_MODE_OF = {
    _M_NOMV: MODE_INTER_NOMV,
    _M_MV: MODE_INTER_MV,
    _M_GOLD: MODE_GOLDEN_NOMV,
    _M_INTRA: MODE_INTRA,
}


def detect_scene_cuts(frames, keyframe_freq: int,
                      threshold: float = 24.0) -> list[int]:
    """Deterministic scene-cut GOP segmentation for the batched tiers.

    The host tier's auto-keyframe is a sequential recode rule (re-encode
    an inter frame as intra when it outgrows the last keyframe,
    encoder.py:335-344; encode.c's analogue recodes on scene cuts) --
    inherently order-dependent, which would serialize the batched
    device/mesh encoders.  The batched redesign decides GOP
    boundaries up front from pixels alone: a frame opens a new GOP when
    the mean absolute luma delta to its predecessor exceeds `threshold`
    (a scene cut), and GOPs never exceed keyframe_freq frames.  The
    segmentation depends only on content, so every mesh shape derives
    the same boundaries and byte-identity across shapes is preserved.

    frames: list of [y, u, v] display-orientation planes.  Returns the
    sorted GOP start indices (always beginning with 0).
    """
    starts = [0]
    prev = None
    for i, fr in enumerate(frames):
        y = np.asarray(fr[0]).astype(np.float32)[::2, ::2]
        if prev is not None:
            if (
                i - starts[-1] >= keyframe_freq
                or float(np.abs(y - prev).mean()) > threshold
            ):
                starts.append(i)
        prev = y
    return starts


def gop_starts(frames, keyframe_freq: int, auto_keyframe: bool
               ) -> list[int]:
    """The clip's GOP start indices: fixed spacing, or scene-cut driven
    (bounded by keyframe_freq) with auto_keyframe."""
    if auto_keyframe:
        return detect_scene_cuts(frames, keyframe_freq)
    return list(range(0, len(frames), keyframe_freq))


def make_plane_scan(nv, nh, pad_y, pad_x, emit_recon=False,
                    frag_axis=None, use_trellis=False, n_qis=1):
    """Build the closed-loop encode scan for one plane geometry.

    Returned fn(init_prev, init_gold, cur_blocks [F, N, 8, 8] u8,
    refsel, o1y, o1x, o2y, o2x, use2, may_skip [F, N], is_intra [F],
    deq_intra, deq_inter [F, 64] i32, bv [F, 256] i32, lam [F] /
    lam_q_* [F] f32) -> (qdct [F, N, 64] i16, coded [F, N] bool[, recon
    planes], final prev plane).

    Quantizer inputs are PER FRAME (leading F axis): CBR and 2-pass
    rate control change qi frame to frame, like the reference
    (rate.c select_qi per frame); fixed-qi callers broadcast one row.

    With use_trellis, four trailing args are appended -- nb_intra /
    nb_inter [64, 32] f32 token bit costs (frame-type keyed, qi
    independent) and lam_t_intra / lam_t_inter [F] f32 -- and the R/D
    quantizer is replaced by the batched trellis
    (ops/transforms_jax.trellis_values), the device counterpart of the
    host Viterbi tokenizer.

    With frag_axis set (inside shard_map), N is this shard's fragment
    slice: the transform/quantize/skip work stays sharded and only the
    reconstructed 8x8 blocks are all-gathered over the axis to assemble
    the carried reference plane (replicated, like the decoder's) --
    tensor-parallel encode over the fragment dimension.

    With n_qis > 1 (adaptive quantization, the rate.c:175-201 qi-triple
    analogue), deq_intra/deq_inter are [F, K, 64] (slot 0 of every row
    already holding the BASE qi's DC quant -- DC always quantizes with
    qis[0]), the lam_q_*/lam_t_* args are [F, K] vectors, and each
    fragment evaluates the full quantize+recon chain at every qi,
    keeping the one minimizing 16*ssd + lam*(6*nnz + 2 + 6*sig) where
    sig charges the qi-RLE signaling (~1 extra bit for non-base rows,
    the host tier's convention).  An extra [F, N] uint8 qii output is
    appended before the carried plane.
    """
    import jax
    import jax.numpy as jnp

    from theora_tpu.ops import mc_jax as mc
    from theora_tpu.ops import transforms_jax as tj
    from theora_tpu.ops.loopfilter_jax import loop_filter_plane_jax
    from theora_tpu.pipeline import fill_borders

    h, w = nv * 8, nh * 8
    n = nv * nh

    def scan_fn(init_prev, init_gold,
                cur_blocks, refsel, o1y, o1x, o2y, o2x, use2, may_skip,
                is_intra, deq_intra, deq_inter, bv, lam, lam_q_intra,
                lam_q_inter, nb_intra=None, nb_inter=None,
                lam_t_intra=None, lam_t_inter=None, lam_sc=None):
        nl = cur_blocks.shape[1]
        if frag_axis is None:
            start = 0
        else:
            start = jax.lax.axis_index(frag_axis) * nl
        # Fragment ids may be padded past n for even sharding; clamp the
        # pads onto the last real fragment (their outputs are dropped and
        # the plane reassembly only uses the first n gathered blocks).
        fi = jnp.minimum(start + jnp.arange(nl), n - 1)

        def step(carry, xs):
            prev, gold = carry
            (curf, rsf, y1, x1, y2, x2, u2, ms, ik,
             deq_intra, deq_inter, bv, lam, lam_q_intra, lam_q_inter,
             lam_t_intra, lam_t_inter, lam_sc) = xs
            # MC via masked shifts over block neighborhoods
            # (ops/mc_jax.py), not per-element gathers. Sharded runs
            # take their fragment rows of the replicated neighborhood
            # tensor (row-granular take).
            # named_scope labels group profiler traces by codec stage
            # (theora_tpu/debug.py).
            with jax.named_scope("mc"):
                # Per-fragment reference select on the neighborhood
                # tensors, then one half-pel MC select -- the decode
                # scan's pattern (decode/tpu_batch.py), so GOLDEN_MV
                # uses the same offset arrays as the prev modes
                # (GOLDEN_NOMV falls out as the zero-offset case).
                nb_p = mc.block_neighborhoods(prev, nv, nh, pad_y, pad_x)
                nb_g = mc.block_neighborhoods(gold, nv, nh, pad_y, pad_x)
                unc_all = mc.plane_to_blocks(prev, nv, nh, pad_y, pad_x)
                if frag_axis is None:
                    nbs_p, nbs_g, unc = nb_p, nb_g, unc_all
                else:
                    nbs_p = jnp.take(nb_p, fi, axis=0)
                    nbs_g = jnp.take(nb_g, fi, axis=0)
                    unc = jnp.take(unc_all, fi, axis=0)
                unc = unc.astype(jnp.int32)
                nbs = jnp.where((rsf == 2)[:, None, None], nbs_g, nbs_p)
                s1, s2 = mc.mc_select2(nbs, y1, x1, y2, x2, pad_y, pad_x)
                selv = jnp.where(u2[:, None, None], (s1 + s2) >> 1, s1)
                pred = jnp.where((rsf == 0)[:, None, None], 128, selv)
            curi = curf.astype(jnp.int32)
            with jax.named_scope("fdct"):
                res = curi - pred
                dct = tj.fdct8x8(res)

            def quantize_recon(deq_i, deq_p, lqi, lqp, lti, ltp):
                """One qi row: quantize (trellis or R/D), reconstruct,
                and reduce nnz + SSD.  Counts and SSDs reduce in
                float32: every term is an integer below 2^24 (counts
                <= 64, squared diffs <= 255^2, their 64-sums <= 4.2M),
                so the accumulation is exact -- and the minor-axis
                int32 reduces these replace were the scan's hottest ops
                (3+ ms/frame in the 720p trace)."""
                deq = jnp.where((rsf == 0)[:, None], deq_i, deq_p)
                if use_trellis:
                    with jax.named_scope("trellis"):
                        qdct0 = tj.quantize(dct, deq)
                        acmin_v = jnp.where(rsf == 0, 3, 0)
                        nb_use = jnp.where(ik, nb_intra, nb_inter)
                        lam_t = jnp.where(ik, lti, ltp)
                        # Per-fragment chooser/tokenize lambda: the
                        # per-MB activity masking scale (all-ones when
                        # the mixed-frame gate is off; *1.0 is exact,
                        # so the default path is bit-identical).
                        qdct = tj.trellis_values(
                            dct, qdct0, deq,
                            lam_t.astype(jnp.float32) * lam_sc,
                            nb_use, acmin_v,
                        )
                else:
                    lam_q = jnp.where(rsf == 0, lqi, lqp).astype(
                        jnp.float32
                    )
                    with jax.named_scope("quantize_rd"):
                        qdct = tj.quantize_rd(dct, deq, lam_q)
                with jax.named_scope("idct_recon"):
                    nzf = (qdct != 0).astype(jnp.float32)
                    cnt = nzf.sum(axis=1)
                    dc_only = cnt - nzf[:, 0] == 0.0
                    residual = tj.dequantize_idct(
                        qdct, deq, qdct[:, 0], deq[:, 0], dc_only
                    )
                    recon = jnp.clip(residual + pred, 0, 255)
                dr = (recon - curi).astype(jnp.float32)
                ssd = (dr * dr).sum(axis=(1, 2)).astype(jnp.int32)
                return qdct, cnt, recon, ssd

            if n_qis == 1:
                qdct, cnt, recon, ssd_rec = quantize_recon(
                    deq_intra, deq_inter, lam_q_intra, lam_q_inter,
                    lam_t_intra, lam_t_inter,
                )
                qii = jnp.zeros((nl,), jnp.uint8)
            else:
                # Adaptive quant: evaluate every qi row, keep the best
                # by the skip stage's own R/D proxy (+1 signaling bit
                # for non-base rows).
                best = None
                for k in range(n_qis):
                    qk, ck, rk, sk = quantize_recon(
                        deq_intra[k], deq_inter[k],
                        lam_q_intra[k], lam_q_inter[k],
                        lam_t_intra[k], lam_t_inter[k],
                    )
                    cost = (
                        16 * sk
                        + (lam * lam_sc
                           * (6.0 * ck + 2.0 + (6.0 if k else 0.0)))
                        .astype(jnp.int32)
                    )
                    if best is None:
                        best = (cost, qk, ck, rk, sk,
                                jnp.zeros_like(sk, jnp.uint8))
                    else:
                        win = cost < best[0]
                        best = (
                            jnp.where(win, cost, best[0]),
                            jnp.where(win[:, None], qk, best[1]),
                            jnp.where(win, ck, best[2]),
                            jnp.where(win[:, None, None], rk, best[3]),
                            jnp.where(win, sk, best[4]),
                            jnp.where(win, np.uint8(k), best[5]),
                        )
                _, qdct, cnt, recon, ssd_rec, qii = best
            with jax.named_scope("skip_rd"):
                du = (unc - curi).astype(jnp.float32)
                ssd_unc = (du * du).sum(axis=(1, 2)).astype(jnp.int32)
                lamterm = (lam * (6.0 * cnt + 2.0)).astype(jnp.int32)
                skip = ms & (16 * ssd_unc <= 16 * ssd_rec + lamterm) & ~ik
                coded = ~skip
            blocks = jnp.where(
                coded[:, None, None], recon, unc
            ).astype(jnp.uint8)
            if frag_axis is None:
                blocks_full, coded_full = blocks, coded
            else:
                blocks_full = jax.lax.all_gather(
                    blocks, frag_axis, axis=0, tiled=True
                )
                coded_full = jax.lax.all_gather(
                    coded, frag_axis, axis=0, tiled=True
                )
            plane = mc.blocks_to_plane(blocks_full[:n], nv, nh,
                                       pad_y, pad_x)
            with jax.named_scope("loopfilter"):
                plane = loop_filter_plane_jax(
                    plane, coded_full[:n].reshape(nv, nh), bv, nv, nh,
                    pad_y, pad_x,
                )
            with jax.named_scope("borders"):
                plane = fill_borders(plane, h, w, pad_y, pad_x)
            gold_new = jnp.where(ik, plane, gold)
            qout = jnp.where(coded[:, None], qdct, 0).astype(jnp.int16)
            # Per-block nonzero counts (reused from the skip stage) ride
            # the scan outputs so the host can size the sparse download
            # without re-reducing [F, N, 64] afterwards.
            nnz = jnp.where(coded, cnt, 0.0).astype(jnp.uint8)
            ys = (qout, coded, nnz)
            if n_qis > 1:
                ys = ys + (qii,)
            if emit_recon:
                ys = ys + (plane,)
            return (plane, gold_new), ys

        if lam_t_intra is None:
            # Non-trellis path: the lam_t slots are unused in step but
            # must still be scannable arrays.
            lam_t_intra = lam
            lam_t_inter = lam
        if lam_sc is None:
            lam_sc = jnp.ones(cur_blocks.shape[:2], jnp.float32)
        (prev_f, _), ys = jax.lax.scan(
            step,
            (init_prev, init_gold),
            (cur_blocks, refsel, o1y, o1x, o2y, o2x, use2, may_skip,
             is_intra, deq_intra, deq_inter, bv, lam, lam_q_intra,
             lam_q_inter, lam_t_intra, lam_t_inter, lam_sc),
        )
        return ys + (prev_f,)

    return scan_fn


@functools.partial(
    __import__("jax").jit,
    static_argnames=("nv", "nh", "pad_y", "pad_x", "emit_recon",
                     "use_trellis", "n_qis"),
)
def _scan_encode_plane(
    cur_planes, refsel, o1y, o1x, o2y, o2x, use2, may_skip, is_intra,
    deq_intra, deq_inter, bv, lam, lam_q_intra, lam_q_inter,
    nb_intra, nb_inter, lam_t_intra, lam_t_inter,
    nv, nh, pad_y, pad_x, emit_recon=False, use_trellis=False, n_qis=1,
    lam_sc=None,
):
    """Single-device jitted wrapper over make_plane_scan.

    cur_planes: [F, nv*8, nh*8] u8 raw planes -- the block view is
    derived on device so each frame's pixels cross the host<->device
    link exactly once (the luma array is the same buffer the fused ME
    plan dispatch consumed).  The gray initial reference planes are
    materialized on device here (every GOP restarts from a keyframe), so
    they never ride the upload -- and passing one buffer object for two
    parameters is avoided, which this jax version's executable fastpath
    mishandles when the trace also hoists large constants."""
    import jax.numpy as jnp

    init_prev = jnp.full(
        (nv * 8 + 2 * pad_y, nh * 8 + 2 * pad_x), 0x80, jnp.uint8
    )
    init_gold = init_prev
    F = cur_planes.shape[0]
    cur_blocks = (
        cur_planes.reshape(F, nv, 8, nh, 8)
        .transpose(0, 1, 3, 2, 4)
        .reshape(F, nv * nh, 8, 8)
    )
    extra = (
        (nb_intra, nb_inter, lam_t_intra, lam_t_inter)
        if use_trellis else ()
    )
    out = make_plane_scan(nv, nh, pad_y, pad_x, emit_recon,
                          use_trellis=use_trellis, n_qis=n_qis)(
        init_prev, init_gold,
        cur_blocks, refsel, o1y, o1x, o2y, o2x, use2, may_skip, is_intra,
        deq_intra, deq_inter, bv, lam, lam_q_intra, lam_q_inter, *extra,
        lam_sc=lam_sc,
    )
    # Per-block nonzero counts are emitted by the scan itself (the skip
    # stage already reduces them) so the host can size the sparse
    # coefficient download without an extra [F, N, 64] pass; reorder to
    # keep this wrapper's historical (.., prev_f, nnz) output layout,
    # with the adaptive-quant qii riding after nnz when present.
    out = list(out)
    qout, coded, nnz = out[:3]
    rest = out[3:]
    qii = rest.pop(0) if n_qis > 1 else None
    recon = rest.pop(0) if emit_recon else None
    prev_f = rest.pop(0)
    res = (qout, coded)
    if emit_recon:
        res = res + (recon,)
    res = res + (prev_f, nnz)
    if qii is not None:
        res = res + (qii,)
    return res


@functools.partial(__import__("jax").jit, static_argnames=("cap",))
def _compact_qdct(qdct, cap):
    """Size-proportional coefficient download: flat-compact the nonzero
    entries of qdct [F, N, 64] i16 into two 1-D arrays of cap records --
    22 bits each (zzi | (val & 0xffff) << 6) split as uint16 low halves
    + uint8 high 6 bits -- in flat (block-major, zzi-ascending) order.
    cap is a static bucket >= the true count; extra slots are 0.  Two
    1-D arrays rather than one [cap, 3] stack, so no device layout can
    pad a narrow minor dim into the download.  ~13x less transfer than
    the dense array at typical occupancy."""
    import jax.numpy as jnp

    flat = qdct.reshape(-1).astype(jnp.int32)
    mask = flat != 0
    idx = jnp.cumsum(mask.astype(jnp.int32)) - 1
    tgt = jnp.where(mask, idx, cap)
    rec = (jnp.arange(flat.shape[0], dtype=jnp.int32) & 63) | (
        (flat & 0xFFFF) << 6
    )
    out = jnp.zeros((cap + 1,), jnp.int32).at[tgt].set(rec, mode="drop")
    out = out[:cap]
    return (
        (out & 0xFFFF).astype(jnp.uint16),
        ((out >> 16) & 0x3F).astype(jnp.uint8),
    )


def _cap_bucket(total: int) -> int:
    """Smallest {5,6,7,8}*2^(k-3) >= total: quarter-octave steps bound
    the download overshoot at <=20% while keeping the number of distinct
    compiled compaction shapes small (4 per octave)."""
    total = max(int(total), 4)
    p = 1 << (total - 1).bit_length()
    for m in (5 * p // 8, 6 * p // 8, 7 * p // 8):
        if total <= m:
            return m
    return p


def _expand_packed(packed, nnz):
    """Rebuild dense qdct [F, N, 64] i16 from the (uint16 low, uint8
    high) compacted records (zzi | val<<6, block-major) and the
    per-block nonzero counts."""
    F, N = nnz.shape
    total = int(nnz.astype(np.int64).sum())
    lo, hi = packed
    rec = lo[:total].astype(np.int32) | (hi[:total].astype(np.int32) << 16)
    vals = ((rec >> 6) & 0xFFFF).astype(np.uint16).view(np.int16)
    zzi = (rec & 63).astype(np.uint8)
    out = np.zeros((F * N, 64), np.int16)
    bids = np.repeat(np.arange(F * N), nnz.reshape(-1))
    out[bids, zzi] = vals
    return out.reshape(F, N, 64)




class TpuGopEncoder:
    """Encode clips with the decision+pixel pipeline resident on device.

    Output streams are valid Theora (decode bit-exactly in the reference
    decoder); frame decisions follow the device policy above, so bytes
    differ from the host tier's but quality is comparable.  Sequential
    and mesh-sharded runs of this encoder are byte-identical.
    """

    def __init__(self, info: TheoraInfo, qi: int | None = None,
                 rd_strength: float = 3.0, use_trellis: bool = True):
        info.validate()
        self.info = info
        self.enc = Encoder(info)
        self.enc.use_trellis = False
        self.g = self.enc.geometry
        self.rd_strength = rd_strength
        # Batched device trellis (ops/transforms_jax.trellis_values)
        # replacing the heuristic R/D quantizer in the plane scans.
        self.use_trellis = bool(use_trellis)
        # Adaptive quantization (qi triple + per-fragment qii chosen by
        # the scan's R/D proxy).  Default "auto" -- the same
        # saturation-region gate as the host tier (encoder.py
        # _adaptive_qi_triple), so the flagship tier no longer ships
        # the textured-q56 quality hole the host tier's gate exists to
        # close.  False = never, True =
        # whenever the reference spec allows (log_qavg < 7).
        self.adaptive_quant: bool | str = "auto"
        self.sp_level = 0
        self._no_mc = False
        # Predicted sparse-download capacities per (plane, GOP length),
        # carried across GOPs so compaction can be enqueued eagerly.
        self._cap_est: dict = {}
        # Lossless sparse temporal-delta pixel upload (delta_upload.py):
        # byte-identical expanded stacks, dense fallback on noise-like
        # content.
        self.delta_upload = True
        self._uploader = None
        g = self.g
        self._mb_list = np.where(g.mb_valid)[0]
        frag0 = g.mb_maps[self._mb_list, 0, 0]
        self._mb_row = g.frag_y[frag0] // 2
        self._mb_col = g.frag_x[frag0] // 2
        # Per-MB luma block grid coordinates (mb_maps bi order) and
        # whether the MB has all 4 luma blocks (4MV eligibility),
        # precomputed for the per-frame mode-decision walk.
        nh8 = g.planes[0].nhfrags
        lf = g.mb_maps[self._mb_list, 0]  # [nmb, 4] plane-local luma ids
        self._mb_birc = np.stack([lf // nh8, lf % nh8], axis=-1)
        self._mb_all4 = (lf >= 0).all(axis=1)
        # Trellis token bit costs [64, 32]: Huffman code length + extra
        # bits at the initial table prediction (encoder.py _trellis_nb;
        # the host packer still selects the frame's tables exactly).
        from theora_tpu.constants import DCT_TOKEN_EXTRA_BITS
        from theora_tpu.encode.encoder import _ZZI_GROUP

        nbt = np.zeros((5, 32), np.float32)
        for gi in range(5):
            for t in range(32):
                nbt[gi, t] = (
                    self.enc.huff_codes[gi << 4][t][1]
                    + DCT_TOKEN_EXTRA_BITS[t]
                )
        self._nb_dev = nbt[_ZZI_GROUP]
        self.set_qi(int(info.quality if qi is None else qi))

    # ------------------------------------------------------------------
    def set_qi(self, qi: int) -> None:
        """Set the quantizer and recompute derived parameters (CBR-style
        feedback between GOP batches changes qi; the compiled scans are
        qi-independent -- tables arrive as arrays)."""
        self.qi = int(np.clip(qi, 0, 63))
        self.enc.qi = self.qi
        # Host-policy bias scale (encoder.py): rate cost in SAD units
        # tracks the quantizer step.
        dq = self.enc.dequant
        self._bias_scale = min(
            1.0, float(dq[self.qi, 0, 1, 1]) / float(dq[40, 0, 1, 1])
        )
        self._mv_bits_sad = (
            28 * int(self.rd_strength * 4 + 4) * self._bias_scale
        )
        from theora_tpu.ops.fdct_np import rd_lambda

        self._lam = (
            rd_lambda(self.qi, int(dq[self.qi, 0, 1, 1]))
            * self.rd_strength * 4.0
        )
        from theora_tpu import tables as _tables

        rdl = _tables.RD_LAMBDA.get(
            int(self.info.pixel_fmt), _tables.RD_LAMBDA[0]
        )
        # DCT-domain trellis lambdas per frame type (host tier units).
        self._lam_t = self._lam_t_for(self.qi)
        flimit = self.enc.qinfo["loop_filter_limits"][self.qi]
        from theora_tpu.ops.loopfilter_np import build_bounding_values

        self._bv = (
            build_bounding_values(flimit).astype(np.int32)
            if flimit else np.zeros(256, np.int32)
        )

    # ------------------------------------------------------------------
    def _lam_t_for(self, qi: int):
        """DCT-domain trellis lambdas (intra, inter) at a qi."""
        from theora_tpu import tables as _tables

        rdl = _tables.RD_LAMBDA.get(
            int(self.info.pixel_fmt), _tables.RD_LAMBDA[0]
        )
        return (float(rdl[0][qi]), float(rdl[1][qi]))

    # ------------------------------------------------------------------
    def _adaptive_qis(self, keyframe_only: bool = False,
                      qi: int | None = None):
        """The GOP's qi list: [base] normally; with adaptive_quant,
        the host tier's reference-spec quantizer set (log_qavg
        -0.6/+0.7 clusters, encoder._adaptive_qi_triple) under the
        SAME "auto" saturation gate -- the tier's own mode passes
        through unchanged, so "auto" gates, True always engages (where
        the spec allows), False never does.  The GOP shares one qi
        list; mixed GOPs use the inter gate/triple (the dominant frame
        type -- the keyframe's qii flags are still chosen by exact R/D
        so a 3-qi keyframe can only win or tie), keyframe-only GOPs
        the intra one."""
        base = self.qi if qi is None else int(np.clip(qi, 0, 63))
        if not self.adaptive_quant or self.sp_level >= 2:
            return (base,)
        saved_aq = self.enc.adaptive_quant
        saved_qi = self.enc.qi
        self.enc.adaptive_quant = self.adaptive_quant
        self.enc.qi = base
        try:
            qis = self.enc._adaptive_qi_triple(0 if keyframe_only else 1)
        finally:
            self.enc.adaptive_quant = saved_aq
            self.enc.qi = saved_qi
        return tuple(qis) if qis else (base,)

    # ------------------------------------------------------------------
    def set_splevel(self, lvl: int) -> None:
        """Speed levels mirroring the host tier's semantics
        (encint.h:216-227): 0-1 full quality (batched trellis), 2-3
        fast analysis (heuristic R/D quantizer -- the trellis is the
        device tier's main quantization cost, see BASELINE.md), 4 no-MC
        (MV modes priced out of the decision)."""
        lvl = int(np.clip(lvl, 0, 4))
        self.sp_level = lvl
        self.use_trellis = lvl < 2
        self._no_mc = lvl >= 4

    # ------------------------------------------------------------------
    def flush_headers(self) -> list[Packet]:
        return self.enc.flush_headers()

    # ------------------------------------------------------------------
    def _plane_blocks(self, plane: np.ndarray) -> np.ndarray:
        h, w = plane.shape
        return (
            plane.reshape(h // 8, 8, w // 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(-1, 8, 8)
        )

    # ------------------------------------------------------------------
    def _plan_frames(self, cur, prev, gold):
        """ME + mode decision for a batch of B independent frames.

        cur/prev/gold: [B, H, W] u8 (prev/gold are the per-frame
        *original* references).  Returns B (mb_modes, mb_mvs) pairs.
        Batching across GOPs is legal for the same reason as across
        frames (original refs only).
        """
        import jax
        import jax.numpy as jnp

        from theora_tpu.ops import me_jax

        outs = me_jax.plan(
            jnp.asarray(np.ascontiguousarray(cur)),
            jnp.asarray(np.ascontiguousarray(prev)),
            jnp.asarray(np.ascontiguousarray(gold)),
        )
        return self._decide_frames(jax.device_get(outs), cur.shape[0])

    # ------------------------------------------------------------------
    def _decide_frames(self, outs, B):
        """Host mode decision over the downloaded fused-plan arrays
        (transfer-compact dtypes widened back to int32)."""
        (mv, sad_mv, sad_nomv, sad_gold, sad_intra, cands,
         cand_sads, gmv, sad_gmv, bmv, bsad) = (
            np.asarray(o).astype(np.int32) for o in outs
        )
        return [
            self._decide_frame(
                fi, mv, sad_mv, sad_nomv, sad_gold, sad_intra,
                cands, cand_sads, gmv, sad_gmv, bmv, bsad,
            )
            for fi in range(B)
        ]

    # ------------------------------------------------------------------
    def _decide_frame(self, fi, mv, sad_mv, sad_nomv, sad_gold, sad_intra,
                      cands, cand_sads, gmv, sad_gmv, bmv, bsad):
        """Sequential LAST/LAST2-aware mode decision for one frame --
        the host tier's policy (encoder.py) over device-precomputed
        SADs, now over the full 8-mode alphabet (analyze.c:2288-2711):
        NOMV/MV/LAST/LAST2/4MV/GOLDEN_NOMV/GOLDEN_MV/INTRA.  Walks MBs
        in transmission (mbi) order maintaining the decoder's last/prior
        MV state (decode.c:806-900); 4MV advances last to the final luma
        block's vector, GOLDEN_MV leaves the state untouched."""
        g = self.g
        b = self._bias_scale
        MVB = self._mv_bits_sad
        try:
            from theora_tpu.native import mode_decide_native

            return mode_decide_native(
                self._mb_list, self._mb_row, self._mb_col,
                self._mb_all4, self._mb_birc,
                mv[fi], sad_mv[fi], sad_nomv[fi], sad_gold[fi],
                sad_intra[fi], cands[fi], cand_sads[fi], gmv[fi],
                sad_gmv[fi], bmv[fi], bsad[fi],
                g.nmbs, b, MVB, self._no_mc,
            )
        except (ImportError, RuntimeError):
            pass  # no native library: the Python walk below, same result
        cand_idx = {
            (int(c[0]), int(c[1])): k
            for k, c in enumerate(cands[fi])
            if (c != 0).any()
        }
        mb_modes = np.where(g.mb_valid, 0, -1).astype(np.int32)
        mb_mvs = np.zeros((g.nmbs, 2), dtype=np.int32)
        mb_bmvs = np.zeros((g.nmbs, 4, 2), dtype=np.int32)
        last = (0, 0)
        prior = (0, 0)
        for i, mbi in enumerate(self._mb_list):
            r, c = self._mb_row[i], self._mb_col[i]
            best = (int(mv[fi, r, c, 0]), int(mv[fi, r, c, 1]))
            gbest = (int(gmv[fi, r, c, 0]), int(gmv[fi, r, c, 1]))
            # Luma block grid rows/cols for this MB, in mb_maps bi order.
            bi_rc = self._mb_birc[i]

            def sad_at(v):
                if v == best:
                    return int(sad_mv[fi, r, c])
                k = cand_idx.get(v)
                return int(cand_sads[fi, k, r, c]) if k is not None else None

            costs = [(int(sad_nomv[fi, r, c]), MODE_INTER_NOMV, None)]
            costs.append(
                (int(sad_intra[fi, r, c]) + 350 * b, MODE_INTRA, None)
            )
            costs.append(
                (int(sad_gold[fi, r, c]) + 80 * b, MODE_GOLDEN_NOMV, None)
            )
            if self._no_mc:
                best = (0, 0)
                gbest = (0, 0)
            if best != (0, 0):
                costs.append((int(sad_mv[fi, r, c]) + MVB,
                              MODE_INTER_MV, best))
            if gbest != (0, 0):
                costs.append(
                    (int(sad_gmv[fi, r, c]) + MVB + 80 * b,
                     MODE_GOLDEN_MV, gbest)
                )
            if not self._no_mc and self._mb_all4[i]:
                s4 = int(bsad[fi, r, c])
                costs.append(
                    (s4 + 640 * b + 4 * MVB, MODE_INTER_MV_FOUR, None)
                )
            if last != (0, 0):
                s = sad_at(last)
                if s is not None:
                    costs.append((s + 16 * b, MODE_INTER_MV_LAST, last))
            if prior != (0, 0) and prior != last:
                s = sad_at(prior)
                if s is not None:
                    costs.append((s + 24 * b, MODE_INTER_MV_LAST2, prior))
            cost, mode, vec = min(costs, key=lambda t: t[0])
            mb_modes[mbi] = mode
            if mode == MODE_INTER_MV:
                mb_mvs[mbi] = vec
                prior = last
                last = vec
            elif mode == MODE_INTER_MV_LAST:
                mb_mvs[mbi] = vec
            elif mode == MODE_INTER_MV_LAST2:
                mb_mvs[mbi] = vec
                prior, last = last, prior
            elif mode == MODE_GOLDEN_MV:
                mb_mvs[mbi] = vec
            elif mode == MODE_INTER_MV_FOUR:
                mb_bmvs[mbi] = bmv[fi, bi_rc[:, 0], bi_rc[:, 1]]
                # All 4 luma blocks stay coded (skip rule), so the
                # decoder's last advances to block bi=3's vector.
                prior = last
                last = (int(mb_bmvs[mbi, 3, 0]), int(mb_bmvs[mbi, 3, 1]))
        return mb_modes, mb_mvs, mb_bmvs

    # ------------------------------------------------------------------
    def _frag_plan(self, mb_modes, mb_mvs, mb_bmvs=None):
        """Per-fragment refsel/mv/may_skip from the MB plan.
        mb_bmvs: [nmbs, 4, 2] per-luma-block vectors for 4MV MBs."""
        g = self.g
        info = self.info
        nfrags = g.nfrags
        refsel = np.zeros(nfrags, dtype=np.int8)
        frag_mv = np.zeros((nfrags, 2), dtype=np.int32)
        may_skip = np.zeros(nfrags, dtype=bool)
        rs_of = np.zeros(64, np.int8)
        rs_of[MODE_INTER_NOMV] = 1
        rs_of[MODE_INTER_MV] = 1
        rs_of[MODE_INTER_MV_LAST] = 1
        rs_of[MODE_INTER_MV_LAST2] = 1
        rs_of[MODE_INTER_MV_FOUR] = 1
        rs_of[MODE_GOLDEN_NOMV] = 2
        rs_of[MODE_GOLDEN_MV] = 2
        rs_of[MODE_INTRA] = 0
        mv_modes = np.zeros(64, bool)
        for m in (MODE_INTER_MV, MODE_INTER_MV_LAST, MODE_INTER_MV_LAST2,
                  MODE_GOLDEN_MV):
            mv_modes[m] = True
        maps = g.mb_maps[self._mb_list]          # [nmb, 3, 4]
        modes = mb_modes[self._mb_list]
        mvs = mb_mvs[self._mb_list]
        flat = maps.reshape(-1)
        ok = flat >= 0
        rep_modes = np.repeat(modes, 12)
        rep_mvs = np.repeat(mvs, 12, axis=0)
        refsel[flat[ok]] = rs_of[rep_modes[ok]]
        frag_mv[flat[ok]] = np.where(
            mv_modes[rep_modes[ok]][:, None], rep_mvs[ok], 0
        )
        # 4MV: per-block luma vectors, chroma from their per-format
        # average (the decoder's derivation, state.c:33-97).
        if mb_bmvs is not None and (modes == MODE_INTER_MV_FOUR).any():
            pf = int(info.pixel_fmt)

            def div_round(v, shift, rval):
                return (int(v) + (-1 if v < 0 else 0) + rval) >> shift

            for i in np.where(modes == MODE_INTER_MV_FOUR)[0]:
                mbi = self._mb_list[i]
                lb = mb_bmvs[mbi]
                for bi in range(4):
                    fragi = g.mb_maps[mbi, 0, bi]
                    if fragi >= 0:
                        frag_mv[fragi] = lb[bi]
                cb = [(0, 0)] * 4
                if pf == 0:
                    dx = int(lb[:, 0].sum())
                    dy = int(lb[:, 1].sum())
                    cb[0] = (div_round(dx, 2, 2), div_round(dy, 2, 2))
                elif pf == 2:
                    for k, (a, bb) in enumerate(((0, 1), (2, 3))):
                        cb[k * 2] = (
                            div_round(int(lb[a, 0] + lb[bb, 0]), 1, 1),
                            div_round(int(lb[a, 1] + lb[bb, 1]), 1, 1),
                        )
                elif pf == 1:
                    for k, (a, bb) in enumerate(((0, 2), (1, 3))):
                        cb[k] = (
                            div_round(int(lb[a, 0] + lb[bb, 0]), 1, 1),
                            div_round(int(lb[a, 1] + lb[bb, 1]), 1, 1),
                        )
                else:
                    cb = [tuple(v) for v in lb]
                for pli in (1, 2):
                    for bi in range(4):
                        fragi = g.mb_maps[mbi, pli, bi]
                        if fragi >= 0:
                            frag_mv[fragi] = cb[bi]
        # Luma: only NOMV blocks may skip (mode transmission rides on
        # coded luma; untransmitted modes decode as NOMV).  Chroma: any
        # mode (uncoded chroma is a zero-MV prev copy regardless).
        luma = maps[:, 0, :].reshape(-1)
        okl = luma >= 0
        may_skip[luma[okl]] = (
            np.repeat(modes, 4)[okl] == MODE_INTER_NOMV
        )
        chroma = maps[:, 1:, :].reshape(-1)
        okc = chroma >= 0
        may_skip[chroma[okc]] = True
        return refsel, frag_mv, may_skip

    # ------------------------------------------------------------------
    def _plane_inputs(self, pli, planes_f, refsel, frag_mv, may_skip,
                      with_cur=True):
        """Scan inputs for one plane of one frame."""
        g = self.g
        info = self.info
        pl = g.planes[pli]
        sl = slice(pl.froffset, pl.froffset + pl.nfrags)
        qpx = 1 if (pli != 0 and not (info.pixel_fmt & 1)) else 0
        qpy = 1 if (pli != 0 and not (info.pixel_fmt & 2)) else 0
        rs = refsel[sl]
        dx = frag_mv[sl, 0]
        dy = frag_mv[sl, 1]
        mx = _MVMAP[qpx][dx + 31]
        mx2 = _MVMAP2[qpx][dx + 31]
        my = _MVMAP[qpy][dy + 31]
        my2 = _MVMAP2[qpy][dy + 31]
        use2 = ((mx2 != 0) | (my2 != 0)) & (rs != 0)
        d = dict(
            rs=rs.astype(np.int8),
            o1y=my.astype(np.int8), o1x=mx.astype(np.int8),
            o2y=(my + my2).astype(np.int8), o2x=(mx + mx2).astype(np.int8),
            u2=use2, ms=may_skip[sl],
        )
        if with_cur:
            d["cur"] = self._plane_blocks(planes_f[pli])
        return d

    # ------------------------------------------------------------------
    def encode_gop(self, gop_frames: list, want_recon: bool = False):
        """Encode one GOP (frame 0 becomes the keyframe).

        gop_frames: list of [y, u, v] display-orientation planes.
        Returns (list of packet byte strings, recon) where recon is the
        final reconstructed padded planes per pli (or None).
        """
        outs = self.dispatch_gop(gop_frames, want_recon=want_recon)
        return self.finish_gop(outs)

    # ------------------------------------------------------------------
    def dispatch_gop(self, gop_frames: list | None = None,
                     want_recon: bool = False, device_planes=None,
                     frame_qi: list | None = None):
        """Upload + enqueue all device work for one GOP without blocking
        on the results (the fused ME plan forces one small download for
        the host mode decision; the heavy per-plane scans stay in
        flight).  Returns an opaque state for finish_gop, letting the
        caller overlap this GOP's device compute with the previous GOP's
        host entropy coding.

        device_planes: optional {pli: [F, h, w] uint8 device arrays,
        bitstream orientation} replacing gop_frames entirely -- the
        device-resident transcode input (TpuBatchDecoder.dispatch_batch
        output); no pixel crosses the host link.

        frame_qi: optional per-frame base qi list (len F) -- rate
        control's per-frame quantizer trajectory, like the reference's
        select_qi-per-frame (rate.c:463-730); None = the encoder's
        current qi for the whole GOP."""
        return self.complete_dispatch(
            self.dispatch_me(gop_frames, device_planes=device_planes),
            want_recon=want_recon, frame_qi=frame_qi,
        )

    # ------------------------------------------------------------------
    def _upload(self, pli, stack_np):
        """Upload one plane's GOP pixel stack, sparse-delta compressed
        when profitable (delta_upload.py); byte-identical to a dense
        device_put either way."""
        import jax

        if not self.delta_upload:
            return jax.device_put(np.ascontiguousarray(stack_np))
        if self._uploader is None:
            from theora_tpu.encode.delta_upload import DeltaUploader

            self._uploader = DeltaUploader()
        return self._uploader.upload(pli, np.ascontiguousarray(stack_np))

    # ------------------------------------------------------------------
    def dispatch_me(self, gop_frames: list | None = None,
                    device_planes=None, kf_flags: list | None = None):
        """Stage 1 of dispatch_gop: upload the GOP's pixels and enqueue
        the fused ME plan WITHOUT blocking on it.  A pipelined driver
        can hide the ME round trip of this GOP behind other host/device
        work (e.g. the next GOP's decode in transcode_device) before
        calling complete_dispatch.

        kf_flags marks the keyframes of a MULTI-GOP frame sequence
        (kf_flags[0] must be True); None = single GOP (frame 0 the only
        keyframe).  With it, one dispatch carries a whole clip chunk:
        golden references follow each frame's own GOP keyframe and the
        plane scans reset their carry at every is_intra frame, so the
        result is byte-identical to per-GOP dispatches."""
        import jax
        import jax.numpy as jnp

        from theora_tpu.ops import me_jax

        if device_planes is not None:
            ys_d = device_planes[0]
            F = int(ys_d.shape[0])
            planes_bs = None
        else:
            F = len(gop_frames)
            planes_bs = [
                [p[::-1].astype(np.uint8) for p in fr] for fr in gop_frames
            ]
            # One upload per frame of luma: the same device buffer feeds
            # the fused ME dispatch and the luma encode scan.
            ys_d = self._upload(0, np.stack([fr[0] for fr in planes_bs]))
        if kf_flags is not None:
            if len(kf_flags) != F or not kf_flags[0]:
                raise ValueError("kf_flags must cover all frames and "
                                 "mark frame 0 a keyframe")
            kf_flags = [bool(b) for b in kf_flags]
        if F < 2:
            me_outs = None
        elif kf_flags is None or not any(kf_flags[1:]):
            me_outs = me_jax.plan_from_gop(ys_d)
        else:
            # Per-frame golden index = the frame's own GOP keyframe
            # (rows whose cur frame is itself a keyframe are discarded
            # host-side, so their gold value is irrelevant).
            gidx = np.zeros(F - 1, np.int32)
            last = 0
            for f in range(1, F):
                if kf_flags[f]:
                    last = f
                gidx[f - 1] = last
            me_outs = me_jax.plan_with_gold(ys_d, jnp.asarray(gidx))
        if me_outs is not None:
            # Start the host copies NOW, so they drain as results
            # complete instead of waiting for the blocking device_get
            # in complete_dispatch (decode_clip does the same).
            for o in jax.tree_util.tree_leaves(me_outs):
                try:
                    o.copy_to_host_async()
                except AttributeError:
                    pass
        return (F, planes_bs, device_planes, ys_d, me_outs, kf_flags)

    # ------------------------------------------------------------------
    def complete_dispatch(self, me_state, want_recon: bool = False,
                          frame_qi: list | None = None):
        """Stage 2: download the ME plan, run the host mode decision,
        and enqueue the per-plane closed-loop scans."""
        import jax
        import jax.numpy as jnp

        g = self.g
        F, planes_bs, device_planes, ys_d, me_outs, kf_flags = me_state
        if kf_flags is None:
            kf_flags = [True] + [False] * (F - 1)
        plans = (
            self._decide_frames(jax.device_get(me_outs), F - 1)
            if me_outs is not None else []
        )
        # Per-frame plan rows: None at keyframes (their ME rows, if
        # computed in a multi-GOP dispatch, are discarded here).
        plan_pf = [None] + [
            (None if kf_flags[f] else plans[f - 1]) for f in range(1, F)
        ]

        nfrags = g.nfrags
        zero_rs = np.zeros(nfrags, np.int8)
        zero_mv = np.zeros((nfrags, 2), np.int32)
        no_skip = np.zeros(nfrags, bool)
        kf_frag = (zero_rs, zero_mv, no_skip)
        frame_frag = [
            kf_frag if p is None else self._frag_plan(*p)
            for p in plan_pf
        ]
        # keyframe_only (the intra saturation gate) applies to frames
        # whose OWN GOP is a single frame -- per-GOP byte identity.
        gop_len = np.zeros(F, np.int64)
        starts = [f for f in range(F) if kf_flags[f]] + [F]
        for si in range(len(starts) - 1):
            gop_len[starts[si]:starts[si + 1]] = (
                starts[si + 1] - starts[si]
            )

        # Per-frame qi lists (rate control steers qi frame to frame,
        # rate.c select_qi; fixed-qi encodes repeat one list).  Each
        # frame derives its own adaptive triple from ITS base qi; lists
        # are padded to the GOP's K by repeating the base row, which the
        # chooser can never pick (identical output + extra signaling
        # cost), so padded frames still pack single-qi headers.
        # The mid-q noise-masking gate (encoder._noise_like) runs per
        # frame when pixels are host-visible; device-resident transcode
        # inputs skip it (downloading pixels to classify them would
        # defeat the resident pipeline).
        saved_nl = getattr(self.enc, "_frame_noise_like", False)
        saved_mx = getattr(self.enc, "_frame_mixed", False)
        saved_sc = getattr(self.enc, "_frag_lam_scale", None)

        def frame_gates(f):
            """Per-frame content gates on the host encoder object (the
            noise gate and the round-5 mixed-frame per-MB masking gate,
            encoder.py _adaptive_qi_triple) and the frame's per-luma-
            fragment chooser lambda scales (the rd_iscale analogue,
            analyze.c:1256-1340).  Device-resident transcode inputs
            skip both gates (no host pixels)."""
            if planes_bs is None:
                self.enc._frame_noise_like = False
                self.enc._frame_mixed = False
                self.enc._frag_lam_scale = None
                return None
            y = planes_bs[f][0]
            self.enc._frame_noise_like = Encoder._noise_like(y)
            act = Encoder._luma_activity(y)
            mixed = Encoder._mixed_frame(act)
            self.enc._frame_mixed = mixed
            sc = (
                self.enc._activity_iscale(act)
                if (mixed and self.adaptive_quant
                    and not self.enc._frame_noise_like)
                else None
            )
            self.enc._frag_lam_scale = sc
            return sc

        frame_sc = [None] * F
        try:
            if frame_qi is None:
                fqis = []
                for f in range(F):
                    sc = frame_gates(f)
                    fqis.append(
                        self._adaptive_qis(
                            keyframe_only=(gop_len[f] == 1)
                        )
                    )
                    if sc is not None and len(fqis[-1]) > 1:
                        frame_sc[f] = sc
            else:
                if len(frame_qi) != F:
                    raise ValueError(
                        "frame_qi length must equal GOP length"
                    )
                fqis = []
                for f, q in enumerate(frame_qi):
                    sc = frame_gates(f)
                    fqis.append(
                        self._adaptive_qis(
                            keyframe_only=(gop_len[f] == 1), qi=int(q)
                        )
                    )
                    if sc is not None and len(fqis[-1]) > 1:
                        frame_sc[f] = sc
        finally:
            self.enc._frame_noise_like = saved_nl
            self.enc._frame_mixed = saved_mx
            self.enc._frag_lam_scale = saved_sc
        # Per-fragment chooser lambda scales for the LUMA scan (chroma
        # keeps 1.0, the host tier's convention); None when no frame
        # engaged masking, keeping the unmasked path bit-identical.
        luma_sc = None
        if any(s is not None for s in frame_sc):
            nl0 = g.planes[0].nfrags
            luma_sc = np.ones((F, nl0), np.float32)
            for f, s in enumerate(frame_sc):
                if s is not None:
                    luma_sc[f] = s[:nl0].astype(np.float32)
        K = max(len(q) for q in fqis)
        fqis_pad = [list(q) + [q[0]] * (K - len(q)) for q in fqis]
        plane_out = {}
        for pli in range(3):
            pl = g.planes[pli]
            vpad, hpad = g.plane_padding(pli)
            stacks = {k: [] for k in ("rs", "o1y", "o1x", "o2y",
                                      "o2x", "u2", "ms")}
            for f in range(F):
                rs, fmv, ms = frame_frag[f]
                d = self._plane_inputs(pli, None, rs, fmv, ms,
                                       with_cur=False)
                for k in stacks:
                    stacks[k].append(d[k])
            arrs = {k: jnp.asarray(np.stack(v)) for k, v in stacks.items()}
            if pli == 0:
                cur_pl = ys_d
            elif device_planes is not None:
                cur_pl = device_planes[pli]
            else:
                cur_pl = self._upload(
                    pli, np.stack([planes_bs[f][pli] for f in range(F)])
                )
            is_intra = jnp.asarray(np.array(kf_flags, bool))
            dq = self.enc.dequant
            from theora_tpu.ops.fdct_np import rd_lambda
            from theora_tpu.ops.loopfilter_np import build_bounding_values

            def lam_for(qi, qti):
                return rd_lambda(
                    qi, int(dq[qi, pli, qti, 1])
                ) * self.rd_strength

            # Per-frame quantizer inputs, [F(,K),...] stacked.
            di_f = np.empty((F, K, 64), np.int32)
            dp_f = np.empty((F, K, 64), np.int32)
            lqi_f = np.empty((F, K), np.float32)
            lqp_f = np.empty((F, K), np.float32)
            lti_f = np.empty((F, K), np.float32)
            ltp_f = np.empty((F, K), np.float32)
            bv_f = np.empty((F, 256), np.int32)
            lam_f = np.empty(F, np.float32)
            for f, qrow in enumerate(fqis_pad):
                base = qrow[0]
                # DC (slot 0) always quantizes with the base qi -- the
                # bitstream's rule.
                di_f[f] = dq[qrow][:, pli, 0].astype(np.int32)
                dp_f[f] = dq[qrow][:, pli, 1].astype(np.int32)
                di_f[f, :, 0] = dq[base, pli, 0, 0]
                dp_f[f, :, 0] = dq[base, pli, 1, 0]
                lqi_f[f] = [lam_for(q, 0) for q in qrow]
                lqp_f[f] = [lam_for(q, 1) for q in qrow]
                lti_f[f] = [self._lam_t_for(q)[0] for q in qrow]
                ltp_f[f] = [self._lam_t_for(q)[1] for q in qrow]
                flimit = self.enc.qinfo["loop_filter_limits"][base]
                bv_f[f] = (
                    build_bounding_values(flimit).astype(np.int32)
                    if flimit else np.zeros(256, np.int32)
                )
                lam_f[f] = (
                    rd_lambda(base, int(dq[base, 0, 1, 1]))
                    * self.rd_strength * 4.0
                )
            if K == 1:
                deq_i, deq_p = di_f[:, 0], dp_f[:, 0]
                lam_qi, lam_qp = lqi_f[:, 0], lqp_f[:, 0]
                lam_ti, lam_tp = lti_f[:, 0], ltp_f[:, 0]
            else:
                deq_i, deq_p = di_f, dp_f
                lam_qi, lam_qp = lqi_f, lqp_f
                lam_ti, lam_tp = lti_f, ltp_f
            out = _scan_encode_plane(
                cur_pl, arrs["rs"], arrs["o1y"], arrs["o1x"],
                arrs["o2y"], arrs["o2x"], arrs["u2"], arrs["ms"], is_intra,
                jnp.asarray(deq_i), jnp.asarray(deq_p),
                jnp.asarray(bv_f), jnp.asarray(lam_f),
                jnp.asarray(lam_qi), jnp.asarray(lam_qp),
                jnp.asarray(self._nb_dev), jnp.asarray(self._nb_dev),
                jnp.asarray(lam_ti), jnp.asarray(lam_tp),
                pl.nvfrags, pl.nhfrags, vpad, hpad,
                emit_recon=want_recon, use_trellis=self.use_trellis,
                n_qis=K,
                lam_sc=(
                    jnp.asarray(luma_sc)
                    if (pli == 0 and luma_sc is not None) else None
                ),
            )
            cap = self._cap_est.get((pli, F), 0)
            packed = _compact_qdct(out[0], cap) if cap else None
            plane_out[pli] = (out, packed, cap)
        # Start the host copies of everything finish_gop will read
        # (nnz, coded, optional recon/qii, compacted coefficients):
        # async copies drain as the scans complete instead of
        # serializing behind later-queued work at device_get time.
        K = max(len(q) for q in fqis)
        nnz_i = -2 if K > 1 else -1
        for pli, (out, packed, cap) in plane_out.items():
            arrs_to_copy = [out[nnz_i], out[1]]
            if want_recon:
                arrs_to_copy.append(out[2])
            if K > 1:
                arrs_to_copy.append(out[-1])
            if packed is not None:
                arrs_to_copy.append(packed)
            for a in arrs_to_copy:
                try:
                    a.copy_to_host_async()
                except AttributeError:
                    pass
        return (F, plan_pf, frame_frag, plane_out, want_recon, fqis,
                kf_flags)

    # ------------------------------------------------------------------
    def finish_gop(self, state):
        """Download the dispatched scans' outputs and entropy-code the
        GOP's packets on the host.

        Everything the host needs -- per-plane nonzero counts, the
        eagerly compacted sparse coefficients, coded flags, and recon
        when requested -- rides ONE batched jax.device_get rather than
        one read per array.  A second round trip happens only when
        a plane's compaction capacity prediction was too small (or on
        the first GOP of a shape, when no prediction exists)."""
        import jax

        F, plan_pf, frame_frag, plane_out, want_recon, fqis, kf_flags = (
            state
        )
        K = max(len(q) for q in fqis)
        nnz_i = -2 if K > 1 else -1  # qii rides last when adaptive
        tree = {}
        for pli, (out, packed, cap) in plane_out.items():
            t = [out[nnz_i], out[1]]       # nnz, coded
            if want_recon:
                t.append(out[2])
            if K > 1:
                t.append(out[-1])
            if packed is not None:
                t.append(packed)
            tree[pli] = t
        host = jax.device_get(tree)

        qdct_pl = {}
        coded_pl = {}
        recon_pl = {}
        qii_pl = {}
        for pli, (out, packed, cap) in plane_out.items():
            h = list(host[pli])
            nnz, coded_pl[pli] = h.pop(0), h.pop(0)
            if want_recon:
                recon_pl[pli] = h.pop(0)
            if K > 1:
                qii_pl[pli] = h.pop(0)
            total = int(nnz.astype(np.int64).sum())
            self._cap_est[(pli, F)] = _cap_bucket(max(total * 9 // 8, 1))
            if packed is not None and total <= cap:
                qdct_pl[pli] = _expand_packed(h[-1], nnz)
            else:
                # Prediction missing or too small: pay one more trip,
                # dense when compaction would not be smaller.
                N = nnz.shape[1]
                if 3 * total + F * N >= F * N * 64:
                    qdct_pl[pli] = np.asarray(out[0])
                else:
                    fresh = _compact_qdct(out[0], _cap_bucket(total))
                    qdct_pl[pli] = _expand_packed(
                        jax.device_get(fresh), nnz
                    )

        pkts = self._pack_gop(F, plan_pf, frame_frag, qdct_pl, coded_pl,
                              fqis=fqis, qii_pl=qii_pl if K > 1 else None,
                              kf_flags=kf_flags)
        return pkts, (recon_pl if want_recon else None)

    # ------------------------------------------------------------------
    def _pack_gop(self, F, plans, frame_frag, qdct_pl, coded_pl,
                  fqis=None, qii_pl=None, kf_flags=None):
        """kf_flags=None (the mesh tier's calling convention): frame 0
        is the keyframe and `plans` lists the F-1 inter frames.
        Otherwise `plans` is a PER-FRAME list with None rows at the
        keyframes kf_flags marks (the clip-batched driver)."""
        if kf_flags is None:
            kf_flags = [True] + [False] * (F - 1)
            plans = [None] + list(plans)
        g = self.g
        nfrags = g.nfrags
        rs_to_ref = np.array(
            [FRAME_SELF, FRAME_PREV, FRAME_GOLD], np.int32
        )
        pkts = []
        saved_qi = self.enc.qi
        try:
            for f in range(F):
                qdct = np.zeros((nfrags, 64), np.int16)
                coded = np.zeros(nfrags, bool)
                frame_qis = (
                    list(fqis[f]) if fqis is not None else [self.qi]
                )
                frag_qii = None
                if qii_pl is not None and len(frame_qis) > 1:
                    frag_qii = np.zeros(nfrags, np.int32)
                for pli in range(3):
                    pl = g.planes[pli]
                    sl = slice(pl.froffset, pl.froffset + pl.nfrags)
                    qdct[sl] = qdct_pl[pli][f]
                    coded[sl] = coded_pl[pli][f]
                    if frag_qii is not None:
                        frag_qii[sl] = qii_pl[pli][f]
                rs, fmv, _ms = frame_frag[f]
                frag_refi = np.where(
                    coded, rs_to_ref[rs.astype(np.int32)], FRAME_NONE
                ).astype(np.int32)
                # The frame's own base qi drives the packed header (and
                # the packer's table cost model).
                self.enc.qi = frame_qis[0]
                pqis = frame_qis if len(frame_qis) > 1 else None
                if kf_flags[f]:
                    data = self.enc.pack_frame_plan(
                        INTRA_FRAME, coded, frag_refi, None, None, qdct,
                        qis=pqis, frag_qii=frag_qii,
                    )
                else:
                    mb_modes, mb_mvs = plans[f][:2]
                    # 4MV MBs pack their per-luma-block vectors from
                    # here (encoder._mvs_pack reads _frag_mv4).
                    self.enc._frag_mv4 = fmv
                    data = self.enc.pack_frame_plan(
                        INTER_FRAME, coded, frag_refi, mb_modes, mb_mvs,
                        qdct, qis=pqis, frag_qii=frag_qii,
                    )
                pkts.append(data)
        finally:
            self.enc.qi = saved_qi
        return pkts

    # ------------------------------------------------------------------
    def encode_clip(self, frames: list, keyframe_freq: int = 8,
                    target_bitrate: int = 0, rate_window: int = 8,
                    auto_keyframe: bool = False,
                    clip_batch: int = 8) -> list[Packet]:
        """Headers + data packets for a whole clip, GOP by GOP.

        auto_keyframe places keyframes at detected scene cuts (bounded
        by keyframe_freq) via the deterministic pre-pass segmentation
        (detect_scene_cuts) shared with the mesh path.

        Two-stage software pipeline (the host<->device analogue of the
        reference's MCU pipelining, SURVEY.md §2.7 "pipeline parallel"):
        GOP k+1's uploads, ME plan, and closed-loop scans are enqueued
        on the device BEFORE GOP k's coefficients are downloaded and
        entropy-coded, so host bit-packing overlaps device compute.
        GOPs are independent (keyframe-delimited), so the overlap cannot
        change any byte.

        With target_bitrate > 0, the fixed-window controller adjusts qi
        between GOPs from real packed bit counts -- the same policy the
        mesh path psums over devices (parallel/gop.py), so output is
        byte-identical to encode_clip_mesh on a 1-device mesh.  The qi
        feedback makes GOPs order-dependent, so CBR encodes run without
        the dispatch/finish overlap."""
        out = self.flush_headers()
        shift = self.info.keyframe_granule_shift
        pno = 3
        nf = len(frames)
        bases = gop_starts(frames, keyframe_freq, auto_keyframe)
        bounds = bases + [nf]
        gops = [
            (bases[k], frames[bases[k]:bounds[k + 1]])
            for k in range(len(bases))
        ]
        rc = (
            WindowRateController(self, target_bitrate, rate_window)
            if target_bitrate > 0 else None
        )

        def emit(pbase, datas):
            nonlocal pno
            for j, data in enumerate(datas):
                fnum = pbase + j
                gp = ((pbase + 1) << shift) + (fnum - pbase)
                out.append(Packet(
                    data, granulepos=gp, packetno=pno,
                    e_o_s=(fnum == nf - 1),
                ))
                pno += 1

        if rc is not None:
            for gi, (base, gfr) in enumerate(gops):
                datas, _ = self.finish_gop(self.dispatch_gop(gfr))
                emit(base, datas)
                rc.add(8 * sum(len(d) for d in datas), len(datas))
                if (gi + 1) % rate_window == 0:
                    rc.update()
            rc.update()
            return out
        # Clip-batched dispatch: consecutive GOPs ride ONE multi-GOP
        # dispatch (is_intra resets the scan carry at each keyframe, so
        # bytes are identical to per-GOP dispatches), cutting the
        # number of host<->device round trips ~4x at the default chunk
        # size.  Chunks are pipelined two deep (chunk k+1's uploads +
        # ME + scans enqueue before chunk k's download + host entropy),
        # the same overlap contract as the old per-GOP staging.
        from collections import deque

        chunks = []  # (pbase, frame list, kf_flags)
        CHUNK = max(int(clip_batch), 1)
        i = 0
        while i < len(gops):
            j = i
            total = 0
            while j < len(gops) and (
                j == i or total + len(gops[j][1]) <= CHUNK
            ):
                total += len(gops[j][1])
                j += 1
            cfr, kf = [], []
            for k in range(i, j):
                cfr.extend(gops[k][1])
                kf.extend([True] + [False] * (len(gops[k][1]) - 1))
            chunks.append((gops[i][0], cfr, kf))
            i = j

        def emit_chunk(pbase, kf, datas):
            nonlocal pno
            gop_base = pbase
            for j, data in enumerate(datas):
                fnum = pbase + j
                if kf[j]:
                    gop_base = fnum
                gp = ((gop_base + 1) << shift) + (fnum - gop_base)
                out.append(Packet(
                    data, granulepos=gp, packetno=pno,
                    e_o_s=(fnum == nf - 1),
                ))
                pno += 1

        me_q: deque = deque()
        fin_q: deque = deque()

        def drain_complete():
            b, kf, me = me_q.popleft()
            fin_q.append((b, kf, self.complete_dispatch(me)))

        def drain_finish():
            b, kf, st = fin_q.popleft()
            emit_chunk(b, kf, self.finish_gop(st)[0])

        for pbase, cfr, kf in chunks:
            me_q.append((pbase, kf, self.dispatch_me(cfr, kf_flags=kf)))
            if len(me_q) >= 2:
                drain_complete()
            if len(fin_q) >= 2:
                drain_finish()
        while me_q:
            drain_complete()
        while fin_q:
            drain_finish()
        return out

    # ------------------------------------------------------------------
    def encode_clip_pass1(self, frames: list, keyframe_freq: int = 8,
                          target_bitrate: int = 0,
                          auto_keyframe: bool = False):
        """2-pass, pass 1 on the device tier: a fixed-qi measurement
        encode (the qi the reference's pass 1 picks, rate.c:502-506)
        producing (packets, OT2P metrics blob).  The blob uses the
        reference's exact file format (RateControl.pack_metrics), so it
        cross-parses with the reference both directions.

        The measurement encode itself runs through the pipelined
        encode_clip (qi never changes during pass 1, so the 3-stage
        dispatch overlap stays legal); the controller replay that
        computes per-frame log_scale happens afterwards from the REAL
        packed byte counts."""
        from theora_tpu.encode.rate import RateControl

        rc = RateControl(
            self._rc_info(target_bitrate), self.enc.dequant,
            keyframe_freq,
        )
        rc.drop_frames = False
        rc.start_pass1()  # placeholder header; summary written last
        body = b""
        p1qi = rc._pass1_qi
        saved_qi = self.qi
        self.set_qi(p1qi)
        try:
            pkts = self.encode_clip(
                frames, keyframe_freq=keyframe_freq,
                auto_keyframe=auto_keyframe,
            )
        finally:
            self.set_qi(saved_qi)
        bases = gop_starts(frames, keyframe_freq, auto_keyframe)
        kf_set = set(bases)
        qi = p1qi
        for j, p in enumerate(pkts[3:]):
            ftype = 0 if j in kf_set else 1
            qi = rc.select_qi(ftype, qi)
            rc.update(ftype, qi, 8 * len(p.data), droppable=False)
            body += rc.pass1_frame_data()
        return pkts, rc.pass1_summary() + body

    # ------------------------------------------------------------------
    def _rc_info(self, target_bitrate: int):
        """A copy of the stream info with the rate target set, for the
        controller only -- the PACKED headers keep the caller's info
        verbatim, so sequential and mesh encodes (which flush headers
        at different points) stay byte-identical."""
        import copy

        rc_info = copy.copy(self.info)
        rc_info.target_bitrate = int(target_bitrate)
        return rc_info

    # ------------------------------------------------------------------
    def encode_clip_pass2(self, frames: list, pass1_data: bytes,
                          keyframe_freq: int = 8, target_bitrate: int = 0,
                          buf_delay: int | None = None,
                          rate_window: int = 1,
                          auto_keyframe: bool = False) -> list[Packet]:
        """2-pass, pass 2 on the device tier: the reference's OT2P
        window allocation (rate.c:878-1034, via RateControl.start_pass2,
        incl. finite buf_delay windows) steering the GOP-batch encoder
        with PER-FRAME qi vectors (the scans take per-frame quantizer
        inputs).

        Per window of rate_window GOPs (default 1): the qi vector for
        every frame comes from the model-estimate pre-pass
        (rate.twopass_window_qvecs) run from the window-start
        controller state; the GOPs then encode batched at those qis,
        and the controller replays per-frame with REAL packed bits --
        the reference's select/update interleaving (rate.c:463-870)
        with the selection lead-time a batch requires.  The same window
        structure runs on the mesh (parallel/gop.py encode_clip_mesh
        twopass_data=...), where the no-real-bits-inside-a-window
        property is what keeps output byte-identical across mesh
        shapes."""
        from theora_tpu.encode.rate import RateControl

        rc = RateControl(
            self._rc_info(target_bitrate), self.enc.dequant,
            keyframe_freq,
        )
        rc.drop_frames = False
        rc.start_pass2(pass1_data, buf_delay)
        out = self.flush_headers()
        shift = self.info.keyframe_granule_shift
        pno = 3
        nf = len(frames)
        bases = gop_starts(frames, keyframe_freq, auto_keyframe)
        bounds = bases + [nf]
        gops = [
            (bases[k], frames[bases[k]:bounds[k + 1]])
            for k in range(len(bases))
        ]
        saved_qi = self.qi
        applied_qi = self.qi
        from theora_tpu.encode.rate import twopass_window_qvecs

        try:
            for w0 in range(0, len(gops), rate_window):
                window = gops[w0 : w0 + rate_window]
                qvecs = twopass_window_qvecs(
                    rc, [len(gfr) for _, gfr in window], applied_qi
                )
                prev_applied = applied_qi
                for (base, gfr), qv in zip(window, qvecs):
                    datas, _ = self.finish_gop(
                        self.dispatch_gop(gfr, frame_qi=qv)
                    )
                    for j, data in enumerate(datas):
                        fnum = base + j
                        gp = ((base + 1) << shift) + (fnum - base)
                        out.append(Packet(
                            data, granulepos=gp, packetno=pno,
                            e_o_s=(fnum == nf - 1),
                        ))
                        pno += 1
                        ftype = 0 if j == 0 else 1
                        # Replay the controller with REAL bits (one
                        # select per frame, the reference's
                        # accounting; its selection is discarded --
                        # the frame's qi was fixed by the pre-pass).
                        rc.select_qi(ftype, prev_applied)
                        rc.log_qtarget = rc.log_qavg[ftype][qv[j]]
                        rc.update(ftype, qv[j], 8 * len(data),
                                  droppable=False)
                        prev_applied = qv[j]
                applied_qi = prev_applied
        finally:
            self.set_qi(saved_qi)
        return out

    # ------------------------------------------------------------------
    def encode_clip_twopass(self, frames: list, keyframe_freq: int = 8,
                            target_bitrate: int = 0,
                            buf_delay: int | None = None,
                            rate_window: int = 1,
                            auto_keyframe: bool = False):
        """Full 2-pass encode (pass 1 + pass 2); returns (packets,
        pass1_blob) so callers can persist the OT2P file."""
        _, blob = self.encode_clip_pass1(
            frames, keyframe_freq, target_bitrate, auto_keyframe
        )
        pkts = self.encode_clip_pass2(
            frames, blob, keyframe_freq, target_bitrate, buf_delay,
            rate_window, auto_keyframe,
        )
        return pkts, blob


def transcode_device(info, setup, data_packets, keyframe_freq: int = 8,
                     qi: int = 40, target_bitrate: int = 0,
                     rate_window: int = 8, enc_kwargs: dict | None = None):
    """Device-resident transcode: TpuBatchDecoder -> TpuGopEncoder with
    the decoded YCbCr planes never leaving the device.

    The reference can only couple a decoder to an encoder through raw
    frames in host memory (examples/encoder_example.c decode->encode
    style loops); here the decode scan's output planes feed the encode
    scans as device arrays, so per GOP only the *coefficients* cross the
    link (sparse up for decode, sparse down for encode) -- the ~55 MB of
    YUV per 16 720p frames never moves.

    data_packets: the input stream's data packet bytes (headers already
    parsed into info/setup).  Output keyframes are placed every
    keyframe_freq frames regardless of input GOP structure (decode
    batches may start anywhere once reference state exists).  Returns
    the full output packet list (headers + data).  Output is
    byte-identical to host-decoding the stream and feeding the frames to
    TpuGopEncoder.encode_clip with the same settings.

    With target_bitrate > 0 the fixed-window CBR controller steers qi
    between GOP windows (sequential, like encode_clip); otherwise GOP
    k+1's decode+encode device work overlaps GOP k's host entropy
    coding.
    """
    import jax.numpy as jnp

    from theora_tpu.decode.tpu_batch import TpuBatchDecoder

    dec = TpuBatchDecoder(info, setup)
    enc = TpuGopEncoder(info, qi=qi, **(enc_kwargs or {}))
    out = enc.flush_headers()
    shift = info.keyframe_granule_shift
    pno = 3
    nf = len(data_packets)
    bases = list(range(0, nf, keyframe_freq))
    rc = (
        WindowRateController(enc, target_bitrate, rate_window)
        if target_bitrate > 0 else None
    )

    def emit(pbase, datas):
        nonlocal pno
        for j, data in enumerate(datas):
            fnum = pbase + j
            gp = ((pbase + 1) << shift) + (fnum - pbase)
            out.append(Packet(
                data, granulepos=gp, packetno=pno,
                e_o_s=(fnum == nf - 1),
            ))
            pno += 1

    prev_last = None  # last decoded frame's planes (all-dup chunks)

    def decode_chunk(base):
        nonlocal prev_last
        chunk = data_packets[base:base + keyframe_freq]
        st = dec.dispatch_batch(chunk)
        if st is None:
            if prev_last is None:
                raise ValueError("stream must start with a live frame")
            dev = {
                pli: jnp.broadcast_to(
                    p, (len(chunk),) + p.shape
                ).astype(jnp.uint8)
                for pli, p in prev_last.items()
            }
        else:
            emit_idx = st["emit"]
            dev = st["dev"]
            if emit_idx != list(range(len(chunk))):
                idx = jnp.asarray(np.asarray(emit_idx, np.int32))
                dev = {pli: p[idx] for pli, p in dev.items()}
        prev_last = {pli: p[-1] for pli, p in dev.items()}
        return [dev[0], dev[1], dev[2]]

    if rc is not None:
        for gi, base in enumerate(bases):
            datas, _ = enc.finish_gop(
                enc.dispatch_gop(device_planes=decode_chunk(base))
            )
            emit(base, datas)
            rc.add(8 * sum(len(d) for d in datas), len(datas))
            if (gi + 1) % rate_window == 0:
                rc.update()
        rc.update()
        return out
    # Three-stage pipeline: while GOP k's decode scans + ME run on
    # device, GOP k-1's mode decision + encode scans are enqueued (its
    # ME round trip already hidden behind k's decode dispatch) and GOP
    # k-2's coefficients are downloaded and entropy-coded on host.
    from collections import deque

    me_q: deque = deque()
    fin_q: deque = deque()

    def drain_complete():
        b, me = me_q.popleft()
        fin_q.append((b, enc.complete_dispatch(me)))

    def drain_finish():
        b, st = fin_q.popleft()
        emit(b, enc.finish_gop(st)[0])

    for base in bases:
        me_q.append((base, enc.dispatch_me(
            device_planes=decode_chunk(base))))
        if len(me_q) >= 2:
            drain_complete()
        if len(fin_q) >= 2:
            drain_finish()
    while me_q:
        drain_complete()
    while fin_q:
        drain_finish()
    return out


class WindowRateController:
    """Fixed-window CBR for the device tier: between GOP windows, steer
    qi from REAL packed bit counts (the decoder-visible truth, not an
    estimate).  Deliberately simple and mesh-invariant: updates happen
    only at fixed GOP indices and the reservoir sums are associative
    integers, so the mesh path can psum the counts over devices and land
    on the same qi trajectory (parallel/gop.py)."""

    def __init__(self, enc, target_bitrate: int, rate_window: int):
        self.enc = enc
        self.target_bitrate = int(target_bitrate)
        info = enc.info
        self.fps = max(
            info.fps_numerator / max(info.fps_denominator, 1), 1e-6
        )
        self.rate_window = int(rate_window)
        self.fullness = 0.0
        self.win_bits = 0
        self.win_frames = 0

    def add(self, bits: int, nframes: int) -> None:
        self.win_bits += int(bits)
        self.win_frames += int(nframes)

    def update(self) -> None:
        self.apply(self.win_bits, self.win_frames)
        self.win_bits = 0
        self.win_frames = 0

    def apply(self, total_bits: int, nframes: int) -> None:
        """Apply one window's totals (the mesh path passes psum-reduced
        counts here)."""
        if nframes == 0:
            return
        target = self.target_bitrate * nframes / self.fps
        self.fullness += target - total_bits
        step = int(round(-self.fullness / max(target / 2, 1.0)))
        if step:
            self.enc.set_qi(self.enc.qi + int(np.clip(step, -4, 4)))
