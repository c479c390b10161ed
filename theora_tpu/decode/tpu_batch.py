"""GOP-batch device decode: host entropy for all frames up front, then ONE
jitted program per plane expands sparse coefficients on device and runs
the entire pixel pipeline (dequant + iDCT + MC + reconstruction + loop
filter + borders) for every frame via lax.scan, carrying the reference
planes in the scan state.

Transfer discipline (this is what amortizes the host<->device transfers
of the per-frame TpuDecoder):

- UP: coefficients go up SPARSE -- per-fragment nonzero counts (uint8),
  zig-zag positions (uint8) and values (int16), padded to a bucketed
  length -- ~10x smaller than the dense [nfrags, 64] int16 tensor. The
  dense tensor is materialized on device by one scatter-add.
- DOWN: only the picture-region uint8 pixels come back, cropped on
  device (no UMV padding rows).
- Reference planes stay RESIDENT on device between decode_batch calls
  (donated into the next dispatch); nothing reference-sized crosses the
  link in a chained-GOP stream.

Bit-exact with the scalar decoder (same integer kernels; dense
uncoded-fragment formulation of decode/tpu_decoder.py).
"""
from __future__ import annotations

import functools

import numpy as np

from theora_tpu.constants import FRAME_GOLD, FRAME_PREV, FRAME_SELF
from theora_tpu.decode.decoder import Decoder, _MVMAP, _MVMAP2
from theora_tpu.info import INTRA_FRAME


@functools.partial(
    __import__("jax").jit,
    static_argnames=("nv", "nh", "pad_y", "pad_x"),
    donate_argnums=(0, 1),
)
def _scan_decode_plane(
    init_prev, init_gold,
    counts, zzi, vals, deq_tab, qii, inter, dc, dc_only, refsel,
    o1y, o1x, o2y, o2x, use2, coded, bv, do_filter, is_intra,
    nv, nh, pad_y, pad_x,
):
    """Scan over F frames for one plane.

    counts: [F, n] uint8 nonzero-AC counts per fragment; zzi/vals:
    [NNZ_PAD] uint8/int16 concatenated nonzero positions/values in
    (frame, fragment) order, zero-padded. Other per-frame inputs are
    stacked on axis 0; refsel==0 selects intra (128), 1 PREV, 2 GOLD.
    is_intra[f] rotates GOLD; do_filter[f] gates the loop filter
    (multiplied into bv). Returns (planes_cropped, prev_out, gold_out).
    """
    import jax
    import jax.numpy as jnp

    from theora_tpu.ops import mc_jax as mc
    from theora_tpu.ops import transforms_jax as tj
    from theora_tpu.ops.loopfilter_jax import loop_filter_plane_jax
    from theora_tpu.pipeline import fill_borders

    h, w = nv * 8, nh * 8
    F, n = counts.shape
    # Expand sparse coefficients to dense [F, n, 64] on device: one
    # scatter-add (padding scatters value 0 into the tail fragment's DC
    # slot, which the DC pass overwrites anyway).
    flat_counts = counts.reshape(-1).astype(jnp.int32)
    ids = jnp.repeat(
        jnp.arange(F * n, dtype=jnp.int32), flat_counts,
        total_repeat_length=zzi.shape[0],
    )
    qz = (
        jnp.zeros((F * n, 64), jnp.int16)
        .at[ids, zzi.astype(jnp.int32)]
        .add(vals)
        .reshape(F, n, 64)
    )

    def step(carry, xs):
        prev_plane, gold_plane = carry
        (qzf, deqt, qiif, intf, dcf, dof, rsf, y1, x1, y2, x2, u2, codedf,
         bvf, isintra) = xs
        deqf = deqt[qiif.astype(jnp.int32), intf.astype(jnp.int32)].astype(
            jnp.int32
        )
        dcqf = deqt[0, intf.astype(jnp.int32), 0].astype(jnp.int32)
        # named_scope labels group profiler traces by codec stage
        # (theora_tpu/debug.py).
        with jax.named_scope("dequant_idct"):
            residual = tj.dequantize_idct(
                qzf.astype(jnp.int32), deqf, dcf.astype(jnp.int32),
                dcqf, dof,
            )
        # MC as masked shifts over per-fragment neighborhoods (see
        # ops/mc_jax.py) instead of element gathers.
        with jax.named_scope("mc"):
            nb_p = mc.block_neighborhoods(prev_plane, nv, nh, pad_y, pad_x)
            nb_g = mc.block_neighborhoods(gold_plane, nv, nh, pad_y, pad_x)
            nb = jnp.where((rsf == 2)[:, None, None], nb_g, nb_p)
            s1, s2 = mc.mc_select2(nb, y1, x1, y2, x2, pad_y, pad_x)
            sel = jnp.where(u2[:, None, None], (s1 + s2) >> 1, s1)
            pred = jnp.where((rsf == 0)[:, None, None], 128, sel)
        blocks = jnp.clip(residual + pred, 0, 255).astype(jnp.uint8)
        plane = mc.blocks_to_plane(blocks, nv, nh, pad_y, pad_x)
        with jax.named_scope("loopfilter"):
            plane = loop_filter_plane_jax(
                plane, codedf, bvf, nv, nh, pad_y, pad_x
            )
        with jax.named_scope("borders"):
            plane = fill_borders(plane, h, w, pad_y, pad_x)
        gold_new = jnp.where(isintra, plane, gold_plane)
        # Downloads are picture-region-only; full padded planes live in
        # the carry.
        return (plane, gold_new), plane[pad_y:pad_y + h, pad_x:pad_x + w]

    bvs = bv * do_filter[:, None].astype(jnp.int32)
    (prev_out, gold_out), planes = jax.lax.scan(
        step,
        (init_prev, init_gold),
        (qz, deq_tab, qii, inter, dc, dc_only, refsel,
         o1y, o1x, o2y, o2x, use2, coded, bvs, is_intra),
    )
    return planes, prev_out, gold_out


def _nnz_bucket(n: int) -> int:
    """Round the sparse length up to a coarse bucket so jit caches stay
    small (one compile per bucket)."""
    b = 1 << 14
    while b < n:
        b <<= 1
    return b


class TpuBatchDecoder(Decoder):
    """Decode a batch of packets with one device dispatch per plane.
    Reference planes stay resident on device across batches."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # Device-resident (prev, gold) per plane, carried across
        # decode_batch calls.
        self._dev_refs: dict[int, tuple] | None = None
        # Host copy of the last frame emitted by a batched call, kept so
        # a dup packet that LEADS the next batch can repeat it without a
        # device round trip (the pre-batch refs are donated into the
        # scan and gone by the time emit indices are resolved).
        self._last_out_host: list[np.ndarray] | None = None

    def _prev_output_frame(self) -> list[np.ndarray]:
        """The most recently output frame, display orientation.  Used
        when a batch (or chunk) begins with dup packets."""
        if self._dev_refs is not None:
            if self._last_out_host is not None:
                return self._last_out_host
            # Device state exists but no host copy was kept (e.g. the
            # caller used dispatch_batch directly): materialize it.
            self.sync_refs_to_host()
        return self.ycbcr_out()

    def decode_batch(self, packets: list[bytes]) -> list[list[np.ndarray]]:
        """Returns display-orientation [y, u, v] planes per packet.
        The batch must start at a decodable point (keyframe or existing
        reference state); dup packets repeat the previous output.
        Chained calls keep the reference state on device."""
        g = self.geometry
        prev_frame = None
        if packets and len(packets[0]) == 0:
            # Leading dup: capture the previous output BEFORE dispatch
            # donates the reference planes into the new scan.
            prev_frame = self._prev_output_frame()
        st = self.dispatch_batch(packets)
        if st is None:
            # All dups: repeat the last decoded frame.
            if prev_frame is None:
                prev_frame = self._prev_output_frame()
            outs = [[p.copy() for p in prev_frame] for _ in packets]
            if outs:
                self._last_out_host = [p.copy() for p in outs[-1]]
            return outs
        out_planes = {pli: np.asarray(p) for pli, p in st["dev"].items()}
        outs = []
        for li in st["emit"]:
            if li < 0:
                outs.append([p.copy() for p in prev_frame])
                continue
            frame_out = []
            for pli in range(3):
                h, w = g.plane_shape(pli)
                p = out_planes[pli][li][:h, :w]
                frame_out.append(p[::-1].copy())
            outs.append(frame_out)
        self._last_out_host = [p.copy() for p in outs[-1]]
        return outs

    def dispatch_batch(self, packets: list[bytes]):
        """Parse the batch on host and enqueue the device decode scans
        WITHOUT downloading pixels.  Returns None when the batch holds
        no live frames (all dups), else a state dict with
        dev: {pli: [F_live, h, w] device uint8 planes, bitstream
        orientation, UMV padding cropped} and emit: per-packet index
        into the live axis (dups repeat their predecessor).  The
        device-resident transcode path feeds dev straight into
        TpuGopEncoder.dispatch_gop(device_planes=...) so decoded pixels
        never cross the host link."""
        import jax.numpy as jnp

        from theora_tpu.ops.loopfilter_np import build_bounding_values

        g = self.geometry
        nfrags = g.nfrags
        per_frame = []
        for data in packets:
            if len(data) == 0:
                self.frame_type = 1
                self._update_granpos()
                per_frame.append(None)
                continue
            side = self._parse_sideinfo_native(data)
            coded = side["coded"]
            per_plane_fragis = []
            for pli in range(3):
                sel = g.scan_pli == pli
                fr = g.scan_fragis[sel]
                per_plane_fragis.append(fr[coded[fr]])
            order = np.concatenate(per_plane_fragis).astype(np.int32)
            qzc, lz, dcc, _ = self._native.decode_frame_tokens(
                data, side["bitpos"], [len(f) for f in per_plane_fragis]
            )
            self._update_granpos()
            qz = np.zeros((nfrags, 64), dtype=np.int32)
            qz[order] = qzc
            last_zzi = np.full(nfrags, 64, dtype=np.int32)
            last_zzi[order] = lz
            dc_full = np.zeros(nfrags, dtype=np.int32)
            dc_full[order] = dcc
            from theora_tpu.native import dc_predict_native

            for pli in range(3):
                pl = g.planes[pli]
                sl = slice(pl.froffset, pl.froffset + pl.nfrags)
                shape = (pl.nvfrags, pl.nhfrags)
                dc_pl = np.ascontiguousarray(dc_full[sl].reshape(shape))
                dc_predict_native(
                    0, coded[sl].reshape(shape),
                    side["refi"][sl].reshape(shape), dc_pl, [0, 0, 0],
                )
                dc_full[sl] = dc_pl.reshape(-1)
            # Keep the postprocessor's persistent qii/qis state current
            # (stale-qii dering semantics, decoder.py) so a later
            # scalar decode_packet with pp enabled sees the same state
            # a pure scalar decode would have.
            self._pp_qis_state[: len(self.qis)] = self.qis
            self._pp_qii_state[coded] = side["qii"][coded]
            per_frame.append(
                dict(side=side, coded=coded, qz=qz, last_zzi=last_zzi,
                     dc=dc_full, ftype=self.frame_type, qis=list(self.qis))
            )
        live = [f for f in per_frame if f is not None]
        if not live:
            return None

        # Stack per-plane inputs over live frames and scan on device.
        out_planes = {}
        new_dev_refs = {}
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            vpad, hpad = g.plane_padding(pli)
            qpx = 1 if (pli != 0 and not (self.info.pixel_fmt & 1)) else 0
            qpy = 1 if (pli != 0 and not (self.info.pixel_fmt & 2)) else 0
            stacks = {k: [] for k in
                      "deqt qii inter dc donly rs y1 x1 y2 x2 u2 coded "
                      "bvf ik".split()}
            counts = np.zeros((len(live), pl.nfrags), np.uint8)
            zzis, valss = [], []
            for fi, fr in enumerate(live):
                side = fr["side"]
                # Sparse AC coefficients for this plane (zzi 1..63; DC
                # travels separately, already predicted).
                qzp = fr["qz"][sl]
                fr_idx, zz_idx = np.nonzero(qzp[:, 1:])
                zz_idx = zz_idx + 1
                counts[fi] = np.bincount(
                    fr_idx, minlength=pl.nfrags
                ).astype(np.uint8)
                zzis.append(zz_idx.astype(np.uint8))
                valss.append(qzp[fr_idx, zz_idx].astype(np.int16))
                frame_dequant = np.stack(
                    [np.stack([self.dequant[qi, pli] for qi in fr["qis"]])]
                )[0]
                refi = side["refi"][sl]
                mode_inter = (refi != FRAME_SELF).astype(np.int8)
                rs = np.where(
                    refi == FRAME_SELF, 0,
                    np.where(refi == FRAME_GOLD, 2, 1),
                ).astype(np.int8)
                # Pad the qii axis to 3 so shapes are static across frames.
                deqt = np.zeros((3, 2, 64), np.int16)
                deqt[: len(fr["qis"])] = frame_dequant.astype(np.int16)
                qii = side["qii"][sl].astype(np.int8)
                dx = side["mv"][sl, 0]
                dy = side["mv"][sl, 1]
                mx = _MVMAP[qpx][dx + 31]
                mx2 = _MVMAP2[qpx][dx + 31]
                my = _MVMAP[qpy][dy + 31]
                my2 = _MVMAP2[qpy][dy + 31]
                u2 = ((mx2 != 0) | (my2 != 0)) & (rs != 0)
                coded = fr["coded"][sl]
                donly = (fr["last_zzi"][sl] < 2) | ~coded
                flimit = self.setup.qinfo["loop_filter_limits"][fr["qis"][0]]
                bvf = (
                    build_bounding_values(flimit).astype(np.int32)
                    if flimit
                    else np.zeros(256, np.int32)
                )
                stacks["deqt"].append(deqt)
                stacks["qii"].append(qii)
                stacks["inter"].append(mode_inter)
                stacks["dc"].append(fr["dc"][sl].astype(np.int16))
                stacks["donly"].append(donly)
                stacks["rs"].append(rs.astype(np.int8))
                stacks["y1"].append(my.astype(np.int8))
                stacks["x1"].append(mx.astype(np.int8))
                stacks["y2"].append((my + my2).astype(np.int8))
                stacks["x2"].append((mx + mx2).astype(np.int8))
                stacks["u2"].append(u2)
                stacks["coded"].append(
                    coded.reshape(pl.nvfrags, pl.nhfrags)
                )
                stacks["bvf"].append(bvf)
                stacks["ik"].append(fr["ftype"] == INTRA_FRAME)
            zz_flat = np.concatenate(zzis)
            val_flat = np.concatenate(valss)
            nnz = _nnz_bucket(max(len(zz_flat), 1))
            zz_pad = np.zeros(nnz, np.uint8)
            zz_pad[: len(zz_flat)] = zz_flat
            val_pad = np.zeros(nnz, np.int16)
            val_pad[: len(val_flat)] = val_flat
            arrs = {k: jnp.asarray(np.stack(v)) for k, v in stacks.items()}
            if self._dev_refs is not None and pli in self._dev_refs:
                init_prev, init_gold = self._dev_refs[pli]
            else:
                prev_i = self.ref_idx[FRAME_PREV]
                gold_i = self.ref_idx[FRAME_GOLD]
                if prev_i < 0 or gold_i < 0:
                    shape = (
                        pl.nvfrags * 8 + 2 * vpad,
                        pl.nhfrags * 8 + 2 * hpad,
                    )
                    init_prev = jnp.full(shape, 0x80, jnp.uint8)
                    init_gold = jnp.full(shape, 0x80, jnp.uint8)
                else:
                    init_prev = jnp.asarray(self.buffers[prev_i].planes[pli])
                    init_gold = jnp.asarray(self.buffers[gold_i].planes[pli])
            do_filter = jnp.asarray(
                np.array([1 if b.any() else 0 for b in stacks["bvf"]],
                         np.int32)
            )
            planes, prev_out, gold_out = _scan_decode_plane(
                init_prev, init_gold,
                jnp.asarray(counts), jnp.asarray(zz_pad),
                jnp.asarray(val_pad), arrs["deqt"], arrs["qii"],
                arrs["inter"], arrs["dc"], arrs["donly"], arrs["rs"],
                arrs["y1"], arrs["x1"], arrs["y2"], arrs["x2"],
                arrs["u2"], arrs["coded"], arrs["bvf"], do_filter,
                jnp.asarray(arrs["ik"]),
                pl.nvfrags, pl.nhfrags, vpad, hpad,
            )
            out_planes[pli] = planes
            new_dev_refs[pli] = (prev_out, gold_out)
        self._dev_refs = new_dev_refs

        # Update host-side bookkeeping: which buffer slots the refs
        # WOULD occupy (pixels stay on device; sync_refs_to_host()
        # materializes them if host-side decode_packet must continue).
        last_intra = None
        for i, fr in enumerate(live):
            if fr["ftype"] == INTRA_FRAME:
                last_intra = i
        refi = 0
        while refi in (self.ref_idx[FRAME_GOLD], self.ref_idx[FRAME_PREV]):
            refi += 1
        self.ref_idx[FRAME_PREV] = refi
        self.ref_idx[FRAME_SELF] = refi
        if last_intra is not None:
            if last_intra == len(live) - 1:
                self.ref_idx[FRAME_GOLD] = refi
            else:
                gold_i = 0
                while gold_i in (refi,):
                    gold_i += 1
                self.ref_idx[FRAME_GOLD] = gold_i
        self._out_frame = self.buffers[refi]

        # Per-packet emit index into the live axis (dup packets repeat;
        # device already cropped the UMV padding).  A dup BEFORE the
        # first live frame of the batch emits -1: the caller must
        # substitute the previous batch's last output frame -- clamping
        # to 0 here would show a FUTURE frame for that packet.
        emit = []
        li = -1
        for fr in per_frame:
            if fr is not None:
                li += 1
            emit.append(li)
        return {"dev": out_planes, "emit": emit}

    def decode_clip(self, packets: list[bytes], batch: int = 8,
                    ) -> list[list[np.ndarray]]:
        """Decode a whole clip with transfer/compute overlap: batches
        are dispatched two deep, each batch's device->host copies are
        started asynchronously (copy_to_host_async) as soon as its scans
        are enqueued, and the blocking materialization happens only
        after the NEXT batch's host entropy parse + device dispatch are
        already in flight.  So the wire time of batch k hides under the
        host parse and device compute of batch k+1 (decode-side double
        buffering).  Byte-exactness
        is untouched: the overlap reorders only transfers, not compute.

        Returns display-orientation [y, u, v] planes per packet."""
        g = self.geometry
        chunks = [
            packets[i : i + batch] for i in range(0, len(packets), batch)
        ]
        outs: list = []
        # If the clip LEADS with a dup packet, the frame it repeats
        # predates this call -- capture it before the first dispatch
        # donates the reference planes away.  None when the decoder has
        # no prior state (then a leading dup is a stream error).
        prior_frame = None
        if packets and len(packets[0]) == 0:
            if self._dev_refs is None and self.ref_idx[FRAME_PREV] < 0:
                raise ValueError("stream must start with a live frame")
            prior_frame = self._prev_output_frame()

        def drain(item):
            chunk, st = item
            if st is None:
                # All-dup chunk: repeat the last emitted frame (the
                # decoder state may already reflect the NEXT in-flight
                # batch, so ycbcr_out() must not be consulted here).
                prev = outs[-1] if outs else prior_frame
                if prev is None:
                    raise ValueError("stream must start with a live frame")
                outs.extend([f.copy() for f in prev] for _ in chunk)
                return
            host = {pli: np.asarray(p) for pli, p in st["dev"].items()}
            for li in st["emit"]:
                if li < 0:
                    # Dup before the chunk's first live frame: repeat
                    # the PREVIOUS chunk's last output, not this
                    # chunk's first (future) frame.
                    prev = outs[-1] if outs else prior_frame
                    if prev is None:
                        raise ValueError(
                            "stream must start with a live frame"
                        )
                    outs.append([f.copy() for f in prev])
                    continue
                frame = []
                for pli in range(3):
                    h, w = g.plane_shape(pli)
                    frame.append(host[pli][li][:h, :w][::-1].copy())
                outs.append(frame)

        pending = None
        for chunk in chunks + [None]:
            if chunk is not None:
                st = self.dispatch_batch(chunk)
                if st is not None:
                    for p in st["dev"].values():
                        p.copy_to_host_async()
                item = (chunk, st)
            else:
                item = None
            if pending is not None:
                drain(pending)
            pending = item
        if outs:
            self._last_out_host = [p.copy() for p in outs[-1]]
        return outs

    def sync_refs_to_host(self) -> None:
        """Materialize the device-resident reference planes into the
        host buffers (needed before mixing decode_batch with the
        scalar decode_packet path)."""
        if self._dev_refs is None:
            return
        prev_i = self.ref_idx[FRAME_PREV]
        gold_i = self.ref_idx[FRAME_GOLD]
        for pli, (prev_out, gold_out) in self._dev_refs.items():
            self.buffers[prev_i].planes[pli][:] = np.asarray(prev_out)
            if gold_i != prev_i:
                self.buffers[gold_i].planes[pli][:] = np.asarray(gold_out)
        self._dev_refs = None
