"""Multi-device scaling: the real GOP encoder sharded over a device mesh.

The codec has no model weights; the scaling axes are (SURVEY.md §2.7):
  - "gop": independent keyframe-delimited GOPs, data-parallel -- each
    device runs the full closed-loop encode scan for its own GOPs;
  - "frag": fragments within a frame, tensor-parallel -- the transform/
    quantize/skip work shards over fragments and only the reconstructed
    8x8 blocks are all-gathered to assemble the carried reference plane.

Shared artifacts (dequant tables, loop-filter table, lambdas) are tiny
and replicated.  Rate control is the one cross-shard dependency: after
the host entropy-codes each batch, the REAL packed bit counts are
psum-reduced over the whole mesh (rate_psum) and fed back into the next
batch's quantizer choice -- the reservoir all-reduce a CBR encode
spanning shards needs.  Entropy-coded packets are ordered host-side for
Ogg muxing.

Byte-identity invariant: encode_clip_mesh over ANY mesh shape produces
the same packets as the sequential TpuGopEncoder (integer compute,
fixed tie-break orders, associative integer psum) -- tested in
tests/test_distributed.py / test_tpu_gop.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from theora_tpu.encode.tpu_gop import (
    TpuGopEncoder,
    WindowRateController,
    make_plane_scan,
)
from theora_tpu.info import TheoraInfo
from theora_tpu.tpkt import Packet


def make_mesh(
    n_devices: int | None = None, frag_axis: int = 1, devices=None
) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    gop = n // frag_axis
    dev_array = np.array(devices).reshape(gop, frag_axis)
    return Mesh(dev_array, ("gop", "frag"))


@functools.partial(jax.jit, static_argnames=("mesh",))
def _rate_psum(mesh, gop_bits):
    """psum of per-GOP REAL packed bit counts over the whole mesh --
    the CBR rate-control collective (gop_bits: [G] int32, sharded over
    "gop" and so replicated over "frag"; returns the replicated total).
    The sum runs over "gop" only: adding the "frag" replicas too would
    count every GOP once per fragment shard."""
    from jax import shard_map

    def f(b):
        return jax.lax.psum(b.sum(), "gop")

    return shard_map(
        f, mesh=mesh, in_specs=(P("gop"),), out_specs=P()
    )(gop_bits)


def rate_psum(mesh: Mesh, gop_bits: np.ndarray) -> int:
    sharded = jax.device_put(
        jnp.asarray(gop_bits, jnp.int32), NamedSharding(mesh, P("gop"))
    )
    return int(_rate_psum(mesh, sharded))


class MeshGopEncoder:
    """TpuGopEncoder fanned out over a (gop, frag) device mesh.

    Encodes batches of G equal-length GOPs in one sharded dispatch per
    plane; the host packs each GOP's frames afterwards.
    """

    def __init__(self, mesh: Mesh, info: TheoraInfo, qi: int | None = None,
                 rd_strength: float = 3.0):
        self.mesh = mesh
        self.base = TpuGopEncoder(info, qi=qi, rd_strength=rd_strength)
        self.g = self.base.g
        self._scan_cache = {}

    # ------------------------------------------------------------------
    def _sharded_scan(self, pli, n_qis: int = 1):
        key = (pli, self.base.use_trellis, n_qis)
        fn = self._scan_cache.get(key)
        if fn is not None:
            return fn
        from jax import shard_map

        g = self.g
        pl = g.planes[pli]
        vpad, hpad = g.plane_padding(pli)
        use_trellis = self.base.use_trellis
        scan = make_plane_scan(
            pl.nvfrags, pl.nhfrags, vpad, hpad, frag_axis="frag",
            use_trellis=use_trellis, n_qis=n_qis,
        )

        def local(init_prev, init_gold, cur, rs, o1y, o1x, o2y, o2x, u2,
                  ms, ik, deqi, deqp, bv, lam, lqi, lqp, nbi, nbp, lti,
                  ltp, lsc):
            # Quantizer inputs carry a per-GOP axis (CBR / 2-pass rate
            # control gives every GOP its own per-frame qi vector; the
            # adaptive triple adds a K row axis); the token-bit tables
            # (nbi/nbp) are frame-type keyed only and stay shared.
            # lsc: per-fragment chooser lambda scales (per-MB masking,
            # all-ones when the mixed-frame gate is off).
            def one_gop(ip, ig, c, r, a, b_, cc, dd, u, m, k, di, dp,
                        bvf, lm, qi_, qp_, ti_, tp_, sc_):
                extra = (nbi, nbp, ti_, tp_) if use_trellis else ()
                return scan(ip, ig, c, r, a, b_, cc, dd, u, m, k,
                            di, dp, bvf, lm, qi_, qp_, *extra,
                            lam_sc=sc_)

            return jax.vmap(one_gop)(
                init_prev, init_gold, cur, rs, o1y, o1x, o2y, o2x, u2,
                ms, ik, deqi, deqp, bv, lam, lqi, lqp, lti, ltp, lsc,
            )

        gfp = P("gop", None, "frag")
        gq = P("gop")
        out = [
            P("gop", None, "frag", None),
            P("gop", None, "frag"),
            P("gop", None, "frag"),
        ]
        if n_qis > 1:
            out.append(P("gop", None, "frag"))  # qii
        out.append(P("gop", None, None))
        fn = jax.jit(shard_map(
            local,
            mesh=self.mesh,
            in_specs=(
                P("gop", None, None), P("gop", None, None),
                P("gop", None, "frag", None, None),
                gfp, gfp, gfp, gfp, gfp, gfp, gfp,
                P("gop", None),
                gq, gq, gq, gq, gq, gq,
                P(), P(), gq, gq, gfp,
            ),
            out_specs=tuple(out),
            check_vma=False,
        ))
        self._scan_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    def encode_gops(self, gops: list, want_sizes: bool = False,
                    frame_qi: list | None = None):
        """Encode G GOPs (equal frame counts) in one mesh dispatch per
        plane.  Returns a list of per-GOP packet byte lists.

        frame_qi: optional per-GOP per-frame base-qi vectors
        ([G][F] ints) -- the 2-pass controller's trajectory; None
        encodes everything at base.qi."""
        base = self.base
        g = self.g
        G = len(gops)
        F = len(gops[0])
        assert all(len(x) == F for x in gops)
        if frame_qi is not None:
            assert len(frame_qi) == G and all(
                len(qv) == F for qv in frame_qi
            )
        fragshards = self.mesh.shape["frag"]

        planes_bs = [
            [[p[::-1].astype(np.uint8) for p in fr] for fr in gop]
            for gop in gops
        ]
        # Batched ME + mode decision across all GOPs' inter frames.
        plans_per_gop = [[] for _ in range(G)]
        if F > 1:
            ys = [np.stack([fr[0] for fr in pg]) for pg in planes_bs]
            cur = np.concatenate([y[1:] for y in ys])
            prev = np.concatenate([y[:-1] for y in ys])
            gold = np.concatenate(
                [np.broadcast_to(y[0], (F - 1,) + y.shape[1:]) for y in ys]
            )
            flat_plans = base._plan_frames(cur, prev, gold)
            for gi in range(G):
                plans_per_gop[gi] = flat_plans[
                    gi * (F - 1) : (gi + 1) * (F - 1)
                ]

        nfrags = g.nfrags
        zero_rs = np.zeros(nfrags, np.int8)
        zero_mv = np.zeros((nfrags, 2), np.int32)
        no_skip = np.zeros(nfrags, bool)
        frame_frag = [
            [(zero_rs, zero_mv, no_skip)]
            + [base._frag_plan(mm, mv, bm)
               for mm, mv, bm in plans_per_gop[gi]]
            for gi in range(G)
        ]

        # Per-(GOP, frame) adaptive qi lists through the SAME gate as
        # the sequential tier (complete_dispatch) -- the sequential-vs-
        # mesh byte-identity contract requires identical triples, and
        # they are a pure function of (content, base qi), so they are
        # also mesh-shape independent.
        from theora_tpu.encode.encoder import Encoder as _Enc

        saved_nl = getattr(base.enc, "_frame_noise_like", False)
        saved_mx = getattr(base.enc, "_frame_mixed", False)
        saved_sc = getattr(base.enc, "_frag_lam_scale", None)
        frame_sc = [[None] * F for _ in range(G)]
        try:
            fqis_gf = []
            for gi in range(G):
                row = []
                for f in range(F):
                    y = planes_bs[gi][f][0]
                    base.enc._frame_noise_like = _Enc._noise_like(y)
                    act = _Enc._luma_activity(y)
                    mixed = _Enc._mixed_frame(act)
                    base.enc._frame_mixed = mixed
                    sc = (
                        base.enc._activity_iscale(act)
                        if (mixed and base.adaptive_quant
                            and not base.enc._frame_noise_like)
                        else None
                    )
                    base.enc._frag_lam_scale = sc
                    q = (
                        base.qi if frame_qi is None
                        else int(frame_qi[gi][f])
                    )
                    row.append(base._adaptive_qis(
                        keyframe_only=(F == 1), qi=q
                    ))
                    if sc is not None and len(row[-1]) > 1:
                        frame_sc[gi][f] = sc
                fqis_gf.append(row)
        finally:
            base.enc._frame_noise_like = saved_nl
            base.enc._frame_mixed = saved_mx
            base.enc._frag_lam_scale = saved_sc
        K = max(len(q) for row in fqis_gf for q in row)
        fqis_pad = [
            [list(q) + [q[0]] * (K - len(q)) for q in row]
            for row in fqis_gf
        ]

        qdct_pl = {}
        coded_pl = {}
        qii_pl = {}
        for pli in range(3):
            pl = g.planes[pli]
            vpad, hpad = g.plane_padding(pli)
            n = pl.nfrags
            npad = -(-n // fragshards) * fragshards
            stacks = {k: [] for k in ("cur", "rs", "o1y", "o1x", "o2y",
                                      "o2x", "u2", "ms")}
            for gi in range(G):
                fs = {k: [] for k in stacks}
                for f in range(F):
                    rs, fmv, ms = frame_frag[gi][f]
                    d = base._plane_inputs(
                        pli, planes_bs[gi][f], rs, fmv, ms
                    )
                    for k in fs:
                        fs[k].append(d[k])
                for k in stacks:
                    arr = np.stack(fs[k])
                    if npad != n:
                        pad = np.zeros(
                            (F, npad - n) + arr.shape[2:], arr.dtype
                        )
                        if k == "ms":
                            pad[:] = True  # pads skip themselves
                        arr = np.concatenate([arr, pad], axis=1)
                    stacks[k].append(arr)
            arrs = {
                k: jnp.asarray(np.stack(v)) for k, v in stacks.items()
            }
            is_intra = jnp.asarray(
                np.broadcast_to(
                    np.arange(F) == 0, (G, F)
                ).copy()
            )
            init = jnp.full(
                (G, pl.nvfrags * 8 + 2 * vpad, pl.nhfrags * 8 + 2 * hpad),
                0x80, jnp.uint8,
            )
            dq = base.enc.dequant
            from theora_tpu.ops.fdct_np import rd_lambda
            from theora_tpu.ops.loopfilter_np import (
                build_bounding_values,
            )

            fn = self._sharded_scan(pli, n_qis=K)
            # Per-GOP, per-frame quantizer inputs ([G, F(, K), ...];
            # the scan takes a leading F axis per GOP, a K row axis
            # when adaptive, and the mesh maps the G axis).  Fixed-qi
            # dispatches broadcast one row.
            di_g = np.empty((G, F, K, 64), np.int32)
            dp_g = np.empty((G, F, K, 64), np.int32)
            bv_g = np.empty((G, F, 256), np.int32)
            lam_g = np.empty((G, F), np.float32)
            lqi_g = np.empty((G, F, K), np.float32)
            lqp_g = np.empty((G, F, K), np.float32)
            lti_g = np.empty((G, F, K), np.float32)
            ltp_g = np.empty((G, F, K), np.float32)
            bv_cache = {}
            for gi in range(G):
                for f in range(F):
                    qrow = fqis_pad[gi][f]
                    q = qrow[0]
                    di_g[gi, f] = dq[qrow][:, pli, 0].astype(np.int32)
                    dp_g[gi, f] = dq[qrow][:, pli, 1].astype(np.int32)
                    # DC always quantizes with the base qi.
                    di_g[gi, f, :, 0] = dq[q, pli, 0, 0]
                    dp_g[gi, f, :, 0] = dq[q, pli, 1, 0]
                    if q not in bv_cache:
                        flimit = base.enc.qinfo[
                            "loop_filter_limits"
                        ][q]
                        bv_cache[q] = (
                            build_bounding_values(flimit)
                            .astype(np.int32)
                            if flimit else np.zeros(256, np.int32)
                        )
                    bv_g[gi, f] = bv_cache[q]
                    lam_g[gi, f] = (
                        rd_lambda(q, int(dq[q, 0, 1, 1]))
                        * base.rd_strength * 4.0
                    )
                    lqi_g[gi, f] = [
                        rd_lambda(qk, int(dq[qk, pli, 0, 1]))
                        * base.rd_strength for qk in qrow
                    ]
                    lqp_g[gi, f] = [
                        rd_lambda(qk, int(dq[qk, pli, 1, 1]))
                        * base.rd_strength for qk in qrow
                    ]
                    lti_g[gi, f] = [
                        base._lam_t_for(qk)[0] for qk in qrow
                    ]
                    ltp_g[gi, f] = [
                        base._lam_t_for(qk)[1] for qk in qrow
                    ]
            if K == 1:
                di_g = di_g[:, :, 0]
                dp_g = dp_g[:, :, 0]
                lqi_g = lqi_g[..., 0]
                lqp_g = lqp_g[..., 0]
                lti_g = lti_g[..., 0]
                ltp_g = ltp_g[..., 0]
            # Per-fragment chooser lambda scales (luma only; ones
            # elsewhere and on every unengaged frame -- *1.0 is exact,
            # so unengaged output is bit-identical).
            lsc_g = np.ones((G, F, npad), np.float32)
            if pli == 0:
                for gi in range(G):
                    for f in range(F):
                        if frame_sc[gi][f] is not None:
                            lsc_g[gi, f, :n] = frame_sc[gi][f][:n]
            outs = fn(
                init, init,
                arrs["cur"], arrs["rs"], arrs["o1y"], arrs["o1x"],
                arrs["o2y"], arrs["o2x"], arrs["u2"], arrs["ms"],
                is_intra,
                jnp.asarray(di_g), jnp.asarray(dp_g),
                jnp.asarray(bv_g), jnp.asarray(lam_g),
                jnp.asarray(lqi_g), jnp.asarray(lqp_g),
                jnp.asarray(base._nb_dev), jnp.asarray(base._nb_dev),
                jnp.asarray(lti_g), jnp.asarray(ltp_g),
                jnp.asarray(lsc_g),
            )
            qdct, coded = outs[0], outs[1]
            qdct_pl[pli] = np.asarray(qdct)[:, :, :n]
            coded_pl[pli] = np.asarray(coded)[:, :, :n]
            if K > 1:
                qii_pl[pli] = np.asarray(outs[3])[:, :, :n]

        out = []
        for gi in range(G):
            out.append(base._pack_gop(
                F, plans_per_gop[gi], frame_frag[gi],
                {pli: qdct_pl[pli][gi] for pli in range(3)},
                {pli: coded_pl[pli][gi] for pli in range(3)},
                fqis=fqis_gf[gi],
                qii_pl=(
                    {pli: qii_pl[pli][gi] for pli in range(3)}
                    if K > 1 else None
                ),
            ))
        return out


def encode_clip_mesh(
    frames: list,
    info: TheoraInfo,
    mesh: Mesh,
    keyframe_freq: int = 8,
    qi: int | None = None,
    target_bitrate: int = 0,
    rate_window: int = 8,
    auto_keyframe: bool = False,
    twopass_data: bytes | None = None,
    buf_delay: int | None = None,
) -> list[Packet]:
    """Encode a clip over the mesh, GOP batches up to the gop-axis size.

    auto_keyframe segments GOPs at detected scene cuts (bounded by
    keyframe_freq) via the deterministic content-only pre-pass
    (tpu_gop.detect_scene_cuts), so every mesh shape derives the same
    (possibly uneven) GOP boundaries.

    With target_bitrate > 0, a reservoir controller adjusts qi at fixed
    rate_window GOP boundaries from the psum of real packed bit counts
    (the rate collective).  rate_window is arbitrary: a dispatch batch
    is clipped at window boundaries, so a qi update never lands inside
    a batch and the update happens at the same GOP index on every mesh
    shape.  The window is mesh-independent and the psum is an
    associative integer sum, so the qi trajectory -- and therefore
    every output byte -- is identical on any mesh shape.
    """
    from theora_tpu.encode.tpu_gop import gop_starts

    enc = MeshGopEncoder(mesh, info, qi=qi)
    G = mesh.shape["gop"]
    out = enc.base.flush_headers()
    shift = info.keyframe_granule_shift
    nf = len(frames)
    starts = gop_starts(frames, keyframe_freq, auto_keyframe)
    bounds = starts + [nf]
    gop_list = [
        (starts[k], frames[starts[k] : bounds[k + 1]])
        for k in range(len(starts))
    ]
    pno = 3
    # 2-pass mode: the reference's OT2P window allocation steers a
    # per-frame qi trajectory at rate_window-GOP windows.  Window
    # boundaries sit at FIXED GOP indices (mesh-shape independent); the
    # qi vectors for a whole window derive from the window-start
    # controller state via the model-estimate pre-pass
    # (rate.twopass_window_qvecs) -- no real bits inside a window -- so
    # the trajectory (and every output byte) is identical on any mesh
    # shape; the controller replays with REAL bits between windows.
    if twopass_data is not None:
        from theora_tpu.encode.rate import (
            RateControl,
            twopass_window_qvecs,
        )

        rc2 = RateControl(
            enc.base._rc_info(target_bitrate), enc.base.enc.dequant,
            keyframe_freq,
        )
        rc2.drop_frames = False
        rc2.start_pass2(twopass_data, buf_delay)
        prev_applied = enc.base.qi
        for w0 in range(0, len(gop_list), rate_window):
            window = gop_list[w0 : w0 + rate_window]
            qvecs = twopass_window_qvecs(
                rc2, [len(gp) for _, gp in window], prev_applied
            )
            results = []
            for c0 in range(0, len(window), G):
                batch = window[c0 : c0 + G]
                qv_b = qvecs[c0 : c0 + G]
                F = max(len(gp) for _, gp in batch)
                padded = [
                    gp + [gp[-1]] * (F - len(gp)) for _, gp in batch
                ]
                frame_qi = [
                    qv + [qv[-1]] * (F - len(qv)) for qv in qv_b
                ]
                while len(padded) < G:
                    padded.append(padded[0])
                    frame_qi.append(frame_qi[0])
                results.extend(enc.encode_gops(
                    padded, frame_qi=frame_qi
                )[: len(batch)])
            for (base_f, gfr), pk, qv in zip(window, results, qvecs):
                nreal = len(gfr)
                for j in range(nreal):
                    fnum = base_f + j
                    gp = ((base_f + 1) << shift) + j
                    out.append(Packet(
                        pk[j], granulepos=gp, packetno=pno,
                        e_o_s=(fnum == nf - 1),
                    ))
                    pno += 1
                    # Per-frame controller replay with REAL bits, in
                    # frame order, identically on every host.
                    ftype = 0 if j == 0 else 1
                    rc2.select_qi(ftype, prev_applied)
                    rc2.log_qtarget = rc2.log_qavg[ftype][qv[j]]
                    rc2.update(ftype, qv[j], 8 * len(pk[j]),
                               droppable=False)
                    prev_applied = qv[j]
        return out
    rc = WindowRateController(enc.base, target_bitrate, rate_window)
    win_bits: list[int] = []
    win_frames = 0

    def rate_update():
        nonlocal win_frames
        if not win_bits:
            return
        # REAL packed bits, psum-reduced over the mesh (pad the window
        # to the gop axis; zeros don't change the sum), applied through
        # the shared window controller (encode/tpu_gop.py) so single-
        # device encode_clip CBR is byte-identical by construction.
        arr = np.zeros(max(-(-len(win_bits) // G) * G, G), np.int32)
        arr[: len(win_bits)] = win_bits
        rc.apply(rate_psum(mesh, arr), win_frames)
        win_bits.clear()
        win_frames = 0

    b0 = 0
    while b0 < len(gop_list):
        size = min(G, len(gop_list) - b0)
        if target_bitrate > 0:
            # Clip the batch at the next rate-window boundary: updates
            # then always fall between dispatches, at mesh-independent
            # GOP indices (costs parallelism only in the boundary
            # batch when rate_window is not a multiple of G).
            size = min(size, rate_window - b0 % rate_window)
        batch = gop_list[b0 : b0 + size]
        real = len(batch)
        F = max(len(gp) for _, gp in batch)
        # Equal-shape padding: short GOPs repeat their last frame, the
        # batch pads with copies of GOP 0 (outputs dropped).
        padded = [
            gp + [gp[-1]] * (F - len(gp)) for _, gp in batch
        ]
        while len(padded) < G:
            padded.append(padded[0])
        pkts_per_gop = enc.encode_gops(padded)
        for gi in range(real):
            base_f, gfr = batch[gi]
            nreal = len(gfr)
            for j in range(nreal):
                fnum = base_f + j
                gp = ((base_f + 1) << shift) + j
                out.append(Packet(
                    pkts_per_gop[gi][j], granulepos=gp, packetno=pno,
                    e_o_s=(fnum == nf - 1),
                ))
                pno += 1
            if target_bitrate > 0:
                win_bits.append(
                    8 * sum(len(d) for d in pkts_per_gop[gi][:nreal])
                )
                win_frames += nreal
                if (b0 + gi + 1) % rate_window == 0:
                    rate_update()
        b0 += size
    if target_bitrate > 0:
        rate_update()
    return out
