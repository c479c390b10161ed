"""Device-resident GOP encoder (encode/tpu_gop.py).

The contract: every decision and the closed-loop reconstruction are made
on device; the host only entropy-codes the plan.  So (a) the device's
carried reconstruction must equal the decoder's output on the produced
packets bit-for-bit, and (b) the packets must decode identically in the
reference decoder (oracle).
"""
import os
import subprocess

import numpy as np
import pytest

from tests.conftest import REPO_ROOT, TESTDATA, ensure_ref_oracle
from theora_tpu.decode.decoder import Decoder
from theora_tpu.encode.tpu_gop import TpuGopEncoder
from theora_tpu.headers import (
    parse_comment_header,
    parse_info_header,
    parse_setup_header,
)
from theora_tpu.info import TheoraInfo
from theora_tpu.tpkt import Packet


def _load_clip(name, w, h, n):
    raw = np.fromfile(os.path.join(TESTDATA, name), np.uint8)
    fsz = w * h * 3 // 2
    out = []
    for i in range(min(n, len(raw) // fsz)):
        fr = raw[i * fsz : (i + 1) * fsz]
        out.append([
            fr[: w * h].reshape(h, w),
            fr[w * h : w * h + w * h // 4].reshape(h // 2, w // 2),
            fr[w * h + w * h // 4 :].reshape(h // 2, w // 2),
        ])
    return out


def _moving_frames(w, h, fmt, n, seed):
    rng = np.random.RandomState(seed)
    cw = w if fmt & 1 else w // 2
    ch = h if fmt & 2 else h // 2
    y0 = rng.randint(0, 256, (h, w)).astype(np.uint8)
    u0 = rng.randint(0, 256, (ch, cw)).astype(np.uint8)
    v0 = rng.randint(0, 256, (ch, cw)).astype(np.uint8)
    return [
        [
            np.roll(y0, (f, 2 * f), (0, 1)),
            np.roll(u0, (f // 2, f), (0, 1)),
            np.roll(v0, (f // 2, f), (0, 1)),
        ]
        for f in range(n)
    ]


def _decode_all(enc, datas):
    hp = enc.flush_headers()
    info = parse_info_header(hp[0].data)
    parse_comment_header(hp[1].data)
    setup = parse_setup_header(hp[2].data)
    dec = Decoder(info, setup)
    outs = []
    for d in datas:
        dec.decode_packet(d)
        outs.append(dec)
        yield dec


@pytest.mark.parametrize("fmt,qi", [(0, 40), (2, 24), (3, 55)])
def test_closed_loop_identity(fmt, qi):
    """Device-carried reconstruction == decoder output, bit for bit."""
    frames = _moving_frames(64, 48, fmt, 5, fmt * 7 + qi)
    info = TheoraInfo(
        frame_width=64, frame_height=48, pic_width=64, pic_height=48,
        quality=qi, pixel_fmt=fmt,
    )
    enc = TpuGopEncoder(info, qi=qi)
    datas, recon = enc.encode_gop(frames, want_recon=True)
    g = enc.g
    for f, dec in enumerate(_decode_all(enc, datas)):
        for pli in range(3):
            vpad, hpad = g.plane_padding(pli)
            hh, ww = g.plane_shape(pli)
            got = dec._out_frame.planes[pli][
                vpad : vpad + hh, hpad : hpad + ww
            ]
            want = recon[pli][f][vpad : vpad + hh, hpad : hpad + ww]
            assert np.array_equal(got, want), (f, pli)


def test_reference_decoder_agrees():
    """Device-tier streams decode bit-identically in libtheora."""
    if not ensure_ref_oracle():
        pytest.skip("reference oracle unavailable")
    from theora_tpu.tpkt import write_tpkt

    frames = _load_clip("clip64x48.i420", 64, 48, 8)
    info = TheoraInfo(
        frame_width=64, frame_height=48, pic_width=64, pic_height=48,
        quality=32,
    )
    enc = TpuGopEncoder(info, qi=32)
    pkts = enc.encode_clip(frames, keyframe_freq=4)
    tpkt = "/tmp/test_tpu_gop.tpkt"
    yuv = "/tmp/test_tpu_gop.yuv"
    write_tpkt(tpkt, pkts)
    subprocess.run(
        [os.path.join(REPO_ROOT, "refbuild", "build", "ref_dec"),
         tpkt, yuv],
        check=True, capture_output=True,
    )
    ref = open(yuv, "rb").read()
    ours = bytearray()
    hp = enc.flush_headers()
    dinfo = parse_info_header(hp[0].data)
    parse_comment_header(hp[1].data)
    setup = parse_setup_header(hp[2].data)
    dec = Decoder(dinfo, setup)
    for p in pkts[3:]:
        dec.decode_packet(p.data)
        for pl in dec.ycbcr_out():
            ours += pl.tobytes()
    assert bytes(ours) == ref


def test_mesh_byte_identity():
    """Mesh-sharded encode (gop x frag, incl. fragment all_gather and
    the CBR psum over real packed bits) == sequential, byte for byte,
    on every mesh shape."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from theora_tpu.parallel.gop import encode_clip_mesh, make_mesh

    frames = _moving_frames(64, 48, 0, 11, 7)
    info = TheoraInfo(
        frame_width=64, frame_height=48, pic_width=64, pic_height=48,
        quality=40, fps_numerator=30, fps_denominator=1,
    )
    kw = dict(keyframe_freq=4, qi=40, target_bitrate=80_000,
              rate_window=8)
    ref = None
    for nd, fragax in ((1, 1), (8, 2), (8, 1), (4, 4)):
        mesh = make_mesh(nd, frag_axis=fragax)
        pk = encode_clip_mesh(frames, info, mesh, **kw)
        blob = b"".join(p.data for p in pk)
        if ref is None:
            ref = blob
        assert blob == ref, dict(mesh.shape)
    # And VBR vs the plain sequential encoder class.
    mesh = make_mesh(8, frag_axis=2)
    pk = encode_clip_mesh(frames, info, mesh, keyframe_freq=4, qi=40)
    seq = TpuGopEncoder(info, qi=40).encode_clip(frames, keyframe_freq=4)
    assert [p.data for p in pk] == [p.data for p in seq]


@pytest.mark.parametrize("nd,fragax", [(1, 1), (4, 2), (8, 4), (8, 8)])
def test_rate_psum_counts_each_gop_once(nd, fragax):
    """The CBR collective sums the per-GOP bit counts once, whatever the
    fragment axis: the counts are sharded over "gop" and replicated over
    "frag"."""
    import jax

    if len(jax.devices()) < nd:
        pytest.skip(f"needs {nd} virtual devices")
    from theora_tpu.parallel.gop import make_mesh, rate_psum

    mesh = make_mesh(nd, frag_axis=fragax)
    bits = np.arange(1, mesh.shape["gop"] * 3 + 1, dtype=np.int32) * 1000
    assert rate_psum(mesh, bits) == int(bits.sum())


def test_mesh_arbitrary_rate_window_and_auto_keyframes():
    """CBR windows that do NOT divide the gop axis (dispatch batches are
    clipped at window boundaries) and scene-cut-driven uneven GOPs stay
    byte-identical across mesh shapes, and the auto keyframes land where
    the scene cuts are."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from theora_tpu.encode.tpu_gop import detect_scene_cuts
    from theora_tpu.parallel.gop import encode_clip_mesh, make_mesh

    # Smooth panning content (small inter-frame deltas) with a hard
    # scene cut at frame 9 (luma inverted from there on).
    yy, xx = np.mgrid[0:48, 0:64]
    rng = np.random.RandomState(5)
    tex = rng.randint(0, 48, (48, 64)).astype(np.int32)
    frames = []
    for t in range(14):
        y = (tex + 80 + 70 * np.sin((xx + 2 * t) / 9.0)).clip(0, 255)
        y = y.astype(np.uint8)
        if t >= 9:
            y = 255 - y
        u = (128 + 40 * np.cos((yy[::2, ::2] + t) / 7.0)).astype(np.uint8)
        v = (128 - 40 * np.sin((xx[::2, ::2] - t) / 8.0)).astype(np.uint8)
        frames.append([y, u, v])
    info = TheoraInfo(
        frame_width=64, frame_height=48, pic_width=64, pic_height=48,
        quality=40, fps_numerator=30, fps_denominator=1,
    )
    starts = detect_scene_cuts(frames, 8)
    assert 9 in starts  # the cut was detected
    assert max(np.diff(starts + [len(frames)])) <= 8
    kw = dict(keyframe_freq=8, qi=40, target_bitrate=90_000,
              rate_window=3, auto_keyframe=True)  # 3 !| gop axis of 4
    ref = None
    for nd, fragax in ((1, 1), (8, 2), (4, 1)):
        mesh = make_mesh(nd, frag_axis=fragax)
        pk = encode_clip_mesh(frames, info, mesh, **kw)
        blob = b"".join(p.data for p in pk)
        if ref is None:
            ref = blob
            # Keyframes really are at the detected starts: granulepos
            # frame part resets there.
            kfs = [
                i for i, p in enumerate(pk[3:])
                if (p.granulepos & ((1 << info.keyframe_granule_shift) - 1))
                == 0
            ]
            assert kfs == starts
        assert blob == ref, dict(mesh.shape)
    # Sequential device encoder with the same segmentation matches too.
    enc = TpuGopEncoder(info, qi=40)
    seq = enc.encode_clip(frames, keyframe_freq=8, target_bitrate=90_000,
                          rate_window=3, auto_keyframe=True)
    assert b"".join(p.data for p in seq) == ref


def test_single_device_cbr_matches_mesh():
    """encode_clip with target_bitrate uses the same window controller
    the mesh path psums over devices: byte-identical to a 1-device mesh
    encode, and the qi actually moves under pressure."""
    import jax

    from theora_tpu.parallel.gop import encode_clip_mesh, make_mesh

    frames = _moving_frames(64, 48, 0, 12, 13)
    info = TheoraInfo(
        frame_width=64, frame_height=48, pic_width=64, pic_height=48,
        quality=40, fps_numerator=30, fps_denominator=1,
    )
    kw = dict(keyframe_freq=4, qi=40, target_bitrate=60_000,
              rate_window=1)
    enc = TpuGopEncoder(info, qi=40)
    pk = enc.encode_clip(frames, keyframe_freq=4, target_bitrate=60_000,
                         rate_window=1)
    assert enc.qi != 40  # noisy content at 60 kbps forces a qi move
    mesh = make_mesh(1, frag_axis=1, devices=jax.devices()[:1])
    pk_mesh = encode_clip_mesh(frames, info, mesh, **kw)
    assert [p.data for p in pk] == [p.data for p in pk_mesh]


def test_device_speed_levels():
    """set_splevel mirrors the host semantics: 2+ drops the trellis,
    4 prices MV modes out; every level still decodes bit-exactly."""
    frames = _moving_frames(64, 48, 0, 6, 3)
    info = TheoraInfo(
        frame_width=64, frame_height=48, pic_width=64, pic_height=48,
        quality=40,
    )
    outs = {}
    for lvl in (0, 2, 4):
        enc = TpuGopEncoder(info, qi=40)
        enc.set_splevel(lvl)
        assert enc.use_trellis == (lvl < 2)
        pkts = enc.encode_clip(frames, keyframe_freq=6)
        for _ in _decode_all(enc, [p.data for p in pkts[3:]]):
            pass  # raises on any invalid stream
        outs[lvl] = sum(len(p.data) for p in pkts[3:])
    # no-MC cannot beat full search on moving content
    assert outs[4] >= outs[2]


def test_mode_decision_without_native_library(monkeypatch):
    """When the native library cannot load, the mode decision falls back
    to the Python walk, with the same packets as the C++ walk."""
    import theora_tpu.native as native

    frames = _moving_frames(64, 48, 0, 5, 11)
    info = TheoraInfo(
        frame_width=64, frame_height=48, pic_width=64, pic_height=48,
        quality=40,
    )
    want = TpuGopEncoder(info, qi=40).encode_clip(frames, keyframe_freq=8)

    def unavailable(*args):
        raise RuntimeError("native entropy library unavailable")

    monkeypatch.setattr(native, "mode_decide_native", unavailable)
    got = TpuGopEncoder(info, qi=40).encode_clip(frames, keyframe_freq=8)
    assert [p.data for p in got] == [p.data for p in want]


def test_encode_clip_granulepos():
    frames = _moving_frames(32, 32, 0, 7, 9)
    info = TheoraInfo(
        frame_width=32, frame_height=32, pic_width=32, pic_height=32,
        quality=40,
    )
    enc = TpuGopEncoder(info, qi=40)
    pkts = enc.encode_clip(frames, keyframe_freq=4)
    assert len(pkts) == 3 + 7
    gps = [p.granulepos for p in pkts[3:]]
    assert gps == sorted(gps)
    shift = info.keyframe_granule_shift
    # Keyframes at 0 and 4 (frame numbering matches the host encoder's).
    assert gps[0] == (1 << shift)
    assert gps[4] == (5 << shift)
    assert gps[3] == (1 << shift) + 3
    assert pkts[-1].e_o_s


@pytest.mark.parametrize("stream", ["clip64x48_k8_q20", "cif_cbr"])
def test_transcode_device_byte_identity(stream):
    """Device-resident transcode (decode scan -> encode scan, pixels
    never leaving the device) must produce byte-identical packets to
    host-decoding the stream and encoding the frames with
    TpuGopEncoder.encode_clip.  cif_cbr includes dup (0-byte) packets,
    exercising the emit-index expansion."""
    from theora_tpu.encode.tpu_gop import transcode_device
    from theora_tpu.tpkt import read_tpkt

    pkts = read_tpkt(os.path.join(TESTDATA, f"{stream}.tpkt"))
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)
    data = [p.data for p in pkts[3:]][:12]

    # Host reference: scalar decode, then the device encoder on frames.
    dec = Decoder(info, setup)
    frames = []
    for d in data:
        dec.decode_packet(d)
        frames.append([p.copy() for p in dec.ycbcr_out()])
    enc = TpuGopEncoder(info, qi=40)
    want = enc.encode_clip(frames, keyframe_freq=6)

    got = transcode_device(info, setup, data, keyframe_freq=6, qi=40)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.data == b.data
        assert a.granulepos == b.granulepos


def test_4mv_and_golden_mv_modes():
    """The device tier's full 8-mode alphabet: content built so 4MV and
    GOLDEN_MV win some macroblocks; the plan must actually choose them,
    the closed-loop recon must equal the decoder bit-for-bit, and the
    stream must decode identically in the reference decoder."""
    from theora_tpu.constants import MODE_GOLDEN_MV, MODE_INTER_MV_FOUR
    from theora_tpu.tpkt import write_tpkt

    if not ensure_ref_oracle():
        pytest.skip("reference oracle unavailable")
    rng = np.random.RandomState(3)
    W, H = 96, 64
    y0 = rng.randint(0, 256, (H, W)).astype(np.uint8)
    u0 = rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)
    v0 = rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)

    def frame(y):
        return [y, u0, v0]

    frames = [frame(y0)]
    # Frame 1: the band boundary sits mid-MB (y=24), so the MBs of
    # grid row 1 have their top blocks moving right and bottom blocks
    # moving left -- per-block vectors (4MV) fit, one MB vector cannot.
    y1 = y0.copy()
    y1[:24] = np.roll(y0[:24], 4, axis=1)
    y1[24:] = np.roll(y0[24:], -4, axis=1)
    frames.append(frame(y1))
    # Frame 2: unrelated noise (prev becomes useless).
    frames.append(frame(rng.randint(0, 256, (H, W)).astype(np.uint8)))
    # Frame 3: a clean global shift of the KEYFRAME -- golden + MV wins
    # over the noise in prev.
    frames.append(frame(np.roll(y0, (2, 5), (0, 1))))

    info = TheoraInfo(
        frame_width=W, frame_height=H, pic_width=W, pic_height=H,
        quality=48,
    )
    enc = TpuGopEncoder(info, qi=48)
    state = enc.dispatch_gop(frames, want_recon=True)
    # state[1] is the per-frame plan list (None rows at keyframes).
    plans = [p for p in state[1] if p is not None]
    modes_used = set()
    for mm, mv, bm in plans:
        modes_used.update(int(m) for m in mm[mm >= 0])
    assert MODE_INTER_MV_FOUR in modes_used, modes_used
    assert MODE_GOLDEN_MV in modes_used, modes_used
    datas, recon = enc.finish_gop(state)
    # Closed loop == decoder, bit for bit.
    g = enc.g
    for f, dec in enumerate(_decode_all(enc, datas)):
        for pli in range(3):
            vpad, hpad = g.plane_padding(pli)
            hh, ww = g.plane_shape(pli)
            got = dec._out_frame.planes[pli][
                vpad : vpad + hh, hpad : hpad + ww
            ]
            want = recon[pli][f][vpad : vpad + hh, hpad : hpad + ww]
            assert np.array_equal(got, want), (f, pli)
    # Reference decoder agrees byte for byte.
    hp = enc.flush_headers()
    shift = info.keyframe_granule_shift
    pkts = list(hp)
    for j, d in enumerate(datas):
        pkts.append(Packet(d, granulepos=(1 << shift) + j, packetno=3 + j,
                           e_o_s=(j == len(datas) - 1)))
    tpkt = "/tmp/test_tpu_4mv.tpkt"
    yuv = "/tmp/test_tpu_4mv.yuv"
    write_tpkt(tpkt, pkts)
    subprocess.run(
        [os.path.join(REPO_ROOT, "refbuild", "build", "ref_dec"),
         tpkt, yuv],
        check=True, capture_output=True,
    )
    ref = open(yuv, "rb").read()
    dinfo = parse_info_header(hp[0].data)
    parse_comment_header(hp[1].data)
    setup = parse_setup_header(hp[2].data)
    dec = Decoder(dinfo, setup)
    ours = bytearray()
    for d in datas:
        dec.decode_packet(d)
        for pl in dec.ycbcr_out():
            ours += pl.tobytes()
    assert bytes(ours) == ref


def test_adaptive_quant_device():
    """Device-tier adaptive quantization: a qi triple with per-fragment
    qii chosen by the scan's R/D proxy, packed as the block-qi RLE.
    Mixed smooth/textured content must actually use >1 qi, the closed
    loop must equal the decoder bit-for-bit, and the reference decoder
    must agree."""
    from theora_tpu.tpkt import write_tpkt

    if not ensure_ref_oracle():
        pytest.skip("reference oracle unavailable")
    rng = np.random.RandomState(9)
    W, H = 96, 64
    y0 = np.zeros((H, W), np.uint8)
    y0[:, : W // 2] = 128 + (np.arange(W // 2) // 4)[None, :]  # smooth
    y0[:, W // 2 :] = rng.randint(0, 256, (H, W // 2))         # textured
    u0 = np.full((H // 2, W // 2), 90, np.uint8)
    v0 = rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)
    frames = [[np.roll(y0, f, 1), u0, v0] for f in range(4)]

    info = TheoraInfo(
        frame_width=W, frame_height=H, pic_width=W, pic_height=H,
        quality=40,
    )
    enc = TpuGopEncoder(info, qi=40)
    enc.adaptive_quant = True
    assert len(enc._adaptive_qis()) == 3
    state = enc.dispatch_gop(frames, want_recon=True)
    datas, recon = enc.finish_gop(state)
    g = enc.g
    for f, dec in enumerate(_decode_all(enc, datas)):
        assert len(dec.qis) == 3, "stream must carry the qi triple"
        for pli in range(3):
            vpad, hpad = g.plane_padding(pli)
            hh, ww = g.plane_shape(pli)
            got = dec._out_frame.planes[pli][
                vpad : vpad + hh, hpad : hpad + ww
            ]
            want = recon[pli][f][vpad : vpad + hh, hpad : hpad + ww]
            assert np.array_equal(got, want), (f, pli)
    # At least one fragment chose a non-base qi.
    qii_y = np.asarray(state[3][0][0][-1])  # luma [F, N] qii
    assert (qii_y > 0).any(), "adaptive quant never chose a non-base qi"
    hp = enc.flush_headers()
    shift = info.keyframe_granule_shift
    pkts = list(hp)
    for j, d in enumerate(datas):
        pkts.append(Packet(d, granulepos=(1 << shift) + j, packetno=3 + j,
                           e_o_s=(j == len(datas) - 1)))
    tpkt = "/tmp/test_tpu_aq.tpkt"
    yuv = "/tmp/test_tpu_aq.yuv"
    write_tpkt(tpkt, pkts)
    subprocess.run(
        [os.path.join(REPO_ROOT, "refbuild", "build", "ref_dec"),
         tpkt, yuv],
        check=True, capture_output=True,
    )
    ref = open(yuv, "rb").read()
    dinfo = parse_info_header(hp[0].data)
    parse_comment_header(hp[1].data)
    setup = parse_setup_header(hp[2].data)
    dec = Decoder(dinfo, setup)
    ours = bytearray()
    for d in datas:
        dec.decode_packet(d)
        for pl in dec.ycbcr_out():
            ours += pl.tobytes()
    assert bytes(ours) == ref


@pytest.mark.parametrize("target", [150000, 300000])
def test_device_twopass_cbr(target):
    """Device-tier 2-pass: OT2P pass-1 blob in the reference format
    (parses with the host RateControl), pass-2 deviation within 5% at
    a finite buf_delay (the reference's own whole-file allocator
    leaves up to 15% unspent, rate.c:506-625)."""
    from theora_tpu.encode.rate import RateControl

    W, H = 352, 288
    raw = np.fromfile(
        os.path.join(TESTDATA, "cif_smooth.i420"), np.uint8
    )
    fsz = W * H * 3 // 2
    frames = []
    for i in range(min(32, len(raw) // fsz)):
        f = raw[i * fsz : (i + 1) * fsz]
        frames.append([
            f[: W * H].reshape(H, W),
            f[W * H : W * H + fsz // 6].reshape(H // 2, W // 2),
            f[W * H + fsz // 6 :].reshape(H // 2, W // 2),
        ])
    info = TheoraInfo(
        frame_width=W, frame_height=H, pic_width=W, pic_height=H,
        fps_numerator=30, fps_denominator=1, quality=0,
        keyframe_granule_shift=6,
    )
    enc = TpuGopEncoder(info, qi=40)
    pkts, blob = enc.encode_clip_twopass(
        frames, keyframe_freq=8, target_bitrate=target, buf_delay=16
    )
    summary, metrics = RateControl.twopass_parse(blob)
    assert len(metrics) == len(frames)
    assert summary["frames_total"][0] == 4  # keyframes at kf=8
    bits = 8 * sum(len(p.data) for p in pkts[3:])
    goal = target * len(frames) / 30.0
    assert abs(bits / goal - 1) <= 0.05, (target, bits / goal - 1)
    # The stream decodes in the reference decoder (and frames carry
    # varying qi -- the controller actually steered).
    qis = set()
    from theora_tpu.bitio import BitReader

    for p in pkts[3:]:
        br = BitReader(p.data)
        assert br.read1() == 0
        br.read1()
        qis.add(br.read(6))
    assert len(qis) > 1, "2-pass never changed qi"


def test_mesh_twopass_byte_identity():
    """Mesh 2-pass (per-frame qi vectors from the window pre-pass) is
    byte-identical across mesh shapes, and the deviation matches the
    sequential tier at the same rate_window."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from theora_tpu.parallel.gop import encode_clip_mesh, make_mesh

    frames = _moving_frames(64, 48, 0, 11, 7)
    info = TheoraInfo(
        frame_width=64, frame_height=48, pic_width=64, pic_height=48,
        quality=0, fps_numerator=30, fps_denominator=1,
    )
    target = 120_000
    enc = TpuGopEncoder(info, qi=40)
    _, blob = enc.encode_clip_pass1(
        frames, keyframe_freq=4, target_bitrate=target
    )
    kw = dict(keyframe_freq=4, qi=40, target_bitrate=target,
              rate_window=2, twopass_data=blob, buf_delay=16)
    ref = None
    for nd, fragax in ((1, 1), (8, 2), (4, 4)):
        mesh = make_mesh(nd, frag_axis=fragax)
        pk = encode_clip_mesh(frames, info, mesh, **kw)
        blob_out = b"".join(p.data for p in pk)
        if ref is None:
            ref = blob_out
        assert blob_out == ref, dict(mesh.shape)
    # Sequential pass-2 at the same window size produces the same
    # bytes (shared controller + shared pre-pass).
    seq = enc.encode_clip_pass2(
        frames, blob, keyframe_freq=4, target_bitrate=target,
        buf_delay=16, rate_window=2,
    )
    assert [p.data for p in seq] == [p.data for p in pk]
