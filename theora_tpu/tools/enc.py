"""Encode a .y4m clip to Ogg Theora (.ogv).

Usage: python -m theora_tpu.tools.enc [-q QUALITY] [-k KF_FREQ] in.y4m out.ogv
The encoder_example analogue (examples/encoder_example.c in the reference),
including Vorbis A/V muxing via --audio.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-q", "--quality", type=int, default=48)
    ap.add_argument("-k", "--keyframe-freq", type=int, default=64)
    ap.add_argument("-b", "--bitrate", type=int, default=0,
                    help="target bitrate (bps); enables CBR")
    ap.add_argument("--adaptive-quant", choices=["auto", "on", "off"],
                    nargs="?", const="on", default="auto",
                    help="activity masking: auto (high-qi region only, "
                         "default), on (every qi, the reference's "
                         "default), off; bare --adaptive-quant means "
                         "'on' (backward compatible with the old flag)")
    ap.add_argument("--rd-strength", type=float, default=None)
    ap.add_argument("--two-pass", action="store_true",
                    help="two-pass CBR (requires --bitrate)")
    ap.add_argument("--two-pass-file", default=None,
                    help="write/keep the OT2P pass-1 metrics file here")
    ap.add_argument("--rate-buffer", type=int, default=0,
                    help="rate buffer size in frames (finite 2-pass "
                         "window; default = whole file)")
    ap.add_argument("--drop-frames", type=int, default=1,
                    help="allow frame dropping under rate pressure (0/1)")
    ap.add_argument("-j", "--workers", type=int, default=0,
                    help="GOP-parallel encode with N worker processes "
                         "(VBR only; byte-identical to sequential)")
    ap.add_argument("-z", "--speed", type=int, default=0,
                    help="speed level 0-4 (encoder_example -z): 0 full "
                         "effort, 1 early skip, 2 fast analysis, 3 plain "
                         "quantizer, 4 no motion compensation")
    ap.add_argument("--device", action="store_true",
                    help="encode on the GPU device tier (TpuGopEncoder: "
                         "ME, mode decision, batched trellis and the "
                         "closed loop on device, host entropy coding; "
                         "CBR via the fixed-window controller)")
    ap.add_argument("-a", "--audio", default=None,
                    help="16-bit PCM WAV to encode as a Vorbis stream and "
                         "mux A/V with reference page ordering "
                         "(encoder_example.c:1790-1860)")
    ap.add_argument("--audio-quality", type=float, default=0.2,
                    help="Vorbis VBR quality -0.1..1.0 (default 0.2)")
    args = ap.parse_args(argv)

    from theora_tpu.encode.encoder import Encoder
    from theora_tpu.info import TheoraInfo
    from theora_tpu.ogg import mux_stream
    from theora_tpu.tools.y4m import read_y4m

    import numpy as np

    W, H, fps, frames, pixel_fmt = read_y4m(args.input, want_fmt=True)
    fw, fh = (W + 15) & ~15, (H + 15) & ~15
    if fw != W or fh != H:
        # Pad to multiples of 16 by edge replication, with a crop
        # rectangle covering the real picture (encode.c:1562-1638).
        hd = 0 if pixel_fmt == 3 else 1
        vd = 0 if pixel_fmt >= 2 else 1
        padded = []
        for y, u, v in frames:
            py = np.pad(y, ((0, fh - H), (0, fw - W)), mode="edge")
            pu = np.pad(
                u,
                ((0, (fh >> vd) - u.shape[0]), (0, (fw >> hd) - u.shape[1])),
                mode="edge",
            )
            pv = np.pad(
                v,
                ((0, (fh >> vd) - v.shape[0]), (0, (fw >> hd) - v.shape[1])),
                mode="edge",
            )
            padded.append([py, pu, pv])
        frames = padded
    info = TheoraInfo(
        frame_width=fw,
        frame_height=fh,
        pic_width=W,
        pic_height=H,
        pic_x=0,
        pic_y=0,
        fps_numerator=fps[0],
        fps_denominator=fps[1],
        quality=args.quality,
        target_bitrate=args.bitrate,
        pixel_fmt=pixel_fmt,
    )
    def make_encoder():
        e = Encoder(info)
        e.keyframe_freq = args.keyframe_freq
        e.adaptive_quant = {
            "auto": "auto", "on": True, "off": False
        }[args.adaptive_quant]
        if args.rd_strength is not None:
            e.rd_strength = args.rd_strength
        if args.speed:
            e.set_splevel(args.speed)
        return e

    def write_output(pkts):
        if not args.audio:
            with open(args.output, "wb") as f:
                f.write(mux_stream(pkts))
            return
        from theora_tpu.ogg import mux_av
        from theora_tpu.tools.vorbis import VorbisEncoder, read_wav

        pcm, rate = read_wav(args.audio)
        venc = VorbisEncoder(pcm.shape[1], rate, args.audio_quality)
        apkts = venc.headers()
        for off in range(0, len(pcm), 65536):
            apkts += venc.encode(pcm[off : off + 65536])
        apkts += venc.finish()
        shift = info.keyframe_granule_shift
        num, den = info.fps_numerator, info.fps_denominator

        def vtime(gp):
            nfr = (gp >> shift) + (gp & ((1 << shift) - 1))
            return (nfr + 1) * den / num

        with open(args.output, "wb") as f:
            f.write(mux_av(pkts, apkts, vtime, lambda gp: gp / rate))
        print(
            f"muxed Vorbis audio: {len(apkts) - 3} packets, "
            f"{pcm.shape[0] / rate:.2f}s @ {rate} Hz",
            file=sys.stderr,
        )

    t0 = time.perf_counter()
    if args.device:
        if args.two_pass and not args.bitrate:
            ap.error("--two-pass requires --bitrate")
        from theora_tpu import runtime
        from theora_tpu.encode.tpu_gop import TpuGopEncoder

        runtime.setup_compile_cache()
        runtime.require_gpu()
        denc = TpuGopEncoder(info, qi=args.quality)
        denc.adaptive_quant = {
            "auto": "auto", "on": True, "off": False
        }[args.adaptive_quant]
        if args.speed:
            denc.set_splevel(args.speed)
        if args.two_pass:
            # Device-tier 2-pass: OT2P pass 1 + pass-2 window
            # allocation with per-frame qi vectors (encode_clip_pass2).
            pkts, blob = denc.encode_clip_twopass(
                frames, keyframe_freq=args.keyframe_freq,
                target_bitrate=args.bitrate,
                buf_delay=args.rate_buffer or None,
            )
            if args.two_pass_file:
                with open(args.two_pass_file, "wb") as f:
                    f.write(blob)
        else:
            pkts = denc.encode_clip(
                frames, keyframe_freq=args.keyframe_freq,
                target_bitrate=args.bitrate,
            )
        dt = time.perf_counter() - t0
        write_output(pkts)
        total = sum(len(p.data) for p in pkts[3:])
        mpix = len(frames) * (W * H * 1.5) / 1e6
        print(
            f"{len(frames)} frames, {total} bytes, {dt:.2f}s"
            f" ({mpix/dt:.2f} Mpix/s, device tier)",
            file=sys.stderr,
        )
        return
    pass1_blob = None
    if args.two_pass:
        if not args.bitrate:
            ap.error("--two-pass requires --bitrate")
        # Pass 1: fixed-qi measurement pass writing the reference's
        # OT2P metrics format (rate.c:878-936; driver protocol per
        # encoder_example.c:1190-1226).
        from theora_tpu.encode.rate import RateControl

        enc1 = make_encoder()
        enc1.rc = RateControl(info, enc1.dequant, args.keyframe_freq)
        body = b""
        enc1.rc.start_pass1()  # placeholder header; real one at the end
        for fr in frames:
            enc1.encode_frame(fr)
            body += enc1.rc.pass1_frame_data()
        pass1_blob = enc1.rc.pass1_summary() + body
        if args.two_pass_file:
            with open(args.two_pass_file, "wb") as f:
                f.write(pass1_blob)
        print(
            f"pass 1: {len(enc1.rc.frame_metrics)} frame metrics "
            f"({len(pass1_blob)} bytes OT2P)",
            file=sys.stderr,
        )
    if args.workers and not args.bitrate and not args.two_pass:
        from theora_tpu.parallel.transcode import transcode

        pkts = transcode(
            frames, info, keyframe_freq=args.keyframe_freq,
            max_workers=args.workers, rd_strength=args.rd_strength,
            use_processes=True,
        )
        dt = time.perf_counter() - t0
        write_output(pkts)
        total = sum(len(p.data) for p in pkts[3:])
        mpix = len(frames) * (W * H * 1.5) / 1e6
        print(
            f"{len(frames)} frames, {total} bytes, {dt:.2f}s"
            f" ({mpix/dt:.2f} Mpix/s, {args.workers} workers)",
            file=sys.stderr,
        )
        return
    enc = make_encoder()
    if pass1_blob is not None:
        from theora_tpu.encode.rate import RateControl

        enc.rc = RateControl(info, enc.dequant, args.keyframe_freq)
        enc.rc.start_pass2(
            pass1_blob, buf_delay=args.rate_buffer or None
        )
    if args.bitrate and not args.drop_frames:
        from theora_tpu.encode.rate import RateControl

        if enc.rc is None:
            enc.rc = RateControl(info, enc.dequant, args.keyframe_freq)
        enc.rc.drop_frames = False
    pkts = enc.flush_headers()
    for i, fr in enumerate(frames):
        pkts.append(enc.encode_frame(fr, e_o_s=(i == len(frames) - 1)))
    dt = time.perf_counter() - t0
    write_output(pkts)
    total = sum(len(p.data) for p in pkts[3:])
    mpix = len(frames) * (W * H * 1.5) / 1e6
    print(
        f"{len(frames)} frames, {total} bytes, {dt:.2f}s"
        f" ({mpix/dt:.2f} Mpix/s)",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
