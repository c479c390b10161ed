#!/usr/bin/env python
"""Full quality sweep: bytes + luma PSNR at equal qi for the reference
C encoder, the host tier, and the device tier, across content types.

Produces the BASELINE.md device-tier quality table: a claim that the
device tier RD-beats the host must hold across a q-sweep and a content
sweep, not at two operating points.

Usage: python tools/qualitysweep.py [--qis 16,24,32,40,48,56]
       [--content smooth,textured,noise] [--frames 16] [--json out.json]

Reference anchor: the encoder quality loop of
/root/reference/examples/encoder_example.c (fixed-qi VBR) driven via the
refbuild ref_enc oracle.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
sys.path.insert(0, REPO)

W, H = 352, 288
KF = 8


def gen_content(kind: str, n: int):
    """Deterministic clips per content class at the sweep's WxH.

    The first three classes are spatially HOMOGENEOUS; the round-5
    classes (halfmix/mover/grainpan) put heterogeneity INSIDE each
    frame -- the regime where the reference's per-MB activity masking
    (analyze.c:1152-1300) shifts bits spatially and a per-frame gate
    cannot."""
    yy, xx = np.mgrid[0:H, 0:W]
    rng = np.random.RandomState(7)
    frames = []
    if kind == "smooth":
        for t in range(n):
            y = (110 + 70 * np.sin((xx + 3 * t) / 31.0)
                 + 40 * np.cos((yy - 2 * t) / 23.0)).clip(0, 255)
            u = (128 + 40 * np.sin((xx[::2, ::2] + 2 * t) / 41.0))
            v = (128 - 40 * np.cos((yy[::2, ::2] + t) / 37.0))
            frames.append([y.astype(np.uint8), u.astype(np.uint8),
                           v.astype(np.uint8)])
    elif kind == "textured":
        ty = rng.randint(0, 160, (H + 64, W + 64)).astype(np.int32)
        tu = rng.randint(0, 80, (H // 2 + 32, W // 2 + 32)).astype(np.int32)
        for t in range(n):
            y = (ty[t:t + H, 2 * t:2 * t + W]
                 + 48 + 32 * np.sin((xx + 4 * t) / 57.0)).clip(0, 255)
            u = (tu[t // 2:t // 2 + H // 2, t:t + W // 2] + 88).clip(0, 255)
            v = (tu[t:t + H // 2, t // 2:t // 2 + W // 2] + 88).clip(0, 255)
            frames.append([y.astype(np.uint8), u.astype(np.uint8),
                           v.astype(np.uint8)])
    elif kind == "noise":
        for t in range(n):
            frames.append([
                rng.randint(0, 256, (H, W)).astype(np.uint8),
                rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8),
                rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8),
            ])
    elif kind == "halfmix":
        # Left half: smooth moving gradients.  Right half: dense static
        # texture under a slow pan.  Masking that modulates per-frame
        # must compromise between the two halves; per-MB masking can
        # spend coarser quantization on the textured half only.
        tex = rng.randint(0, 200, (H + 64, W + 64)).astype(np.int32)
        mask = xx >= W // 2
        for t in range(n):
            smooth = (110 + 70 * np.sin((xx + 3 * t) / 31.0)
                      + 40 * np.cos((yy - 2 * t) / 23.0))
            txt = tex[t:t + H, 2 * t:2 * t + W] + 28
            y = np.where(mask, txt, smooth).clip(0, 255)
            u = (128 + 40 * np.sin((xx[::2, ::2] + 2 * t) / 41.0))
            v = (128 - 40 * np.cos((yy[::2, ::2] + t) / 37.0))
            frames.append([y.astype(np.uint8), u.astype(np.uint8),
                           v.astype(np.uint8)])
    elif kind == "mover":
        # Small textured mover on a flat background: nearly all bits
        # belong in a few macroblocks per frame.
        patch = rng.randint(0, 255, (64, 64)).astype(np.int32)
        for t in range(n):
            y = np.full((H, W), 96, np.int32)
            y += (8 * np.sin(yy / 97.0)).astype(np.int32)
            px_ = (12 * t) % max(1, W - 64)
            py_ = (7 * t) % max(1, H - 64)
            y[py_:py_ + 64, px_:px_ + 64] = patch
            u = np.full((H // 2, W // 2), 120, np.uint8)
            v = np.full((H // 2, W // 2), 136, np.uint8)
            frames.append([y.clip(0, 255).astype(np.uint8), u, v])
    elif kind == "grainpan":
        # Film-grain analogue: a STATIC grain field riding a smooth
        # base, under a global pan -- temporally correlated noise
        # (unlike the iid "noise" class), so motion compensation can
        # win if the encoder finds the pan.
        grain = rng.randint(-28, 29, (H + 128, W + 128)).astype(np.int32)
        cgrain = rng.randint(-14, 15,
                             (H // 2 + 64, W // 2 + 64)).astype(np.int32)
        for t in range(n):
            base = (120 + 50 * np.sin((xx + 2 * t) / 53.0)
                    + 30 * np.cos(yy / 43.0))
            y = (base + grain[3 * t:3 * t + H, 5 * t:5 * t + W]).clip(0, 255)
            u = (128 + cgrain[t:t + H // 2, 2 * t:2 * t + W // 2]).clip(
                0, 255)
            v = (128 - cgrain[2 * t:2 * t + H // 2, t:t + W // 2]).clip(
                0, 255)
            frames.append([y.astype(np.uint8), u.astype(np.uint8),
                           v.astype(np.uint8)])
    else:
        raise ValueError(kind)
    return frames


def luma_psnr(frames, recons):
    from theora_tpu.metrics import clip_luma_psnr

    return clip_luma_psnr(frames, recons)


def luma_ssim(frames, recons):
    from theora_tpu.metrics import clip_luma_ssim

    return clip_luma_ssim(frames, recons)


def decode_packets(pkts):
    from theora_tpu.decode.decoder import Decoder
    from theora_tpu.headers import parse_info_header, parse_setup_header

    dec = Decoder(parse_info_header(pkts[0].data),
                  parse_setup_header(pkts[2].data))
    outs = []
    for p in pkts[3:]:
        dec.decode_packet(p.data)
        outs.append(dec.ycbcr_out())
    return outs


def run_reference(frames, qi):
    from theora_tpu.tpkt import read_tpkt

    enc = os.path.join(REPO, "refbuild", "build", "ref_enc")
    if not os.path.exists(enc):
        subprocess.run(["make", "-C", os.path.join(REPO, "refbuild")],
                       check=True, capture_output=True)
    with tempfile.TemporaryDirectory() as td:
        raw = os.path.join(td, "in.i420")
        with open(raw, "wb") as f:
            for y, u, v in frames:
                f.write(y.tobytes()); f.write(u.tobytes()); f.write(v.tobytes())
        out = os.path.join(td, "out.tpkt")
        subprocess.run(
            [enc, str(W), str(H), str(len(frames)), str(qi), str(KF),
             raw, out],
            check=True, capture_output=True,
        )
        pkts = read_tpkt(out)
    size = sum(len(p.data) for p in pkts[3:])
    rec = decode_packets(pkts)
    return size, luma_psnr(frames, rec), luma_ssim(frames, rec)


def mk_info(qi):
    from theora_tpu.info import TheoraInfo

    return TheoraInfo(
        frame_width=W, frame_height=H, pic_width=W, pic_height=H,
        quality=qi, fps_numerator=30, fps_denominator=1,
        keyframe_granule_shift=6,
    )


def run_host(frames, qi):
    from theora_tpu.encode.encoder import Encoder

    enc = Encoder(mk_info(qi))
    enc.keyframe_freq = KF
    hdrs = enc.flush_headers()
    pkts = list(hdrs) + [enc.encode_frame(fr) for fr in frames]
    size = sum(len(p.data) for p in pkts[3:])
    rec = decode_packets(pkts)
    return size, luma_psnr(frames, rec), luma_ssim(frames, rec)


_DEV_CACHE = {}


def run_device(frames, qi, adaptive="auto"):
    from theora_tpu.encode.tpu_gop import TpuGopEncoder

    # One encoder per (adaptive,) reused across qis: the compiled scans
    # are qi-independent (tables arrive as arrays), so the sweep pays
    # compile once.
    enc = _DEV_CACHE.get(adaptive)
    if enc is None:
        enc = TpuGopEncoder(mk_info(qi), qi=qi)
        enc.adaptive_quant = adaptive
        _DEV_CACHE[adaptive] = enc
    enc.set_qi(qi)
    pkts = enc.encode_clip(frames, keyframe_freq=KF)
    size = sum(len(p.data) for p in pkts[3:])
    rec = decode_packets(pkts)
    return size, luma_psnr(frames, rec), luma_ssim(frames, rec)


def main():
    global W, H
    ap = argparse.ArgumentParser()
    ap.add_argument("--qis", default="16,24,32,40,48,56")
    ap.add_argument("--content", default="smooth,textured,noise")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--adaptive", action="store_true",
                    help="also sweep the device tier with adaptive quant")
    ap.add_argument("--size", default="352x288",
                    help="WxH; must be multiples of 16 (e.g. 1280x720, "
                         "1920x1088)")
    ap.add_argument("--skip", default="",
                    help="comma list of columns to skip (ref,host,device)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    W, H = (int(v) for v in args.size.split("x"))
    if W % 16 or H % 16:
        ap.error("--size dims must be multiples of 16")
    skip = set(args.skip.split(",")) if args.skip else set()
    qis = [int(q) for q in args.qis.split(",")]
    rows = []
    for kind in args.content.split(","):
        frames = gen_content(kind, args.frames)
        for qi in qis:
            r = {"content": kind, "qi": qi, "size": f"{W}x{H}"}
            if "ref" not in skip:
                (r["ref_bytes"], r["ref_psnr"],
                 r["ref_ssim"]) = run_reference(frames, qi)
            if "host" not in skip:
                r["host_bytes"], r["host_psnr"], r["host_ssim"] = run_host(
                    frames, qi
                )
            if "device" not in skip:
                (r["dev_bytes"], r["dev_psnr"],
                 r["dev_ssim"]) = run_device(frames, qi)
            if args.adaptive:
                (r["deva_bytes"], r["deva_psnr"],
                 r["deva_ssim"]) = run_device(frames, qi, adaptive=True)
            rows.append(r)
            print(json.dumps(r), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    if skip:
        return
    # Markdown table for BASELINE.md.
    print("\n| content | q | ref (B @ dB / SSIM) | host (B @ dB / SSIM) "
          "| device (B @ dB / SSIM) | dev vs ref | dev vs host |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['content']} | {r['qi']} "
            f"| {r['ref_bytes']:,} @ {r['ref_psnr']:.2f} / "
            f"{r['ref_ssim']:.4f} "
            f"| {r['host_bytes']:,} @ {r['host_psnr']:.2f} / "
            f"{r['host_ssim']:.4f} "
            f"| {r['dev_bytes']:,} @ {r['dev_psnr']:.2f} / "
            f"{r['dev_ssim']:.4f} "
            f"| {100 * (r['dev_bytes'] / r['ref_bytes'] - 1):+.1f}% "
            f"({r['dev_psnr'] - r['ref_psnr']:+.2f} dB, "
            f"{r['dev_ssim'] - r['ref_ssim']:+.4f} S) "
            f"| {100 * (r['dev_bytes'] / r['host_bytes'] - 1):+.1f}% "
            f"({r['dev_psnr'] - r['host_psnr']:+.2f} dB, "
            f"{r['dev_ssim'] - r['host_ssim']:+.4f} S) |"
        )
if __name__ == "__main__":
    main()
