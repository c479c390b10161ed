"""Record a JAX profiler trace of the device codec pipeline.

The device-tier analogue of the reference's telemetry instrumentation
(SURVEY.md section 5 tracing plan): the device stages carry
jax.named_scope labels (mc / fdct / quantize_rd / idct_recon / skip_rd /
loopfilter / borders, plus the ME stages), so the written trace groups
device time by codec stage.  View with TensorBoard's profile plugin or
Perfetto (ui.perfetto.dev).

Usage: python -m theora_tpu.tools.profile [--mode encode|decode]
           [--out DIR] [--frames N] [--size WxH]

The command needs a GPU; `record` is the same trace on whatever device
JAX runs on.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _synth_frames(w, h, n):
    rng = np.random.RandomState(7)
    base = rng.randint(0, 256, size=(h + 64, w + 64)).astype(np.uint8)
    out = []
    for t in range(n):
        y = base[t * 2 : t * 2 + h, t : t + w]
        u = np.full((h // 2, w // 2), 90 + 3 * t, np.uint8)
        v = np.full((h // 2, w // 2), 160 - 2 * t, np.uint8)
        out.append([y, u, v])
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=("encode", "decode"),
                    default="encode")
    ap.add_argument("--out", default="trace")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", default="640x352")
    return ap.parse_args(argv)


def main(argv=None):
    from theora_tpu import runtime

    args = parse_args(argv)
    runtime.setup_compile_cache()
    runtime.require_gpu()
    return record(args)


def record(args):
    """Warm up, then trace one encode or decode of synthetic frames into
    args.out."""
    from theora_tpu.debug import trace
    from theora_tpu.encode.tpu_gop import TpuGopEncoder
    from theora_tpu.info import TheoraInfo

    w, h = (int(x) for x in args.size.split("x"))
    frames = _synth_frames(w, h, args.frames)
    info = TheoraInfo(frame_width=w, frame_height=h,
                      pic_width=w, pic_height=h, quality=48)
    enc = TpuGopEncoder(info, qi=48)
    # Warm up outside the trace so compilation doesn't drown the steps.
    enc.encode_gop(frames)
    if args.mode == "encode":
        with trace(args.out):
            enc.encode_gop(frames)
    else:
        from theora_tpu.decode.tpu_batch import TpuBatchDecoder
        from theora_tpu.headers import (
            parse_info_header,
            parse_setup_header,
        )

        pkts = [enc.flush_headers()]
        pkts = enc.encode_clip(frames, keyframe_freq=args.frames)
        dinfo = parse_info_header(pkts[0].data)
        setup = parse_setup_header(pkts[2].data)
        dec = TpuBatchDecoder(dinfo, setup)
        dec.decode_batch([p.data for p in pkts[3:]])  # warm
        dec2 = TpuBatchDecoder(dinfo, setup)
        with trace(args.out):
            dec2.decode_batch([p.data for p in pkts[3:]])
    print(f"trace written to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
