#!/usr/bin/env python
"""Benchmark: the device GOP encoder on one GPU at 720p, against the
reference C encoder on the same machine's CPU, printing one JSON line.

Device numbers come only from a GPU: with none, the run fails. Every
device timing ends in block_until_ready, and all device benches run in
this one process. The JSON line names the device (platform, device
kind, count) and the card's power limit.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

W, H, NFRAMES = 1280, 720, 32
QUALITY = 48
KF_FREQ = 8  # same GOP structure for the reference and the device tier


def gen_frames():
    """Synthetic 720p natural-video stand-in for the BASELINE.json
    headline ("encode+decode Mpixels/s/chip on 720p derf clips"): a
    detailed STATIC scene (texture + gradients), three textured movers,
    a film-grain panel refreshed every frame, and mostly-static chroma
    with colored movers -- the temporal structure real derf-style
    content has (mostly-static background + local motion + some grain).
    Both encoders run the SAME frames, so vs_baseline is an
    apples-to-apples ratio."""
    rng = np.random.RandomState(11)
    yy, xx = np.mgrid[0:H, 0:W]
    tex = rng.randint(-40, 41, size=(H, W)).astype(np.int32)
    bg = (
        128
        + 50 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
        + 30 * np.sin((xx + 2 * yy) / 61.0)
        + tex * 0.5
    ).clip(0, 255).astype(np.uint8)
    movers = [
        (rng.randint(0, 256, size=(96, 128)).astype(np.uint8), 9, 2, 60, 40),
        (rng.randint(0, 256, size=(64, 64)).astype(np.uint8), -5, 4, 400, 900),
        ((128 + 90 * np.sin(np.arange(80)[:, None] / 3.0)).astype(np.uint8)
         * np.ones((1, 112), np.uint8), 3, -3, 520, 300),
    ]
    ug = (128 + 40 * np.sin(xx[::2, ::2] / 37.0)).astype(np.uint8)
    vg = (128 + 40 * np.cos(yy[::2, ::2] / 29.0)).astype(np.uint8)
    frames = []
    for t in range(NFRAMES):
        y = bg.copy()
        u = ug.copy()
        v = vg.copy()
        for mi, (patch, dx, dy, x0, y0) in enumerate(movers):
            ph, pw = patch.shape
            py = (y0 + dy * t) % (H - ph)
            px = (x0 + dx * t) % (W - pw)
            y[py : py + ph, px : px + pw] = patch
            u[py // 2 : (py + ph) // 2, px // 2 : (px + pw) // 2] = (
                80 + 50 * mi
            )
            v[py // 2 : (py + ph) // 2, px // 2 : (px + pw) // 2] = (
                190 - 40 * mi
            )
        # Film-grain panel: fresh iid noise every frame (keeps the
        # worst-case token/filter load present and exercises the
        # delta-upload dense handling).
        y[H - 256 :, W - 256 :] = rng.randint(
            0, 256, size=(256, 256)
        ).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def bench_reference(frames):
    """Reference encoder Mpix/s (keyframe-only, fixed quality)."""
    refbuild = os.path.join(os.path.dirname(os.path.abspath(__file__)), "refbuild")
    enc = os.path.join(refbuild, "build", "ref_enc")
    if not os.path.exists(enc):
        subprocess.run(["make", "-C", refbuild], check=True, capture_output=True)
    with tempfile.TemporaryDirectory() as td:
        raw = os.path.join(td, "in.i420")
        with open(raw, "wb") as f:
            for y, u, v in frames:
                f.write(y.tobytes())
                f.write(u.tobytes())
                f.write(v.tobytes())
        out = os.path.join(td, "out.tpkt")
        # Best of 3: host load noise otherwise dominates the baseline.
        dt = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            subprocess.run(
                [enc, str(W), str(H), str(NFRAMES), str(QUALITY),
                 str(KF_FREQ), raw, out],
                check=True,
                capture_output=True,
            )
            dt = min(dt, time.perf_counter() - t0)
    mpix = NFRAMES * (W * H + 2 * (W // 2) * (H // 2)) / 1e6
    return mpix / dt


MPIX = NFRAMES * (W * H + 2 * (W // 2) * (H // 2)) / 1e6


def _info():
    from theora_tpu.info import TheoraInfo

    return TheoraInfo(
        frame_width=W, frame_height=H, pic_width=W, pic_height=H,
        pic_x=0, pic_y=0, fps_numerator=30, fps_denominator=1,
        quality=QUALITY, keyframe_granule_shift=6,
    )


def _best_of(fn, reps):
    """Least wall time of reps calls of fn, each ending in
    block_until_ready (the first call, which compiles, is not timed)."""
    import jax

    jax.block_until_ready(fn())
    dt = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        dt = min(dt, time.perf_counter() - t0)
    return dt


def bench_compute_core(frames):
    """The jitted keyframe transform core (fDCT + quantize + bit-exact
    dequant/iDCT reconstruction) over all fragments of the clip."""
    import jax.numpy as jnp

    from theora_tpu import tables
    from theora_tpu.pipeline import intra_encode_core
    from theora_tpu.quant import dequant_tables_init

    dequant = dequant_tables_init(tables.DEF_QUANT_INFO)

    def to_blocks(plane):
        h, w = plane.shape
        return (
            plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
            .reshape(-1, 8, 8)
        )

    yb = jnp.asarray(np.stack([to_blocks(f[0]) for f in frames]))
    cb = jnp.asarray(np.stack(
        [to_blocks(f[1]) for f in frames] + [to_blocks(f[2]) for f in frames]
    ))
    dq_y = jnp.asarray(dequant[QUALITY, 0, 0].astype(np.int32))
    dq_c = jnp.asarray(dequant[QUALITY, 1, 0].astype(np.int32))
    dt = _best_of(
        lambda: (intra_encode_core(yb, dq_y), intra_encode_core(cb, dq_c)),
        16,
    )
    return MPIX / dt


def bench_device_e2e(frames):
    """End-to-end device GOP encode: ME, R/D quantization, skip and the
    closed-loop reconstruction on the device (encode/tpu_gop.py), mode
    decision, entropy coding and packing on the host, transfers
    included.  encode_clip returns host packets, so its wall time needs
    no fence."""
    from theora_tpu.encode.tpu_gop import TpuGopEncoder

    enc = TpuGopEncoder(_info(), qi=QUALITY)
    fr = [[f[0], f[1], f[2]] for f in frames]
    enc.encode_clip(fr, keyframe_freq=KF_FREQ)  # compile
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        enc.encode_clip(fr, keyframe_freq=KF_FREQ)
        dt = min(dt, time.perf_counter() - t0)
    return MPIX / dt


def bench_device_pipeline_compute(frames):
    """Device-resident pipeline compute for one 8-frame GOP: the fused
    ME plan and the three closed-loop plane scans (with the batched
    trellis), every input already on the device."""
    from theora_tpu.encode.tpu_gop import TpuGopEncoder, _scan_encode_plane
    from theora_tpu.ops import me_jax
    from theora_tpu.tools.roofline import _plane_args

    enc = TpuGopEncoder(_info(), qi=QUALITY)
    F = KF_FREQ
    plane_args = [_plane_args(enc, frames, F, pli)[0] for pli in range(3)]
    ys_d = plane_args[0][0]

    def one_pass():
        return (
            me_jax.plan_from_gop(ys_d),
            [_scan_encode_plane(*a, use_trellis=enc.use_trellis)
             for a in plane_args],
        )

    dt = _best_of(one_pass, 6)
    return F * (W * H + 2 * (W // 2) * (H // 2)) / 1e6 / dt


def bench_host_parallel(frames):
    """Host-tier GOP-parallel encode (2 workers, byte-identical to
    sequential) on the host CPU -- the reference encoder is
    single-threaded by design."""
    from theora_tpu.parallel.transcode import transcode

    info = _info()
    fr = [[f[0], f[1], f[2]] for f in frames]
    transcode(fr, info, keyframe_freq=KF_FREQ, max_workers=2)
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        transcode(fr, info, keyframe_freq=KF_FREQ, max_workers=2)
        dt = min(dt, time.perf_counter() - t0)
    return MPIX / dt


def main():
    from theora_tpu import runtime

    runtime.setup_compile_cache()
    devices = runtime.require_gpu()
    card = runtime.cards()[0]
    frames = gen_frames()
    ref_mpixs = bench_reference(frames)
    value = bench_device_e2e(frames)
    pipeline = bench_device_pipeline_compute(frames)
    core = bench_compute_core(frames)
    host_parallel = bench_host_parallel(frames)
    print(json.dumps({
        "metric": "720p end-to-end device GOP encode Mpix/s (ME, R/D "
                  "quantization and closed loop on the device; host mode "
                  "decision and entropy coding; transfers included)",
        "value": value,
        "unit": "Mpix/s",
        "vs_baseline": value / ref_mpixs,
        "ref_encode_mpixs": ref_mpixs,
        "pipeline_compute_mpixs": pipeline,
        "compute_core_mpixs": core,
        "host_gop_parallel_mpixs": host_parallel,
        "host_parallel_vs_ref": host_parallel / ref_mpixs,
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": card,
    }))


if __name__ == "__main__":
    main()
