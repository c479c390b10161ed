#!/usr/bin/env python
"""Smoke test of the device encode and decode paths on NVIDIA GPUs.

    python chip_smoke.py                # one card: phases a-e
    python chip_smoke.py --four-cards   # four cards: the mesh phase only

Phases (one process; each prints its result and wall time):
  a. the device is a GPU and the native entropy library loads;
  b. TpuBatchDecoder.decode_clip reproduces every golden
     testdata/*.tpkt with a *.ref.yuv, byte for byte;
  c. TpuGopEncoder.encode_clip of bench.py's 720p clip: the closed-loop
     reconstruction equals the host Decoder's output on the packets, and
     TpuBatchDecoder gives the same frames; prints bytes, PSNR, SSIM and
     Mpix/s after warm-up;
  d. transcode_device of phase c's stream equals encode_clip of the
     host-decoded frames, packet for packet;
  e. a 16-frame CIF encode on the GPU equals the same encode in a child
     process that runs JAX on the CPU;
  f. (--four-cards only) encode_clip_mesh and MeshGopEncoder on a 4-card
     mesh equal the same encodes on a 1-card mesh.

The card's name and power limit are printed before the first phase. The
last line is one JSON object, printed only when every phase passed; any
failure exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (the 720p clip and its settings)
from theora_tpu import runtime  # noqa: E402

TESTDATA = os.path.join(ROOT, "testdata")
CIF_W, CIF_H, CIF_FRAMES, CIF_Q, CIF_KF = 352, 288, 16, 40, 8
FRAME_SUBSAMPLING = 1.5  # 4:2:0 samples per luma pixel


def _headers(pkts):
    from theora_tpu.headers import (
        parse_comment_header, parse_info_header, parse_setup_header,
    )

    info = parse_info_header(pkts[0].data)
    parse_comment_header(pkts[1].data)
    return info, parse_setup_header(pkts[2].data)


def _info(w, h, q):
    from theora_tpu.info import TheoraInfo

    return TheoraInfo(
        frame_width=w, frame_height=h, pic_width=w, pic_height=h,
        pic_x=0, pic_y=0, fps_numerator=30, fps_denominator=1,
        quality=q, keyframe_granule_shift=6,
    )


def host_decode(info, setup, datas):
    """Host-tier decode: (decoder after each packet's planes, frames)."""
    from theora_tpu.decode.decoder import Decoder

    dec = Decoder(info, setup)
    planes, frames = [], []
    for d in datas:
        dec.decode_packet(d)
        planes.append([p.copy() for p in dec._out_frame.planes])
        frames.append(dec.ycbcr_out())
    return planes, frames


# ---------------------------------------------------------------------
def phase_device():
    from theora_tpu.native import get_lib

    devices = runtime.require_gpu()
    if get_lib() is None:
        raise RuntimeError("native entropy library did not load")
    return f"{len(devices)} x {devices[0].device_kind}, native lib loaded"


def golden_streams():
    """Names of the testdata streams that have a reference decode."""
    names = (f[:-len(".tpkt")] for f in os.listdir(TESTDATA)
             if f.endswith(".tpkt"))
    return sorted(n for n in names
                  if os.path.exists(os.path.join(TESTDATA, n + ".ref.yuv")))


def phase_decode_goldens():
    from theora_tpu.decode.tpu_batch import TpuBatchDecoder
    from theora_tpu.tpkt import read_tpkt

    names = golden_streams()
    for name in names:
        pkts = read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
        info, setup = _headers(pkts)
        outs = TpuBatchDecoder(info, setup).decode_clip(
            [p.data for p in pkts[3:]]
        )
        got = b"".join(p.tobytes() for fr in outs for p in fr)
        with open(os.path.join(TESTDATA, f"{name}.ref.yuv"), "rb") as f:
            want = f.read()
        if got != want:
            raise AssertionError(f"{name}: decode differs from ref.yuv")
        if chained_decode(info, setup, [p.data for p in pkts[3:]]) != want:
            raise AssertionError(f"{name}: chained decode differs")
    return (f"{len(names)} streams byte-exact, in one clip and in chained "
            f"batches: {', '.join(names)}")


def chained_decode(info, setup, datas):
    """Uneven decode_batch chunks (the reference planes are donated from
    one batch into the next), then sync_refs_to_host and the scalar
    decode_packet for the second half of the stream."""
    from theora_tpu.decode.tpu_batch import TpuBatchDecoder

    dec = TpuBatchDecoder(info, setup)
    half = len(datas) // 2
    outs = []
    for lo, hi in ((0, min(3, half)), (min(3, half), half)):
        outs += dec.decode_batch(datas[lo:hi])
    dec.sync_refs_to_host()
    for d in datas[half:]:
        dec.decode_packet(d)
        outs.append(dec.ycbcr_out())
    return b"".join(p.tobytes() for fr in outs for p in fr)


def phase_encode_720p(card, state):
    from theora_tpu.decode.tpu_batch import TpuBatchDecoder
    from theora_tpu.encode.tpu_gop import TpuGopEncoder, gop_starts
    from theora_tpu.metrics import clip_luma_psnr, clip_luma_ssim

    frames = [list(f) for f in bench.gen_frames()]
    info = _info(bench.W, bench.H, bench.QUALITY)
    enc = TpuGopEncoder(info, qi=bench.QUALITY)
    t0 = time.perf_counter()
    pkts = enc.encode_clip(frames, keyframe_freq=bench.KF_FREQ)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = enc.encode_clip(frames, keyframe_freq=bench.KF_FREQ)
    warm_s = time.perf_counter() - t0
    datas = [p.data for p in pkts[3:]]
    if [p.data for p in again[3:]] != datas:
        raise AssertionError("two encodes of one clip differ")

    # Closed loop: the scans' carried reconstruction, GOP by GOP, equals
    # what the host decoder makes of the packets.
    dinfo, setup = _headers(pkts)
    planes, decoded = host_decode(dinfo, setup, datas)
    g = enc.g
    bases = gop_starts(frames, bench.KF_FREQ, False) + [len(frames)]
    for b0, b1 in zip(bases[:-1], bases[1:]):
        gop_datas, recon = enc.encode_gop(frames[b0:b1], want_recon=True)
        if gop_datas != datas[b0:b1]:
            raise AssertionError(f"encode_gop({b0}) != encode_clip")
        for f in range(b1 - b0):
            for pli in range(3):
                vpad, hpad = g.plane_padding(pli)
                hh, ww = g.plane_shape(pli)
                win = np.s_[vpad:vpad + hh, hpad:hpad + ww]
                if not np.array_equal(recon[pli][f][win],
                                      planes[b0 + f][pli][win]):
                    raise AssertionError(
                        f"closed loop differs: frame {b0 + f} plane {pli}"
                    )
    dev = TpuBatchDecoder(dinfo, setup).decode_clip(datas)
    for i, (a, b) in enumerate(zip(dev, decoded)):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"TpuBatchDecoder differs at frame {i}")
    if len(dev) != len(decoded):
        raise AssertionError("TpuBatchDecoder frame count")

    state.update(pkts=pkts, decoded=decoded)
    nbytes = sum(len(d) for d in datas)
    mpix = len(frames) * bench.W * bench.H * FRAME_SUBSAMPLING / 1e6
    return (
        f"{len(frames)} frames {bench.W}x{bench.H} q{bench.QUALITY} "
        f"kf{bench.KF_FREQ}: {nbytes} bytes, "
        f"luma PSNR {clip_luma_psnr(frames, decoded):.4f} dB, "
        f"luma SSIM {clip_luma_ssim(frames, decoded):.6f}; "
        f"closed loop == host Decoder == TpuBatchDecoder; "
        f"encode_clip {mpix / warm_s:.3f} Mpix/s after warm-up "
        f"({warm_s:.3f} s; first call {first_s:.3f} s) on {card}"
    )


def phase_transcode(state):
    from theora_tpu.encode.tpu_gop import TpuGopEncoder, transcode_device

    if "pkts" not in state:
        raise RuntimeError("needs phase c's stream")
    pkts = state["pkts"]
    info, setup = _headers(pkts)
    datas = [p.data for p in pkts[3:]]
    want = TpuGopEncoder(info, qi=bench.QUALITY).encode_clip(
        [list(f) for f in state["decoded"]], keyframe_freq=bench.KF_FREQ
    )
    got = transcode_device(info, setup, datas,
                           keyframe_freq=bench.KF_FREQ, qi=bench.QUALITY)
    if [(p.data, p.granulepos) for p in got] != [
        (p.data, p.granulepos) for p in want
    ]:
        raise AssertionError("transcode_device differs from encode_clip")
    return (f"{len(datas)} frames: transcode_device == encode_clip "
            f"({sum(len(p.data) for p in got[3:])} bytes)")


def cif_packets():
    """The phase-e encode: 16 frames of testdata/cif_smooth.i420."""
    from theora_tpu.encode.tpu_gop import TpuGopEncoder

    raw = np.fromfile(os.path.join(TESTDATA, "cif_smooth.i420"), np.uint8)
    w, h = CIF_W, CIF_H
    fsz = w * h * 3 // 2
    frames = []
    for i in range(CIF_FRAMES):
        fr = raw[i * fsz:(i + 1) * fsz]
        frames.append([
            fr[:w * h].reshape(h, w),
            fr[w * h:w * h + w * h // 4].reshape(h // 2, w // 2),
            fr[w * h + w * h // 4:].reshape(h // 2, w // 2),
        ])
    enc = TpuGopEncoder(_info(w, h, CIF_Q), qi=CIF_Q)
    return enc.encode_clip(frames, keyframe_freq=CIF_KF)


def _cpu_child(path):
    """Entry point of phase e's child: encode on the CPU, save packets."""
    import logging

    # The child sees no GPU, so the CUDA plug-in logs its failed
    # initialization; JAX_PLATFORMS=cpu makes that harmless.
    logging.getLogger("jax._src.xla_bridge").setLevel(logging.CRITICAL)
    import jax

    from theora_tpu.tpkt import write_tpkt

    if jax.devices()[0].platform != "cpu":
        raise RuntimeError("the child must run on the CPU")
    write_tpkt(path, cif_packets())


def phase_gpu_vs_cpu():
    from theora_tpu.tpkt import read_tpkt

    gpu = [p.data for p in cif_packets()]
    with tempfile.TemporaryDirectory(dir=ROOT) as td:
        path = os.path.join(td, "cpu.tpkt")
        # No persistent cache in the child: a cached XLA:CPU program may
        # come from a host with other CPU features.
        env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
                   JAX_ENABLE_COMPILATION_CACHE="false")
        subprocess.run(
            [sys.executable, "-c",
             "import sys, chip_smoke; chip_smoke._cpu_child(sys.argv[1])",
             path],
            check=True, cwd=ROOT, env=env, timeout=900,
        )
        cpu = [p.data for p in read_tpkt(path)]
    if len(cpu) != len(gpu):
        raise AssertionError(f"{len(gpu)} GPU vs {len(cpu)} CPU packets")
    diff = [i for i, (a, b) in enumerate(zip(gpu, cpu)) if a != b]
    if diff:
        raise AssertionError(f"GPU and CPU packets differ at {diff}")
    return (f"{CIF_FRAMES} CIF frames q{CIF_Q}: {len(gpu)} packets, "
            f"{sum(len(p) for p in gpu)} bytes, identical on GPU and CPU")


MESH_W, MESH_H = 1920, 1088  # the frag=4 GOP: one 1080p luma GOP
# Above the clip's ~25 Mbit/s at q48, so the controller lowers qi and
# the adaptive-quant triple (qi >= 52 here) never engages: one compiled
# scan per plane and mesh.
MESH_CBR_BITRATE = 40_000_000


def phase_four_cards(devices):
    """The mesh encodes and their 1-card twins run in four threads of
    this process, so their compilations overlap."""
    from concurrent.futures import ThreadPoolExecutor

    from theora_tpu.parallel.gop import (
        MeshGopEncoder, encode_clip_mesh, make_mesh,
    )

    if len(devices) < 4:
        raise RuntimeError(f"needs 4 GPUs, found {len(devices)}")
    one = make_mesh(1, frag_axis=1, devices=devices[:1])
    frames = [list(f) for f in bench.gen_frames()]
    info = _info(bench.W, bench.H, bench.QUALITY)
    kw = dict(keyframe_freq=bench.KF_FREQ, qi=bench.QUALITY,
              target_bitrate=MESH_CBR_BITRATE, rate_window=3,
              auto_keyframe=True)

    w, h = MESH_W, MESH_H
    yy, xx = np.mgrid[0:h, 0:w]
    gop = []
    for t in range(2):
        y = (120 + 90 * np.sin((xx + 40 * t) / 37.0)
             + 30 * np.cos(yy / 23.0)).clip(0, 255).astype(np.uint8)
        gop.append([y, np.full((h // 2, w // 2), 110, np.uint8),
                    np.full((h // 2, w // 2), 150, np.uint8)])
    info_big = _info(w, h, 48)

    def clip(mesh):
        return [p.data for p in encode_clip_mesh(frames, info, mesh, **kw)]

    def big_gop(mesh):
        return MeshGopEncoder(mesh, info_big, qi=48).encode_gops([gop])

    def timed(fn, mesh):
        t0 = time.perf_counter()
        return fn(mesh), time.perf_counter() - t0

    jobs = {
        "clip 2x2": (clip, make_mesh(4, frag_axis=2, devices=devices[:4])),
        "clip 1x1": (clip, one),
        "gop 1x4": (big_gop, make_mesh(4, frag_axis=4,
                                       devices=devices[:4])),
        "gop 1x1": (big_gop, one),
    }
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(timed, fn, m) for k, (fn, m) in jobs.items()}
        res = {k: f.result() for k, f in futs.items()}
    if res["clip 2x2"][0] != res["clip 1x1"][0]:
        raise AssertionError(
            f"{bench.H}p gop=2 x frag=2 CBR differs from 1 card"
        )
    if res["gop 1x4"][0] != res["gop 1x1"][0]:
        raise AssertionError(f"{h}p gop=1 x frag=4 differs from 1 card")
    secs = ", ".join(f"{k} {v[1]:.1f} s" for k, v in res.items())
    return (f"{bench.H}p CBR gop=2 x frag=2 "
            f"({sum(len(d) for d in res['clip 2x2'][0][3:])} bytes) and "
            f"{h}p gop=1 x frag=4 "
            f"({sum(len(d) for d in res['gop 1x4'][0][0])} bytes) equal "
            f"1-card runs (wall, compile included: {secs})")


# ---------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    lines = runtime.cards()
    print("\n".join(lines), flush=True)
    card = lines[0]
    runtime.setup_compile_cache()
    devices = runtime.require_gpu()

    failed = []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            msg = fn(*a)
            status = "ok"
        except Exception:
            traceback.print_exc()
            failed.append(name)
            msg, status = "see traceback on stderr", "FAILED"
        print(f"phase {name}: {status} ({time.perf_counter() - t0:.1f} s) "
              f"{msg}", flush=True)

    if args.four_cards:
        run("f four cards", phase_four_cards, devices)
    else:
        state: dict = {}
        run("a device", phase_device)
        run("b decode goldens", phase_decode_goldens)
        run("c encode 720p", phase_encode_720p, card, state)
        run("d transcode_device", phase_transcode, state)
        run("e GPU vs CPU", phase_gpu_vs_cpu)
    if failed:
        print(f"failed phases: {', '.join(failed)}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
