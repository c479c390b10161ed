"""Per-stage device profile and speed-of-light model of the device GOP
encode pipeline.

Each stage of the device encode pipeline is timed separately (wall time
of back-to-back dispatches ending in block_until_ready), and set
against a memory-bound model: the bytes a closed-loop scan step must
touch per frame over the card's published HBM bandwidth, looked up by
JAX's device_kind in PEAKS.

  memory bound = bytes touched per frame / HBM bandwidth.  A 720p 4:2:0
                 frame's closed-loop scan step reads cur (1.4 MB u8) and
                 the prev/gold refs (2 x 1.4 MB) and writes the recon
                 (1.4 MB) and qdct (F x N x 64 i16, ~2.8 MB): ~9 MB per
                 frame at the least.
  measured     = the per-stage table; the serial frame scan, the 63-step
                 trellis scan and the coarse-ME chunks keep the stages
                 far above that bound.

Usage: python -m theora_tpu.tools.roofline [--frames N] [--gops G]
           [--size WxH] [--reps R]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _synth_frames(w, h, n, seed=11):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = rng.randint(0, 256, size=(h + 4 * n + 4, w + 2 * n + 4)).astype(
        np.uint8
    )
    frames = []
    for t in range(n):
        y = base[t * 4 : t * 4 + h, t * 2 : t * 2 + w].copy()
        y = (
            (y.astype(np.int32) + 128 + 80 * np.sin((xx + 8 * t) / 24.0)) // 2
        ).clip(0, 255).astype(np.uint8)
        u = (128 + 50 * np.sin((xx[::2, ::2] + 3 * t) / 40.0)).astype(np.uint8)
        v = (128 + 50 * np.cos((yy[::2, ::2] - 2 * t) / 32.0)).astype(np.uint8)
        frames.append([y, u, v])
    return frames


def _plane_args(enc, frames, F, pli, n_qis=1):
    """Device-resident scan inputs for one plane (synthetic motion
    metadata: the scans' cost depends on shapes, not data)."""
    import jax.numpy as jnp

    from theora_tpu.ops.fdct_np import rd_lambda

    g = enc.g
    dq = enc.enc.dequant
    pl = g.planes[pli]
    vpad, hpad = g.plane_padding(pli)
    n = pl.nfrags
    hh, ww = pl.nvfrags * 8, pl.nhfrags * 8
    cur = jnp.asarray(
        np.stack(
            [
                np.asarray(frames[f][pli])[::-1][:hh, :ww].astype(np.uint8)
                for f in range(F)
            ]
        )
    )
    z8 = jnp.zeros((F, n), jnp.int8)
    ones = jnp.ones((F, n), jnp.int8)
    rs = jnp.where(jnp.arange(F)[:, None] == 0, 0, ones)
    u2 = jnp.zeros((F, n), bool)
    ms = jnp.asarray(np.broadcast_to(np.arange(F)[:, None] != 0, (F, n)).copy())
    ik = jnp.asarray(np.arange(F) == 0)
    lam_qi = rd_lambda(enc.qi, int(dq[enc.qi, pli, 0, 1])) * 3.0
    lam_qp = rd_lambda(enc.qi, int(dq[enc.qi, pli, 1, 1])) * 3.0

    def pf(row, dtype=np.float32):
        a = np.asarray(row, dtype)
        return jnp.asarray(np.broadcast_to(a, (F,) + a.shape).copy())

    return (
        (
            cur, rs, z8, z8, z8, z8, u2, ms, ik,
            pf(dq[enc.qi, pli, 0], np.int32),
            pf(dq[enc.qi, pli, 1], np.int32),
            pf(enc._bv, np.int32), pf(enc._lam),
            pf(lam_qi), pf(lam_qp),
            jnp.asarray(enc._nb_dev), jnp.asarray(enc._nb_dev),
            pf(enc._lam_t[0]), pf(enc._lam_t[1]),
            pl.nvfrags, pl.nhfrags, vpad, hpad,
        ),
        n,
    )


# Published peaks, keyed by JAX's device_kind.  Source: NVIDIA H100
# data sheet, SXM part (80 GB HBM3 at 3.35 TB/s).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of a device; an unknown device is an error, never
    an assumed peak."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}"
        ) from None


def _time(fn, reps):
    """Wall time per call of reps back-to-back dispatches, ending in
    block_until_ready (the first call compiles and is not timed)."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--gops", type=int, default=1)
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from theora_tpu import runtime
    from theora_tpu.encode.tpu_gop import TpuGopEncoder, _scan_encode_plane
    from theora_tpu.info import TheoraInfo
    from theora_tpu.ops import me_jax

    runtime.setup_compile_cache()
    devices = runtime.require_gpu()
    peaks = device_peaks(devices[0].device_kind)
    card = runtime.cards()[0]
    w, h = (int(x) for x in args.size.split("x"))
    F = args.frames
    frames = _synth_frames(w, h, F)
    info = TheoraInfo(
        frame_width=w, frame_height=h, pic_width=w, pic_height=h,
        quality=48,
    )
    enc = TpuGopEncoder(info, qi=48)
    mpix_f = (w * h + 2 * (w // 2) * (h // 2)) / 1e6

    rows = []

    def add(name, dt, frames_covered):
        rows.append(
            {
                "stage": name,
                "ms_per_gop": round(dt * 1e3, 2),
                "ms_per_frame": round(dt * 1e3 / frames_covered, 3),
                "mpix_s": round(mpix_f * frames_covered / dt, 1),
            }
        )

    reps = args.reps
    pa = [_plane_args(enc, frames, F, pli)[0] for pli in range(3)]
    ys_d = pa[0][0]

    # --- ME plan (fused pyramid search over the GOP) ---
    dt = _time(lambda: me_jax.plan_from_gop(ys_d), reps)
    add("me_plan", dt, F)

    # --- per-plane closed-loop scans, trellis tier ---
    for pli, name in ((0, "scan_luma"), (1, "scan_cb"), (2, "scan_cr")):
        dt = _time(
            lambda pli=pli: _scan_encode_plane(*pa[pli], use_trellis=True),
            reps,
        )
        add(name + "_trellis", dt, F)

    # --- luma scan, R/D-quantizer tier (isolates the trellis DP) ---
    dt = _time(lambda: _scan_encode_plane(*pa[0], use_trellis=False), reps)
    add("scan_luma_rdquant", dt, F)

    # --- full pipeline (ME + 3 scans), the bench metric ---
    def one_pass():
        outs = me_jax.plan_from_gop(ys_d)
        scans = [
            _scan_encode_plane(*a, use_trellis=enc.use_trellis) for a in pa
        ]
        return outs, scans

    dt = _time(one_pass, reps)
    add("pipeline_total", dt, F)

    # --- transform core (compute bound reference) ---
    from theora_tpu.pipeline import intra_encode_core
    import jax.numpy as jnp

    dq_y = jnp.asarray(enc.enc.dequant[48, 0, 0].astype(np.int32))
    yb = np.stack(
        [
            np.asarray(frames[f][0])
            .reshape(h // 8, 8, w // 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(-1, 8, 8)
            for f in range(F)
        ]
    )
    yb_d = jnp.asarray(yb)
    dt = _time(lambda: intra_encode_core(yb_d, dq_y), reps)
    rows.append(
        {
            "stage": "transform_core(luma)",
            "ms_per_gop": round(dt * 1e3, 2),
            "ms_per_frame": round(dt * 1e3 / F, 3),
            "mpix_s": round(w * h * F / 1e6 / dt, 1),
        }
    )

    # --- speed-of-light model ---
    bytes_frame = (
        1.5 * w * h  # cur u8 (4:2:0)
        + 2 * 1.5 * w * h  # prev + gold refs
        + 1.5 * w * h  # recon write
        + 1.5 * w * h / 64 * 64 * 2  # qdct i16
    )
    sol_us = bytes_frame / peaks["hbm_bytes_per_s"] * 1e6
    model = {
        "device_kind": devices[0].device_kind,
        "card": card,
        "hbm_bytes_per_s": peaks["hbm_bytes_per_s"],
        "bytes_touched_per_frame_mb": round(bytes_frame / 1e6, 2),
        "hbm_speed_of_light_us_per_frame": round(sol_us, 1),
        "hbm_speed_of_light_mpix_s": round(mpix_f / (sol_us * 1e-6), 0),
    }
    pt = next(r for r in rows if r["stage"] == "pipeline_total")
    model["pipeline_pct_of_hbm_roofline"] = round(
        100.0 * sol_us / (pt["ms_per_frame"] * 1e3), 2
    )

    if args.json:
        print(json.dumps({"stages": rows, "model": model}))
    else:
        print(f"{'stage':26s} {'ms/GOP':>9s} {'ms/frame':>9s} {'Mpix/s':>9s}")
        for r in rows:
            print(
                f"{r['stage']:26s} {r['ms_per_gop']:9.2f}"
                f" {r['ms_per_frame']:9.3f} {r['mpix_s']:9.1f}"
            )
        print("model:", json.dumps(model))
    return rows, model


if __name__ == "__main__":
    main()
