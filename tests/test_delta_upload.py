"""Sparse temporal-delta pixel upload (encode/delta_upload.py) and the
clip-batched multi-GOP dispatch path.

Everything here is about one contract: the optimized transfer/dispatch
paths are BYTE-IDENTICAL to the plain ones."""
import numpy as np
import pytest

from theora_tpu.info import TheoraInfo

W, H = 160, 128


def _info(q=48):
    return TheoraInfo(
        frame_width=W, frame_height=H, pic_width=W, pic_height=H,
        quality=q,
    )


def _mover_frames(n, seed=7):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (H, W)).astype(np.uint8)
    out = []
    for t in range(n):
        y = base.copy()
        y[64:96, (6 * t) % (W - 24) : (6 * t) % (W - 24) + 24] = 40
        y[:32, :32] = rng.randint(0, 256, (32, 32))  # grain panel
        out.append([y, np.full((H // 2, W // 2), 90, np.uint8),
                    np.full((H // 2, W // 2), 160, np.uint8)])
    return out


def _noise_frames(n, seed=3):
    rng = np.random.RandomState(seed)
    return [
        [rng.randint(0, 256, (H, W)).astype(np.uint8),
         rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8),
         rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)]
        for _ in range(n)
    ]


def _drift_frames(n):
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for t in range(n):
        y = (128 + 60 * np.sin((xx + 2 * t) / 19.0)).astype(np.uint8)
        u = (128 + 40 * np.sin((xx[::2, ::2] + t) / 23.0)).astype(np.uint8)
        v = (128 + 40 * np.cos((yy[::2, ::2] - t) / 31.0)).astype(np.uint8)
        out.append([y, u, v])
    return out


def test_uploader_exactness_all_modes():
    """upload() must reproduce the exact stack for sparse, nibble, and
    dense decisions, including chained carries."""
    import jax

    from theora_tpu.encode.delta_upload import DeltaUploader

    rng = np.random.RandomState(0)
    up = DeltaUploader()
    prev = rng.randint(0, 256, (24, 32)).astype(np.uint8)
    stacks = []
    # dense (first), sparse (few blocks), nibble (small-amp everywhere),
    # dense fallback (full-range noise)
    s0 = rng.randint(0, 256, (3, 24, 32)).astype(np.uint8)
    s1 = np.repeat(s0[-1][None], 3, axis=0).copy()
    s1[:, :8, :8] = rng.randint(0, 256, (3, 8, 8))
    # Cumulative small-step drift: every frame-to-frame residue fits
    # [-8, 7] so the nibble mode engages.
    s2 = np.empty((3, 24, 32), np.uint8)
    cur = s1[-1]
    for f in range(3):
        cur = (cur.astype(np.int16)
               + rng.randint(-7, 8, (24, 32))).astype(np.uint8)
        s2[f] = cur
    s3 = rng.randint(0, 256, (3, 24, 32)).astype(np.uint8)
    for s in (s0, s1, s2, s3):
        got = np.asarray(jax.device_get(up.upload("y", s)))
        assert np.array_equal(got, s)
    assert up.stats["sparse"] >= 1
    assert up.stats.get("nibble", 0) >= 1
    assert up.stats["dense"] >= 2  # first + fallback


@pytest.mark.parametrize("gen,kf", [
    (_mover_frames, 4), (_noise_frames, 3), (_drift_frames, 4),
])
def test_delta_upload_byte_identity(gen, kf):
    from theora_tpu.encode.tpu_gop import TpuGopEncoder

    frames = gen(8)
    a = TpuGopEncoder(_info(), qi=48)
    a.delta_upload = False
    pa = [p.data for p in a.encode_clip(frames, keyframe_freq=kf)]
    b = TpuGopEncoder(_info(), qi=48)
    pb = [p.data for p in b.encode_clip(frames, keyframe_freq=kf)]
    assert pa == pb


@pytest.mark.parametrize("kf_freq,q", [(1, 48), (5, 48), (8, 56)])
def test_clip_batched_vs_per_gop_identity(kf_freq, q):
    """One multi-GOP dispatch (clip_batch > GOP) must produce the same
    bytes as per-GOP dispatches -- including all-intra clips and the
    adaptive-quant (multi-qi) gate at q56."""
    from theora_tpu.encode.tpu_gop import TpuGopEncoder

    frames = _mover_frames(10, seed=11)
    seq = TpuGopEncoder(_info(q), qi=q)
    out_seq = []
    for i in range(0, 10, kf_freq):
        pk, _ = seq.finish_gop(seq.complete_dispatch(
            seq.dispatch_me(frames[i:i + kf_freq])
        ))
        out_seq.extend(pk)
    bat = TpuGopEncoder(_info(q), qi=q)
    out_bat = [
        p.data
        for p in bat.encode_clip(frames, keyframe_freq=kf_freq,
                                 clip_batch=10)[3:]
    ]
    assert out_seq == out_bat


def test_clip_batched_native_decide_matches_python():
    """th_mode_decide (C++) must reproduce the Python walk exactly."""
    import jax

    from theora_tpu.encode.tpu_gop import TpuGopEncoder
    import theora_tpu.native as nat

    if not hasattr(nat, "mode_decide_native"):
        pytest.skip("native tier unavailable")
    frames = _mover_frames(6, seed=5)
    enc = TpuGopEncoder(_info(), qi=48)
    me = enc.dispatch_me(frames, kf_flags=[True] + [False] * 5)
    outs = jax.device_get(me[4])
    plans_native = enc._decide_frames(outs, 5)
    saved = nat.mode_decide_native
    del nat.mode_decide_native
    try:
        plans_py = enc._decide_frames(outs, 5)
    finally:
        nat.mode_decide_native = saved
    for a, b in zip(plans_native, plans_py):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
