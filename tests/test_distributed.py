"""Multi-host GOP transcode (jax.distributed): two local processes must
produce output byte-identical to a sequential encode."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import TESTDATA
from theora_tpu.encode.encoder import Encoder
from theora_tpu.info import TheoraInfo

_WORKER = r"""
import os, sys, pickle
import numpy as np
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(f"localhost:{port}", num_processes=nproc,
                           process_id=pid)
sys.path.insert(0, sys.argv[4])
from theora_tpu.info import TheoraInfo
from theora_tpu.parallel.distributed import distributed_transcode
W, H = 64, 48
raw = np.fromfile(sys.argv[5], np.uint8)
fsz = W*H*3//2
frames = []
for i in range(len(raw)//fsz):
    f = raw[i*fsz:(i+1)*fsz]
    frames.append([f[:W*H].reshape(H,W), f[W*H:W*H+fsz//6].reshape(H//2,W//2),
                   f[W*H+fsz//6:fsz].reshape(H//2,W//2)])
info = TheoraInfo(frame_width=W, frame_height=H, pic_width=W, pic_height=H,
                  quality=40)
pkts = distributed_transcode(frames, info, keyframe_freq=4)
if pid == 0:
    with open(sys.argv[6], "wb") as f:
        pickle.dump([(p.data, p.granulepos, p.e_o_s) for p in pkts], f)
"""


def _load(W, H):
    raw = np.fromfile(os.path.join(TESTDATA, "clip64x48.i420"), np.uint8)
    fsz = W * H * 3 // 2
    frames = []
    for i in range(len(raw) // fsz):
        f = raw[i * fsz : (i + 1) * fsz]
        frames.append(
            [
                f[: W * H].reshape(H, W),
                f[W * H : W * H + fsz // 6].reshape(H // 2, W // 2),
                f[W * H + fsz // 6 :].reshape(H // 2, W // 2),
            ]
        )
    return frames


def test_two_process_distributed_matches_sequential(tmp_path):
    W, H = 64, 48
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    clip = os.path.join(TESTDATA, "clip64x48.i420")
    out = str(tmp_path / "dist.pkl")
    worker = str(tmp_path / "worker.py")
    with open(worker, "w") as f:
        f.write(_WORKER)
    port = "9923"
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    p1 = subprocess.Popen(
        [sys.executable, worker, "1", "2", port, repo, clip, out], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        r0 = subprocess.run(
            [sys.executable, worker, "0", "2", port, repo, clip, out],
            env=env, timeout=120, capture_output=True,
        )
        p1.wait(timeout=30)
    except subprocess.TimeoutExpired:
        p1.kill()
        pytest.skip("distributed init timed out in this environment")
    if r0.returncode != 0:
        pytest.skip(
            f"jax.distributed unavailable: {r0.stderr[-300:]!r}"
        )
    with open(out, "rb") as f:
        dist = pickle.load(f)

    frames = _load(W, H)
    info = TheoraInfo(
        frame_width=W, frame_height=H, pic_width=W, pic_height=H, quality=40
    )
    enc = Encoder(info)
    enc.keyframe_freq = 4
    seq = enc.flush_headers()
    for i, fr in enumerate(frames):
        seq.append(enc.encode_frame(fr, e_o_s=(i == len(frames) - 1)))
    assert len(seq) == len(dist)
    for a, (d, g, e) in zip(seq, dist):
        assert a.data == d and a.granulepos == g and a.e_o_s == e


_WORKER4 = r"""
import os, sys, pickle
import numpy as np
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(f"localhost:{port}", num_processes=nproc,
                           process_id=pid)
sys.path.insert(0, sys.argv[4])
from theora_tpu.info import TheoraInfo
from theora_tpu.parallel.distributed import distributed_transcode
W, H = 64, 48
raw = np.fromfile(sys.argv[5], np.uint8)
fsz = W*H*3//2
frames = []
for i in range(len(raw)//fsz):
    f = raw[i*fsz:(i+1)*fsz]
    frames.append([f[:W*H].reshape(H,W), f[W*H:W*H+fsz//6].reshape(H//2,W//2),
                   f[W*H+fsz//6:fsz].reshape(H//2,W//2)])
info = TheoraInfo(frame_width=W, frame_height=H, pic_width=W, pic_height=H,
                  quality=40)
bases = [int(b) for b in sys.argv[7].split(",")]
drop = set(int(g) for g in sys.argv[8].split(",") if g)
pkts = distributed_transcode(frames, info, gop_bases=bases,
                             _drop_gops=drop or None)
if pid == 0:
    with open(sys.argv[6], "wb") as f:
        pickle.dump([(p.data, p.granulepos, p.e_o_s) for p in pkts], f)
"""


def test_four_process_scene_cut_gops_with_killed_worker(tmp_path):
    """4 jax.distributed processes over UNEVEN
    scene-cut GOPs, with one worker SIGKILLed before it joins the
    cluster and then relaunched having lost its assignment (the
    restarted incarnation reports nothing for its GOPs; host 0's
    elastic recovery re-encodes them).  Output must be byte-identical
    to a single sequential encoder forcing keyframes at the same
    cuts."""
    import signal
    import time

    W, H = 64, 48
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # Scene-cut clip: 3 hard cuts at uneven positions.
    rng = np.random.RandomState(5)
    scenes = [rng.randint(0, 256, (H, W)).astype(np.uint8)
              for _ in range(4)]
    bases = [0, 5, 8, 14]
    nf = 18
    frames = []
    for i in range(nf):
        si = sum(1 for b in bases if b <= i) - 1
        y = scenes[si].copy()
        y[:, (3 * i) % (W - 8) : (3 * i) % (W - 8) + 8] = 128
        frames.append([
            y,
            np.full((H // 2, W // 2), 90 + si, np.uint8),
            np.full((H // 2, W // 2), 160 - si, np.uint8),
        ])
    clip = str(tmp_path / "cuts.i420")
    with open(clip, "wb") as f:
        for y, u, v in frames:
            f.write(y.tobytes() + u.tobytes() + v.tobytes())
    out = str(tmp_path / "dist4.pkl")
    worker = str(tmp_path / "worker4.py")
    with open(worker, "w") as f:
        f.write(_WORKER4)
    hang = str(tmp_path / "hang.py")
    with open(hang, "w") as f:
        f.write("import time\ntime.sleep(600)\n")
    port = "9931"
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    bases_s = ",".join(str(b) for b in bases)
    # Worker 2's GOPs under round-robin assignment over 4 GOPs.
    lost = "2"
    procs = []
    args = lambda pid, drop: [
        sys.executable, worker, str(pid), "4", port, repo, clip, out,
        bases_s, drop,
    ]
    try:
        for pid in (0, 1, 3):
            procs.append(subprocess.Popen(
                args(pid, ""), env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            ))
        # Worker 2's first incarnation dies before joining the cluster
        # (the other three block at the init barrier until the restart
        # joins).
        doomed = subprocess.Popen(
            [sys.executable, hang], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        time.sleep(1.0)
        doomed.send_signal(signal.SIGKILL)
        doomed.wait(timeout=10)
        procs.append(subprocess.Popen(
            args(2, lost), env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        ))
        deadline = time.time() + 240
        for p in procs:
            p.wait(timeout=max(5.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("4-process distributed run timed out here")
    if not os.path.exists(out):
        pytest.skip("jax.distributed unavailable in this environment")
    with open(out, "rb") as f:
        dist = pickle.load(f)

    # Sequential oracle: ONE encoder, keyframes forced at the cuts.
    info = TheoraInfo(
        frame_width=W, frame_height=H, pic_width=W, pic_height=H,
        quality=40,
    )
    enc = Encoder(info)
    enc.keyframe_freq = 64
    seq = enc.flush_headers()
    for i, fr in enumerate(frames):
        if i in bases:
            enc._frames_since_keyframe = enc.keyframe_freq
        seq.append(enc.encode_frame(fr, e_o_s=(i == nf - 1)))
    assert len(seq) == len(dist)
    for a, (d, g, e) in zip(seq, dist):
        assert a.data == d and a.granulepos == g and a.e_o_s == e
