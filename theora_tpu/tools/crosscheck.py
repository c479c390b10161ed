"""Randomized encode/decode conformance campaign.

Forward direction: OUR encoder across random frame geometries (including
odd crops), pixel formats, quantizers, keyframe schedules, CBR, and
adaptive quant; every stream must decode in the reference decoder
(refbuild oracle) AND our decoder with bit-identical output.

Reverse direction (--reverse): the REFERENCE encoder across random
configs; our decoder must match the reference decoder bit-for-bit.

Device direction (--device): the DEVICE-TIER encoder (TpuGopEncoder,
with and without the batched trellis) across random configs; same
double-decode byte-identity requirement.

Usage: python -m theora_tpu.tools.crosscheck [--reverse|--device]
       [trials] [seed]
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

from theora_tpu.decode.decoder import Decoder
from theora_tpu.encode.encoder import Encoder
from theora_tpu.headers import parse_info_header, parse_setup_header
from theora_tpu.info import TheoraInfo
from theora_tpu.tpkt import write_tpkt

REF_DEC = "refbuild/build/ref_dec"
REF_ENC = "refbuild/build/ref_enc"


def synth(rng, W, H, n, fmt, kind):
    cw = W if fmt == 3 else W // 2
    ch = H if fmt >= 2 else H // 2
    frames = []
    y0 = rng.randint(0, 256, size=(H, W)).astype(np.uint8)
    for i in range(n):
        if kind == 0:
            yy, xx = np.mgrid[0:H, 0:W]
            y = ((xx * 3 + yy * 2 + i * 7) % 256).astype(np.uint8)
        elif kind == 1:
            y = np.roll(y0, i, axis=1)
        else:
            y = (
                (y0.astype(int)
                 + 30 * np.sin((np.arange(W) + 5 * i) / 17.0)[None, :])
                .clip(0, 255)
            ).astype(np.uint8)
        u = (
            rng.randint(0, 256, size=(ch, cw)).astype(np.uint8)
            if kind == 1
            else np.full((ch, cw), (100 + i * 3) % 256, np.uint8)
        )
        v = np.full((ch, cw), (180 - i * 5) % 256, np.uint8)
        frames.append([y, u, v])
    return frames

def _tmp_path(tag: str) -> str:
    """Per-process scratch path: concurrent campaigns must not race on
    shared .tpkt/.yuv files (two campaigns at the same seed otherwise
    read each other's streams mid-trial)."""
    return f"/tmp/crosscheck_{tag}_{os.getpid()}"


def run_trial(rng, trial, tmp=None):
    tmp = tmp or _tmp_path('fw')
    fw = int(rng.choice([32, 48, 64, 80, 96, 112]))
    fh = int(rng.choice([32, 48, 64, 80]))
    fmt = int(rng.choice([0, 2, 3]))
    pw = fw - int(rng.randint(0, min(16, fw - 15)))
    ph = fh - int(rng.randint(0, min(16, fh - 15)))
    px = int(rng.randint(0, fw - pw + 1))
    py = int(rng.randint(0, fh - ph + 1))
    qi = int(rng.randint(0, 64))
    kf = int(rng.choice([1, 2, 4, 8]))
    nfr = int(rng.randint(2, 7))
    br = int(rng.choice([0, 0, 0, 80000]))
    desc = (f"{fw}x{fh} pic {pw}x{ph}+{px}+{py} fmt{fmt} qi{qi} kf{kf} "
            f"br{br} kind{trial % 3}")
    info = TheoraInfo(
        frame_width=fw, frame_height=fh, pic_width=pw, pic_height=ph,
        pic_x=px, pic_y=py, fps_numerator=30, fps_denominator=1,
        quality=qi, keyframe_granule_shift=6, pixel_fmt=fmt,
        target_bitrate=br,
    )
    e = Encoder(info)
    e.keyframe_freq = kf
    if trial % 7 == 0:
        e.adaptive_quant = True
    hd = e.flush_headers()
    pk = [e.encode_frame(fr) for fr in synth(rng, fw, fh, nfr, fmt, trial % 3)]
    write_tpkt(tmp + ".tpkt", hd + pk)
    pp = int(rng.choice([0, 0, 0, 2, 5, 7]))
    cmd = [REF_DEC, tmp + ".tpkt", tmp + ".yuv"]
    if pp:
        cmd.append(str(pp))
        desc += f" pp{pp}"
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if "decoded" not in (r.stdout + r.stderr):
        return desc, "reference decoder rejected the stream"
    dec = Decoder(parse_info_header(hd[0].data), parse_setup_header(hd[2].data))
    if pp:
        dec.set_pplevel(pp)
    mine = []
    for p in pk:
        dec.decode_packet(p.data)
        mine.append(np.concatenate([x.reshape(-1) for x in dec.ycbcr_out()]))
    ref = np.fromfile(tmp + ".yuv", np.uint8)
    mine_all = np.concatenate(mine)
    if len(ref) != len(mine_all):
        return desc, f"length {len(ref)} vs {len(mine_all)}"
    if not np.array_equal(ref, mine_all):
        return desc, f"bytes differ at {int(np.argmax(ref != mine_all))}"
    return desc, None


def run_reverse_trial(rng, trial, tmp=None):
    """Reference encoder -> both decoders must agree byte-for-byte."""
    tmp = tmp or _tmp_path("rev")
    from theora_tpu.tpkt import read_tpkt
    from theora_tpu.headers import parse_info_header, parse_setup_header

    fw = int(rng.choice([32, 48, 64, 80, 96]))
    fh = int(rng.choice([32, 48, 64, 80]))
    fmt = int(rng.choice([0, 2, 3]))
    pw = fw - int(rng.randint(0, min(16, fw - 15)))
    ph = fh - int(rng.randint(0, min(16, fh - 15)))
    px = int(rng.randint(0, fw - pw + 1))
    py = int(rng.randint(0, fh - ph + 1))
    qi = int(rng.randint(0, 64))
    kf = int(rng.choice([1, 2, 4, 8]))
    nfr = int(rng.randint(2, 7))
    br = int(rng.choice([0, 0, 80000]))
    desc = (f"REV {fw}x{fh} pic {pw}x{ph}+{px}+{py} fmt{fmt} qi{qi} "
            f"kf{kf} br{br}")
    frames = synth(rng, fw, fh, nfr, fmt, trial % 3)
    csz = sum(p.size for p in frames[0])
    with open(tmp + ".i420", "wb") as f:
        for fr in frames:
            for p in fr:
                f.write(np.ascontiguousarray(p).tobytes())
    r = subprocess.run(
        [REF_ENC, str(fw), str(fh), str(nfr), str(qi), str(kf),
         tmp + ".i420", tmp + ".tpkt", str(br), str(pw), str(ph),
         str(px), str(py), str(fmt)],
        capture_output=True, text=True, timeout=120,
    )
    if r.returncode != 0:
        return desc, f"reference encoder failed: {r.stderr[-120:]}"
    r = subprocess.run(
        [REF_DEC, tmp + ".tpkt", tmp + ".yuv"],
        capture_output=True, text=True, timeout=120,
    )
    if "decoded" not in (r.stdout + r.stderr):
        return desc, "reference decoder rejected its own stream"
    pkts = read_tpkt(tmp + ".tpkt")
    dec = Decoder(parse_info_header(pkts[0].data),
                  parse_setup_header(pkts[2].data))
    mine = []
    for p in pkts[3:]:
        dec.decode_packet(p.data)
        mine.append(np.concatenate([x.reshape(-1) for x in dec.ycbcr_out()]))
    ref = np.fromfile(tmp + ".yuv", np.uint8)
    mine_all = np.concatenate(mine)
    if len(ref) != len(mine_all):
        return desc, f"length {len(ref)} vs {len(mine_all)}"
    if not np.array_equal(ref, mine_all):
        return desc, f"bytes differ at {int(np.argmax(ref != mine_all))}"
    return desc, None


def run_device_trial(rng, trial, tmp=None):
    """Device-tier encoder -> both decoders must agree byte-for-byte."""
    tmp = tmp or _tmp_path("dev")
    from theora_tpu.encode.tpu_gop import TpuGopEncoder

    fw = int(rng.choice([32, 48, 64, 80, 96]))
    fh = int(rng.choice([32, 48, 64, 80]))
    fmt = int(rng.choice([0, 2, 3]))
    pw = fw - int(rng.randint(0, min(16, fw - 15)))
    ph = fh - int(rng.randint(0, min(16, fh - 15)))
    px = int(rng.randint(0, fw - pw + 1))
    py = int(rng.randint(0, fh - ph + 1))
    qi = int(rng.randint(0, 64))
    kf = int(rng.choice([1, 2, 4, 8]))
    nfr = int(rng.randint(2, 7))
    trellis = bool(rng.randint(0, 2))
    desc = (f"DEV {fw}x{fh} pic {pw}x{ph}+{px}+{py} fmt{fmt} qi{qi} "
            f"kf{kf} {'trellis' if trellis else 'rdquant'}")
    info = TheoraInfo(
        frame_width=fw, frame_height=fh, pic_width=pw, pic_height=ph,
        pic_x=px, pic_y=py,
        fps_numerator=30, fps_denominator=1, quality=qi,
        keyframe_granule_shift=6, pixel_fmt=fmt,
    )
    enc = TpuGopEncoder(info, qi=qi, use_trellis=trellis)
    pkts = enc.encode_clip(
        synth(rng, fw, fh, nfr, fmt, trial % 3), keyframe_freq=kf
    )
    write_tpkt(tmp + ".tpkt", pkts)
    pp = int(rng.choice([0, 0, 0, 2, 7]))
    cmd = [REF_DEC, tmp + ".tpkt", tmp + ".yuv"]
    if pp:
        cmd.append(str(pp))
        desc += f" pp{pp}"
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if "decoded" not in (r.stdout + r.stderr):
        return desc, "reference decoder rejected the stream"
    dec = Decoder(parse_info_header(pkts[0].data),
                  parse_setup_header(pkts[2].data))
    if pp:
        dec.set_pplevel(pp)
    mine = []
    for p in pkts[3:]:
        dec.decode_packet(p.data)
        mine.append(
            np.concatenate([x.reshape(-1) for x in dec.ycbcr_out()])
        )
    ref = np.fromfile(tmp + ".yuv", np.uint8)
    mine_all = np.concatenate(mine)
    if len(ref) != len(mine_all):
        return desc, f"length {len(ref)} vs {len(mine_all)}"
    if not np.array_equal(ref, mine_all):
        return desc, f"bytes differ at {int(np.argmax(ref != mine_all))}"
    return desc, None


REF_FUZZ = "refbuild/build/ref_fuzz"


def _mutate_packet(rng, data: bytes) -> bytes:
    """One random packet mutation: truncate, bit flips, zeroed range, or
    random-tail extension."""
    b = bytearray(data)
    kind = int(rng.randint(0, 4))
    if kind == 0 and len(b) > 1:  # truncate
        b = b[: int(rng.randint(1, len(b)))]
    elif kind == 1 and len(b):  # flip 1-8 bits
        for _ in range(int(rng.randint(1, 9))):
            i = int(rng.randint(0, len(b)))
            b[i] ^= 1 << int(rng.randint(0, 8))
    elif kind == 2 and len(b) > 2:  # zero a range
        lo = int(rng.randint(0, len(b) - 1))
        hi = int(rng.randint(lo + 1, len(b) + 1))
        b[lo:hi] = bytes(hi - lo)
    else:  # extend with random bytes
        b += bytes(rng.randint(0, 256, int(rng.randint(1, 32))).astype(
            np.uint8
        ).tobytes())
    return bytes(b)


def run_fuzz_trial(rng, trial, tmp=None):
    """Corrupt-DATA-PACKET differential: mutate packets of a valid
    stream; our decoder and the reference must produce the same
    per-packet accept/dup/reject decision AND byte-identical output
    frames, including the recovery AFTER a rejected packet (the
    zeros-past-EOF / dummy-frame semantics of bitpack.c:47-53 and
    decode.c:2053-2082 on damaged input)."""
    tmp = tmp or _tmp_path("fz")
    fw = int(rng.choice([32, 48, 64, 80]))
    fh = int(rng.choice([32, 48, 64]))
    fmt = int(rng.choice([0, 2, 3]))
    qi = int(rng.randint(0, 64))
    kf = int(rng.choice([1, 2, 4]))
    nfr = int(rng.randint(3, 8))
    desc = f"FUZZ {fw}x{fh} fmt{fmt} qi{qi} kf{kf} n{nfr}"
    info = TheoraInfo(
        frame_width=fw, frame_height=fh, pic_width=fw, pic_height=fh,
        fps_numerator=30, fps_denominator=1, quality=qi,
        keyframe_granule_shift=6, pixel_fmt=fmt,
    )
    e = Encoder(info)
    e.keyframe_freq = kf
    hd = e.flush_headers()
    pk = [e.encode_frame(fr)
          for fr in synth(rng, fw, fh, nfr, fmt, trial % 3)]
    # Mutate 1-3 data packets (never the headers; container-level damage
    # is test_ogg_container.py's job).
    nmut = int(rng.randint(1, 4))
    muts = rng.choice(len(pk), size=min(nmut, len(pk)), replace=False)
    datas = [p.data for p in pk]
    for mi in muts:
        datas[mi] = _mutate_packet(rng, datas[mi])
        desc += f" mut@{mi}"
    from theora_tpu.tpkt import Packet as TPacket

    mutated = hd + [
        TPacket(d, granulepos=p.granulepos, packetno=p.packetno,
                e_o_s=p.e_o_s)
        for d, p in zip(datas, pk)
    ]
    write_tpkt(tmp + ".tpkt", mutated)
    r = subprocess.run(
        [REF_FUZZ, tmp + ".tpkt", tmp + ".yuv"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        return desc, f"ref_fuzz crashed: rc={r.returncode} {r.stderr[-80:]}"
    ref_stat = [int(line.split()[1]) for line in r.stdout.splitlines()
                if line.startswith("S ")]
    ref_cat = ["bad" if s < 0 else "dup" if s == 1 else "ok"
               for s in ref_stat]

    dec = Decoder(parse_info_header(hd[0].data),
                  parse_setup_header(hd[2].data))
    my_cat = []
    mine = []
    for d in datas:
        try:
            ret = dec.decode_packet(d)
            my_cat.append("dup" if ret == 1 else "ok")
            mine.append(
                np.concatenate([x.reshape(-1) for x in dec.ycbcr_out()])
            )
        except Exception:
            my_cat.append("bad")
    if my_cat != ref_cat:
        return desc, f"status divergence: ref {ref_cat} vs ours {my_cat}"
    ref = np.fromfile(tmp + ".yuv", np.uint8)
    mine_all = (np.concatenate(mine) if mine
                else np.zeros(0, np.uint8))
    if len(ref) != len(mine_all):
        return desc, f"length {len(ref)} vs {len(mine_all)}"
    if not np.array_equal(ref, mine_all):
        return desc, f"bytes differ at {int(np.argmax(ref != mine_all))}"
    return desc, None


REF_HDR = "refbuild/build/ref_hdr"
# Accepted-but-huge frame geometry guard, mirrored in ref_hdr.c: both
# sides stop before decoder allocation when the accepted info header
# names more pixels than this, so hostile-but-legal 1Mx1M dimensions
# cannot OOM the differential itself.
MAX_HDR_AREA = 4096 * 4096


def _mutate_info_packet(rng, data: bytes) -> tuple[bytes, str]:
    """Surgical hostile edits at known info-header byte offsets (the
    info packet layout is fixed at 42 bytes: type(1) magic(6) version(3)
    fw(2) fh(2) pw(3) ph(3) px(1) py(1) fps(8) aspect(6) colorspace(1)
    bitrate(3) quality/kgshift/pixfmt/padding(2))."""
    b = bytearray(data)
    kind = int(rng.randint(0, 10))
    if kind == 0:
        b[7] = 4  # version_major too new -> TH_EVERSION
        tag = "vmaj"
    elif kind == 1:
        b[8] = 9  # version_minor too new -> TH_EVERSION
        tag = "vmin"
    elif kind == 2:
        b[9] = 99  # subminor is always accepted by spec
        tag = "vsub"
    elif kind == 3:
        b[10] = b[11] = 0  # frame_width = 0
        tag = "fw0"
    elif kind == 4:
        b[14] = 0xFF  # pic_width >> frame_width
        tag = "pwbig"
    elif kind == 5:
        b[20] = 0xFF  # pic_x pushes pic past the frame
        tag = "pxbig"
    elif kind == 6:
        b[22:26] = bytes(4)  # fps_numerator = 0
        tag = "fps0"
    elif kind == 7:
        v = (b[40] << 8) | b[41]
        v = (v & ~0x18) | 0x08  # pixel_fmt = 1 (reserved)
        b[40], b[41] = v >> 8, v & 0xFF
        tag = "pfrsvd"
    elif kind == 8:
        v = (b[40] << 8) | b[41]
        v |= int(rng.randint(1, 8))  # nonzero padding bits
        b[40], b[41] = v >> 8, v & 0xFF
        tag = "pad"
    else:
        # Huge-but-legal dims: header accepted, alloc guard must fire
        # identically on both sides.
        b[10] = b[11] = b[12] = b[13] = 0xFF
        tag = "huge"
    return bytes(b), tag


def _mutate_comment_packet(rng, data: bytes) -> tuple[bytes, str]:
    b = bytearray(data)
    kind = int(rng.randint(0, 4))
    if kind == 0:
        b[7:11] = (0xFFFFFFF0).to_bytes(4, "little")  # vendor len huge
        tag = "vendbig"
    elif kind == 1:
        b[7:11] = (0x7FFFFFFF).to_bytes(4, "little")  # vendor len = LONG_MAX
        tag = "vendmax"
    elif kind == 2 and len(b) >= 15:
        # comment count huge (offset depends on vendor length; recompute)
        vlen = int.from_bytes(b[7:11], "little")
        off = 11 + vlen
        if off + 4 <= len(b):
            b[off:off + 4] = (0x40000000).to_bytes(4, "little")
        tag = "nbig"
    else:
        b = b[: max(1, len(b) - int(rng.randint(1, min(8, len(b)))))]
        tag = "trunc"
    return bytes(b), tag


def run_hdr_fuzz_trial(rng, trial, tmp=None):
    """HEADER-packet differential: mutate the info/comment/setup packets
    (bit flips, truncations, hostile field values, packet-sequence
    damage) and drive the full header state machine on both sides.  The
    reference oracle (ref_hdr) prints the th_decode_headerin return code
    per header-phase packet and then decodes the rest; our
    th_decode_headerin (compat.py) must return the IDENTICAL code
    sequence (TH_ENOTFORMAT / TH_EVERSION / TH_EBADHEADER / 3/2/1/0),
    make the identical alloc decision, and any decoded output must be
    byte-identical.  Covers decinfo.c:182-272 (header state machine +
    info/comment unpack), dequant.c:24-144 (quant params), and
    huffdec.c:193-240 (Huffman tree unpack) against hostile input."""
    tmp = tmp or _tmp_path("hd")
    import signal

    from theora_tpu import compat
    from theora_tpu.tpkt import Packet as TPacket

    fw = int(rng.choice([32, 48, 64]))
    fh = int(rng.choice([32, 48]))
    fmt = int(rng.choice([0, 2, 3]))
    qi = int(rng.randint(0, 64))
    nfr = int(rng.randint(2, 5))
    desc = f"HDR {fw}x{fh} fmt{fmt} qi{qi} n{nfr}"
    info = TheoraInfo(
        frame_width=fw, frame_height=fh, pic_width=fw, pic_height=fh,
        fps_numerator=30, fps_denominator=1, quality=qi,
        keyframe_granule_shift=6, pixel_fmt=fmt,
    )
    e = Encoder(info)
    e.keyframe_freq = 4
    hd = e.flush_headers()
    pk = [e.encode_frame(fr) for fr in synth(rng, fw, fh, nfr, fmt, trial % 3)]
    pkts = list(hd) + pk

    # --- Mutate ------------------------------------------------------
    strat = int(rng.randint(0, 6))
    if strat == 0:  # generic byte damage on one header packet
        hi = int(rng.randint(0, 3))
        d, p = _mutate_packet(rng, pkts[hi].data), pkts[hi]
        pkts[hi] = TPacket(d, granulepos=p.granulepos,
                           packetno=p.packetno, e_o_s=p.e_o_s,
                           b_o_s=p.b_o_s)
        desc += f" gen@{hi}"
    elif strat == 1:  # targeted info-header field edits
        d, tag = _mutate_info_packet(rng, pkts[0].data)
        pkts[0] = TPacket(d, granulepos=pkts[0].granulepos,
                          packetno=0, e_o_s=False, b_o_s=True)
        desc += f" info:{tag}"
    elif strat == 2:  # targeted comment-header edits
        d, tag = _mutate_comment_packet(rng, pkts[1].data)
        pkts[1] = TPacket(d, granulepos=pkts[1].granulepos,
                          packetno=1, e_o_s=False)
        desc += f" cmt:{tag}"
    elif strat == 3:  # setup-payload bit damage (quant + Huffman areas)
        d = _mutate_packet(rng, pkts[2].data)
        pkts[2] = TPacket(d, granulepos=pkts[2].granulepos,
                          packetno=2, e_o_s=False)
        desc += " setup"
    elif strat == 4:  # packet-sequence damage
        kind = int(rng.randint(0, 6))
        if kind == 0 and len(pkts) > 3:
            del pkts[int(rng.randint(0, 3))]
            desc += " drop"
        elif kind == 1:
            hi = int(rng.randint(0, 3))
            pkts.insert(hi, pkts[hi])
            desc += " dup"
        elif kind == 2:
            pkts[1], pkts[2] = pkts[2], pkts[1]
            desc += " swap"
        elif kind == 3:
            p = pkts[0]
            pkts[0] = TPacket(p.data, granulepos=p.granulepos,
                              packetno=0, e_o_s=False, b_o_s=False)
            desc += " nobos"
        elif kind == 4:
            pkts.insert(0, TPacket(b"", granulepos=-1, packetno=0))
            desc += " empty1st"
        else:
            junk = bytes([0x83]) + b"theora" + bytes(
                rng.randint(0, 256, 8).astype(np.uint8).tobytes())
            pkts.insert(int(rng.randint(0, 4)),
                        TPacket(junk, granulepos=-1, packetno=9))
            desc += " junkhdr"
    else:  # bad magic on a random header
        hi = int(rng.randint(0, 3))
        b = bytearray(pkts[hi].data)
        b[1 + int(rng.randint(0, 6))] ^= 0xFF
        pkts[hi] = TPacket(bytes(b), granulepos=pkts[hi].granulepos,
                           packetno=hi, e_o_s=False,
                           b_o_s=pkts[hi].b_o_s)
        desc += f" magic@{hi}"

    write_tpkt(tmp + ".tpkt", pkts)
    r = subprocess.run(
        [REF_HDR, tmp + ".tpkt", tmp + ".yuv"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        return desc, f"ref_hdr crashed: rc={r.returncode} {r.stderr[-80:]}"
    ref_events = []
    for line in r.stdout.splitlines():
        f = line.split()
        if f and f[0] in ("H", "A", "S"):
            ref_events.append((f[0], f[1] if f[0] == "A" else int(f[1])))

    # --- Our side: identical driver loop -----------------------------
    my_events = []
    mine = []

    def _drive():
        state: dict = {}
        dec = None
        for p in pkts:
            if dec is None:
                ret = compat.th_decode_headerin(state, p)
                my_events.append(("H", ret))
                if ret != 0:
                    continue
                ti = state["info"]
                if ti.frame_width * ti.frame_height > MAX_HDR_AREA:
                    my_events.append(("A", "skip"))
                    return
                try:
                    dec = Decoder(state["info"], state["setup"])
                except Exception:
                    my_events.append(("A", "fail"))
                    return
            try:
                ret = dec.decode_packet(p.data)
                my_events.append(("S", 1 if ret == 1 else 0))
                mine.append(np.concatenate(
                    [x.reshape(-1) for x in dec.ycbcr_out()]))
            except Exception:
                my_events.append(("S", -1))

    def _alarm(signum, frame):
        raise TimeoutError

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(60)
    try:
        _drive()
    except TimeoutError:
        return desc, "our driver hung >60s"
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)

    # Header codes compare EXACTLY; decode statuses compare by category
    # (the data-packet campaign already pins those codes).
    def norm(ev):
        return [(k, ("bad" if v < 0 else "dup" if v == 1 else "ok")
                 if k == "S" else v) for k, v in ev]

    if norm(ref_events) != norm(my_events):
        return desc, (f"event divergence: ref {ref_events} "
                      f"vs ours {my_events}")
    ref = np.fromfile(tmp + ".yuv", np.uint8)
    mine_all = (np.concatenate(mine) if mine else np.zeros(0, np.uint8))
    if len(ref) != len(mine_all):
        return desc, f"length {len(ref)} vs {len(mine_all)}"
    if not np.array_equal(ref, mine_all):
        return desc, f"bytes differ at {int(np.argmax(ref != mine_all))}"
    return desc, None


def run_synth_trial(rng, trial, tmp=None):
    """LEGAL-but-RD-atypical streams: random coding plans (modes, MVs,
    qi triples, per-block qii, sparse coefficients) packed through
    Encoder.pack_frame_plan -- structurally valid bitstreams no
    rate-distortion-driven encoder would ever emit (all-GOLDEN frames,
    saturated MVs, maximal-magnitude coefficients, adversarial qi
    RLEs).  Both decoders must still agree byte-for-byte.  This covers
    the legal-stream space the encoder-driven directions cannot reach
    (a substitute for outside test streams, which need a download)."""
    tmp = tmp or _tmp_path("sy")
    from theora_tpu.constants import (
        FRAME_FOR_MODE,
        FRAME_NONE,
        FRAME_SELF,
        MODE_INTER_MV_FOUR,
    )
    from theora_tpu.tpkt import Packet

    fw = int(rng.choice([32, 48, 64, 80]))
    fh = int(rng.choice([32, 48, 64]))
    fmt = int(rng.choice([0, 2, 3]))
    nfr = int(rng.randint(2, 6))
    desc = f"SYNTH {fw}x{fh} fmt{fmt} n{nfr}"
    info = TheoraInfo(
        frame_width=fw, frame_height=fh, pic_width=fw, pic_height=fh,
        fps_numerator=30, fps_denominator=1, quality=40,
        keyframe_granule_shift=6, pixel_fmt=fmt,
    )
    enc = Encoder(info)
    g = enc.geometry
    nfrags = g.nfrags
    hd = enc.flush_headers()
    pkts = list(hd)

    def rand_qis():
        k = int(rng.randint(1, 4))
        qs = list(rng.choice(64, size=k, replace=False))
        return [int(q) for q in qs]

    def rand_qdct(coded):
        qdct = np.zeros((nfrags, 64), np.int16)
        idx = np.nonzero(coded)[0]
        # Sparse values incl. extremes of every value-token category.
        for i in idx:
            nnz = int(rng.randint(0, 12))
            pos = rng.choice(64, size=nnz, replace=False)
            mags = rng.choice(
                [1, 2, 3, 6, 7, 8, 12, 20, 36, 68, 69, 580], size=nnz
            )
            sgn = rng.choice([-1, 1], size=nnz)
            qdct[i, pos] = (mags * sgn).astype(np.int16)
        return qdct

    pno = 3
    for f in range(nfr):
        qis = rand_qis()
        frag_qii = (
            rng.randint(0, len(qis), nfrags).astype(np.int32)
            if len(qis) > 1 else None
        )
        if f == 0:
            coded = np.zeros(nfrags, bool)
            coded[g.scan_fragis] = True
            frag_refi = np.where(coded, FRAME_SELF, FRAME_NONE).astype(np.int32)
            data = enc.pack_frame_plan(
                0, coded, frag_refi, None, None, rand_qdct(coded),
                qis=qis if len(qis) > 1 else None, frag_qii=frag_qii,
            )
        else:
            coded = rng.rand(nfrags) < rng.uniform(0.15, 0.95)
            mb_modes = np.zeros(g.nmbs, np.int32)
            mb_mvs = np.zeros((g.nmbs, 2), np.int32)
            frag_refi = np.full(nfrags, FRAME_NONE, np.int32)
            fmv4 = np.zeros((nfrags, 2), np.int32)
            for mbi in range(g.nmbs):
                if not g.mb_valid[mbi]:
                    continue
                mode = int(rng.randint(0, 8))
                mb_modes[mbi] = mode
                mb_mvs[mbi] = rng.randint(-31, 32, 2)
                for p in range(3):
                    for bi in range(4):
                        fi = g.mb_maps[mbi, p, bi]
                        if fi >= 0 and coded[fi]:
                            frag_refi[fi] = FRAME_FOR_MODE[mode]
                if mode == MODE_INTER_MV_FOUR:
                    for bi in range(4):
                        fi = g.mb_maps[mbi, 0, bi]
                        if fi >= 0:
                            fmv4[fi] = rng.randint(-31, 32, 2)
            frag_refi[~coded] = FRAME_NONE
            enc._frag_mv4 = fmv4
            data = enc.pack_frame_plan(
                1, coded, frag_refi, mb_modes, mb_mvs, rand_qdct(coded),
                qis=qis if len(qis) > 1 else None, frag_qii=frag_qii,
            )
        shift = info.keyframe_granule_shift
        pkts.append(Packet(
            data, granulepos=(1 << shift) + f, packetno=pno,
            e_o_s=(f == nfr - 1),
        ))
        pno += 1

    write_tpkt(tmp + ".tpkt", pkts)
    # Random postproc level: the out-of-loop deblock/dering filters key
    # their strength off the per-block qi (the qi RLE this direction
    # randomizes adversarially), so pp on RD-atypical streams covers
    # strength combinations no encoder-driven trial produces.
    pp = int(rng.choice([0, 0, 2, 5, 7]))
    cmd = [REF_DEC, tmp + ".tpkt", tmp + ".yuv"]
    if pp:
        cmd.append(str(pp))
        desc += f" pp{pp}"
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if "decoded" not in (r.stdout + r.stderr):
        return desc, f"reference decoder rejected: {r.stderr[-80:]}"
    dec = Decoder(parse_info_header(hd[0].data),
                  parse_setup_header(hd[2].data))
    if pp:
        dec.set_pplevel(pp)
    mine = []
    for p in pkts[3:]:
        dec.decode_packet(p.data)
        mine.append(
            np.concatenate([x.reshape(-1) for x in dec.ycbcr_out()])
        )
    ref = np.fromfile(tmp + ".yuv", np.uint8)
    mine_all = np.concatenate(mine)
    if len(ref) != len(mine_all):
        return desc, f"length {len(ref)} vs {len(mine_all)}"
    if not np.array_equal(ref, mine_all):
        return desc, f"bytes differ at {int(np.argmax(ref != mine_all))}"
    return desc, None


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    reverse = "--reverse" in argv
    device = "--device" in argv
    fuzz = "--fuzz" in argv
    synth = "--synth" in argv
    hdr = "--hdr" in argv
    if reverse:
        argv.remove("--reverse")
    if device:
        argv.remove("--device")
    if fuzz:
        argv.remove("--fuzz")
    if synth:
        argv.remove("--synth")
    if hdr:
        argv.remove("--hdr")
    trials = int(argv[0]) if argv else 40
    seed = int(argv[1]) if len(argv) > 1 else 42
    rng = np.random.RandomState(seed)
    fails = 0
    fn = (run_reverse_trial if reverse
          else run_device_trial if device
          else run_fuzz_trial if fuzz
          else run_synth_trial if synth
          else run_hdr_fuzz_trial if hdr else run_trial)
    for t in range(trials):
        desc, err = fn(rng, t)
        if err:
            fails += 1
            print(f"FAIL {desc}: {err}")
    which = ("reference encodes" if reverse
             else "device-tier encodes" if device
             else "mutated streams" if fuzz
             else "synthetic random plans" if synth
             else "mutated headers" if hdr else "our encodes")
    print(f"{trials - fails}/{trials} trials bit-identical "
          f"(reference decoder vs ours, on {which})")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
