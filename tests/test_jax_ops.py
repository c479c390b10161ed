"""JAX device op twins must be bit-exact vs the numpy reference ops (which are
themselves validated against the C reference)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from theora_tpu.ops import idct_np, fdct_np  # noqa: E402
from theora_tpu.ops import transforms_jax as tj  # noqa: E402


def test_idct_jax_matches_numpy():
    rng = np.random.RandomState(3)
    x = rng.randint(-8100, 8101, size=(256, 8, 8)).astype(np.int32)
    ref = idct_np.idct8x8_batch(x)
    out = np.asarray(jax.jit(tj.idct8x8)(jnp.asarray(x)))
    assert np.array_equal(out, ref)


def test_fdct_jax_matches_numpy():
    rng = np.random.RandomState(4)
    x = rng.randint(-255, 256, size=(256, 8, 8)).astype(np.int64)
    ref = fdct_np.fdct8x8_batch(x)
    out = np.asarray(jax.jit(tj.fdct8x8)(jnp.asarray(x, dtype=jnp.int32)))
    assert np.array_equal(out, ref)


def test_quantize_jax_matches_numpy():
    rng = np.random.RandomState(5)
    dct = rng.randint(-6000, 6001, size=(128, 64)).astype(np.int32)
    deq = rng.randint(8, 4097, size=(64,)).astype(np.uint16)
    ref = fdct_np.quantize_batch(dct, deq)
    out = np.asarray(
        jax.jit(tj.quantize)(jnp.asarray(dct), jnp.asarray(deq.astype(np.int32)))
    )
    assert np.array_equal(out, ref)


def test_dc_fill_jax():
    rng = np.random.RandomState(6)
    dc = rng.randint(-580, 581, size=(64,))
    q = rng.randint(16, 4097, size=(64,))
    ref = idct_np.dc_fill_batch(dc, q)
    out = np.asarray(jax.jit(tj.dc_fill)(jnp.asarray(dc, jnp.int32), jnp.asarray(q, jnp.int32)))
    assert np.array_equal(out, ref)


def test_jax_loop_filter_matches_scalar():
    from theora_tpu.ops.loopfilter_np import (
        build_bounding_values,
        loop_filter_plane,
    )
    from theora_tpu.ops.loopfilter_jax import loop_filter_plane_jax

    rng = np.random.RandomState(17)
    nv, nh, pad = 5, 7, 16
    img = rng.randint(0, 256, size=(nv * 8 + 2 * pad, nh * 8 + 2 * pad)).astype(
        np.uint8
    )
    coded = rng.rand(nv, nh) < 0.6
    bv = build_bounding_values(40)
    a = img.copy()
    loop_filter_plane(a, coded, bv)
    b = np.asarray(
        loop_filter_plane_jax(
            jnp.asarray(img), jnp.asarray(coded),
            jnp.asarray(bv.astype(np.int32)), nv, nh, pad, pad,
        )
    )
    assert np.array_equal(a, b)


def test_tpu_decoder_pipeline_bit_exact():
    import os

    from tests.conftest import TESTDATA
    from theora_tpu.decode.tpu_decoder import TpuDecoder
    from theora_tpu.headers import parse_info_header, parse_setup_header
    from theora_tpu.tpkt import read_tpkt

    name = "clip64x48_k8_q5"
    pkts = read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)
    dec = TpuDecoder(info, setup)
    ref = np.fromfile(
        os.path.join(TESTDATA, f"{name}.ref.yuv"), dtype=np.uint8
    ).reshape(len(pkts) - 3, -1)
    for i, p in enumerate(pkts[3:]):
        dec.decode_packet(p.data)
        mine = np.concatenate([x.reshape(-1) for x in dec.ycbcr_out()])
        assert np.array_equal(mine, ref[i]), f"frame {i}"


def test_fdct_jax_batched_leading_dims():
    """fdct8x8 must be correct with extra leading batch dims (the batched
    multi-frame path used by bench.py / parallel.gop): the systematic-
    error biases index the last two axes, not absolute positions."""
    rng = np.random.RandomState(8)
    x = rng.randint(-255, 256, size=(3, 5, 40, 8, 8)).astype(np.int64)
    ref = fdct_np.fdct8x8_batch(x.reshape(-1, 8, 8)).reshape(3, 5, 40, 64)
    out = np.asarray(jax.jit(tj.fdct8x8)(jnp.asarray(x, dtype=jnp.int32)))
    assert np.array_equal(out, ref)


def test_tpu_batch_intra_encoder_byte_identical():
    """TpuBatchIntraEncoder (device fDCT+quantize, host entropy) must be
    byte-identical to the pure-host Encoder at keyframe_freq=1."""
    import os

    from tests.conftest import TESTDATA
    from theora_tpu.encode.encoder import Encoder
    from theora_tpu.encode.tpu_encoder import TpuBatchIntraEncoder
    from theora_tpu.info import TheoraInfo

    W, H = 64, 48
    raw = np.fromfile(os.path.join(TESTDATA, "clip64x48.i420"), np.uint8)
    fsz = W * H * 3 // 2
    frames = []
    for i in range(4):
        f = raw[i * fsz : (i + 1) * fsz]
        frames.append(
            [
                f[: W * H].reshape(H, W),
                f[W * H : W * H + fsz // 6].reshape(H // 2, W // 2),
                f[W * H + fsz // 6 :].reshape(H // 2, W // 2),
            ]
        )
    info = TheoraInfo(
        frame_width=W, frame_height=H, pic_width=W, pic_height=H, quality=40
    )
    host = Encoder(info)
    host.keyframe_freq = 1
    host.flush_headers()
    hp = [host.encode_frame(fr).data for fr in frames]
    dev = TpuBatchIntraEncoder(info)
    dev.flush_headers()
    dp = [p.data for p in dev.encode(frames)]
    assert hp == dp


def test_tpu_batch_decoder_bit_exact():
    """GOP-batch device decode (one lax.scan per plane over all frames)
    must match the golden streams bit-for-bit."""
    import os

    from tests.conftest import TESTDATA
    from theora_tpu.decode.tpu_batch import TpuBatchDecoder
    from theora_tpu.headers import parse_info_header, parse_setup_header
    from theora_tpu.tpkt import read_tpkt

    for name in ("cif_k4_q40", "clip64x48_k8_q5"):
        pkts = read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
        dec = TpuBatchDecoder(
            parse_info_header(pkts[0].data), parse_setup_header(pkts[2].data)
        )
        outs = dec.decode_batch([p.data for p in pkts[3:]])
        ref = np.fromfile(
            os.path.join(TESTDATA, f"{name}.ref.yuv"), dtype=np.uint8
        ).reshape(len(pkts) - 3, -1)
        for i, o in enumerate(outs):
            mine = np.concatenate([x.reshape(-1) for x in o])
            assert np.array_equal(mine, ref[i]), f"{name} frame {i}"


def test_tpu_batch_decoder_chained_batches():
    """Reference planes stay device-resident across decode_batch calls
    (donated buffers): splitting a stream into several batches must be
    byte-identical to one batch and to the golden yuv."""
    import os

    from tests.conftest import TESTDATA
    from theora_tpu.decode.tpu_batch import TpuBatchDecoder
    from theora_tpu.headers import parse_info_header, parse_setup_header
    from theora_tpu.tpkt import read_tpkt

    name = "cif_k4_q40"
    pkts = read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    dec = TpuBatchDecoder(
        parse_info_header(pkts[0].data), parse_setup_header(pkts[2].data)
    )
    data = [p.data for p in pkts[3:]]
    outs = []
    # Uneven chunking on purpose: batch boundaries mid-GOP.
    for lo, hi in ((0, 3), (3, 7), (7, len(data))):
        outs.extend(dec.decode_batch(data[lo:hi]))
    ref = np.fromfile(
        os.path.join(TESTDATA, f"{name}.ref.yuv"), dtype=np.uint8
    ).reshape(len(data), -1)
    for i, o in enumerate(outs):
        mine = np.concatenate([x.reshape(-1) for x in o])
        assert np.array_equal(mine, ref[i]), f"frame {i}"
    # sync_refs_to_host lets the scalar path continue the stream.
    dec.sync_refs_to_host()


def test_tpu_batch_decoder_pipelined_clip():
    """decode_clip (two-deep dispatch with async device->host copies)
    must equal the SCALAR decoder frame-for-frame -- not just
    decode_batch, which could share a flaw -- including a dup packet
    that is the FIRST packet of a chunk (must repeat the previous
    chunk's last frame, not this chunk's first live frame), a
    mid-chunk dup, and a whole dup-only chunk."""
    import os

    from tests.conftest import TESTDATA
    from theora_tpu.decode.decoder import Decoder
    from theora_tpu.decode.tpu_batch import TpuBatchDecoder
    from theora_tpu.headers import parse_info_header, parse_setup_header
    from theora_tpu.tpkt import read_tpkt

    name = "cif_k4_q40"
    pkts = read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)

    # Dups at a chunk boundary (index 3 = first packet of chunk 1 at
    # batch=3), mid-chunk (index 5), and a dup-only chunk (6,7,8).
    data = [p.data for p in pkts[3:]]
    data = data[:3] + [b""] + data[3:4] + [b""] + [b"", b"", b""] + data[4:]

    truth = []
    dref = Decoder(info, setup)
    for d in data:
        dref.decode_packet(d)
        truth.append(dref.ycbcr_out())

    a = TpuBatchDecoder(info, setup).decode_clip(data, batch=3)
    b = []
    d2 = TpuBatchDecoder(info, setup)
    for lo in range(0, len(data), 3):
        b.extend(d2.decode_batch(data[lo:lo + 3]))
    assert len(a) == len(b) == len(truth) == len(data)
    for i, (fa, fb, ft) in enumerate(zip(a, b, truth)):
        for pa, pb, pt in zip(fa, fb, ft):
            assert np.array_equal(pa, pt), f"clip frame {i} vs scalar"
            assert np.array_equal(pb, pt), f"batch frame {i} vs scalar"
