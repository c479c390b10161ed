"""JAX/XLA device implementations of the codec transforms.

Bit-exact integer twins of the numpy ops (idct_np.py, fdct_np.py):
all arithmetic in int32 with explicit int16 wraparound where the spec has
int16 stores, so results match the C reference exactly. Batched over all
fragments of a frame -- the batched replacement for the reference's
per-block SIMD kernels (lib/x86/*, lib/arm/*).

These run under jit as elementwise integer ops, and XLA
fuses the whole transform chain into a handful of kernels.
"""
from __future__ import annotations

import jax.numpy as jnp

from theora_tpu.constants import (
    C1S7,
    C2S6,
    C3S5,
    C4S4,
    C5S3,
    C6S2,
    C7S1,
    ZIGZAG_TO_NAT,
)
from theora_tpu.debug import DEBUG as _DBG


def _i16(x):
    """int16 wraparound in int32 domain.

    On legal streams the wrap is the identity; THEORA_TPU_DEBUG=1 arms
    an assertion that it stayed one (theora_tpu/debug.py)."""
    w = ((x + 0x8000) & 0xFFFF) - 0x8000
    if _DBG:
        from theora_tpu.debug import check_wrap

        w = check_wrap(w, x, "transforms_jax._i16")
    return w


def _mul16(c, x):
    """(c * x) >> 16 with c a small positive constant, exact vs C int32."""
    return (c * x) >> 16


def idct8(x):
    """1-D 8-point iDCT along the last axis (idct.c:30-81); int32."""
    t0 = _mul16(C4S4, _i16(x[..., 0] + x[..., 4]))
    t1 = _mul16(C4S4, _i16(x[..., 0] - x[..., 4]))
    t2 = _mul16(C6S2, x[..., 2]) - _mul16(C2S6, x[..., 6])
    t3 = _mul16(C2S6, x[..., 2]) + _mul16(C6S2, x[..., 6])
    t4 = _mul16(C7S1, x[..., 1]) - _mul16(C1S7, x[..., 7])
    t5 = _mul16(C3S5, x[..., 5]) - _mul16(C5S3, x[..., 3])
    t6 = _mul16(C5S3, x[..., 5]) + _mul16(C3S5, x[..., 3])
    t7 = _mul16(C1S7, x[..., 1]) + _mul16(C7S1, x[..., 7])
    r = t4 + t5
    t5 = _mul16(C4S4, _i16(t4 - t5))
    t4 = r
    r = t7 + t6
    t6 = _mul16(C4S4, _i16(t7 - t6))
    t7 = r
    r = t0 + t3
    t3 = t0 - t3
    t0 = r
    r = t1 + t2
    t2 = t1 - t2
    t1 = r
    r = t6 + t5
    t5 = t6 - t5
    t6 = r
    return jnp.stack(
        [
            _i16(t0 + t7),
            _i16(t1 + t6),
            _i16(t2 + t5),
            _i16(t3 + t4),
            _i16(t3 - t4),
            _i16(t2 - t5),
            _i16(t1 - t6),
            _i16(t0 - t7),
        ],
        axis=-1,
    )


def idct8x8(coeffs):
    """Dense 2-D iDCT: [N, 8, 8] int32 natural-order coefficients ->
    [N, 8, 8] residuals (idct.c:285-296)."""
    w = jnp.swapaxes(idct8(coeffs), -1, -2)
    y = jnp.swapaxes(idct8(w), -1, -2)
    return _i16(y + 8 >> 4)


def dc_fill(dc, dc_quant):
    """[N] -> [N, 8, 8]: DC-only blocks (state.c:967-975)."""
    p = _i16(dc * dc_quant + 15 >> 5)
    return jnp.broadcast_to(p[:, None, None], (*p.shape, 8, 8))


def fdct8(x):
    """1-D 8-point fDCT along the last axis (fdct.c:27-120); int32."""
    t0 = x[..., 0] + x[..., 7]
    t7 = x[..., 0] - x[..., 7]
    t1 = x[..., 1] + x[..., 6]
    t6 = x[..., 1] - x[..., 6]
    t2 = x[..., 2] + x[..., 5]
    t5 = x[..., 2] - x[..., 5]
    t3 = x[..., 3] + x[..., 4]
    t4 = x[..., 3] - x[..., 4]
    r = t0 + t3
    t3 = t0 - t3
    t0 = r
    r = t1 + t2
    t2 = t1 - t2
    t1 = r
    r = t6 + t5
    t5 = t6 - t5
    t6 = r
    nz = lambda t: (t != 0).astype(jnp.int32)
    s = ((27146 * t5 + 0xB500) >> 16) + t5 + nz(t5) >> 1
    r = t4 + s
    t5 = t4 - s
    t4 = r
    s = ((27146 * t6 + 0xB500) >> 16) + t6 + nz(t6) >> 1
    r = t7 + s
    t6 = t7 - s
    t7 = r
    r = ((27146 * t0 + 0x4000) >> 16) + t0 + nz(t0)
    s = ((27146 * t1 + 0xB500) >> 16) + t1 + nz(t1)
    u = r + s >> 1
    v = r - u
    y0, y4 = u, v
    u = ((C6S2 * t2 + C2S6 * t3 + 0x6CB7) >> 16) + nz(t3)
    s = ((C6S2 * u) >> 16) - t2
    v = ((s * 21600 + 0x2800) >> 18) + s + nz(s)
    y2, y6 = u, v
    u = ((C5S3 * t6 + C3S5 * t5 + 0x0E3D) >> 16) + nz(t5)
    s = t6 - ((C5S3 * u) >> 16)
    v = ((s * 26568 + 0x3400) >> 17) + s + nz(s)
    y5, y3 = u, v
    u = ((C7S1 * t4 + C1S7 * t7 + 0x7B1B) >> 16) + nz(t7)
    s = ((C7S1 * u) >> 16) - t4
    v = ((s * 20539 + 0x3000) >> 20) + s + nz(s)
    y1, y7 = u, v
    return _i16(jnp.stack([y0, y1, y2, y3, y4, y5, y6, y7], axis=-1))


# Keep as a host numpy constant: a module-level device array would be
# committed to the default backend at import time and force transfers when
# used from another backend's jit.
import numpy as np  # noqa: E402

_ZZ = np.asarray(ZIGZAG_TO_NAT[:64])


def fdct8x8(res):
    """[..., N, 8, 8] residuals -> [..., N, 64] zig-zag DCT coefficients
    (fdct.c:128-154); any leading batch dims."""
    w = res.astype(jnp.int32) << 2
    w = w.at[..., 0, 0].add((w[..., 0, 0] != 0).astype(jnp.int32) + 1)
    w = w.at[..., 0, 1].add(1)
    w = w.at[..., 1, 0].add(-1)
    y = fdct8(jnp.swapaxes(w, -1, -2))
    w2 = fdct8(jnp.swapaxes(y, -1, -2))
    flat = w2.reshape(*w2.shape[:-2], 64)
    return _i16(flat[..., _ZZ] + 2 >> 2)


def quantize(dct_zz, dequant_zz):
    """Round-to-nearest quantizer (enquant.c:220-249); int32."""
    d = dequant_zz.astype(jnp.int32)
    v2 = jnp.abs(dct_zz) << 1
    q = (v2 + d) // (2 * d)
    q = jnp.where(v2 >= d, q, 0)
    return jnp.sign(dct_zz) * q


# Token-cost model of the R/D quantizer (ops/fdct_np.py _MAG_BITS).
_MAG_BITS_J = np.array(
    [0.0, 4.5, 5.5, 6.5, 6.5, 7.5, 7.5, 8.5, 9.5], dtype=np.float32
)


def quantize_rd(dct_zz, dequant_zz, lam):
    """JAX twin of ops/fdct_np.quantize_rd_batch: per-AC-coefficient
    magnitude reduction, isolated-coefficient kill and tail kill, each
    accepted when it wins d^2 + lambda*bits.  Errors are evaluated in
    float32 (deterministic elementwise IEEE ops, so results are identical
    across backends and mesh shardings; the closed loop reconstructs from
    whatever this returns, so bitstream validity never depends on the
    decisions).

    dct_zz/dequant_zz: [N, 64] int32; lam: [N] float32.  Returns [N, 64]
    int32.
    """
    q0 = quantize(dct_zz, dequant_zz)
    d = dequant_zz.astype(jnp.float32)
    av = jnp.abs(dct_zz).astype(jnp.float32)
    lamc = lam[:, None]
    a0 = jnp.abs(q0)
    a1 = jnp.maximum(a0 - 1, 0)
    mb = jnp.asarray(_MAG_BITS_J)
    err0 = (a0.astype(jnp.float32) * d - av) ** 2
    err1 = (a1.astype(jnp.float32) * d - av) ** 2
    bits0 = mb[jnp.minimum(a0, 8)]
    bits1 = mb[jnp.minimum(a1, 8)]
    take1 = err1 + lamc * bits1 <= err0 + lamc * bits0
    out = jnp.where(take1, jnp.sign(q0) * a1, q0)
    out = out.at[:, 0].set(q0[:, 0])  # never degrade DC
    # Isolated kill: a lone +-1 between zeros costs a whole run+value
    # token; two sweeps so newly isolated coefficients get a chance.
    ISO_BITS = jnp.float32(11.0)
    err_coded = (d - av) ** 2
    err_zero = av * av
    for _ in range(2):
        nz = out != 0
        left_zero = jnp.ones_like(nz).at[:, 2:].set(~nz[:, 1:-1])
        right_zero = jnp.ones_like(nz).at[:, :-1].set(~nz[:, 1:])
        iso = nz & left_zero & right_zero & (jnp.abs(out) == 1)
        iso = iso.at[:, 0].set(False)
        kill = iso & (err_zero - err_coded <= lamc * ISO_BITS)
        out = jnp.where(kill, 0, out)
    # Tail kill: dropping a block's last nonzero +-1 removes a token and
    # usually merges EOB runs.
    TAIL_BITS = jnp.float32(14.0)
    rows = jnp.arange(out.shape[0])
    for _ in range(4):
        nz = out != 0
        nz = nz.at[:, 0].set(False)
        has = nz.any(axis=1)
        last = 63 - jnp.argmax(nz[:, ::-1], axis=1)
        q_at = out[rows, last]
        d_at = d[rows, last]
        v_at = av[rows, last]
        ec = (jnp.abs(q_at).astype(jnp.float32) * d_at - v_at) ** 2
        ez = v_at * v_at
        kill = has & (jnp.abs(q_at) == 1) & (ez - ec <= lam * TAIL_BITS)
        out = out.at[rows, last].set(jnp.where(kill, 0, q_at))
    return out


# ---------------------------------------------------------------------------
# Batched trellis quantizer: the device counterpart of the host Viterbi
# tokenizer (encode/tokenize.py trellis_plan, a re-derivation of
# tokenize.c:457-744).  Key reformulation: the reference's DP walks
# sparse linked node chains per block; here the run transitions are DENSE
# -- every position considers all 64 run ends at once, with masked costs
# -- so the whole frame's blocks advance through one 63-step lax.scan of
# elementwise [N, 64] work.  Only the chosen quantized VALUES leave the
# DP (the host re-derives the token structure greedily from values, which
# matches the DP's structural choices except on pathological Huffman
# costs), so the result plugs into the closed loop and the existing
# sparse download unchanged.  Dense run transitions may zero |q|>=2
# coefficients (the reference's chains only pass |q|<=1) -- a superset of
# its moves, charging the exact c^2 distortion, so plans are never worse.
# Costs are float32 (deterministic elementwise IEEE ops -> identical
# decisions across backends and mesh shardings at fixed shapes).

# Plain Python float: a module-level jnp scalar would be a concrete
# device array on the import-time default backend and get hoisted into
# every consuming executable as a hidden parameter (see the numpy-only
# note above _ZZ).
_BIG = 1e30


def _value_token_id(mag, neg):
    """Token id of a lone coefficient of magnitude mag (>=1); sign picks
    9/10 and 11/12 (tokenize.c:52-232 category layout)."""
    t = jnp.where(mag <= 2, 9 + (mag - 1) * 2 + neg, 0)
    t = jnp.where((mag >= 3) & (mag <= 6), 10 + mag, t)
    t = jnp.where((mag >= 7) & (mag <= 8), 17, t)
    t = jnp.where((mag >= 9) & (mag <= 12), 18, t)
    t = jnp.where((mag >= 13) & (mag <= 20), 19, t)
    t = jnp.where((mag >= 21) & (mag <= 36), 20, t)
    t = jnp.where((mag >= 37) & (mag <= 68), 21, t)
    return jnp.where(mag >= 69, 22, t)


def _alt_mag(mag):
    """Top of the next-lower value-token category: the largest magnitude
    with a strictly cheaper token (tokenize.py _ALT_QC)."""
    alt = jnp.where(mag <= 6, mag - 1, 0)
    alt = jnp.where((mag >= 7) & (mag <= 8), 6, alt)
    alt = jnp.where((mag >= 9) & (mag <= 12), 8, alt)
    alt = jnp.where((mag >= 13) & (mag <= 20), 12, alt)
    alt = jnp.where((mag >= 21) & (mag <= 36), 20, alt)
    alt = jnp.where((mag >= 37) & (mag <= 68), 36, alt)
    return jnp.where(mag >= 69, 68, alt)


def _nb_at(nb_t, tok):
    """nb_t [32] f32 bit costs; tok [N] int32 -> [N] f32 (one-hot matmul
    instead of a gather -- the table is tiny and gathers are slow)."""
    return (
        (jnp.arange(32)[None, :] == tok[:, None]) * nb_t[None, :]
    ).sum(axis=1)


def trellis_values(dct_zz, qdct_rtn, dequant_zz, lam, nb_full, acmin):
    """Jointly choose quantized values minimizing d^2 + lam*bits over the
    block's token structure (runs, combos, EOB placement).

    dct_zz:    [N, 64] int32 unquantized zig-zag coefficients.
    qdct_rtn:  [N, 64] int32 round-to-nearest quantization (the DP's
               candidate magnitudes, as in the reference).
    dequant_zz:[N, 64] int32.
    lam:       [N] f32 DCT-domain lambda (tables.RD_LAMBDA units).
    nb_full:   [64, 32] f32 bits per (stream position, token): Huffman
               code length + extra bits (encoder.py _trellis_nb expanded
               over positions).
    acmin:     [N] int32 -- positions below it code at lam=0
               (rate-free), the reference's intra low-frequency guard.
    Returns [N, 64] int32 chosen values (DC passed through).
    """
    import jax

    N = dct_zz.shape[0]
    cf = dct_zz.astype(jnp.float32)
    df = dequant_zz.astype(jnp.float32)
    q = qdct_rtn
    jcols = jnp.arange(64)
    idx = jnp.arange(63, 0, -1)        # DP visits positions 63..1
    # Zero-cost contribution per position: zeroing a coefficient costs
    # its full c^2 IF round-to-nearest would have coded it; already-zero
    # positions cost nothing on any path (constant, dropped).
    z = jnp.where(q != 0, cf * cf, 0.0)
    P = jnp.concatenate(
        [jnp.zeros((N, 1), jnp.float32), jnp.cumsum(z, axis=1)], axis=1
    )  # [N, 65]; D2(i, j) = P[:, j] - P[:, i]
    aj = jnp.abs(q)
    sj = jnp.where(q < 0, -1, 1)
    m23 = jnp.where(aj > 2, 3, 2)
    cv23 = sj * m23

    # ---- position-static precomputes (everything the 63-step scan
    # would otherwise redo: token ids, bit lookups, error products) ----
    # node1 candidates at every position: the round-to-nearest value and
    # one step down the token-category ladder.  Below acmin only VALUE
    # decisions go rate-free (the intra low-frequency guard); structural
    # run/EOB tokens keep their rate cost, as the reference does until
    # its lam mutation triggers (tokenize.c lam=0 sites are in the value
    # branches).
    lamv = jnp.where(jcols[None, :] < acmin[:, None], 0.0, lam[:, None])
    a_cl = jnp.minimum(aj, 580)
    neg = (q < 0).astype(jnp.int32)
    tokA = _value_token_id(jnp.maximum(a_cl, 1), neg)
    altm = _alt_mag(a_cl)
    tokB = _value_token_id(jnp.maximum(altm, 1), neg)

    def nb_lookup(tok):
        # [N, 64] token ids -> bits via one-hot against nb_full [64, 32]
        return (
            (tok[:, :, None] == jnp.arange(32)[None, None, :])
            * nb_full[None, :, :]
        ).sum(axis=2)

    eA = (a_cl * sj).astype(jnp.float32) * df - cf
    eB = (altm * sj).astype(jnp.float32) * df - cf
    cA_s = eA * eA + lamv * nb_lookup(tokA)
    cB_s = eB * eB + lamv * nb_lookup(tokB)
    useB = (altm >= 1) & (cB_s < cA_s)
    c1_s = jnp.where(aj >= 1, jnp.where(useB, cB_s, cA_s), _BIG)
    v1_s = jnp.where(aj >= 1, jnp.where(useB, altm * sj, a_cl * sj), 0)
    # Combo-at-j error bases with value-range validity folded in.
    e1j = cf - sj.astype(jnp.float32) * df
    e23j = cf - cv23.astype(jnp.float32) * df
    pre1 = jnp.where((aj >= 1) & (aj <= 2), e1j * e1j, _BIG)
    pre23 = jnp.where((aj >= 2) & (aj <= 4), e23j * e23j, _BIG)
    # EOB cost per start position (nb_full[.., 0] varies only through
    # the stream-position group; use each start's own row like nb(i, 0)).
    costc_s = (P[:, 64:] - P[:, :64]) + lam[:, None] * nb_full[:, 0][None]
    # Per-step [64] rows: structural token bits and validity by run
    # length r = j - i, with the i==1 dc_reserve (one slot of headroom
    # so a zero DC can extend the block's leading run at emission).
    r_si = jcols[None, :] - idx[:, None]               # [63, 64]
    maskj_si = r_si > 0
    zb_si = jnp.where(r_si <= 8, nb_full[idx, 7:8], nb_full[idx, 8:9])
    amask_si = jnp.where(maskj_si, 0.0, _BIG)
    cb1_si = jnp.where(r_si <= 5, nb_full[idx][:, 22:23], 0.0)
    for rr, ti in ((1, 23), (2, 24), (3, 25), (4, 26), (5, 27)):
        cb1_si = jnp.where(r_si == rr, nb_full[idx, ti][:, None], cb1_si)
    cb1_si = jnp.where(
        (r_si >= 6) & (r_si <= 9), nb_full[idx, 28][:, None], cb1_si
    )
    cb1_si = jnp.where(r_si >= 10, nb_full[idx, 29][:, None], cb1_si)
    dc_allow = jnp.where(idx == 1, 0, 1)[:, None]
    b1mask_si = jnp.where(
        maskj_si & (r_si <= 16 + dc_allow), 0.0, _BIG
    )
    cb23_si = jnp.where(
        r_si == 1, nb_full[idx, 30][:, None], nb_full[idx, 31][:, None]
    )
    b23mask_si = jnp.where(
        maskj_si & (r_si <= 2 + dc_allow), 0.0, _BIG
    )

    # Decision word per position (one int32, emitted as a scan output --
    # minimal carry traffic and a 1-reduction backtrack):
    #   bits  0..10  node1 value + 1024
    #   bit   11     node1 successor node (best1 at i+1)
    #   bits 12..13  node0 ending: 0 EOB, 1 run+value, 2 combo +-1,
    #                3 combo +-2/3
    #   bits 14..19  node0 run end position zzj
    #   bits 20..30  node0 combo value + 1024
    #   (node0's successor bit is recomputed cheaply at backtrack time
    #    from the packed word at zzj)
    def dp_step(carry, xs):
        # c0p/c1p: the previous step's column (position i+1) -- the scan
        # runs i descending, so no dynamic carry reads are needed.
        cost0, cost1, c0p, c1p = carry
        (i, c1col, v1col, P_i, costc, zb_row, amask_row, cb1_row,
         b1mask_row, cb23_row, b23mask_row) = xs
        bn_next = jnp.minimum(c0p, c1p)
        next1 = (c1p < c0p).astype(jnp.int32)
        # ---- node1: coded nonzero at i -------------------------------
        c1 = c1col + bn_next
        # ---- node0: zero run starting at i, all 64 ends at once ------
        D2 = P[:, :64] - P_i[:, None]
        lamc = lam[:, None]
        costa = D2 + (lamc * zb_row[None, :] + amask_row[None, :]) + cost1
        bn = jnp.minimum(cost0, cost1)
        bn_nextj = jnp.concatenate([bn[:, 1:], bn[:, :1]], axis=1)
        cost_b1 = (
            pre1 + D2 + (lamc * cb1_row[None, :] + b1mask_row[None, :])
            + bn_nextj
        )
        cost_b23 = (
            pre23 + D2 + (lamc * cb23_row[None, :] + b23mask_row[None, :])
            + bn_nextj
        )
        m_b = jnp.minimum(cost_b1, cost_b23)
        m_j = jnp.minimum(costa, m_b)
        jbest = jnp.argmin(m_j, axis=1)
        cbest = jnp.min(m_j, axis=1)
        oh = jcols[None, :] == jbest[:, None]
        typ_j = jnp.where(
            costa <= m_b, 1, jnp.where(cost_b1 <= cost_b23, 2, 3)
        )
        typ_at = (jnp.where(oh, typ_j, 0)).sum(axis=1)
        cv_j = jnp.where(typ_j == 3, cv23, sj)
        cv_at = (jnp.where(oh, cv_j, 0)).sum(axis=1)
        use_eob = costc <= cbest
        c0 = jnp.where(use_eob, costc, cbest)
        e0 = jnp.where(use_eob, 0, typ_at)
        word = (
            (v1col + 1024)
            | (next1 << 11)
            | (e0 << 12)
            | (jnp.where(use_eob, 0, jbest) << 14)
            | ((cv_at + 1024) << 20)
        )
        # ---- write column i ------------------------------------------
        def upd(A, v):
            return jax.lax.dynamic_update_slice_in_dim(
                A, v[:, None].astype(A.dtype), i, axis=1
            )

        return (upd(cost0, c0), upd(cost1, c1), c0, c1), word

    carry0 = (
        jnp.full((N, 64), _BIG).at[:, 0].set(0.0),   # col 0 = end sentinel
        jnp.full((N, 64), _BIG),
        jnp.zeros((N,), jnp.float32),                # cost at the wrapped
        jnp.full((N,), _BIG),                        # successor of 63 = 0
    )
    xs = (
        idx, c1_s.T[idx], v1_s.T[idx], P.T[idx], costc_s.T[idx],
        zb_si, amask_si, cb1_si, b1mask_si, cb23_si, b23mask_si,
    )
    (cost0, cost1, _, _), words = jax.lax.scan(
        dp_step, carry0, xs, unroll=4
    )

    # ---- backtrack: position-ordered event sweep ----------------------
    # Every winning path visits strictly increasing positions (node1
    # advances pos -> pos+1; a node0 run from i ends at some j > i), so
    # instead of chasing per-block pointers with one-hot [N, 64] reads
    # and writes (the scan's single hottest stage in the 720p trace),
    # sweep positions 1..63 once: each block carries its next event
    # (position, node kind, pending combo value) in [N] vectors, and the
    # step at position p consumes only that position's decision words --
    # a static row of the forward scan's output.  Emits out's row p as a
    # scan output, so no [N, 64] tensor is touched per step at all.
    node0_ = cost1[:, 1] < cost0[:, 1]

    def bt_step(carry, xs):
        ep, nd, runend, pend, take = carry
        p, w = xs
        v1 = (w & 0x7FF) - 1024
        nxt1 = (w >> 11) & 1
        er = (w >> 12) & 3
        jr = (w >> 14) & 63
        cv = ((w >> 20) & 0x7FF) - 1024
        at = ep == p
        isn = at & ~runend          # node event at p
        isr = at & runend           # a pending zero-run ends at p
        n1 = isn & (nd == 1)        # coded value at p
        n0 = isn & (nd == 0)
        run = n0 & (er != 0)        # start a run ending at jr
        # er == 0 at a node0 event is EOB: the block goes inactive.
        # Values written at p: node1's value, or the run's terminal
        # value -- the combo value carried from the run's start, or
        # (er == 1 there) the value field of THIS position's word.
        row = jnp.where(
            n1, v1, jnp.where(isr, jnp.where(take, v1, pend), 0)
        )
        adv = n1 | isr              # next event is the node at p + 1
        ep = jnp.where(adv, p + 1, jnp.where(run, jr, 0 * ep))
        ep = jnp.where(at, ep, carry[0])
        nd = jnp.where(adv, nxt1, nd)
        runend = jnp.where(at, run, runend)
        pend = jnp.where(run, cv, pend)
        take = jnp.where(run, er == 1, take)
        return (ep, nd, runend, pend, take), row

    N_ = dct_zz.shape[0]
    carry_bt = (
        jnp.ones((N_,), jnp.int32),
        node0_.astype(jnp.int32),
        jnp.zeros((N_,), bool),
        jnp.zeros((N_,), jnp.int32),
        jnp.zeros((N_,), bool),
    )
    # words row k holds position idx[k] = 63-k; reverse=True sweeps
    # positions ascending while keeping ys rows aligned with words rows.
    _, rows = jax.lax.scan(
        bt_step, carry_bt, (idx, words), reverse=True, unroll=4
    )
    out = jnp.zeros((N_, 64), jnp.int32).at[:, idx].set(rows.T)
    return out.at[:, 0].set(q[:, 0])


def dequantize_idct(coeffs_zz, dequant_zz, dc, dc_quant, dc_only):
    """Full reconstruction of residual blocks on the device.

    coeffs_zz: [N, 64] int32 quantized coefficients (zig-zag order,
      DC slot ignored).
    dequant_zz: [N, 64] dequant factors (zig-zag).
    dc: [N] predicted DC values; dc_quant: [N].
    dc_only: [N] bool -- blocks where the decoder takes the last_zzi<2 path.
    Returns [N, 8, 8] int32 residuals.
    """
    deq = _i16(coeffs_zz * dequant_zz.astype(jnp.int32))
    deq = deq.at[:, 0].set(_i16(dc * dc_quant))
    nat = jnp.zeros_like(deq).at[:, _ZZ].set(deq)
    full = idct8x8(nat.reshape(-1, 8, 8))
    return jnp.where(dc_only[:, None, None], dc_fill(dc, dc_quant), full)


def recon_intra(residual):
    """(fragment.c:49-57)"""
    return jnp.clip(residual + 128, 0, 255).astype(jnp.uint8)


def recon_inter(residual, pred):
    """(fragment.c:59-80); pred already averaged for half-pel."""
    return jnp.clip(residual + pred, 0, 255).astype(jnp.uint8)
