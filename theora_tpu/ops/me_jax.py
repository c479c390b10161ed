"""Batched device motion estimation (JAX/XLA).

Batched replacement for the reference's per-MB scalar search
(mcenc.c:268-548): every macroblock of every frame of a GOP is searched
in one jitted dispatch.  Three stages, all integer and deterministic
(ties break on a fixed candidate order, so results are identical on any
backend or mesh sharding):

  1. coarse: exhaustive +-7 full-pel search on a 2x sum-pooled pyramid,
     evaluated as whole-plane shifted absolute differences box-summed per
     MB (one lax.scan over the 225 displacements);
  2. refine: +-2 full-pel window around the doubled coarse vector at
     full resolution;
  3. half-pel: the 8 half-pel neighbours scored with the exact two-tap
     prediction the reconstruction uses (truncating MVMAP offsets,
     decode path state.c:846-957).

Stages 2-3 are gather-free: XLA lowers per-MB dynamic indexing to
element gathers, so each MB's search window is extracted from a
static-shift neighborhood tensor by one-hot selection (the ops/mc_jax.py
discipline), and all candidate positions become static slices of that
per-MB patch.

The search runs on the *original* (un-reconstructed) previous/golden
frames, mirroring the reference's OC_FRAME_*_ORIG design
(mcenc.c:314-316) -- this is what makes whole-GOP batching legal: ME for
every frame depends only on source frames, never on the closed loop.

`plan` fuses the whole per-GOP decision precompute -- search, zero-MV /
golden / intra SADs, top-K shared candidate selection, and candidate
SADs -- into ONE dispatch returning transfer-compact dtypes, so a GOP
costs a single round trip between host and device.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_COARSE_R = 7
_REFINE_R = 2
_MV_MAX = 15  # full-pel; half-pel range is +-31 (bitstream limit)
N_CANDS = 16  # shared candidate vectors scored per frame


def _coarse_cands() -> np.ndarray:
    """Displacements sorted by radius so ties prefer short vectors."""
    ds = [(dy, dx)
          for dy in range(-_COARSE_R, _COARSE_R + 1)
          for dx in range(-_COARSE_R, _COARSE_R + 1)]
    ds.sort(key=lambda d: (d[0] * d[0] + d[1] * d[1], d))
    return np.asarray(ds, dtype=np.int32)


def _refine_cands() -> np.ndarray:
    ds = [(dy, dx)
          for dy in range(-_REFINE_R, _REFINE_R + 1)
          for dx in range(-_REFINE_R, _REFINE_R + 1)]
    ds.sort(key=lambda d: (d[0] * d[0] + d[1] * d[1], d))
    return np.asarray(ds, dtype=np.int32)


def _sumpool2(x):
    F, H, W = x.shape
    return (
        x.astype(jnp.int32)
        .reshape(F, H // 2, 2, W // 2, 2)
        .sum(axis=(2, 4))
    )


@functools.lru_cache(None)
def _boxsum_mats(H, W, mb):
    """Column/row box-sum matrices: box sums as two matmuls instead of
    a reshape-reduce over mb-wide minor dims.  f32 is exact here: every
    sum is an integer < 2^24."""
    cs = np.zeros((W, W // mb), np.float32)
    cs[np.arange(W), np.arange(W) // mb] = 1.0
    rs = np.zeros((H // mb, H), np.float32)
    rs[np.arange(H) // mb, np.arange(H)] = 1.0
    return rs, cs


def _box_mb(diff, mb):
    """[F, H, W] -> [F, H//mb, W//mb] box sums (exact: HIGHEST keeps
    the f32 operands out of reduced-precision matmul paths such as TF32)."""
    F, H, W = diff.shape
    rs, cs = _boxsum_mats(H, W, mb)
    P = jax.lax.Precision.HIGHEST
    t = jnp.einsum(
        "fhc,ck->fhk", diff.astype(jnp.float32), jnp.asarray(cs),
        precision=P,
    )
    return jnp.einsum(
        "vh,fhk->fvk", jnp.asarray(rs), t, precision=P
    ).astype(jnp.int32)


def _mb_neighborhoods(ref, nv, nh):
    """[F, H, W] u8 plane -> [F, nv*nh, 48, 48] u8 neighborhood tensor:
    entry (f, b, 16+dy, 16+dx) is ref pixel at offset (dy, dx) from MB
    b's top-left corner (edge-replicated outside the frame).

    Built band-major: overlapping 48-wide windows at stride 16 are three
    CONTIGUOUS reshapes (rows k..k+16*nv view as [nv, 16]) concatenated
    on a trailing axis, applied to rows then columns, then one final
    transpose, instead of a 3x3 grid of strided
    slice+reshape+transpose+concat ops; bit-identical."""
    F = ref.shape[0]
    W = nh * 16
    refp = jnp.pad(ref, ((0, 0), (16, 16), (16, 16)), mode="edge")
    Wp = W + 32
    bands = jnp.concatenate(
        [refp[:, k : k + 16 * nv].reshape(F, nv, 16, Wp) for k in (0, 16, 32)],
        axis=2,
    )  # [F, nv, 48, Wp]
    cols = jnp.concatenate(
        [
            bands[:, :, :, k : k + 16 * nh].reshape(F, nv, 48, nh, 16)
            for k in (0, 16, 32)
        ],
        axis=4,
    )  # [F, nv, 48, nh, 48]
    return cols.transpose(0, 1, 3, 2, 4).reshape(F, nv * nh, 48, 48)


def _extract_patch(nb, py, px, S):
    """Per-MB SxS patch at per-MB offset (py, px) from the neighborhood
    tensor, as two separable one-hot contractions (the ops/mc_jax.py
    discipline): selection matrices from index comparisons, applied as
    integer contractions -- no per-element gathers, and two ops to
    trace instead of ~2x37 masked shifts (which dominated compile
    time).

    nb: [F, n, 48, 48] u8; py/px: [F, n] int32 in [-16, 32-S].
    Returns [F, n, S, S] u8."""
    lanes = jnp.arange(48, dtype=jnp.int32)
    steps = jnp.arange(S, dtype=jnp.int32)
    rsel = (
        (py + 16)[:, :, None, None] + steps[None, None, :, None]
        == lanes[None, None, None, :]
    ).astype(jnp.int16)  # [F, n, S, 48]
    rows = jnp.einsum(
        "fnsr,fnrc->fnsc", rsel, nb.astype(jnp.int16),
        preferred_element_type=jnp.int32,
    )
    csel = (
        (px + 16)[:, :, None, None] + steps[None, None, :, None]
        == lanes[None, None, None, :]
    ).astype(jnp.int16)  # [F, n, S, 48]
    out = jnp.einsum(
        "fnsc,fntc->fnst", rows.astype(jnp.int16), csel,
        preferred_element_type=jnp.int32,
    )
    return out.astype(jnp.uint8)


@functools.lru_cache(None)
def _refine_rank():
    """rank[ey*5+ex] = radius-order position of cell offset
    (ey-2, ex-2) in _refine_cands()."""
    rank = np.empty(25, np.int32)
    for r, (dy, dx) in enumerate(_refine_cands()):
        rank[(dy + 2) * 5 + (dx + 2)] = r
    return rank


def _refine_select(grid, by, bx, mv_max):
    """First-by-radius-rank minimum over the in-range cells of a 5x5
    refine grid.  grid: list of 25 [F, n] SADs in row-major cell order,
    cell (ey, ex) scoring full-pel offset (by+ey-2, bx+ex-2).

    Replaces the clipped radius-ordered candidate loop (25 per-candidate
    one-hot picks) with ONE keyed argmin -- result
    identical: a clipped candidate lands on a cell whose own unclipped
    candidate has a strictly earlier radius rank (clipping shrinks |dy|
    or |dx| at equal other component), so clipped duplicates can never
    win, and out-of-range cells are simply masked out.

    Returns (sad, oy, ox)."""
    g = jnp.stack(grid, -1)  # [F, n, 25]
    steps = jnp.arange(25, dtype=jnp.int32)
    cy = steps // 5 - 2
    cx = steps % 5 - 2
    oy = by[..., None] + cy
    ox = bx[..., None] + cx
    valid = (jnp.abs(oy) <= mv_max) & (jnp.abs(ox) <= mv_max)
    # sad <= 65280 (16x16 u8 SAD) so sad*32+rank < 2^22: exact in i32.
    key = jnp.where(
        valid, g * 32 + jnp.asarray(_refine_rank()),
        jnp.iinfo(jnp.int32).max,
    )
    idx = jnp.argmin(key, axis=-1).astype(jnp.int32)
    kmin = jnp.min(key, axis=-1)
    return kmin >> 5, by + idx // 5 - 2, bx + idx % 5 - 2


def _halfpel_select(taps, cur_blk, best_y, best_x):
    """Score the 8 half-pel neighbours (+ the full-pel center) of each
    block's full-pel winner with the exact two-tap MC prediction
    (state.c:846-957 semantics) and return the radius-order first
    minimum as (sad, my, mx) in half-pel units.

    taps[ry][rx]: [.., S, S] i32 ref pixels at full-pel offset
    (best_y-1+ry, best_x-1+rx); cur_blk [.., S, S] i32.

    The two MC taps of an odd component are the same UNORDERED full-pel
    pair for either sign (truncation toward zero walks the pair from the
    near end), and pred2 = tap_a + tap_b is symmetric, so every
    candidate's prediction is one of at most two STATIC tap sums --
    diagonals pick between the two by whether sign(my) and sign(mx)
    agree.  13 static SAD passes replace the 81 per-candidate one-hot
    weight passes of the previous formulation."""
    nd = cur_blk.ndim - 2
    sum_ax = (nd, nd + 1)

    def psad(a, b):
        pred2 = taps[a[0]][a[1]] + taps[b[0]][b[1]]
        return jnp.abs(cur_blk - (pred2 >> 1)).sum(axis=sum_ax)

    pair = {-1: (0, 1), 1: (1, 2)}
    sads = {
        (0, 0): psad((1, 1), (1, 1)),
        (-1, 0): psad((0, 1), (1, 1)),
        (1, 0): psad((1, 1), (2, 1)),
        (0, -1): psad((1, 0), (1, 1)),
        (0, 1): psad((1, 1), (1, 2)),
    }
    for dy in (-1, 1):
        for dx in (-1, 1):
            (y0, y1), (x0, x1) = pair[dy], pair[dx]
            s_same = psad((y0, x0), (y1, x1))
            s_mixed = psad((y0, x1), (y1, x0))
            agree = ((2 * best_y + dy) >= 0) == ((2 * best_x + dx) >= 0)
            sads[(dy, dx)] = jnp.where(agree, s_same, s_mixed)

    order = sorted(sads, key=lambda d: (d[0] * d[0] + d[1] * d[1], d))
    best = jnp.full_like(sads[(0, 0)], jnp.iinfo(jnp.int32).max)
    bmy = jnp.zeros_like(best_y)
    bmx = jnp.zeros_like(best_x)
    for dy, dx in order:
        s = sads[(dy, dx)]
        better = s < best
        best = jnp.where(better, s, best)
        bmy = jnp.where(better, 2 * best_y + dy, bmy)
        bmx = jnp.where(better, 2 * best_x + dx, bmx)
    return best, bmy, bmx


def _me_search_impl(cur, ref):
    """See me_search.  Returns (mv [F, nv, nh, 2] int32 half-pel (dx, dy),
    sad_mv [F, nv, nh] int32, sad_nomv [F, nv, nh] int32)."""
    F, H, W = cur.shape
    nv, nh = H // 16, W // 16
    n = nv * nh
    curi = cur.astype(jnp.int32)
    refi = ref.astype(jnp.int32)

    # ---- coarse, half resolution --------------------------------------
    # int16 pyramid: 2x2 sums are <= 1020 so differences fit i16, and
    # halving the per-step stream halves the memory traffic of each
    # scan step (box sums accumulate in i32).
    cur2 = _sumpool2(cur).astype(jnp.int16)
    ref2 = _sumpool2(ref).astype(jnp.int16)
    R2 = _COARSE_R + 1
    ref2p = jnp.pad(ref2, ((0, 0), (R2, R2), (R2, R2)), mode="edge")

    # 5 displacements per scan step, to cut the per-step lax.scan
    # overhead; candidate ORDER -- and so every tie-break -- is
    # unchanged, the inner unroll just applies the same sequential
    # strict-< updates 5 at a time.
    def coarse_step(carry, ds):
        best_sad, best_d = carry
        for i in range(ds.shape[0]):
            d = ds[i]
            shifted = jax.lax.dynamic_slice(
                ref2p, (0, R2 + d[0], R2 + d[1]), cur2.shape
            )
            sad = _box_mb(jnp.abs(cur2 - shifted), 8)
            better = sad < best_sad
            best_sad = jnp.where(better, sad, best_sad)
            best_d = jnp.where(
                better[..., None], d[None, None, None, :], best_d
            )
        return (best_sad, best_d), None

    init = (
        jnp.full((F, nv, nh), jnp.iinfo(jnp.int32).max, jnp.int32),
        jnp.zeros((F, nv, nh, 2), jnp.int32),
    )
    (c_sad, c_d), _ = jax.lax.scan(
        coarse_step, init, jnp.asarray(_coarse_cands().reshape(45, 5, 2))
    )

    # ---- full-pel refine around 2x coarse -----------------------------
    nb = _mb_neighborhoods(ref, nv, nh)
    # Transpose in u8 and materialize (optimization_barrier) BEFORE the
    # int32 cast, so the ~38 grid/half-pel consumers do not each re-walk
    # a fused int32 strided transpose.
    cur_mb = (
        cur.reshape(F, nv, 16, nh, 16)
        .transpose(0, 1, 3, 2, 4)
        .reshape(F, n, 16, 16)
    )
    cur_mb = jax.lax.optimization_barrier(cur_mb).astype(jnp.int32)
    base = 2 * c_d  # [F, nv, nh, 2] (dy, dx), each in [-14, 14]
    by = base[..., 0].reshape(F, n)
    bx = base[..., 1].reshape(F, n)

    # One 20x20 patch per MB covers all 25 refine positions; their SADs
    # are the 5x5 grid of static 16x16 slices.
    patch = _extract_patch(nb, by - 2, bx - 2, 20).astype(jnp.int32)
    grid = []
    for ry in range(5):
        for rx in range(5):
            d = jnp.abs(patch[:, :, ry : ry + 16, rx : rx + 16] - cur_mb)
            grid.append(d.sum(axis=(2, 3)))
    _, best_y, best_x = _refine_select(grid, by, bx, _MV_MAX)

    # ---- half-pel refine ----------------------------------------------
    # Candidate m in half-pel units; prediction = (ref[trunc(m/2)] +
    # ref[trunc(m/2) + sign(m)*(m&1)]) >> 1 -- the exact MC kernel.
    # Both taps lie in [f-1, f+1], so one 18x18 patch at (f-1) holds
    # every tap as a static 3x3 grid of 16x16 slices.
    patch = _extract_patch(nb, best_y - 1, best_x - 1, 18).astype(jnp.int32)
    taps = [
        [patch[:, :, ry : ry + 16, rx : rx + 16] for rx in range(3)]
        for ry in range(3)
    ]
    # |f| <= 15 so |m| <= 31: never clipped.
    best_hsad, best_my, best_mx = _halfpel_select(
        taps, cur_mb, best_y, best_x
    )

    h_m = jnp.stack([best_mx, best_my], axis=-1).reshape(F, nv, nh, 2)
    h_sad = best_hsad.reshape(F, nv, nh)
    sad_nomv = _box_mb(jnp.abs(curi - refi), 16)
    return h_m, h_sad, sad_nomv


@jax.jit
def me_search(cur, ref):
    """Full+half-pel search: cur/ref [F, H, W] uint8 (H, W multiples of
    16).  Returns (mv [F, nv, nh, 2] int32 half-pel units (dx, dy),
    sad_mv [F, nv, nh] int32, sad_nomv [F, nv, nh] int32)."""
    return _me_search_impl(cur, ref)


def _top_cands_impl(mv, K=N_CANDS):
    """Top-K shared candidate vectors per frame by best-MV popularity,
    ties broken (count desc, dx asc, dy asc) -- exactly np.unique +
    np.lexsort((dy, dx, -counts)).  mv: [F, nv, nh, 2] int32 (dx, dy)
    in [-31, 31].  Returns [F, K, 2] int32, zero rows past the last
    nonzero-count candidate (the zero vector is never a candidate)."""
    F = mv.shape[0]
    dx = mv[..., 0].reshape(F, -1)
    dy = mv[..., 1].reshape(F, -1)
    bins = (dx + 31) * 63 + (dy + 31)  # monotonic in (dx, dy) lex order
    nz = (dx != 0) | (dy != 0)

    def count1(b, m):
        return jnp.zeros(63 * 63, jnp.int32).at[b].add(m.astype(jnp.int32))

    counts = jax.vmap(count1)(bins, nz)
    # count desc, then bin (= (dx, dy) lex) asc.
    score = counts * 4096 + (4095 - jnp.arange(63 * 63, dtype=jnp.int32))
    _, idx = jax.lax.top_k(score, K)
    cnt = jnp.take_along_axis(counts, idx, axis=1)
    cand = jnp.stack([idx // 63 - 31, idx % 63 - 31], axis=-1)
    return jnp.where((cnt > 0)[..., None], cand, 0)


def _cand_sads_impl(cur, ref, cand):
    """SAD of every MB against K shared half-pel candidate vectors.

    cur/ref: [F, H, W] u8; cand: [F, K, 2] int32 (dx, dy) half-pel.
    Returns [F, K, nv, nh] int32.  Feeds the host's LAST/LAST2-aware
    sequential mode decision (the decoder's MV predictors are shared
    across macroblock runs, so their SADs are whole-plane shifts --
    one dynamic slice per (frame, candidate))."""
    F, H, W = cur.shape
    curi = cur.astype(jnp.int32)
    refi = ref.astype(jnp.int32)
    PAD = 17
    refp = jnp.pad(refi, ((0, 0), (PAD, PAD), (PAD, PAD)), mode="edge")

    def one_frame(cf, rp, cands):
        def one_cand(carry, m):
            mx, my = m[0], m[1]
            o1y = jnp.sign(my) * (jnp.abs(my) >> 1)
            o1x = jnp.sign(mx) * (jnp.abs(mx) >> 1)
            o2y = o1y + jnp.sign(my) * (jnp.abs(my) & 1)
            o2x = o1x + jnp.sign(mx) * (jnp.abs(mx) & 1)
            s1 = jax.lax.dynamic_slice(rp, (PAD + o1y, PAD + o1x), (H, W))
            s2 = jax.lax.dynamic_slice(rp, (PAD + o2y, PAD + o2x), (H, W))
            pred = (s1 + s2) >> 1
            sad = _box_mb(jnp.abs(cf - pred)[None], 16)[0]
            return carry, sad
        _, sads = jax.lax.scan(one_cand, 0, cands)
        return sads

    return jax.vmap(one_frame)(curi, refp, cand)


@jax.jit
def mv_cand_sads(cur, ref, cand):
    return _cand_sads_impl(cur, ref, cand)


def _sad_intra_impl(cur):
    """Host-policy intra proxy: per-MB sum over its four 8x8 luma blocks
    of the absolute deviation from the block mean (encoder.py mode
    decision)."""
    F, H, W = cur.shape
    nv, nh = H // 16, W // 16
    b8 = (
        cur.astype(jnp.int32)
        .reshape(F, nv * 2, 8, nh * 2, 8)
        .transpose(0, 1, 3, 2, 4)
        .reshape(F, nv * 2, nh * 2, 64)
    )
    dev = jnp.abs(b8 - (b8.sum(axis=-1, keepdims=True) >> 6)).sum(axis=-1)
    return (
        dev.reshape(F, nv, 2, nh, 2).sum(axis=(2, 4))
    )


@jax.jit
def sad_nomv_vs(cur, ref):
    """Zero-MV SAD per MB: cur [F, H, W] u8, ref [H, W] or [F, H, W]."""
    refi = ref.astype(jnp.int32)
    if refi.ndim == 2:
        refi = refi[None]
    return _box_mb(jnp.abs(cur.astype(jnp.int32) - refi), 16)


@jax.jit
def sad_intra_mb(cur):
    return _sad_intra_impl(cur)


def _block_refine_impl(cur, ref, mv):
    """Per-8x8-block MV refine around each parent MB's winner (the 4MV
    search, mcenc.c:430-496 redesigned batched): +-2 full-pel grid then
    the 8 half-pel neighbours with the exact two-tap MC prediction.

    cur/ref: [F, H, W] u8; mv: [F, nv, nh, 2] int32 half-pel (dx, dy)
    MB winners.  Returns (bmv [F, 2nv, 2nh, 2] int32 half-pel,
    bsad [F, 2nv, 2nh] int32) in the block grid.  Block full-pel
    candidates are clamped to +-13 (half-pel +-27) so every candidate
    and half-pel tap stays inside the MB's 48x48 neighborhood tensor --
    a slightly tighter range than the MB search's +-15, which block
    vectors (anchored at the MB winner) do not reach in practice."""
    F, H, W = cur.shape
    nv, nh = H // 16, W // 16
    n = nv * nh
    nb = _mb_neighborhoods(ref, nv, nh)
    # Full-pel base per MB: the MC first tap of the half-pel winner.
    mx, my = mv[..., 0], mv[..., 1]
    base_x = (jnp.sign(mx) * (jnp.abs(mx) >> 1)).reshape(F, n)
    base_y = (jnp.sign(my) * (jnp.abs(my) >> 1)).reshape(F, n)
    base_x = jnp.clip(base_x, -13, 13)
    base_y = jnp.clip(base_y, -13, 13)

    out_mv = jnp.zeros((F, 2 * nv, 2 * nh, 2), jnp.int32)
    out_sad = jnp.zeros((F, 2 * nv, 2 * nh), jnp.int32)
    for jy in (0, 1):
        for jx in (0, 1):
            # u8 transpose + barrier before the i32 cast: see the
            # cur_mb note in _me_search_impl.
            cur_blk = (
                cur.reshape(F, nv, 2, 8, nh, 2, 8)[:, :, jy, :, :, jx]
                .transpose(0, 1, 3, 2, 4)
                .reshape(F, n, 8, 8)
            )
            cur_blk = jax.lax.optimization_barrier(cur_blk).astype(
                jnp.int32
            )
            # ---- full-pel: 5x5 grid as static slices of a 12px patch.
            patch = _extract_patch(
                nb, 8 * jy + base_y - 2, 8 * jx + base_x - 2, 12
            ).astype(jnp.int32)
            grid = []
            for ry in range(5):
                for rx in range(5):
                    d = jnp.abs(
                        patch[:, :, ry : ry + 8, rx : rx + 8] - cur_blk
                    )
                    grid.append(d.sum(axis=(2, 3)))
            _, best_y, best_x = _refine_select(grid, base_y, base_x, 13)
            # ---- half-pel: 3x3 taps from a 10px patch.
            patch = _extract_patch(
                nb, 8 * jy + best_y - 1, 8 * jx + best_x - 1, 10
            ).astype(jnp.int32)
            taps = [
                [patch[:, :, ry : ry + 8, rx : rx + 8] for rx in range(3)]
                for ry in range(3)
            ]
            b_hsad, b_my, b_mx = _halfpel_select(
                taps, cur_blk, best_y, best_x
            )
            bm = jnp.stack([b_mx, b_my], axis=-1).reshape(F, nv, nh, 2)
            out_mv = out_mv.at[:, jy::2, jx::2].set(bm)
            out_sad = out_sad.at[:, jy::2, jx::2].set(
                b_hsad.reshape(F, nv, nh)
            )
    return out_mv, out_sad


# ---------------------------------------------------------------------------
# Fused per-GOP decision precompute: everything the host mode decision
# needs, in one dispatch and one compact download.  SADs are 16x16 sums
# of values <= 255, so they fit uint16 exactly (max 65280); MV components
# fit int8 (|m| <= 31).
# ---------------------------------------------------------------------------

def _plan_impl(cur, prev, gold):
    # named_scope labels group profiler traces by ME stage
    # (theora_tpu/debug.py).
    with jax.named_scope("me_search"):
        mv, sad_mv, sad_nomv = _me_search_impl(cur, prev)
    with jax.named_scope("me_search_gold"):
        gmv, sad_gmv, sad_gold = _me_search_impl(cur, gold)
    with jax.named_scope("me_block_refine"):
        bmv, bsad = _block_refine_impl(cur, prev, mv)
        # Per-MB 4MV SAD sums: the host decision only ever consumes the
        # SUM of an MB's four block SADs (the 4MV mode cost), so the
        # download shrinks 4x (B*2nv*2nh u16 -> B*nv*nh).
        B, nv2, nh2 = bsad.shape
        bsad4 = bsad.reshape(B, nv2 // 2, 2, nh2 // 2, 2).sum(
            axis=(2, 4)
        )
    with jax.named_scope("me_sads"):
        sad_intra = _sad_intra_impl(cur)
    with jax.named_scope("me_cands"):
        cands = _top_cands_impl(mv)
        cand_sads = _cand_sads_impl(cur, prev, cands)
    return (
        mv.astype(jnp.int8),
        sad_mv.astype(jnp.uint16),
        sad_nomv.astype(jnp.uint16),
        sad_gold.astype(jnp.uint16),
        sad_intra.astype(jnp.uint16),
        cands.astype(jnp.int8),
        cand_sads.astype(jnp.uint16),
        gmv.astype(jnp.int8),
        sad_gmv.astype(jnp.uint16),
        bmv.astype(jnp.int8),
        bsad4.astype(jnp.uint16),
    )


@jax.jit
def plan(cur, prev, gold):
    """Fused ME + SADs + candidate selection for B independent frames.
    cur/prev/gold: [B, H, W] u8.  Returns compact-dtype arrays
    (mv i8 [B,nv,nh,2], sad_mv/sad_nomv/sad_gold/sad_intra u16 [B,nv,nh],
    cands i8 [B,K,2], cand_sads u16 [B,K,nv,nh])."""
    return _plan_impl(cur, prev, gold)


@jax.jit
def plan_from_gop(ys):
    """Fused plan for one GOP: ys [F, H, W] u8 (frame 0 = keyframe).
    cur/prev/gold are derived on device so the GOP's luma uploads once."""
    cur = ys[1:]
    prev = ys[:-1]
    gold = jnp.broadcast_to(ys[0], cur.shape)
    return _plan_impl(cur, prev, gold)


@jax.jit
def plan_with_gold(ys, gold_idx):
    """Fused plan for a multi-GOP frame sequence in ONE dispatch: ys
    [F, H, W] u8, gold_idx [F-1] i32 giving, for each cur frame f+1,
    the index of its GOP's keyframe in ys (the golden reference).
    Rows whose cur frame is itself a keyframe are computed against an
    arbitrary gold and discarded by the host (keyframes are all-intra).
    The clip-batched encode driver's ME entry (encode_clip)."""
    cur = ys[1:]
    prev = ys[:-1]
    gold = jnp.take(ys, gold_idx, axis=0)
    return _plan_impl(cur, prev, gold)


@jax.jit
def plan_from_gops(ys):
    """Fused plan for G stacked GOPs: ys [G, F, H, W] u8.  Returns
    arrays with leading dim G*(F-1), GOP-major (the mesh batch path)."""
    G, F, H, W = ys.shape
    cur = ys[:, 1:].reshape(G * (F - 1), H, W)
    prev = ys[:, :-1].reshape(G * (F - 1), H, W)
    gold = jnp.broadcast_to(ys[:, 0:1], (G, F - 1, H, W)).reshape(
        G * (F - 1), H, W
    )
    return _plan_impl(cur, prev, gold)
