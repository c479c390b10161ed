"""Frame geometry: fragment planes, super-block Hilbert maps, macro-block
maps, and the canonical bitstream traversal orders.

The reference builds pointer-based maps at state init (state.c:123-332); here
the same structure is precomputed once per (frame size, pixel format) as
numpy index arrays, which later feed gather/scatter ops on the device.

Coordinate system: fragment row 0 is the *bitstream* bottom row (Theora frames
are coded bottom-up). Planes are stored as arrays whose row 0 is bitstream row
0; display output flips rows at the API boundary (internal.c:177-188).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from theora_tpu.constants import MB_MAP, SB_HILBERT, MODE_INVALID


@dataclasses.dataclass(frozen=True)
class PlaneGeometry:
    nhfrags: int
    nvfrags: int
    froffset: int
    nfrags: int
    nhsbs: int
    nvsbs: int
    sboffset: int
    nsbs: int


class FrameGeometry:
    """All index maps for one frame configuration.

    Attributes:
      planes: per-plane PlaneGeometry (3 entries; chroma planes share shape).
      nfrags, nsbs, nmbs: totals.
      sb_maps: [nsbs, 4, 4] int32, fragment index per (sb, quad, block),
        -1 outside the coded frame (state.c:123-181).
      sb_quad_valid: [nsbs, 4] bool.
      mb_maps: [nmbs, 3, 4] int32 fragment index per (mb, plane, block), -1
        where not applicable for the pixel format (state.c:296-332).
      mb_valid: [nmbs] bool; False for MBs fully outside the coded frame.
      scan_fragis: [n_scan] int32 -- every valid fragment in the canonical
        super-block scan order (plane 0 SBs, then plane 1, then 2; quads in
        bitstream order; blocks 0..3), i.e. the order coded-block flags and
        the coded fragment list are built in (decode.c:483-671).
      scan_sbi / scan_quadi: [n_scan] companion arrays.
      frag_pli / frag_x / frag_y: [nfrags] per-fragment plane and position.
    """

    def __init__(self, frame_width: int, frame_height: int, pixel_fmt: int):
        self.frame_width = frame_width
        self.frame_height = frame_height
        self.pixel_fmt = pixel_fmt
        hdec = 0 if (pixel_fmt & 1) else 1
        vdec = 0 if (pixel_fmt & 2) else 1
        self.hdec, self.vdec = hdec, vdec

        yh = frame_width >> 3
        yv = frame_height >> 3
        ch = (yh + hdec) >> hdec
        cv = (yv + vdec) >> vdec
        yfrags = yh * yv
        cfrags = ch * cv
        yhsbs, yvsbs = (yh + 3) >> 2, (yv + 3) >> 2
        chsbs, cvsbs = (ch + 3) >> 2, (cv + 3) >> 2
        ysbs, csbs = yhsbs * yvsbs, chsbs * cvsbs

        self.planes = [
            PlaneGeometry(yh, yv, 0, yfrags, yhsbs, yvsbs, 0, ysbs),
            PlaneGeometry(ch, cv, yfrags, cfrags, chsbs, cvsbs, ysbs, csbs),
            PlaneGeometry(
                ch, cv, yfrags + cfrags, cfrags, chsbs, cvsbs, ysbs + csbs, csbs
            ),
        ]
        self.nfrags = yfrags + 2 * cfrags
        self.nsbs = ysbs + 2 * csbs
        self.nmbs = ysbs << 2
        self.nhmbs = yhsbs << 1
        self.nvmbs = yvsbs << 1

        self._build_sb_maps()
        self._build_mb_maps()
        self._build_scan_order()
        self._build_frag_coords()

    # -- super block maps --------------------------------------------------
    def _build_sb_maps(self) -> None:
        sb_maps = np.full((self.nsbs, 4, 4), -1, dtype=np.int32)
        quad_valid = np.zeros((self.nsbs, 4), dtype=bool)
        for pli, pl in enumerate(self.planes):
            for sby in range(pl.nvsbs):
                for sbx in range(pl.nhsbs):
                    sbi = pl.sboffset + sby * pl.nhsbs + sbx
                    y0, x0 = sby * 4, sbx * 4
                    imax = min(4, pl.nvfrags - y0)
                    jmax = min(4, pl.nhfrags - x0)
                    for i in range(imax):
                        for j in range(jmax):
                            quad, block = SB_HILBERT[i][j]
                            sb_maps[sbi, quad, block] = (
                                pl.froffset + (y0 + i) * pl.nhfrags + x0 + j
                            )
            # quad valid: the top-left block of a quad determines validity
            # (state.c:107-112): for quad q it is block index q & (q<<1).
        for sbi in range(self.nsbs):
            for quad in range(4):
                quad_valid[sbi, quad] = sb_maps[sbi, quad, quad & (quad << 1)] >= 0
        self.sb_maps = sb_maps
        self.sb_quad_valid = quad_valid

    # -- macro block maps --------------------------------------------------
    def _build_mb_maps(self) -> None:
        mb_maps = np.full((self.nmbs, 3, 4), -1, dtype=np.int32)
        mb_valid = np.ones(self.nmbs, dtype=bool)
        pl0, pl1, pl2 = self.planes
        hdec, vdec = self.hdec, self.vdec
        for sby in range(pl0.nvsbs):
            for sbx in range(pl0.nhsbs):
                sbi = sby * pl0.nhsbs + sbx
                for ymb in range(2):
                    for xmb in range(2):
                        mbi = sbi << 2 | MB_MAP[ymb][xmb]
                        mbx = sbx * 4 + xmb * 2
                        mby = sby * 4 + ymb * 2
                        if mbx >= pl0.nhfrags or mby >= pl0.nvfrags:
                            mb_valid[mbi] = False
                            continue
                        # Luma: 2x2 blocks; flat index i<<1|j (state.c:189-196)
                        for i in range(2):
                            for j in range(2):
                                fy, fx = mby + i, mbx + j
                                if fy < pl0.nvfrags and fx < pl0.nhfrags:
                                    mb_maps[mbi, 0, i << 1 | j] = (
                                        fy * pl0.nhfrags + fx
                                    )
                        # Chroma (state.c:205-269)
                        cx, cy = mbx >> hdec, mby >> vdec
                        if hdec and vdec:
                            f = cy * pl1.nhfrags + cx
                            mb_maps[mbi, 1, 0] = f + pl1.froffset
                            mb_maps[mbi, 2, 0] = f + pl2.froffset
                        elif hdec:  # 4:2:2 style (decimated X only)
                            for i in range(2):
                                f = (mby + i) * pl1.nhfrags + cx
                                mb_maps[mbi, 1, i << 1] = f + pl1.froffset
                                mb_maps[mbi, 2, i << 1] = f + pl2.froffset
                        elif vdec:  # decimated Y only
                            for j in range(2):
                                f = cy * pl1.nhfrags + mbx + j
                                mb_maps[mbi, 1, j] = f + pl1.froffset
                                mb_maps[mbi, 2, j] = f + pl2.froffset
                        else:  # 4:4:4
                            for k in range(4):
                                f0 = mb_maps[mbi, 0, k]
                                mb_maps[mbi, 1, k] = f0 + pl1.froffset
                                mb_maps[mbi, 2, k] = f0 + pl2.froffset
        self.mb_maps = mb_maps
        self.mb_valid = mb_valid
        # Initial mb_modes: 0 for valid, INVALID for others (state.c:321).
        self.initial_mb_modes = np.where(mb_valid, 0, MODE_INVALID).astype(
            np.int8
        )

    # -- canonical scan order ----------------------------------------------
    def _build_scan_order(self) -> None:
        fragis, sbis, quadis = [], [], []
        for sbi in range(self.nsbs):
            for quad in range(4):
                if not self.sb_quad_valid[sbi, quad]:
                    continue
                for bi in range(4):
                    fragi = self.sb_maps[sbi, quad, bi]
                    if fragi >= 0:
                        fragis.append(fragi)
                        sbis.append(sbi)
                        quadis.append(quad)
        self.scan_fragis = np.array(fragis, dtype=np.int32)
        self.scan_sbi = np.array(sbis, dtype=np.int32)
        self.scan_quadi = np.array(quadis, dtype=np.int32)
        # plane id per scan entry
        bounds = [self.planes[0].nsbs, self.planes[0].nsbs + self.planes[1].nsbs]
        self.scan_pli = np.digitize(self.scan_sbi, bounds).astype(np.int32)

    def _build_frag_coords(self) -> None:
        pli = np.empty(self.nfrags, dtype=np.int32)
        fx = np.empty(self.nfrags, dtype=np.int32)
        fy = np.empty(self.nfrags, dtype=np.int32)
        for p, pl in enumerate(self.planes):
            idx = pl.froffset + np.arange(pl.nfrags)
            pli[idx] = p
            fx[idx] = np.arange(pl.nfrags) % pl.nhfrags
            fy[idx] = np.arange(pl.nfrags) // pl.nhfrags
        self.frag_pli = pli
        self.frag_x = fx
        self.frag_y = fy

    # -- misc helpers -------------------------------------------------------
    def plane_shape(self, pli: int) -> tuple[int, int]:
        """(height, width) in pixels of a plane."""
        if pli == 0:
            return self.frame_height, self.frame_width
        return (
            self.frame_height >> self.vdec,
            self.frame_width >> self.hdec,
        )

    def plane_padding(self, pli: int) -> tuple[int, int]:
        """(vpadding, hpadding) of the UMV border for a plane
        (state.c:778-809)."""
        from theora_tpu.constants import UMV_PADDING

        if pli == 0:
            return UMV_PADDING, UMV_PADDING
        return UMV_PADDING >> self.vdec, UMV_PADDING >> self.hdec


@functools.lru_cache(maxsize=8)
def get_geometry(frame_width: int, frame_height: int, pixel_fmt: int) -> FrameGeometry:
    return FrameGeometry(frame_width, frame_height, pixel_fmt)
