"""Stereo left-right feature matching with sub-pixel SAD refinement, stacked
pyramids and RGB-D right-view synthesis (port of ops/stereo.py).

``stereo_match`` replaces Frame::ComputeStereoMatches (Frame.cc:477-646):
the row-bucketed candidate lists become a row / disparity / octave-band mask
over all (left, right) feature pairs, and the 11-step sliding SAD window
with its parabola fit is one batched gather against a stacked pyramid (all
levels concatenated along rows, so a keypoint indexes its own level with
plain arithmetic).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import matching as M
from .image import index_table, scale_table

SAD_W = 5          # half window (11x11), Frame.cc:560
SAD_L = 5          # slide range +/-5, Frame.cc:567
TH_ORB = 75        # (TH_HIGH + TH_LOW) / 2, Frame.cc:509


class StereoMatchResult(NamedTuple):
    u_right: torch.Tensor   # (N,) float32, -1 where unmatched
    depth: torch.Tensor     # (N,) float32, -1 where unmatched
    valid: torch.Tensor     # (N,) bool


def stack_pyramid(pyr: list) -> tuple[torch.Tensor, np.ndarray]:
    """Concatenate pyramid levels along rows, padded to level-0 width.

    Returns (stacked image (sum_H, W0), per-level row offsets (L,)).
    """
    w0 = pyr[0].shape[1]
    offsets = np.zeros(len(pyr), np.int32)
    acc = 0
    rows = []
    for lv, im in enumerate(pyr):
        offsets[lv] = acc
        acc += im.shape[0]
        rows.append(F.pad(im, (0, w0 - im.shape[1])))
    return torch.cat(rows, dim=0), offsets


def _gather_patches(stack: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                    h: int, w: int) -> torch.Tensor:
    """(N, h, w) patches of ``stack`` with top-left corners (y0, x0)."""
    rows = (y0[:, None] + torch.arange(h, device=stack.device))[:, :, None]
    cols = (x0[:, None] + torch.arange(w, device=stack.device))[:, None, :]
    return stack[rows, cols]


def stereo_match(
    left,
    right,
    stack_l: torch.Tensor,
    stack_r: torch.Tensor,
    level_offsets: np.ndarray,
    scale_factors: np.ndarray,
    fx: float,
    bf: float,
    min_z: float,
) -> StereoMatchResult:
    """Match left ORB features to right features and refine the disparity.

    left/right: ``OrbFeatures`` banks (raw level-0 coordinates).  Returns per
    left feature u_right and depth (= bf / disparity).  The descriptor search
    goes through ``matching.nn_match_desc``: the masked best-2 CUDA kernel
    for CUDA tensors, its plain version for CPU tensors.
    """
    n = left.xy.shape[0]
    dev = left.xy.device
    sf = scale_table(tuple(float(v) for v in scale_factors), dev)
    offs = index_table(tuple(int(v) for v in level_offsets), dev)

    # --- 1. Hamming matching under row/disparity/octave gates -------------
    vL = left.xy[:, 1:2]
    vR = right.xy[None, :, 1]
    r_row = 2.0 * sf[right.octave.long()][None, :]      # Frame.cc:495
    row_ok = torch.abs(vR - vL) <= r_row
    lev_ok = M.octave_band_mask(left.octave, right.octave, -1, 1)
    max_d = fx                      # bf / minZ with minZ = baseline
    disp = left.xy[:, 0:1] - right.xy[None, :, 0]
    disp_ok = (disp >= 0.0) & (disp <= max_d)
    res = M.nn_match_desc(
        left.desc, right.desc,
        row_valid=left.valid, col_valid=right.valid,
        extra_mask=row_ok & lev_ok & disp_ok, max_dist=TH_ORB,
    )

    # --- 2. SAD sub-pixel refinement (Frame.cc:557-625) -------------------
    lev = left.octave.long()
    scale_l = sf[lev]
    inv_sf = 1.0 / scale_l
    su_l = torch.round(left.xy[:, 0] * inv_sf).to(torch.int64)
    sv_l = torch.round(left.xy[:, 1] * inv_sf).to(torch.int64)
    uR0 = right.xy[:, 0][torch.clamp(res.idx, min=0).long()]
    su_r0 = torch.round(uR0 * inv_sf).to(torch.int64)

    H_l, W0 = stack_l.shape
    y_l = offs[lev] + sv_l
    # Start indices are clamped so that a patch never leaves the stack, as
    # ``jax.lax.dynamic_slice`` clamps them; rows it reads from a
    # neighbouring level belong to features that the gates below reject or
    # that the JAX package reads the same way.
    ps = 2 * SAD_W + 1
    strip_w = ps + 2 * SAD_L
    y0 = torch.clamp(y_l - SAD_W, 0, H_l - ps)
    xl0 = torch.clamp(su_l - SAD_W, 0, W0 - ps)
    xr0 = torch.clamp(su_r0 - SAD_W - SAD_L, 0, W0 - strip_w)
    patch_l = _gather_patches(stack_l, y0, xl0, ps, ps)
    strip_r = _gather_patches(stack_r, y0, xr0, ps, strip_w)

    # centre-subtract (the reference subtracts the central pixel value)
    patch_l_n = patch_l - patch_l[:, SAD_W, SAD_W][:, None, None]
    # windows for each of the 11 shifts: (n, 11 shifts, ps, ps)
    wins = strip_r.unfold(2, ps, 1).permute(0, 2, 1, 3)
    wins_n = wins - wins[:, :, SAD_W, SAD_W][:, :, None, None]
    sad = torch.sum(torch.abs(patch_l_n[:, None] - wins_n), dim=(2, 3))   # (n, 11)
    best_inc = torch.argmin(sad, dim=1)
    best_sad = torch.gather(sad, 1, best_inc[:, None])[:, 0]

    # parabola fit over the neighbours (Frame.cc:604-612)
    i_c = torch.clamp(best_inc, 1, 2 * SAD_L - 1)
    s_m = torch.gather(sad, 1, (i_c - 1)[:, None])[:, 0]
    s_c = torch.gather(sad, 1, i_c[:, None])[:, 0]
    s_p = torch.gather(sad, 1, (i_c + 1)[:, None])[:, 0]
    denom = s_m + s_p - 2.0 * s_c
    delta = torch.where(torch.abs(denom) > 1e-6, (s_m - s_p) / (2.0 * denom), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    interior = (best_inc >= 1) & (best_inc <= 2 * SAD_L - 1)
    delta = torch.where(interior, delta, 0.0)

    best_u_r = scale_l * (
        su_r0.to(torch.float32) + (best_inc - SAD_L).to(torch.float32) + delta
    )
    disparity = left.xy[:, 0] - best_u_r
    # clamp tiny/negative disparities like the reference (Frame.cc:617-621)
    tiny = (disparity <= 0) & (disparity >= -1.0)
    disparity = torch.where(tiny, 0.01, disparity)
    best_u_r = torch.where(tiny, left.xy[:, 0] - 0.01, best_u_r)
    ok = res.mask & (disparity > 0) & (disparity <= max_d)

    # --- 3. median SAD outlier filter (Frame.cc:634-645) ------------------
    sad_sorted = torch.sort(torch.where(ok, best_sad, float("inf"))).values
    n_ok = ok.sum()
    median = sad_sorted.gather(0, torch.clamp(n_ok // 2, 0, n - 1)[None])[0]
    ok = ok & (best_sad < 1.5 * 1.4 * median)

    depth = torch.where(ok, bf / torch.clamp(disparity, min=1e-6), -1.0)
    # cap absurd depths from near-zero disparity
    ok = ok & (depth > min_z)
    return StereoMatchResult(
        u_right=torch.where(ok, best_u_r, -1.0),
        depth=torch.where(ok, depth, -1.0),
        valid=ok,
    )


def depth_to_uright(xy_un: torch.Tensor, depth: torch.Tensor, bf: float) -> torch.Tensor:
    """RGB-D: synthesize the right-view u from depth
    (Frame::ComputeStereoFromRGBD, Frame.cc:648-666)."""
    return torch.where(depth > 0,
                       xy_un[:, 0] - bf / torch.clamp(depth, min=1e-6), -1.0)
