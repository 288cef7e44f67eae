"""Multi-scale ORB extraction (port of ops/orb.py).

Bilinear pyramid -> dense FAST-9-16 with the 20 -> 7 cell fallback -> 3x3
NMS -> cell-winner bonus + top-k per level -> parabolic sub-pixel offsets
-> intensity-centroid angle -> 32-bin rotated rBRIEF, all at static shapes
(padded keypoint banks + validity masks).

Two choices keep it equal to the JAX package:

- top-k is a stable descending sort, so among equal ranks the lowest flat
  index wins, as the JAX CPU top-k does (``torch.topk`` leaves the order of
  ties undefined on CUDA);
- each rBRIEF bit is ``I(p2) - I(p1) > 0`` read by two gathers.  The JAX
  package contracts a ±1 selection matrix with exactly those two non-zero
  entries per bit, whose float32 result is the same single rounding of
  ``I(p2) - I(p1)`` in any summation order, so the bits are equal.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import fast as fast_ops
from . import image as image_ops
from .descriptors import pack_bits
from .orb_pattern import BRIEF_PATTERN
from .stereo import stack_pyramid

EDGE_MARGIN = 19       # descriptor sample radius bound (EDGE_THRESHOLD)
HALF_PATCH = 15        # IC_Angle patch radius (ORBextractor.cc:32)
CELL = 30              # FAST cell size (ORBextractor.cc:754)
ANGLE_BINS = 32        # rBRIEF rotation quantization (11.25 deg)
PATCH_R = 18           # rotated-pattern sample radius bound (13 * sqrt(2))
PATCH = 2 * PATCH_R + 1


@functools.lru_cache(maxsize=None)
def _ic_angle_weights(device: torch.device) -> torch.Tensor:
    """(PATCH*PATCH, 2) dx/dy weights of the radius-15 circular IC_Angle
    patch (ORBextractor.cc:76-100) inside the 37x37 slab."""
    r = HALF_PATCH
    W = np.zeros((PATCH, PATCH, 2), np.float32)
    for dy in range(-r, r + 1):
        u = int(np.floor(np.sqrt(max(r * r - dy * dy, 0)) + 0.5))
        for dx in range(-u, u + 1):
            W[dy + PATCH_R, dx + PATCH_R] = (dx, dy)
    return torch.from_numpy(W.reshape(PATCH * PATCH, 2)).to(device)


@functools.lru_cache(maxsize=None)
def _brief_sample_index(device: torch.device) -> torch.Tensor:
    """(2, ANGLE_BINS, 256) flat slab offsets of the rotated pattern's first
    and second sample for each angle bin (rounded as the JAX selection
    matrices round them)."""
    pat = np.asarray(BRIEF_PATTERN, dtype=np.float64)   # (256, 4) x1 y1 x2 y2
    out = np.zeros((2, ANGLE_BINS, 256), np.int64)
    for b in range(ANGLE_BINS):
        th = 2.0 * np.pi * b / ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        for s, (cx, cy) in enumerate(((0, 1), (2, 3))):
            x = np.round(pat[:, cx] * ca - pat[:, cy] * sa).astype(int)
            y = np.round(pat[:, cx] * sa + pat[:, cy] * ca).astype(int)
            out[s, b] = (y + PATCH_R) * PATCH + (x + PATCH_R)
    return torch.from_numpy(out).to(device)


class OrbFeatures(NamedTuple):
    """Padded keypoint bank for one frame; invalid slots are masked."""

    xy: torch.Tensor        # (N, 2) float32 level-0 raw pixel coords (x, y)
    response: torch.Tensor  # (N,) float32 FAST score
    octave: torch.Tensor    # (N,) int32 pyramid level
    angle: torch.Tensor     # (N,) float32 degrees [0, 360)
    desc: torch.Tensor      # (N, 8) int32 packed rBRIEF
    valid: torch.Tensor     # (N,) bool

    @property
    def n_slots(self) -> int:
        return self.xy.shape[0]


def level_quotas(n_features: int, n_levels: int, scale_factor: float):
    """Per-level feature budget, geometric in 1/scale (ORBextractor.cc:429-441)."""
    factor = 1.0 / scale_factor
    n_per = n_features * (1 - factor) / (1 - factor ** n_levels)
    quotas = []
    total = 0
    for _ in range(n_levels - 1):
        q = int(round(n_per))
        quotas.append(q)
        total += q
        n_per *= factor
    quotas.append(max(n_features - total, 0))
    return quotas


def _cell_max_up(score: torch.Tensor) -> torch.Tensor:
    """Per-pixel max of its 30x30 cell."""
    h, w = score.shape
    ph = (CELL - h % CELL) % CELL
    pw = (CELL - w % CELL) % CELL
    padded = F.pad(score, (0, pw, 0, ph))
    cells = padded.reshape((h + ph) // CELL, CELL, (w + pw) // CELL, CELL)
    cell_max = torch.amax(cells, dim=(1, 3))
    return cell_max.repeat_interleave(CELL, 0).repeat_interleave(CELL, 1)[:h, :w]


def _detect_level(img: torch.Tensor, quota: int, ini_th: float, min_th: float):
    """FAST + fallback + NMS + balanced selection on one level.

    Returns integer corner coords (ys, xs), sub-pixel offsets, response and
    valid mask, each (quota,).
    """
    h, w = img.shape
    score_all = fast_ops.fast_score(img)
    corner = fast_ops.cell_fallback_mask(score_all > ini_th, score_all > min_th, CELL)
    score = torch.where(corner, score_all, 0.0)
    nms = fast_ops.nonmax_suppress_3x3(score)
    score = torch.where(nms & corner, score, 0.0)

    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = ((yy >= EDGE_MARGIN) & (yy < h - EDGE_MARGIN)
                & (xx >= EDGE_MARGIN) & (xx < w - EDGE_MARGIN))
    score = torch.where(interior, score, 0.0)

    # cell-winner bonus for spatial uniformity (octree replacement)
    is_winner = (score > 0) & (score >= _cell_max_up(score))
    rank = score + torch.where(is_winner, 1e4, 0.0)

    top_rank, top_idx = torch.sort(rank.reshape(-1), descending=True, stable=True)
    top_rank, top_idx = top_rank[:quota], top_idx[:quota]
    ys = torch.div(top_idx, w, rounding_mode="floor")
    xs = top_idx % w
    valid = top_rank > 0.0
    response = score.reshape(-1)[top_idx]

    # parabolic sub-pixel refinement on the dense pre-NMS score surface
    dense = torch.where(corner, score_all, 0.0)

    def sample_d(dy, dx):
        return dense[torch.clamp(ys + dy, 0, h - 1), torch.clamp(xs + dx, 0, w - 1)]

    def parab(sm, sc, sp):
        denom = sm + sp - 2.0 * sc
        d = torch.where(torch.abs(denom) > 1e-6, 0.5 * (sm - sp) / denom, 0.0)
        return torch.clamp(d, -0.5, 0.5)

    sub_x = parab(sample_d(0, -1), sample_d(0, 0), sample_d(0, 1))
    sub_y = parab(sample_d(-1, 0), sample_d(0, 0), sample_d(1, 0))
    return ys, xs, sub_y, sub_x, response, valid


def _slabs(stack: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(N, PATCH*PATCH) slabs centred on (ys, xs).  Start indices are clamped
    into the image as ``jax.lax.dynamic_slice`` clamps them, so padded
    keypoint slots at (0, 0) read the same corner patch as in JAX."""
    hs, ws = stack.shape
    r = torch.arange(PATCH, device=stack.device)
    y0 = torch.clamp(ys - PATCH_R, 0, hs - PATCH)
    x0 = torch.clamp(xs - PATCH_R, 0, ws - PATCH)
    rows = (y0[:, None] + r)[:, :, None]
    cols = (x0[:, None] + r)[:, None, :]
    return stack[rows, cols].reshape(ys.shape[0], PATCH * PATCH)


def extract_orb(
    img: torch.Tensor,
    *,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
) -> OrbFeatures:
    """Full multi-scale ORB extraction on a grayscale (H, W) image.

    Returns a padded bank with sum(level quotas) slots; coordinates are
    level-0 raw pixels.
    """
    img = img.to(torch.float32)
    dev = img.device
    quotas = level_quotas(n_features, n_levels, scale_factor)
    pyr = image_ops.build_pyramid(img, n_levels, scale_factor)
    scales = image_ops.scale_factors(n_levels, scale_factor)
    blur = [image_ops.gaussian_blur(p, 7, 2.0) for p in pyr]
    stack_blur, offsets = stack_pyramid(blur)
    stack_raw, _ = stack_pyramid(pyr)        # unblurred, for IC_Angle moments

    xs_l, ys_l, xy0, rs, octs, vals = [], [], [], [], [], []
    for lv in range(n_levels):
        ys, xs, sub_y, sub_x, resp, valid = _detect_level(
            pyr[lv], quotas[lv], ini_th, min_th
        )
        xs_l.append(xs)
        ys_l.append(ys + int(offsets[lv]))
        xy = torch.stack([xs.to(torch.float32) + sub_x,
                          ys.to(torch.float32) + sub_y], dim=-1)
        xy0.append(xy * float(scales[lv]))
        rs.append(resp)
        octs.append(torch.full((quotas[lv],), lv, dtype=torch.int32, device=dev))
        vals.append(valid)

    xs_all = torch.cat(xs_l)
    ys_all = torch.cat(ys_l)

    # IC_Angle: radius-15 circular moments as one (N, PATCH^2) @ (PATCH^2, 2)
    # product over unblurred slabs.  At level 0 the inputs are integers and
    # the sums stay below 2^24, so the moments are exact there.
    moments = _slabs(stack_raw, ys_all, xs_all) @ _ic_angle_weights(dev)
    angle = torch.atan2(moments[:, 1], moments[:, 0]) * (180.0 / math.pi)
    angle = torch.where(angle < 0, angle + 360.0, angle)

    # rotated rBRIEF on the blurred slabs
    patches = _slabs(stack_blur, ys_all, xs_all)
    bin_id = torch.remainder(
        torch.round(angle / (360.0 / ANGLE_BINS)).to(torch.int64), ANGLE_BINS
    )
    sample = _brief_sample_index(dev)
    v1 = torch.gather(patches, 1, sample[0][bin_id])
    v2 = torch.gather(patches, 1, sample[1][bin_id])
    desc = pack_bits(((v2 - v1) > 0).to(torch.uint8))

    return OrbFeatures(
        xy=torch.cat(xy0),
        response=torch.cat(rs),
        octave=torch.cat(octs),
        angle=angle,
        desc=desc,
        valid=torch.cat(vals),
    )
