"""Dense FAST-9-16 corner score, 3x3 NMS and the two-threshold cell
fallback (port of ops/fast.py).

Every step is a min, max or single subtraction of the input, so on an
integer-valued image the score map is exact and equals the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, clockwise from 12 o'clock ((dy, dx) pairs).
RING_OFFSETS = np.asarray(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def _ring_stack(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (16, H, W) ring samples via rolls (borders wrap; callers
    mask them)."""
    return torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) for dy, dx in RING_OFFSETS]
    )


def _run9_minmax(vals: torch.Tensor) -> torch.Tensor:
    """(16, H, W) -> (H, W): max over the 16 arcs of the min over each 9-arc
    (log-step: 9 = 4 + 4 + 1 rotations)."""
    m = vals
    a2 = torch.minimum(m, torch.roll(m, -1, dims=0))
    a4 = torch.minimum(a2, torch.roll(a2, -2, dims=0))
    a8 = torch.minimum(a4, torch.roll(a4, -4, dims=0))
    a9 = torch.minimum(a8, torch.roll(m, -8, dims=0))
    return torch.amax(a9, dim=0)


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9-16 max-threshold score: a pixel is a corner at threshold
    t iff score > t, so one pass serves both thresholds of the fallback."""
    ring = _ring_stack(img)
    c = img[None]
    score = torch.maximum(_run9_minmax(ring - c), _run9_minmax(c - ring))
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(interior, score, 0.0)


def nonmax_suppress_3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep pixels equal to the max of their 3x3 neighbourhood (-inf
    outside the image)."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return score >= neigh


def cell_fallback_mask(corner_ini: torch.Tensor, corner_min: torch.Tensor,
                       cell: int = 30) -> torch.Tensor:
    """Per 30x30 cell: iniThFAST corners where the cell has any, else
    minThFAST corners (ORBextractor.cc:774-780)."""
    h, w = corner_ini.shape
    ph = (cell - h % cell) % cell
    pw = (cell - w % cell) % cell
    padded = F.pad(corner_ini, (0, pw, 0, ph))
    cells = padded.reshape((h + ph) // cell, cell, (w + pw) // cell, cell)
    cell_has_ini = torch.any(torch.any(cells, dim=3), dim=1)
    up = cell_has_ini.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]
    return torch.where(up, corner_ini, corner_min)
