"""Stacked pyramids and RGB-D right-view synthesis (the part of
ops/stereo.py the RGB-D slice uses; ``stereo_match`` arrives with the
stereo sensor, ROADMAP queue 1 item 8)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


def depth_to_uright(xy_un: torch.Tensor, depth: torch.Tensor, bf: float) -> torch.Tensor:
    """RGB-D: synthesize the right-view u from depth
    (Frame::ComputeStereoFromRGBD, Frame.cc:648-666)."""
    return torch.where(depth > 0,
                       xy_un[:, 0] - bf / torch.clamp(depth, min=1e-6), -1.0)
