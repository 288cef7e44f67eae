"""Frame construction: ORB extraction + undistortion + stereo/depth
association (port of frontend/frame.py; the three Frame constructors of
Frame.cc:66, 129, 189)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..geometry import camera as cam_mod
from ..geometry.camera import Camera
from ..ops import image as image_ops
from ..ops import stereo as stereo_ops
from ..ops.orb import OrbFeatures, extract_orb


@dataclass
class FrameData:
    """One frame's padded feature bank (the array form of class Frame)."""

    xy: torch.Tensor        # (N, 2) undistorted keypoint coords
    xy_raw: torch.Tensor    # (N, 2) raw coords
    uvr: torch.Tensor       # (N, 3) (u_un, v_un, uR); uR = -1 -> mono feature
    depth: torch.Tensor     # (N,) depth in meters, -1 invalid
    octave: torch.Tensor    # (N,) int32
    angle: torch.Tensor     # (N,) float32 degrees
    response: torch.Tensor  # (N,)
    desc: torch.Tensor      # (N, 8) int32
    valid: torch.Tensor     # (N,) bool

    @property
    def n_slots(self) -> int:
        return self.xy.shape[0]


def _feats_to_frame(cam: Camera, feats: OrbFeatures, u_right, depth) -> FrameData:
    xy_un = cam_mod.undistort_pixels(cam, feats.xy)
    return FrameData(
        xy=xy_un,
        xy_raw=feats.xy,
        uvr=torch.cat([xy_un, u_right[:, None]], dim=-1),
        depth=depth,
        octave=feats.octave,
        angle=feats.angle,
        response=feats.response,
        desc=feats.desc,
        valid=feats.valid,
    )


def _extract(img: torch.Tensor, orb) -> OrbFeatures:
    """``extract_orb`` with the settings of a ``config.ORBConfig``."""
    return extract_orb(
        img,
        n_features=orb.n_features,
        n_levels=orb.n_levels,
        scale_factor=orb.scale_factor,
        ini_th=orb.ini_th_fast,
        min_th=orb.min_th_fast,
    )


def build_frame_mono(img: torch.Tensor, cam: Camera, orb) -> FrameData:
    """Monocular frame: no right-view coordinate and no depth."""
    feats = _extract(img, orb)
    none = torch.full((feats.n_slots,), -1.0, dtype=torch.float32, device=img.device)
    return _feats_to_frame(cam, feats, none, none)


def build_frame_rgbd(img: torch.Tensor, depth_map: torch.Tensor, cam: Camera,
                     orb, depth_factor: float = 1.0) -> FrameData:
    """RGB-D frame: depth looked up at raw keypoint coords with depth-edge
    rejection, uR synthesized (Frame.cc:648-666).  ``depth_map`` is in
    meters times ``depth_factor``; ``orb`` is a ``config.ORBConfig``."""
    feats = _extract(img, orb)
    h, w = depth_map.shape
    ys = torch.clamp(torch.round(feats.xy[:, 1]).to(torch.int64), 0, h - 1)
    xs = torch.clamp(torch.round(feats.xy[:, 0]).to(torch.int64), 0, w - 1)
    d = depth_map[ys, xs] * depth_factor
    # depth-edge rejection: a corner on an occlusion boundary can look up the
    # far surface after a 1-px rounding error; reject features whose 3x3
    # depth window spreads by more than 10% among positive samples
    d_min = torch.full_like(d, float("inf"))
    d_max = torch.zeros_like(d)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            dn = depth_map[torch.clamp(ys + dy, 0, h - 1),
                           torch.clamp(xs + dx, 0, w - 1)] * depth_factor
            d_min = torch.minimum(d_min, torch.where(dn > 0, dn, float("inf")))
            d_max = torch.maximum(d_max, dn)
    edge = (d_max > 1.1 * d_min) | ~torch.isfinite(d_min)
    d = torch.where(feats.valid & (d > 0) & ~edge, d, -1.0)
    xy_un = cam_mod.undistort_pixels(cam, feats.xy)
    u_r = stereo_ops.depth_to_uright(xy_un, d, cam.bf)
    return _feats_to_frame(cam, feats, u_r, d)


def build_frame_stereo(img_l: torch.Tensor, img_r: torch.Tensor, cam: Camera,
                       orb) -> FrameData:
    """Stereo frame: extraction on both images (the reference uses two CPU
    threads, Frame.cc:87-90), then row-constrained matching and SAD
    refinement on the unblurred pyramids."""
    feats_l = _extract(img_l, orb)
    feats_r = _extract(img_r, orb)
    pyr_l = image_ops.build_pyramid(img_l.to(torch.float32), orb.n_levels, orb.scale_factor)
    pyr_r = image_ops.build_pyramid(img_r.to(torch.float32), orb.n_levels, orb.scale_factor)
    stack_l, offs = stereo_ops.stack_pyramid(pyr_l)
    stack_r, _ = stereo_ops.stack_pyramid(pyr_r)
    sf = image_ops.scale_factors(orb.n_levels, orb.scale_factor)
    sm = stereo_ops.stereo_match(
        feats_l, feats_r, stack_l, stack_r, offs, sf,
        fx=cam.fx, bf=cam.bf, min_z=cam.bf / cam.fx,
    )
    return _feats_to_frame(cam, feats_l, sm.u_right, sm.depth)
