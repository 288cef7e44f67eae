"""Raycast renderer for rendered test and smoke fixtures (port of the parts
of utils/world3d.py that the RGB-D room fixture uses).

The scene and trajectory builders are numpy and produce the same arrays as
the JAX module's; the raycaster is the same ray/plane arithmetic and
procedural texture in torch, so the fixture renders on the card without
JAX.  The uint32 lattice hash runs in int64 with ``& 0xFFFFFFFF`` after
every multiply.  A fixture renderer, not part of the tracking path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


# ----------------------------------------------------------- procedural hash
def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) and a 32-bit constant c, in int64
    without overflow: split a into 16-bit halves."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _hash2(ix: torch.Tensor, iy: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Deterministic uint32 lattice hash -> float32 in [0, 1)."""
    u = lambda v: v.to(torch.int64) & _MASK32   # int32 -> its uint32 value
    h = (_mul32(u(ix), 0x9E3779B1) ^ _mul32(u(iy), 0x85EBCA77)
         ^ _mul32(u(seed), 0x27D4EB2F))
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    h = h ^ (h >> 15)
    return h.to(torch.float32) * float(np.float32(1.0 / 4294967296.0))


_OCTAVES = ((4.5, 0.12), (1.6, 0.14), (0.45, 0.16), (0.13, 0.16), (0.036, 0.12))


def _aa_cells(u, v, cell, seed, foot):
    """Anti-aliased 2D block noise: flat cells with smoothstep edges whose
    width tracks the pixel footprint (band-limited like camera optics)."""
    w = torch.clamp(foot / cell * 0.7, 0.02, 0.5)
    x = u / cell + 0.5
    y = v / cell + 0.5
    ix = torch.floor(x).to(torch.int32)
    iy = torch.floor(y).to(torch.int32)
    tx = torch.clamp((x - ix.to(torch.float32) - 0.5) / (2.0 * w) + 0.5, 0.0, 1.0)
    ty = torch.clamp((y - iy.to(torch.float32) - 0.5) / (2.0 * w) + 0.5, 0.0, 1.0)
    tx = tx * tx * (3.0 - 2.0 * tx)
    ty = ty * ty * (3.0 - 2.0 * ty)
    r00 = _hash2(ix - 1, iy - 1, seed)
    r10 = _hash2(ix, iy - 1, seed)
    r01 = _hash2(ix - 1, iy, seed)
    r11 = _hash2(ix, iy, seed)
    top = r00 + (r10 - r00) * tx
    bot = r01 + (r11 - r01) * tx
    return top + (bot - top) * ty


def _blocky_texture(u, v, seed, footprint):
    """Band-limited multi-octave block texture; each octave fades out as the
    pixel footprint approaches its cell size."""
    val = torch.full(u.shape, 0.55, dtype=torch.float32, device=u.device)
    foot = torch.clamp(footprint, min=1e-6)
    for k, (cell, amp) in enumerate(_OCTAVES):
        w = torch.clamp(cell / foot * 0.30, 0.0, 1.0)
        r = _aa_cells(u, v, cell, seed * 7 + k, foot)
        val = val + amp * w * (r - 0.5) * 2.0
    return val


# ------------------------------------------------------------------ geometry
@dataclass
class Surface:
    """Planar textured rectangle: origin + two edge vectors."""

    p0: np.ndarray      # (3,) corner
    eu: np.ndarray      # (3,) edge vector (u axis, meters)
    ev: np.ndarray      # (3,) edge vector (v axis, meters)
    seed: int
    albedo: float = 1.0

    def __post_init__(self):
        self.p0 = np.asarray(self.p0, np.float32)
        self.eu = np.asarray(self.eu, np.float32)
        self.ev = np.asarray(self.ev, np.float32)
        n = np.cross(self.eu, self.ev)
        self.normal = (n / np.linalg.norm(n)).astype(np.float32)


def box_surfaces(center, size, seed, inward=False, albedo=1.0):
    """Six faces of an axis-aligned box (two-sided; normals affect shading
    only)."""
    cx, cy, cz = center
    sx, sy, sz = (s / 2.0 for s in size)
    return [
        Surface([cx + sx, cy - sy, cz - sz], [0, 2 * sy, 0], [0, 0, 2 * sz], seed + 1, albedo),
        Surface([cx - sx, cy - sy, cz - sz], [0, 0, 2 * sz], [0, 2 * sy, 0], seed + 2, albedo),
        Surface([cx - sx, cy + sy, cz - sz], [0, 0, 2 * sz], [2 * sx, 0, 0], seed + 3, albedo),
        Surface([cx - sx, cy - sy, cz - sz], [2 * sx, 0, 0], [0, 0, 2 * sz], seed + 4, albedo),
        Surface([cx - sx, cy - sy, cz + sz], [2 * sx, 0, 0], [0, 2 * sy, 0], seed + 5, albedo),
        Surface([cx - sx, cy - sy, cz - sz], [0, 2 * sy, 0], [2 * sx, 0, 0], seed + 6, albedo),
    ]


_CHUNK = 16384  # rays per step: bounds the (chunk, S) temporaries


def _raycast(packed, light, ambient, R, t, h, w, fx, fy, cx, cy, noise_img):
    """Full-frame raycast -> (image (h, w) float32 0..255, depth (h, w) m)."""
    p0, eu, ev, normal, inv_lu2, inv_lv2, seed, albedo = packed
    dev = p0.device
    o = -R.T @ t                                     # camera center, world
    xs = (torch.arange(w, dtype=torch.float32, device=dev) - cx) / fx
    ys = (torch.arange(h, dtype=torch.float32, device=dev) - cy) / fy
    dx, dy = torch.meshgrid(xs, ys, indexing="xy")
    dirs_c = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1).reshape(-1, 3)

    t0 = ((p0 - o[None, :]) * normal).sum(-1)        # (S,) plane offsets
    oe_u = ((o[None, :] - p0) * eu).sum(-1)
    oe_v = ((o[None, :] - p0) * ev).sum(-1)

    imgs, depths = [], []
    for s in range(0, dirs_c.shape[0], _CHUNK):
        dc = dirs_c[s:s + _CHUNK]
        dirs = dc @ R                                # (C, 3) world rays
        dn = dirs @ normal.T                         # (C, S)
        dn = torch.where(torch.abs(dn) < 1e-9, 1e-9, dn)
        t_hit = t0[None, :] / dn
        a = (oe_u[None, :] + t_hit * (dirs @ eu.T)) * inv_lu2[None, :]
        b = (oe_v[None, :] + t_hit * (dirs @ ev.T)) * inv_lv2[None, :]
        ok = (t_hit > 0.08) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        t_masked = torch.where(ok, t_hit, float("inf"))
        best_i = torch.argmin(t_masked, dim=1)
        rows = torch.arange(t_masked.shape[0], device=dev)
        best_t = t_masked[rows, best_i]
        hit = torch.isfinite(best_t)
        best_t = torch.where(hit, best_t, 0.0)

        a_w = a[rows, best_i]
        b_w = b[rows, best_i]
        lu = 1.0 / torch.sqrt(inv_lu2[best_i])
        lv = 1.0 / torch.sqrt(inv_lv2[best_i])
        cosi = torch.abs(dn[rows, best_i]) / torch.linalg.norm(dirs, dim=1)
        foot = best_t / fx / torch.clamp(cosi, min=0.25)
        tex = _blocky_texture(a_w * lu, b_w * lv, seed[best_i], foot)
        shade = ambient + (1 - ambient) * torch.abs(normal[best_i] @ light)
        val = torch.clamp(tex * shade * albedo[best_i], 0.02, 1.0) * 235.0 + 12.0
        # miss -> featureless bright sky with a soft vertical gradient
        sky = 185.0 - torch.clamp(dc[:, 1], -1.0, 1.0) * 30.0
        imgs.append(torch.where(hit, val, sky))
        depths.append(best_t)                        # dir_c z == 1 -> t = z
    img = torch.cat(imgs).reshape(h, w) + noise_img
    depth = torch.cat(depths).reshape(h, w)
    return torch.clamp(img, 0, 255), depth


@dataclass
class World3D:
    surfaces: list = field(default_factory=list)
    light: np.ndarray = field(
        default_factory=lambda: np.asarray([0.35, -0.8, 0.49], np.float32)
    )
    ambient: float = 0.45

    def __post_init__(self):
        self.light = np.asarray(self.light, np.float32)
        self.light /= np.linalg.norm(self.light)

    def _pack(self, device):
        s = self.surfaces
        return tuple(
            torch.from_numpy(np.stack(x)).to(device)
            for x in (
                [f.p0 for f in s], [f.eu for f in s], [f.ev for f in s],
                [f.normal for f in s],
                [np.float32(1.0 / (f.eu @ f.eu)) for f in s],
                [np.float32(1.0 / (f.ev @ f.ev)) for f in s],
                [np.int32(f.seed) for f in s],
                [np.float32(f.albedo) for f in s],
            )
        )

    def _render(self, Tcw, cam, noise, rng, device):
        h, w = cam.height, cam.width
        if noise > 0:
            rng = rng or np.random.default_rng(0)
            noise_img = rng.normal(0.0, noise, (h, w)).astype(np.float32)
        else:
            noise_img = np.zeros((h, w), np.float32)
        f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
        return _raycast(
            self._pack(device), f(self.light), float(np.float32(self.ambient)),
            f(Tcw[:3, :3]), f(Tcw[:3, 3]), h, w,
            float(np.float32(cam.fx)), float(np.float32(cam.fy)),
            float(np.float32(cam.cx)), float(np.float32(cam.cy)),
            f(noise_img),
        )

    def render(self, Tcw: np.ndarray, cam, want_depth: bool = False,
               noise: float = 0.0, rng=None, device="cpu"):
        """Raycast a grayscale (H, W) float32 numpy image in [0, 255] (+ depth
        in m).  Tcw is world->camera; ideal pinhole."""
        img, depth = self._render(Tcw, cam, noise, rng, torch.device(device))
        img = img.cpu().numpy()
        return (img, depth.cpu().numpy()) if want_depth else img

    def render_device(self, Tcw: np.ndarray, cam, want_depth: bool = False,
                      noise: float = 0.0, rng=None, device="cuda"):
        """Raycast a frame that stays on ``device``, in the tracker's wire
        encoding (uint8 grayscale, uint16 millimetre depth), for
        ``SlamSystem.track_rgbd_device``."""
        img, depth = self._render(Tcw, cam, noise, rng, torch.device(device))
        img_u8 = torch.clamp(img, 0.0, 255.0).to(torch.uint8)
        depth_u16 = torch.clamp(depth * 1000.0, 0.0, 65535.0).to(torch.uint16)
        return (img_u8, depth_u16) if want_depth else img_u8


# ------------------------------------------------------------------- scenes
def scene_room(seed=11) -> World3D:
    """TUM-fr1-like office room: 6x5x2.8 m interior, desk-cluster boxes,
    wall posters for texture variety."""
    rng = np.random.default_rng(seed)
    surfs = box_surfaces([0, 0, 1.4], [6.0, 5.0, 2.8], seed=seed * 100, inward=True)
    for i, (c, s) in enumerate((
        ([0.0, 0.0, 0.35], [1.6, 0.9, 0.7]),      # desk
        ([0.9, 0.6, 0.25], [0.5, 0.5, 0.5]),      # crate
        ([-0.8, -0.5, 0.55], [0.4, 0.4, 1.1]),    # shelf
        ([0.1, -0.9, 0.15], [0.7, 0.35, 0.3]),    # low box
    )):
        surfs += box_surfaces(c, s, seed=seed * 100 + 10 + 7 * i, albedo=0.9)
    # posters: slightly inset wall rectangles with their own seeds
    for i in range(6):
        wall = rng.integers(0, 4)
        uo = rng.uniform(0.3, 3.0)
        vo = rng.uniform(0.5, 1.6)
        wpost, hpost = rng.uniform(0.7, 1.4), rng.uniform(0.5, 1.0)
        eps = 0.01
        if wall == 0:
            s = Surface([3.0 - eps, -2.5 + uo, vo], [0, wpost, 0], [0, 0, hpost], seed * 100 + 50 + i)
        elif wall == 1:
            s = Surface([-3.0 + eps, -2.5 + uo, vo], [0, wpost, 0], [0, 0, hpost], seed * 100 + 50 + i)
        elif wall == 2:
            s = Surface([-3.0 + uo, 2.5 - eps, vo], [wpost, 0, 0], [0, 0, hpost], seed * 100 + 50 + i)
        else:
            s = Surface([-3.0 + uo, -2.5 + eps, vo], [wpost, 0, 0], [0, 0, hpost], seed * 100 + 50 + i)
        surfs.append(s)
    return World3D(surfaces=surfs)


# -------------------------------------------------------------- trajectories
def _look_at(eye, target, up):
    """World->camera pose (Tcw) looking from eye toward target
    (camera +z forward, +x right, +y down)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=1)   # columns = camera axes
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ eye
    return T


def _smooth_noise(n, scale, octaves=3, seed=0):
    """(n,) smooth random wander in [-scale, scale] (handheld jitter)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(n)
    for o in range(octaves):
        pts = max(3, n // (8 * 2 ** o))
        knots = rng.normal(0, 1, pts)
        x = np.linspace(0, pts - 1, n)
        out += np.interp(x, np.arange(pts), knots) / 2 ** o
    return out / np.abs(out).max() * scale


def traj_room_orbit(n_frames, seed=5, span=1.15 * np.pi):
    """Handheld sweep around the desk cluster (TUM fr1/desk style): orbit
    segment + partial return, with translation bob and look-target wander."""
    ang0 = -0.7 * np.pi
    s = np.linspace(0, 1, n_frames)
    sweep = np.where(s < 0.8, s / 0.8, 1.0 - (s - 0.8) / 0.2 * 0.25)
    ang = ang0 + span * sweep
    r = 2.0 + 0.15 * _smooth_noise(n_frames, 1.0, seed=seed)
    ex = r * np.cos(ang)
    ey = r * np.sin(ang)
    ez = 1.25 + 0.12 * _smooth_noise(n_frames, 1.0, seed=seed + 1)
    tx = 0.25 * _smooth_noise(n_frames, 1.0, seed=seed + 2)
    ty = 0.25 * _smooth_noise(n_frames, 1.0, seed=seed + 3)
    tz = 0.45 + 0.1 * _smooth_noise(n_frames, 1.0, seed=seed + 4)
    poses = np.stack([
        _look_at([ex[i], ey[i], ez[i]], [tx[i], ty[i], tz[i]], [0, 0, 1])
        for i in range(n_frames)
    ])
    return poses.astype(np.float64)
