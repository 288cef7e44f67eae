"""The benchmark's frozen copy of the port's raycast renderer
(``refactored_orb_slam2_tpu_torch/utils/world3d.py``): RGB-D frames,
rectified stereo pairs and monocular frames in the tracker's wire encoding,
of a scene along a trajectory that are data files of their own.

- a scene: ``scenes/<name>.json``, textured boxes and rectangles;
- a trajectory: ``trajectories/<name>.csv``, the camera's eye, target and
  up vector a frame.

The room and the hall are the original's ``scene_room(11)`` and
``scene_hall(31)``, and the trajectories its ``traj_room_orbit(600, 11)``
and ``traj_hall_ellipse(400, 31)`` (BASELINE.md's fixtures), written out.
Copied so that the benchmark's inputs and ground truth do not move when the
program changes.  One departure from the original: the sensor noise is
drawn on the frame's device from a ``torch.Generator`` (the original draws
it on the host with numpy).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
#: a scene is ``scenes/<name>.json``, a trajectory ``trajectories/<name>.csv``
SCENES, TRAJECTORIES = HERE / "scenes", HERE / "trajectories"

_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) and a 32-bit constant c, in int64
    without overflow: split a into 16-bit halves."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _hash2(ix: torch.Tensor, iy: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Deterministic uint32 lattice hash -> float32 in [0, 1)."""
    u = lambda v: v.to(torch.int64) & _MASK32
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
    """Anti-aliased block noise: flat cells with smoothstep edges whose width
    tracks the pixel footprint."""
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
    """Band-limited multi-octave block texture."""
    val = torch.full(u.shape, 0.55, dtype=torch.float32, device=u.device)
    foot = torch.clamp(footprint, min=1e-6)
    for k, (cell, amp) in enumerate(_OCTAVES):
        w = torch.clamp(cell / foot * 0.30, 0.0, 1.0)
        r = _aa_cells(u, v, cell, seed * 7 + k, foot)
        val = val + amp * w * (r - 0.5) * 2.0
    return val


@dataclass
class Surface:
    """Planar textured rectangle: a corner and two edge vectors."""

    p0: np.ndarray
    eu: np.ndarray
    ev: np.ndarray
    seed: int
    albedo: float = 1.0

    def __post_init__(self):
        self.p0 = np.asarray(self.p0, np.float32)
        self.eu = np.asarray(self.eu, np.float32)
        self.ev = np.asarray(self.ev, np.float32)
        n = np.cross(self.eu, self.ev)
        self.normal = (n / np.linalg.norm(n)).astype(np.float32)


def box_surfaces(center, size, seed, albedo=1.0):
    """Six faces of an axis-aligned box."""
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


_CHUNK = 16384  # rays per step on the CPU: bounds the (chunk, S) temporaries


def _raycast(packed, light, ambient, R, t, h, w, fx, fy, cx, cy, noise_img):
    """Full-frame raycast -> (image (h, w) float32 0..255, depth (h, w) m)."""
    p0, eu, ev, normal, inv_lu2, inv_lv2, seed, albedo = packed
    dev = p0.device
    o = -R.T @ t
    xs = (torch.arange(w, dtype=torch.float32, device=dev) - cx) / fx
    ys = (torch.arange(h, dtype=torch.float32, device=dev) - cy) / fy
    dx, dy = torch.meshgrid(xs, ys, indexing="xy")
    dirs_c = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1).reshape(-1, 3)

    t0 = ((p0 - o[None, :]) * normal).sum(-1)
    oe_u = ((o[None, :] - p0) * eu).sum(-1)
    oe_v = ((o[None, :] - p0) * ev).sum(-1)

    chunk = dirs_c.shape[0] if dev.type == "cuda" else _CHUNK
    imgs, depths = [], []
    for s in range(0, dirs_c.shape[0], chunk):
        dc = dirs_c[s:s + chunk]
        dirs = dc @ R
        dn = dirs @ normal.T
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
        sky = 185.0 - torch.clamp(dc[:, 1], -1.0, 1.0) * 30.0
        imgs.append(torch.where(hit, val, sky))
        depths.append(best_t)
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
        self._packed = {}

    def _pack(self, device):
        if device not in self._packed:
            s = self.surfaces
            self._packed[device] = tuple(
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
        return self._packed[device]

    def _render(self, Tcw, cam, noise, gen, device):
        h, w = cam.height, cam.width
        noise_img = torch.randn((h, w), generator=gen, device=device) * noise
        f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
        return _raycast(
            self._pack(device), f(self.light), float(np.float32(self.ambient)),
            f(Tcw[:3, :3]), f(Tcw[:3, 3]), h, w,
            float(np.float32(cam.fx)), float(np.float32(cam.fy)),
            float(np.float32(cam.cx)), float(np.float32(cam.cy)),
            noise_img,
        )

    @staticmethod
    def _right_pose(Tcw: np.ndarray, cam) -> np.ndarray:
        """The right camera's pose: displaced by the baseline bf / fx along
        the camera's x axis."""
        T_rl = np.eye(4, dtype=np.float32)
        T_rl[0, 3] = -float(cam.bf) / float(cam.fx)
        return T_rl @ Tcw

    def render_device(self, Tcw, cam, noise, gen, device, want_depth=False):
        """A frame on ``device`` in the wire encoding: uint8 grayscale, and
        uint16 millimetre depth when ``want_depth``."""
        img, depth = self._render(Tcw, cam, noise, gen, torch.device(device))
        img_u8 = torch.clamp(img, 0.0, 255.0).to(torch.uint8)
        depth_u16 = torch.clamp(depth * 1000.0, 0.0, 65535.0).to(torch.uint16)
        return (img_u8, depth_u16) if want_depth else img_u8

    def render_stereo_device(self, Tcw, cam, noise, gen, device):
        """A rectified left/right uint8 pair on ``device``."""
        return (self.render_device(Tcw, cam, noise, gen, device),
                self.render_device(self._right_pose(Tcw, cam), cam, noise, gen, device))


def _look_at(eye, target, up):
    """World->camera pose (Tcw) looking from eye toward target (camera +z
    forward, +x right, +y down)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=1)
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ eye
    return T


def load_scene(name: str, base: Path = SCENES) -> World3D:
    """``scenes/<name>.json``: its light and ambient term, its boxes (centre,
    size, albedo, and ``seed``: the six faces take textures seed + 1 to
    seed + 6) and its rectangles (corner, edges, texture seed, albedo), in
    that order."""
    doc = json.loads((base / f"{name}.json").read_text())
    surfaces = []
    for b in doc["boxes"]:
        surfaces += box_surfaces(b["center"], b["size"], b["seed"], b["albedo"])
    surfaces += [Surface(r["p0"], r["eu"], r["ev"], r["seed"], r["albedo"])
                 for r in doc["rects"]]
    return World3D(surfaces=surfaces, light=doc["light"], ambient=doc["ambient"])


def load_trajectory(name: str, base: Path = TRAJECTORIES) -> np.ndarray:
    """``trajectories/<name>.csv``: one frame a row, the camera's eye, the
    point it looks at and its up vector, as (n, 4, 4) float64 Tcw."""
    rows = np.loadtxt(base / f"{name}.csv", delimiter=",", skiprows=1, ndmin=2)
    return np.stack([_look_at(r[0:3], r[3:6], r[6:9]) for r in rows]).astype(np.float64)
