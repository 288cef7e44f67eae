"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV (a copy of the JAX
package's io/datasets.py, which imports nothing of JAX; the code below the
docstring is the original's except for the image reading and the EuRoC
rectification, which run on the port's own PNG codec and numpy instead of
cv2. tests/test_torch_config.py holds the rest equal word for word and
names the rewritten functions; tests/test_torch_datasets.py holds the
readers to the JAX package's).

Replaces the example drivers' ad-hoc loaders (reference:
mono_tum.cc:150-185 LoadImages + association logic, stereo_kitti.cc,
stereo_euroc.cc:70-115 incl. stereo rectification).  Each loader yields
(timestamp, frame-data) tuples of host arrays ready for
SlamSystem.track_*.

Images load through ``io/png.py`` at the host boundary (the reference uses
cv::imread; ``png.imread_gray`` gives what cv2's grey read gives), and the
EuRoC rectification is cv::initUndistortRectifyMap for the radtan model
and a bilinear cv::remap with a zero border, in numpy
(``undistort_rectify_map``, ``remap_linear``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import png


def _imread_gray(path: str) -> np.ndarray:
    return png.imread_gray(path).astype(np.float32)


def _imread_depth(path: str, factor: float) -> np.ndarray:
    return png.read_png(path).astype(np.float32) / factor


def undistort_rectify_map(K, D, R, P, size):
    """cv::initUndistortRectifyMap for the radtan model (k1, k2, p1, p2[,
    k3]) with CV_32F maps: for every pixel (u, v) of the rectified image of
    ``size`` = (width, height), where it lies in the raw image. The same
    double-precision steps as OpenCV, so the maps are equal to its."""
    w, h = size
    k1, k2, p1, p2, k3 = (list(np.ravel(D)) + [0.0] * 5)[:5]
    ir = np.linalg.inv(np.asarray(P, np.float64)[:3, :3] @ np.asarray(R, np.float64))
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    x_h = ir[0, 0] * u + ir[0, 1] * v + ir[0, 2]
    y_h = ir[1, 0] * u + ir[1, 1] * v + ir[1, 2]
    inv_w = 1.0 / (ir[2, 0] * u + ir[2, 1] * v + ir[2, 2])
    x, y = x_h * inv_w, y_h * inv_w
    x2, y2, xy2 = x * x, y * y, 2.0 * x * y
    r2 = x2 + y2
    kr = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2.0 * x2)
    yd = y * kr + p1 * (r2 + 2.0 * y2) + p2 * xy2
    K = np.asarray(K, np.float64)
    return ((K[0, 0] * xd + K[0, 2]).astype(np.float32),
            (K[1, 1] * yd + K[1, 2]).astype(np.float32))


def remap_linear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """cv::remap(img, map_x, map_y, INTER_LINEAR) of a float32 image with
    the default constant zero border: bilinear at the maps' float
    coordinates (OpenCV 5.0 does not quantize them to 1/32 px for a float32
    image), a neighbour outside the image reading 0. Along x, then y, each
    step a fused multiply-add ``p + f * (q - p)`` as OpenCV's vector code
    does it: the product and sum in float64, one rounding to float32."""
    h, w = img.shape
    x0f, y0f = np.floor(map_x), np.floor(map_y)
    fx, fy = map_x - x0f, map_y - y0f
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)
    pad = np.zeros((h + 2, w + 2), np.float32)
    pad[1:-1, 1:-1] = img

    def at(yy, xx):
        inside = (yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w)
        val = pad[np.clip(yy + 1, 0, h + 1), np.clip(xx + 1, 0, w + 1)]
        return np.where(inside, val, np.float32(0.0))

    def lerp(p, q, f):
        return (p.astype(np.float64) + f.astype(np.float64) * (q - p)).astype(np.float32)

    p00, p01 = at(y0, x0), at(y0, x0 + 1)
    p10, p11 = at(y0 + 1, x0), at(y0 + 1, x0 + 1)
    return lerp(lerp(p00, p01, fx), lerp(p10, p11, fx), fy)


@dataclass
class TumRgbdSequence:
    """TUM RGB-D: associates rgb.txt and depth.txt by nearest timestamp
    (the associate.py convention; reference rgbd_tum.cc expects a
    pre-associated file)."""

    root: str
    depth_factor: float = 5000.0
    max_dt: float = 0.02

    def __iter__(self):
        rgb = self._read_list(os.path.join(self.root, "rgb.txt"))
        depth = self._read_list(os.path.join(self.root, "depth.txt"))
        d_ts = np.asarray([t for t, _ in depth])
        for t, rgb_path in rgb:
            j = int(np.argmin(np.abs(d_ts - t)))
            if abs(d_ts[j] - t) > self.max_dt:
                continue
            img = _imread_gray(os.path.join(self.root, rgb_path))
            dep = _imread_depth(
                os.path.join(self.root, depth[j][1]), self.depth_factor
            )
            yield t, img, dep

    @staticmethod
    def _read_list(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                out.append((float(ts), rel))
        return out


@dataclass
class TumMonoSequence:
    root: str

    def __iter__(self):
        for t, rel in TumRgbdSequence._read_list(os.path.join(self.root, "rgb.txt")):
            yield t, _imread_gray(os.path.join(self.root, rel))


@dataclass
class KittiStereoSequence:
    """KITTI odometry: image_0/image_1 grayscale pairs + times.txt
    (reference stereo_kitti.cc LoadImages)."""

    root: str  # e.g. .../sequences/00

    def __iter__(self):
        times_path = os.path.join(self.root, "times.txt")
        with open(times_path) as f:
            times = [float(x) for x in f.read().split()]
        for i, t in enumerate(times):
            name = f"{i:06d}.png"
            left = _imread_gray(os.path.join(self.root, "image_0", name))
            right = _imread_gray(os.path.join(self.root, "image_1", name))
            yield t, left, right


@dataclass
class KittiMonoSequence:
    """KITTI odometry, left camera only (reference mono_kitti.cc)."""

    root: str

    def __iter__(self):
        with open(os.path.join(self.root, "times.txt")) as f:
            times = [float(x) for x in f.read().split()]
        for i, t in enumerate(times):
            yield t, _imread_gray(os.path.join(self.root, "image_0", f"{i:06d}.png"))


@dataclass
class EurocMonoSequence:
    """EuRoC MAV, cam0 only, unrectified (reference mono_euroc.cc; the
    monocular settings carry the raw cam0 distortion)."""

    root: str  # .../mav0

    def __iter__(self):
        cam0 = os.path.join(self.root, "cam0", "data")
        for name in sorted(os.listdir(cam0)):
            if not name.endswith(".png"):
                continue
            yield float(name[:-4]) * 1e-9, _imread_gray(os.path.join(cam0, name))


@dataclass
class EurocStereoSequence:
    """EuRoC MAV: mav0/cam0,cam1 with rectification from the settings'
    LEFT.*/RIGHT.* matrices (reference stereo_euroc.cc:70-115)."""

    root: str               # .../mav0
    rect: dict | None = None  # keys LEFT.K, LEFT.D, LEFT.R, LEFT.P, RIGHT.* (numpy)

    def _rect_maps(self, shape):
        r = self.rect
        h, w = shape
        m = {}
        for side in ("LEFT", "RIGHT"):
            K = r[f"{side}.K"]
            D = r[f"{side}.D"]
            R = r[f"{side}.R"]
            P = r[f"{side}.P"]
            m[side] = undistort_rectify_map(K, D, R, P[:3, :3], (w, h))
        return m

    def __iter__(self):
        cam0 = os.path.join(self.root, "cam0", "data")
        cam1 = os.path.join(self.root, "cam1", "data")
        names = sorted(os.listdir(cam0))
        maps = None
        for name in names:
            if not name.endswith(".png"):
                continue
            t = float(name[:-4]) * 1e-9
            left = _imread_gray(os.path.join(cam0, name))
            right_path = os.path.join(cam1, name)
            if not os.path.exists(right_path):
                continue
            right = _imread_gray(right_path)
            if self.rect is not None:
                if maps is None:
                    maps = self._rect_maps(left.shape)
                left = remap_linear(left, *maps["LEFT"])
                right = remap_linear(right, *maps["RIGHT"])
            yield t, left, right


def run_sequence(system, sequence, sensor: str, max_frames: int | None = None):
    """Drive a SlamSystem over a dataset sequence (the example-binary loop,
    mono_tum.cc:72-123, without the real-time pacing sleep)."""
    n = 0
    for item in sequence:
        if sensor == "rgbd":
            t, img, depth = item
            system.track_rgbd(img, depth, t)
        elif sensor == "stereo":
            t, left, right = item
            system.track_stereo(left, right, t)
        else:
            t, img = item
            system.track_monocular(img, t)
        n += 1
        if max_frames and n >= max_frames:
            break
    return n
