"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV (a copy of the JAX
package's io/datasets.py, which imports nothing of JAX; the code below the
docstring is the original's, held equal by tests/test_torch_config.py).

Replaces the example drivers' ad-hoc loaders (reference:
mono_tum.cc:150-185 LoadImages + association logic, stereo_kitti.cc,
stereo_euroc.cc:70-115 incl. stereo rectification).  Each loader yields
(timestamp, frame-data) tuples of host arrays ready for
SlamSystem.track_*.

Images load through cv2 at the host boundary (the reference uses
cv::imread), imported inside the readers, so importing this module needs
only numpy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def _imread_gray(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


def _imread_depth(path: str, factor: float) -> np.ndarray:
    import cv2

    d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if d is None:
        raise FileNotFoundError(path)
    return d.astype(np.float32) / factor


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
        import cv2

        r = self.rect
        h, w = shape
        m = {}
        for side in ("LEFT", "RIGHT"):
            K = r[f"{side}.K"]
            D = r[f"{side}.D"]
            R = r[f"{side}.R"]
            P = r[f"{side}.P"]
            m[side] = cv2.initUndistortRectifyMap(
                K, D, R, P[:3, :3], (w, h), cv2.CV_32F
            )
        return m

    def __iter__(self):
        import cv2

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
                left = cv2.remap(left, *maps["LEFT"], cv2.INTER_LINEAR)
                right = cv2.remap(right, *maps["RIGHT"], cv2.INTER_LINEAR)
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
