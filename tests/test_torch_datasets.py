"""The port's dataset readers and its dataset driver, on the CPU.

- The six readers of ``refactored_orb_slam2_tpu_torch/io/datasets.py``
  against the JAX package's on TUM, KITTI and EuRoC layouts written with
  cv2 (``tests/test_datasets.py``'s writers): the same timestamps, the
  arrays equal; ``run_sequence`` makes the same calls. The port reads
  PNGs with its own codec (``io/png.py``) and rectifies EuRoC frames in
  numpy, so the EuRoC stereo reader with rectification is held to the JAX
  one (cv2's initUndistortRectifyMap and remap) on the 752x480 camera too:
  the maps and the rectified frames equal (tolerance 0; the largest
  difference seen is 0, as OpenCV's vector code rounds once per
  multiply-add, which ``remap_linear`` repeats).
- ``python -m refactored_orb_slam2_tpu_torch.scripts.run_dataset rgbd_tum
  --cpu`` on a short TUM sequence written from the ``tests/test_torch_
  sequence.py`` scenario (320x240, 500 features, 4 levels, settings YAML):
  every frame tracked, the trajectory and keyframe files written, and
  ``scripts/evaluate.py`` (numpy only, used as is) reads the trajectory
  against the rendered ground truth with an ATE under 0.02 m (the bound of
  ``test_torch_sequence.py``).
- ``--async-mapping``, ``--coop``, ``--pipelined`` and ``--depth 3`` run
  on the CPU and track every frame; without ``--cpu`` on a machine without CUDA the driver exits
  non-zero naming CUDA.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from refactored_orb_slam2_tpu.io import datasets as JD
from refactored_orb_slam2_tpu.utils import presets as JP
from refactored_orb_slam2_tpu_torch.io import datasets as TD
from refactored_orb_slam2_tpu_torch.utils import presets as TP

cv2 = pytest.importorskip("cv2")

from test_datasets import _write_euroc, _write_kitti, _write_tum  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = "refactored_orb_slam2_tpu_torch.scripts.run_dataset"
N_FRAMES = 6
ATE_BOUND_M = 0.02

SETTINGS = (
    "%YAML:1.0\n\n"
    "Camera.fx: 400.0\nCamera.fy: 400.0\nCamera.cx: 160.0\nCamera.cy: 120.0\n"
    "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
    "Camera.width: 320\nCamera.height: 240\nCamera.fps: 10.0\nCamera.bf: 200.0\n"
    "Camera.RGB: 1\nDepthMapFactor: 5000.0\n"
    "ORBextractor.nFeatures: 500\nORBextractor.nLevels: 4\n"
)

READERS = {   # name -> (layout writer, reader arguments)
    "TumRgbdSequence": (_write_tum, {}),
    "TumMonoSequence": (_write_tum, {}),
    "KittiStereoSequence": (_write_kitti, {}),
    "KittiMonoSequence": (_write_kitti, {}),
    "EurocMonoSequence": (_write_euroc, {}),
    "EurocStereoSequence": (_write_euroc, {"rect": "EUROC_RECTIFICATION"}),
}


@pytest.mark.parametrize("name", list(READERS))
def test_reader_equals_the_reference(tmp_path, name):
    write, kw = READERS[name]
    write(str(tmp_path), np.random.default_rng(len(name)))
    jkw = {k: getattr(JP, v) for k, v in kw.items()}
    tkw = {k: getattr(TP, v) for k, v in kw.items()}
    j = list(getattr(JD, name)(str(tmp_path), **jkw))
    t = list(getattr(TD, name)(str(tmp_path), **tkw))
    assert len(t) == len(j) == 3
    for a, b in zip(t, j):
        assert len(a) == len(b) and a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_rectifying_reader_equals_the_reference_at_euroc_size(tmp_path):
    """Two 752x480 frame pairs (smooth ramps under noise, so the bilinear
    weights matter) through the EuRoC stereo reader with the preset's
    rectification: the port's equal to the JAX package's, both readers'
    left and right images, and the port's maps equal to cv2's."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:480, 0:752]
    for cam in ("cam0", "cam1"):
        os.makedirs(tmp_path / cam / "data")
        for i in range(2):
            img = (xx * 0.21 + yy * 0.13 * (i + 1) + rng.normal(0, 20, xx.shape)) % 256
            cv2.imwrite(str(tmp_path / cam / "data" / f"{1403636579763555584 + i * 50_000_000}.png"),
                        img.astype(np.uint8))
    j = list(JD.EurocStereoSequence(str(tmp_path), rect=JP.EUROC_RECTIFICATION))
    t = list(TD.EurocStereoSequence(str(tmp_path), rect=TP.EUROC_RECTIFICATION))
    assert len(t) == len(j) == 2
    for a, b in zip(t, j):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype == np.float32 and x.shape == (480, 752)
            assert (x == 0).mean() < 0.1                  # the border is a thin band
            np.testing.assert_array_equal(x, y)
    r = TP.EUROC_RECTIFICATION
    for side in ("LEFT", "RIGHT"):
        args = (r[f"{side}.K"], r[f"{side}.D"], r[f"{side}.R"], r[f"{side}.P"][:3, :3])
        for got, ref in zip(TD.undistort_rectify_map(*args, (752, 480)),
                            cv2.initUndistortRectifyMap(*args, (752, 480), cv2.CV_32F)):
            assert got.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(got, ref)


def test_remap_linear_equals_cv2_at_the_border():
    """Coordinates on, near and outside every edge (a neighbour outside
    reads 0), at random fractions: equal to cv2.remap's float32 result."""
    rng = np.random.default_rng(12)
    img = rng.uniform(0, 255, (30, 40)).astype(np.float32)
    mx = rng.uniform(-2.0, 42.0, (50, 60)).astype(np.float32)
    my = rng.uniform(-2.0, 32.0, (50, 60)).astype(np.float32)
    mx[0, :8] = [-1.0, -0.5, 0.0, 39.0, 39.5, 40.0, 0.25, 38.75]
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
    got = TD.remap_linear(img, mx, my)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


class _Recorder:
    def __init__(self):
        self.calls = []

    def track_rgbd(self, img, depth, t):
        self.calls.append(("rgbd", t, img.sum(), depth.sum()))

    def track_stereo(self, left, right, t):
        self.calls.append(("stereo", t, left.sum(), right.sum()))

    def track_monocular(self, img, t):
        self.calls.append(("mono", t, img.sum()))


@pytest.mark.parametrize("sensor,name", [("rgbd", "TumRgbdSequence"),
                                         ("stereo", "KittiStereoSequence"),
                                         ("monocular", "EurocMonoSequence")])
def test_run_sequence_makes_the_reference_calls(tmp_path, sensor, name):
    READERS[name][0](str(tmp_path), np.random.default_rng(7))
    calls = {}
    for mod in (JD, TD):
        rec = _Recorder()
        n = mod.run_sequence(rec, getattr(mod, name)(str(tmp_path)), sensor, max_frames=2)
        calls[mod.__name__] = (n, rec.calls)
    assert calls[JD.__name__] == calls[TD.__name__]
    assert calls[TD.__name__][0] == 2


def _write_rendered_tum(root, traj, frames):
    """A TUM RGB-D layout (rgb/, depth/ at 5000 per metre, both lists) and
    the rendered trajectory as a TUM ground-truth file."""
    from refactored_orb_slam2_tpu_torch.geometry import se3
    import torch

    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    lists = {"rgb": [], "depth": []}
    gt = []
    for i, ((img, depth), Tcw) in enumerate(zip(frames, traj)):
        t = f"{1000.0 + i * 0.1:.6f}"
        cv2.imwrite(os.path.join(root, "rgb", f"{t}.png"),
                    np.clip(np.rint(img), 0, 255).astype(np.uint8))
        cv2.imwrite(os.path.join(root, "depth", f"{t}.png"),
                    np.clip(np.rint(depth * 5000.0), 0, 65535).astype(np.uint16))
        for kind in lists:
            lists[kind].append(f"{t} {kind}/{t}.png")
        Twc = np.linalg.inv(Tcw)
        q = se3.to_quaternion(torch.from_numpy(Twc[:3, :3].astype(np.float32))).numpy()
        gt.append(f"{t} " + " ".join(f"{v:.7f}" for v in (*Twc[:3, 3], *q)))
    for kind, lines in lists.items():
        with open(os.path.join(root, f"{kind}.txt"), "w") as f:
            f.write("# rendered\n" + "\n".join(lines) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt) + "\n")


def _driver(args, **kw):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", DRIVER, *args], capture_output=True,
                          text=True, timeout=600, cwd=REPO, env=env, **kw)


def test_driver_on_the_cpu_tracks_and_evaluate_reads_it(tmp_path):
    from test_torch_sequence import lateral_traj, render

    traj = lateral_traj(N_FRAMES)
    seq = tmp_path / "seq"
    _write_rendered_tum(str(seq), traj, render(traj))
    (tmp_path / "settings.yaml").write_text(SETTINGS)
    out, out_kf = tmp_path / "traj.txt", tmp_path / "kf.txt"
    res = _driver(["rgbd_tum", "--data", str(seq), "--settings", str(tmp_path / "settings.yaml"),
                   "--cpu", "--out", str(out), "--out-kf", str(out_kf)])
    assert res.returncode == 0, res.stderr[-3000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["mode"] == "rgbd_tum" and summary["frames"] == N_FRAMES
    assert summary["median_track_ms"] > 0 and summary["fps"] > 0
    assert len(out.read_text().splitlines()) == N_FRAMES          # every frame tracked
    assert len(out_kf.read_text().splitlines()) >= 2
    ev = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "evaluate.py"),
                         "--est", str(out), "--gt", str(seq / "groundtruth.txt"), "--json"],
                        capture_output=True, text=True, timeout=120)
    assert ev.returncode == 0, ev.stderr
    r = json.loads(ev.stdout)
    assert r["poses"] == N_FRAMES and r["ate_rmse_m"] < ATE_BOUND_M


@pytest.fixture(scope="module")
def rendered_tum(tmp_path_factory):
    from test_torch_sequence import lateral_traj, render

    root = tmp_path_factory.mktemp("modes")
    traj = lateral_traj(N_FRAMES)
    _write_rendered_tum(str(root / "seq"), traj, render(traj))
    (root / "settings.yaml").write_text(SETTINGS)
    return root


@pytest.mark.parametrize("flags", [["--coop"], ["--async-mapping"], ["--pipelined"],
                                   ["--depth", "3"]])
def test_item_12_flags_exit_non_zero(rendered_tum, flags):
    """Every flag of item 12 runs and tracks every frame: ``--async-mapping``
    (mapping and loop closing on worker threads), ``--coop`` (pipelined at
    ``--depth``, 1 here), ``--pipelined`` and ``--depth 3`` (which, as in
    the JAX driver, only sets the depth of ``--coop``)."""
    out = rendered_tum / f"traj{'_'.join(flags)}.txt"
    res = _driver(["rgbd_tum", "--data", str(rendered_tum / "seq"), "--settings",
                   str(rendered_tum / "settings.yaml"), "--cpu", "--out", str(out), *flags])
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["frames"] == N_FRAMES
    assert len(out.read_text().splitlines()) == N_FRAMES


def test_driver_without_cpu_needs_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the driver would run on it")
    res = _driver(["rgbd_tum", "--data", str(tmp_path)])
    assert res.returncode != 0 and "CUDA" in res.stderr and "--cpu" in res.stderr
