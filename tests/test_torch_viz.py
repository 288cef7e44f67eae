"""The port's headless figures (``io/viz.py``) from a port system on the
CPU: ``plot_trajectory``, ``draw_frame`` and ``plot_map`` each write a PNG,
and the driver's loop (``scripts/run_dataset.py::track_frames``) draws its
overlays through ``draw_frame``.  The scenario is ``tests/test_torch_
sequence.py``'s (320x240, 500 features), 4 frames.  Skips without
matplotlib.
"""

import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu_torch.io import viz
from refactored_orb_slam2_tpu_torch.scripts.run_dataset import track_frames
from refactored_orb_slam2_tpu_torch.system import SlamSystem, TrackState
from test_torch_sequence import TCFG, gt_centers, lateral_traj, render

pytest.importorskip("matplotlib")
torch.set_num_threads(1)

PNG = b"\x89PNG\r\n\x1a\n"
N = 4


@pytest.fixture(scope="module")
def run():
    traj = lateral_traj(N)
    frames = render(traj)
    slam = SlamSystem(TCFG, device="cpu")
    for i, (img, depth) in enumerate(frames):
        assert slam.track_rgbd(img, depth, i * 0.1) is not None
    return slam, traj, frames


def _is_png(path):
    with open(path, "rb") as f:
        return f.read(8) == PNG


def test_plot_trajectory_writes_a_png(run, tmp_path):
    slam, traj, _ = run
    path = tmp_path / "traj.png"
    viz.plot_trajectory(str(path), slam.camera_centers(), gt_centers(traj))
    assert _is_png(path)


def test_draw_frame_counts_the_tracked_points(run, tmp_path):
    slam, _, frames = run
    path = tmp_path / "frame.png"
    out = viz.draw_frame(str(path), slam, frames[-1][0], frame_no=N)
    assert _is_png(path)
    assert out["state"] == str(TrackState.OK)
    n_assoc = int((slam.last_pt_idx >= 0).logical_and(slam.last_frame.valid).sum())
    assert out["matches"] + out["vo_matches"] == n_assoc > 0


def test_plot_map_writes_a_png(run, tmp_path):
    slam, _, _ = run
    path = tmp_path / "map.png"
    viz.plot_map(str(path), slam)
    assert _is_png(path)


def test_driver_loop_draws_overlays(tmp_path):
    frames = render(lateral_traj(3))
    slam = SlamSystem(TCFG, device="cpu")
    times = track_frames(slam, [(i * 0.1, img, depth) for i, (img, depth) in enumerate(frames)],
                         overlay_every=2, overlay_dir=str(tmp_path), progress=False)
    assert len(times) == 3 and min(times) > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["frame_000002.png"]
    assert _is_png(tmp_path / "frame_000002.png")
