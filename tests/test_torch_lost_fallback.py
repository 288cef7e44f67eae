"""The port's paths off the steady tracking step, against the JAX package
on the ``tests/test_e2e.py`` RGB-D scenario (see ``test_torch_sequence.py``
for the configuration), loop closing off on both:

- LOST: a blank frame after 6 tracked ones is lost, the next frame resets
  the system (n_kf <= 5) and the one after initializes it again;
- fallback: the camera turns 0.15 rad between two frames, the motion model
  fails and TrackReferenceKeyFrame carries the frames;
- loop closing (ROADMAP item 11) raises at the first keyframe where the JAX
  package would run loop detection, unless ``loop_closing_enabled`` is off.

Poses within 1 mm and 0.1 degree of the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from refactored_orb_slam2_tpu.geometry import se3 as jse3
from refactored_orb_slam2_tpu.utils.config import LoopConfig
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam
from test_torch_sequence import CFG, assert_poses_close, lateral_traj, render, run_both


def test_lost_frame_resets_and_reinitializes():
    frames = render(lateral_traj(10), blank=(6,))
    out = run_both(frames)
    for name, (slam, returned) in out.items():
        ok = [r is not None for r in returned]
        assert ok == [True] * 6 + [False, False] + [True] * 2, name
        assert slam.state == 1 and slam.n_kf == 1
        # the reset dropped the trajectory before it
        np.testing.assert_array_equal(slam.tracked_frame_ids(), [8, 9])
    (j, jr), (t, tr) = out["jax"], out["port"]
    assert t.n_pt == j.n_pt
    assert_poses_close(t.frame_poses(), j.frame_poses())


def test_reference_keyframe_fallback():
    traj = lateral_traj(10)
    turn = np.asarray(jse3.exp(jnp.asarray([0, 0, 0, 0, 0.15, 0], jnp.float32)))
    traj = np.concatenate([traj[:7], turn @ traj[7:]])
    out = run_both(render(traj))
    (j, jr), (t, tr) = out["jax"], out["port"]
    assert all(r is not None for r in tr)
    assert t.stats["ref_kf_tracks"] == j.stats["ref_kf_tracks"] >= 1
    assert t.n_kf == j.n_kf
    assert_poses_close(t.frame_poses(), j.frame_poses())


def test_loop_closing_raises_where_detection_would_run():
    """With ``kf_gap`` 2 the JAX package runs detection from n_kf 4 on
    (keyframe 3, frame 8 of the scenario); the port raises there."""
    slam = TSlam(config_from_reference(CFG.replace(loop=LoopConfig(kf_gap=2))), device="cpu")
    assert slam.loop_closing_enabled
    frames = render(lateral_traj(9))
    for i, (img, depth) in enumerate(frames[:8]):
        assert slam.track_rgbd(img, depth, i * 0.1) is not None
    assert slam.n_kf == 3
    with pytest.raises(NotImplementedError, match="item 11"):
        slam.track_rgbd(*frames[8], 0.8)
    assert slam.n_kf == 4
