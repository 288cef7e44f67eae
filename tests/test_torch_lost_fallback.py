"""The port's paths off the steady tracking step, against the JAX package
on the ``tests/test_e2e.py`` RGB-D scenario (see ``test_torch_sequence.py``
for the configuration), loop closing off on both but in the last item:

- LOST: a blank frame after 6 tracked ones is lost, the next frame resets
  the system (n_kf <= 5) and the one after initializes it again;
- fallback: the camera turns 0.15 rad between two frames, the motion model
  fails and TrackReferenceKeyFrame carries the frames;
- loop closing, on by default: with ``kf_gap`` 2 both packages run loop
  detection (``_try_close_loop``) from the same keyframe on, and a default
  port system maps 40 frames of the scenario past ``loop.kf_gap + 2`` = 12
  keyframes, detecting at each from there on; none finds a loop (a
  straight lateral path has none).

Poses within 1 mm and 0.1 degree of the JAX package's.
"""

import jax.numpy as jnp
import numpy as np

from refactored_orb_slam2_tpu.geometry import se3 as jse3
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
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
    """Where the JAX package runs loop detection, the port runs it too and
    raises nothing: with ``kf_gap`` 2 from n_kf 4 on (keyframe 3, frame 8 of
    the scenario).  Both packages with loop closing at its default, on; the
    keyframes, the detection calls and the poses agree."""
    cfg = CFG.replace(loop=LoopConfig(kf_gap=2))
    frames = render(lateral_traj(12))
    out = {}
    for name in ("jax", "port"):
        slam = JSlam(cfg) if name == "jax" else TSlam(config_from_reference(cfg), device="cpu")
        assert slam.loop_closing_enabled
        detected = _count_detection(slam)
        returned = [slam.track_rgbd(img, depth, i * 0.1) for i, (img, depth) in enumerate(frames)]
        assert all(r is not None for r in returned), name
        out[name] = (slam, detected)
    (j, jd), (t, td) = out["jax"], out["port"]
    assert t.n_kf == j.n_kf >= 4
    assert td == jd and td[0] == (3, False)
    assert (t.map.kf_loop_edges.numpy() == -1).all()
    assert_poses_close(t.frame_poses(), j.frame_poses())


def _count_detection(slam) -> list:
    """Wrap ``slam._try_close_loop``; the list gets (keyframe, loop closed)
    for every keyframe that reached detection (n_kf >= kf_gap + 2)."""
    calls, inner = [], slam._try_close_loop

    def counted(kf_slot):
        closed = inner(kf_slot)
        if slam.n_kf >= slam.cfg.loop.kf_gap + 2:
            calls.append((kf_slot, bool(closed)))
        return closed

    slam._try_close_loop = counted
    return calls


def test_default_system_maps_past_twelve_keyframes_with_loop_closing():
    """A default port ``SlamSystem`` (loop closing on, ``kf_gap`` 10) over
    40 frames of the scenario: 14 keyframes, detection at every keyframe
    from n_kf 12 on, no loop, no frame lost, no global BA."""
    slam = TSlam(config_from_reference(CFG), device="cpu")
    detected = _count_detection(slam)
    for i, (img, depth) in enumerate(render(lateral_traj(40))):
        assert slam.track_rgbd(img, depth, i * 0.1) is not None, i
    assert slam.n_kf >= 13
    assert [k for k, _ in detected] == list(range(11, slam.n_kf))
    assert not any(closed for _, closed in detected)
    assert slam.stats["gba_runs"] == 0 and slam.loop_state.last_loop_kf == -1
