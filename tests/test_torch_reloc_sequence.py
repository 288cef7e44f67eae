"""The ``tests/test_tracking_robustness.py:117-172`` relocalization scenario on
both packages (SyntheticWorld seed 13, noise seed 9, 16 lateral RGB-D frames
of 8 cm, 320x240, 500 features, 4 levels, map 32 x 8192 x 8,
``min_frames_between_kf=1``, loop closing off): two black frames, a view
yawed 60 degrees away from the map, then the view of frame 8 again and three
frames after it.

The JAX package draws its EPnP sets with ``jax.random``; PyTorch cannot
reproduce those draws.  So the port runs twice:

- with the JAX package's sets (``test_torch_epnp.jax_sets_injected``).
  Asserted: LOST after the black frames on both, the yawed view rejected on
  both, the relocalization at the same frame with the same ``relocs`` and
  ``reloc_rejects``, the relocalized camera centre within 1 mm of the JAX
  package's and within 5 cm of the rendered one, the frames after it
  tracked;
- with its own sampler (a CPU ``torch.Generator`` seeded with the frame
  id): the JAX test's bars only (LOST, rejected, relocalized at the revisit
  with one ``relocs``, within 5 cm, the frames after it tracked).
"""

import contextlib

import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam, TrackState
from test_torch_epnp import jax_sets_injected
from test_tracking_robustness import make_cfg, step_x, yaw

# One intra-op thread: at these sizes PyTorch's threads gain nothing, and
# several test workers with a thread per core each spin against one another.
torch.set_num_threads(1)

CFG = make_cfg(min_frames_between_kf=1)
TCFG = config_from_reference(CFG)
APART_M = 1e-3
BOUND_M = 0.05


def _centre(T):
    return -(T[:3, :3].T @ T[:3, 3])


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld.create(seed=13, n_points=800, x_range=(-6, 14), y_range=(-3, 3),
                                  z_range=(2.5, 9.0), clear_tube=0.0)
    traj = [np.eye(4, dtype=np.float32)]
    for _ in range(15):
        traj.append(step_x(0.08) @ traj[-1])
    traj = np.stack(traj)
    cam = TSlam(TCFG, device="cpu").cam
    rng = np.random.default_rng(9)
    # the frames in the JAX test's order of draws from the noise generator
    track = [(world.render(T, cam, noise=2.0, rng=rng), world.render_depth(T, cam)) for T in traj]
    black = np.zeros((240, 320), np.float32)
    T_away = yaw(1.05) @ traj[8]
    away = (world.render(T_away, cam, noise=2.0, rng=rng), world.render_depth(T_away, cam))
    revisit = [traj[8]] + [step_x(0.04 * (i + 1)) @ traj[8] for i in range(3)]
    again = [(world.render(T, cam, noise=2.0, rng=rng), world.render_depth(T, cam))
             for T in revisit]

    out = {}
    for name in ("jax", "injected", "own"):
        slam = JSlam(CFG) if name == "jax" else TSlam(TCFG, device="cpu")
        slam.loop_closing_enabled = False
        r = dict(track=[slam.track_rgbd(*f, i * 0.1) for i, f in enumerate(track)])
        r["n_kf"] = slam.n_kf
        r["black"] = [slam.track_rgbd(black, black, 10.0 + k * 0.1) for k in range(2)]
        r["state_black"] = slam.state
        r["away"] = slam.track_rgbd(*away, 20.0)
        r["state_away"], r["stats_away"] = slam.state, dict(slam.stats)
        with (jax_sets_injected() if name == "injected" else contextlib.nullcontext()):
            r["again"] = [slam.track_rgbd(*f, 30.0 + i * 0.1) for i, f in enumerate(again)]
        r["stats"] = dict(slam.stats)
        out[name] = r
    return traj, out


@pytest.mark.parametrize("name", ["jax", "injected", "own"])
def test_lost_after_the_blackout_and_the_yawed_view_rejected(runs, name):
    _, out = runs
    r = out[name]
    assert all(p is not None for p in r["track"]) and r["n_kf"] > 5
    assert r["black"] == [None, None] and r["state_black"] == TrackState.LOST
    assert r["away"] is None and r["state_away"] == TrackState.LOST
    assert r["stats_away"]["relocs"] == 0


@pytest.mark.parametrize("name", ["jax", "injected", "own"])
def test_relocalized_at_the_revisit_and_tracking_after(runs, name):
    traj, out = runs
    r = out[name]
    assert r["again"][0] is not None, "relocalization failed on a mapped view"
    assert r["stats"]["relocs"] == 1
    assert all(p is not None for p in r["again"][1:]), "tracking after reloc lost"
    assert np.linalg.norm(_centre(r["again"][0]) - _centre(traj[8])) < BOUND_M


def test_with_the_jax_sets_equal_to_jax(runs):
    _, out = runs
    j, t = out["jax"], out["injected"]
    assert [p is None for p in t["track"] + t["black"] + [t["away"]] + t["again"]] == \
        [p is None for p in j["track"] + j["black"] + [j["away"]] + j["again"]]
    assert t["n_kf"] == j["n_kf"]
    for key in ("relocs", "reloc_rejects"):
        assert t["stats_away"][key] == j["stats_away"][key], key
        assert t["stats"][key] == j["stats"][key], key
    assert np.linalg.norm(_centre(t["again"][0]) - _centre(j["again"][0])) < APART_M
    for a, b in zip(t["again"][1:], j["again"][1:]):
        assert np.linalg.norm(_centre(a) - _centre(b)) < APART_M
