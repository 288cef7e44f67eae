"""The ``tests/test_e2e.py`` monocular scenario on both packages: 14 lateral
frames of 6 cm (``SyntheticWorld`` seed 7, noise seed 5, 320x240, 600
features, 4 levels, map 24 x 4096 x 8), synchronous mapping, loop closing
off on both.

The JAX package draws the initializer's minimal sets with ``jax.random``
from ``PRNGKey(frame_id)``; PyTorch cannot reproduce those draws.  So the
port runs twice:

- with the JAX package's sets handed to its sampler (``draw_minimal_sets``
  replaced by the JAX package's own two calls, seeded with the port
  generator's seed, which is the frame id).  Asserted: initialization at
  the same frame with the same model (``is_h``), the same keyframes at the
  same frame ids, ``n_pt`` within 1%, the Sim3-aligned ATE of both under
  0.05 m and within 0.5 mm of each other (measured: 0.00486 and 0.00492 m,
  n_pt 1011 on both);
- with its own sampler (a CPU ``torch.Generator`` seeded with the frame
  id): state OK, at least 10 frames tracked, ATE under 0.05 m (measured:
  13 frames, 0.0036 m).

A monocular keyframe gets no depth points, so every point after the
initial map comes from triangulation through the masked best-2 search.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.solvers import initializer as jinit
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.config import (
    CameraConfig, MapConfig, ORBConfig, SystemConfig,
)
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld, ate_rmse_sim3
from refactored_orb_slam2_tpu_torch import system as tsystem
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.solvers import initializer as tinit
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam, TrackState
from test_torch_initializer import jax_sets
from test_torch_sequence import gt_centers, lateral_traj

CFG = SystemConfig(
    sensor="monocular",
    camera=CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                        width=320, height=240, fps=10),
    orb=ORBConfig(n_features=600, n_levels=4),
    map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8,
                  fuse_neighbors=4, triangulate_neighbors=4),
)
TCFG = config_from_reference(CFG)
ATE_BOUND_M = 0.05
ATE_APART_M = 5e-4


def _ate(slam, traj):
    return ate_rmse_sim3(slam.camera_centers(), gt_centers(traj)[slam.tracked_frame_ids()])


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld.create(seed=7, n_points=500, x_range=(-6, 6),
                                  y_range=(-2.5, 2.5), z_range=(2.5, 10.0), clear_tube=0.0)
    traj = lateral_traj(14, step=0.06)
    cam = TSlam(TCFG, device="cpu").cam
    rng = np.random.default_rng(5)
    frames = [world.render(T, cam, noise=2.0, rng=rng) for T in traj]

    inits = {"jax": [], "injected": [], "own": []}
    j_init, t_init, t_draw = (jinit.initialize_two_view, tsystem.initialize_two_view,
                              tinit.draw_minimal_sets)

    def recorded(fn, log):
        def run(*a, **k):
            res = fn(*a, **k)
            log.append((bool(res.success), bool(res.is_h), int(res.n_good)))
            return res
        return run

    def sets_of_jax(valid, n_hyps, generator):
        assert n_hyps == jinit.N_HYPS
        return torch.from_numpy(jax_sets(valid.numpy(), generator.initial_seed()))

    out = {}
    try:
        for name in inits:
            slam = JSlam(CFG) if name == "jax" else TSlam(TCFG, device="cpu")
            slam.loop_closing_enabled = False
            jinit.initialize_two_view = recorded(j_init, inits["jax"])
            tsystem.initialize_two_view = recorded(t_init, inits[name])
            tinit.draw_minimal_sets = sets_of_jax if name == "injected" else t_draw
            n_pt_init = []
            returned = []
            for i, img in enumerate(frames):
                returned.append(slam.track_monocular(img, i * 0.1))
                if returned[-1] is not None and not n_pt_init:
                    n_pt_init.append(slam.n_pt)
            out[name] = (slam, returned, n_pt_init[0])
    finally:
        jinit.initialize_two_view = j_init
        tsystem.initialize_two_view = t_init
        tinit.draw_minimal_sets = t_draw
    return traj, out, inits


def test_mono_initializes_at_the_same_frame_with_the_same_model(runs):
    _, out, inits = runs
    first = {name: [r is not None for r in returned].index(True)
             for name, (_, returned, _) in out.items()}
    assert first["injected"] == first["jax"]
    # the accepted attempt is the last one; both chose the same model
    assert inits["jax"][-1][0] and inits["injected"][-1][0]
    assert inits["injected"][-1][1] == inits["jax"][-1][1]
    assert len(inits["injected"]) == len(inits["jax"])
    assert abs(inits["injected"][-1][2] - inits["jax"][-1][2]) <= 0.01 * inits["jax"][-1][2]


def test_mono_with_the_jax_sets_agrees_with_jax(runs):
    traj, out, _ = runs
    j, t = out["jax"][0], out["injected"][0]
    assert t.state == TrackState.OK and j.state == 1
    assert [r is None for r in out["injected"][1]] == [r is None for r in out["jax"][1]]
    assert t.n_kf == j.n_kf >= 3
    np.testing.assert_array_equal(t.map.kf_frame_id[:t.n_kf].numpy(),
                                  np.asarray(j.map.kf_frame_id)[:j.n_kf])
    assert abs(t.n_pt - j.n_pt) <= 0.01 * j.n_pt
    assert t.stats["motion_tracks"] == j.stats["motion_tracks"]
    ate_j, ate_t = _ate(j, traj), _ate(t, traj)
    assert ate_j < ATE_BOUND_M and ate_t < ATE_BOUND_M
    assert abs(ate_j - ate_t) < ATE_APART_M, (ate_j, ate_t)


def test_mono_with_its_own_sampler_tracks(runs):
    traj, out, _ = runs
    slam, returned, _ = out["own"]
    assert slam.state == TrackState.OK, "monocular init never succeeded"
    assert sum(r is not None for r in returned) >= 10
    assert _ate(slam, traj) < ATE_BOUND_M
    assert np.isfinite(slam.frame_poses()).all()


@pytest.mark.parametrize("name", ["injected", "own"])
def test_mono_map_grows_by_triangulation_only(runs, name):
    """No feature of a monocular frame has depth, so keyframes add no depth
    points; the map still grows after the initial two-view map."""
    _, out, _ = runs
    slam, _, n_pt_init = out[name]
    assert n_pt_init >= 50
    assert slam.n_pt > n_pt_init + 100
    assert (slam.last_frame.depth < 0).all() and (slam.last_frame.uvr[:, 2] < 0).all()
    # a point is triangulated from two keyframes, so it has two observations
    n_obs = (slam.map.pt_obs_kf >= 0).sum(dim=1)
    assert int(n_obs[slam.map.pt_valid].min()) >= 2


def test_mono_branches_of_the_facade():
    slam = TSlam(TCFG, device="cpu")
    frame = slam._build_frame(torch.zeros((240, 320), dtype=torch.uint8), None)
    assert not slam._initialize_depth(frame)          # refuses monocular
    assert slam._motion_window == 15.0
    assert TSlam(TCFG.replace(sensor="stereo"), device="cpu")._motion_window == 7.0
    with pytest.raises(ValueError, match="sensor"):
        TSlam(TCFG.replace(sensor="lidar"), device="cpu")
    async_slam = TSlam(TCFG, device="cpu", async_mapping=True)
    assert async_slam.mapper is not None and async_slam.sensor == "monocular"
    async_slam.shutdown()
    assert async_slam.mapper is None
    for kwargs in (dict(pipelined=True), dict(cooperative_mapping=True)):
        slam = TSlam(TCFG, device="cpu", **kwargs)
        assert (slam.pipelined, slam.cooperative) == (kwargs.get("pipelined", False),
                                                      kwargs.get("cooperative_mapping", False))
