"""``match_vo_points`` (the temporal points of localization-only mode)
against the JAX package, on a JAX-built last frame.

A JAX ``SlamSystem`` tracks 4 RGB-D frames of the ``tests/test_e2e.py``
localization scenario (``SyntheticWorld`` seed 6, 320x240, 400 features, 4
levels).  Its last frame, the last frame's map matches and pose, and a fifth
frame built by the JAX package cross into the port through ``io/convert.py``,
so both functions see identical inputs.  The match mask and count must be
equal; the unprojected points agree within 1e-5 m (float32 products in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.frontend import tracking_kernels as JTK
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam, _encode_depth, _encode_img
from refactored_orb_slam2_tpu.utils.config import (
    CameraConfig, MapConfig, ORBConfig, SystemConfig,
)
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld
from refactored_orb_slam2_tpu_torch.frontend import tracking_kernels as TTK
from refactored_orb_slam2_tpu_torch.geometry.camera import camera_from_config
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference, frame_from_numpy
from test_torch_sequence import lateral_traj

CFG = SystemConfig(
    sensor="rgbd",
    camera=CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                        width=320, height=240, fps=10),
    orb=ORBConfig(n_features=400, n_levels=4),
    map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8,
                  fuse_neighbors=4, triangulate_neighbors=4),
)
POINT_TOL_M = 1e-5


@pytest.fixture(scope="module")
def state():
    world = SyntheticWorld.create(seed=6, n_points=450, z_range=(2.5, 9.0), clear_tube=0.0)
    traj = lateral_traj(5, step=0.05)
    slam = JSlam(CFG)
    slam.loop_closing_enabled = False
    rng = np.random.default_rng(4)
    frames = [(world.render(T, slam.cam, noise=2.0, rng=rng), world.render_depth(T, slam.cam))
              for T in traj]
    for i, (img, depth) in enumerate(frames[:4]):
        assert slam.track_rgbd(img, depth, i * 0.1) is not None
    frame = slam._jit_frame(jnp.asarray(_encode_img(frames[4][0])),
                            jnp.asarray(_encode_depth(frames[4][1])))
    pose0 = jnp.asarray(slam.velocity) @ slam.last_pose
    return slam, frame, pose0


@pytest.mark.parametrize("th", [30.0, 60.0])
def test_match_vo_points_matches_jax(state, th):
    slam, frame, pose0 = state
    last = slam.last_frame
    ref = JTK.match_vo_points(
        slam.cam, pose0, frame, last.xy, last.depth, last.valid, slam.last_pt_idx,
        last.octave, last.angle, last.desc, slam.last_pose,
        th=th, scale_factors=slam.scale_factors)
    tn = lambda x: torch.from_numpy(np.array(x))
    tlast = frame_from_numpy(jax.tree.map(np.asarray, last))
    got = TTK.match_vo_points(
        camera_from_config(config_from_reference(CFG).camera), tn(pose0),
        frame_from_numpy(jax.tree.map(np.asarray, frame)),
        tlast.xy, tlast.depth, tlast.valid, tn(slam.last_pt_idx), tlast.octave,
        tlast.angle, tlast.desc, tn(slam.last_pose),
        th=th, scale_factors=slam.scale_factors)
    mask = np.asarray(ref.mask)
    # the scenario has depth features without a map point to carry over
    n_rows = int((np.asarray(last.valid) & (np.asarray(last.depth) > 0)
                  & (np.asarray(slam.last_pt_idx) < 0)).sum())
    assert n_rows > 20 and mask.sum() > 10
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    assert int(got.n_matches) == int(ref.n_matches) == mask.sum()
    np.testing.assert_allclose(got.pw.numpy(), np.asarray(ref.pw), atol=POINT_TOL_M)
    assert (got.pw.numpy()[~mask] == 0).all()
