"""Map banks, tracking searches and pose-only LM against the JAX package.

A JAX ``SlamSystem`` initializes on frame 0 of the rendered room fixture
(320x240, 500 features, map 24 x 4096 x 8); its ``MapState`` and frames cross
into the port through ``io/convert.py`` so both packages compute on
identical state.  Integer banks and indices must be equal; float banks
agree within 1e-5 (float32 products and norms in another order), the LM
pose within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.models import map_ops as JMO
from refactored_orb_slam2_tpu.models import map_state as JMS
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.config import (
    CameraConfig, MapConfig, ORBConfig, SystemConfig,
)
from refactored_orb_slam2_tpu_torch.frontend import tracking_kernels as TTK
from refactored_orb_slam2_tpu_torch.geometry.camera import camera_from_config
from refactored_orb_slam2_tpu_torch.io.convert import (
    config_from_reference, frame_from_numpy, map_state_from_numpy, map_state_to_numpy,
)
from refactored_orb_slam2_tpu_torch.models import map_ops as TMO
from refactored_orb_slam2_tpu_torch.models import map_state as TMS
from refactored_orb_slam2_tpu_torch.optim.pose_opt import optimize_pose
from refactored_orb_slam2_tpu_torch.utils import world3d as W

CFG = SystemConfig(
    sensor="rgbd",
    camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                        width=320, height=240),
    orb=ORBConfig(n_features=500, n_levels=4),
    map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8),
)
TCFG = config_from_reference(CFG)        # the port's own config tree
FLOAT_TOL = 1e-5


def _np(x):
    return jax.tree.map(np.array, x)


def _assert_banks(got: dict, ref, names=None):
    for name in names or got:
        g, r = got[name], np.array(getattr(ref, name))
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, atol=FLOAT_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.fixture(scope="module")
def init():
    cam = camera_from_config(TCFG.camera)
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:2]
    rng = np.random.default_rng(0)
    frames = [world.render(T, cam, want_depth=True, noise=2.0, rng=rng) for T in poses]
    jsys = JSlam(CFG)
    jsys.track_rgbd(*frames[0], 0.0)          # _initialize_depth
    assert jsys.n_kf == 1 and jsys.n_pt > 300
    from refactored_orb_slam2_tpu.system import _encode_depth, _encode_img
    import jax.numpy as jnp
    f1 = jsys._jit_frame(jnp.asarray(_encode_img(frames[1][0])),
                         jnp.asarray(_encode_depth(frames[1][1])))
    return jsys, cam, _np(jsys.last_frame), _np(f1)


def test_initialization_banks_equal(init):
    """insert_keyframe -> create_points_from_depth -> update_point_stats on
    the port reproduces the JAX _initialize_depth map."""
    jsys, cam, f0, _ = init
    n = jsys.n_feat_slots
    empty = map_state_from_numpy(_np(JMS.create_empty(CFG.map, n)))
    np.testing.assert_array_equal(
        map_state_to_numpy(TMS.create_empty(TCFG.map, n, "cpu"))["kf_desc"],
        map_state_to_numpy(empty)["kf_desc"])
    frame = frame_from_numpy(f0)
    no_pt = torch.full((n,), -1, dtype=torch.int32)
    m = TMO.insert_keyframe(empty, 0, 0, torch.eye(4), frame.xy, frame.uvr,
                            frame.octave, frame.angle, frame.desc, frame.valid, no_pt, -1)
    m, n_new = TMO.create_points_from_depth(m, 0, frame.depth, no_pt, cam,
                                            th_depth=1e9, pt_base=0, max_new=n)
    assert int(n_new) == jsys.n_pt
    m = TMS.update_point_stats(m, scale_factor=1.2, n_levels=4)
    _assert_banks(map_state_to_numpy(m), _np(jsys.map))


def test_add_observations_and_stats_on_second_keyframe(init):
    """A second keyframe observing existing points appends observations in
    the first free slot; the statistics then mix both views."""
    jsys, _, _, f1 = init
    n = jsys.n_feat_slots
    rng = np.random.default_rng(1)
    matched = np.full(n, -1, np.int32)
    feats = rng.choice(n, 200, replace=False)
    matched[feats] = rng.choice(jsys.n_pt, 200, replace=False)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.05, -0.02, 0.01]
    jm = JMO.insert_keyframe(jsys.map, 1, 1, pose, f1.xy, f1.uvr, f1.octave, f1.angle,
                             f1.desc, f1.valid, matched, 0)
    jm = JMS.update_point_stats(jm, 1.2, 4)
    tf = frame_from_numpy(f1)
    tm = TMO.insert_keyframe(map_state_from_numpy(_np(jsys.map)), 1, 1,
                             torch.from_numpy(pose), tf.xy, tf.uvr, tf.octave, tf.angle,
                             tf.desc, tf.valid, torch.from_numpy(matched), 0)
    tm = TMS.update_point_stats(tm, scale_factor=1.2, n_levels=4)
    _assert_banks(map_state_to_numpy(tm), _np(jm))
    np.testing.assert_array_equal(TMS.n_observations(tm).numpy(),
                                  np.array(JMS.n_observations(jm)))


@pytest.fixture(scope="module")
def tracked(init):
    """Motion-model match + first pose LM of frame 1 on both packages."""
    jsys, cam, f0, f1 = init
    m = jsys.map
    sf = jsys.scale_factors
    eye = np.eye(4, dtype=np.float32)
    jr = jsys._jit_motion_match(jsys.cam, eye, f1, f0.xy, jsys.last_pt_idx, f0.octave,
                                m.pt_pos, m.pt_valid, m.pt_desc, f0.angle,
                                th=15.0, scale_factors=sf, nn_max_dist=75)
    tmap = map_state_from_numpy(_np(m))
    tf0, tf1 = frame_from_numpy(f0), frame_from_numpy(f1)
    tr = TTK.match_motion_model(cam, torch.eye(4), tf1,
                                torch.from_numpy(np.array(jsys.last_pt_idx)), tf0.octave,
                                tmap.pt_pos, tmap.pt_valid, tmap.pt_desc, tf0.angle,
                                th=15.0, scale_factors=sf, nn_max_dist=75)
    inv_s2 = jsys.inv_sigma2_table[np.clip(f1.octave, 0, 3)]
    is_st = f1.uvr[:, 2] >= 0
    pidx = np.array(jr.pt_idx)
    pw = np.array(m.pt_pos)[np.clip(pidx, 0, None)]
    jo = _np(jsys._jit_pose_opt(jsys.cam, eye, pw, f1.uvr, inv_s2, pidx >= 0, is_st))
    to = optimize_pose(cam, torch.eye(4), torch.from_numpy(pw), tf1.uvr,
                       torch.from_numpy(inv_s2), torch.from_numpy(pidx >= 0),
                       torch.from_numpy(is_st))
    return jsys, cam, jr, tr, jo, to, tmap


def test_match_motion_model_equal(tracked):
    _, _, jr, tr, _, _, _ = tracked
    np.testing.assert_array_equal(tr.pt_idx.numpy(), np.array(jr.pt_idx))
    assert int(tr.n_matches) == int(jr.n_matches) >= 100


def test_optimize_pose_matches(tracked):
    _, _, _, _, jo, to, _ = tracked
    np.testing.assert_allclose(to.Tcw.numpy(), jo.Tcw, atol=1e-4)
    np.testing.assert_array_equal(to.inlier.numpy(), jo.inlier)
    assert int(to.n_inliers) == int(jo.n_inliers)
    np.testing.assert_allclose(to.chi2.numpy(), jo.chi2, rtol=1e-3, atol=1e-3)


def test_select_local_points_equal(tracked):
    jsys, cam, jr, _, jo, to, tmap = tracked
    m = jsys.map
    P = m.pt_pos.shape[0]
    pt1 = np.where(jo.inlier, np.array(jr.pt_idx), -1)
    already = np.zeros(P, bool)
    already[pt1[pt1 >= 0]] = True
    # same pose on both sides, so the comparison isolates the selection
    Tcw = jo.Tcw
    jl = _np(jsys._jit_select_local(jsys.cam, Tcw, m.pt_pos, m.pt_valid, m.pt_normal,
                                    m.pt_min_dist, m.pt_max_dist, already,
                                    budget=4096, scale_factor=1.2, n_levels=4))
    tl = TTK.select_local_points(cam, torch.from_numpy(Tcw), tmap.pt_pos, tmap.pt_valid,
                                 tmap.pt_normal, tmap.pt_min_dist, tmap.pt_max_dist,
                                 torch.from_numpy(already), budget=4096,
                                 scale_factor=1.2, n_levels=4)
    np.testing.assert_array_equal(tl.idx.numpy(), jl.idx)
    np.testing.assert_array_equal(tl.valid.numpy(), jl.valid)
    np.testing.assert_array_equal(tl.pred_level.numpy(), jl.pred_level)
    np.testing.assert_allclose(tl.uv.numpy(), jl.uv, atol=1e-3)
    np.testing.assert_allclose(tl.view_cos.numpy(), jl.view_cos, atol=FLOAT_TOL)
    assert 0 < jl.valid.sum() < 4096        # padded slots exist and are -1
    assert (jl.idx[~jl.valid] == -1).all()
