"""Local mapping, module by module: the port against the JAX package on a
map that a JAX run built.

The JAX ``SlamSystem`` tracks 9 frames of the ``tests/test_e2e.py`` RGB-D
scenario (SyntheticWorld seed 3, lateral motion, 320x240, 500 features, 4
levels, map 24 keyframes x 4096 points x 8 observations), inserting
keyframes at frames 0, 4, 6 and 8.  Its map is captured just before local
mapping runs for keyframe 3, and the mapping steps are replayed here with
the JAX functions; each port function takes the same input state (carried
across with ``io/convert.py``) and must give:

- integer banks (slots, observations, keyframe back pointers, masks,
  selections) equal;
- triangulated positions within 1e-4 m;
- point statistics within 1e-5;
- dense LM, 5 iterations: poses within 1e-4 and points within 1e-4 m;
  ``classify_outliers`` equal except within 1e-4 of the chi2 threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.backend import local_mapping as JLM
from refactored_orb_slam2_tpu.frontend import tracking_kernels as JTK
from refactored_orb_slam2_tpu.geometry import se3 as jse3
from refactored_orb_slam2_tpu.geometry.triangulation import triangulate_dlt as j_dlt
from refactored_orb_slam2_tpu.models import map_ops as JMO
from refactored_orb_slam2_tpu.models import map_state as JMS
from refactored_orb_slam2_tpu.optim import bundle_adjustment as JBA
from refactored_orb_slam2_tpu.optim import residuals as jres
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.config import (
    CameraConfig, MapConfig, ORBConfig, SystemConfig, camera_from_config as j_cam,
)
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld
from refactored_orb_slam2_tpu_torch.backend import local_mapping as TLM
from refactored_orb_slam2_tpu_torch.frontend import tracking_kernels as TTK
from refactored_orb_slam2_tpu_torch.geometry.camera import camera_from_config as t_cam
from refactored_orb_slam2_tpu_torch.geometry.triangulation import triangulate_dlt as t_dlt
from refactored_orb_slam2_tpu_torch.io.convert import (
    ba_problem_from_numpy, config_from_reference, frame_from_numpy, map_state_from_numpy, map_state_to_numpy,
)
from refactored_orb_slam2_tpu_torch.models import map_ops as TMO
from refactored_orb_slam2_tpu_torch.models import map_state as TMS
from refactored_orb_slam2_tpu_torch.optim import bundle_adjustment as TBA

# One intra-op thread: at these sizes PyTorch's threads gain nothing, and
# several test workers with a thread per core each spin against one another.
# Every file that runs the port's whole system sets it, so the setting holds
# whichever files a run selects.
torch.set_num_threads(1)

CFG = SystemConfig(
    sensor="rgbd",
    camera=CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                        width=320, height=240, fps=10),
    orb=ORBConfig(n_features=500, n_levels=4),
    map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8,
                  fuse_neighbors=4, triangulate_neighbors=4),
)
TCFG = config_from_reference(CFG)        # the port's own config tree
SF, NL = 1.2, 4
KF = 3                                  # the keyframe being mapped
NN = N_NB = 4
T_CAP = 3 * NN + 2
INT_BANKS = ("kf_point_idx", "pt_valid", "pt_obs_kf", "pt_obs_feat", "pt_ref_kf",
             "pt_first_kf", "kf_valid", "kf_parent", "pt_visible", "pt_found")


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def lateral_traj(n, step=0.06):
    motion = np.asarray(jse3.exp(jnp.asarray([step, 0, 0, 0, 0, 0], jnp.float32)))
    out = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        out.append(motion @ out[-1])
    return np.stack(out)


@pytest.fixture(scope="module")
def run():
    """The JAX run, with the map captured before mapping keyframe 3."""
    world = SyntheticWorld.create(seed=3, n_points=500, x_range=(-6, 6),
                                  y_range=(-2.5, 2.5), z_range=(2.5, 10.0),
                                  clear_tube=0.0)
    slam = JSlam(CFG)
    slam.loop_closing_enabled = False
    captured = {}
    core = slam._mapping_core

    def capture(kf_slot):
        captured[kf_slot] = dict(map=np_tree(slam.map), n_pt=slam.n_pt,
                                 ref_kf=slam.ref_kf)
        core(kf_slot)

    slam._mapping_core = capture
    rng = np.random.default_rng(1)
    for i, T in enumerate(lateral_traj(9)):
        img = world.render(T, slam.cam, noise=2.0, rng=rng)
        assert slam.track_rgbd(img, world.render_depth(T, slam.cam), i * 0.1) is not None
    assert slam.n_kf == 4 and KF in captured
    snap = captured[KF]
    return dict(slam=slam, S0=snap["map"], n_pt=snap["n_pt"], ref_kf=snap["ref_kf"],
                last_frame=np_tree(slam.last_frame), final=np_tree(slam.map))


@pytest.fixture(scope="module")
def chain(run):
    """The mapping steps of keyframe 3 replayed with the JAX functions, in
    the order of ``SlamSystem._mapping_steps``; every state kept as numpy."""
    jcam = j_cam(CFG.camera)
    S0 = jax.tree.map(jnp.asarray, run["S0"])
    P = S0.pt_pos.shape[0]
    ws = JLM.mapping_work_sets(S0, jnp.int32(KF), jnp.int32(run["ref_kf"]), nn=NN,
                               t_cap=T_CAP, n_neighbors=N_NB)
    S1, n_new = JLM.triangulate_with_neighbors(
        S0, jnp.int32(KF), ws[0], jcam, jnp.int32(run["n_pt"]), max_new=64,
        scale_factor=SF, n_levels=NL, min_baseline_ratio=0.005)
    S2 = JLM.fuse_into_keyframes(S1, ws[1], jcam, None, budget=1024, scale_factor=SF,
                                 n_levels=NL, cand_idx=S1.kf_point_idx[KF])
    obs = S2.pt_obs_kf
    tgt = S2.pt_valid & jnp.any(jnp.any(obs[:, :, None] == ws[1][None, None, :], -1)
                                & (obs >= 0), axis=1)
    S3 = JLM.fuse_into_keyframe(S2, jnp.int32(KF), jcam, tgt, budget=2048,
                                scale_factor=SF, n_levels=NL)
    reserved_end = min(run["n_pt"] + 64 * N_NB, P)
    S4 = JLM.cull_recent_map_points(S3, jnp.int32(KF), jnp.int32(reserved_end))
    S5 = JMS.update_point_stats_subset(S4, S4.kf_point_idx[KF], scale_factor=SF,
                                       n_levels=NL)
    inv_s2 = run["slam"].inv_sigma2_table
    gathered = JMO.gather_ba_window(S5, ws[4], ws[5], inv_s2, max_kfs=64,
                                    max_points=4096, max_obs=16)
    return dict(ws=np_tree(ws), S1=np_tree(S1), n_new=int(n_new), tgt=np.asarray(tgt),
                S2=np_tree(S2), S3=np_tree(S3), S4=np_tree(S4), S5=np_tree(S5),
                reserved_end=reserved_end, inv_s2=inv_s2, gathered=np_tree(gathered))


def _port(state_np):
    return map_state_from_numpy(state_np)


def _assert_banks(got, ref, int_banks=INT_BANKS, pos_atol=None):
    g = map_state_to_numpy(got)
    for name in int_banks:
        np.testing.assert_array_equal(g[name], np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(g["pt_desc"], np.asarray(ref.pt_desc))
    if pos_atol is not None:
        valid = g["pt_valid"]
        np.testing.assert_allclose(g["pt_pos"][valid], np.asarray(ref.pt_pos)[valid],
                                   atol=pos_atol)


def test_covisibility_and_best_covisible_equal(run):
    S0 = run["S0"]
    ref = np.asarray(JMS.covisibility_matrix(jax.tree.map(jnp.asarray, S0)))
    got = TMS.covisibility_matrix(_port(S0))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[KF].max() > 15
    j_idx, j_w = JMS.best_covisible(jnp.asarray(ref), KF, 3)
    t_idx, t_w = TMS.best_covisible(got, KF, 3)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))


def test_mapping_work_sets_equal(run, chain):
    got = TLM.mapping_work_sets(_port(run["S0"]), KF, run["ref_kf"], nn=NN,
                                t_cap=T_CAP, n_neighbors=N_NB)
    for g, r in zip(got, chain["ws"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (np.asarray(chain["ws"][0]) >= 0).sum() >= 2       # triangulation pairs
    assert np.asarray(chain["ws"][4]).sum() >= 3              # BA window


def test_triangulate_dlt_within_1e4():
    rng = np.random.default_rng(2)
    pw = rng.uniform([-2, -2, 3], [2, 2, 8], (200, 3)).astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(jse3.exp(jnp.asarray([0.3, 0.05, 0, 0.01, 0.05, 0], jnp.float32)))
    proj = lambda T: (pw @ T[:3, :3].T + T[:3, 3])[:, :2] / (pw @ T[:3, :3].T + T[:3, 3])[:, 2:]
    x1 = (proj(T1) + rng.normal(0, 1e-3, (200, 2))).astype(np.float32)
    x2 = (proj(T2) + rng.normal(0, 1e-3, (200, 2))).astype(np.float32)
    ref = np.asarray(j_dlt(jnp.asarray(T1[:3]), jnp.asarray(T2[:3]), jnp.asarray(x1),
                           jnp.asarray(x2)))
    got = t_dlt(*(torch.from_numpy(a.copy()) for a in (T1[:3], T2[:3], x1, x2))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_triangulate_with_neighbor_equal(run):
    S0 = run["S0"]
    jcam = j_cam(CFG.camera)
    nb = 2
    ref, n_ref = JLM.triangulate_with_neighbor(
        jax.tree.map(jnp.asarray, S0), jnp.int32(KF), jnp.int32(nb), jcam,
        jnp.int32(run["n_pt"]), max_new=64, scale_factor=SF, n_levels=NL,
        min_baseline_ratio=0.005)
    got, n_got = TLM.triangulate_with_neighbor(
        _port(S0), KF, nb, t_cam(TCFG.camera), run["n_pt"], max_new=64,
        scale_factor=SF, n_levels=NL, min_baseline_ratio=0.005)
    assert int(n_got) == int(n_ref) > 0
    _assert_banks(got, ref, pos_atol=1e-4)


@pytest.mark.parametrize("base", ["n_pt", "near_full"])
def test_triangulate_with_neighbors_equal(run, chain, base):
    """All listed neighbours from the map's next free slot, and from 100
    slots before the end of the bank, where the stop test runs on the
    device."""
    S0 = run["S0"]
    P = S0.pt_pos.shape[0]
    pt_base = run["n_pt"] if base == "n_pt" else P - 100
    neighbors = np.asarray(chain["ws"][0])
    if base == "n_pt":
        ref, n_ref = jax.tree.map(jnp.asarray, chain["S1"]), chain["n_new"]
    else:
        ref, n_ref = JLM.triangulate_with_neighbors(
            jax.tree.map(jnp.asarray, S0), jnp.int32(KF), jnp.asarray(neighbors),
            j_cam(CFG.camera), jnp.int32(pt_base), max_new=64, scale_factor=SF,
            n_levels=NL, min_baseline_ratio=0.005)
    got, n_got = TLM.triangulate_with_neighbors(
        _port(S0), KF, neighbors.tolist(), t_cam(TCFG.camera), pt_base, max_new=64,
        scale_factor=SF, n_levels=NL, min_baseline_ratio=0.005)
    assert int(n_got) == int(n_ref) > 0
    _assert_banks(got, ref, pos_atol=1e-4)


def test_fuse_into_keyframes_direction_1_equal(chain):
    S1 = chain["S1"]
    got = TLM.fuse_into_keyframes(
        _port(S1), np.asarray(chain["ws"][1]).tolist(), t_cam(TCFG.camera), budget=1024,
        scale_factor=SF, n_levels=NL, cand_idx=torch.from_numpy(S1.kf_point_idx[KF]))
    ref = chain["S2"]
    _assert_banks(got, ref)
    # the fuse did something: observations were added or points merged
    assert not np.array_equal(ref.pt_obs_kf, S1.pt_obs_kf)


def test_fuse_into_keyframe_direction_2_equal(chain):
    got = TLM.fuse_into_keyframe(
        _port(chain["S2"]), KF, t_cam(TCFG.camera), torch.from_numpy(chain["tgt"]),
        budget=2048, scale_factor=SF, n_levels=NL)
    _assert_banks(got, chain["S3"])


def test_fuse_single_target_with_candidates_equal(chain):
    S1 = chain["S1"]
    target = int(np.asarray(chain["ws"][1])[0])
    ref = JLM.fuse_into_keyframe(
        jax.tree.map(jnp.asarray, S1), jnp.int32(target), j_cam(CFG.camera), None,
        budget=1024, scale_factor=SF, n_levels=NL, cand_idx=jnp.asarray(S1.kf_point_idx[KF]))
    got = TLM.fuse_into_keyframe(
        _port(S1), target, t_cam(TCFG.camera), budget=1024, scale_factor=SF, n_levels=NL,
        cand_idx=torch.from_numpy(S1.kf_point_idx[KF]))
    _assert_banks(got, ref)


def test_cull_recent_map_points_equal(chain):
    got = TLM.cull_recent_map_points(_port(chain["S3"]), KF, chain["reserved_end"])
    _assert_banks(got, chain["S4"])


def test_update_point_stats_subset_within_1e5(chain):
    S4 = chain["S4"]
    got = TMS.update_point_stats_subset(_port(S4), torch.from_numpy(S4.kf_point_idx[KF]),
                                        scale_factor=SF, n_levels=NL)
    ref = chain["S5"]
    g = map_state_to_numpy(got)
    np.testing.assert_array_equal(g["pt_desc"], ref.pt_desc)
    for name in ("pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(g[name], getattr(ref, name), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    changed = (ref.pt_normal != S4.pt_normal).any(axis=1)
    assert changed.sum() > 50


def test_gather_ba_window_equal(chain):
    ws = chain["ws"]
    got = TMO.gather_ba_window(
        _port(chain["S5"]), torch.from_numpy(np.asarray(ws[4])),
        torch.from_numpy(np.asarray(ws[5])), torch.from_numpy(chain["inv_s2"]),
        max_kfs=64, max_points=4096, max_obs=16)
    prob_r, *sel_r = chain["gathered"]
    prob_g, *sel_g = got
    for g, r in zip(sel_g, sel_r):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for name in prob_r._fields:
        g, r = getattr(prob_g, name).numpy(), np.asarray(getattr(prob_r, name))
        if r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)
    assert prob_r.kf_fixed[prob_r.kf_valid].any() and prob_r.point_valid.sum() > 100


def test_lm_chunk_dense_5_iterations_and_outliers(chain):
    prob_np = chain["gathered"][0]
    jprob = jax.tree.map(jnp.asarray, prob_np)
    jcam, tcam = j_cam(CFG.camera), t_cam(TCFG.camera)
    jp, jx, jl = JBA.lm_chunk(jcam, jprob, jprob.kf_poses, jprob.points, jnp.float32(1e-4),
                              n_iters=5, use_huber=True, solver="dense", n_cg=0)
    tprob = ba_problem_from_numpy(prob_np)
    tp, tx, tl = TBA.lm_chunk(tcam, tprob, tprob.kf_poses, tprob.points,
                              torch.tensor(1e-4), n_iters=5, use_huber=True)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    ok = prob_np.point_valid
    np.testing.assert_allclose(tx.numpy()[ok], np.asarray(jx)[ok], atol=1e-4)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    moved = np.abs(np.asarray(jx)[ok] - prob_np.points[ok]).max()
    assert moved > 1e-4                          # the LM did move the points

    ref = np.asarray(JBA.classify_outliers(jcam, jprob, jp, jx))
    got = TBA.classify_outliers(tcam, tprob, tp, tx).numpy()
    # chi2 of the JAX result, to exempt edges within 1e-4 of the threshold
    chi2 = np.asarray(JBA._edge_terms(jcam, jprob, jp, jx, False)[4])
    th = np.where(prob_np.obs_is_stereo, jres.CHI2_STEREO, jres.CHI2_MONO)
    near = np.abs(chi2 - th) < 1e-4
    np.testing.assert_array_equal(got[~near], ref[~near])
    assert (prob_np.obs_valid & ~ref).sum() > 0  # some outliers were dropped


def test_scatter_ba_window_equal(chain):
    prob_np, kf_sel, pt_sel, obs_sel, _ = chain["gathered"]
    jprob = jax.tree.map(jnp.asarray, prob_np)
    jcam = j_cam(CFG.camera)
    jp, jx, _ = JBA.lm_chunk(jcam, jprob, jprob.kf_poses, jprob.points, jnp.float32(1e-4),
                             n_iters=5, use_huber=True, solver="dense", n_cg=0)
    valid = JBA.classify_outliers(jcam, jprob, jp, jx)
    ref = JMO.scatter_ba_window(jax.tree.map(jnp.asarray, chain["S5"]), jprob,
                                jnp.asarray(kf_sel), jnp.asarray(pt_sel),
                                jnp.asarray(obs_sel), jp, jx, valid)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = TMO.scatter_ba_window(_port(chain["S5"]), ba_problem_from_numpy(prob_np),
                                t(kf_sel), t(pt_sel), t(obs_sel), t(jp), t(jx), t(valid))
    _assert_banks(got, ref)
    g = map_state_to_numpy(got)
    np.testing.assert_array_equal(g["kf_pose"], np.asarray(ref.kf_pose))
    np.testing.assert_array_equal(g["pt_pos"], np.asarray(ref.pt_pos))


def test_keyframe_redundancy_and_remove_keyframe_equal(run):
    final = run["final"]
    jstate = jax.tree.map(jnp.asarray, final)
    tstate = _port(final)
    slots = np.array([0, 1, 2, 3, 3, 0], np.int32)
    ref = np.asarray(jax.vmap(lambda c: JLM.keyframe_redundancy(jstate, c))(
        jnp.asarray(slots)))
    got = TLM.keyframe_redundancy(tstate, torch.from_numpy(slots)).numpy()
    np.testing.assert_array_equal(got, ref)
    for k in (1, 2):
        single = float(JLM.keyframe_redundancy(jstate, jnp.int32(k)))
        assert float(TLM.keyframe_redundancy(tstate, torch.tensor([k]))[0]) == single
    assert (ref > 0).any()
    for k in (1, 2):
        _assert_banks(TLM.remove_keyframe(tstate, k),
                      JLM.remove_keyframe(jstate, jnp.int32(k)))


def test_match_reference_kf_equal(run):
    final, frame = run["final"], run["last_frame"]
    ref_kf = 2
    ref = JTK.match_reference_kf(
        jax.tree.map(jnp.asarray, frame), jnp.asarray(final.kf_desc[ref_kf]),
        jnp.asarray(final.kf_point_idx[ref_kf]), jnp.asarray(final.kf_feat_valid[ref_kf]),
        jnp.asarray(final.kf_angle[ref_kf]), jnp.asarray(final.pt_valid),
        nn_ratio=CFG.matcher.nn_ratio_ref_kf)
    tstate = _port(final)
    got = TTK.match_reference_kf(
        frame_from_numpy(frame), tstate.kf_desc[ref_kf], tstate.kf_point_idx[ref_kf],
        tstate.kf_feat_valid[ref_kf], tstate.kf_angle[ref_kf], tstate.pt_valid,
        nn_ratio=CFG.matcher.nn_ratio_ref_kf)
    np.testing.assert_array_equal(got.pt_idx.numpy(), np.asarray(ref.pt_idx))
    assert int(got.n_matches) == int(ref.n_matches) > 30
