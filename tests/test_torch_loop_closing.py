"""Loop closing, module by module: the port against the JAX package on a
map that a JAX run built.

The JAX ``SlamSystem`` tracks 12 frames of the ``tests/test_torch_reloc.py``
scenario (SyntheticWorld seed 13, 8 cm lateral steps, 320x240 RGB-D, 500
features, 4 levels, map 32 x 8192 x 8), loop closing off; its map and
KeyFrameDB are carried to the port with ``io/convert.py``.  A straight
path closes no loop, so each stage is staged on that map:

- ``detect``: every keyframe queried against a covisibility matrix where
  the query is connected to its least similar keyframe alone (so that the
  others are candidates) and a ``LoopState`` whose chain holds a group;
  the consistent candidates and the new chain are equal, and the
  ``kf_gap`` gates agree;
- ``compute_sim3`` between keyframe pairs, fix_scale on and off, with the
  JAX package's RANSAC sets injected: the match count, success, final
  inlier count and mask and the point pairs equal, (R, t, s) within 1e-4;
- ``search_by_sim3`` at the pairs' relative pose, with duplicated
  descriptors in the candidate keyframe so that the argmins meet ties: the
  new rows and columns equal (a tie keeps the lowest index);
- ``count_loop_projection_matches``: the counts equal;
- ``optimize_sim3`` on the JAX test's synthetic case: (R, t, s) within
  1e-4 and the inlier mask equal;
- ``_correct_loop`` on both systems with the same measured (R, t, s), SE3
  (RGB-D) and Sim3 (the same map with the sensor set to monocular), then
  the global BA: ``kf_loop_edges`` equal, keyframe poses within 1e-4 in
  rotation and 1e-3 m in translation after each step, points within 2e-3
  m, one GBA run on both;
- ``_global_ba`` (the whole-map problem, the PCG solver, the writeback with
  its outliers erased) on both: observations and back pointers equal, poses
  and points within the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.backend import loop_closing as JLC
from refactored_orb_slam2_tpu.geometry import se3 as jse3
from refactored_orb_slam2_tpu.models.map_state import covisibility_matrix as j_covis
from refactored_orb_slam2_tpu.ops import matching as JM
from refactored_orb_slam2_tpu.ops.descriptors import hamming as j_hamming
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld
from refactored_orb_slam2_tpu_torch.backend import loop_closing as TLC
from refactored_orb_slam2_tpu_torch.io.convert import (
    config_from_reference, keyframe_db_from_numpy, map_state_from_numpy,
)
from refactored_orb_slam2_tpu_torch.models.map_state import covisibility_matrix
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam
from test_torch_pose_graph import jax_sim3_sets
from test_torch_reloc import db_numpy, lateral, np_tree
from test_tracking_robustness import make_cfg

torch.set_num_threads(1)

CFG = make_cfg(min_frames_between_kf=1)
TCFG = config_from_reference(CFG)
WORLD = dict(seed=13, n_points=800, x_range=(-6, 14), y_range=(-3, 3), z_range=(2.5, 9.0),
             clear_tube=0.0)


@pytest.fixture(scope="module")
def built():
    """The JAX run's map, KeyFrameDB and counters as numpy."""
    world = SyntheticWorld.create(**WORLD)
    slam = JSlam(CFG)
    slam.loop_closing_enabled = False
    rng = np.random.default_rng(9)
    for i, T in enumerate(lateral(12)):
        img, depth = world.render(T, slam.cam, noise=2.0, rng=rng), world.render_depth(T, slam.cam)
        assert slam.track_rgbd(img, depth, i * 0.1) is not None
    assert slam.n_kf >= 6
    return dict(map=np_tree(slam.map), db=db_numpy(slam.db), n_kf=slam.n_kf, n_pt=slam.n_pt,
                ref_kf=slam.ref_kf, frame_id=slam.frame_id, jdb=slam.db)


def _systems(rec, sensor="rgbd"):
    """A JAX and a port system holding the run's map."""
    j = JSlam(CFG)
    j.map = jax.tree.map(jnp.asarray, rec["map"])
    t = TSlam(TCFG, device="cpu")
    t.map = map_state_from_numpy(rec["map"])
    t.db = keyframe_db_from_numpy(rec["db"])
    t.vocab = t.db.vocab
    for s in (j, t):
        s.n_kf, s.n_pt, s.ref_kf, s.frame_id = rec["n_kf"], rec["n_pt"], rec["ref_kf"], rec["frame_id"]
        s.last_pose = s.map.kf_pose[rec["ref_kf"]]
        s.sensor = sensor
    return j, t


def _pairs(rec):
    n = rec["n_kf"]
    return [(n - 1, n - 3), (n - 1, 1), (n - 2, 0)]


def test_detect_staged(built):
    rec = built
    tdb = keyframe_db_from_numpy(rec["db"])
    covis = np.asarray(j_covis(jax.tree.map(jnp.asarray, rec["map"])))
    np.testing.assert_array_equal(covisibility_matrix(map_state_from_numpy(rec["map"])).numpy(),
                                  covis)
    jdb = rec["jdb"]
    n_found = 0
    valid = rec["db"]["valid"]
    for k in range(rec["n_kf"]):
        # the query keeps one connected neighbour, its least similar
        # keyframe (which sets minScore), and loses the others
        scores = np.where(valid, tdb.scores(tdb.bow[k]).numpy(), np.inf)
        scores[k] = np.inf
        far = int(np.argmin(scores))
        staged = covis.copy()
        staged[k, :] = 0
        staged[:, k] = 0
        staged[k, far] = staged[far, k] = 20
        for groups, last in (([], -1), ([({0, 1}, 1), ({k}, 0)], -1), ([({0, 1, 2}, 2)], k - 1)):
            js = JLC.LoopState(consistent_groups=list(groups), last_loop_kf=last)
            ts = TLC.LoopState(consistent_groups=list(groups), last_loop_kf=last)
            jc = JLC.detect(js, jdb, staged, k, jdb.bow[k], kf_gap=2)
            tc = TLC.detect(ts, tdb, k, tdb.bow[k], torch.from_numpy(staged), kf_gap=2)
            assert tc == jc, (k, groups, last)
            assert ts.consistent_groups == js.consistent_groups
            n_found += len(tc)
    assert n_found > 0


def test_detect_orbslam2_staged(built):
    """The async mode's ``detect_orbslam2`` on the JAX run's map and
    KeyFrameDB against ORB-SLAM2's DetectLoop in numpy
    (``loop_schedule.OrbSlam2Loop``), each keyframe queried four times in a
    row on ``test_detect_staged``'s covisibility (the query connected to its
    least similar keyframe alone): every step's minScore (1e-6), candidates,
    groups and consistent candidates equal, and the fourth step accepts."""
    from loop_schedule import OrbSlam2Loop

    rec = built
    tdb = keyframe_db_from_numpy(rec["db"])
    covis = np.asarray(j_covis(jax.tree.map(jnp.asarray, rec["map"])))
    valid, bow, n = rec["db"]["valid"], np.asarray(rec["db"]["bow"]), rec["n_kf"]
    n_consistent = 0
    for k in range(n):
        scores = np.where(valid, tdb.scores(tdb.bow[k]).numpy(), np.inf)
        scores[k] = np.inf
        far = int(np.argmin(scores))
        staged = covis.copy()
        staged[k, :] = 0
        staged[:, k] = 0
        staged[k, far] = staged[far, k] = 20
        state, model = TLC.LoopState(), OrbSlam2Loop(kf_gap=2)
        for _ in range(4):
            step = {}
            got = TLC.detect_orbslam2(state, tdb, k, torch.from_numpy(staged), n, kf_gap=2,
                                      record=step)
            want = model.detect(k, bow[:n], np.nonzero(valid[:k])[0], staged[:n, :n])
            if want["min_score"] is None:
                assert got == [] and not step, k
                continue
            assert abs(step["min_score"] - want["min_score"]) <= 1e-6, k
            assert got == want["consistent"], k
            assert (step["candidates"], step["groups"]) == (want["candidates"], want["groups"])
        n_consistent += len(got)
    assert n_consistent > 0


def _jax_compute(rec, j, kf_cur, kf_cand, fix_scale, key):
    """The JAX package's candidate evaluation and the sets it drew."""
    m = j.map
    pt_c, pt_m = m.kf_point_idx[kf_cur], m.kf_point_idx[kf_cand]
    res = JM.nn_match(j_hamming(m.kf_desc[kf_cur], m.kf_desc[kf_cand]),
                      row_valid=(pt_c >= 0) & m.kf_feat_valid[kf_cur],
                      col_valid=(pt_m >= 0) & m.kf_feat_valid[kf_cand],
                      max_dist=50, ratio=0.75, mutual=True)
    scal, ints = JLC._compute_sim3_impl(m, j.cam, jnp.int32(kf_cur), jnp.int32(kf_cand), key,
                                        fix_scale=fix_scale, min_inliers=20,
                                        scale_factor=1.2, n_levels=4)
    return np.asarray(scal), np.asarray(ints), jax_sim3_sets(np.asarray(res.mask), key)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_compute_sim3_with_jax_sets(built, fix_scale):
    j, t = _systems(built)
    accepted = 0
    for kf_cur, kf_cand in _pairs(built):
        key = jax.random.PRNGKey(built["frame_id"])
        jscal, jints, sets = _jax_compute(built, j, kf_cur, kf_cand, fix_scale, key)
        tscal, tints = TLC.compute_sim3_device(t.map, t.cam, kf_cur, kf_cand,
                                               fix_scale=fix_scale, sets=sets,
                                               scale_factor=1.2, n_levels=4)
        tscal, tints = tscal.numpy(), tints.numpy()
        np.testing.assert_array_equal(tscal[:3], jscal[:3])
        np.testing.assert_allclose(tscal[3:], jscal[3:], atol=1e-4)
        np.testing.assert_array_equal(tints, jints)
        # the host wrapper's decision and pairs
        ok, R, tt, s, pairs = TLC.compute_sim3(t.map, t.cam, kf_cur, kf_cand,
                                               fix_scale=fix_scale, sets=sets,
                                               scale_factor=1.2, n_levels=4)
        jok, jR, jt, js, jpairs = JLC.compute_sim3(j.map, j.cam, kf_cur, kf_cand,
                                                   fix_scale=fix_scale, key=key,
                                                   scale_factor=1.2, n_levels=4)
        assert ok == jok
        if ok:
            accepted += 1
            np.testing.assert_array_equal(pairs, jpairs)
            np.testing.assert_allclose(R, jR, atol=1e-4)
            assert abs(s - js) < 1e-4
    assert accepted >= 1


def _relative(m, kf_cur, kf_cand):
    """S_cm = T_c T_m^-1 from the map's poses (numpy)."""
    T = np.asarray(m.kf_pose)
    rel = T[kf_cur] @ np.linalg.inv(T[kf_cand])
    return rel[:3, :3].astype(np.float32), rel[:3, 3].astype(np.float32)


def test_search_by_sim3_ties_keep_lowest(built):
    n = built["n_kf"]
    kf_cur, kf_cand = n - 1, n - 3
    # duplicate the candidate's first 40 descriptors into the next 40 slots
    desc = built["map"].kf_desc.copy()
    desc[kf_cand, 40:80] = desc[kf_cand, :40]
    rec = dict(built, map=built["map"]._replace(kf_desc=desc))
    j, t = _systems(rec)
    R, tr = _relative(rec["map"], kf_cur, kf_cand)
    N = desc.shape[1]
    rng = np.random.default_rng(0)
    rows0 = rng.random(N) < 0.3
    cols0 = rng.random(N) < 0.3
    for existing in ((np.zeros(N, bool), np.zeros(N, bool)), (rows0, cols0)):
        jr, jc = JLC.search_by_sim3(j.map, j.cam, kf_cur, kf_cand, jnp.asarray(R), jnp.asarray(tr),
                                    jnp.float32(1.0), jnp.asarray(existing[0]),
                                    jnp.asarray(existing[1]), scale_factor=1.2, n_levels=4)
        tr_, tc = TLC.search_by_sim3(t.map, t.cam, kf_cur, kf_cand, torch.from_numpy(R),
                                     torch.from_numpy(tr), torch.tensor(1.0),
                                     torch.from_numpy(existing[0]), torch.from_numpy(existing[1]),
                                     scale_factor=1.2, n_levels=4)
        np.testing.assert_array_equal(tr_.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert (tc.numpy() >= 0).sum() > 10
    # the tie rule itself, against jnp.argmin on small integers
    d = rng.integers(0, 4, (50, 70)).astype(np.int32)
    for dim in (0, 1):
        mn, first = TLC._argmin_first(torch.from_numpy(d), dim)
        np.testing.assert_array_equal(first.numpy(), np.asarray(jnp.argmin(jnp.asarray(d), axis=dim)))
        np.testing.assert_array_equal(mn.numpy(), d.min(axis=dim))


def test_count_loop_projection_matches(built):
    j, t = _systems(built)
    n = built["n_kf"]
    covis = np.asarray(j_covis(j.map))
    counts = []
    for kf_cur, kf_loop in ((n - 1, 0), (n - 1, 2), (n - 2, 1)):
        group = ((covis[kf_loop] >= 15) | (np.arange(covis.shape[0]) == kf_loop)) \
            & built["map"].kf_valid
        T = built["map"].kf_pose[kf_cur]
        R, tr = T[:3, :3], T[:3, 3]
        jn = JLC.count_loop_projection_matches(j.map, j.cam, kf_cur, jnp.asarray(group),
                                               jnp.asarray(R), jnp.asarray(tr), jnp.float32(1.0))
        tn = TLC.count_loop_projection_matches(t.map, t.cam, kf_cur, torch.from_numpy(group),
                                               torch.from_numpy(R.copy()), torch.from_numpy(tr.copy()),
                                               torch.tensor(1.0))
        assert tn == jn
        counts.append(tn)
    assert max(counts) >= 40


def test_optimize_sim3_equal():
    rng = np.random.default_rng(0)
    n = 120
    R_gt = np.asarray(jse3.so3_exp(jnp.asarray([0.1, -0.3, 0.05], jnp.float32)))
    t_gt, s_gt = np.asarray([0.6, -0.2, 0.4], np.float32), 1.25
    p_m = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 9, n)],
                   axis=1).astype(np.float32)
    p_c = (s_gt * p_m @ R_gt.T + t_gt).astype(np.float32)
    xn_c = (p_c[:, :2] / p_c[:, 2:3] + rng.normal(0, 1e-3, (n, 2))).astype(np.float32)
    xn_m = (p_m[:, :2] / p_m[:, 2:3] + rng.normal(0, 1e-3, (n, 2))).astype(np.float32)
    xn_c[:10] += 0.05                                           # outliers
    R0 = (np.asarray(jse3.so3_exp(jnp.asarray([0.05, 0.02, -0.03], jnp.float32))) @ R_gt)
    t0 = t_gt + np.asarray([0.1, -0.05, 0.08], np.float32)
    valid = np.ones(n, bool)
    for fix_scale in (False, True):
        args = (p_c, p_m, xn_c, xn_m, valid, R0.astype(np.float32), t0)
        jR, jt, js, jin = JLC.optimize_sim3(*map(jnp.asarray, args), jnp.float32(1.1),
                                            fix_scale=fix_scale, inv_sigma2=500.0 ** 2,
                                            chi2_th=10.0)
        tR, tt, ts, tin = TLC.optimize_sim3(*map(torch.from_numpy, args), torch.tensor(1.1),
                                            fix_scale=fix_scale, inv_sigma2=500.0 ** 2,
                                            chi2_th=10.0)
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
        assert abs(float(ts) - float(js)) < 1e-4
        np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
        if not fix_scale:
            assert abs(float(ts) - s_gt) < 0.01 and int(tin.sum()) > 100


def _assert_kf_poses_close(t, j, n_kf):
    tp, jp = t.map.kf_pose.numpy()[:n_kf], np.asarray(j.map.kf_pose)[:n_kf]
    np.testing.assert_allclose(tp[:, :3, :3], jp[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(tp[:, :3, 3], jp[:, :3, 3], atol=1e-3)


@pytest.mark.parametrize("sensor,s_cm", [("rgbd", 1.0), ("monocular", 1.04)])
def test_correct_loop_then_gba_equal(built, sensor, s_cm):
    j, t = _systems(built, sensor)
    n = built["n_kf"]
    kf_cur, kf_loop = n - 1, 0
    R, tr = _relative(built["map"], kf_cur, kf_loop)
    # a measured loop that disagrees with the map a little, as drift would
    turn = np.asarray(jse3.so3_exp(jnp.asarray([0.0, 0.02, 0.01], jnp.float32)))
    R = (turn @ R).astype(np.float32)
    tr = (tr + np.asarray([0.05, 0.0, 0.03], np.float32)).astype(np.float32)
    j._correct_loop(kf_cur, kf_loop, R, tr, s_cm)
    t._correct_loop(kf_cur, kf_loop, R, tr, s_cm)
    np.testing.assert_array_equal(t.map.kf_loop_edges.numpy(), np.asarray(j.map.kf_loop_edges))
    assert t.map.kf_loop_edges[kf_cur, 0] == kf_loop
    _assert_kf_poses_close(t, j, n)
    np.testing.assert_allclose(t.map.pt_pos.numpy(), np.asarray(j.map.pt_pos), atol=2e-3)
    np.testing.assert_array_equal(t.map.pt_obs_kf.numpy(), np.asarray(j.map.pt_obs_kf))
    assert t.loop_state.last_loop_kf == j.loop_state.last_loop_kf == kf_cur
    # the correction moved the current keyframe
    moved = np.abs(t.map.kf_pose.numpy()[kf_cur] - built["map"].kf_pose[kf_cur]).max()
    assert moved > 1e-3

    j._launch_gba(kf_cur)
    t._launch_gba(kf_cur)
    assert t.stats["gba_runs"] == j.stats["gba_runs"] == 1
    assert t.stats["gba_aborted"] == j.stats["gba_aborted"] == 0
    _assert_kf_poses_close(t, j, n)
    np.testing.assert_allclose(t.map.pt_pos.numpy(), np.asarray(j.map.pt_pos), atol=2e-3)
    np.testing.assert_allclose(t.last_pose.numpy(), np.asarray(j.last_pose), atol=1e-3)


def test_global_ba_with_writeback_equal(built):
    j, t = _systems(built)
    K = built["map"].kf_pose.shape[0]
    window = built["map"].kf_valid & (np.arange(K) != 0)
    fixed = np.arange(K) == 0
    j._global_ba(jnp.asarray(window), jnp.asarray(fixed), 5)
    t._global_ba(torch.from_numpy(window), torch.from_numpy(fixed), 5)
    for name in ("pt_obs_kf", "pt_obs_feat", "kf_point_idx"):
        np.testing.assert_array_equal(getattr(t.map, name).numpy(),
                                      np.asarray(getattr(j.map, name)), err_msg=name)
    _assert_kf_poses_close(t, j, built["n_kf"])
    np.testing.assert_allclose(t.map.pt_pos.numpy(), np.asarray(j.map.pt_pos), atol=2e-3)
    moved = np.abs(t.map.kf_pose.numpy() - built["map"].kf_pose).max()
    assert moved > 1e-6


def test_sim3_refused_by_the_projection_count(built, monkeypatch):
    """``_try_close_loop`` with a candidate whose Sim3 ``compute_sim3``
    accepts, and ``min_total_matches`` one above what the projection count
    gives it (LoopClosing.cc:330-373): refused on both packages, after the
    count and before any correction.  Detection is staged (a straight path
    has no loop): both ``detect`` calls give the candidate, with the loop
    gate at ``kf_gap = 2`` so that the run's keyframes reach it, and the
    port's RANSAC takes the JAX package's sets.  The count is equal on
    both; the map, ``loop_state`` and the counters are unchanged, and no
    GBA ran."""
    import dataclasses

    from refactored_orb_slam2_tpu import system as jsystem
    from refactored_orb_slam2_tpu_torch import system as tsystem

    j, t = _systems(built)
    j.db = built["jdb"]
    n = built["n_kf"]
    key = jax.random.PRNGKey(built["frame_id"])
    # the first staged pair whose Sim3 the JAX package accepts
    kf_cur, kf_cand, sets = next(
        (c, m, s) for c, m in _pairs(built)
        for s in [_jax_compute(built, j, c, m, True, key)[2]]
        if JLC.compute_sim3(j.map, j.cam, c, m, fix_scale=True, key=key, scale_factor=1.2,
                            n_levels=4)[0])
    counts = {"jax": [], "port": []}

    def staged_detect(*args, **kwargs):
        return [kf_cand]

    def counted(fn, name):
        def run(*args):
            n_proj = fn(*args)
            counts[name].append(int(n_proj))
            return n_proj
        return run

    t_compute = TLC.compute_sim3

    def with_jax_sets(state, cam, cur, cand, *, generator=None, **kwargs):
        assert generator is not None and generator.initial_seed() == built["frame_id"]
        return t_compute(state, cam, cur, cand, sets=sets, **kwargs)

    monkeypatch.setattr(jsystem.LC, "detect", staged_detect)
    monkeypatch.setattr(tsystem.LC, "detect", staged_detect)
    monkeypatch.setattr(tsystem.LC, "compute_sim3", with_jax_sets)
    monkeypatch.setattr(jsystem.LC, "count_loop_projection_matches",
                        counted(JLC.count_loop_projection_matches, "jax"))
    monkeypatch.setattr(tsystem.LC, "count_loop_projection_matches",
                        counted(TLC.count_loop_projection_matches, "port"))
    # the Sim3's matched pairs, which the bar counts beside the projections
    ok, *_, pairs = t_compute(t.map, t.cam, kf_cur, kf_cand, fix_scale=True, sets=sets,
                              scale_factor=1.2, n_levels=4)
    assert ok and len(pairs) >= 20
    # a first pass finds the count, the refused pass sits one above it
    for s in (j, t):
        s.cfg = dataclasses.replace(s.cfg, loop=dataclasses.replace(s.cfg.loop, kf_gap=2,
                                                                    min_total_matches=10**6))
        assert s._try_close_loop(kf_cur) is False
    assert counts["jax"] == counts["port"] and len(counts["port"]) == 1
    bar = counts["port"][0] + len(pairs) + 1
    banks = lambda s: {k: np.asarray(v) for k, v in (
        s.map._asdict().items() if s is j else vars(s.map).items())}
    before = {name: banks(s) for name, s in (("jax", j), ("port", t))}
    states = {name: (list(s.loop_state.consistent_groups), s.loop_state.last_loop_kf,
                     dict(s.stats)) for name, s in (("jax", j), ("port", t))}
    epochs = (t.gba_epoch, t.map_epoch)
    for name, s in (("jax", j), ("port", t)):
        s.cfg = dataclasses.replace(s.cfg, loop=dataclasses.replace(s.cfg.loop,
                                                                    min_total_matches=bar))
        assert s._try_close_loop(kf_cur) is False, name
        after = banks(s)
        assert after.keys() == before[name].keys()
        for field, a in after.items():
            np.testing.assert_array_equal(a, before[name][field], err_msg=f"{name}: {field}")
        assert (list(s.loop_state.consistent_groups), s.loop_state.last_loop_kf,
                dict(s.stats)) == states[name]
        assert s.stats["gba_runs"] == 0
    assert counts["jax"] == counts["port"] and len(counts["port"]) == 2
    assert t._gba_thread is None and (t.gba_epoch, t.map_epoch) == epochs
    assert not (t.map.kf_loop_edges >= 0).any()
