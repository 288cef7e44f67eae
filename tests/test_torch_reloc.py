"""Relocalization, module by module: the port against the JAX package on a
map that a JAX run built.

The JAX ``SlamSystem`` tracks 12 frames of the ``tests/test_tracking_
robustness.py`` relocalization scenario (SyntheticWorld seed 13, 8 cm
lateral steps, 320x240, 500 features, 4 levels, map 32 x 8192 x 8,
``min_frames_between_kf=1``), is blacked out for two frames (LOST), then
sees the view of frame 6 again.  Its ``_relocalize`` call on that frame is
captured with everything it reads (the frame, the map, the KeyFrameDB,
the frame id), carried across with ``io/convert.py`` and replayed in the
port with the JAX package's EPnP sets (``test_torch_epnp.jax_sets_injected``).

Asserted: the KeyFrameDB built by the port's ``add`` from the map's
keyframes within 1e-6 of the JAX bank, the covisibility matrix equal,
scores within 1e-5, the reloc candidates (both forms) and the loop
candidates of every keyframe equal; ``match_kf_points_by_projection``'s
``pt_idx`` and match count equal at both rescue settings (th 10 / dist 100,
th 3 / dist 64); one ``_relocalize`` call equal in ``ok``, the chosen
candidate, the inlier associations and ``stats``, with the pose within
1e-4.  The view passes 50 inliers after the first LM, so the same call is
replayed on both packages with stricter accept bars (``min_inliers_reloc``
80: one rescue round, accepted; 103: both rounds, accepted; 150: one round,
rejected), and each is held to the same equalities.
"""

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.frontend import tracking_kernels as JTK
from refactored_orb_slam2_tpu.models.map_state import covisibility_matrix as j_covis
from refactored_orb_slam2_tpu.place import keyframe_db as JDB
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld
from refactored_orb_slam2_tpu_torch.frontend import tracking_kernels as TTK
from refactored_orb_slam2_tpu_torch.io.convert import (
    config_from_reference, frame_from_numpy, keyframe_db_from_numpy, map_state_from_numpy,
)
from refactored_orb_slam2_tpu_torch.models.map_state import covisibility_matrix
from refactored_orb_slam2_tpu_torch.place import keyframe_db as TDB
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam, TrackState
from test_torch_epnp import jax_sets_injected
from test_tracking_robustness import make_cfg, step_x

torch.set_num_threads(1)

CFG = make_cfg(min_frames_between_kf=1)
TCFG = config_from_reference(CFG)
WORLD = dict(seed=13, n_points=800, x_range=(-6, 14), y_range=(-3, 3), z_range=(2.5, 9.0),
             clear_tube=0.0)
N_TRACK, REVISIT = 12, 6
POSE_TOL = 1e-4
# accept bars that take the rescue branches on this view (its first LM
# keeps 73 inliers, the first rescue round adds 30-36, the LM after it
# keeps 102): (bar, rescue rounds run, accepted)
STRICT = ((80, 1, True), (103, 2, True), (150, 1, False))


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def lateral(n):
    out = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        out.append(step_x(0.08) @ out[-1])
    return np.stack(out)


def db_numpy(db):
    return dict(vocab=dict(words=np.asarray(db.vocab.words), idf=np.asarray(db.vocab.idf)),
                bow=np.asarray(db.bow), valid=np.asarray(db.valid))


@pytest.fixture(scope="module")
def captured():
    """The JAX run; its relocalization call with what it read and gave."""
    world = SyntheticWorld.create(**WORLD)
    slam = JSlam(CFG)
    slam.loop_closing_enabled = False
    rng = np.random.default_rng(9)
    traj = lateral(N_TRACK)
    for i, T in enumerate(traj):
        img, depth = world.render(T, slam.cam, noise=2.0, rng=rng), world.render_depth(T, slam.cam)
        assert slam.track_rgbd(img, depth, i * 0.1) is not None
    assert slam.n_kf > 5
    black = np.zeros((240, 320), np.float32)
    for k in range(2):
        assert slam.track_rgbd(black, black, 10.0 + k * 0.1) is None
    assert slam.state == TrackState.LOST

    calls = []
    reloc = slam._relocalize

    def strict(frame, bar):
        """The same call with another accept bar, the system put back after."""
        cfg, kept = slam.cfg, (dict(slam.stats), slam.ref_kf, slam._ref_matches, slam.state)
        slam.cfg = dataclasses.replace(
            cfg, tracking=dataclasses.replace(cfg.tracking, min_inliers_reloc=bar))
        ok, pose, pt_idx = reloc(frame)
        out = dict(ok=ok, pose=None if pose is None else np.asarray(pose),
                   pt_idx=None if pt_idx is None else np.asarray(pt_idx),
                   ref_kf=slam.ref_kf, stats=dict(slam.stats))
        slam.cfg = cfg
        slam.stats, slam.ref_kf, slam._ref_matches, slam.state = kept
        return out

    def recorded(frame):
        rec = dict(frame=np_tree(frame), map=np_tree(slam.map), db=db_numpy(slam.db),
                   n_kf=slam.n_kf, n_pt=slam.n_pt, frame_id=slam.frame_id,
                   stats=dict(slam.stats))
        rec["strict"] = {bar: strict(frame, bar) for bar, _, _ in STRICT}
        ok, pose, pt_idx = reloc(frame)
        rec.update(ok=ok, pose=None if pose is None else np.asarray(pose),
                   pt_idx=None if pt_idx is None else np.asarray(pt_idx),
                   ref_kf=slam.ref_kf, stats_after=dict(slam.stats))
        calls.append(rec)
        return ok, pose, pt_idx

    slam._relocalize = recorded
    T = traj[REVISIT]
    img, depth = world.render(T, slam.cam, noise=2.0, rng=rng), world.render_depth(T, slam.cam)
    assert slam.track_rgbd(img, depth, 20.0) is not None
    assert len(calls) == 1 and calls[0]["ok"]
    return slam, calls[0], T


def _port_system(rec):
    """A port system in the state the JAX one had when it relocalized."""
    t = TSlam(TCFG, device="cpu")
    t.map = map_state_from_numpy(rec["map"])
    t.n_kf, t.n_pt, t.frame_id = rec["n_kf"], rec["n_pt"], rec["frame_id"]
    t.db = keyframe_db_from_numpy(rec["db"])
    t.vocab = t.db.vocab
    t.state = TrackState.LOST
    return t


def test_keyframe_db_on_a_jax_built_map(captured):
    _, rec, _ = captured
    m = map_state_from_numpy(rec["map"])
    jdb = JDB.KeyFrameDB(captured[0].db.vocab, CFG.map.max_keyframes)
    jdb.bow, jdb.valid = jnp.asarray(rec["db"]["bow"]), jnp.asarray(rec["db"]["valid"])
    tdb = TDB.KeyFrameDB(keyframe_db_from_numpy(rec["db"]).vocab, TCFG.map.max_keyframes)
    for k in range(rec["n_kf"]):            # the port's add on every keyframe inserted
        tdb.add(k, m.kf_desc[k], m.kf_feat_valid[k])
    for k in np.nonzero(~rec["db"]["valid"][:rec["n_kf"]])[0]:
        tdb.erase(int(k))                   # culled keyframes left the database
    np.testing.assert_allclose(tdb.bow.numpy(), rec["db"]["bow"], atol=1e-6)
    np.testing.assert_array_equal(tdb.valid.numpy(), rec["db"]["valid"])

    covis = covisibility_matrix(m)
    jcov = np.asarray(j_covis(jax.tree.map(jnp.asarray, rec["map"])))
    np.testing.assert_array_equal(covis.numpy(), jcov)
    assert (jcov >= 15).sum() > 0

    frame = frame_from_numpy(rec["frame"])
    tq = tdb.signature_of(frame.desc, frame.valid)
    jq = jdb.signature_of(jnp.asarray(rec["frame"].desc), jnp.asarray(rec["frame"].valid))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tdb.scores(tq).numpy(), np.asarray(jdb.scores(jq)), atol=1e-5)
    for cov_t, cov_j in ((covis, jnp.asarray(jcov)), (None, None)):
        tc, _ = TDB.detect_reloc_candidates(tdb, tq, cov_t)
        jc, _ = JDB.detect_reloc_candidates(jdb, jq, cov_j)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert int(tc[0]) >= 0
    for k in range(rec["n_kf"]):
        tc, ts = TDB.detect_loop_candidates(tdb, tdb.bow[k], k, covis)
        jc, js = JDB.detect_loop_candidates(jdb, jdb.bow[k], k, jnp.asarray(jcov))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("th,max_dist", [(10.0, 100), (3.0, 64)])
def test_rescue_search_equal(captured, th, max_dist):
    """At the pose JAX accepted, with every second association dropped, so
    that the search has landmarks left to find."""
    slam, rec, _ = captured
    cand = rec["ref_kf"]
    N = rec["pt_idx"].shape[0]
    existing = np.where(np.arange(N) % 2 == 0, rec["pt_idx"], -1).astype(np.int32)
    jm, tm = jax.tree.map(jnp.asarray, rec["map"]), map_state_from_numpy(rec["map"])
    kw = dict(th=th, max_dist=max_dist, scale_factors=slam.scale_factors,
              scale_factor=CFG.orb.scale_factor, n_levels=CFG.orb.n_levels)
    j = JTK.match_kf_points_by_projection(
        slam.cam, jnp.asarray(rec["pose"]), jax.tree.map(jnp.asarray, rec["frame"]),
        jm.kf_point_idx[cand], jm.kf_feat_valid[cand], jm.kf_angle[cand], jm.pt_pos,
        jm.pt_valid, jm.pt_desc, jm.pt_max_dist, jnp.asarray(existing), **kw)
    t = TTK.match_kf_points_by_projection(
        _port_system(rec).cam, torch.from_numpy(rec["pose"].copy()), frame_from_numpy(rec["frame"]),
        tm.kf_point_idx[cand], tm.kf_feat_valid[cand], tm.kf_angle[cand], tm.pt_pos,
        tm.pt_valid, tm.pt_desc, tm.pt_max_dist, torch.from_numpy(existing), **kw)
    np.testing.assert_array_equal(t.pt_idx.numpy(), np.asarray(j.pt_idx))
    assert int(t.n_matches) == int(j.n_matches) > 0


def test_relocalize_equal_with_the_jax_sets(captured):
    _, rec, _ = captured
    t = _port_system(rec)
    t.stats.update(relocs=rec["stats"]["relocs"], reloc_rejects=rec["stats"]["reloc_rejects"])
    with jax_sets_injected():
        ok, pose, pt_idx = t._relocalize(frame_from_numpy(rec["frame"]))
    assert ok and rec["ok"]
    assert t.ref_kf == rec["ref_kf"] and t.state == TrackState.OK
    assert [r["cand"] for r in t.reloc_log if r["accepted"]] == [rec["ref_kf"]]
    np.testing.assert_array_equal(pt_idx.numpy(), rec["pt_idx"])
    np.testing.assert_allclose(pose.numpy(), rec["pose"], atol=POSE_TOL)
    for key in ("relocs", "reloc_rejects"):
        assert t.stats[key] == rec["stats_after"][key], key


@pytest.mark.parametrize("bar,rounds,accepted", STRICT)
def test_rescue_rounds_of_relocalize_equal_with_the_jax_sets(captured, bar, rounds, accepted):
    _, rec, _ = captured
    j = rec["strict"][bar]
    t = _port_system(rec)
    t.cfg = t.cfg.replace(tracking=dataclasses.replace(t.cfg.tracking, min_inliers_reloc=bar))
    t.stats.update(relocs=rec["stats"]["relocs"], reloc_rejects=rec["stats"]["reloc_rejects"])
    with jax_sets_injected():
        ok, pose, pt_idx = t._relocalize(frame_from_numpy(rec["frame"]))
    assert ok == j["ok"] == accepted
    assert [r["rescue_rounds"] for r in t.reloc_log] == [rounds]
    for key in ("relocs", "reloc_rejects"):
        assert t.stats[key] == j["stats"][key], key
    if accepted:
        assert t.ref_kf == j["ref_kf"] and t.reloc_log[0]["lm_inliers"][-1] >= bar
        np.testing.assert_array_equal(pt_idx.numpy(), j["pt_idx"])
        np.testing.assert_allclose(pose.numpy(), j["pose"], atol=POSE_TOL)


def test_relocalized_pose_is_right(captured):
    """The JAX result itself, against the rendered pose: within 5 cm."""
    _, rec, T = captured
    c_est = -(rec["pose"][:3, :3].T @ rec["pose"][:3, 3])
    assert np.linalg.norm(c_est - (-(T[:3, :3].T @ T[:3, 3]))) < 0.05
