"""The point-sharded bundle adjustment in one process
(``refactored_orb_slam2_tpu_torch/parallel/dist_ba.py``) against the JAX
package's (``parallel/dist_ba.py``, sharded over conftest's 8 virtual CPU
devices), on the same numpy inputs:

- ``run_distributed_ba`` over ``[cpu] * 8`` against JAX's over
  ``make_mesh(8)`` on ``tests/test_bundle_adjustment.make_ba_problem``:
  poses within 5e-4, points within 5e-3 (``tests/test_distributed.py``'s
  tolerances);
- one shard ``torch.equal`` to ``BA.run``, for both solvers, and
  ``lm_chunk`` and ``classify_outliers`` on a one-shard problem equal to
  theirs on the unsharded one;
- the layout: 8 contiguous point slices, the camera arrays on every shard,
  a ``ValueError`` naming both numbers on an indivisible point count;
- ``_run_ba_chunked`` on ``test_torch_async.py``'s lateral map over 4
  shards against the JAX package's, at that test's tolerances;
- the system's ``_gba_worker`` with ``visible_devices`` giving 4 CPU
  entries (the sharded branch) against the JAX ``_gba_worker`` sharded over
  8 devices, merged into the same map: poses within 1e-5 (the merge test's
  tolerance in ``test_torch_async.py``), points within 5e-5 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.optim import bundle_adjustment as JBA
from refactored_orb_slam2_tpu.parallel import dist_ba as JD
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu_torch.geometry.camera import Camera
from refactored_orb_slam2_tpu_torch.optim import bundle_adjustment as TBA
from refactored_orb_slam2_tpu_torch.parallel import dist_ba as TD
from test_bundle_adjustment import make_ba_problem
from test_torch_async import _jax_map, _port_system, _problem, lateral_map  # noqa: F401
from test_torch_sequence import CFG, TCFG

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _port(jcam, jprob):
    cam = Camera.create(jcam.fx, jcam.fy, jcam.cx, jcam.cy, bf=jcam.bf)
    prob = TBA.BAProblem(**{f: torch.from_numpy(np.array(getattr(jprob, f)))
                            for f in jprob._fields})
    return cam, prob


def test_eight_shards_against_jax():
    assert len(jax.devices()) >= 8, "conftest provides 8 virtual devices"
    jcam, jprob, *_ = make_ba_problem(0, n_kf=6, n_pts=128, obs_per_pt=4)
    cam, prob = _port(jcam, jprob)
    ref = JD.run_distributed_ba(jcam, jprob, JD.make_mesh(8), iters_phase1=3)
    got = TD.run_distributed_ba(cam, prob, TD.make_mesh(devices=[CPU] * 8), iters_phase1=3)
    np.testing.assert_allclose(got.kf_poses.numpy(), np.asarray(ref.kf_poses), atol=5e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), atol=5e-3)
    assert got.points.shape == prob.points.shape and got.obs_valid.shape == prob.obs_valid.shape
    # the LM moved the cameras
    assert (got.kf_poses - prob.kf_poses).abs().max() > 1e-4


@pytest.mark.parametrize("solver", ["pcg", "dense"])
def test_one_shard_equal_to_ba_run(solver):
    jcam, jprob, *_ = make_ba_problem(2, n_kf=5, n_pts=96, obs_per_pt=4, stereo=True,
                                      outlier_frac=0.1)
    cam, prob = _port(jcam, jprob)
    kw = dict(iters_phase1=3, iters_phase2=2, solver=solver, n_cg=20)
    ref = TBA.run(cam, prob, **kw)
    got = TD.run_distributed_ba(cam, prob, TD.make_mesh(devices=[CPU]), **kw)
    for field, r, g in zip(TBA.BAResult._fields, ref, got):
        assert torch.equal(r, g), field
    # the two entry points the system's chunked schedule calls
    sharded = TD.shard_ba_problem(prob, TD.make_mesh(devices=[CPU]))
    lam = torch.full((), 1e-4)
    r_poses, r_points, r_lam = TBA.lm_chunk(cam, prob, prob.kf_poses, prob.points, lam,
                                            n_iters=2, use_huber=True, solver=solver, n_cg=20)
    (g_poses,), (g_points,), (g_lam,) = TBA.lm_chunk(
        cam, sharded, sharded.kf_poses, sharded.points, (lam,), n_iters=2, use_huber=True,
        solver=solver, n_cg=20)
    assert torch.equal(r_poses, g_poses) and torch.equal(r_points, g_points)
    assert torch.equal(r_lam, g_lam)
    (g_valid,) = TBA.classify_outliers(cam, sharded, (r_poses,), (r_points,))
    assert torch.equal(TBA.classify_outliers(cam, prob, r_poses, r_points), g_valid)


def test_sharding_layout():
    jcam, jprob, *_ = make_ba_problem(1, n_kf=4, n_pts=64, obs_per_pt=3)
    _, prob = _port(jcam, jprob)
    mesh = TD.make_mesh(devices=[CPU] * 8)
    sharded = TD.shard_ba_problem(prob, mesh)
    assert len(sharded.shards) == 8
    for i, s in enumerate(sharded.shards):
        for f in TD.POINT_FIELDS:                       # point-major: its slice
            assert torch.equal(getattr(s, f), getattr(prob, f)[8 * i:8 * (i + 1)])
        for f in ("kf_poses", "kf_fixed", "kf_valid"):  # camera arrays: replicated
            assert torch.equal(getattr(s, f), getattr(prob, f))
        assert all(getattr(s, f).device == CPU for f in TBA.BAProblem._fields)
    assert torch.equal(torch.cat(sharded.points), prob.points)
    # the in-process sum: in shard order, a tensor of its own on each shard
    totals = sharded.reduce([torch.full((2,), float(i)) for i in range(8)])
    assert len(totals) == 8 and all(torch.equal(t, torch.full((2,), 28.0)) for t in totals)
    assert len({t.data_ptr() for t in totals}) == 8
    with pytest.raises(ValueError, match="64 points .* 6 equal shards"):
        TD.shard_ba_problem(prob, TD.make_mesh(devices=[CPU] * 6))
    assert TD.make_mesh(2, devices=[CPU] * 8).devices == (CPU, CPU)
    assert TD.visible_devices("cpu") == [CPU]


def test_run_ba_chunked_four_shards_against_jax(lateral_map):
    """``test_torch_async.py::test_run_ba_chunked_against_jax`` with the
    port's problem cut over 4 shards."""
    t = _port_system(lateral_map)
    j = JSlam(CFG)
    tprob = _problem(lateral_map, t)
    jprob = JBA.BAProblem(**{f: jnp.asarray(getattr(tprob, f).numpy())
                             for f in tprob._fields})
    sharded = TD.shard_ba_problem(tprob, TD.make_mesh(devices=[CPU] * 4))
    n_cg = TCFG.map.gba_cg_iters
    tr, ts = t._run_ba_chunked(sharded, 4, 0, solver="pcg", n_cg=n_cg, chunk=2)
    jr, js = j._run_ba_chunked(jprob, 4, 0, solver="pcg", n_cg=n_cg, chunk=2)
    assert not ts and not js
    assert len(tr.points) == 4
    tr = TD.gather(tr, CPU)
    n = lateral_map["n_kf"]
    tp, jp = tr.kf_poses.numpy()[:n], np.asarray(jr.kf_poses)[:n]
    np.testing.assert_allclose(tp[:, :3, :3], jp[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(tp[:, :3, 3], jp[:, :3, 3], atol=1e-3)
    ok = tprob.point_valid.numpy()
    np.testing.assert_allclose(tr.points.numpy()[ok], np.asarray(jr.points)[ok], atol=2e-3)
    assert np.abs(tp - tprob.kf_poses.numpy()[:n]).max() > 1e-6       # the LM moved
    differ = (tr.obs_valid.numpy() != np.asarray(jr.obs_valid)).sum()
    assert differ <= 0.001 * tprob.obs_valid.numpy().sum(), differ


def test_gba_worker_sharded_against_jax(lateral_map, monkeypatch):
    """The live GBA's sharded branch: the port's ``_gba_worker`` over 4 CPU
    shards and the JAX package's over its 8 devices, each run inline by
    ``_launch_gba`` and merged into the same map."""
    rec = lateral_map
    shards = []
    shard = TD.shard_ba_problem

    def watched(prob, mesh):
        shards.append(len(mesh.devices))
        return shard(prob, mesh)

    monkeypatch.setattr(TD, "visible_devices", lambda device: [CPU] * 4)
    monkeypatch.setattr(TD, "shard_ba_problem", watched)
    t = _port_system(rec)
    t._launch_gba(rec["n_kf"] - 1)
    assert shards == [4]
    assert t.stats["gba_runs"] == 1 and t.stats["gba_aborted"] == 0

    j = JSlam(CFG)
    j.map = _jax_map(rec["map"])
    j.n_kf, j.n_pt, j.ref_kf = rec["n_kf"], rec["n_pt"], rec["ref_kf"]
    j._launch_gba(rec["n_kf"] - 1)
    assert j.stats["gba_runs"] == 1 and j.stats["gba_aborted"] == 0

    n = rec["n_kf"]
    tp, jp = t.map.kf_pose.numpy()[:n], np.asarray(j.map.kf_pose)[:n]
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    # points within 5e-5 m (some 50 float32 ulps at the map's 8 m): after 10
    # LM iterations of 80 CG steps the unsharded port is already 3.3e-5 m
    # from the JAX package on 3 of these 978 points, on one thread
    ok = rec["map"].pt_valid.numpy()
    np.testing.assert_allclose(t.map.pt_pos.numpy()[ok], np.asarray(j.map.pt_pos)[ok],
                               atol=5e-5)
    assert np.abs(tp - rec["map"].kf_pose.numpy()[:n]).max() > 1e-6    # the GBA moved
