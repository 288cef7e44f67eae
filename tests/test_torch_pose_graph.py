"""The port's Sim3 group, Horn solver and essential-graph optimizer against
the JAX package's on the same numpy inputs (CPU).

Tolerances: the Sim3 maps agree within 1e-5 (float32 arithmetic in
another order).  Every case of ``tests/test_pose_graph.py`` runs on both
packages: after 20 LM iterations (one for the single-step cases) the
rotations agree within 1e-4, translations within 1e-3 m and scales within
1e-4, and the port's result passes the JAX test's own checks.  Horn's
alignment agrees within 1e-5; ``sim3_ransac`` given the JAX package's
minimal sets has the same inlier mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.geometry import sim3 as JS
from refactored_orb_slam2_tpu.optim import pose_graph as JP
from refactored_orb_slam2_tpu.solvers import horn_sim3 as JH
from refactored_orb_slam2_tpu_torch.geometry import sim3 as TS
from refactored_orb_slam2_tpu_torch.optim import pose_graph as TP
from refactored_orb_slam2_tpu_torch.solvers import horn_sim3 as TH
from tests.test_pose_graph import build_edges, circle_graph

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.3, 1.0])
def test_exp_log_compose_inverse(seed, scale):
    rng = np.random.default_rng(seed)
    za = (rng.normal(0, 1, (8, 7)) * scale).astype(np.float32)
    zb = (rng.normal(0, 1, (8, 7)) * scale).astype(np.float32)
    ja, jb = JS.exp(jnp.asarray(za)), JS.exp(jnp.asarray(zb))
    ta, tb = TS.exp(_t(za)), TS.exp(_t(zb))
    _close(ta, ja, 1e-5)
    np.testing.assert_allclose(TS.log(*ta).numpy(), np.asarray(JS.log(*ja)), atol=1e-5)
    # exp and log are inverse inside the injectivity radius
    inside = np.linalg.norm(za[:, 3:6], axis=1) < 3.0
    np.testing.assert_allclose(TS.log(*ta).numpy()[inside], za[inside], atol=2e-5)
    _close(TS.compose(*ta, *tb), JS.compose(*ja, *jb), 1e-5)
    _close(TS.inverse(*ta), JS.inverse(*ja), 1e-5)
    p = rng.normal(0, 2, (8, 3)).astype(np.float32)
    np.testing.assert_allclose(TS.apply(*ta, _t(p)).numpy(), np.asarray(JS.apply(*ja, jnp.asarray(p))),
                               atol=1e-5)
    M = TS.to_matrix(*ta)
    np.testing.assert_allclose(M.numpy(), np.asarray(JS.to_matrix(*ja)), atol=1e-5)
    _close(TS.from_matrix(M), JS.from_matrix(JS.to_matrix(*ja)), 1e-5)


def _both(n, drift, scale_drift, seed, fix_scale, use_est_scale, extra=None, **kw):
    """One optimize_pose_graph call on both packages; returns (JAX, port,
    the circle graph)."""
    (R_gt, t_gt, s_gt), (R_est, t_est, s_est) = circle_graph(
        n, drift=drift, scale_drift=scale_drift, seed=seed)
    ii = [k - 1 for k in range(1, n)] + [n - 1]
    jj = list(range(1, n)) + [0]
    if extra:
        ii, jj = ii + extra[0], jj + extra[1]
    s0 = s_est if use_est_scale else np.ones(n, np.float32)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    jedges = JP.make_edges_from_poses(
        jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32), jnp.asarray(R_gt),
        jnp.asarray(t_gt), jnp.asarray(s_gt), jnp.ones(len(ii), bool))
    tedges = TP.make_edges_from_poses(
        _t(np.asarray(ii, np.int32)), _t(np.asarray(jj, np.int32)), _t(R_gt), _t(t_gt),
        _t(s_gt), torch.ones(len(ii), dtype=torch.bool))
    j = JP.optimize_pose_graph(jnp.asarray(R_est), jnp.asarray(t_est), jnp.asarray(s0),
                               jnp.ones(n, bool), jnp.asarray(fixed), jedges,
                               fix_scale=fix_scale, **kw)
    t = TP.optimize_pose_graph(_t(R_est), _t(t_est), _t(s0), torch.ones(n, dtype=torch.bool),
                               _t(fixed), tedges, fix_scale=fix_scale, **kw)
    return j, t, ((R_gt, t_gt, s_gt), (R_est, t_est, s_est))


def _centers(R, t, s):
    R, t, s = _np(R), _np(t), _np(s)
    return -np.einsum("kji,kj->ki", R, t) / s[:, None]


def _agree(j, t):
    np.testing.assert_allclose(_np(t[0]), _np(j[0]), atol=1e-4)
    np.testing.assert_allclose(_np(t[1]), _np(j[1]), atol=1e-3)
    np.testing.assert_allclose(_np(t[2]), _np(j[2]), atol=1e-4)


def test_edges_from_poses_equal():
    (R_gt, t_gt, s_gt), _ = circle_graph(12, scale_drift=0.02, seed=1)
    j = build_edges(R_gt, t_gt, s_gt, 12)
    ii = np.asarray(j.i)
    t = TP.make_edges_from_poses(_t(ii), _t(np.asarray(j.j)), _t(R_gt), _t(t_gt), _t(s_gt),
                                 torch.ones(len(ii), dtype=torch.bool))
    _close((t.R, t.t, t.s, t.weight), (j.R, j.t, j.s, j.weight), 1e-6)


def test_loop_closure_se3():
    j, t, ((R_gt, t_gt, s_gt), (R_est, t_est, s_est)) = _both(24, 0.03, 0.0, 0, True, False)
    _agree(j, t)
    err_before = np.linalg.norm(_centers(R_est, t_est, s_est) - _centers(R_gt, t_gt, s_gt), axis=1).max()
    err_after = np.linalg.norm(_centers(*t) - _centers(R_gt, t_gt, s_gt), axis=1).max()
    assert err_after < 0.1 * err_before, (err_before, err_after)
    np.testing.assert_allclose(t[2].numpy(), 1.0, atol=1e-5)


def test_loop_closure_sim3_scale_drift():
    j, t, _ = _both(24, 0.02, 0.02, 1, False, True)
    _agree(j, t)
    assert np.abs(t[2].numpy() - 1.0).max() < 0.02


def test_point_correction():
    j, t, (_, (R_est, t_est, s_est)) = _both(8, 0.05, 0.0, 0, True, False)
    _agree(j, t)
    n = 8
    rng = np.random.default_rng(0)
    pts_cam = rng.uniform(-1, 1, (16, 3)).astype(np.float32) + [0, 0, 3]
    ref = rng.integers(0, n, 16).astype(np.int32)
    p_world = np.einsum("kij,kj->ki", R_est[ref].transpose(0, 2, 1),
                        pts_cam - t_est[ref]).astype(np.float32)
    pj = JP.correct_points_after_pose_graph(
        jnp.asarray(p_world), jnp.asarray(ref), jnp.asarray(R_est), jnp.asarray(t_est),
        jnp.asarray(s_est), *j)
    pt = TP.correct_points_after_pose_graph(_t(p_world), _t(ref), _t(R_est), _t(t_est),
                                            _t(s_est), *t)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)
    p_cam_new = np.einsum("kij,kj->ki", t[0].numpy()[ref], pt.numpy()) + t[1].numpy()[ref]
    np.testing.assert_allclose(p_cam_new, pts_cam, atol=1e-3)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_pcg_single_step_matches_dense(fix_scale):
    n = 24
    out = {}
    for solver, kw in (("dense", {}), ("pcg", {"n_cg": 7 * n})):
        j, t, _ = _both(n, 0.03, 0.0, 0, fix_scale, not fix_scale, solver=solver, n_iters=1, **kw)
        _agree(j, t)
        out[solver] = t
    np.testing.assert_allclose(out["pcg"][0].numpy(), out["dense"][0].numpy(), atol=2e-4)
    np.testing.assert_allclose(out["pcg"][1].numpy(), out["dense"][1].numpy(), atol=2e-3)
    np.testing.assert_allclose(out["pcg"][2].numpy(), out["dense"][2].numpy(), atol=2e-4)


def test_pcg_matches_dense_sim3():
    j, t, _ = _both(32, 0.02, 0.02, 3, False, True, solver="pcg", n_cg=32)
    _agree(j, t)
    assert np.abs(t[2].numpy() - 1.0).max() < 0.02


def test_pcg_large_graph_with_covis_edges():
    n = 160
    extra = ([k for k in range(0, n - 4, 2)], [k + 4 for k in range(0, n - 4, 2)])
    j, t, ((R_gt, t_gt, s_gt), (R_est, t_est, s_est)) = _both(
        n, 0.015, 0.0, 5, True, False, extra=extra, solver="pcg")
    _agree(j, t)
    c_gt = _centers(R_gt, t_gt, s_gt)
    err_before = np.linalg.norm(_centers(R_est, t_est, s_est) - c_gt, axis=1).max()
    err_after = np.linalg.norm(_centers(*t) - c_gt, axis=1).max()
    assert err_after < 0.15 * err_before, (err_before, err_after)


def _matched_sets(seed, n, fix_scale):
    rng = np.random.default_rng(seed)
    R = np.asarray(TS.exp(_t(rng.normal(0, 0.3, 7).astype(np.float32)))[0])
    s = 1.0 if fix_scale else 1.3
    tr = np.asarray([0.4, -0.2, 0.3], np.float32)
    p2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
                  1).astype(np.float32)
    p1 = (s * p2 @ R.T + tr).astype(np.float32)
    out = rng.random(n) < 0.2                           # outliers
    p1[out] += rng.normal(0, 0.5, (out.sum(), 3)).astype(np.float32)
    xn1 = (p1[:, :2] / p1[:, 2:3] + rng.normal(0, 1e-3, (n, 2))).astype(np.float32)
    xn2 = (p2[:, :2] / p2[:, 2:3] + rng.normal(0, 1e-3, (n, 2))).astype(np.float32)
    valid = rng.random(n) < 0.9
    return p1, p2, xn1, xn2, valid


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_equal(fix_scale):
    p1, p2, _, _, valid = _matched_sets(4, 60, fix_scale)
    _close(TH.horn_sim3(_t(p1[:5]), _t(p2[:5]), fix_scale),
           JH.horn_sim3(jnp.asarray(p1[:5]), jnp.asarray(p2[:5]), fix_scale), 1e-5)
    _close(TH.horn_sim3_masked(_t(p1), _t(p2), _t(valid), fix_scale),
           JH.horn_sim3_masked(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), fix_scale),
           1e-5)


def jax_sim3_sets(valid, key, n_hyps=128):
    """The minimal sets ``sim3_ransac`` of the JAX package draws from ``key``."""
    n = valid.shape[0]
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    keys = jax.random.split(key, n_hyps)
    draw = lambda k: jax.random.choice(k, jnp.arange(n), shape=(3,), replace=False,
                                       p=jax.nn.softmax(logits))
    return torch.from_numpy(np.asarray(jax.vmap(draw)(keys)).astype(np.int64))


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_ransac_with_jax_sets(fix_scale):
    p1, p2, xn1, xn2, valid = _matched_sets(5, 80, fix_scale)
    th = np.full(80, 9.21 * (1.2 / 500.0) ** 2, np.float32)
    key = jax.random.PRNGKey(7)
    j = JH.sim3_ransac(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(xn1), jnp.asarray(xn2),
                       jnp.asarray(valid), key, fix_scale=fix_scale, chi2_th1=jnp.asarray(th),
                       chi2_th2=jnp.asarray(th))
    t = TH.sim3_ransac(_t(p1), _t(p2), _t(xn1), _t(xn2), _t(valid),
                       sets=jax_sim3_sets(valid, key), fix_scale=fix_scale,
                       chi2_th1=_t(th), chi2_th2=_t(th))
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers) and bool(t.success) == bool(j.success)
    _close((t.R12, t.t12, t.s12), (j.R12, j.t12, j.s12), 1e-4)
    # a set drawn from a CPU generator finds the same model
    g = torch.Generator().manual_seed(3)
    t2 = TH.sim3_ransac(_t(p1), _t(p2), _t(xn1), _t(xn2), _t(valid), g, fix_scale=fix_scale,
                        chi2_th1=_t(th), chi2_th2=_t(th))
    assert bool(t2.success) and int(t2.n_inliers) >= int(j.n_inliers) - 3
