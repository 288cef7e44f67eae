"""The two-view initializer and the triangulation gates against the JAX
package, on seeded synthetic two-view matches: a general scene (depths 3-8
m) and a planar one, 300 correspondences of which 260 are valid and 30 of
those are outliers, 0.5 px of noise at a focal length of 500.

The JAX package draws its minimal sets with ``jax.random``; PyTorch cannot
reproduce those draws, so ``initialize_two_view`` is compared with the JAX
package's own sets handed to the port (``sets=``).  Singular vectors come
with a sign the SVD routine chooses, so H and F are compared up to sign and
scale, and otherwise only what does not depend on it: scores, inlier masks,
the candidate (R, t) as a set, and the chosen reconstruction.

Tolerances: float32 throughout.  Normalization and scores on the same
matrices: 1e-5 relative.  Matrices from an SVD null vector: 2e-3 of unit
norm (the smallest singular value of a noisy 8-point system is poorly
separated).  The chosen rotation: 0.2 degree, because the Faugeras
decomposition takes square roots of differences of nearby singular values
(measured: 0.12 degree on the planar scene).
A chi2 gate can flip for a correspondence that sits on it, so
masks computed from separately solved matrices may differ in at most 1% of
the correspondences, and on the same matrices in at most 0.1%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.geometry import triangulation as jtri
from refactored_orb_slam2_tpu.solvers import initializer as jinit
from refactored_orb_slam2_tpu_torch.geometry import triangulation as ttri
from refactored_orb_slam2_tpu_torch.io.convert import init_result_from_numpy
from refactored_orb_slam2_tpu_torch.solvers import initializer as tinit

FOCAL = 500.0
SIGMA2 = (1.0 / FOCAL) ** 2
MASK_SHARE = 0.01


def _rot(rx, ry, rz):
    cx, sx, cy, sy, cz, sz = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def two_view(planar: bool, seed: int):
    """(xn1, xn2, valid, R21, t21, inlier): normalized coordinates in both
    views; ``inlier`` = valid and not one of the 30 outliers."""
    rng = np.random.default_rng(seed)
    n = 300
    xy = rng.uniform(-2.0, 2.0, (n, 2))
    z = 5.0 + 0.15 * xy[:, 0] - 0.1 * xy[:, 1] if planar else rng.uniform(3.0, 8.0, n)
    p = np.column_stack([xy, z])
    R = _rot(0.02, -0.04, 0.03)
    t = np.array([0.35, 0.03, 0.05])
    q = p @ R.T + t
    xn1 = p[:, :2] / p[:, 2:] + rng.normal(0, 0.5 / FOCAL, (n, 2))
    xn2 = q[:, :2] / q[:, 2:] + rng.normal(0, 0.5 / FOCAL, (n, 2))
    valid = np.ones(n, bool)
    valid[rng.choice(n, 40, replace=False)] = False
    outliers = rng.choice(np.nonzero(valid)[0], 30, replace=False)
    xn2[outliers] = rng.uniform(-0.4, 0.4, (30, 2))
    inlier = valid.copy()
    inlier[outliers] = False
    return (xn1.astype(np.float32), xn2.astype(np.float32), valid,
            R.astype(np.float32), (t / np.linalg.norm(t)).astype(np.float32), inlier)


SCENES = {"general": two_view(False, 11), "planar": two_view(True, 12)}


def jax_sets(valid: np.ndarray, seed: int) -> np.ndarray:
    """The JAX package's minimal sets for a seed: the two calls of
    ``initialize_two_view`` (initializer.py:207-214)."""
    n = valid.shape[0]
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    keys = jax.random.split(jax.random.PRNGKey(seed), jinit.N_HYPS)
    draw = lambda k: jax.random.choice(k, jnp.arange(n), shape=(8,), replace=False,
                                       p=jax.nn.softmax(logits))
    return np.asarray(jax.vmap(draw)(keys)).astype(np.int64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit_up_to_sign(a, b):
    """a and b scaled to unit norm, b flipped to a's sign."""
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    return a, b * np.sign(np.sum(a * b))


def _rot_angle_deg(Ra, Rb):
    return np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))


# ------------------------------------------------------------- the sampler
def test_draw_minimal_sets_is_seeded_distinct_and_valid_only():
    valid = _t(SCENES["general"][2])
    gen = lambda: torch.Generator(device="cpu").manual_seed(7)
    a = tinit.draw_minimal_sets(valid, 200, gen())
    b = tinit.draw_minimal_sets(valid, 200, gen())
    assert a.shape == (200, 8) and a.dtype == torch.int64
    assert torch.equal(a, b)
    assert not torch.equal(a, tinit.draw_minimal_sets(
        valid, 200, torch.Generator(device="cpu").manual_seed(8)))
    assert valid[a].all()
    assert all(len(set(row.tolist())) == 8 for row in a)
    # every valid correspondence is drawn about equally often
    counts = torch.bincount(tinit.draw_minimal_sets(valid, 20000, gen()).reshape(-1),
                            minlength=valid.shape[0])[valid].double()
    assert counts.min() > 0.8 * counts.mean() and counts.max() < 1.2 * counts.mean()


def test_initialize_two_view_needs_a_generator_or_sets():
    xn1, xn2, valid, _, _, _ = SCENES["general"]
    with pytest.raises(ValueError):
        tinit.initialize_two_view(_t(xn1), _t(xn2), _t(valid))


# ------------------------------------------------------- solvers and scores
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_normalize_matches_jax(scene):
    xn1, _, valid, _, _, _ = SCENES[scene]
    pn_j, T_j = jinit._normalize(jnp.asarray(xn1), jnp.asarray(valid))
    pn_t, T_t = tinit._normalize(_t(xn1), _t(valid))
    np.testing.assert_allclose(pn_t.numpy(), np.asarray(pn_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("model", ["h", "f"])
def test_minimal_solvers_match_jax_up_to_sign(scene, model):
    """20 inlier-only minimal sets, solved one by one in JAX and as one
    batch in the port."""
    xn1, xn2, valid, R, t, _ = SCENES[scene]
    rng = np.random.default_rng(3)
    p1n = np.asarray(jinit._normalize(jnp.asarray(xn1), jnp.asarray(valid))[0])
    p2n = np.asarray(jinit._normalize(jnp.asarray(xn2), jnp.asarray(valid))[0])
    sets = np.stack([rng.choice(np.nonzero(valid)[0], 8, replace=False) for _ in range(20)])
    jsolve = jinit._solve_h if model == "h" else jinit._solve_f
    tsolve = tinit._solve_h if model == "h" else tinit._solve_f
    ref = np.asarray(jax.vmap(jsolve)(jnp.asarray(p1n[sets]), jnp.asarray(p2n[sets])))
    got = tsolve(_t(p1n[sets]), _t(p2n[sets])).numpy()
    assert got.shape == (20, 3, 3)
    for a, b in zip(ref, got):
        a, b = _unit_up_to_sign(a, b)
        np.testing.assert_allclose(b, a, atol=2e-3)
    if model == "f":
        assert np.abs(np.linalg.det(got.astype(np.float64))).max() < 1e-6   # rank 2
    # one set alone gives the batch's entry
    np.testing.assert_allclose(tsolve(_t(p1n[sets[0]]), _t(p2n[sets[0]])).numpy(),
                               got[0], atol=1e-5)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("model", ["h", "f"])
def test_masked_refit_matches_jax_up_to_sign(scene, model):
    xn1, xn2, valid, _, _, _ = SCENES[scene]
    jsolve = jinit._solve_h_masked if model == "h" else jinit._solve_f_masked
    tsolve = tinit._solve_h_masked if model == "h" else tinit._solve_f_masked
    ref = np.asarray(jsolve(jnp.asarray(xn1), jnp.asarray(xn2), jnp.asarray(valid)))
    got = tsolve(_t(xn1), _t(xn2), _t(valid)).numpy()
    a, b = _unit_up_to_sign(ref, got)
    np.testing.assert_allclose(b, a, atol=2e-3)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_scores_equal_on_the_same_matrices(scene):
    """Scores and inlier masks of the JAX package's own H and F (every
    hypothesis of its sets), recomputed by the port in one batch."""
    xn1, xn2, valid, _, _, _ = SCENES[scene]
    sets = jax_sets(valid, 5)[:50]
    j1, j2, jv = jnp.asarray(xn1), jnp.asarray(xn2), jnp.asarray(valid)
    H = jax.vmap(jinit._solve_h)(j1[sets], j2[sets])
    F = jax.vmap(jinit._solve_f)(j1[sets], j2[sets])
    sH, okH = jax.vmap(lambda h: jinit._score_h(h, jnp.linalg.inv(h), j1, j2, jv, SIGMA2))(H)
    sF, okF = jax.vmap(lambda f: jinit._score_f(f, j1, j2, jv, SIGMA2))(F)
    tH, tF = _t(np.asarray(H)), _t(np.asarray(F))
    gH, gokH = tinit._score_h(tH, _t(np.asarray(jnp.linalg.inv(H))), _t(xn1), _t(xn2),
                              _t(valid), SIGMA2)
    gF, gokF = tinit._score_f(tF, _t(xn1), _t(xn2), _t(valid), SIGMA2)
    # a chi2 within float32 rounding of its gate may land on either side
    assert (gokH.numpy() != np.asarray(okH)).mean() <= 1e-3
    assert (gokF.numpy() != np.asarray(okF)).mean() <= 1e-3
    np.testing.assert_allclose(gH.numpy(), np.asarray(sH), rtol=1e-3, atol=0.05)
    np.testing.assert_allclose(gF.numpy(), np.asarray(sF), rtol=1e-3, atol=0.05)
    assert int(np.argmax(gF.numpy())) == int(np.argmax(np.asarray(sF)))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_check_rt_matches_jax(scene):
    xn1, xn2, valid, R, t, _ = SCENES[scene]
    ref = jinit._check_rt(jnp.asarray(R), jnp.asarray(t), jnp.asarray(xn1), jnp.asarray(xn2),
                          jnp.asarray(valid), SIGMA2)
    # the true motion and its mirror, as a batch of two candidates
    got = tinit._check_rt(_t(np.stack([R, R])), _t(np.stack([t, -t])), _t(xn1), _t(xn2),
                          _t(valid), SIGMA2)
    n_good, par_cos, p3d, good = (np.asarray(x) for x in ref)
    assert n_good >= 200
    assert int(got[0][0]) == n_good and int(got[0][1]) == 0
    np.testing.assert_array_equal(got[3][0].numpy(), good)
    np.testing.assert_allclose(got[1][0].numpy(), par_cos, atol=1e-6)
    np.testing.assert_allclose(got[2][0].numpy()[good], p3d[good], rtol=2e-3, atol=2e-3)


def _same_candidates(ref_R, ref_t, got_R, got_t):
    """Every reference (R, t) has a counterpart within 0.1 degree and 2e-3."""
    for R, t in zip(ref_R, ref_t):
        err = [max(_rot_angle_deg(R, R2) / 50.0, np.abs(t - t2).max())
               for R2, t2 in zip(got_R, got_t)]
        assert min(err) < 2e-3, min(err)


def test_homography_decomposition_gives_the_same_candidates():
    xn1, xn2, valid, R, t, _ = SCENES["planar"]
    H = jinit._solve_h_masked(jnp.asarray(xn1), jnp.asarray(xn2), jnp.asarray(valid))
    ref_R, ref_t = (np.asarray(x) for x in jinit._decompose_homography(H))
    got_R, got_t = (x.numpy() for x in tinit._decompose_homography(_t(np.asarray(H))))
    assert got_R.shape == (8, 3, 3) and got_t.shape == (8, 3)
    _same_candidates(ref_R, ref_t, got_R, got_t)
    _same_candidates(got_R, got_t, ref_R, ref_t)
    # the negated matrix (the other sign an SVD may return) lists them too
    neg_R, neg_t = (x.numpy() for x in tinit._decompose_homography(-_t(np.asarray(H))))
    best = min(range(8), key=lambda i: _rot_angle_deg(R, ref_R[i]) + np.abs(t - ref_t[i]).sum())
    _same_candidates(ref_R[best:best + 1], ref_t[best:best + 1], neg_R, neg_t)


def test_essential_decomposition_lists_the_true_motion_under_either_sign():
    xn1, xn2, _, R, t, inlier = SCENES["general"]
    F = np.asarray(jinit._solve_f_masked(jnp.asarray(xn1), jnp.asarray(xn2),
                                         jnp.asarray(inlier)))
    for E in (F, -F):
        cand_R, cand_t = (x.numpy() for x in tinit._decompose_essential(_t(E)))
        assert cand_R.shape == (4, 3, 3)
        np.testing.assert_allclose(np.linalg.det(cand_R.astype(np.float64)), 1.0, atol=1e-4)
        err = [_rot_angle_deg(R, R2) + np.degrees(np.arccos(np.clip(t @ t2, -1, 1)))
               for R2, t2 in zip(cand_R, cand_t)]
        assert min(err) < 3.0


# ------------------------------------------------------------ the whole thing
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_initialize_two_view_with_the_jax_sets(scene):
    """is_h, success and n_good-level agreement with the JAX package's sets
    injected; then the port's own sampler reaches the same reconstruction."""
    xn1, xn2, valid, R, t, _ = SCENES[scene]
    seed = 3
    ref = jinit.initialize_two_view(jnp.asarray(xn1), jnp.asarray(xn2), jnp.asarray(valid),
                                    jax.random.PRNGKey(seed), sigma_px=1.0, focal=FOCAL)
    ref = init_result_from_numpy(jax.tree.map(np.asarray, ref)._asdict())
    got = tinit.initialize_two_view(_t(xn1), _t(xn2), _t(valid), sigma_px=1.0, focal=FOCAL,
                                    sets=_t(jax_sets(valid, seed)))
    assert bool(ref.success) and bool(got.success)
    assert bool(got.is_h) == bool(ref.is_h) == (scene == "planar")
    mismatch = int((got.inliers != ref.inliers).sum())
    assert mismatch <= MASK_SHARE * len(valid), mismatch
    assert abs(int(got.n_good) - int(ref.n_good)) <= mismatch
    assert int(got.n_good) == int(got.inliers.sum()) >= 200
    assert _rot_angle_deg(got.R21.numpy(), ref.R21.numpy()) < 0.2
    np.testing.assert_allclose(got.t21.numpy(), ref.t21.numpy(), atol=2e-3)
    both = (got.inliers & ref.inliers).numpy()
    np.testing.assert_allclose(got.points3d.numpy()[both], ref.points3d.numpy()[both],
                               rtol=5e-3, atol=5e-3)
    # against the truth: rotation within 0.5 degree, translation within 3 degrees
    assert _rot_angle_deg(got.R21.numpy(), R) < 0.5
    assert np.degrees(np.arccos(np.clip(got.t21.numpy() @ t, -1, 1))) < 3.0

    own = tinit.initialize_two_view(_t(xn1), _t(xn2), _t(valid),
                                    torch.Generator(device="cpu").manual_seed(seed),
                                    sigma_px=1.0, focal=FOCAL)
    assert bool(own.success) and bool(own.is_h) == bool(ref.is_h)
    assert _rot_angle_deg(own.R21.numpy(), R) < 0.5
    assert int((own.inliers != ref.inliers).sum()) <= 0.05 * len(valid)


def test_initialize_two_view_refuses_a_pure_rotation():
    """No translation, no parallax: neither package accepts."""
    xn1, _, valid, R, _, _ = SCENES["general"]
    p = np.column_stack([xn1, np.ones(len(xn1))]) @ R.T
    xn2 = (p[:, :2] / p[:, 2:]).astype(np.float32)
    ref = jinit.initialize_two_view(jnp.asarray(xn1), jnp.asarray(xn2), jnp.asarray(valid),
                                    jax.random.PRNGKey(1), sigma_px=1.0, focal=FOCAL)
    got = tinit.initialize_two_view(_t(xn1), _t(xn2), _t(valid), sigma_px=1.0, focal=FOCAL,
                                    sets=_t(jax_sets(valid, 1)))
    assert not bool(ref.success) and not bool(got.success)


# -------------------------------------------------------- triangulation gates
def test_triangulation_checks_match_jax():
    xn1, xn2, valid, R, t, _ = SCENES["general"]
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, :3], T2[:3, 3] = R, t * 0.35
    p3d_j = jtri.triangulate_dlt(jnp.asarray(T1[:3]), jnp.asarray(T2[:3]),
                                 jnp.asarray(xn1), jnp.asarray(xn2))
    p3d = np.asarray(p3d_j).copy()
    p3d[0] = np.nan                       # not finite
    p3d[1, 2] = -1.0                      # behind the first camera
    p3d[2] *= 400.0                       # far away: no parallax
    rng = np.random.default_rng(0)
    s1 = (1.2 ** rng.integers(0, 4, len(xn1))).astype(np.float32) ** 2
    s2 = (1.2 ** rng.integers(0, 4, len(xn1))).astype(np.float32) ** 2
    args = (T1, T2, xn1, xn2, s1, s2)
    ref = np.asarray(jtri.triangulation_checks(
        jnp.asarray(p3d), *(jnp.asarray(a) for a in args), FOCAL, FOCAL, FOCAL, FOCAL))
    got = ttri.triangulation_checks(
        _t(p3d), *(_t(a) for a in args), FOCAL, FOCAL, FOCAL, FOCAL).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[:3].any() and 150 < got.sum() < len(xn1)
    # the port's DLT on batched projections equals the single pair's
    both = ttri.triangulate_dlt(_t(np.stack([T1[:3], T1[:3]])), _t(np.stack([T2[:3], T2[:3]])),
                                _t(xn1), _t(xn2)).numpy()
    one = ttri.triangulate_dlt(_t(T1[:3]), _t(T2[:3]), _t(xn1), _t(xn2)).numpy()
    np.testing.assert_allclose(both[0], one, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(one[valid], np.asarray(p3d_j)[valid], rtol=2e-3, atol=2e-3)
