"""Batched EPnP RANSAC, the port against the JAX package.

The JAX package draws its minimal sets with ``jax.random`` from the key it
is given; PyTorch cannot reproduce those draws.  With the JAX sets handed
to the port (``sets=``, computed by ``jax_pnp_sets`` with the JAX
package's own calls) the inlier mask and ``n_inliers`` must be equal and
``Tcw`` within 1e-4.  The cases of ``tests/test_solvers.py:83-190`` (exact,
outliers, near-planar, planar, deep perspective) are mirrored with the
port's own sampler, at the JAX test's bars: rotation and translation
error (se3 log) under 1e-2 for a single exact solve and 2e-2 near-planar,
under 0.05 after RANSAC.  ``eigh`` and ``svd`` give vectors up to sign, so
poses, masks and errors are compared, not raw vectors.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.geometry import se3 as jse3
from refactored_orb_slam2_tpu.solvers import epnp as jepnp
from refactored_orb_slam2_tpu_torch.geometry import se3 as tse3
from refactored_orb_slam2_tpu_torch.io.convert import pnp_result_from_numpy
from refactored_orb_slam2_tpu_torch.solvers import epnp as tepnp

torch.set_num_threads(1)

POSE_TOL = 1e-4


def jax_pnp_sets(valid: np.ndarray, seed: int, n_hyps: int = 256,
                 sample_size: int = 6) -> np.ndarray:
    """The JAX package's minimal sets for ``PRNGKey(seed)``: the calls of
    ``epnp_ransac`` (epnp.py:243-251)."""
    n = valid.shape[0]
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_hyps)
    draw = lambda k: jax.random.choice(k, jnp.arange(n), shape=(sample_size,),
                                       replace=False, p=jax.nn.softmax(logits))
    return np.asarray(jax.vmap(draw)(keys)).astype(np.int64)


@contextlib.contextmanager
def jax_sets_injected():
    """Hand the JAX package's EPnP sets to every ``epnp_ransac`` call of the
    port that draws its own (``draw_pnp_sets`` replaced; the generator's
    seed is the JAX key's)."""
    draw = tepnp.draw_pnp_sets

    def sets_of_jax(valid, generator, n_hyps=256, sample_size=6):
        return torch.from_numpy(jax_pnp_sets(valid.cpu().numpy(), generator.initial_seed(),
                                             n_hyps, sample_size)).to(valid.device)

    tepnp.draw_pnp_sets = sets_of_jax
    try:
        yield
    finally:
        tepnp.draw_pnp_sets = draw


def _exp(xi):
    return tse3.exp(torch.tensor(xi, dtype=torch.float32)).numpy()


def _err(T, T_est):
    """Largest component of log(T^-1 T_est), as the JAX tests measure it."""
    d = np.linalg.inv(T) @ np.asarray(T_est)
    return float(np.abs(np.asarray(jse3.log(jnp.asarray(d, dtype=jnp.float32)))).max())


def make_outliers(seed=0, n=150, noise_px=0.5, outlier_frac=0.3):
    """tests/test_solvers.py TestEPnP._make."""
    rng = np.random.default_rng(seed)
    pw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)],
                  axis=1).astype(np.float32)
    T = _exp([0.3, -0.1, 0.5, 0.1, -0.2, 0.05])
    pc = pw @ T[:3, :3].T + T[:3, 3]
    xn = pc[:, :2] / pc[:, 2:3] + rng.normal(0, noise_px / 500.0, (n, 2))
    n_out = int(n * outlier_frac)
    out = rng.choice(n, n_out, replace=False)
    xn[out] += rng.uniform(0.03, 0.2, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return pw, xn.astype(np.float32), T, out


def make_planar(seed=11, n=120):
    rng = np.random.default_rng(seed)
    pw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                   6.0 + 0.02 * rng.normal(0, 1, n)], axis=1).astype(np.float32)
    T = _exp([0.2, -0.3, 0.4, 0.15, -0.1, 0.08])
    pc = pw @ T[:3, :3].T + T[:3, 3]
    xn = (pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.5 / 500.0, (n, 2))).astype(np.float32)
    return pw, xn, T


def make_deep(seed=13, n=150):
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 60.0, n)
    pw = np.stack([rng.uniform(-0.5, 0.5, n) * z, rng.uniform(-0.4, 0.4, n) * z, z],
                  axis=1).astype(np.float32)
    T = _exp([0.4, 0.1, -0.3, -0.12, 0.2, 0.05])
    pc = pw @ T[:3, :3].T + T[:3, 3]
    keep = pc[:, 2] > 0.5
    pw, pc = pw[keep], pc[keep]
    xn = (pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.5 / 500.0, (len(pw), 2))).astype(np.float32)
    return pw, xn, T


CASES = {   # name -> (pw, xn, T, valid, key seed, sigma2)
    "outliers": lambda: (*make_outliers(1)[:3], None, 3, (0.5 / 500.0) ** 2),
    "planar": lambda: (*make_planar(), None, 5, (0.5 / 500.0) ** 2),
    "deep": lambda: (*make_deep(), None, 9, (0.5 / 500.0) ** 2),
    # a third of the correspondences invalid, as SearchByBoW leaves them
    "masked": lambda: (*make_outliers(4)[:3], np.random.default_rng(4).random(150) > 0.33,
                       17, (0.5 / 500.0) ** 2),
}


def _case(name):
    pw, xn, T, valid, seed, sigma2 = CASES[name]()
    valid = np.ones(len(pw), bool) if valid is None else valid
    return pw, xn, T, valid, seed, sigma2


@pytest.mark.parametrize("name", sorted(CASES))
def test_with_the_jax_sets_equal_to_jax(name):
    pw, xn, T, valid, seed, sigma2 = _case(name)
    j = jepnp.epnp_ransac(jnp.asarray(pw), jnp.asarray(xn), jnp.asarray(valid),
                          jax.random.PRNGKey(seed), sigma2=sigma2, chi2_th=5.991)
    t = tepnp.epnp_ransac(torch.from_numpy(pw), torch.from_numpy(xn), torch.from_numpy(valid),
                          sets=torch.from_numpy(jax_pnp_sets(valid, seed)),
                          sigma2=sigma2, chi2_th=5.991)
    j = pnp_result_from_numpy(jax.tree.map(np.asarray, j))
    assert bool(t.success) and bool(j.success)
    assert int(t.n_inliers) == int(j.n_inliers)
    np.testing.assert_array_equal(t.inliers.numpy(), j.inliers.numpy())
    np.testing.assert_allclose(t.Tcw.numpy(), j.Tcw.numpy(), atol=POSE_TOL)
    assert _err(T, t.Tcw.numpy()) < 0.05


def test_single_solve_equal_to_jax_and_batched():
    """One set through ``_epnp`` against ``_epnp_single``; a batch of sets
    against the same sets one by one."""
    pw, xn, T, _ = make_outliers(0, noise_px=0.5, outlier_frac=0.0)
    j = np.asarray(jepnp._epnp_single(jnp.asarray(pw[:32]), jnp.asarray(xn[:32])))
    t = tepnp._epnp(torch.from_numpy(pw[:32]), torch.from_numpy(xn[:32])).numpy()
    np.testing.assert_allclose(t, j, atol=POSE_TOL)
    sets = jax_pnp_sets(np.ones(len(pw), bool), 2, n_hyps=4)
    batch = tepnp._epnp(torch.from_numpy(pw[sets]), torch.from_numpy(xn[sets]))
    for s, Tb in zip(sets, batch):
        np.testing.assert_allclose(
            Tb.numpy(), tepnp._epnp(torch.from_numpy(pw[s]), torch.from_numpy(xn[s])).numpy(),
            atol=POSE_TOL)
        js = np.asarray(jepnp._gn_polish(jepnp._epnp_single(jnp.asarray(pw[s]), jnp.asarray(xn[s])),
                                         jnp.asarray(pw[s]), jnp.asarray(xn[s])))
        ts = tepnp._gn_polish(tepnp._epnp(torch.from_numpy(pw[s]), torch.from_numpy(xn[s])),
                              torch.from_numpy(pw[s]), torch.from_numpy(xn[s])).numpy()
        np.testing.assert_allclose(ts, js, atol=POSE_TOL)


def test_sampler_draws_distinct_valid_sets():
    valid = np.random.default_rng(3).random(200) < 0.4
    gen = torch.Generator().manual_seed(7)
    sets = tepnp.draw_pnp_sets(torch.from_numpy(valid), gen).numpy()
    assert sets.shape == (256, 6)
    assert valid[sets].all()
    assert all(len(set(s)) == 6 for s in sets)
    again = tepnp.draw_pnp_sets(torch.from_numpy(valid), torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(again.numpy(), sets)


def test_degenerate_sets_score_nothing():
    """Every point the same: a non-finite pose, no inlier, no raise."""
    pw = np.tile(np.asarray([[0.5, -0.2, 5.0]], np.float32), (20, 1))
    xn = np.tile(np.asarray([[0.1, -0.04]], np.float32), (20, 1))
    r = tepnp.epnp_ransac(torch.from_numpy(pw), torch.from_numpy(xn), torch.ones(20, dtype=torch.bool),
                          torch.Generator().manual_seed(0), sigma2=1e-6)
    assert not bool(r.success) and int(r.n_inliers) == 0


# ----------------------------- tests/test_solvers.py:83-190, mirrored
def test_single_exact():
    pw, xn, T, _ = make_outliers(0, noise_px=0.0, outlier_frac=0.0)
    T_est = tepnp._epnp(torch.from_numpy(pw[:32]), torch.from_numpy(xn[:32])).numpy()
    assert _err(T, T_est) < 1e-2


def test_ransac_with_outliers():
    pw, xn, T, out = make_outliers(1)
    res = tepnp.epnp_ransac(torch.from_numpy(pw), torch.from_numpy(xn),
                            torch.ones(len(pw), dtype=torch.bool),
                            torch.Generator().manual_seed(3),
                            sigma2=(0.5 / 500.0) ** 2, chi2_th=5.991)
    assert bool(res.success)
    assert _err(T, res.Tcw.numpy()) < 0.05
    assert res.inliers.numpy()[out].mean() < 0.2


def test_single_near_planar():
    """Near-planar sets: the beta-2/3 approximations recover the pose."""
    rng = np.random.default_rng(7)
    for trial in range(6):
        n = 32
        pw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                       8.0 + rng.normal(0, 0.01, n)], axis=1).astype(np.float32)
        T = _exp(rng.normal(0, 0.3, 6).astype(np.float32))
        pc = pw @ T[:3, :3].T + T[:3, 3]
        assert (pc[:, 2] > 0.5).all()
        xn = (pc[:, :2] / pc[:, 2:3]).astype(np.float32)
        T_est = tepnp._epnp(torch.from_numpy(pw), torch.from_numpy(xn)).numpy()
        assert _err(T, T_est) < 2e-2, trial


@pytest.mark.parametrize("name", ["planar", "deep"])
def test_ransac_own_sampler(name):
    pw, xn, T, valid, seed, sigma2 = _case(name)
    res = tepnp.epnp_ransac(torch.from_numpy(pw), torch.from_numpy(xn), torch.from_numpy(valid),
                            torch.Generator().manual_seed(seed), sigma2=sigma2, chi2_th=5.991)
    assert bool(res.success)
    assert _err(T, res.Tcw.numpy()) < 0.05
