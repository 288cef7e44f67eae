"""The pose-only LM's wrapper on the CPU: ``optimize_pose`` on CPU tensors is
``optimize_pose_reference`` bit for bit, it refuses what the kernel would
not take, and a float64 model of the kernel's schedule
(``csrc/pose_lm.cu``: the reclassification fused with the next round's
first build, LU with partial pivoting, Exp's closed form) gives the plain
version's answer.  The kernel itself is held against the plain version on
the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from pose_cases import KINDS, camera, pose_case
from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
from refactored_orb_slam2_tpu_torch.optim import pose_opt

torch.set_num_threads(1)

ARGS = ("Tcw0", "points_w", "obs", "inv_sigma2", "valid", "is_stereo")


def _args(case):
    return {k: case[k] for k in ARGS}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_optimize_pose_on_cpu_is_the_reference(kind):
    args = _args(pose_case(kind, 300, seed=len(kind)))
    before = dict(cuda_hamming.launches)
    got = pose_opt.optimize_pose(camera(), **args)
    ref = pose_opt.optimize_pose_reference(camera(), **args)
    assert cuda_hamming.launches == before          # the CPU runs the plain version
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert got.inlier.dtype == torch.bool and got.n_inliers.dtype == torch.int32


def _wrong(args, name, value):
    return dict(args, **{name: value})


@pytest.mark.parametrize("change,error", [
    (lambda a: _wrong(a, "points_w", a["points_w"].double()), TypeError),
    (lambda a: _wrong(a, "Tcw0", a["Tcw0"].double()), TypeError),
    (lambda a: _wrong(a, "valid", a["valid"].to(torch.uint8)), TypeError),
    (lambda a: _wrong(a, "obs", a["obs"][:, :2]), ValueError),
    (lambda a: _wrong(a, "Tcw0", a["Tcw0"][:3]), ValueError),
    (lambda a: _wrong(a, "inv_sigma2", a["inv_sigma2"][:-1]), ValueError),
    (lambda a: _wrong(a, "points_w", a["points_w"].to("meta")), ValueError),
    (lambda a: {k: v.to("meta") for k, v in a.items()}, ValueError),
], ids=["points_float64", "pose_float64", "valid_uint8", "obs_two_columns",
        "pose_three_rows", "inv_sigma2_short", "mixed_devices", "meta_device"])
def test_optimize_pose_refuses_what_the_kernel_does_not_take(change, error):
    args = change(_args(pose_case("stereo_mix", 50, seed=1)))
    with pytest.raises(error):
        pose_opt.optimize_pose(camera(), **args)


# ------------------------------------------- the kernel's schedule, modelled
TH_MONO = float(np.float32(5.991))
TH_STEREO = float(np.float32(7.815))


def _lu_solve6(A, b):
    """csrc/pose_lm.cu::lu_solve6: the first row of largest magnitude is
    the pivot, only columns k.. are swapped, b is eliminated alongside."""
    A, b = A.copy(), b.copy()
    for k in range(6):
        p = k + int(np.argmax(np.abs(A[k:, k])))
        A[[k, p], k:], b[[k, p]] = A[[p, k], k:], b[[p, k]]
        for i in range(k + 1, 6):
            l = A[i, k] / A[k, k]
            A[i, k + 1:] -= l * A[k, k + 1:]
            b[i] -= l * b[k]
    for k in range(5, -1, -1):
        b[k] = (b[k] - A[k, k + 1:] @ b[k + 1:]) / A[k, k]
    return b


def _exp_times(xi, T):
    """csrc/pose_lm.cu::exp_times: Exp(xi) T with se3.exp's branches."""
    phi, rho = xi[3:], xi[:3]
    theta2 = phi @ phi
    theta = np.sqrt(max(theta2, 1e-16))
    small = theta2 < 1e-8
    a = 1 - theta2 / 6 if small else np.sin(theta) / theta
    b = 0.5 - theta2 / 24 if small else (1 - np.cos(theta)) / theta2
    c = 1 / 6 - theta2 / 120 if small else (theta - np.sin(theta)) / (theta2 * theta)
    P = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    E = np.eye(4)
    E[:3, :3] = np.eye(3) + a * P + b * P @ P
    E[:3, 3] = (np.eye(3) + b * P + c * P @ P) @ rho
    return E @ T


def _kernel_model(cam, Tcw0, points_w, obs, inv_sigma2, valid, is_stereo):
    """The kernel's passes in float64: returns (Tcw, inlier, n, chi2)."""
    T = Tcw0.numpy().astype(np.float64)
    pw, ob = points_w.numpy().astype(np.float64), obs.numpy().astype(np.float64)
    is2 = inv_sigma2.numpy().astype(np.float64)
    valid, st = valid.numpy(), is_stereo.numpy()
    th = np.where(st, TH_STEREO, TH_MONO)

    def visit(T, inlier, huber, reclassify):
        x, y, z = (pw @ T[:3, :3].T + T[:3, 3]).T
        zs = np.where(np.abs(z) < 1e-6, 1e-6, z)
        u = cam.fx * x / zs + cam.cx
        v = cam.fy * y / zs + cam.cy
        r = ob - np.stack([u, v, u - cam.bf / zs], axis=1)
        s2 = r[:, 0] ** 2 + r[:, 1] ** 2
        chi2 = np.where(st, s2 + r[:, 2] ** 2, s2) * is2
        pos = z > 1e-3
        if reclassify:
            inlier = valid & (chi2 <= th) & pos
        act = inlier & pos
        wh = np.where(chi2 <= th, 1.0, np.sqrt(th / np.maximum(chi2, 1e-12))) if huber else 1.0
        we = np.where(act, wh * is2, 0.0)
        iz = 1 / zs
        a0, a2 = cam.fx * iz, -cam.fx * x * iz**2
        b1, b2 = cam.fy * iz, -cam.fy * y * iz**2
        c2 = a2 + cam.bf * iz**2
        zero = np.zeros_like(x)
        J = np.stack([
            np.stack([-a0, zero, -a2, -a2 * y, a2 * x - a0 * z, a0 * y], axis=1),
            np.stack([zero, -b1, -b2, b1 * z - b2 * y, b2 * x, -b1 * x], axis=1),
            np.stack([-a0, zero, -c2, -c2 * y, c2 * x - a0 * z, a0 * y], axis=1)], axis=1)
        w = np.stack([we, we, we * st], axis=1)
        H = np.einsum("nrj,nr,nrk->jk", J, w, J)
        g = np.einsum("nrj,nr,nr->j", J, w, r)
        err = np.where(act, wh * chi2, 0.0).sum()
        return H, g, err, chi2, inlier

    def step(H, g, lam, T):
        A = H + np.diag(lam * np.diag(H)) + 1e-9 * np.eye(6)
        return _exp_times(-_lu_solve6(A, g), T)

    inlier = valid
    for rnd in range(pose_opt.N_ROUNDS):
        huber = rnd < 2
        H, g, err, _, inlier = visit(T, inlier, huber, reclassify=rnd > 0)
        lam = 1e-4
        T_try = step(H, g, lam, T)
        for it in range(pose_opt.N_ITERS):
            Hn, gn, en, _, _ = visit(T_try, inlier, huber, reclassify=False)
            if en < err:
                T, H, g, err = T_try, Hn, gn, en
                lam *= 0.5
            else:
                lam *= 4.0
            lam = min(max(lam, 1e-10), 1e6)
            if it + 1 < pose_opt.N_ITERS:
                T_try = step(H, g, lam, T)
    _, _, _, chi2, inlier = visit(T, inlier, False, reclassify=True)
    return T, inlier, int(inlier.sum()), chi2


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kernel_schedule_model_gives_the_reference(kind):
    """In float64 the model and the plain version agree to rounding: the
    same inliers, the pose within 1e-8 and chi2 within 1e-6 (near the
    optimum the accept test compares errors a few ulps apart, so the two
    sum orders may stop at points ~1e-9 apart, which moves a chi2 of a few
    units by ~1e-7)."""
    case = pose_case(kind, 300, seed=7 + len(kind))
    args = {k: case[k] for k in ARGS}
    T, inlier, n, chi2 = _kernel_model(camera(), **args)
    ref = pose_opt.optimize_pose_reference(
        camera(), **{k: (v.double() if v.is_floating_point() else v) for k, v in args.items()})
    np.testing.assert_allclose(T, ref.Tcw.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(inlier, ref.inlier.numpy())
    assert n == int(ref.n_inliers)
    np.testing.assert_allclose(chi2, ref.chi2.numpy(), rtol=1e-6, atol=1e-6)
    if kind == "none_valid":
        assert n == 0 and np.array_equal(T, args["Tcw0"].numpy().astype(np.float64))
    elif kind != "behind":
        # the optimum: within 1 cm and ~0.2 degrees of the true pose
        assert np.abs(T - case["T_true"]).max() < 1e-2
