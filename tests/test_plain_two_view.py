"""The port's two-view initializer against the plain reference
(``slambench/plain_two_view.py``), both handed the same minimal sets, on
seeded synthetic matches: a general scene (depths 3-8 m) and a planar one,
300 correspondences of which 260 are valid and 30 of those outliers, 0.5 px
of noise at a focal length of 500, and a general scene at the card's 1024
feature slots with 400 valid.

Compared under ``plain_two_view.TOLERANCES`` (each with its reason there):
every hypothesis's H and F score, the model chosen, the rotation, the
translation direction, the inlier mask, n_good and success.  The same
reference computed in bfloat16 fails at least one of them, and both refuse
a pure rotation and too few matches.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu_torch.solvers import initializer as tinit
from slambench import plain_two_view as plain

FOCAL = 500.0
SIGMA2 = (1.0 / FOCAL) ** 2


def _rot(rx, ry, rz):
    cx, sx, cy, sy, cz, sz = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


R_TRUE = _rot(0.02, -0.04, 0.03)
T_TRUE = np.array([0.35, 0.03, 0.05])


def two_view(planar: bool, seed: int, n: int = 300, n_valid: int = 260, t=T_TRUE):
    """(xn1, xn2, valid) as float32 / bool tensors: ``n`` slots, ``n_valid``
    of them matches, 30 of those outliers."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2.0, 2.0, (n, 2))
    z = 5.0 + 0.15 * xy[:, 0] - 0.1 * xy[:, 1] if planar else rng.uniform(3.0, 8.0, n)
    p = np.column_stack([xy, z])
    q = p @ R_TRUE.T + t
    xn1 = p[:, :2] / p[:, 2:] + rng.normal(0, 0.5 / FOCAL, (n, 2))
    xn2 = q[:, :2] / q[:, 2:] + rng.normal(0, 0.5 / FOCAL, (n, 2))
    valid = np.zeros(n, bool)
    valid[rng.choice(n, n_valid, replace=False)] = True
    outliers = rng.choice(np.nonzero(valid)[0], min(30, n_valid // 4), replace=False)
    xn2[outliers] = rng.uniform(-0.4, 0.4, (len(outliers), 2))
    return (torch.tensor(xn1, dtype=torch.float32), torch.tensor(xn2, dtype=torch.float32),
            torch.tensor(valid))


SCENES = {"general": (False, 11), "planar": (True, 12), "slots_1024": (False, 13, 1024, 400)}


def sets_for(valid, seed=3):
    return tinit.draw_minimal_sets(valid, tinit.N_HYPS, torch.Generator().manual_seed(seed))


def port_solve(xn1, xn2, valid, sets, sigma2=SIGMA2, focal=FOCAL) -> dict:
    """The port's ``initialize_two_view`` on ``sets``, with every
    hypothesis's scores as its first steps compute them."""
    p1n, T1 = tinit._normalize(xn1, valid)
    p2n, T2 = tinit._normalize(xn2, valid)
    g1, g2 = p1n[sets], p2n[sets]
    H = torch.linalg.inv_ex(T2).inverse @ tinit._solve_h(g1, g2) @ T1
    F = T2.T @ tinit._solve_f(g1, g2) @ T1
    SH, _ = tinit._score_h(H, torch.linalg.inv_ex(H).inverse, xn1, xn2, valid, sigma2)
    SF, _ = tinit._score_f(F, xn1, xn2, valid, sigma2)
    res = tinit.initialize_two_view(xn1, xn2, valid, sigma_px=1.0, focal=focal, sets=sets)
    return dict(res._asdict(), SH=SH, SF=SF)


def _failed(readings):
    return sorted(k for k, (_, _, within) in readings.items() if not within)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_port_agrees_with_the_plain_reference(scene):
    xn1, xn2, valid = two_view(*SCENES[scene])
    sets = sets_for(valid)
    got = port_solve(xn1, xn2, valid, sets)
    ref = plain.two_view(xn1, xn2, valid, sets, sigma_px=1.0, focal=FOCAL)
    readings = plain.compare(got, ref)
    assert not _failed(readings), readings
    assert ref["success"] and ref["is_h"] == (scene == "planar")
    assert ref["SH"].shape == ref["SF"].shape == (tinit.N_HYPS,)
    # the reference reaches the truth: rotation within 0.5 degree
    assert plain.rotation_deg(ref["R21"], torch.tensor(R_TRUE)) < 0.5


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_the_reference_in_bfloat16_fails_a_tolerance(scene):
    """The precision control: one precision below the configuration's
    (float32) is told apart by the comparison."""
    xn1, xn2, valid = two_view(*SCENES[scene])
    sets = sets_for(valid)
    got = port_solve(xn1, xn2, valid, sets)
    low = plain.two_view(xn1, xn2, valid, sets, sigma_px=1.0, focal=FOCAL, dtype=torch.bfloat16)
    assert low["SH"].dtype == torch.bfloat16
    assert _failed(plain.compare(got, low))


def _pure_rotation():
    xn1, _, valid = two_view(False, 11)
    p = torch.cat([xn1, torch.ones_like(xn1[:, :1])], dim=1) @ torch.tensor(
        R_TRUE, dtype=torch.float32).T
    return xn1, p[:, :2] / p[:, 2:], valid


REFUSED = {
    "pure_rotation": _pure_rotation,
    # 45 matches, 11 of them outliers: fewer than the 50 good points asked for
    "too_few_matches": lambda: two_view(False, 14, n_valid=45),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_both_refuse(case):
    xn1, xn2, valid = REFUSED[case]()
    sets = sets_for(valid)
    got = port_solve(xn1, xn2, valid, sets)
    ref = plain.two_view(xn1, xn2, valid, sets, sigma_px=1.0, focal=FOCAL)
    assert not ref["success"] and not bool(got["success"])
    readings = plain.compare(got, ref)
    for key in ("SH", "SF", "is_h", "success"):
        assert readings[key][2], (key, readings[key])


def test_tf32_off_while_it_runs_and_restored(monkeypatch):
    seen = []
    normalize = plain.normalize

    def spy(*a):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return normalize(*a)

    monkeypatch.setattr(plain, "normalize", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    xn1, xn2, valid = two_view(True, 12)
    plain.two_view(xn1, xn2, valid, sets_for(valid)[:4], sigma_px=1.0, focal=FOCAL)
    assert seen == [(False, False)] * 2
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_the_reference_imports_neither_package_nor_jax():
    tree = ast.parse(Path(plain.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "torch"}, names
