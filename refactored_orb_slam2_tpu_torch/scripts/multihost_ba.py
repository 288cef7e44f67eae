"""The multi-process BA check: the JAX package's two-controller problem
(``tests/test_multihost.py``: K 6 keyframes, P 64 points, O 4 observations,
``default_rng(7)``) on every rank of a ``torch.distributed`` job.

    python -m refactored_orb_slam2_tpu_torch.scripts.multihost_ba \\
        --rank R --world N --init file://$PWD/rendezvous --device cpu --out ba

Each rank builds the same arrays, keeps its point slice, runs
``parallel.multihost.run_multihost_ba`` (6 LM iterations, PCG), checks that
the cameras' translation error falls below half its start, saves its poses
and points to ``<out>.poses.<rank>.npy`` and ``<out>.points.<rank>.npy``
and prints ``WORKER_OK <rank>``.  :func:`launch` starts the ranks as
subprocesses and waits for them with a timeout.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

K, P_TOTAL, O = 6, 64, 4
FX, CX, CY, BF = 450.0, 160.0, 120.0, 45.0
ROOT = Path(__file__).resolve().parents[2]     # the checkout that holds the package


def problem() -> dict:
    """The JAX multihost worker's arrays, in its draw order (numpy)."""
    rng = np.random.default_rng(7)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k in range(K):
        poses[k, 0, 3] = -0.15 * k
    pts = np.stack([rng.uniform(-2, 2, P_TOTAL), rng.uniform(-1.5, 1.5, P_TOTAL),
                    rng.uniform(3, 9, P_TOTAL)], axis=1).astype(np.float32)
    obs_kf = rng.integers(0, K, (P_TOTAL, O)).astype(np.int32)
    uvr = np.zeros((P_TOTAL, O, 3), np.float32)
    for p in range(P_TOTAL):
        for o in range(O):
            T = poses[obs_kf[p, o]]
            pc = T[:3, :3] @ pts[p] + T[:3, 3]
            u = FX * pc[0] / pc[2] + CX
            v = FX * pc[1] / pc[2] + CY
            uvr[p, o] = [u, v, u - BF / pc[2]]
    uvr += rng.normal(0, 0.3, uvr.shape).astype(np.float32)
    pts_noisy = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    poses_noisy = poses.copy()
    poses_noisy[1:, :3, 3] += rng.normal(0, 0.02, (K - 1, 3)).astype(np.float32)
    return dict(poses=poses, poses_noisy=poses_noisy, points_noisy=pts_noisy, obs_kf=obs_kf,
                obs_uvr=uvr)


def ba_arrays(arrays: dict, lo: int = 0, hi: int = P_TOTAL) -> dict:
    """The BAProblem fields (numpy) with the point rows [lo, hi)."""
    n = hi - lo
    return dict(kf_poses=arrays["poses_noisy"], kf_fixed=np.asarray([True] + [False] * (K - 1)),
                kf_valid=np.ones(K, bool), points=arrays["points_noisy"][lo:hi],
                point_valid=np.ones(n, bool), obs_kf=arrays["obs_kf"][lo:hi],
                obs_uvr=arrays["obs_uvr"][lo:hi], obs_inv_sigma2=np.ones((n, O), np.float32),
                obs_is_stereo=np.ones((n, O), bool), obs_valid=np.ones((n, O), bool))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="host:port or an init_method URL")
    ap.add_argument("--device", required=True, help="this rank's device (cpu, cuda:0, ...)")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl for CUDA, gloo for the CPU)")
    ap.add_argument("--out", required=True, help="prefix of the saved arrays")
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from refactored_orb_slam2_tpu_torch.geometry.camera import Camera
    from refactored_orb_slam2_tpu_torch.optim.bundle_adjustment import BAProblem
    from refactored_orb_slam2_tpu_torch.parallel import multihost as MH

    torch.backends.cuda.matmul.allow_tf32 = False
    MH.init_process(args.init, args.world, args.rank, device=args.device, backend=args.backend)
    try:
        cam = Camera.create(FX, FX, CX, CY, bf=BF, width=320, height=240)
        arrays = problem()
        mesh = MH.global_mesh()
        lo, hi = MH.host_point_slice(P_TOTAL)
        prob = MH.global_ba_problem(BAProblem(**ba_arrays(arrays, lo, hi)), mesh, P_TOTAL)
        result = MH.run_multihost_ba(cam, prob, iters_phase1=6, iters_phase2=0)
        poses, points = MH.replicated_poses(result), MH.local_points(result)
    finally:
        torch.distributed.destroy_process_group()
    if points.shape != (hi - lo, 3):
        raise AssertionError(f"rank {args.rank}: points {points.shape}, slice {hi - lo}")
    if not (np.isfinite(poses).all() and np.isfinite(points).all()):
        raise AssertionError(f"rank {args.rank}: non-finite result")
    err0 = np.linalg.norm(arrays["poses_noisy"][:, :3, 3] - arrays["poses"][:, :3, 3])
    err1 = np.linalg.norm(poses[:, :3, 3] - arrays["poses"][:, :3, 3])
    if not err1 < 0.5 * err0:
        raise AssertionError(f"rank {args.rank}: camera error {err0} -> {err1}")
    np.save(f"{args.out}.poses.{args.rank}.npy", poses)
    np.save(f"{args.out}.points.{args.rank}.npy", points)
    print(f"camera error {err0:.6f} -> {err1:.6f} m")
    print("WORKER_OK", args.rank, flush=True)


def launch(world: int, init: str, devices: list, out: str, *, backend: str | None = None,
           timeout: float = 120.0) -> list:
    """Run ``world`` ranks of :func:`main` as subprocesses (rank r on
    ``devices[r]``) and return their outputs.  Raises if a rank exits
    non-zero, does not print ``WORKER_OK``, or outlives ``timeout``
    seconds; every rank is killed before it raises."""
    procs = []
    for rank in range(world):
        cmd = [sys.executable, "-m", "refactored_orb_slam2_tpu_torch.scripts.multihost_ba",
               "--rank", str(rank), "--world", str(world), "--init", init,
               "--device", str(devices[rank]), "--out", out]
        if backend:
            cmd += ["--backend", backend]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      env=dict(os.environ, OMP_NUM_THREADS="1")))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"WORKER_OK {rank}" not in text:
            raise RuntimeError(f"rank {rank} of {world} exited {p.returncode}:\n{text[-3000:]}")
    return outs


if __name__ == "__main__":
    main()
