"""Point-sharded bundle adjustment in one process over a list of devices
(port of parallel/dist_ba.py).

The JAX package annotates shardings and lets XLA insert the collectives;
here the reduction is named: ``optim/bundle_adjustment.py`` sends every sum
onto camera blocks through the problem's ``reduce``.

- The map points and the point-major observation arrays are cut into
  contiguous equal slices, one per mesh entry, each on its device.
- The camera (keyframe) arrays are replicated on every shard.
- Each shard computes its residuals, Jacobians, point blocks and point
  updates alone; the camera-side partial sums (``_assemble``'s segment sum,
  each PCG matvec's, the dense fill-in, the robust error) are moved to the
  first device, added in shard order (deterministic, unlike
  ``torch.cuda.comm.reduce_add``) and copied back to every shard's device,
  where the small camera solve runs alike.

A mesh may repeat a device: ``[torch.device("cpu")] * 8`` is the
counterpart of XLA's 8 virtual host devices, and ``[cuda:0] * 4`` runs four
shards on one card.  Across processes, ``parallel/multihost.py`` runs the
same BA with ``torch.distributed.all_reduce`` as its reduction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..optim import bundle_adjustment as BA

POINT_FIELDS = ("points", "point_valid", "obs_kf", "obs_uvr", "obs_inv_sigma2",
                "obs_is_stereo", "obs_valid")


class Mesh(NamedTuple):
    """The devices the point axis is cut over, in shard order."""

    devices: tuple
    axis: str = "points"


def visible_devices(device) -> list:
    """The devices a system on ``device`` may shard its global BA over:
    every visible CUDA device for a CUDA system, the device alone else."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def make_mesh(n_devices: int | None = None, axis: str = "points", devices=None) -> Mesh:
    """A 1-D mesh over ``devices`` (which may repeat one), by default every
    visible CUDA device; the first ``n_devices`` of them if given."""
    if devices is None:
        if torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=")
        devices = visible_devices("cuda")
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, axis)


def _sum_in_order(devices):
    """The in-process reduction: the partials added on ``devices[0]`` in
    shard order, the total copied to every other shard's device."""
    def reduce(parts):
        total = parts[0].to(devices[0])
        for part in parts[1:]:
            total = total + part.to(devices[0])
        return [total] + [total.to(d, copy=True) for d in devices[1:]]
    return reduce


def shard_ba_problem(prob: BA.BAProblem, mesh: Mesh) -> BA.ShardedBAProblem:
    """The problem on the mesh: point-major arrays cut into contiguous equal
    slices along the point axis, camera arrays replicated."""
    n, n_pts = len(mesh.devices), prob.points.shape[0]
    if n_pts % n:
        raise ValueError(f"shard_ba_problem: {n_pts} points do not divide into "
                         f"{n} equal shards")
    per = n_pts // n

    def shard(i, device):
        rows = slice(i * per, (i + 1) * per)
        return BA.BAProblem(**{
            f: (getattr(prob, f)[rows] if f in POINT_FIELDS else getattr(prob, f)).to(device)
            for f in BA.BAProblem._fields})

    return BA.ShardedBAProblem(tuple(shard(i, d) for i, d in enumerate(mesh.devices)),
                               _sum_in_order(mesh.devices))


def gather(result: BA.BAResult, device) -> BA.BAResult:
    """A sharded run's result as one problem's on ``device``: the first
    shard's replica of the poses and error, the points and masks in shard
    order."""
    device = torch.device(device)
    return BA.BAResult(kf_poses=result.kf_poses[0].to(device),
                       points=torch.cat([p.to(device) for p in result.points]),
                       obs_valid=torch.cat([v.to(device) for v in result.obs_valid]),
                       total_chi2=result.total_chi2[0].to(device))


def run_distributed_ba(cam, prob: BA.BAProblem, mesh: Mesh, *, iters_phase1: int = 10,
                       iters_phase2: int = 0, solver: str = "pcg",
                       n_cg: int = 80) -> BA.BAResult:
    """Global BA with the point axis sharded over the mesh, gathered back
    onto ``mesh.devices[0]``.  The point count must divide by the number of
    shards (the map's capacities are powers of two).  The matrix-free PCG
    solver is the default: each matvec's camera-side sum is one reduction."""
    result = BA.run(cam, shard_ba_problem(prob, mesh), iters_phase1=iters_phase1,
                    iters_phase2=iters_phase2, solver=solver, n_cg=n_cg)
    return gather(result, mesh.devices[0])
