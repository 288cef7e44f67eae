"""Bundle adjustment across processes on ``torch.distributed`` (port of
parallel/multihost.py).

One process per device, the PyTorch idiom, where the JAX package runs one
controller per host over its global device list:

- every process calls :func:`init_process` (wraps
  ``torch.distributed.init_process_group``);
- each rank holds only its contiguous slice of the point and observation
  arrays (:func:`host_point_slice`); the camera arrays are small and made
  replicated by a broadcast from rank 0 (:func:`global_ba_problem`);
- every rank then calls :func:`run_multihost_ba`, the same ``BA.run`` as
  ``dist_ba``, whose camera-side sums are one
  ``torch.distributed.all_reduce(SUM)`` each;
- the poses come back alike on every rank (:func:`replicated_poses`), the
  points as the rank's own slice (:func:`local_points`).

The slices must be equal: the point count divides by the world size (the
map's capacities are powers of two).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..optim import bundle_adjustment as BA
from .dist_ba import POINT_FIELDS

POINT_AXIS = "points"

# this process's device, named once at init_process: one per process, as
# torch.distributed keeps its default process group
_rank_device: torch.device | None = None


class HostMesh(NamedTuple):
    """The process group, this rank's device and the point axis."""

    group: object
    device: torch.device
    axis: str = POINT_AXIS


def init_process(coordinator_address: str | None = None, num_processes: int | None = None,
                 process_id: int | None = None, *, device, backend: str | None = None) -> None:
    """Join the job.  ``coordinator_address`` is ``host:port`` (TCP) or a
    whole ``init_method`` URL (``file://...`` for a rendezvous through a
    file); with no arguments the rendezvous, rank and world size come from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``).  The backend follows ``device``: NCCL for CUDA, gloo
    for the CPU; ``backend="gloo"`` puts ranks that share one card (which
    NCCL refuses) on gloo, whose all-reduce takes CUDA tensors."""
    global _rank_device
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)
    _rank_device = device


def global_mesh() -> HostMesh:
    """The job's point axis: every rank, this rank's device."""
    if _rank_device is None or not dist.is_initialized():
        raise RuntimeError("global_mesh: call init_process first")
    return HostMesh(dist.group.WORLD, _rank_device)


def host_point_slice(total_points: int) -> tuple[int, int]:
    """[start, stop) of this rank's point partition."""
    n = dist.get_world_size()
    if total_points % n:
        raise ValueError(f"point capacity {total_points} not divisible by {n} processes")
    per = total_points // n
    i = dist.get_rank()
    return i * per, (i + 1) * per


def _all_reduce(group):
    def reduce(parts):
        (part,) = parts
        part = part.contiguous()
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
        return [part]
    return reduce


def global_ba_problem(local: BA.BAProblem, mesh: HostMesh,
                      total_points: int) -> BA.ShardedBAProblem:
    """This rank's shard of the global problem.  ``local`` holds the rank's
    slice (``host_point_slice(total_points)`` rows) of every point-major
    array, numpy or tensors, and the camera arrays, which rank 0's
    broadcast makes alike on every rank.  No point crosses ranks."""
    lo, hi = host_point_slice(total_points)

    def here(x):
        return torch.as_tensor(x).to(mesh.device)

    def point_major(f):
        x = here(getattr(local, f))
        if x.shape[0] != hi - lo:
            raise ValueError(f"global_ba_problem: {f} has {x.shape[0]} rows, this rank's "
                             f"slice [{lo}, {hi}) of {total_points} has {hi - lo}")
        return x

    def replicated(f):
        x = here(getattr(local, f)).contiguous()
        dist.broadcast(x, src=0, group=mesh.group)
        return x

    shard = BA.BAProblem(**{f: point_major(f) if f in POINT_FIELDS else replicated(f)
                            for f in BA.BAProblem._fields})
    return BA.ShardedBAProblem((shard,), _all_reduce(mesh.group))


def run_multihost_ba(cam, global_prob: BA.ShardedBAProblem, *, iters_phase1: int = 10,
                     iters_phase2: int = 0, solver: str = "pcg", n_cg: int = 80) -> BA.BAResult:
    """The Schur BA over every rank's shard; call it from every rank.  The
    result holds the replicated poses and error and this rank's points."""
    result = BA.run(cam, global_prob, iters_phase1=iters_phase1, iters_phase2=iters_phase2,
                    solver=solver, n_cg=n_cg)
    return BA.BAResult(*(field[0] for field in result))


def local_points(result: BA.BAResult) -> np.ndarray:
    """This rank's optimized point slice."""
    return result.points.cpu().numpy()


def replicated_poses(result: BA.BAResult) -> np.ndarray:
    """The optimized camera poses, alike on every rank."""
    return result.kf_poses.cpu().numpy()
