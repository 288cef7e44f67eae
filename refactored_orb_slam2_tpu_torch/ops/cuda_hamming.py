"""The port's hand-written CUDA kernels, their loader and their plain
versions: the Hamming best-2 matchers, the pose-only LM that the tracked
frame runs twice, and the DLT's null vector of local mapping's
triangulation.

- ``window_match`` replaces ``refactored_orb_slam2_tpu/ops/pallas_hamming.py::
  window_match_pallas`` (kernel body ``_match_kernel``): per query row, the
  best distance, its target column and the second-best distance over the
  targets inside the row's pixel window and octave band, without storing
  the (N1, N2) distance matrix.  The kernel (``csrc/window_match.cu``) is
  bound by operations on the card (a window test per row and column, 8 XOR
  + 8 POPC per candidate pair, against 49 B of input per row and 45 B per
  column).
- ``hamming_best2`` replaces ``pallas_hamming.py::hamming_best2_pallas``
  (kernel body ``_kernel``): the same best-2, under a precomputed (N1, N2)
  bool mask.  The kernel (``csrc/masked_best2.cu``) is bound by the bytes
  of the mask, which it reads 16 at a time.
- ``pose_lm`` replaces no Pallas kernel: it runs the whole of
  ``optim/pose_opt.py::optimize_pose_reference`` (4 rounds of 10 LM
  iterations over one camera's edges) in one thread block
  (``csrc/pose_lm.cu``), where the plain version is some 8,200 small
  PyTorch kernels.  It is bound by latency: 49 normal-equation builds and
  40 damped 6x6 solves in one chain.  ``optimize_pose`` launches it on
  CUDA tensors.
- ``dlt_nullvec`` replaces no Pallas kernel either: it triangulates every
  correspondence of a keyframe pair by the smallest right singular vector
  of its 4x4 DLT system, one thread a correspondence, by one-sided Jacobi
  in float32 (``csrc/dlt_nullvec.cu``), where the plain version
  (``geometry/triangulation.py::triangulate_dlt``) calls
  ``torch.linalg.svd``, which synchronizes with the host and so cannot be
  captured in a CUDA graph.  Local mapping launches it on CUDA tensors.

Both matchers give each query row one warp with the lanes across columns,
gather the row's candidates into a queue so that all 32 lanes run their
popcounts together, read only the candidates' descriptors (from device
memory; the window matcher keeps the targets' uv and octave, 12 B a column,
in shared memory), and merge the lanes' best-2 with the tie rule of
``csrc/best2_merge.cuh``; their grids fill the card and walk over the rows.

See each source for its contract.  On a CUDA tensor a wrapper launches its
kernel or raises.  On a CPU tensor it runs its plain version
(``window_match_reference``, ``hamming_best2_reference``: dense Hamming,
then the masks, then ``masked_best2``; ``optimize_pose_reference``), which
is also what the kernel is checked against.  The kernels build at first use
with ``nvcc`` for ``sm_90a`` into ``build/`` next to this package, one
library a source, keyed by a hash of the source and of the shared header.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..geometry.triangulation import triangulate_dlt
from . import matching as M
from .descriptors import hamming

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "window_match": _PKG / "csrc" / "window_match.cu",
    "hamming_best2": _PKG / "csrc" / "masked_best2.cu",
    "pose_lm": _PKG / "csrc" / "pose_lm.cu",
    "dlt_nullvec": _PKG / "csrc" / "dlt_nullvec.cu",
}
HEADERS = (_PKG / "csrc" / "best2_merge.cuh",)     # the matchers' shared header
BUILD_DIR = _PKG / "build"

#: kernel launches per wrapper since the last reset (CPU calls are not counted)
launches = {name: 0 for name in SOURCES}
#: the same per thread name (the tracker's thread, the async mode's workers)
launches_by_thread: dict = {}
_count_lock = threading.Lock()

#: what nvcc printed for each kernel this process built (-Xptxas -v: the
#: registers, shared memory and spills of every kernel)
build_log: dict = {}

_libs: dict = {}


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0
        launches_by_thread.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` launches of ``name`` (negative: take them back) to the
    totals and to the calling thread's counts."""
    with _count_lock:
        launches[name] += n
        mine = launches_by_thread.setdefault(threading.current_thread().name,
                                             dict.fromkeys(SOURCES, 0))
        mine[name] += n


def thread_launches() -> dict:
    """A copy of the calling thread's launch counts."""
    with _count_lock:
        return dict(launches_by_thread.get(threading.current_thread().name,
                                           dict.fromkeys(SOURCES, 0)))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(b"".join(
        f.read_bytes() for f in (SOURCES[name], *HEADERS))).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every kernel (or those in ``names``) whose source has not been
    built yet, one source at a time; return {name: shared library path}."""
    names = list(SOURCES) if names is None else list(names)
    out = {name: _lib_path(name) for name in names}
    for name in names:
        if out[name].exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name].name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        build_log[name] = proc.stderr
        os.replace(tmp, out[name])
    return out


_ARGTYPES = {
    "window_match": ("window_match_launch",
                     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2),
    "hamming_best2": ("masked_best2_launch",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2),
    "pose_lm": ("pose_lm_launch",
                [ctypes.c_void_p] * 10 + [ctypes.c_int] + [ctypes.c_float] * 5
                + [ctypes.c_void_p]),
    "dlt_nullvec": ("dlt_nullvec_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]),
}


def _launcher(name: str):
    if name not in _libs:
        lib = ctypes.CDLL(str(build([name])[name]))
        symbol, argtypes = _ARGTYPES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = (lib, fn)
    return _libs[name][1]


def _check(spec, args, sizes):
    """Device, dtype and shape of every argument against ``spec`` rows
    (name, dtype, trailing shape, which leading size)."""
    device = args[0].device
    for (name, dtype, tail, side), t in zip(spec, args):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(sizes[s] for s in side) + tail:
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the CUDA kernels run on cuda or cpu tensors, not {device}")
    return device


def _call(name, device, *args) -> None:
    """One launch of ``name`` with ``args`` on the current stream of
    ``device``, counted; raises if the launch was refused."""
    fn = _launcher(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    if torch.cuda.current_device() == device.index:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    count(name)


def _launch(name, args, n1, *ints):
    """One (3, n1) int32 output, one launch on the current stream of the
    tensors' device, and the output's three rows; a view is copied to a
    contiguous tensor first.  Raises if the launch was refused."""
    if not all(t.is_contiguous() for t in args):
        args = tuple(t.contiguous() for t in args)
    ptrs = [t.data_ptr() for t in args]
    if ptrs[0] % 16 or ptrs[1] % 16:
        raise ValueError(f"{name}: descriptor banks must be 16-byte aligned")
    out = torch.empty((3, n1), dtype=torch.int32, device=args[0].device)
    _call(name, args[0].device, *ptrs, *ints, out.data_ptr())
    return out[0], out[1], out[2]


def window_match_reference(desc_q, desc_t, uv_q, uv_t, radius, oct_q, oct_t,
                           valid_q, valid_t, oct_band):
    """Plain PyTorch version: (d1, i1, d2) int32 per query row."""
    mask = M.window_mask(uv_q, uv_t, radius)
    mask = mask & M.octave_band_mask(oct_q, oct_t, oct_band[0], oct_band[1])
    mask = mask & valid_q[:, None] & valid_t[None, :]
    return M.masked_best2(hamming(desc_q, desc_t), mask)


_WINDOW_SPEC = (  # name, dtype, trailing shape, leading size ("q" or "t" rows)
    ("desc_q", torch.int32, (8,), "q"), ("desc_t", torch.int32, (8,), "t"),
    ("uv_q", torch.float32, (2,), "q"), ("uv_t", torch.float32, (2,), "t"),
    ("radius", torch.float32, (), "q"), ("oct_q", torch.int32, (), "q"),
    ("oct_t", torch.int32, (), "t"), ("valid_q", torch.bool, (), "q"),
    ("valid_t", torch.bool, (), "t"),
)


def window_match(desc_q, desc_t, uv_q, uv_t, radius, oct_q, oct_t,
                 valid_q, valid_t, oct_band: tuple[int, int]):
    """Fused window best-2 matcher.

    desc_q (N1, 8) int32, desc_t (N2, 8) int32, uv_q (N1, 2) / uv_t (N2, 2)
    float32, radius (N1,) float32, oct_q (N1,) / oct_t (N2,) int32,
    valid_q (N1,) / valid_t (N2,) bool, oct_band = (lo, hi) on
    oct_t - oct_q.  Returns (d1, i1, d2), each (N1,) int32.
    """
    args = (desc_q, desc_t, uv_q, uv_t, radius, oct_q, oct_t, valid_q, valid_t)
    n1, n2 = desc_q.shape[0], desc_t.shape[0]
    device = _check(_WINDOW_SPEC, args, {"q": n1, "t": n2})
    lo, hi = int(oct_band[0]), int(oct_band[1])
    if device.type == "cpu":
        return window_match_reference(*args, (lo, hi))
    return _launch("window_match", args, n1, n1, n2, lo, hi)


def hamming_best2_reference(desc_a, desc_b, mask):
    """Plain PyTorch version: (d1, i1, d2) int32 per row of ``desc_a``."""
    return M.masked_best2(hamming(desc_a, desc_b), mask)


_BEST2_SPEC = (
    ("desc_a", torch.int32, (8,), "a"), ("desc_b", torch.int32, (8,), "b"),
    ("mask", torch.bool, (), "ab"),
)


def hamming_best2(desc_a, desc_b, mask):
    """Masked best-2 matcher.

    desc_a (N1, 8) int32, desc_b (N2, 8) int32, mask (N1, N2) bool.
    Returns (d1, i1, d2), each (N1,) int32, as ``matching.masked_best2``
    of the Hamming matrix under ``mask``.
    """
    n1, n2 = desc_a.shape[0], desc_b.shape[0]
    device = _check(_BEST2_SPEC, (desc_a, desc_b, mask), {"a": n1, "b": n2})
    if device.type == "cpu":
        return hamming_best2_reference(desc_a, desc_b, mask)
    return _launch("hamming_best2", (desc_a, desc_b, mask), n1, n1, n2)


_POSE_SPEC = (
    ("Tcw0", torch.float32, (4, 4), ""), ("points_w", torch.float32, (3,), "n"),
    ("obs", torch.float32, (3,), "n"), ("inv_sigma2", torch.float32, (), "n"),
    ("valid", torch.bool, (), "n"), ("is_stereo", torch.bool, (), "n"),
)


def check_pose_lm(Tcw0, points_w, obs, inv_sigma2, valid, is_stereo) -> torch.device:
    """The device of ``pose_lm``'s tensors; raises on a mixed device, a
    dtype or a shape the kernel does not take."""
    n = points_w.shape[0] if points_w.dim() else -1
    return _check(_POSE_SPEC, (Tcw0, points_w, obs, inv_sigma2, valid, is_stereo), {"n": n})


def pose_lm(cam, Tcw0, points_w, obs, inv_sigma2, valid, is_stereo):
    """The pose-only LM as one launch of ``csrc/pose_lm.cu``, on CUDA
    tensors that ``check_pose_lm`` passed: Tcw0 (4, 4), points_w and obs
    (N, 3), inv_sigma2 (N,) float32, valid and is_stereo (N,) bool; the
    intrinsics ``cam.fx``, ``fy``, ``cx``, ``cy``, ``bf`` go in as float32.
    Returns (Tcw (4, 4), inlier (N,) bool, n_inliers () int32, chi2 (N,)),
    as ``optim/pose_opt.py::optimize_pose_reference``."""
    args = tuple(t.contiguous() for t in (Tcw0, points_w, obs, inv_sigma2, valid, is_stereo))
    device, n = Tcw0.device, points_w.shape[0]
    out = (torch.empty((4, 4), dtype=torch.float32, device=device),
           torch.empty(n, dtype=torch.bool, device=device),
           torch.empty((), dtype=torch.int32, device=device),
           torch.empty(n, dtype=torch.float32, device=device))
    _call("pose_lm", device, *(t.data_ptr() for t in args + out), n,
          cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    return out


_DLT_SPEC = (
    ("P1", torch.float32, (3, 4), ""), ("P2", torch.float32, (3, 4), ""),
    ("x1", torch.float32, (2,), "n"), ("x2", torch.float32, (2,), "n"),
)


def dlt_nullvec(P1, P2, x1, x2):
    """Two-view DLT triangulation: P1 and P2 (3, 4) float32 projections, x1
    and x2 (N, 2) float32 normalized coordinates of N correspondences.
    Returns (N, 3) float32 points, as ``triangulate_dlt`` (the plain
    version, which CPU tensors take): the null vector of each 4x4 DLT
    system, dehomogenised with the same guard on ``|w| < 1e-12``."""
    n = x1.shape[0] if x1.dim() else -1
    device = _check(_DLT_SPEC, (P1, P2, x1, x2), {"n": n})
    if device.type == "cpu":
        return triangulate_dlt(P1, P2, x1, x2)
    args = tuple(t.contiguous() for t in (P1, P2, x1, x2))
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    _call("dlt_nullvec", device, *(t.data_ptr() for t in args), out.data_ptr(), n)
    return out
