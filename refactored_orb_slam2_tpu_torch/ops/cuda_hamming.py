"""Fused window matcher: the hand-written CUDA kernel and its plain version.

``window_match`` replaces ``refactored_orb_slam2_tpu/ops/pallas_hamming.py::
window_match_pallas`` (kernel body ``_match_kernel``): per query row, the
best distance, its target column and the second-best distance over the
targets inside the row's pixel window and octave band, without storing the
(N1, N2) distance matrix.  The kernel (``csrc/window_match.cu``) is bound by
integer ALU on the card (8 XOR + 8 POPC per candidate pair, against ~40 B
of input per row and per column); it keeps one query row per thread in
registers, stages the target bank through shared memory so each column is
read once per block, and runs the window test before the popcounts.  See
the source for the contract.

On a CUDA tensor the wrapper launches that kernel or raises.  On a CPU
tensor it runs ``window_match_reference`` (dense Hamming, then the masks,
then ``masked_best2``), which is also what the kernel is checked against.
The kernel builds at first use with ``nvcc`` for ``sm_90a`` into
``build/`` next to this package, keyed by a hash of the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import matching as M
from .descriptors import hamming

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "window_match.cu"
BUILD_DIR = _PKG / "build"

#: number of kernel launches since the last reset (CPU calls are not counted)
launches = 0

_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


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
                       "to build the window-match kernel")


def build() -> Path:
    """Compile the kernel if this source has not been built yet; return the
    shared library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"window_match_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.window_match_launch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def window_match_reference(desc_q, desc_t, uv_q, uv_t, radius, oct_q, oct_t,
                           valid_q, valid_t, oct_band):
    """Plain PyTorch version: (d1, i1, d2) int32 per query row."""
    mask = M.window_mask(uv_q, uv_t, radius)
    mask = mask & M.octave_band_mask(oct_q, oct_t, oct_band[0], oct_band[1])
    mask = mask & valid_q[:, None] & valid_t[None, :]
    return M.masked_best2(hamming(desc_q, desc_t), mask)


_SPEC = (  # name, dtype, trailing shape, which side (q rows or t rows)
    ("desc_q", torch.int32, (8,), "q"), ("desc_t", torch.int32, (8,), "t"),
    ("uv_q", torch.float32, (2,), "q"), ("uv_t", torch.float32, (2,), "t"),
    ("radius", torch.float32, (), "q"), ("oct_q", torch.int32, (), "q"),
    ("oct_t", torch.int32, (), "t"), ("valid_q", torch.bool, (), "q"),
    ("valid_t", torch.bool, (), "t"),
)


def window_match(desc_q, desc_t, uv_q, uv_t, radius, oct_q, oct_t,
                 valid_q, valid_t, oct_band: tuple[int, int]):
    """Fused masked best-2 matcher.

    desc_q (N1, 8) int32, desc_t (N2, 8) int32, uv_q (N1, 2) / uv_t (N2, 2)
    float32, radius (N1,) float32, oct_q (N1,) / oct_t (N2,) int32,
    valid_q (N1,) / valid_t (N2,) bool, oct_band = (lo, hi) on
    oct_t - oct_q.  Returns (d1, i1, d2), each (N1,) int32.
    """
    global launches
    args = (desc_q, desc_t, uv_q, uv_t, radius, oct_q, oct_t, valid_q, valid_t)
    device = desc_q.device
    n1, n2 = desc_q.shape[0], desc_t.shape[0]
    for (name, dtype, tail, side), t in zip(_SPEC, args):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != ((n1 if side == "q" else n2),) + tail:
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
    lo, hi = int(oct_band[0]), int(oct_band[1])
    if device.type == "cpu":
        return window_match_reference(*args, (lo, hi))
    if device.type != "cuda":
        raise ValueError(f"window_match runs on cuda or cpu tensors, not {device}")
    args = tuple(t.contiguous() for t in args)
    for name, t in (("desc_q", args[0]), ("desc_t", args[1])):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    d1 = torch.empty(n1, dtype=torch.int32, device=device)
    i1 = torch.empty(n1, dtype=torch.int32, device=device)
    d2 = torch.empty(n1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().window_match_launch(
            *(t.data_ptr() for t in args), n1, n2, lo, hi,
            d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"window_match kernel launch failed: cudaError {err}")
    launches += 1
    return d1, i1, d2
