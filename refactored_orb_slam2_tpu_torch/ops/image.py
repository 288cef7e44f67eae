"""Image-plane ops: Gaussian blur and the bilinear pyramid (port of
ops/image.py).

Images are ``(H, W)`` float32 in [0, 255].  The blur is written as shifted
sums in the JAX package's order, not as a cuDNN convolution, which would run
in TF32 by default on the card and flip descriptor bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _gaussian_kernel1d(ksize: int, sigma: float) -> tuple:
    # cv::getGaussianKernel formula, rounded to float32
    half = (ksize - 1) / 2.0
    x = np.arange(ksize) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _reflect101_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.pad(np.arange(n), pad, mode="reflect")).to(device)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect-101 borders (OpenCV default)."""
    k = _gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    h, w = img.shape
    x = img.index_select(0, _reflect101_index(h, pad, img.device))
    out = k[0] * x[0:h, :]
    for i in range(1, ksize):
        out = out + k[i] * x[i : i + h, :]
    x = out.index_select(1, _reflect101_index(w, pad, img.device))
    out = k[0] * x[:, 0:w]
    for i in range(1, ksize):
        out = out + k[i] * x[:, i : i + w]
    return out


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_out, n_in) bilinear interpolation matrix with half-pixel centers
    (the cv::resize INTER_LINEAR sampling grid, edge-clamped)."""
    A = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        f = src - i0
        i0c = min(max(i0, 0), n_in - 1)
        i1c = min(max(i0 + 1, 0), n_in - 1)
        A[o, i0c] += 1.0 - f
        A[o, i1c] += f
    return torch.from_numpy(A).to(device)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centers as ``A_h @ img @ A_w^T``."""
    h, w = img.shape
    Ah = _resize_matrix(h, out_h, img.device)
    Aw = _resize_matrix(w, out_w, img.device)
    return Ah @ img @ Aw.T


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    """Per-level (H, W), rounded like the reference (cvRound(W/scale))."""
    return [
        (int(round(h / scale_factor ** lv)), int(round(w / scale_factor ** lv)))
        for lv in range(n_levels)
    ]


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float):
    """Per-level images, each resized from the previous level (the
    reference's chained resize)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    out = [img]
    for lv in range(1, n_levels):
        out.append(resize_bilinear(out[-1], *shapes[lv]))
    return out


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    return np.asarray([scale_factor ** lv for lv in range(n_levels)],
                      dtype=np.float32)


@functools.lru_cache(maxsize=None)
def scale_table(values: tuple, device: torch.device) -> torch.Tensor:
    """A small constant table (per-level scales, a sign pattern) as float32
    on ``device``, built once per device: a tensor made from Python floats
    on a CUDA device copies from host memory and synchronizes."""
    return torch.tensor(values, dtype=torch.float32).to(device)


@functools.lru_cache(maxsize=None)
def index_table(values: tuple, device: torch.device) -> torch.Tensor:
    """A small constant int64 table (per-level row offsets) on ``device``,
    built once per device, as ``scale_table``."""
    return torch.tensor(values, dtype=torch.int64).to(device)


def level_sigma2(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-octave variance (mvLevelSigma2), the optimizers' information."""
    return scale_factors(n_levels, scale_factor) ** 2
