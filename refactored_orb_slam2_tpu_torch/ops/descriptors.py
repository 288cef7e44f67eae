"""Packed binary descriptors and Hamming distance (port of ops/descriptors.py).

Layout: ``(N, 8) int32``.  Bit ``b`` of the 256-bit descriptor is bit
``b % 32`` of word ``b // 32`` (LSB-first): the same bits as the JAX
package's ``(N, 8) uint32`` words, reinterpreted as signed.  int32 rather
than uint32 because PyTorch on the CPU has no ``>>`` and no popcount on
``uint32``; ``io/convert.py`` moves banks across with a numpy ``view``.
"""

from __future__ import annotations

import functools

import torch

DESC_BITS = 256
DESC_WORDS = 8


@functools.lru_cache(maxsize=None)
def _popcount8(device: torch.device) -> torch.Tensor:
    return torch.tensor([bin(i).count("1") for i in range(256)],
                        dtype=torch.int32).to(device)


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) {0,1} -> (..., 8) int32 packed descriptors."""
    b = bits.to(torch.int64).reshape(bits.shape[:-1] + (DESC_WORDS, 32))
    words = torch.sum(b << _shifts(bits.device).to(torch.int64), dim=-1)
    # [0, 2^32) -> the int32 with the same bits
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (..., 256) {0,1} uint8."""
    bits = (packed[..., None] >> _shifts(packed.device)) & 1
    return bits.reshape(packed.shape[:-1] + (DESC_BITS,)).to(torch.uint8)


def unpack_pm1(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., 8) int32 -> (..., 256) ±1 planes for matmul Hamming."""
    return unpack_bits(packed).to(dtype) * 2 - 1


def hamming(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming (N1, 8), (N2, 8) -> (N1, N2) int32.

    ``(256 - A @ B^T) / 2`` over ±1 float32 planes: the products are ±1 and
    the 256-term sums are integers below 2^24, so the result is exact in
    any summation order (and under TF32, whose inputs ±1 survive).
    """
    dots = unpack_pm1(a_packed) @ unpack_pm1(b_packed).T
    return ((DESC_BITS - dots) * 0.5).to(torch.int32)


def hamming_rowwise(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """Elementwise row-to-row Hamming: (N, 8), (N, 8) -> (N,) int32,
    through a 256-entry byte popcount table."""
    x = torch.bitwise_xor(a_packed, b_packed).contiguous()
    bytes_ = x.view(torch.uint8).to(torch.int64)      # (..., 32)
    return _popcount8(x.device)[bytes_].sum(dim=-1).to(torch.int32)


def majority_descriptor(counts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(..., 256) per-bit counts of set bits over ``n`` descriptors -> the
    packed bitwise majority, ties set (FORB::meanValue, DBoW2/FORB.cpp:24-56)."""
    return pack_bits((2 * counts >= n).to(torch.uint8))


def mean_descriptor(packed: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Bitwise-majority mean of the valid rows: (N, 8), (N,) bool -> (8,)."""
    bits = unpack_bits(packed).to(torch.int32)
    n = torch.clamp(valid.sum(dtype=torch.int32), min=1)
    counts = torch.sum(bits * valid[:, None].to(torch.int32), dim=0)
    return majority_descriptor(counts, n)
