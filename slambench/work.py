"""The benchmark's frozen count of the matchers' work, and the card's peaks.

The count is read from each call's own inputs (shapes, the window and
octave tests, the mask's true entries), never from a kernel, so the same
work is counted whatever implements it:

- bytes: every input once in, the (3, n1) int32 output once out;
- operations: a Hamming distance per candidate pair, 8 XOR and 8 POPC on
  32-bit words (256-bit descriptors).  POPC issues at a quarter of XOR's
  rate, so it bounds the pair; the candidate test itself is not counted
  (an index over the targets could skip most of it).

The least time is the larger of bytes / bandwidth and POPCs / POPC rate,
and a launch's share of its roofline is least time / device time.
"""

from __future__ import annotations

import numpy as np

from .reference import window_candidates

#: NVIDIA H100 SXM5 (the "H100 80GB HBM3" card), published figures
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,      # H100 SXM data sheet: 3.35 TB/s HBM3
    "sms": 132,                      # H100 SXM5: 132 SMs (H100 white paper)
    "boost_hz": 1.98e9,              # max boost clock 1980 MHz (H100 white paper)
    # CUDA C++ Programming Guide, "Arithmetic Instructions", throughput of
    # native arithmetic instructions per clock per SM, compute capability
    # 9.0: 32-bit population count 16 (32-bit bitwise AND/OR/XOR: 64)
    "popc_per_clk_sm": 16,
}
POPC_PER_S = PEAKS["popc_per_clk_sm"] * PEAKS["sms"] * PEAKS["boost_hz"]

POPC_PER_PAIR = 8          # 8 x 32-bit words per descriptor


def call_work(call: dict) -> tuple[float, float]:
    """(bytes, POPC operations) that one recorded matcher call needs."""
    a = call["args"]
    n1 = len(a[0])
    out_bytes = 3 * n1 * 4
    in_bytes = sum(np.asarray(x).nbytes for x in a)
    if call["name"] == "window_match":
        rows, _ = window_candidates(*a[2:], call["band"])
        pairs = len(rows)
    else:
        pairs = int(np.count_nonzero(np.asarray(a[2], bool)))
    return float(in_bytes + out_bytes), float(POPC_PER_PAIR * pairs)


def least_seconds(call: dict) -> float:
    """The least time the card could take for the call."""
    nbytes, popc = call_work(call)
    return max(nbytes / PEAKS["hbm_bytes_per_s"], popc / POPC_PER_S)
