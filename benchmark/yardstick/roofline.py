"""Peaks of the card and the least time a piece of work could take.

Peak rates of one NVIDIA H100 SXM at its full 700 W, from NVIDIA's
data sheet (dense, no sparsity); a card set to a lower power limit runs
slower, so every result carries the card's limit beside it.
"""

from __future__ import annotations

import math

#: HBM3 bandwidth, bytes/s (data sheet: 3.35 TB/s)
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, operations/s, an FMA counted as
#: two (data sheet: 67 TFLOP/s)
F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The least seconds the card could take: bytes over the HBM rate
    or operations over the peak rate of their type, whichever is
    larger, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dft_ops(n: int, K: int) -> float:
    """float32 operations a row needs for K bins of an n-point DFT: the
    direct sum's complex multiply-add (8) per sample and bin, or a
    radix-2 FFT's 5·n·log2(n) for every bin, whichever is fewer — the
    least the carrier search must do, whatever form a kernel gives it."""
    return min(8.0 * n * K, 5.0 * n * math.log2(n))


def window_bins(cfg: dict, n: int) -> int:
    """Bins a locked search looks at: ±search_width and Quinn's two
    neighbours."""
    return int(2 * cfg["search_width"] / (cfg["samprate"] / n)) + 3


def front_end_least_s(cfg: dict, channels: int, nblocks: int, n: int) -> tuple[float, str]:
    """The front end's least time for one block of the receive chain:
    the raw int16 IQ read once and the int32 prefix sum of the baseband
    (T·n + 1 columns) written once; the carrier search of the first pm
    block over the whole spectrum and of the others over the locked
    window, by dft_ops.  Unlocked blocks after the first need more, so
    this is a lower bound whatever the signal."""
    nbytes = channels * (nblocks * n * 4 + (nblocks * n + 1) * 4)
    ops = channels * (dft_ops(n, n) + (nblocks - 1) * dft_ops(n, window_bins(cfg, n)))
    return bound_s(nbytes, ops)
