"""Plain Viterbi decoder of a whole frame (viterbi224_sse2.c), in
PyTorch on any device.

2^(K-1) path metrics in int32, standard state order: new state 2i + j
comes from state i or state i + 2^(K-2); the branch cost of a symbol is
its soft value for a sent 0 and 255 minus it for a sent 1.  Unknown
start states begin START_BIAS worse than the known one; a tie keeps the
lower predecessor.  One packed decision bit a state a step, then the
traceback from the known end state.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.codec import CodeSpec

START_BIAS = 5000


def _parity(x: np.ndarray) -> np.ndarray:
    for shift in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> np.uint64(shift))
    return (x & np.uint64(1)).astype(np.int32)


def _branch_bits(code: CodeSpec, device):
    """The sent symbol pair of butterfly i: the encoder's parities of
    the state 2i (viterbi224_sse2.c:74-77)."""
    two_i = 2 * np.arange(1 << (code.k - 2), dtype=np.uint64)
    b0 = code.g1flip ^ _parity(two_i & np.uint64(code.poly1))
    b1 = code.g2flip ^ _parity(two_i & np.uint64(code.poly2))
    return torch.as_tensor(b0, device=device), torch.as_tensor(b1, device=device)


def viterbi_frames(syms: torch.Tensor, nbits: int, start: int, end: int,
                   code: CodeSpec) -> torch.Tensor:
    """(B, 2·nbits) uint8 soft symbols → (B, nbits) uint8 bits of the
    best path from ``start`` to ``end``."""
    B = syms.shape[0]
    dev = syms.device
    n = code.nstates
    half = n // 2
    b0, b1 = _branch_bits(code, dev)
    s = syms.to(torch.int32)
    metrics = torch.full((B, n), START_BIAS, dtype=torch.int32, device=dev)
    metrics[:, start & code.state_mask] = 0
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    dec = torch.empty((nbits, B, n // 8), dtype=torch.uint8, device=dev)
    for t in range(nbits):
        s0, s1 = s[:, 2 * t: 2 * t + 1], s[:, 2 * t + 1: 2 * t + 2]
        mt = s0 + b0[None, :] * (255 - 2 * s0) + s1 + b1[None, :] * (255 - 2 * s1)
        mm = 510 - mt
        lo, hi = metrics[:, :half], metrics[:, half:]
        m0, m1, m2, m3 = lo + mt, hi + mm, lo + mm, hi + mt
        d = torch.stack([m0 > m1, m2 > m3], dim=-1).reshape(B, n)
        metrics = torch.stack([torch.minimum(m0, m1), torch.minimum(m2, m3)],
                              dim=-1).reshape(B, n)
        dec[t] = (d.reshape(B, n // 8, 8).to(torch.uint8) << shifts).sum(
            dim=-1, dtype=torch.uint8)
    state = torch.full((B,), end & code.state_mask, dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    out = torch.empty((nbits, B), dtype=torch.uint8, device=dev)
    for t in range(nbits - 1, -1, -1):
        out[t] = (state & 1).to(torch.uint8)
        byte = dec[t, rows, state >> 3].to(torch.int64)
        bit = (byte >> (state & 7)) & 1
        state = (bit << (code.k - 2)) | (state >> 1)
    return out.T.contiguous()
