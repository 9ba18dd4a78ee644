"""Kernel K3: exclusive int32 prefix sum of the pm scan's baseband with
the (T, B, n) → (B, T·n) transpose fused in, and its plain version.

Replaces the TPU kernel ``_kernel`` of isee3_decoder_tpu/ops/
prefix_pallas.py:65 (entry ``prefix_sum_blocks``); CUDA source
csrc/prefix.cu.  The result is exact: int32 sums wrap exactly as the
JAX package's do, and the symbol demodulator only reads differences.

``tail`` appends that many columns holding each channel's grand total —
an edge extension of the prefix sum (the same values the JAX package's
``symbols.prefix_sum(pad_to=...)`` produces past the last sample), so
the timing search may read past the final sample without a copy.
"""

from __future__ import annotations

import torch

from isee3_decoder_tpu_torch import _kernels


def prefix_sum_blocks_plain(blocks: torch.Tensor, tail: int = 0) -> torch.Tensor:
    """Plain version of K3: (T, B, n) int16 → (B, T·n + tail) int32."""
    T, B, n = blocks.shape
    x = blocks.permute(1, 0, 2).reshape(B, T * n).to(torch.int64)
    inc = torch.cumsum(x, dim=1)
    exc = torch.cat([torch.zeros((B, 1), dtype=torch.int64,
                                 device=blocks.device), inc[:, :-1]], dim=1)
    total = inc[:, -1:].expand(B, tail)
    # int64 → int32 keeps the low 32 bits: two's-complement wraparound
    return torch.cat([exc, total], dim=1).to(torch.int32)


def prefix_sum_blocks(blocks: torch.Tensor, tail: int = 0) -> torch.Tensor:
    """K3: (T, B, n) int16 scan-layout baseband → (B, T·n + tail) int32
    exclusive prefix sum; columns past T·n hold the grand total."""
    if not _kernels.use_kernel(blocks):
        _kernels.note_backend("csum", "torch")
        return prefix_sum_blocks_plain(blocks, tail)
    if blocks.dtype != torch.int16 or blocks.ndim != 3:
        raise ValueError(f"blocks must be (T, B, n) int16, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    T, B, n = blocks.shape
    if min(T, B, n) < 1 or tail < 0 or T * n + tail >= 2**31:
        raise ValueError(f"unsupported shape T={T} B={B} n={n} tail={tail}")
    out = torch.empty((B, T * n + tail), dtype=torch.int32,
                      device=blocks.device)
    err = _kernels.lib().prefix_sum_launch(
        blocks.data_ptr(), T, B, n, tail, out.data_ptr(),
        _kernels.stream_ptr(blocks.device),
    )
    _kernels.check(err, "prefix_sum_launch")
    _kernels.count_launch("prefix_sum")
    _kernels.note_backend("csum", "cuda")
    return out
