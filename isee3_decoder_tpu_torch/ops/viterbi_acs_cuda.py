"""Kernel K10: one trellis step of the classic Viterbi decoder, and its
plain PyTorch version.

K10 ``acs_step`` replaces the TPU kernel ``_acs_kernel``
(isee3_decoder_tpu/ops/viterbi_pallas.py:39, call :165); CUDA source:
csrc/viterbi_acs.cu.  Metrics are in standard state order: butterfly i
pairs states i and i + 2^(K-2) and writes new states 2i and 2i+1.  The
renormalization is folded into the branch metric: the step subtracts
``adjust``, the previous step's global minimum, as it adds, and returns
its own global minimum for the next step (viterbi_pallas.py:61-109).
Arithmetic is int32 over the stored metric type (int16 or int32): the
branch metrics are cast to it and the adds wrap in it, as jnp's
``astype`` and int16 adds wrap — no saturation.

Decision words follow ``decision_t`` (bit ``s & 31`` of word ``s >> 5``)
and are int32 holding the uint32 bits (torch has no general uint32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import DEFAULT_CODE, CodeSpec

INT32_MAX = 2**31 - 1


def branch_masks(code: CodeSpec) -> tuple[int, int]:
    """The polynomials' bits 1..K-2: b = flip ^ parity((2i) & mask), the
    form K10 computes with one __popc per bit."""
    m = (1 << (code.k - 1)) - 1
    return code.poly1 & m, code.poly2 & m


def _parity_u32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    for sh in (32, 16, 8, 4, 2, 1):
        x ^= x >> np.uint64(sh)
    return (x & np.uint64(1)).astype(np.uint8)


@functools.lru_cache(maxsize=8)
def branch_bits(code: CodeSpec = DEFAULT_CODE) -> tuple[np.ndarray, np.ndarray]:
    """0/1 branch bits (uint8) for each butterfly index i in [0, 2^(K-2)):
    ``Branchtab224[p][i] = GFLIP ^ parity((2i) & POLY)``
    (viterbi224_sse2.c:74-77).  The plain step reads them; K10 computes
    them in the kernel."""
    i = np.arange(1 << (code.k - 2), dtype=np.uint64)
    b0 = code.g1flip ^ _parity_u32((2 * i) & np.uint64(code.poly1))
    b1 = code.g2flip ^ _parity_u32((2 * i) & np.uint64(code.poly2))
    return b0.astype(np.uint8), b1.astype(np.uint8)


def _pack(d: torch.Tensor) -> torch.Tensor:
    """(B, n) bool decisions in state order → (B, n/32) int32 words."""
    B, n = d.shape
    bits = d.reshape(B, n // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=d.device)
    # int64 → int32 keeps the low 32 bits: the uint32 word's bit pattern
    return (bits << shifts).sum(dim=2).to(torch.int32)


def acs_step_plain(metrics: torch.Tensor, syms: torch.Tensor,
                   adjust: torch.Tensor, code: CodeSpec = DEFAULT_CODE):
    """Plain version of K10: (B, 2^(K-1)) int16/int32 metrics, (B, 2)
    int32 symbols, (B,) int32 adjust → (new metrics of the same type,
    decisions (B, 2^(K-1)/32) int32, global minimum (B,) int32)."""
    B, n = metrics.shape
    dt = metrics.dtype
    dev = metrics.device
    b0, b1 = (torch.as_tensor(b, device=dev).to(torch.int32)[None, :]
              for b in branch_bits(code))
    s = syms.to(torch.int32)
    s0, s1 = s[:, 0:1], s[:, 1:2]
    adj = adjust.to(torch.int32)[:, None]
    metric32 = (s0 + b0 * (255 - 2 * s0)) + (s1 + b1 * (255 - 2 * s1)) - adj
    mt = metric32.to(dt)
    mm = (510 - metric32 - 2 * adj).to(dt)
    lo, hi = metrics[:, : n // 2], metrics[:, n // 2 :]
    m0, m1, m2, m3 = lo + mt, hi + mm, lo + mm, hi + mt
    d0, d1 = m0 > m1, m2 > m3
    v0, v1 = torch.minimum(m0, m1), torch.minimum(m2, m3)
    new = torch.stack([v0, v1], dim=-1).reshape(B, n)
    dec = _pack(torch.stack([d0, d1], dim=-1).reshape(B, n))
    gmin = torch.minimum(v0.amin(dim=1), v1.amin(dim=1)).to(torch.int32)
    return new, dec, gmin


def check_launch(metrics, syms, adjust, code, out, dec, name) -> None:
    if code.k < 7 or code.k > 24:
        raise ValueError(f"{name}: K10 takes 7 <= K <= 24, not {code.k}")
    if (metrics.dtype not in (torch.int16, torch.int32) or metrics.ndim != 2
            or metrics.shape[1] != code.nstates or not metrics.is_contiguous()):
        raise ValueError(f"{name}: metrics must be contiguous (B, "
                         f"{code.nstates}) int16 or int32")
    B = metrics.shape[0]
    dev = metrics.device
    for what, t, shape in (("syms", syms, (B, 2)), ("adjust", adjust, (B,)),
                           ("dec", dec, (B, code.nstates // 32))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name}: {what} must be contiguous {shape} int32 "
                             "on the metrics' device")
    if (out.dtype != metrics.dtype or out.shape != metrics.shape
            or not out.is_contiguous() or out.device != dev
            or out.data_ptr() == metrics.data_ptr()):
        raise ValueError(f"{name}: out must be a contiguous buffer like the "
                         "metrics, distinct from them")


def launch(metrics, syms, adjust, out, dec, gmin, code=DEFAULT_CODE,
           reset=None, renorm=None, stream=None) -> None:
    """One K10 launch, no checks: ops/viterbi.update_blk's per-step call.
    ``gmin`` (B,) int32 must hold INT32_MAX and receives the step's
    minimum; ``reset`` (set to INT32_MAX) and ``renorm`` (+= adjust) are
    (B,) int32 or None."""
    q1, q2 = branch_masks(code)
    err = _kernels.lib().viterbi_acs_launch(
        metrics.data_ptr(), out.data_ptr(), syms.data_ptr(), adjust.data_ptr(),
        gmin.data_ptr(), None if reset is None else reset.data_ptr(),
        None if renorm is None else renorm.data_ptr(), dec.data_ptr(),
        metrics.shape[0], code.k - 2, metrics.element_size(), q1, q2,
        code.g1flip, code.g2flip,
        _kernels.stream_ptr(metrics.device) if stream is None else stream,
    )
    _kernels.check(err, "viterbi_acs_launch")
    _kernels.count_launch("viterbi_acs")
    _kernels.note_backend("viterbi", "cuda")


def acs_step(metrics: torch.Tensor, syms: torch.Tensor, adjust: torch.Tensor,
             code: CodeSpec = DEFAULT_CODE, out: torch.Tensor | None = None,
             dec: torch.Tensor | None = None):
    """K10 on a CUDA tensor (the plain version on a CPU one): one trellis
    step of (B, 2^(K-1)) int16/int32 metrics with (B, 2) int32 symbols
    and (B,) int32 adjust.  ``out`` (like the metrics, another buffer)
    and ``dec`` ((B, 2^(K-1)/32) int32, e.g. a tape slot) receive the new
    metrics and decisions when given.  Returns (new metrics, decisions,
    global minimum (B,) int32)."""
    if not _kernels.use_kernel(metrics):
        _kernels.note_backend("viterbi", "torch")
        new, d, gmin = acs_step_plain(metrics, syms, adjust, code)
        if out is not None:
            new = out.copy_(new)
        if dec is not None:
            d = dec.copy_(d)
        return new, d, gmin
    B = metrics.shape[0]
    dev = metrics.device
    out = torch.empty_like(metrics) if out is None else out
    dec = (torch.empty((B, code.nstates // 32), dtype=torch.int32, device=dev)
           if dec is None else dec)
    check_launch(metrics, syms, adjust, code, out, dec, "acs_step")
    gmin = torch.full((B,), INT32_MAX, dtype=torch.int32, device=dev)
    launch(metrics, syms, adjust, out, dec, gmin, code)
    return out, dec, gmin
