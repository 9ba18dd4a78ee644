"""Kernels K5 and K6: one trellis cycle of the fused in-place Viterbi ACS,
split in two phases, and their plain PyTorch versions.

K5 ``cycle_a`` replaces the TPU kernel ``_kernel_a`` (isee3_decoder_tpu/
ops/viterbi_pallas_fused.py:157, call :341); K6 ``cycle_b`` replaces
``_kernel_b`` (:203, call :412).  CUDA source: csrc/viterbi.cu.

View the (B, 2^W) int16 metrics of one frame (rotating layout, see
ops/viterbi_inplace.py) as a (2^ROWB, 2^COLB) matrix.  Over one W-step
cycle the pair offset walks 2^(W-1) … 1: steps 0..ROWB-1 pair elements
across rows (K5: a column holds every pair it needs), steps ROWB..W-1
across columns of one row (K6).  Both phases compute, per pair (lo, hi)
with branch metric ``mt`` and ``mm = 510 - mt``:

    a0 = lo + mt, a1 = hi + mm, a2 = lo + mm, a3 = hi + mt
    d0 = a0 > a1 (decision at lo), d1 = a2 > a3 (decision at hi)
    lo' = a1 if d0 else a0,  hi' = a3 if d1 else a2

(ties keep a0 at lo and a2 at hi, viterbi224_sse2.c:303-321), in int32
over int16 storage, and pack the decisions in the contract layout of
ops/viterbi_inplace.py.  K5 subtracts the deferred renormalization
``base`` as it reads; K6 emits per-row minima for the next cycle's base.

Both wrappers update ``metrics`` IN PLACE (the JAX functions return new
arrays) and write the decision planes into ``dec`` — a caller's (B,
nsteps, n/32) int32 view, so a frame's tape is filled where it lies, with
no concatenation.  Decision words are int32 (torch has no uint32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import DEFAULT_CODE, CodeSpec
from isee3_decoder_tpu_torch.ops.viterbi_inplace import _branch_masks, _rotr


def _geometry(code: CodeSpec) -> tuple[int, int, int]:
    """(W, ROWB, COLB): row bits cover the steps with offsets >= 2^COLB."""
    w = code.k - 1
    colb = min(15, w - 1)
    rowb = w - colb
    return w, rowb, colb


def _step_masks(code: CodeSpec, t: int) -> tuple[int, int, int, int]:
    """Row/col parity masks for both polynomials at cycle step t."""
    w = code.k - 1
    _, rowb, colb = _geometry(code)
    q1, q2 = _branch_masks(code)
    m1 = _rotr(q1, t % w, w)
    m2 = _rotr(q2, t % w, w)
    colmask = (1 << colb) - 1
    return m1 >> colb, m1 & colmask, m2 >> colb, m2 & colmask


@functools.lru_cache(maxsize=16)
def _colpar_planes(code: CodeSpec, nsteps: int) -> np.ndarray:
    """(3*nsteps, 2^COLB) int32 column planes of the column phase: per
    step the column halves of the two branch-parity folds (at the pair's
    low column) and the high-position bit.  The TPU kernel B reads them
    precomputed; the plain K6 here uses them too, while the CUDA K6
    computes its parities with ``__popc`` — so the check of kernel
    against plain also holds the two forms equal."""
    w, rowb, colb = _geometry(code)
    cols = np.arange(1 << colb, dtype=np.int64)
    rows = []
    for j in range(nsteps):
        t = rowb + j
        _, cl1, _, cl2 = _step_masks(code, t)
        s = w - 1 - t
        o = 1 << s
        for mask in (cl1 & ~o, (cl1 ^ cl2) & ~o):
            v = cols & mask
            p = np.zeros_like(v)
            while mask:
                p ^= v & 1
                v >>= 1
                mask >>= 1
            rows.append(p)
        rows.append((cols >> s) & 1)
    return np.asarray(rows, dtype=np.int32)


def _parity(x: torch.Tensor) -> torch.Tensor:
    """Parity of integers below 2^32 by XOR folding."""
    for sh in (16, 8, 4, 2, 1):
        x = x ^ (x >> sh)
    return x & 1


def _pack_words(d: torch.Tensor) -> torch.Tensor:
    """(B, n) bool decisions in flat position order → (B, n/32) int32
    words: bit (p >> 7) & 31 of word (p >> 12) * 128 + (p & 127)."""
    B, n = d.shape
    bits = d.reshape(B, n // 4096, 32, 128).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=d.device)[:, None]
    # int64 → int32 keeps the low 32 bits: the uint32 word's bit pattern
    return (bits << shifts).sum(dim=2).reshape(B, n // 32).to(torch.int32)


def _acs(lo, hi, mt):
    """(lo', hi', d0, d1) of the butterfly; mt is the branch metric."""
    mm = 510 - mt
    a0, a1, a2, a3 = lo + mt, hi + mm, lo + mm, hi + mt
    d0 = a0 > a1
    d1 = a2 > a3
    return torch.where(d0, a1, a0), torch.where(d1, a3, a2), d0, d1


def _branch_metric(b0, b1, s0, s1):
    return (s0 + b0 * (255 - 2 * s0)) + (s1 + b1 * (255 - 2 * s1))


def _check_code(code: CodeSpec) -> None:
    # COLB >= 12 keeps a 4096-column word group inside one row; ROWB <= 8
    # bounds the row phase's column tile (csrc/viterbi.cu)
    if not 14 <= code.k <= 24:
        raise ValueError(f"{code.name}: the fused ACS takes 14 <= K <= 24")


def _dec_out(dec, B: int, nsteps: int, n: int, dev) -> torch.Tensor:
    if dec is None:
        return torch.empty((B, nsteps, n // 32), dtype=torch.int32, device=dev)
    if (dec.dtype != torch.int32 or tuple(dec.shape) != (B, nsteps, n // 32)
            or dec.stride(2) != 1 or dec.device != dev):
        raise ValueError(f"dec must be a ({B}, {nsteps}, {n // 32}) int32 view "
                         "with unit stride in its last axis on the metrics' "
                         "device")
    return dec


def cycle_a_plain(metrics, syms, code=DEFAULT_CODE, nsteps=None, base=None,
                  dec=None):
    """Plain version of K5 (the JAX ``_kernel_a``): steps 0..nsteps-1,
    row pairing, base subtracted as the metrics are read."""
    w, rowb, colb = _geometry(code)
    nsteps = rowb if nsteps is None else nsteps
    B, n = metrics.shape
    dev = metrics.device
    dec = _dec_out(dec, B, nsteps, n, dev)
    nrows, ncols = 1 << rowb, 1 << colb
    q1, q2 = _branch_masks(code)
    m = metrics.reshape(B, nrows, ncols).to(torch.int32)
    if base is not None:
        m = m - base.to(torch.int32)[:, None, None]
    rows = torch.arange(nrows, dtype=torch.int64, device=dev)
    cols = torch.arange(ncols, dtype=torch.int64, device=dev)
    s = syms.to(torch.int32)
    for t in range(nsteps):
        half = nrows >> (t + 1)
        v = m.reshape(B, 1 << t, 2, half, ncols)
        lo_rows = rows.reshape(1 << t, 2, half)[:, 0]
        p = (lo_rows[..., None] << colb) | cols  # (2^t, half, ncols)
        b0 = _parity(p & _rotr(q1, t, w)) ^ code.g1flip
        b1 = _parity(p & _rotr(q2, t, w)) ^ code.g2flip
        mt = _branch_metric(b0, b1, s[:, 2 * t, None, None, None],
                            s[:, 2 * t + 1, None, None, None]).to(torch.int32)
        nl, nh, d0, d1 = _acs(v[:, :, 0], v[:, :, 1], mt)
        m = torch.stack([nl, nh], dim=2).reshape(B, nrows, ncols)
        dec[:, t] = _pack_words(torch.stack([d0, d1], dim=2).reshape(B, n))
    metrics.copy_(m.reshape(B, n).to(torch.int16))
    return metrics, dec


def cycle_b_plain(metrics, syms, code=DEFAULT_CODE, nsteps=None, dec=None):
    """Plain version of K6 (the JAX ``_kernel_b``, column parities from
    ``_colpar_planes``): steps ROWB..ROWB+nsteps-1, column pairing.
    Returns (metrics, dec, mins (B, 2^ROWB) int32 per-row minima)."""
    w, rowb, colb = _geometry(code)
    nsteps = w - rowb if nsteps is None else nsteps
    B, n = metrics.shape
    dev = metrics.device
    dec = _dec_out(dec, B, nsteps, n, dev)
    nrows, ncols = 1 << rowb, 1 << colb
    planes = torch.as_tensor(_colpar_planes(code, nsteps), device=dev)
    m = metrics.reshape(B, nrows, ncols).to(torch.int32)
    rows = torch.arange(nrows, dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(ncols, dtype=torch.int64, device=dev)
    s = syms.to(torch.int32)
    for j in range(nsteps):
        t = rowb + j
        rh1, _, rh2, _ = _step_masks(code, t)
        o = 1 << (w - 1 - t)
        pb0 = _parity(rows & rh1) ^ planes[3 * j] ^ code.g1flip
        pb1 = (pb0 ^ _parity(rows & (rh1 ^ rh2)) ^ planes[3 * j + 1]
               ^ code.g1flip ^ code.g2flip)
        hi = planes[3 * j + 2].bool()
        mt = _branch_metric(pb0, pb1, s[:, 2 * j, None, None],
                            s[:, 2 * j + 1, None, None]).to(torch.int32)
        partner = m[:, :, cols ^ o]
        keep = m + mt  # a0 at lo positions, a3 at hi positions
        swap = partner + (510 - mt)  # a1 at lo positions, a2 at hi positions
        d = torch.where(hi, swap > keep, keep > swap)
        m = torch.where(d ^ hi, swap, keep)
        dec[:, j] = _pack_words(d.reshape(B, n))
    metrics.copy_(m.reshape(B, n).to(torch.int16))
    return metrics, dec, m.amin(dim=2)


def _check_launch(metrics, syms, code, nsteps, lo, hi, name):
    if (metrics.dtype != torch.int16 or metrics.ndim != 2
            or metrics.shape[1] != code.nstates or not metrics.is_contiguous()):
        raise ValueError(f"{name}: metrics must be contiguous (B, "
                         f"{code.nstates}) int16")
    B = metrics.shape[0]
    if (syms.dtype != torch.int32 or tuple(syms.shape) != (B, 2 * nsteps)
            or not syms.is_contiguous() or syms.device != metrics.device):
        raise ValueError(f"{name}: syms must be contiguous ({B}, {2 * nsteps}) "
                         "int32 on the metrics' device")
    if not lo <= nsteps <= hi:
        raise ValueError(f"{name}: nsteps {nsteps} outside [{lo}, {hi}]")


def cycle_a(metrics, syms, code=DEFAULT_CODE, nsteps=None, base=None, dec=None):
    """K5: steps 0..nsteps-1 of a cycle (row pairing) on (B, 2^W) int16
    metrics in P_0 layout, updated in place; syms (B, 2*nsteps) int32;
    base (B,) int32 subtracted as the metrics are read.  Returns
    (metrics, dec (B, nsteps, 2^W/32) int32)."""
    w, rowb, colb = _geometry(code)
    nsteps = rowb if nsteps is None else nsteps
    _check_code(code)
    if not _kernels.use_kernel(metrics):
        _kernels.note_backend("viterbi", "torch")
        return cycle_a_plain(metrics, syms, code, nsteps, base, dec)
    _check_launch(metrics, syms, code, nsteps, 1, rowb, "cycle_a")
    B, n = metrics.shape
    dev = metrics.device
    if base is None:
        base = torch.zeros(B, dtype=torch.int32, device=dev)
    if (base.dtype != torch.int32 or tuple(base.shape) != (B,)
            or base.device != dev or not base.is_contiguous()):
        raise ValueError("cycle_a: base must be contiguous (B,) int32")
    dec = _dec_out(dec, B, nsteps, n, dev)
    q1, q2 = _branch_masks(code)
    err = _kernels.lib().viterbi_a_launch(
        metrics.data_ptr(), syms.data_ptr(), base.data_ptr(), dec.data_ptr(),
        dec.stride(0), dec.stride(1), B, rowb, colb, nsteps, q1, q2,
        code.g1flip, code.g2flip, _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "viterbi_a_launch")
    _kernels.count_launch("viterbi_a")
    _kernels.note_backend("viterbi", "cuda")
    return metrics, dec


def cycle_b(metrics, syms, code=DEFAULT_CODE, nsteps=None, dec=None):
    """K6: steps ROWB..ROWB+nsteps-1 (column pairing) on (B, 2^W) int16
    metrics in P_ROWB layout, updated in place; syms (B, 2*nsteps) int32
    for those steps.  Returns (metrics, dec (B, nsteps, 2^W/32) int32,
    mins (B, 2^ROWB) int32 — each row's minimum; the frame's global
    minimum, the next cycle's base, is their amin)."""
    w, rowb, colb = _geometry(code)
    nsteps = w - rowb if nsteps is None else nsteps
    _check_code(code)
    if not _kernels.use_kernel(metrics):
        _kernels.note_backend("viterbi", "torch")
        return cycle_b_plain(metrics, syms, code, nsteps, dec)
    _check_launch(metrics, syms, code, nsteps, 1, w - rowb, "cycle_b")
    B, n = metrics.shape
    dev = metrics.device
    dec = _dec_out(dec, B, nsteps, n, dev)
    mins = torch.empty((B, 1 << rowb), dtype=torch.int32, device=dev)
    q1, q2 = _branch_masks(code)
    err = _kernels.lib().viterbi_b_launch(
        metrics.data_ptr(), syms.data_ptr(), dec.data_ptr(), dec.stride(0),
        dec.stride(1), mins.data_ptr(), B, rowb, colb, nsteps, q1, q2,
        code.g1flip, code.g2flip, _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "viterbi_b_launch")
    _kernels.count_launch("viterbi_b")
    _kernels.note_backend("viterbi", "cuda")
    return metrics, dec, mins
