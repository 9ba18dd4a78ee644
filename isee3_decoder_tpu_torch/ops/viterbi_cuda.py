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
over int16 storage (the CUDA K6 in int16 halves: the same while the sums
stay in the int16 range, as the renormalization keeps them), and pack
the decisions in the contract layout of ops/viterbi_inplace.py.  K5 subtracts the deferred renormalization
``base`` as it reads; K6 emits per-row minima for the next cycle's base.

Both wrappers update ``metrics`` IN PLACE (the JAX functions return new
arrays) and write the decision planes into ``dec`` — a caller's (B,
nsteps, n/32) int32 view, so a frame's tape is filled where it lies, with
no concatenation.  Decision words are int32 (torch has no uint32).

``traceback`` walks a whole frame's tape back in one launch of
``viterbi_traceback_kernel`` (csrc/viterbi.cu); it replaces no TPU kernel
(the JAX package's traceback is jnp, viterbi_pallas_fused.py:620).  Its
plain twin is ops/viterbi_inplace.chainback_inplace.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import DEFAULT_CODE, CodeSpec
from isee3_decoder_tpu_torch.ops.viterbi_inplace import (
    _branch_masks,
    _rotr,
    chainback_inplace,
)


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
    reads its branch metrics from a table it builds per row (parities
    split by item and register bits) — so the check of kernel against
    plain also holds the two forms equal."""
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


A_LT = 8  # columns li of a K5 tile per (row, j): 16 bytes of int16
A_TILE = 32 * A_LT  # columns of a K5 tile: g*4096 + j*128 + l0 + li
A_CLUSTER = 4  # K5 tiles of a cluster: li 32u .. 32u+31, 64-byte runs
_SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90


@functools.lru_cache(maxsize=16)
def cycle_a_plan(code: CodeSpec) -> dict:
    """K5's launch plan (csrc/viterbi.cu ``viterbi_a_kernel``): one block
    per (frame, tile); tile ``x`` holds the columns g*4096 + j*128 + l0 +
    li (g = x >> 4, l0 = 8·(x & 15), j < 32, li < 8) of every row, whose
    decisions are words g*128 + l0 + li of each row.  Tiles x .. x+3 (x a
    multiple of 4) form a cluster that moves the metrics in 64-byte runs,
    li 32u .. 32u+31 of a (row, j).  Shared memory: the tile as
    int16 (512 bytes a row), three steps of decision words (32 bytes a
    row each) and the branch metrics of up to 8 steps."""
    _, rowb, colb = _geometry(code)
    nrows = 1 << rowb
    smem = nrows * 2 * A_TILE + 3 * nrows * 4 * A_LT + 4 * 4 * 8
    if smem > _SMEM_MAX:
        raise ValueError(f"{code.name}: K5 tile needs {smem} bytes of shared "
                         "memory")
    return {"tiles": (1 << colb) // A_TILE, "cluster": A_CLUSTER,
            "threads": min(512, max(128, 16 * nrows)), "smem": smem}


def cycle_a_tile(code: CodeSpec, x: int) -> tuple[np.ndarray, np.ndarray]:
    """Tile ``x`` of K5's plan → (the flat metric positions it holds, the
    decision word indices of a plane it writes), both int64."""
    _, rowb, colb = _geometry(code)
    g, l0 = x >> 4, (x & 15) * A_LT
    rows = np.arange(1 << rowb, dtype=np.int64)[:, None]
    cols = (g * 4096 + 128 * np.arange(32)[:, None]
            + l0 + np.arange(A_LT)[None, :]).reshape(-1)
    words = g * 128 + l0 + np.arange(A_LT)
    return ((rows << colb) | cols).reshape(-1), \
        (rows * ((1 << colb) // 32) + words).reshape(-1)


B_THREADS = 512  # threads of a K6 block (VB_THREADS): two blocks an SM
B_LANE_BITS = (7, 8, 9, 10, 11)  # column bits of j, a warp's lanes in K6


@functools.lru_cache(maxsize=64)
def cycle_b_plan(code: CodeSpec, nsteps: int | None = None) -> dict:
    """K6's launch plan (csrc/viterbi.cu ``viterbi_b_kernel``): one block
    per (frame, row); the row, 2^COLB int16, in shared memory as words
    of column pairs (c, c+1) at ``cycle_b_word(c)``.  Steps s = COLB-1,
    COLB-2, … (the pair offset 2^s) run in up to three register stages:

    - A: the g bits s = COLB-1 … 12 in registers, then the j bits s = 11
      … 7 across the lanes (the partner by a warp shuffle);
    - B: li bits s = 6, 5, 4 in registers;
    - C: li bits s = 3, 2, 1, 0 in registers (bit 0 pairs the halves of
      a word).

    A warp takes an item: lane j holds the values at the columns
    ``fixed(item) | j << 7 | reg(v)`` for every v — column bit 0 and the
    stage's register bits — so a decision ballot over the lanes is one
    whole decision word.  A stage's steps are truncated at ``nsteps``.
    Each stage: ``reg`` (the column bit of value bit k, k = 0, 1, …),
    ``fixed`` (the column bit of item bit k), ``steps`` (the pair bits
    s it runs), ``first`` (the index of its first step), ``items``.
    Shared memory: the row, the decision words of the longest stage run
    (a row's 2^COLB / 32 words a step), the branch-metric table (32
    packed (mt, mm) pairs a step) and the step masks."""
    _, _, colb = _geometry(code)
    nsteps = colb if nsteps is None else nsteps
    if not 1 <= nsteps <= colb:
        raise ValueError(f"{code.name}: K6 runs 1..{colb} steps, not {nsteps}")
    gbits = tuple(range(12, colb))
    full = (
        ((0, *gbits), (1, 2, 3, 4, 5, 6), tuple(range(colb - 1, 6, -1))),
        ((0, 4, 5, 6), (1, 2, 3, *gbits), (6, 5, 4)),
        ((0, 1, 2, 3), (4, 5, 6, *gbits), (3, 2, 1, 0)),
    )
    stages, first = [], 0
    for reg, fixed, steps in full:
        steps = steps[: nsteps - first]
        if not steps:
            break
        stages.append({"reg": reg, "fixed": fixed, "steps": steps,
                       "first": first, "items": 1 << len(fixed)})
        first += len(steps)
    ncols = 1 << colb
    dsteps = max(len(st["steps"]) for st in stages)
    smem = 2 * ncols + dsteps * (ncols // 32) * 4 + nsteps * (32 * 8 + 8)
    if smem > _SMEM_MAX:
        raise ValueError(f"{code.name}: K6 needs {smem} bytes of shared memory")
    return {"stages": stages, "threads": B_THREADS, "smem": smem,
            "dsteps": dsteps}


def cycle_b_columns(stage: dict, item: int) -> np.ndarray:
    """(32 lanes, values) int64 columns a warp holds for ``item`` of a
    stage of ``cycle_b_plan``: lane j, value v at fixed(item) | j << 7 |
    reg(v)."""
    def spread(x, bits):
        return sum(((x >> k) & 1) << b for k, b in enumerate(bits))

    v = np.arange(1 << len(stage["reg"]), dtype=np.int64)
    j = np.arange(32, dtype=np.int64)
    return (spread(item, stage["fixed"]) | spread(j, B_LANE_BITS)[:, None]
            | spread(v, stage["reg"])[None, :])


def cycle_b_word(c):
    """The shared-memory word of K6's row that holds column c (and its
    pair partner c ^ 1): (c >> 1) ^ j, j = (c >> 7) & 31, so that the 32
    lanes of a warp (the 32 values of j) read 32 banks."""
    return (c >> 1) ^ ((c >> 7) & 31)


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
    # the kernel moves metrics and decision words as 16-byte vectors
    if (metrics.data_ptr() % 16 or dec.data_ptr() % 16
            or dec.stride(0) % 4 or dec.stride(1) % 4):
        raise ValueError("cycle_a: metrics and dec must be 16-byte aligned, "
                         "dec's strides multiples of 4 words")
    plan = cycle_a_plan(code)
    q1, q2 = _branch_masks(code)
    err = _kernels.lib().viterbi_a_launch(
        metrics.data_ptr(), syms.data_ptr(), base.data_ptr(), dec.data_ptr(),
        dec.stride(0), dec.stride(1), B, rowb, colb, nsteps, q1, q2,
        code.g1flip, code.g2flip, plan["tiles"], plan["threads"],
        plan["smem"], _kernels.stream_ptr(dev),
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
    # the kernel moves metrics and decision words as 16-byte vectors
    if (metrics.data_ptr() % 16 or dec.data_ptr() % 16
            or dec.stride(0) % 4 or dec.stride(1) % 4):
        raise ValueError("cycle_b: metrics and dec must be 16-byte aligned, "
                         "dec's strides multiples of 4 words")
    mins = torch.empty((B, 1 << rowb), dtype=torch.int32, device=dev)
    plan = cycle_b_plan(code, nsteps)
    q1, q2 = _branch_masks(code)
    err = _kernels.lib().viterbi_b_launch(
        metrics.data_ptr(), syms.data_ptr(), dec.data_ptr(), dec.stride(0),
        dec.stride(1), mins.data_ptr(), B, rowb, colb, nsteps, q1, q2,
        code.g1flip, code.g2flip, plan["smem"], _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "viterbi_b_launch")
    _kernels.count_launch("viterbi_b")
    _kernels.note_backend("viterbi", "cuda")
    return metrics, dec, mins


def traceback(dec, nbits, endstate, code=DEFAULT_CODE):
    """The traceback over a fused decoder's tape: ``dec`` (B, nbits,
    2^W/32) int32, contiguous, plane t in P_{t+1} layout, from
    ``endstate`` — an int, or an integer tensor on the tape's device of
    one end state or one a frame — to (B, nbits) uint8 bits.  A CUDA tape
    takes one launch of ``viterbi_traceback_kernel``, the int end state
    as an argument and a tensor as a pointer (nothing is copied from the
    host); a CPU tape, or any under plain_reference(), takes
    chainback_inplace."""
    _check_code(code)
    shape = (nbits, code.nstates // 32)
    if dec.dtype != torch.int32 or dec.ndim != 3 or tuple(dec.shape[1:]) != shape:
        raise ValueError(f"traceback: the tape must be (B, {nbits}, "
                         f"{code.nstates // 32}) int32 planes, not "
                         f"{tuple(dec.shape)} {dec.dtype}")
    if not dec.is_contiguous():
        raise ValueError("traceback: the tape must be contiguous")
    if isinstance(endstate, torch.Tensor) and endstate.device != dec.device:
        raise ValueError("traceback: an end-state tensor must lie on the "
                         "tape's device")
    if not _kernels.use_kernel(dec):
        _kernels.note_backend("traceback", "torch")
        return chainback_inplace(dec.transpose(0, 1), nbits, endstate, code)
    B = dec.shape[0]
    out = torch.empty((B, nbits), dtype=torch.uint8, device=dec.device)
    if not out.numel():
        return out
    ends, end = None, 0
    if isinstance(endstate, torch.Tensor):
        ends = endstate.to(torch.int64).expand(B).contiguous()
    else:
        end = int(endstate) & code.state_mask
    err = _kernels.lib().viterbi_traceback_launch(
        dec.data_ptr(), None if ends is None else ends.data_ptr(), end,
        out.data_ptr(), B, code.k - 1, nbits, _kernels.stream_ptr(dec.device))
    _kernels.check(err, "viterbi_traceback_launch")
    _kernels.count_launch("viterbi_traceback")
    _kernels.note_backend("traceback", "cuda")
    return out
