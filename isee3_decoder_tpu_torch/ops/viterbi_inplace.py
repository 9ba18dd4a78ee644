"""The rotating-layout contract of the in-place Viterbi ACS
(isee3_decoder_tpu/ops/viterbi_inplace.py), which the fused kernels K5/K6
(ops/viterbi_cuda.py) and the traceback share.

Metrics live in *position space*: after t trellis steps state ``s`` sits
at ``P_t(s) = rotr^t(s)`` (a rotation of its W = K-1 bits), so every ACS
butterfly writes its survivors exactly where it read its sources and the
step is elementwise over two half-views whose pair offset is
``2^((W-1-t) mod W)``.  The branch bit of position p at step t is
``flip ^ parity(p & rotr^t(q))`` with q the polynomial's butterfly mask.

Decision words (the contract chainback and the stream tape read): for
flat position p, the bit is ``(p >> 7) & 31`` of word
``((p >> 7) >> 5) * 128 + (p & 127)`` of the step's (n/32)-word plane.
torch has no general uint32, so words are stored as int32 and every
right shift of one is masked.

Only the contract is ported; the JAX package's XLA step kernel
(``_step_inplace`` / ``update_frame_inplace`` / ``stream_update``) is not
a path of the port — the fused kernels are its only ACS.
"""

from __future__ import annotations

import dataclasses

import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import DEFAULT_CODE, CodeSpec
from isee3_decoder_tpu_torch.utils import profiling

#: Starting-state bias: unknown states start this much worse than the
#: known start state (ops/viterbi.py:53; viterbi224_sse2.c:44-50).
START_BIAS = 5000


def _rotr(x: int, t: int, w: int) -> int:
    t %= w
    mask = (1 << w) - 1
    return ((x >> t) | (x << (w - t))) & mask


def _rotl(x: int, t: int, w: int) -> int:
    return _rotr(x, w - (t % w), w)


def _branch_masks(code: CodeSpec) -> tuple[int, int]:
    """q such that branch_bit(i) = flip ^ parity(i & q) for butterfly i."""
    w = code.k - 1
    q1 = (code.poly1 >> 1) & ((1 << (w - 1)) - 1)
    q2 = (code.poly2 >> 1) & ((1 << (w - 1)) - 1)
    return q1, q2


def perm_t(t: int, code: CodeSpec) -> int:
    """Static rotation amount of the layout after t steps."""
    return t % (code.k - 1)


def state_position(s, t: int, code: CodeSpec):
    """P_t(s) = rotr^t(s) for ints or integer tensors."""
    w = code.k - 1
    r = perm_t(t, code)
    if r == 0:
        return s
    mask = (1 << w) - 1
    return ((s >> r) | (s << (w - r))) & mask


def _pos_bit(words: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Decision bit (int64 0/1) for position p: ``words`` (..., n/32)
    int32 gathered at the last axis by p (same leading shape)."""
    row = p >> 7
    word = (row >> 5) * 128 + (p & 127)
    wv = words.gather(-1, word[..., None])[..., 0].to(torch.int64)
    return (wv >> (row & 31)) & 1


def chainback_inplace(
    decisions: torch.Tensor,
    nbits: int,
    endstate: int | torch.Tensor,
    code: CodeSpec = DEFAULT_CODE,
) -> torch.Tensor:
    """Trace back through position-space decision planes.

    decisions: (nbits, B, n/32) int32, plane t in P_{t+1} layout.
    Returns (B, nbits) uint8 bits."""
    B = decisions.shape[1]
    w = code.k - 1
    k = code.k
    dev = decisions.device
    s = (profiling.upload("viterbi/states", endstate, dev, torch.int64)
         & code.state_mask).expand(B).clone()
    out = torch.empty((nbits, B), dtype=torch.uint8, device=dev)
    for t in range(nbits - 1, -1, -1):
        r = (t + 1) % w
        p = ((s >> r) | (s << (w - r))) & ((1 << w) - 1)
        out[t] = (s & 1).to(torch.uint8)
        bit = _pos_bit(decisions[t], p)
        s = (bit << (k - 2)) | (s >> 1)
    return out.T.contiguous()


@dataclasses.dataclass
class StreamState:
    """Streaming decoder state of the rotating-layout ACS: the circular
    decision memory that makes unbounded decoding possible
    (viterbi224_sse2.c:379-380).  ``dp`` and ``total`` are host ints."""

    metrics: torch.Tensor  # (B, 2^W) int16 in layout P_{total mod W}
    decisions: torch.Tensor  # (L, B, n/32) int32 circular tape of planes
    dp: int  # next write slot
    total: int  # absolute trellis steps so far
    renorm: torch.Tensor  # (B,) int32


def stream_create(
    tape_len: int,
    batch: int = 1,
    code: CodeSpec = DEFAULT_CODE,
    start_state: int | torch.Tensor = 0,
    device=None,
) -> StreamState:
    """A fresh stream decoder: the start state's metric 0, the others
    START_BIAS, on ``device`` — the card unless "cpu" is asked for."""
    device = _kernels.run_device(device)
    n = code.nstates
    start = (torch.as_tensor(start_state, dtype=torch.int64, device=device)
             & code.state_mask).expand(batch)
    metrics = torch.full((batch, n), START_BIAS, dtype=torch.int16,
                         device=device)
    metrics[torch.arange(batch, device=device), start] = 0
    return StreamState(
        metrics=metrics,
        decisions=torch.zeros((tape_len, batch, n // 32), dtype=torch.int32,
                              device=device),
        dp=0,
        total=0,
        renorm=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def stream_decodebits(
    state: StreamState,
    delay: int,
    count: int,
    code: CodeSpec = DEFAULT_CODE,
    skip: int = 0,
) -> torch.Tensor:
    """Fixed-delay outputs for ``count`` steps ending ``skip`` steps
    before the newest plane (vdecode mode), as (B, count) uint8.
    Requires tape_len >= skip + count + delay; ``skip`` lets a caller
    ignore erasure-padded steps appended by a cycle-aligned update."""
    w = code.k - 1
    k = code.k
    L, B, nw = state.decisions.shape
    dev = state.decisions.device
    flat = state.decisions.reshape(-1)
    bidx = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    offsets = torch.arange(skip + count - 1, skip - 1, -1, dtype=torch.int64,
                           device=dev)[:, None]
    s = torch.zeros((count, B), dtype=torch.int64, device=dev)
    bit = s
    for d in range(delay):
        # the plane of absolute step T = total-1-offset-d has layout
        # rotation (T+1) mod w
        T = state.total - 1 - offsets - d
        slot = torch.remainder(state.dp - 1 - offsets - d, L)
        r = torch.remainder(T + 1, w)
        p = ((s >> r) | (s << (w - r))) & ((1 << w) - 1)
        row = p >> 7
        word = (row >> 5) * 128 + (p & 127)
        wv = flat[(slot * B + bidx) * nw + word].to(torch.int64)
        bit = (wv >> (row & 31)) & 1
        s = (bit << (k - 2)) | (s >> 1)
    return bit.to(torch.uint8).T.contiguous()
