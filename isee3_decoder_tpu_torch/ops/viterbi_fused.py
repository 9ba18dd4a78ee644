"""Frame and stream decoding with the fused-cycle ACS kernels K5/K6
(isee3_decoder_tpu/ops/viterbi_pallas_fused.py:439-771).

A frame's nbits trellis steps run as whole W-step cycles — K5 for steps
0..ROWB-1, K6 for the rest — plus a remainder.  Renormalization is
deferred and fused: K6 emits per-row minima, and the next cycle's K5
subtracts their minimum (``base``) as it reads the metrics, so no extra
pass over the metrics is made (viterbi224_sse2.c:351-377's lazy renorm).

Decision tape layout of the port: ONE (B, nbits, n/32) int32 tensor,
plane t at ``dec[:, t]`` (layout P_{t+1}), which the kernels fill in
place.  The JAX package keeps a scan-native (ncycles, B, W, n/32) +
(B, rem, n/32) pair instead, because ``lax.scan`` stacks per cycle;
the bits of every plane are the same.  The streaming path hands the
kernels a (B, nbits, n/32) view of its (L, B, n/32) circular tape.
"""

from __future__ import annotations

import os

import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import DEFAULT_CODE, CodeSpec
from isee3_decoder_tpu_torch.ops.viterbi_cuda import _geometry, cycle_a, cycle_b
from isee3_decoder_tpu_torch.ops.viterbi_inplace import (
    START_BIAS,
    StreamState,
    chainback_inplace,
)
from isee3_decoder_tpu_torch.utils import profiling

#: share of the device's free memory a decision tape may take by default
#: (the rest covers the metrics and whatever the caller holds resident)
_FREE_SHARE = 0.75
#: default decision-memory budget off the card (the CPU tests' own shapes
#: are a few MiB)
_CPU_BUDGET = 4 * 1024**3


def decision_budget(device) -> int:
    """Bytes the decision tape(s) of one update may take on ``device``:
    ``ISEE3_FUSED_DEC_BYTES`` if set, else 3/4 of the device memory this
    process can still use on a CUDA device (``torch.cuda.mem_get_info``'s
    free bytes plus what PyTorch's allocator holds unused, such as the
    previous batch's tape), else 4 GiB."""
    env = os.environ.get("ISEE3_FUSED_DEC_BYTES")
    if env:
        return int(env)
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return int((free + cached) * _FREE_SHARE)
    return _CPU_BUDGET


def frame_tape_bytes(nbits: int, code: CodeSpec) -> int:
    """Decision bytes of one frame: one bit per state per step (1 GiB for
    a 1024-bit frame at K = 24)."""
    return nbits * (code.nstates // 8)


def _check_decision_budget(B: int, nbits: int, code: CodeSpec, device) -> None:
    """Raise, before anything is allocated, when the decision tape of B
    frames exceeds decision_budget(device).  Every update holds one tape
    (the flat layout too, since the port writes it in place; the JAX
    package's relayout needed two).  Callers with more frames chunk the
    batch (models/decode does)."""
    budget = decision_budget(device)
    per = frame_tape_bytes(nbits, code)
    if B * per > budget:
        raise ValueError(
            f"fused Viterbi decision memory ~{B * per / 1e9:.1f} GB "
            f"(B={B}, nbits={nbits}, {code.nstates} states) exceeds the "
            f"{budget / 1e9:.1f} GB budget — chunk the batch (e.g. "
            f"B<={max(budget // per, 1)}) or set ISEE3_FUSED_DEC_BYTES"
        )


def _syms_i32(syms: torch.Tensor, B: int, nbits: int) -> torch.Tensor:
    if syms.ndim == 1:
        syms = syms[None, :]
    return syms.to(torch.int32).reshape(-1, 2 * nbits).expand(B, 2 * nbits)


def _update_frame_planes(metrics: torch.Tensor, syms: torch.Tensor,
                         nbits: int, code: CodeSpec,
                         dec: torch.Tensor) -> torch.Tensor:
    """nbits ACS steps from P_0 layout on ``metrics`` (B, n) int16, in
    place; plane t goes to dec[:, t].  Returns the (B,) int32 total of
    the renormalizations subtracted."""
    B, n = metrics.shape
    w, rowb, _ = _geometry(code)
    _kernels.note_backend("viterbi_path", "fused")
    flat = _syms_i32(syms, B, nbits)
    dev = metrics.device
    ncycles, rem = divmod(nbits, w)
    total = torch.zeros(B, dtype=torch.int32, device=dev)
    base = torch.zeros(B, dtype=torch.int32, device=dev)
    for c in range(ncycles):
        t0 = c * w
        sc = flat[:, 2 * t0 : 2 * (t0 + w)]
        cycle_a(metrics, sc[:, : 2 * rowb].contiguous(), code, rowb, base,
                dec[:, t0 : t0 + rowb])
        total += base
        _, _, mins = cycle_b(metrics, sc[:, 2 * rowb :].contiguous(), code,
                             w - rowb, dec[:, t0 + rowb : t0 + w])
        base = mins.amin(dim=1)
    if rem:
        t0 = ncycles * w
        na = min(rem, rowb)
        cycle_a(metrics, flat[:, 2 * t0 : 2 * (t0 + na)].contiguous(), code,
                na, base, dec[:, t0 : t0 + na])
        total += base
        if rem > rowb:
            cycle_b(metrics, flat[:, 2 * (t0 + rowb) : 2 * nbits].contiguous(),
                    code, rem - rowb, dec[:, t0 + rowb : nbits])
        base = metrics.amin(dim=1).to(torch.int32)
    # the last pending base: returned metrics are renormalized
    metrics.copy_((metrics.to(torch.int32) - base[:, None]).to(torch.int16))
    return total + base


def update_frame_fused_planes(metrics0: torch.Tensor, syms: torch.Tensor,
                              nbits: int, code: CodeSpec = DEFAULT_CODE):
    """nbits ACS steps with K5/K6.  ``metrics0`` (B, n) int16 in P_0
    layout is updated IN PLACE.  Returns (metrics in P_nbits layout,
    decisions (B, nbits, n/32) int32, renorm total (B,) int32)."""
    B, n = metrics0.shape
    _check_decision_budget(B, nbits, code, metrics0.device)
    dec = torch.empty((B, nbits, n // 32), dtype=torch.int32,
                      device=metrics0.device)
    total = _update_frame_planes(metrics0, syms, nbits, code, dec)
    return metrics0, dec, total


def update_frame_fused(metrics0: torch.Tensor, syms: torch.Tensor, nbits: int,
                       code: CodeSpec = DEFAULT_CODE, out: torch.Tensor | None = None):
    """update_frame_fused_planes with the flat (nbits, B, n/32) decision
    layout of the JAX package's ``update_frame_fused`` (what the stream
    tape holds).  ``out``, when given, is that (nbits, B, n/32) int32
    view and is filled in place — the kernels write straight into it."""
    B, n = metrics0.shape
    if out is None:
        _check_decision_budget(B, nbits, code, metrics0.device)
        out = torch.empty((nbits, B, n // 32), dtype=torch.int32,
                          device=metrics0.device)
    total = _update_frame_planes(metrics0, syms, nbits, code,
                                 out.transpose(0, 1))
    return metrics0, out, total


def chainback_planes(dec: torch.Tensor, nbits: int,
                     endstate: int | torch.Tensor,
                     code: CodeSpec = DEFAULT_CODE) -> torch.Tensor:
    """Traceback over a (B, nbits, n/32) tape (plane t in P_{t+1}
    layout) → (B, nbits) uint8 bits.  Plain torch, as in the JAX package
    (XLA there): one (B,)-sized gather per step."""
    if dec.shape[1] != nbits:
        raise ValueError(f"tape holds {dec.shape[1]} planes, not {nbits}")
    with profiling.span("host_tail/traceback"):
        return chainback_inplace(dec.transpose(0, 1), nbits, endstate, code)


def stream_update_fused(state: StreamState, syms: torch.Tensor,
                        code: CodeSpec = DEFAULT_CODE) -> StreamState:
    """Advance a streaming decoder with K5/K6 (vdecode-style unbounded
    streams, vdecode.c:142-152).  The chunk must be a multiple of W (the
    layout returns to P_0 after whole cycles) and must not straddle the
    tape's wrap (``dp + chunk <= tape_len``); callers pad a final
    partial chunk with erasures (128) and pass ``skip`` to
    stream_decodebits.  The state's metrics and tape are updated in
    place."""
    w = code.k - 1
    if syms.ndim == 1:
        syms = syms[None, :]
    nbits = syms.shape[-1] // 2
    L = state.decisions.shape[0]
    if nbits % w:
        raise ValueError(f"chunk ({nbits} bits) must be a multiple of W={w}")
    if state.dp + nbits > L:
        raise ValueError(f"chunk of {nbits} at slot {state.dp} straddles the "
                         f"tape's wrap (tape_len {L})")
    _, _, ren = update_frame_fused(state.metrics, syms, nbits, code,
                                   out=state.decisions[state.dp : state.dp + nbits])
    return StreamState(
        metrics=state.metrics,
        decisions=state.decisions,
        dp=(state.dp + nbits) % L,
        total=state.total + nbits,
        renorm=state.renorm + ren,
    )


def decode_frame_fused(syms: torch.Tensor, nbits: int,
                       start_state: int | torch.Tensor = 0,
                       end_state: int | torch.Tensor = 0,
                       code: CodeSpec = DEFAULT_CODE) -> torch.Tensor:
    """Full frame decode with K5/K6: (B, 2*nbits) soft symbols →
    (B, nbits) uint8 bits, on the symbols' device."""
    if syms.ndim == 1:
        syms = syms[None, :]
    B = syms.shape[0]
    dev = syms.device
    n = code.nstates
    _check_decision_budget(B, nbits, code, dev)
    start = (profiling.upload("viterbi/states", start_state, dev, torch.int64)
             & code.state_mask).expand(B)
    metrics = torch.full((B, n), START_BIAS, dtype=torch.int16, device=dev)
    metrics[torch.arange(B, device=dev), start] = profiling.upload(
        "viterbi/states", 0, dev, torch.int16)
    dec = torch.empty((B, nbits, n // 32), dtype=torch.int32, device=dev)
    _update_frame_planes(metrics, syms, nbits, code, dec)
    return chainback_planes(dec, nbits, end_state, code)
