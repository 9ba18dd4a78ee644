"""The classic Viterbi API for rate-1/2 convolutional codes (K up to 24)
— the port of isee3_decoder_tpu/ops/viterbi.py.

A 2^(K-1)-state add-compare-select over offset-binary soft symbols with
packed survivor decisions and a serial chainback (viterbi224_sse2.c).
Metrics are (B, 2^(K-1)) in standard state order; decisions go into a
circular tape of (tape_len, B, 2^(K-1)/32) int32 words holding the uint32
``decision_t`` bits (bit ``s & 31`` of word ``s >> 5``; every right shift
of a word is followed by ``& 1``).

``update_blk`` runs kernel K10 (ops/viterbi_acs_cuda.py) once per trellis
step on a CUDA state and its plain version on a CPU one, with the
renormalization folded into the next step's branch metric
(viterbi_pallas.update_blk_pallas); the final metrics, renorm and tape
equal the JAX ``update_blk``'s (per-step renormalization) bit for bit.
The chainbacks (``chainback``, the ``decodebit`` family) and
``best_state`` are plain torch on the state's device, as the JAX package
computes them outside any kernel.

``decode_frames`` is the one place that maps the JAX package's backend
names onto the port's two frame decoders (``BACKENDS``).

Differences from the JAX package: ``dp`` is a host int (``update_blk``
advances it by a count known on the host, so no device read is needed);
``update_blk`` writes the decisions into the state's tape in place (the
JAX function donates it); the CPU's plain step is the adjust-folded form of K10
(``acs_step_plain``), which gives the JAX ``_acs_step``'s states.
"""

from __future__ import annotations

import dataclasses

import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import DEFAULT_CODE, CodeSpec
from isee3_decoder_tpu_torch.ops import viterbi_acs_cuda as acs
from isee3_decoder_tpu_torch.ops.viterbi_fused import decode_frame_fused

#: Starting-state bias: unknown states start this much worse than the known
#: start state (viterbi224_sse2.c:44-50 uses SHRT_MIN+5000 vs SHRT_MIN).
START_BIAS = 5000

#: 0/1 branch bits per butterfly (viterbi224_sse2.c:74-77), kept beside
#: the plain step, which reads them
branch_bits = acs.branch_bits


@dataclasses.dataclass
class ViterbiState:
    """Decoder carry state (``struct v224``, viterbi224_sse2.c:26-34)."""

    metrics: torch.Tensor  # (B, 2^(K-1)) int16 or int32 path metrics
    decisions: torch.Tensor  # (tape_len, B, 2^(K-1)/32) int32 circular tape
    dp: int  # next write slot in the tape (host int)
    renorm: torch.Tensor  # (B,) int32 accumulated renormalizations

    @property
    def tape_len(self) -> int:
        return self.decisions.shape[0]


def _states(x, B: int, code: CodeSpec, device) -> torch.Tensor:
    """An int or integer tensor of states → (B,) int64 on ``device``."""
    return (torch.as_tensor(x, device=device).to(torch.int64)
            & code.state_mask).expand(B)


def create(tape_len: int, batch: int = 1, code: CodeSpec = DEFAULT_CODE,
           start_state: int | torch.Tensor = 0, dtype: torch.dtype = torch.int32,
           device=None) -> ViterbiState:
    """Allocate decision tape + metrics (create_viterbi224, sse2.c:56-80)
    on ``device``: the card unless "cpu" is asked for.  dtype: the metric
    type; int16 halves the bytes each step moves, and the per-step
    renormalization keeps the values far from its range."""
    device = _kernels.run_device(device)
    st = ViterbiState(
        metrics=torch.zeros((batch, code.nstates), dtype=dtype, device=device),
        decisions=torch.zeros((tape_len, batch, code.nstates // 32),
                              dtype=torch.int32, device=device),
        dp=0,
        renorm=torch.zeros(batch, dtype=torch.int32, device=device),
    )
    return init(st, start_state, code)


def init(state: ViterbiState, start_state: int | torch.Tensor = 0,
         code: CodeSpec = DEFAULT_CODE) -> ViterbiState:
    """Re-bias metrics for a new frame (init_viterbi224, sse2.c:37-53):
    every state at START_BIAS, the known start state at 0."""
    batch, n = state.metrics.shape
    dev = state.metrics.device
    metrics = torch.full((batch, n), START_BIAS, dtype=state.metrics.dtype,
                         device=dev)
    metrics[torch.arange(batch, device=dev),
            _states(start_state, batch, code, dev)] = 0
    return dataclasses.replace(
        state, metrics=metrics, dp=0,
        renorm=torch.zeros(batch, dtype=torch.int32, device=dev))


def _step_syms(syms, B: int, device) -> torch.Tensor:
    """(B, 2*nbits) or (2*nbits,) symbols → (nbits, B, 2) int32."""
    syms = torch.as_tensor(syms, device=device)
    if syms.ndim == 1:
        syms = syms[None, :]
    nbits = syms.shape[-1] // 2
    s = syms.to(torch.int32).reshape(-1, nbits, 2).expand(B, nbits, 2)
    return s.transpose(0, 1).contiguous()


def update_blk(state: ViterbiState, syms,
               code: CodeSpec = DEFAULT_CODE) -> ViterbiState:
    """Run nbits ACS steps (update_viterbi224_blk, sse2.c:259-389) for
    (B, 2*nbits) or (2*nbits,) offset-binary soft symbols, writing the
    decisions into the circular tape from slot ``state.dp`` on.

    On a CUDA state, one K10 launch per step and no device read: each
    step subtracts the previous step's minimum (held on the card in three
    rotating (B,) buffers), the last one is subtracted after the loop.
    The decisions go into the state's tape in place (the returned state
    shares the tape); the state's metrics and renorm are left as they
    are, on both devices."""
    B = state.metrics.shape[0]
    dev = state.metrics.device
    s = _step_syms(syms, B, dev)
    nbits = s.shape[0]
    L = state.tape_len
    metrics = state.metrics
    _kernels.note_backend("viterbi_path", "classic")
    if not _kernels.use_kernel(metrics):
        _kernels.note_backend("viterbi", "torch")
        adjust = torch.zeros(B, dtype=torch.int32, device=dev)
        renorm = state.renorm
        for t in range(nbits):
            metrics, dec, gmin = acs.acs_step_plain(metrics, s[t], adjust, code)
            state.decisions[(state.dp + t) % L] = dec
            renorm = renorm + adjust
            adjust = gmin
        last = adjust
    else:
        # two buffers of our own, so the caller's metrics stay as they are
        spare = torch.empty_like(metrics)
        other = torch.empty_like(metrics) if nbits > 1 else None
        # mins[t % 3] is step t's adjust; step 0's is 0, its output cell
        # starts at INT32_MAX, and each step resets the third
        mins = torch.full((3, B), acs.INT32_MAX, dtype=torch.int32, device=dev)
        mins[0] = 0
        renorm = state.renorm.clone()
        if nbits:
            acs.check_launch(metrics, s[0], mins[0], code, spare,
                             state.decisions[state.dp], "update_blk")
        stream = _kernels.stream_ptr(dev)
        for t in range(nbits):
            acs.launch(metrics, s[t], mins[t % 3], spare,
                       state.decisions[(state.dp + t) % L], mins[(t + 1) % 3],
                       code, reset=mins[(t + 2) % 3], renorm=renorm,
                       stream=stream)
            metrics, spare = spare, (other if t == 0 else metrics)
        last = mins[nbits % 3]
    metrics = metrics - last[:, None].to(metrics.dtype)
    return ViterbiState(metrics=metrics, decisions=state.decisions,
                        dp=(state.dp + nbits) % L, renorm=renorm + last)


def _tape_bit(flat: torch.Tensor, B: int, nw: int, slot, b, endstate):
    """Decision bit (int64 0/1) of ``endstate`` at tape ``slot`` for batch
    rows ``b`` (sse2.c:141); ``flat`` is the tape flattened, slot, b and
    endstate broadcast together."""
    word = flat[(slot * B + b) * nw + (endstate >> 5)].to(torch.int64)
    return (word >> (endstate & 31)) & 1


def _walk(state: ViterbiState, slots, end: torch.Tensor, delay: int,
          code: CodeSpec, keep: bool):
    """``delay`` traceback steps: step d reads slot ``slots(d)``.  Returns
    the stacked bits (delay, ...) when ``keep``, else the last one."""
    L, B, nw = state.decisions.shape
    flat = state.decisions.reshape(-1)
    b = torch.arange(B, device=end.device)
    bits = []
    bit = torch.zeros_like(end)
    for d in range(delay):
        bit = _tape_bit(flat, B, nw, slots(d), b, end)
        end = (bit << (code.k - 2)) | (end >> 1)
        if keep:
            bits.append(bit)
    return torch.stack(bits) if keep else bit


def chainback(state: ViterbiState, nbits: int, endstate: int | torch.Tensor,
              code: CodeSpec = DEFAULT_CODE) -> torch.Tensor:
    """Trace back nbits decisions from a known end state
    (chainback_viterbi224, sse2.c:113-161); the tape's last written slot
    holds the final step.  Returns (B, nbits) uint8 bits in transmitted
    order."""
    L, B, nw = state.decisions.shape
    dev = state.decisions.device
    flat = state.decisions.reshape(-1)
    b = torch.arange(B, device=dev)
    end = _states(endstate, B, code, dev)
    out = torch.empty((nbits, B), dtype=torch.uint8, device=dev)
    last = (state.dp - 1) % L
    for t in range(nbits):
        # bits fall off the right end of the state newest-first (sse2.c:137)
        out[nbits - 1 - t] = (end & 1).to(torch.uint8)
        bit = _tape_bit(flat, B, nw, (last - t) % L, b, end)
        end = (bit << (code.k - 2)) | (end >> 1)
    return out.T.contiguous()


def decodebit(state: ViterbiState, delay: int,
              endstate: int | torch.Tensor = 0,
              code: CodeSpec = DEFAULT_CODE) -> torch.Tensor:
    """Chain back ``delay`` steps from ``endstate`` and return one decoded
    bit per batch row (decodebit_viterbi224, sse2.c:164-203) — the
    fixed-delay streaming mode of vdecode.c:145-152.  (B,) uint8."""
    B = state.metrics.shape[0]
    L = state.tape_len
    end = _states(endstate, B, code, state.decisions.device)
    bit = _walk(state, lambda d: (state.dp - 1 - d) % L, end, delay, code,
                keep=False)
    return bit.to(torch.uint8)


def _end_times(state: ViterbiState, delay: int, slot0: torch.Tensor,
               code: CodeSpec) -> torch.Tensor:
    """Fixed-delay outputs for many end times at once (the JAX ``vmap``):
    ``slot0`` (count,) is each end time's newest slot; delay gathers over
    (count, B).  Returns (B, count) uint8."""
    L, B, _ = state.decisions.shape
    end = torch.zeros((slot0.shape[0], B), dtype=torch.int64,
                      device=slot0.device)
    slot0 = slot0[:, None]
    bit = _walk(state, lambda d: torch.remainder(slot0 - d, L), end, delay,
                code, keep=False)
    return bit.to(torch.uint8).T.contiguous()


def streaming_decodebits(state: ViterbiState, delay: int,
                         code: CodeSpec = DEFAULT_CODE) -> torch.Tensor:
    """Every fixed-delay streaming output of a fresh full-frame tape
    (tape_len >= nbits): ``decodebit(state_t, delay, 0)`` after each step
    t >= delay, vectorized.  Returns (B, nbits-delay) uint8; output j
    equals input bit b_{j - (K-2)}."""
    ts = torch.arange(delay, state.tape_len, dtype=torch.int64,
                      device=state.decisions.device)
    return _end_times(state, delay, ts, code)


def streaming_decodebits_window(state: ViterbiState, delay: int, count: int,
                                code: CodeSpec = DEFAULT_CODE) -> torch.Tensor:
    """Fixed-delay streaming outputs for the last ``count`` trellis steps
    on a circular tape: output j is decodebit(delay) as issued right after
    the update to end time dp-count+j.  Requires tape_len >= count +
    delay.  Returns (B, count) uint8 (no column for count <= 0)."""
    offsets = torch.arange(max(count, 0) - 1, -1, -1, dtype=torch.int64,
                           device=state.decisions.device)
    return _end_times(state, delay, state.dp - 1 - offsets, code)


def decodeword(state: ViterbiState, delay: int,
               endstate: int | torch.Tensor = 0,
               code: CodeSpec = DEFAULT_CODE) -> torch.Tensor:
    """Chain back ``delay`` steps and return the last 64 decoded bits as
    (B, min(delay, 64)) uint8, oldest first (decodeword_viterbi224,
    sse2.c:206-243)."""
    B = state.metrics.shape[0]
    L = state.tape_len
    end = _states(endstate, B, code, state.decisions.device)
    bits = _walk(state, lambda d: (state.dp - 1 - d) % L, end, delay, code,
                 keep=True)  # (delay, B): bits[d] is d+1 steps back
    return bits.flip(0)[:64].T.to(torch.uint8).contiguous()


def best_state(state: ViterbiState) -> torch.Tensor:
    """First index of the smallest path metric per row, int64 — the 'find
    best path' mode of decodebit/decodeword (sse2.c:173-182)."""
    m = state.metrics
    n = m.shape[1]
    idx = torch.arange(n, dtype=torch.int64, device=m.device)
    return torch.where(m == m.amin(dim=1, keepdim=True), idx, n).amin(dim=1)


def min_metric(state: ViterbiState) -> torch.Tensor:
    """(B,) smallest path metric incl. renorm (min_metric_viterbi224)."""
    return state.metrics.amin(dim=1).to(torch.int32) + state.renorm


def max_metric(state: ViterbiState) -> torch.Tensor:
    """(B,) largest path metric incl. renorm (max_metric_viterbi224)."""
    return state.metrics.amax(dim=1).to(torch.int32) + state.renorm


def decode_frame(syms, nbits: int, start_state: int | torch.Tensor = 0,
                 end_state: int | torch.Tensor = 0,
                 code: CodeSpec = DEFAULT_CODE,
                 dtype: torch.dtype = torch.int32, device=None) -> torch.Tensor:
    """init → update → chainback for (B, 2*nbits) symbols → (B, nbits)
    uint8 bits, on the card unless ``device="cpu"`` (a CUDA tensor runs
    where it lies).  The tape takes nbits·2^(K-1)/8 bytes per frame."""
    syms = _kernels.place(syms, device)
    if syms.ndim == 1:
        syms = syms[None, :]
    st = create(nbits, syms.shape[0], code, start_state, dtype, syms.device)
    st = update_blk(st, syms, code)
    return chainback(st, nbits, end_state, code)


#: the JAX package's Viterbi backend names → the port's frame decoders:
#: "jnp" is the classic API here (K10), "fused" the fused-cycle decoder
#: (K5/K6); "inplace" (the JAX package's XLA in-place step, not ported)
#: runs K5/K6.  All give the same bits.
BACKENDS = {"jnp": "jnp", "fused": "fused", "inplace": "fused"}


def resolve_backend(backend: str) -> str:
    """"jnp" or "fused" for one of the names in ``BACKENDS``."""
    try:
        return BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown Viterbi backend {backend!r}: "
                         "'jnp', 'inplace' or 'fused'") from None


def decode_frames(syms: torch.Tensor, nbits: int,
                  start_state: int | torch.Tensor, end_state: int | torch.Tensor,
                  code: CodeSpec, backend: str) -> torch.Tensor:
    """(B, 2*nbits) soft symbols → (B, nbits) uint8 bits from start_state
    to end_state by the decoder ``backend`` names, on the symbols'
    device: decode_frame (int32 metrics, as the JAX "jnp" backend) or
    decode_frame_fused."""
    if resolve_backend(backend) == "fused":
        return decode_frame_fused(syms, nbits, start_state, end_state, code)
    return decode_frame(syms, nbits, start_state, end_state, code,
                        device=syms.device)
