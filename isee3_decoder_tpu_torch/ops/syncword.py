"""Frame sync: soft syncword correlation and frame verification
(decode.c:162-193 sync search, decode.c:237-247 end-of-frame check)."""

from __future__ import annotations

import numpy as np
import torch

from isee3_decoder_tpu_torch.config import (
    DEFAULT_CODE,
    SYNCBITS,
    SYNCWORD,
    CodeSpec,
    sync_vector,
)


def sync_taps(code: CodeSpec = DEFAULT_CODE) -> np.ndarray:
    """±1 correlation taps from the encoded sync vector (decode.c:170-176:
    add the symbol when sync_vector[k] is 1, subtract when 0)."""
    sv = np.asarray(sync_vector(code), np.int32)
    return 2 * sv - 1


def sync_correlate(
    symbols: torch.Tensor, npos: int, code: CodeSpec = DEFAULT_CODE
) -> torch.Tensor:
    """(B, >= npos+SYNCBITS-1) uint8 soft symbols → (B, npos) int32 soft
    sync correlation sum_k ±(sym[i+k] - 128) at positions 0..npos-1."""
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    if symbols.shape[-1] < npos + SYNCBITS - 1:
        raise ValueError(
            f"sync_correlate needs symbols length >= npos + SYNCBITS - 1"
            f" = {npos + SYNCBITS - 1}, got {symbols.shape[-1]}"
        )
    taps = sync_taps(code)
    s = symbols.to(torch.int32) - 128
    acc = torch.zeros(
        (s.shape[0], npos), dtype=torch.int32, device=symbols.device
    )
    for k in range(SYNCBITS):
        sl = s[:, k : k + npos]
        acc = acc + sl if taps[k] > 0 else acc - sl
    return acc


def argmax_first(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first maximum along dim (the reference's strict '>'
    update loop), as an explicit max + iota reduction."""
    m = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.int64, device=x.device).reshape(shape)
    return torch.where(x == m, idx, n).amin(dim=dim)


def argmax_last(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the last maximum along dim (the reference's '>=' loop)."""
    m = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.int64, device=x.device).reshape(shape)
    return torch.where(x == m, idx, -1).amax(dim=dim)


def find_sync(
    symbols: torch.Tensor, npos: int, code: CodeSpec = DEFAULT_CODE
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best sync position per channel (decode.c:165-181), keeping the
    earliest maximal position.  Returns (sync_start int64, record_sum)."""
    corr = sync_correlate(symbols, npos, code)
    best = argmax_first(corr, dim=-1)
    return best, corr.gather(1, best[:, None])[:, 0]


def verify_frame(frame_bits: torch.Tensor) -> torch.Tensor:
    """True when the (B, FRAMEBITS) decoded bits end in the 5-byte
    syncword (decode.c:237-247)."""
    last40 = frame_bits[..., -40:].to(torch.int64)
    weights = 1 << torch.arange(39, -1, -1, dtype=torch.int64,
                                device=frame_bits.device)
    return (last40 * weights).sum(dim=-1) == SYNCWORD


def framer_positions(bits: torch.Tensor) -> torch.Tensor:
    """Hard framer: (B, N) 0/1 bits → (B, N) bool, True at the LAST bit of
    every 40-bit syncword match (framer.c:61-95's shift register,
    vectorized)."""
    if bits.ndim == 1:
        bits = bits[None, :]
    B, N = bits.shape
    x = bits.to(torch.int32)
    eq = torch.ones((B, N), dtype=torch.bool, device=bits.device)
    for k in range(40):
        # bits[p-39+k] against syncword bit k (MSB first), wrapping as the
        # JAX package's roll does; positions < 39 are masked below
        eq &= torch.roll(x, 39 - k, dims=-1) == ((SYNCWORD >> (39 - k)) & 1)
    return eq & (torch.arange(N, device=bits.device) >= 39)


def phase_sync_peaks(symbols: torch.Tensor, code: CodeSpec = DEFAULT_CODE
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Even/odd-phase sync peaks over a frame of soft symbols — the
    symbol-pair phasing detector of vdecode.c:110-141.  symbols: (B,
    FRAMESYMBOLS + SYNCBITS) uint8.  Returns (peak_even, peak_odd), the
    largest correlation whose window ENDS on an even / odd symbol."""
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    npos = symbols.shape[-1] - SYNCBITS
    corr = sync_correlate(symbols, npos, code)
    end_parity = (torch.arange(npos, device=symbols.device) + SYNCBITS - 1) % 2
    neg = torch.tensor(-1_000_000, dtype=torch.int32, device=symbols.device)
    even = torch.where(end_parity == 0, corr, neg).amax(dim=-1)
    odd = torch.where(end_parity == 1, corr, neg).amax(dim=-1)
    return even, odd
