"""On-device telemetry signal synthesis.

Only the frame bytes (a few KB) go to the device; encode → Manchester →
PM → noise runs there, from a ``torch.Generator`` on that device.  The
waveform follows the JAX package's ``synthesize_iq_device`` step for
step (float32 phase, 0.7 rad start phase); the noise samples differ,
since the two generators differ.
"""

from __future__ import annotations

import numpy as np
import torch

from isee3_decoder_tpu_torch.config import (
    DEFAULT_CODE,
    FRAMEBITS,
    SYNC_STATE,
    SYNCWORD,
    CodeSpec,
)
from isee3_decoder_tpu_torch.ops.encode import bytes_to_bits, encode_bits


def random_frames(rng: np.random.Generator, nframes: int) -> np.ndarray:
    """(nframes, 128) frame bytes, each ending in the 5 syncword bytes
    (the invariant tail every real minor frame carries)."""
    frames = rng.integers(0, 256, (nframes, FRAMEBITS // 8), dtype=np.uint8)
    frames[:, -5:] = list(SYNCWORD.to_bytes(5, "big"))
    return frames


def synthesize_iq_device(
    frames: torch.Tensor,
    carrier_hz: torch.Tensor,
    generator: torch.Generator | None,
    nsamples: int,
    samprate: float = 250_000.0,
    symrate: float = 1024.0,
    mod_index: float = 1.1,
    amplitude: float = 12_000.0,
    noise_std: float = 0.0,
    code: CodeSpec = DEFAULT_CODE,
) -> torch.Tensor:
    """(B, nframes, 128) uint8 frame bytes → (B, nsamples) complex64 IQ on
    the frames' device.  carrier_hz: (B,) per-channel carriers.  The
    symbol stream repeats cyclically to fill nsamples."""
    B = frames.shape[0]
    dev = frames.device
    bits = bytes_to_bits(frames.reshape(B, -1))
    syms, _ = encode_bits(bits, SYNC_STATE, code)  # (B, 2*nbits)
    nsym = syms.shape[-1]

    t = torch.arange(nsamples, dtype=torch.float32, device=dev)
    pos = t / np.float32(samprate / symrate)
    sym_idx = torch.floor(pos).to(torch.int64) % nsym
    second_half = (pos - torch.floor(pos)) >= 0.5
    level = torch.where(syms[:, sym_idx] > 0, 1.0, -1.0)
    d = torch.where(second_half[None, :], level, -level)
    ph = (2 * np.pi * carrier_hz.to(torch.float32)[:, None] * t[None, :]
          / samprate + mod_index * d + 0.7)
    iq = amplitude * torch.polar(torch.ones_like(ph), ph)
    if noise_std > 0:
        nr = torch.randn(iq.shape, generator=generator, device=dev)
        ni = torch.randn(iq.shape, generator=generator, device=dev)
        iq = iq + noise_std * torch.complex(nr, ni)
    return iq.to(torch.complex64)


def to_raw_int16(iq: torch.Tensor) -> torch.Tensor:
    """(B, L) complex → (B, 2L) int16 interleaved I,Q — the reference's
    recording format (pmdemod.c:206-230), truncated and clipped as the
    JAX package's benchmark quantizes its synthetic IQ."""
    ri = torch.stack([iq.real, iq.imag], dim=-1).reshape(iq.shape[0], -1)
    return torch.trunc(torch.clamp(ri, -32767.0, 32767.0)).to(torch.int16)
