"""On-device telemetry signal synthesis.

Only the frame bytes (a few KB) go to the device; encode → Manchester →
PM → noise runs there, from a ``torch.Generator`` on that device.  The
waveform follows the JAX package's ``synthesize_iq_device`` step for
step (float32 phase, 0.7 rad start phase); the noise samples differ,
since the two generators differ.  ``synthesize_wideband_device`` splices
the per-channel spectra into one wide capture; ``to_packed_wide`` packs
it as the int32 words the fused channelizer reads.
"""

from __future__ import annotations

import numpy as np
import torch

from isee3_decoder_tpu_torch.config import (
    DEFAULT_CODE,
    SYNC_STATE,
    CodeSpec,
)
from isee3_decoder_tpu_torch.ops.encode import bytes_to_bits, encode_bits
from isee3_decoder_tpu_torch.utils.testsignal import random_frames  # noqa: F401


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


def synthesize_wideband_device(
    frames: torch.Tensor,
    carrier_hz: torch.Tensor,
    generator: torch.Generator | None,
    nsamples: int,
    nchan: int,
    samprate: float = 250_000.0,
    symrate: float = 1024.0,
    mod_index: float = 1.1,
    amplitude: float = 12_000.0,
    noise_std: float = 0.0,
    code: CodeSpec = DEFAULT_CODE,
) -> torch.Tensor:
    """(nchan, nframes, 128) frame bytes → ONE wideband capture carrying
    one telemetry downlink per polyphase channel slot.

    Each channel's PM signal is synthesized at the channel rate
    (``synthesize_iq_device``); the wide capture is assembled in the
    frequency domain: channel k's length-L spectrum occupies wide bins
    kL+b (b < L/2) and (k-1)L+b (b >= L/2) — an exact, perfectly
    bandlimited upsample-and-shift, so channel k of a critically sampled
    polyphase channelizer recovers x_k to within prototype-filter error.

    Args:
      frames: (nchan, nframes, 128) uint8 frame bytes per channel.
      carrier_hz: (nchan,) carrier offset within each channel slot
        (relative to the slot centre k*samprate).
      nsamples: per-channel sample count L; the capture has nchan*L
        complex samples at rate nchan*samprate.

    The wide capture sums nchan unit-modulus carriers, so its peaks reach
    about amplitude*nchan at worst.  For a capture that will be quantized
    to int16, pick ``amplitude <~ 30000 / nchan`` and scale the noise with
    it (per-channel C/N0 is set by amplitude/noise_std).

    Returns (nchan*nsamples,) complex64 wideband samples."""
    M, L = nchan, nsamples
    x = synthesize_iq_device(
        frames, carrier_hz, generator, L, samprate=samprate, symrate=symrate,
        mod_index=mod_index, amplitude=amplitude, noise_std=noise_std,
        code=code,
    )  # (M, L)
    X = torch.fft.fft(x, dim=-1)
    del x
    wide_spec = torch.cat(
        [X[:, : L // 2], torch.roll(X, -1, dims=0)[:, L // 2 :]], dim=1
    ).reshape(M * L)
    del X
    # length-ML inverse of length-L bins: amplitude needs the M factor
    return (torch.fft.ifft(wide_spec) * M).to(torch.complex64)


def to_packed_wide(wide: torch.Tensor) -> torch.Tensor:
    """(N,) complex → (N,) int32 packed IQ: I in the low half of each word,
    Q in the high half, each saturated at ±32767 and truncated toward zero
    — byte-identical to the interleaved int16 recording."""
    i = torch.trunc(torch.clamp(wide.real, -32767.0, 32767.0)).to(torch.int32)
    q = torch.trunc(torch.clamp(wide.imag, -32767.0, 32767.0)).to(torch.int32)
    return (i & 0xFFFF) | (q << 16)
