"""Synthetic telemetry signals on the host, in numpy: the transmit chain
frame bytes → convolutional symbols → Manchester waveform →
residual-carrier PM → int16 IQ, and the reference's test sinusoid
(gensine.c; the Manchester expansion of icesync.c:55-141).

The port of the JAX package's utils/testsignal.py on the port's own
encoder: given the same ``np.random.Generator``, every function returns
the JAX package's arrays bit for bit.  utils/devicesignal.py makes the
same waveform on the card from a ``torch.Generator``.
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


def gensine(
    nsamples: int,
    carrier: float = 2000.0,
    samprate: float = 32768.0,
    amplitude: float = 20000.0,
    start_phase: float = 0.0,
) -> np.ndarray:
    """Complex sinusoid as interleaved int16 I,Q (gensine.c:30-55)."""
    t = np.arange(nsamples)
    v = amplitude * np.exp(1j * (2 * np.pi * carrier * t / samprate + start_phase))
    out = np.empty((nsamples, 2), np.int16)
    out[:, 0] = v.real.astype(np.int16)
    out[:, 1] = v.imag.astype(np.int16)
    return out.reshape(-1)


def random_frames(rng: np.random.Generator, nframes: int) -> np.ndarray:
    """(nframes, 128) frame bytes, each ending in the 5 syncword bytes
    (the invariant tail every real minor frame carries)."""
    frames = rng.integers(0, 256, (nframes, FRAMEBITS // 8), dtype=np.uint8)
    frames[:, -5:] = list(SYNCWORD.to_bytes(5, "big"))
    return frames


def frames_to_symbols(frames: np.ndarray, code: CodeSpec = DEFAULT_CODE) -> np.ndarray:
    """Encode a contiguous stream of frames from the sync state (as if a
    previous frame's syncword had just been sent, decode.c:220)."""
    bits = bytes_to_bits(torch.as_tensor(np.asarray(frames).reshape(-1)))
    syms, _ = encode_bits(bits, SYNC_STATE, code)
    return syms.numpy()


def manchester_waveform(
    symbols: np.ndarray,
    symbolsamples: float,
    nsamples: int | None = None,
    symbolclocks: int = 1,
) -> np.ndarray:
    """±1 Manchester waveform (icesync.c:90-98 convention: symbol 1 is
    -1 then +1, so the integrate-and-dump (−first+second) is positive)."""
    nsym = len(symbols)
    if nsamples is None:
        nsamples = int(np.ceil(nsym * symbolsamples))
    t = np.arange(nsamples)
    pos = t / symbolsamples
    sym_idx = np.minimum(pos.astype(np.int64), nsym - 1)
    frac = pos - sym_idx
    # second half of each subcarrier clock cycle is the +1 half
    clock_frac = (frac * symbolclocks) % 1.0
    second_half = clock_frac >= 0.5
    level = np.where(symbols[sym_idx] > 0, 1.0, -1.0)
    return np.where(second_half, level, -level)


def synthesize_iq(
    frames: np.ndarray,
    samprate: float = 250_000.0,
    symrate: float = 1024.0,
    carrier: float = 20_000.0,
    mod_index: float = 1.1,
    amplitude: float = 12_000.0,
    noise_std: float = 0.0,
    phase0: float = 0.7,
    symbolclocks: int = 1,
    lead_symbols: int = 0,
    rng: np.random.Generator | None = None,
    code: CodeSpec = DEFAULT_CODE,
) -> np.ndarray:
    """Full transmit chain → complex IQ for one channel.

    lead_symbols: random filler symbols ahead of the frames, so frame
    sync does not sit exactly at the stream's start.
    """
    syms = frames_to_symbols(frames, code)
    if lead_symbols:
        # random filler: a periodic pattern (e.g. 0101...) would put a
        # discrete PM sideband tone above the residual carrier and
        # capture the carrier search (true of the reference chain too)
        lead_rng = rng if rng is not None else np.random.default_rng(1234)
        lead = lead_rng.integers(0, 2, lead_symbols).astype(np.uint8)
        syms = np.concatenate([lead, syms])
    symbolsamples = samprate / symrate
    d = manchester_waveform(syms, symbolsamples, symbolclocks=symbolclocks)
    n = len(d)
    t = np.arange(n)
    ph = 2 * np.pi * carrier * t / samprate + mod_index * d + phase0
    iq = amplitude * np.exp(1j * ph)
    if noise_std > 0:
        if rng is None:
            rng = np.random.default_rng(0)
        iq = iq + rng.normal(0, noise_std, n) + 1j * rng.normal(0, noise_std, n)
    return iq


def iq_to_int16(iq: np.ndarray) -> np.ndarray:
    """Interleave complex IQ into the int16 I,Q wire format
    (pmdemod.c:26-30)."""
    out = np.empty((len(iq), 2), np.int16)
    out[:, 0] = np.clip(iq.real, -32768, 32767).astype(np.int16)
    out[:, 1] = np.clip(iq.imag, -32768, 32767).astype(np.int16)
    return out.reshape(-1)
