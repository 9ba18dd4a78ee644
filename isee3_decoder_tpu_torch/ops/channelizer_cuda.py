"""Kernels K7a / K7b: the fused polyphase channelizer, and its plain
PyTorch version.

``channelize_raw_fused`` replaces the TPU kernels ``kern`` (critically
sampled bank) and ``kern2`` (2× oversampled bank) of
isee3_decoder_tpu/ops/channelizer_pallas.py:177 and :213; the CUDA source
is csrc/channelizer.cu.  One packed-int32 capture (I in the low 16 bits
of each word, Q in the high 16 — byte-identical to the interleaved int16
recording) goes in; (nchan, 2·nout) int16 interleaved I,Q per channel
comes out, ready for the receive chain's raw int16 ingestion.

A CUDA tensor goes through the kernel (or the wrapper raises); a CPU
tensor through ``channelize_raw_plain``: unpack → ops/channelizer
.channelize → trunc∘clip → int16.  Kernel and plain agree to 1 LSB on
well under 1 % of the samples (float32 rounding at truncation
boundaries: the kernel's FFT and the library's sum in other orders).
Both emit what the plain bank emits: nout = L − P + 1 frames at
oversample 1; at oversample 2 twice the frames both of its streams have
(2·(L − P), or 2·(L − P + 1) when at least half a frame trails the last
whole one).

The kernel takes channel counts that are powers of two from 32 to 256
(its transform is a radix-2 FFT over a shared-memory tile);
``channelize_raw_fused`` raises ``ValueError`` for any other count, on
either device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.ops import carrier
from isee3_decoder_tpu_torch.ops.channelizer import channelize, default_taps

MIN_NCHAN, MAX_NCHAN = 32, 256
_SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90


def supports(nchan: int) -> bool:
    """True for the channel counts the kernel takes."""
    return (MIN_NCHAN <= nchan <= MAX_NCHAN) and nchan & (nchan - 1) == 0


def _nsamp(nwords: int, nchan: int, P: int, oversample: int) -> int:
    """Output samples per channel of the plain bank for an nwords capture:
    the even stream has nwords // M − P + 1 frames, the odd stream (from
    word M/2 on) (nwords − M/2) // M − P + 1; the oversampled bank
    interleaves as many of each as both have."""
    even = nwords // nchan - P + 1
    if oversample == 1:
        return even
    odd = (nwords - nchan // 2) // nchan - P + 1
    return 2 * min(even, odd)


def _check(wide_packed: torch.Tensor, nchan: int, P: int, oversample: int) -> int:
    """Validate what both versions take; returns the output sample count."""
    if not supports(nchan):
        raise ValueError(
            f"fused channelizer needs nchan a power of two in "
            f"{MIN_NCHAN}..{MAX_NCHAN}, got {nchan}")
    if oversample not in (1, 2):
        raise ValueError("oversample must be 1 or 2")
    if wide_packed.dtype != torch.int32 or wide_packed.ndim != 1:
        raise ValueError(f"wide_packed must be (nchan*L,) int32, got "
                         f"{wide_packed.dtype} {tuple(wide_packed.shape)}")
    if P < 1:
        raise ValueError(f"taps_per_branch = {P} must be positive")
    nsamp = _nsamp(wide_packed.shape[0], nchan, P, oversample)
    if nsamp < 1:
        raise ValueError(f"capture too short: {wide_packed.shape[0] // nchan} "
                         f"frames < {P + oversample}")
    return nsamp


def _taps(nchan: int, P: int, oversample: int, taps, device) -> torch.Tensor:
    h = default_taps(nchan, P, oversample) if taps is None else taps
    h = torch.as_tensor(h, dtype=torch.float32, device=device).reshape(-1)
    if h.shape[0] != nchan * P:
        raise ValueError(f"taps must have nchan*taps_per_branch = {nchan * P} "
                         f"values, got {h.shape[0]}")
    return h.contiguous()


def unpack_wide(wide_packed: torch.Tensor) -> torch.Tensor:
    """(N,) packed int32 → (N,) complex64: I the sign-extended low half,
    Q the high half."""
    return carrier.iq_from_interleaved(wide_packed.contiguous().view(torch.int16))


def quantize_raw(chans: torch.Tensor) -> torch.Tensor:
    """(M, nout) complex → (M, 2·nout) int16 interleaved I,Q: saturate at
    ±32767, then truncate toward zero (torch's .to(int16) would wrap)."""
    ri = torch.stack([chans.real, chans.imag], dim=-1).reshape(chans.shape[0], -1)
    return torch.trunc(torch.clamp(ri, -32767.0, 32767.0)).to(torch.int16)


def channelize_raw_plain(
    wide_packed: torch.Tensor,
    nchan: int,
    taps_per_branch: int = 8,
    taps=None,
    oversample: int = 1,
) -> torch.Tensor:
    """Plain version of K7a / K7b: one packed-int32 capture →
    (nchan, 2·nout) int16 through the plain bank."""
    chans = channelize(unpack_wide(wide_packed), nchan, taps_per_branch, taps,
                       oversample)[0]
    return quantize_raw(chans)


@functools.lru_cache(maxsize=8)
def _twiddles(nchan: int, device: torch.device) -> torch.Tensor:
    """cos(2πt/M) for t < M/2, then −sin(2πt/M): made in float64, rounded
    to float32 once."""
    ang = 2.0 * np.pi * np.arange(nchan // 2, dtype=np.float64) / nchan
    tab = np.concatenate([np.cos(ang), -np.sin(ang)]).astype(np.float32)
    return torch.as_tensor(tab, device=device)


def _tile(nchan: int) -> int:
    """Output samples per thread block."""
    return 64 if nchan <= 128 else 32


def _smem_bytes(nchan: int, P: int, oversample: int, tile: int) -> int:
    """Dynamic shared memory of one block (the layout of csrc/channelizer.cu):
    two (M, tile+1) float planes, M twiddles, P·M taps, the capture tile."""
    floats = 2 * nchan * (tile + 1) + nchan + P * nchan
    words = (tile - 1) * (nchan // oversample) + P * nchan
    return 4 * (floats + words)


def channelize_raw_fused(
    wide_packed: torch.Tensor,
    nchan: int,
    taps_per_branch: int = 8,
    taps=None,
    oversample: int = 1,
) -> torch.Tensor:
    """K7a (oversample 1) / K7b (oversample 2): one packed-int32 wideband
    capture → (nchan, 2·nout) int16 raw.

    Args:
      wide_packed: (nchan*L,) int32 packed IQ samples at rate
        nchan·samprate (I = low 16 bits, Q = high 16, sign-extended).
      nchan: channel count M, a power of two in 32..256.
      taps: optional prototype filter, len M·taps_per_branch (default the
        Kaiser sinc of ops/channelizer.prototype_lowpass with the plain
        bank's cutoff per oversample mode).
      oversample: 1 = critically sampled; 2 = the 2× oversampled bank
        (hop M/2; the odd output samples' odd bins sign-flipped), in which
        a carrier at a channel edge stays unaliased and decodable.

    Returns (nchan, 2·nout) int16 interleaved I,Q per channel at rate
    oversample·fs_in/M: nout = L − P + 1 at oversample 1, the plain
    bank's 2·min(even, odd frames) at 2.
    """
    P = taps_per_branch
    nsamp = _check(wide_packed, nchan, P, oversample)
    if not _kernels.use_kernel(wide_packed):
        _kernels.note_backend("channelizer", "torch")
        return channelize_raw_plain(wide_packed, nchan, P, taps, oversample)
    if not wide_packed.is_contiguous():
        raise ValueError("wide_packed must be contiguous")
    tile = _tile(nchan)
    smem = _smem_bytes(nchan, P, oversample, tile)
    if smem > _SMEM_MAX:
        raise ValueError(f"taps_per_branch = {P} at nchan = {nchan} needs "
                         f"{smem} bytes of shared memory (max {_SMEM_MAX})")
    dev = wide_packed.device
    h = _taps(nchan, P, oversample, taps, dev)
    out = torch.empty((nchan, 2 * nsamp), dtype=torch.int16, device=dev)
    name = "channelize" if oversample == 1 else "channelize2"
    err = _kernels.lib().channelize_launch(
        wide_packed.data_ptr(), wide_packed.shape[0], h.data_ptr(),
        _twiddles(nchan, dev).data_ptr(), nchan, P, tile, oversample, nsamp,
        out.data_ptr(), smem, _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "channelize_launch")
    _kernels.count_launch(name)
    _kernels.note_backend("channelizer", "cuda")
    return out
