"""Polyphase FFT channelizer: one wideband stream → many channels.

The reference processes one downlink per run; the many-channel scenario
starts from one wide receiver capture, split into per-channel basebands
by a polyphase filterbank: P tap-weighted shifted frame sums, then a DFT
across the M branches.

Channel k (k = 0..M-1) is centred at k·fs_in/M (negative frequencies
alias as usual), with output rate oversample·fs_in/M.  This is the plain
PyTorch bank; it is also the plain version of the fused CUDA front end
(ops/channelizer_cuda.py), which computes the same function from the
packed int32 capture straight to per-channel int16.
"""

from __future__ import annotations

import numpy as np
import torch


def prototype_lowpass(
    nchan: int,
    taps_per_branch: int = 8,
    beta: float = 9.0,
    cutoff_scale: float = 1.0,
) -> np.ndarray:
    """Kaiser-windowed sinc prototype for a polyphase filterbank.

    Cutoff at ``cutoff_scale`` × half the channel spacing; length
    nchan * taps_per_branch.  The critically sampled bank needs
    cutoff_scale=1.0 (anything past half-spacing aliases); the 2×
    oversampled bank uses 1.2, so the passband covers the channel edge
    while the stopband is reached by the doubled output Nyquist."""
    n = nchan * taps_per_branch
    t = np.arange(n) - (n - 1) / 2
    h = np.sinc(cutoff_scale * t / nchan) * np.kaiser(n, beta)
    return (h / h.sum()).astype(np.float32)


def default_taps(nchan: int, taps_per_branch: int, oversample: int) -> np.ndarray:
    """The prototype each oversample mode uses when the caller gives none."""
    return prototype_lowpass(nchan, taps_per_branch,
                             cutoff_scale=1.2 if oversample == 2 else 1.0)


def _pfb_frames(x: torch.Tensor, hb: torch.Tensor, nchan: int) -> torch.Tensor:
    """(B, L) → (B, nout, M) tap-weighted frame sums at hop M:
    y[m] = sum_p x[m+p] * hb[p] per branch, as P shifted slices (a
    gather of (B, nout, P, M) would copy the capture P-fold)."""
    B, L = x.shape
    P = hb.shape[0]
    nframes = L // nchan
    xf = x[:, : nframes * nchan].reshape(B, nframes, nchan)
    nout = nframes - P + 1
    filtered = torch.zeros((B, nout, nchan), dtype=x.dtype, device=x.device)
    for p in range(P):
        filtered = filtered + xf[:, p : p + nout, :] * hb[p][None, None, :]
    return filtered


def channelize(
    x: torch.Tensor,
    nchan: int,
    taps_per_branch: int = 8,
    taps=None,
    oversample: int = 1,
) -> torch.Tensor:
    """Split a complex wideband stream into nchan complex basebands.

    Args:
      x: (L,) or (B, L) complex64 wideband samples at rate fs_in.
      nchan: number of channels M (output rate oversample·fs_in / M).
      taps: optional prototype filter (len M*taps_per_branch); default
        Kaiser sinc.
      oversample: 1 = critically sampled (output rate fs_in/M; signal
        energy past ±fs_in/2M aliases); 2 = 2× oversampled (hop M/2,
        output rate 2·fs_in/M), so a carrier near a channel edge stays
        unaliased and decodable.

    Returns (B, nchan, nout) complex64: channel k centred at +k·fs_in/M
    (wrap for negative)."""
    if oversample not in (1, 2):
        raise ValueError("oversample must be 1 or 2")
    if oversample == 2 and nchan % 2:
        raise ValueError("2x oversampling needs an even channel count")
    if x.ndim == 1:
        x = x[None, :]
    B = x.shape[0]
    P = taps_per_branch
    if taps is None:
        taps = default_taps(nchan, P, oversample)
    h = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    # polyphase branches: h reshaped (P, M); branch r filters frame col r
    hb = h.reshape(P, nchan)

    # A tone at +k*fs_out gives branch r the constant phase e^{+j2πkr/M},
    # so the forward DFT across branches collects it into bin k.
    ev = torch.fft.fft(_pfb_frames(x, hb, nchan), dim=-1)  # (B, nout, M)
    if oversample == 1:
        # critically sampled: no per-frame phase correction
        return ev.transpose(1, 2).to(torch.complex64)

    # Two interleaved hop-M streams: even output frames start at n=mM,
    # odd frames at n=mM+M/2.  Frame m of the interleaved stream starts
    # at n=m·M/2, so bin k carries the residual carrier phase
    # e^{+j2πk(mM/2)/M} = (-1)^{km}; negating the odd frames' odd bins
    # re-centres every channel at baseband.
    od = torch.fft.fft(_pfb_frames(x[:, nchan // 2 :], hb, nchan), dim=-1)
    sign = torch.where(torch.arange(nchan, device=x.device) % 2 == 0, 1.0, -1.0)
    od = od * sign[None, None, :]
    nout = min(ev.shape[1], od.shape[1])
    inter = torch.stack([ev[:, :nout], od[:, :nout]], dim=2)  # (B,nout,2,M)
    spect = inter.reshape(B, 2 * nout, nchan)
    return spect.transpose(1, 2).to(torch.complex64)


def channel_center(k: int, fs_in: float, nchan: int) -> float:
    """Centre frequency of channel k in Hz (aliased to ±fs_in/2)."""
    f = k * fs_in / nchan
    if f > fs_in / 2:
        f -= fs_in
    return f
