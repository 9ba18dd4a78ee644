"""Plain PM carrier demodulator (pmdemod.c:204-372), block by block.

Each FFT-sized block: the full FFT of the block, the peak of the energy
over the search window (the whole passband until the carrier locks,
±search_width around the last lock after), Quinn's second estimator,
the spin-down by the estimated carrier, the carrier amplitude and C/N0
by the two-pass mean and variance, and the Q axis emitted as int16 at
-3 dB with C truncation.  The FFT and the estimate run in float32, as
the reference's fftwf does; the phase ramp and the moments in float64.

``real=torch.bfloat16`` is the control: every real intermediate of the
demodulator rounded to bfloat16, the next precision below the float32
the configuration states.  ``baseband_real=torch.bfloat16`` is the
second control: the carrier estimate in float32, the spin-down and the
baseband it emits rounded to bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _round(x: torch.Tensor, real) -> torch.Tensor:
    """x rounded to ``real`` and back (complex: both parts)."""
    if real is None:
        return x
    if x.is_complex():
        return torch.complex(x.real.to(real).to(x.real.dtype),
                             x.imag.to(real).to(x.imag.dtype))
    return x.to(real).to(x.dtype)


def _tau(x: torch.Tensor) -> torch.Tensor:
    r = math.sqrt(2 / 3.0)
    return (0.25 * torch.log(3 * x * x + 6 * x + 1)
            - math.sqrt(6.0) / 24 * torch.log((x + 1 - r) / (x + 1 + r)))


def search_window(center, cn0, n: int, binsize: float, fs: float, width: float,
                  threshold: float):
    """(first, last) bins per channel (pmdemod.c:255-284): the whole
    spectrum unless locked; C truncation toward zero, negative bins
    wrapped, the pair swapped when the window straddles 0 Hz."""
    locked = (cn0 > threshold) & (width != 0)
    lo, hi = center - width, center + width
    first = torch.where(lo <= -fs / 2, 0, torch.trunc(lo / binsize)).to(torch.int64)
    first = torch.where(first < 0, first + n, first)
    last = torch.where(hi >= fs / 2, n // 2 - 1, torch.trunc(hi / binsize)).to(torch.int64)
    last = torch.where(last < 0, last + n, last)
    first, last = torch.minimum(first, last), torch.maximum(first, last)
    return torch.where(locked, first, 0), torch.where(locked, last, n)


def find_carrier(spec: torch.Tensor, first, last, binsize: float, fs: float, real):
    """Peak energy over bins [first, last) — the reference's ``>=`` scan
    keeps the last maximal bin — and Quinn's second estimator on it
    (pmdemod.c:246-318) → carrier Hz."""
    B, n = spec.shape
    energy = _round(spec.real ** 2 + spec.imag ** 2, real)
    idx = torch.arange(n, device=spec.device)
    inside = (idx[None, :] >= first[:, None]) & (idx[None, :] < last[:, None])
    masked = torch.where(inside, energy, -1.0)
    top = masked.amax(dim=1, keepdim=True)
    peak = torch.where(masked == top, idx[None, :], -1).amax(dim=1)
    maxe = energy.gather(1, peak[:, None])[:, 0]
    sp = spec.gather(1, peak[:, None])[:, 0]
    sn = spec.gather(1, ((peak + 1) % n)[:, None])[:, 0]
    sm = spec.gather(1, ((peak - 1) % n)[:, None])[:, 0]
    safe = torch.where(maxe > 0, maxe, 1.0)
    ap = _round((sn.real * sp.real + sn.imag * sp.imag) / safe, real)
    dp = -ap / (1 - ap)
    am = _round((sm.real * sp.real + sm.imag * sp.imag) / safe, real)
    dm = am / (1 - am)
    d = _round((dp + dm) / 2 + _tau(dp * dp) - _tau(dm * dm), real)
    d = torch.where(maxe > 0, d, 0.0)
    freq = _round(binsize * (peak.to(d.dtype) + d), real)
    return torch.where(freq > fs / 2, freq - fs, freq)


def spin_down(iq: torch.Tensor, freq: torch.Tensor, fs: float, real):
    """Rotate the block down by ``freq`` and onto the I axis
    (pmdemod.c:321-367) → (int16 Q axis, cn0 dB-Hz)."""
    n = iq.shape[1]
    # cycles a sample as the reference divides it, in float32
    c = freq.to(torch.float32) / torch.tensor(fs, dtype=torch.float32, device=iq.device)
    t = torch.arange(n, dtype=torch.float64, device=iq.device)
    cyc = torch.remainder(c.to(torch.float64)[:, None] * t[None, :], 1.0)
    ang = _round(-2 * math.pi * cyc, real)
    lo = _round(torch.complex(torch.cos(ang), torch.sin(ang)), real)
    spun = _round(iq.to(torch.complex128) * lo, real)
    dc = _round(spun.mean(dim=1), real)
    amp = dc.abs()
    unit = torch.where(amp > 0, torch.conj(dc) / torch.where(amp > 0, amp, 1.0), 1.0)
    rot = _round(spun * unit[:, None], real)
    var = _round(((rot.real - amp[:, None]) ** 2).mean(dim=1), real)
    cn0 = 10 * torch.log10(fs * amp * amp / (2 * var))
    q = torch.trunc(rot.imag * math.sqrt(0.5))
    return q.clamp(-32768.0, 32767.0).to(torch.int16), cn0


def pm_demod(raw: torch.Tensor, cfg: dict, real=None, baseband_real=None) -> torch.Tensor:
    """(B, 2L) int16 interleaved I,Q → (B, T·n) int16 baseband of the T
    whole blocks (a trailing partial block is dropped, as the
    reference's fread loop does)."""
    fs, width = cfg["samprate"], cfg["search_width"]
    threshold = cfg["cn0_threshold"]
    n = 1 << int(np.rint(np.log2(fs / cfg["binsize"])))
    binsize = fs / n
    B = raw.shape[0]
    T = raw.shape[1] // (2 * n)
    dev = raw.device
    center = torch.zeros(B, dtype=torch.float32, device=dev)
    cn0 = torch.full((B,), -999.0, dtype=torch.float64, device=dev)
    out = torch.empty((B, T * n), dtype=torch.int16, device=dev)
    for b in range(T):
        blk = raw[:, 2 * n * b: 2 * n * (b + 1)].reshape(B, n, 2).to(torch.float32)
        iq = _round(torch.complex(blk[..., 0], blk[..., 1]), real)
        first, last = search_window(center, cn0, n, binsize, fs, width, threshold)
        freq = find_carrier(_round(torch.fft.fft(iq, dim=-1), real), first, last,
                            binsize, fs, real)
        out[:, n * b: n * (b + 1)], cn0 = spin_down(iq, freq, fs, real or baseband_real)
        center = torch.where(cn0 > threshold, freq, center)
    return out
