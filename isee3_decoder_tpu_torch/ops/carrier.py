"""PM carrier acquisition / tracking / spin-down (pmdemod.c:204-372).

Per FFT-sized block: FFT carrier search (full passband when unlocked,
only the window bins around the last lock when locked), Quinn's second
estimator, one-pass five-moment spin-down with C/N0, and emission of the
Q (data) axis as int16.  Float32 on the kernels; a float64 config
(``PMConfig(dtype=torch.float64)``, the JAX package's C-matching golden
mode) runs its own plain branch, chosen by the dtype alone, as the JAX
package's gates choose it: full FFT search every block, the exact
two-pass spin-down, no kernel (``_kernels.backend_used["pm"]`` reads
``"plain_f64"``).

On raw int16 blocks — the recording format, and the receive chain's
main path — a locked block runs entirely in kernel K1
(``carrier_cuda.pm_locked_fused``) and an unlocked one runs the full
``torch.fft`` search followed by kernel K2 (``carrier_cuda.
spin_down_fused``).  A locked block shorter than the TPU kernels' 8192-
sample chunk searches with kernel K8 (``windowed_dft_raw``) and spins
down with K2, as the JAX package does.  The JAX package's ``lax.cond``
between these is a host branch on one scalar per block here.

``pm_demod_scan_csum`` runs blocks 1..T-1 in one launch of kernel K9
(``carrier_cuda.pm_scan_locked_fused``) and emits the prefix sum the
symbol demodulator reads; one host read per call decides whether its
result stands or the block scan runs instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.ops.syncword import argmax_last


@dataclasses.dataclass(frozen=True)
class PMConfig:
    """Static pmdemod configuration (pmdemod.c:75-131 defaults)."""

    samprate: float = 250_000.0
    binsize: float = 4.0  # FFT bin size request, Hz
    search_width: float = 0.0  # ±Hz when locked; 0 disables windowing
    doppler_rate: float = 0.0  # Hz/s chirp
    cn0_threshold: float = 21.0  # dB-Hz lock threshold
    #: working precision: float32 runs the kernels; float64 is the plain
    #: C-matching golden branch
    dtype: torch.dtype = torch.float32
    #: windowed search when every channel is locked (skips the full
    #: FFT); False forces the reference's always-FFT behaviour
    fast_locked_search: bool = True

    def __post_init__(self):
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(
                f"PMConfig.dtype {self.dtype}: float32 (the kernels) or "
                "float64 (the plain golden branch)")

    @property
    def fftsize(self) -> int:
        # Fftsize = 2^round(log2(samprate/binsize)) (pmdemod.c:129-131)
        return 1 << int(np.rint(np.log2(self.samprate / self.binsize)))

    @property
    def actual_binsize(self) -> float:
        return self.samprate / self.fftsize

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64


class PMCarry(NamedTuple):
    """Streaming carry: the reference's cross-block globals
    (Carrier_search_freq, cn0 — pmdemod.c:37,63)."""

    search_center: torch.Tensor  # (B,) Hz, PMConfig.dtype
    cn0: torch.Tensor  # (B,) dB-Hz, PMConfig.dtype


class PMBlockOut(NamedTuple):
    baseband: torch.Tensor  # (B, fftsize) int16 — Q axis (data)
    carrier_freq: torch.Tensor  # (B,) Hz
    cn0: torch.Tensor  # (B,) dB-Hz
    locked: torch.Tensor  # (B,) bool


def init_carry(
    batch: int, cfg: PMConfig, start_freq: float = 0.0, device=None
) -> PMCarry:
    return PMCarry(
        search_center=torch.full((batch,), start_freq, dtype=cfg.dtype,
                                 device=device),
        cn0=torch.full((batch,), -999.0, dtype=cfg.dtype, device=device),
    )


def _tau(x: torch.Tensor) -> torch.Tensor:
    """Quinn's second estimator helper (pmdemod.c:43-46)."""
    r = math.sqrt(2 / 3.0)
    return 0.25 * torch.log(3 * x * x + 6 * x + 1) - math.sqrt(6.0) / 24 * torch.log(
        (x + 1 - r) / (x + 1 + r)
    )


def doppler_chirp(iq: torch.Tensor, cfg: PMConfig) -> torch.Tensor:
    """De-rotate the per-block Doppler chirp (pmdemod.c:232-244): phase
    drate·i(i+1)/2 at sample i, restarted every block."""
    if cfg.doppler_rate == 0.0:
        return iq
    n = iq.shape[-1]
    drate = cfg.doppler_rate * 2 * np.pi / (cfg.samprate**2)
    i = torch.arange(n, dtype=cfg.dtype, device=iq.device)
    phase = drate * (i * (i + 1) / 2)
    return iq * torch.polar(torch.ones_like(phase), -phase)


def _search_window(
    center: torch.Tensor, cn0: torch.Tensor, cfg: PMConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """(firstbin, lastbin) int32 per channel (pmdemod.c:255-284),
    including the complement-window quirk when the range straddles 0 Hz."""
    n = cfg.fftsize
    binsize = cfg.actual_binsize
    fs = cfg.samprate
    w = cfg.search_width

    locked = (cn0 > cfg.cn0_threshold) & (w != 0)
    lo = center - w
    hi = center + w
    # C int conversion truncates toward zero
    first = torch.where(
        lo <= -fs / 2, 0, torch.trunc(lo / binsize).to(torch.int32)
    ).to(torch.int32)
    first = torch.where(first < 0, first + n, first)
    last = torch.where(
        hi >= fs / 2, n // 2 - 1, torch.trunc(hi / binsize).to(torch.int32)
    ).to(torch.int32)
    last = torch.where(last < 0, last + n, last)
    swap = first > last
    first, last = torch.where(swap, last, first), torch.where(swap, first, last)

    first = torch.where(locked, first, 0).to(torch.int32)
    last = torch.where(locked, last, n).to(torch.int32)
    return first, last


def full_spectrum(iq: torch.Tensor) -> torch.Tensor:
    """(B, n) complex → (B, n) full DFT spectrum, in the input's
    precision, for the unlocked carrier search (pmdemod.c:253)."""
    return torch.fft.fft(iq, dim=-1)


def find_carrier(
    spectrum: torch.Tensor, carry: PMCarry, cfg: PMConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Peak-energy carrier search + Quinn interpolation
    (pmdemod.c:246-318) → (carrier_freq_hz in the spectrum's real
    precision, peak_bin)."""
    B, n = spectrum.shape
    energy = spectrum.real**2 + spectrum.imag**2
    first, last = _search_window(carry.search_center, carry.cn0, cfg)
    idx = torch.arange(n, dtype=torch.int32, device=spectrum.device)
    # exclusive upper bound, the reference's `i < lastbin` scan
    # (pmdemod.c:266-292): the top window bin is never searched
    mask = (idx[None, :] >= first[:, None]) & (idx[None, :] < last[:, None])
    masked = torch.where(mask, energy, -1.0)
    # ">=" update in the reference keeps the *last* maximal bin
    peak = argmax_last(masked, dim=1)
    maxenergy = energy.gather(1, peak[:, None])[:, 0]
    sp = spectrum.gather(1, peak[:, None])[:, 0]
    sn = spectrum.gather(1, ((peak + 1) % n)[:, None])[:, 0]
    sm = spectrum.gather(1, ((peak - 1 + n) % n)[:, None])[:, 0]
    freq = _quinn_freq(sp, sn, sm, maxenergy, peak, cfg.actual_binsize,
                       cfg.samprate)
    return freq, peak


def _quinn_freq(sp, sn, sm, maxenergy, peak_bin, binsize: float,
                samprate: float) -> torch.Tensor:
    """Quinn's second estimator + Hz conversion (pmdemod.c:299-318) from
    the peak bin's spectrum value and its two neighbours."""
    safe = torch.where(maxenergy > 0, maxenergy, 1.0)
    ap = (sn.real * sp.real + sn.imag * sp.imag) / safe
    dp = -ap / (1 - ap)
    am = (sm.real * sp.real + sm.imag * sp.imag) / safe
    dm = am / (1 - am)
    d = (dp + dm) / 2 + _tau(dp * dp) - _tau(dm * dm)
    d = torch.where(maxenergy > 0, d, 0.0)
    freq = binsize * (peak_bin.to(d.dtype) + d)
    return torch.where(freq > samprate / 2, freq - samprate, freq)


def _window_bins(cfg: PMConfig) -> int:
    """Bins covering any locked search window plus the Quinn neighbours:
    last-first+1 <= trunc(2W/binsize)+2 in-window bins."""
    return int(2 * cfg.search_width / cfg.actual_binsize) + 3


def _fast_search_capable(cfg: PMConfig) -> bool:
    """Static gate for the windowed locked-path search (kernels K1, K8,
    K9 and the plain windowed DFT): float32 only, as the JAX package's."""
    n = cfg.fftsize
    return (
        cfg.search_width > 0
        and cfg.dtype == torch.float32
        and n % 256 == 0
        and n >= 512
        and 256 * n < 2**31  # exact int32 phase arithmetic
        and (n // 256) ** 2 < 2**31
        and _window_bins(cfg) <= 2048
    )


def _fast_search_ok(carry: PMCarry, cfg: PMConfig) -> bool:
    """Every channel locked with a well-formed, strictly positive-
    frequency, non-wrapping window that fits _window_bins — the one
    scalar a block step reads back to the host."""
    first, last = _search_window(carry.search_center, carry.cn0, cfg)
    c, w = carry.search_center, cfg.search_width
    b, fs = cfg.actual_binsize, cfg.samprate
    ok = (
        (carry.cn0 > cfg.cn0_threshold)
        & (w != 0)
        & (c - w >= b)  # first >= 1, window never touches bin 0
        & (c + w < fs / 2 - b)  # last <= n/2-2: no top-edge clipping
        & (first >= 1)
        & (last > first)
        & (last - first <= _window_bins(cfg) - 2)
    )
    return bool(ok.all())


def _cexp(num: torch.Tensor, den: int) -> torch.Tensor:
    """exp(-2πi·num/den) in complex64 from exact integer phases."""
    ang = (-2 * np.pi / den) * num.to(torch.float32)
    return torch.complex(torch.cos(ang), torch.sin(ang))


def windowed_dft(iq: torch.Tensor, first1: torch.Tensor, K: int) -> torch.Tensor:
    """(B, n) complex → (B, K) complex64 DFT bins first1_b .. first1_b+K-1
    by the JAX package's mix-folded Cooley-Tukey split (t = 256h + l):

        X[f] = Σ_h Σ_l x[h,l] · e^{-2πi h (f mod n/256)/(n/256)} · e^{-2πi l f/n}

    with every phase an exact integer product reduced mod its period."""
    B, n = iq.shape
    nhi = n // 256
    dev = iq.device
    kk = torch.arange(K, dtype=torch.int64, device=dev)
    h = torch.arange(nhi, dtype=torch.int64, device=dev)
    tl = torch.arange(256, dtype=torch.int64, device=dev)
    f1 = first1.to(torch.int64)
    mixh = _cexp((h[None, :] * (f1 % nhi)[:, None]) % nhi, nhi)  # (B, nhi)
    hi0 = _cexp((h[:, None] * kk[None, :]) % nhi, nhi)  # (nhi, K)
    mixl = _cexp((tl[None, :] * (f1 % n)[:, None]) % n, n)  # (B, 256)
    lo0 = _cexp((tl[:, None] * kk[None, :]) % n, n)  # (256, K)
    x3 = iq.to(torch.complex64).reshape(B, nhi, 256)
    hib = mixh[:, :, None] * hi0[None, :, :]  # (B, nhi, K)
    A = torch.einsum("bht,bhk->btk", x3, hib)
    return torch.einsum("btk,bt,tk->bk", A, mixl, lo0)


def windowed_peak(
    S: torch.Tensor,
    first1: torch.Tensor,
    wlen: torch.Tensor,
    binsize: float,
    samprate: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked last-max peak + Quinn over window bins S[b, k] =
    X[first1_b + k] (pmdemod.c:257-318) → (freq float32, peak bin).
    In-window ⇔ 1 <= k < wlen+1 (wlen = last - first): the reference's
    exclusive-lastbin scan."""
    kk = torch.arange(S.shape[1], dtype=torch.int32, device=S.device)
    energy = S.real**2 + S.imag**2
    mask = (kk[None, :] >= 1) & (kk[None, :] < (wlen + 1)[:, None])
    masked = torch.where(mask, energy, -1.0)
    pk = argmax_last(masked, dim=1)  # 1 <= pk <= K-2
    maxenergy = energy.gather(1, pk[:, None])[:, 0]
    sp = S.gather(1, pk[:, None])[:, 0]
    sn = S.gather(1, pk[:, None] + 1)[:, 0]
    sm = S.gather(1, pk[:, None] - 1)[:, 0]
    peak = first1.to(torch.int64) + pk
    return _quinn_freq(sp, sn, sm, maxenergy, peak, binsize, samprate), peak


def find_carrier_windowed(
    iq: torch.Tensor, carry: PMCarry, cfg: PMConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Locked-path carrier search over ONLY the window bins (the
    reference recomputes the whole FFT, pmdemod.c:253, to look at ~100
    bins of it).  Callers must guard with _fast_search_ok."""
    first, last = _search_window(carry.search_center, carry.cn0, cfg)
    S = windowed_dft(iq, first - 1, _window_bins(cfg))
    return windowed_peak(S, first - 1, last - first, cfg.actual_binsize,
                         cfg.samprate)


def find_carrier_windowed_raw(
    packed: torch.Tensor, carry: PMCarry, cfg: PMConfig, flip: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """find_carrier_windowed over (B, n) packed int32 words: the window
    bins from kernel K8, whose launch also runs the peak + Quinn pass
    (``windowed_peak``, the JAX package's ``_windowed_peak_from_s``).
    Callers guard with _fast_search_ok."""
    from isee3_decoder_tpu_torch.ops import carrier_cuda

    first, last = _search_window(carry.search_center, carry.cn0, cfg)
    _, freq, peak = carrier_cuda.windowed_search_raw(
        packed, first - 1, last - first, _window_bins(cfg), cfg.samprate,
        cfg.actual_binsize, flip)
    return freq, peak


def carrier_cycles(carrier_freq: torch.Tensor, samprate: float,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) Hz → (B,) cycles/sample in ``dtype`` by a true IEEE division
    (a Python-scalar divisor would let PyTorch multiply by its reciprocal
    on the card, one ulp off the kernels' division — and one ulp of the
    phase step is tens of LSB of baseband by the end of a block)."""
    fs = torch.tensor(samprate, dtype=dtype, device=carrier_freq.device)
    return carrier_freq.to(dtype) / fs


def _lo_ramp(carrier_freq: torch.Tensor, n: int, samprate: float,
             extra_cycles: torch.Tensor | None = None,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) Hz → (B, n) LO exp(-2πi f t / fs), complex of ``dtype``.

    Two-level range reduction keeps every phase small: with
    i = 256·ihi + ilo, the per-256-sample phase is reduced mod one cycle
    (c256 = (256c) mod 1), so cyc = c256·ihi + c·ilo stays below ~384
    cycles instead of the ~1e4 a raw c·i reaches at n = 65536.
    ``extra_cycles`` (n,) adds a per-sample phase (the folded de-chirp)."""
    c = carrier_cycles(carrier_freq, samprate, dtype)
    i = torch.arange(n, dtype=torch.int32, device=carrier_freq.device)
    if n % 256 != 0:  # tiny FFT sizes: direct reduced ramp
        cyc = torch.remainder(c[:, None] * i.to(dtype)[None, :], 1.0)
    else:
        ihi = (i // 256).to(dtype)
        ilo = (i % 256).to(dtype)
        c256 = torch.remainder(c * 256.0, 1.0)
        cyc = c256[:, None] * ihi[None, :] + c[:, None] * ilo[None, :]
    if extra_cycles is not None:
        cyc = cyc + extra_cycles[None, :]
    ang = (-2 * np.pi) * cyc
    return torch.complex(torch.cos(ang), torch.sin(ang))


def _moments_cn0(spun: torch.Tensor, samprate: float):
    """One-pass five-moment C/N0 estimate → (amp, unit, cn0).

    The reference's second (variance) sweep (pmdemod.c:341-351) re-reads
    the rotated block; the variance of the rotated I axis is a quadratic
    form in five raw moments of the un-rotated block, so everything
    reduces in one pass.  var = E[(x·û)²] - amp² loses ~f32-eps relative
    precision, noticeable only above ~85 dB-Hz C/N0 — clamped."""
    sr, si = spun.real, spun.imag
    m_r = sr.mean(dim=1)
    m_i = si.mean(dim=1)
    m_rr = (sr * sr).mean(dim=1)
    m_ii = (si * si).mean(dim=1)
    m_ri = (sr * si).mean(dim=1)
    amp2 = m_r * m_r + m_i * m_i
    amp = torch.sqrt(amp2)
    safe2 = torch.where(amp2 > 0, amp2, 1.0)
    e_rot2 = (m_rr * m_r * m_r + 2 * m_ri * m_r * m_i + m_ii * m_i * m_i) / safe2
    var = torch.maximum(e_rot2 - amp2, amp2 * 3e-7 + 1e-30)
    safe_amp = torch.where(amp > 0, amp, 1.0)
    unit = torch.complex(
        torch.where(amp > 0, m_r / safe_amp, 1.0),
        torch.where(amp > 0, -m_i / safe_amp, 0.0),
    )  # conj(dc) / amp
    cn0 = 10 * torch.log10(samprate * amp2 / (2 * var))
    return amp, unit, cn0


def spin_down(
    iq: torch.Tensor, carrier_freq: torch.Tensor, samprate: float,
    extra_cycles: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spin-down + C/N0 estimate (pmdemod.c:321-351) → (baseband complex
    with the carrier on the I axis, carrier amplitude, cn0_db).  complex128
    input takes the JAX package's exact two-pass form in float64 (the
    golden branch), anything else the one-pass float32 moments."""
    if iq.dtype != torch.complex128:
        lo = _lo_ramp(carrier_freq, iq.shape[1], samprate, extra_cycles)
        spun = iq.to(torch.complex64) * lo
        amp, unit, cn0 = _moments_cn0(spun, samprate)
        return spun * unit[:, None], amp, cn0
    spun = iq * _lo_ramp(carrier_freq, iq.shape[1], samprate, extra_cycles,
                         torch.float64)
    dc = spun.mean(dim=1)
    amp = dc.abs()
    unit = torch.where(amp > 0, torch.conj(dc) / torch.where(amp > 0, amp, 1.0),
                       1.0)
    rotated = spun * unit[:, None]
    var = ((rotated.real - amp[:, None]) ** 2).mean(dim=1)
    cn0 = 10 * torch.log10(samprate * amp * amp / (2 * var))
    return rotated, amp, cn0


def emit_baseband(rotated: torch.Tensor) -> torch.Tensor:
    """Q axis, -3 dB headroom, C truncation toward zero
    (pmdemod.c:360-367) → int16, saturating as the JAX package's
    conversion does (a clipped recording can exceed the int16 range).
    The scale is float32 on a complex64 input, float64 on complex128."""
    scale = (np.sqrt(0.5) if rotated.dtype == torch.complex128
             else np.float32(np.sqrt(0.5)))
    q = torch.trunc(rotated.imag * scale)
    return q.clamp(-32768.0, 32767.0).to(torch.int16)


def iq_from_interleaved(raw: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """int16 interleaved I,Q → complex64 (pmdemod.c:206-230; -f flips)."""
    raw = raw.reshape(*raw.shape[:-1], -1, 2).to(torch.float32)
    i, q = raw[..., 0], raw[..., 1]
    if flip:
        i, q = q, i
    return torch.complex(i, q)


def pack_raw(raw: torch.Tensor) -> torch.Tensor:
    """(…, 2n) int16 interleaved I,Q → (…, n) int32 packed words (I in
    the low half, little-endian).  A view: no data moves."""
    return raw.view(torch.int32)


def _finish_block(carry: PMCarry, freq, baseband, cn0, cfg: PMConfig):
    locked = cn0 > cfg.cn0_threshold
    new_center = torch.where(locked, freq, carry.search_center)
    out = PMBlockOut(baseband=baseband, carrier_freq=freq, cn0=cn0,
                     locked=locked)
    return PMCarry(search_center=new_center, cn0=cn0), out


def pm_demod_block(
    carry: PMCarry, iq: torch.Tensor, cfg: PMConfig = PMConfig()
) -> tuple[PMCarry, PMBlockOut]:
    """One pmdemod block step on (B, fftsize) complex IQ (the body of
    pmdemod.c:204-372), plain PyTorch: windowed search when every channel
    is locked, full FFT search otherwise, then spin-down and emission.
    A float64 config computes in complex128 and always takes the full FFT
    search (the JAX package's float64 branch)."""
    if cfg.dtype == torch.float64:
        _kernels.note_backend("pm", "plain_f64")
    iq = doppler_chirp(iq.to(cfg.cdtype), cfg)
    if (cfg.fast_locked_search and _fast_search_capable(cfg)
            and _fast_search_ok(carry, cfg)):
        freq, _ = find_carrier_windowed(iq, carry, cfg)
    else:
        freq, _ = find_carrier(full_spectrum(iq), carry, cfg)
    rotated, amp, cn0 = spin_down(iq, freq, cfg.samprate)
    return _finish_block(carry, freq, emit_baseband(rotated), cn0, cfg)


def pm_demod_block_raw(
    carry: PMCarry,
    raw: torch.Tensor,
    cfg: PMConfig = PMConfig(),
    flip: bool = False,
    out: torch.Tensor | None = None,
) -> tuple[PMCarry, PMBlockOut]:
    """pm_demod_block over a (B, 2·fftsize) raw int16 block.  Locked
    (every channel): kernel K1 does the windowed DFT search, peak +
    Quinn, spin-down and int16 emission from the packed words — or, for
    an undechirped block of fewer than carrier_cuda.SCAN_CHUNK samples,
    kernel K8 the search and K2 the rest (the JAX package's split when
    its fused kernels' chunk does not divide the block).  Otherwise: full
    FFT search on the converted block, then kernel K2 spins down and
    emits.  A configured Doppler rate folds its de-chirp into K1's and
    K2's mix angle.  ``out`` (B, fftsize) int16 receives the baseband in
    place when given.  A float64 config takes no kernel: the block goes
    through iq_from_interleaved to pm_demod_block in complex128, as the
    JAX package's float64 scan does."""
    from isee3_decoder_tpu_torch.ops import carrier_cuda

    if cfg.dtype == torch.float64:
        carry, o = pm_demod_block(carry, iq_from_interleaved(raw, flip), cfg)
        if out is None:
            return carry, o
        out.copy_(o.baseband)
        return carry, o._replace(baseband=out)
    packed = pack_raw(raw)
    n = packed.shape[1]
    # de-chirp rate in cycles/sample², folded into the kernels' mix angle
    dop = cfg.doppler_rate / (cfg.samprate * cfg.samprate)
    locked = (cfg.fast_locked_search and _fast_search_capable(cfg)
              and _fast_search_ok(carry, cfg))
    if locked and not dop and n % carrier_cuda.SCAN_CHUNK:
        freq, _ = find_carrier_windowed_raw(packed, carry, cfg, flip)
        baseband, amp, cn0 = carrier_cuda.spin_down_fused(
            packed, freq, cfg.samprate, flip, out=out)
    elif locked:
        first, last = _search_window(carry.search_center, carry.cn0, cfg)
        baseband, freq, amp, cn0 = carrier_cuda.pm_locked_fused(
            packed, first - 1, last - first, _window_bins(cfg),
            cfg.samprate, cfg.actual_binsize, flip, dop=dop, out=out,
        )
    else:
        iq = doppler_chirp(iq_from_interleaved(raw, flip), cfg)
        freq, _ = find_carrier(full_spectrum(iq), carry, cfg)
        baseband, amp, cn0 = carrier_cuda.spin_down_fused(
            packed, freq, cfg.samprate, flip, dop=dop, out=out
        )
    return _finish_block(carry, freq, baseband, cn0, cfg)


def pm_demod_scan(
    carry: PMCarry,
    iq_blocks: torch.Tensor,
    cfg: PMConfig = PMConfig(),
    flip: bool = False,
) -> tuple[PMCarry, PMBlockOut]:
    """pm_demod_block over the time axis of (B, T, fftsize) complex — or
    (B, T, 2·fftsize) int16 interleaved I,Q as recorded on disk
    (pmdemod.c:206-230) — → outputs stacked over T: baseband (T, B, n),
    carrier_freq / cn0 / locked (T, B).  The streaming outer loop of
    pmdemod.c:204."""
    B, T = iq_blocks.shape[0], iq_blocks.shape[1]
    raw = not iq_blocks.is_complex()
    n = iq_blocks.shape[2] // 2 if raw else iq_blocks.shape[2]
    baseband = torch.empty((T, B, n), dtype=torch.int16, device=iq_blocks.device)
    freqs, cn0s, locks = [], [], []
    for t in range(T):
        if raw:
            carry, o = pm_demod_block_raw(carry, iq_blocks[:, t], cfg, flip,
                                          out=baseband[t])
        else:
            carry, o = pm_demod_block(carry, iq_blocks[:, t], cfg)
            baseband[t] = o.baseband
        freqs.append(o.carrier_freq)
        cn0s.append(o.cn0)
        locks.append(o.locked)
    return carry, PMBlockOut(
        baseband=baseband,
        carrier_freq=torch.stack(freqs),
        cn0=torch.stack(cn0s),
        locked=torch.stack(locks),
    )


class PMScanStats(NamedTuple):
    """Per-block pm status in scan layout (the baseband lives in the
    prefix sum)."""

    carrier_freq: torch.Tensor  # (T, B) Hz
    cn0: torch.Tensor  # (T, B) dB-Hz
    locked: torch.Tensor  # (T, B) bool


def _scan_fused_capable(cfg: PMConfig, n: int, T: int) -> bool:
    """Static gate for the one-launch pm scan (kernel K9): at least one
    block after the cold start, no de-chirp (the kernel has none), float32,
    the windowed locked search, and blocks the TPU kernel's chunk
    divides."""
    from isee3_decoder_tpu_torch.ops import carrier_cuda

    return (
        T >= 2
        and cfg.doppler_rate == 0.0
        and cfg.dtype == torch.float32
        and cfg.fast_locked_search
        and _fast_search_capable(cfg)
        and n % carrier_cuda.SCAN_CHUNK == 0
    )


def pm_demod_scan_csum(
    carry: PMCarry,
    raw_blocks: torch.Tensor,
    cfg: PMConfig = PMConfig(),
    flip: bool = False,
    tail: int = 0,
) -> tuple[PMCarry, torch.Tensor, PMScanStats, torch.Tensor]:
    """pm_demod_scan with the prefix sum of the baseband as its output:
    (B, T, 2·fftsize) raw int16 → (carry', csum (B, T·n + tail) int32
    exclusive prefix sum — columns past T·n hold the total —, PMScanStats,
    totals (B,) int32).

    Block 0 runs the cold-start step (pm_demod_block_raw); blocks 1..T-1
    run the locked windowed path in one launch of kernel K9, which carries
    the lock state and the running sum.  If any channel's window fails
    the locked-path preconditions in any of those blocks, the whole call
    runs again from ``carry`` as the block scan + kernel K3 — the JAX
    package's ``lax.cond``, here one host read per call.  Callers pass
    _scan_fused_capable."""
    from isee3_decoder_tpu_torch.ops import carrier_cuda
    from isee3_decoder_tpu_torch.ops.prefix_cuda import prefix_sum_blocks

    B, T = raw_blocks.shape[0], raw_blocks.shape[1]
    n = raw_blocks.shape[2] // 2
    carry1, out0 = pm_demod_block_raw(carry, raw_blocks[:, 0], cfg, flip)
    init = torch.stack([torch.zeros_like(out0.cn0), out0.cn0,
                        out0.carrier_freq, carry1.search_center], dim=1)
    csum, stat, tots = carrier_cuda.pm_scan_locked_fused(
        pack_raw(raw_blocks), out0.baseband, init,
        cfg.samprate, cfg.actual_binsize, cfg.search_width, cfg.cn0_threshold,
        _window_bins(cfg), flip,
        dop=cfg.doppler_rate / (cfg.samprate * cfg.samprate), tail=tail,
    )
    if bool((stat[:, 1:, 3] > 0).all()):
        freq, cn0 = stat[:, :, 2].T, stat[:, :, 1].T
        carry = PMCarry(search_center=stat[:, T - 1, 5], cn0=stat[:, T - 1, 1])
    else:
        _kernels.note_backend("pm_scan", "fallback")
        carry, out = pm_demod_scan(carry, raw_blocks, cfg, flip)
        csum = prefix_sum_blocks(out.baseband, tail=tail)
        tots = csum[:, T * n - 1] + out.baseband[T - 1, :, n - 1].to(torch.int32)
        freq, cn0 = out.carrier_freq, out.cn0
    stats = PMScanStats(carrier_freq=freq, cn0=cn0,
                        locked=cn0 > cfg.cn0_threshold)
    return carry, csum, stats, tots
