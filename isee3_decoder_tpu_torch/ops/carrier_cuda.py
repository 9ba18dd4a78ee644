"""Kernels K1 (locked pm block) and K2 (spin-down) and their plain
PyTorch versions.

K1 ``pm_locked_fused`` replaces the TPU kernel ``_locked_kernel``
(isee3_decoder_tpu/ops/carrier_pallas.py:687); K2 ``spin_down_fused``
replaces ``_spin_kernel`` (carrier_pallas.py:214).  The CUDA source is
csrc/carrier.cu.  A CUDA tensor goes through the kernel (or the wrapper
raises); a CPU tensor through the plain version beside it, which is the
JAX package's XLA path written in PyTorch (windowed DFT by einsum,
masked last-max peak, Quinn, five-moment spin-down, int16 emission).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.ops import carrier

SPIN_CHUNK = 4096  # samples per moments/emit block (csrc/carrier.cu)
CHIRP_CHUNK = 8192  # de-chirp coefficient chunk (csrc/carrier.cu)
_SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90


def _iq_from_packed(packed: torch.Tensor, flip: bool) -> torch.Tensor:
    return carrier.iq_from_interleaved(packed.view(torch.int16), flip)


@functools.lru_cache(maxsize=8)
def chirp_table(n: int, dop: float, device: torch.device) -> torch.Tensor:
    """(n,) complex64 de-chirp phasors exp(-2πi φ(i)), φ(i) = dop·i(i+1)/2
    mod 1 in float64 (pmdemod.c:232-244, restarted every block).  The
    DFT search rotates the data by them: the chirp phase has an h·l cross
    term, so it cannot fold into the two DFT factors."""
    ii = np.arange(n, dtype=np.float64)
    ang = 2.0 * np.pi * ((dop * (ii * (ii + 1.0) / 2.0)) % 1.0)
    tab = np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)
    return torch.view_as_complex(torch.as_tensor(tab, device=device))


@functools.lru_cache(maxsize=8)
def chirp_cycles(n: int, dop: float, device: torch.device) -> torch.Tensor:
    """(n,) float32 de-chirp phase in cycles as the spin-down folds it into
    its mix angle: per 8192-sample chunk k, φ(j) = A + B256·(j//256) +
    Bk·(j%256) + C·j² with the chunk base reduced mod 1 in float64 (every
    traced term stays small enough for float32)."""
    j = torch.arange(min(n, CHIRP_CHUNK), dtype=torch.int32, device=device)
    jh, jl, jf = (j // 256).float(), (j % 256).float(), j.float()
    parts = []
    for k in range(-(-n // CHIRP_CHUNK)):
        base = float(k) * CHIRP_CHUNK
        A = (0.5 * dop * base * base + 0.5 * dop * base) % 1.0
        Bk = (dop * base + 0.5 * dop) % 1.0
        B256 = (256.0 * Bk) % 1.0
        f32 = np.float32
        parts.append(f32(A) + f32(B256) * jh + f32(Bk) * jl
                     + f32(0.5 * dop) * (jf * jf))
    return torch.cat(parts)[:n]


def spin_down_plain(
    packed: torch.Tensor, carrier_freq: torch.Tensor, samprate: float,
    flip: bool = False, dop: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2: (B, n) packed int32 IQ + (B,) Hz →
    (baseband int16 (B, n), amp, cn0_db).  ``dop`` (cycles/sample²)
    folds the Doppler de-chirp into the mix angle."""
    iq = _iq_from_packed(packed, flip)
    extra = chirp_cycles(iq.shape[1], dop, iq.device) if dop else None
    rotated, amp, cn0 = carrier.spin_down(iq, carrier_freq, samprate, extra)
    return carrier.emit_baseband(rotated), amp, cn0


def pm_locked_plain(
    packed: torch.Tensor,
    first1: torch.Tensor,
    wlen: torch.Tensor,
    K: int,
    samprate: float,
    binsize: float,
    flip: bool = False,
    dop: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1: (B, n) packed int32 IQ, window start bins
    first1 = firstbin-1 and wlen = lastbin-firstbin → (baseband int16,
    carrier_freq, amp, cn0_db)."""
    iq = _iq_from_packed(packed, flip)
    n = iq.shape[1]
    search = iq * chirp_table(n, dop, iq.device) if dop else iq
    S = carrier.windowed_dft(search, first1, K)
    freq, _ = carrier.windowed_peak(S, first1, wlen, binsize, samprate)
    extra = chirp_cycles(n, dop, iq.device) if dop else None
    rotated, amp, cn0 = carrier.spin_down(iq, freq, samprate, extra)
    return carrier.emit_baseband(rotated), freq, amp, cn0


def _check_packed(packed: torch.Tensor, out: torch.Tensor | None) -> None:
    if packed.dtype != torch.int32 or packed.ndim != 2:
        raise ValueError(f"packed must be (B, n) int32, got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if packed.stride(1) != 1:
        raise ValueError("packed rows must be contiguous")
    B, n = packed.shape
    if n % 256 != 0 or n <= 0:
        raise ValueError(f"n = {n} must be a positive multiple of 256")
    if B < 1 or B > 65535:
        raise ValueError(f"B = {B} out of range 1..65535")
    if out is not None and (out.dtype != torch.int16
                            or tuple(out.shape) != (B, n)
                            or not out.is_contiguous()
                            or out.device != packed.device):
        raise ValueError("out must be a contiguous (B, n) int16 tensor "
                         "on the input's device")


def _moment_scratch(B: int, n: int, device) -> torch.Tensor:
    nchunk = -(-n // SPIN_CHUNK)
    return torch.empty((B, nchunk, 5), dtype=torch.float64, device=device)


def _put(bb: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    if out is None:
        return bb
    out.copy_(bb)
    return out


def pm_locked_fused(
    packed: torch.Tensor,
    first1: torch.Tensor,
    wlen: torch.Tensor,
    K: int,
    samprate: float,
    binsize: float,
    flip: bool = False,
    dop: float = 0.0,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: one locked pm block, window search to int16 emission →
    (baseband int16 (B, n), carrier_freq, amp, cn0_db), all float32.

    ``K`` bins first1 .. first1+K-1 are evaluated (carrier._window_bins);
    callers pass the carrier._fast_search_ok gate, so 1 <= wlen <= K-2.
    ``dop`` (cycles/sample²) de-chirps; ``out`` receives the baseband."""
    if not _kernels.use_kernel(packed):
        _kernels.note_backend("pm", "torch")
        bb, freq, amp, cn0 = pm_locked_plain(packed, first1, wlen, K,
                                             samprate, binsize, flip, dop)
        return _put(bb, out), freq, amp, cn0
    _check_packed(packed, out)
    B, n = packed.shape
    if not 3 <= K <= n:
        raise ValueError(f"K = {K} window bins out of range 3..{n}")
    if ((n // 256) + 128) * 8 > _SMEM_MAX:
        raise ValueError(f"n = {n}: twiddle table exceeds shared memory")
    dev = packed.device
    iw = torch.stack([first1, wlen], dim=1).to(device=dev,
                                                dtype=torch.int32).contiguous()
    if iw.shape != (B, 2):
        raise ValueError("first1 and wlen must be (B,)")
    bb = out if out is not None else torch.empty((B, n), dtype=torch.int16,
                                                 device=dev)
    stat = torch.empty((B, 4), dtype=torch.float32, device=dev)
    spec = torch.empty((B, K, 2), dtype=torch.float32, device=dev)
    cyc = torch.empty((B,), dtype=torch.float32, device=dev)
    mom = _moment_scratch(B, n, dev)
    chirp = chirp_table(n, dop, dev) if dop else None
    err = _kernels.lib().pm_locked_launch(
        packed.data_ptr(), packed.stride(0), iw.data_ptr(), B, n, K,
        float(np.float32(samprate)), float(np.float32(binsize)), int(flip),
        float(dop), None if chirp is None else chirp.data_ptr(),
        bb.data_ptr(), stat.data_ptr(), spec.data_ptr(), cyc.data_ptr(),
        mom.data_ptr(), _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "pm_locked_launch")
    _kernels.count_launch("pm_locked")
    _kernels.note_backend("pm", "cuda")
    return bb, stat[:, 2], stat[:, 0], stat[:, 1]


def spin_down_fused(
    packed: torch.Tensor,
    carrier_freq: torch.Tensor,
    samprate: float,
    flip: bool = False,
    dop: float = 0.0,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: spin-down at the given carrier + int16 emission →
    (baseband int16 (B, n), amp, cn0_db).  ``dop`` (cycles/sample²)
    de-chirps; ``out`` receives the baseband when given."""
    if not _kernels.use_kernel(packed):
        _kernels.note_backend("pm", "torch")
        bb, amp, cn0 = spin_down_plain(packed, carrier_freq, samprate, flip,
                                       dop)
        return _put(bb, out), amp, cn0
    _check_packed(packed, out)
    B, n = packed.shape
    dev = packed.device
    if carrier_freq.shape != (B,):
        raise ValueError("carrier_freq must be (B,)")
    cyc = carrier.carrier_cycles(carrier_freq.to(dev), samprate).contiguous()
    bb = out if out is not None else torch.empty((B, n), dtype=torch.int16,
                                                 device=dev)
    stat = torch.empty((B, 2), dtype=torch.float32, device=dev)
    mom = _moment_scratch(B, n, dev)
    err = _kernels.lib().spin_down_launch(
        packed.data_ptr(), packed.stride(0), cyc.data_ptr(), B, n,
        float(np.float32(samprate)), int(flip), float(dop), bb.data_ptr(),
        stat.data_ptr(), mom.data_ptr(), _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "spin_down_launch")
    _kernels.count_launch("spin_down")
    _kernels.note_backend("pm", "cuda")
    return bb, stat[:, 0], stat[:, 1]
