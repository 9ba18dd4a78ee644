"""Plain Manchester symbol demodulator (symdemod.c:96-335).

One ``window`` seconds of baseband a step: the timing search over ±half
a symbol (integrate-and-dump energy at every offset, the reference's
relative edge rounding, the earliest maximal offset), then the
integrate-and-dump at the chosen timing with the reference's absolute
edge rounding (round half to even), the gain 100/sqrt(energy), and
offset-128 soft symbols.  Segment sums are differences of an int64
prefix sum of the baseband; reads past its end take the total (zero
padding); energies are float64, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: prefix-sum entries one gather of the timing search may hold a channel
GATHER_ENTRIES = 1 << 21


def _read(csum: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B = csum.shape[0]
    flat = idx.reshape(B, -1).clamp(0, csum.shape[1] - 1)
    return csum.gather(1, flat).reshape(idx.shape)


def _dump(edges_sum: torch.Tensor, nsym: int, clocks: int, real=None) -> torch.Tensor:
    """(..., 2·clocks·nsym + 1) prefix-sum reads at the segment edges →
    (..., nsym) integrators: the second half-cycle minus the first,
    summed over a symbol's subcarrier cycles.  ``real`` (the control)
    rounds each half-cycle's sum to that type and integrates in it."""
    seg = edges_sum[..., 1:] - edges_sum[..., :-1]
    if real is not None:
        seg = seg.to(real)
    seg = seg.reshape(*seg.shape[:-1], nsym, clocks, 2)
    return (seg[..., 1] - seg[..., 0]).sum(dim=-1)


def timesearch(csum, first, halfclock: float, nsym: int, clocks: int,
               noffsets: int, real=None):
    """(best offset, its mean energy) per channel (symdemod.c:260-335):
    edges first + offset + nearbyint(m·halfclock)."""
    dev = csum.device
    half = noffsets // 2
    rel = np.rint(np.cumsum(np.full(2 * clocks * nsym, halfclock)))
    rel = torch.as_tensor(np.concatenate([[0], rel]).astype(np.int64), device=dev)
    offsets = torch.arange(-half, noffsets - half, dtype=torch.int64, device=dev)
    step = max(GATHER_ENTRIES // rel.numel(), 1)
    parts = []
    for o0 in range(0, noffsets, step):
        edges = first[:, None, None] + offsets[None, o0:o0 + step, None] + rel[None, None, :]
        integ = _dump(_read(csum, edges), nsym, clocks, real).to(torch.float64)
        parts.append((integ ** 2).sum(dim=-1))
    energy = torch.cat(parts, dim=1) / nsym
    top = energy.amax(dim=1, keepdim=True)
    idx = torch.arange(noffsets, device=dev)
    best = torch.where(energy == top, idx[None, :], noffsets).amin(dim=1)
    return offsets[best], energy.gather(1, best[:, None])[:, 0]


def integrate(csum, first, halfclock: float, nsym: int, clocks: int, real=None):
    """(B, nsym) integrators at edges nearbyint(first + rel), rel the
    float64 running sum of half-cycles, rounded half to even exactly:
    first is an integer, so the tie class and parity come from rel."""
    dev = csum.device
    rel = np.concatenate([[0.0], np.cumsum(np.full(2 * clocks * nsym, halfclock))])
    flo = np.floor(rel)
    frac = rel - flo
    flo_t = torch.as_tensor(flo.astype(np.int64), device=dev)
    up = torch.as_tensor((frac > 0.5).astype(np.int64), device=dev)
    tie = torch.as_tensor((frac == 0.5).astype(np.int64), device=dev)
    base = first[:, None] + flo_t[None, :]
    edges = base + up[None, :] + tie[None, :] * (base & 1)
    return _dump(_read(csum, edges), nsym, clocks, real)


def symdemod(baseband: torch.Tensor, cfg: dict, real=None) -> torch.Tensor:
    """(B, L) int16 baseband → (B, nwindows·nsym) uint8 soft symbols,
    the window count the receive chain takes: one window of slack is
    left for the timing search.  ``real`` integrates in that type (the
    control)."""
    B, L = baseband.shape
    dev = baseband.device
    sps = cfg["samprate"] / cfg["symrate"]
    clocks = cfg["symbolclocks"]
    halfclock = (0.5 / clocks) * sps
    nsym = int(cfg["window"] * cfg["symrate"])
    noffsets = int(sps / 2) + math.ceil(sps / 2)
    first0 = int(sps / 2)
    nwin = max((L - first0) // int(cfg["window"] * cfg["samprate"]) - 1, 0)
    csum = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                      torch.cumsum(baseband.to(torch.int64), dim=1)], dim=1)
    first = torch.full((B,), first0, dtype=torch.int64, device=dev)
    out = []
    for _ in range(nwin):
        phase, energy = timesearch(csum, first, halfclock, nsym, clocks, noffsets, real)
        first = first + phase
        x = integrate(csum, first, halfclock, nsym, clocks, real).to(torch.float64)
        gain = 100.0 / torch.sqrt(energy)
        out.append(torch.clamp(gain[:, None] * x + 128.0, 0.0, 255.0).to(torch.uint8))
        first = torch.trunc(first.to(torch.float64) + nsym * sps).to(torch.int64)
    if not out:
        return torch.empty((B, 0), dtype=torch.uint8, device=dev)
    return torch.cat(out, dim=1)
