"""Manchester symbol demodulation: timing search + integrate-and-dump
(symdemod.c:199-335).

A prefix sum over the block turns every integration segment into two
reads, so all symbols × all timing offsets evaluate as one batched
gather + reduction.  Segment sums are differences of an int32 prefix
sum: two's-complement wraparound in the prefix sum cancels in the
differences.  Energies, the gain, the soft-decision scale and the
firstsample advance are float64, as in the C reference (and the JAX
package with x64 on).

The JAX package evaluates the offset sweep through grouped and framed
static-slice plans built around TPU gather costs; here the plain gather
form (its ``_esum_gather``) serves every mode.  All three read the same
prefix-sum entries, and the float64 sums of integer squares are exact,
so energies and decisions are identical.  The gather runs over chunks of
the offset axis of at most ``SEARCH_ENTRIES`` entries a channel (one
chunk at 512 and 2048 bps; 32 in the 16 bps subcarrier mode, whose one
gather would hold 32 times that); the result does not depend on the
chunks.

Reads past the end of the prefix sum are clamped to its last column,
which holds the grand total (prefix_cuda.prefix_sum_blocks(tail=1) /
prefix_sum here): an edge extension, equal to zero-padding the samples.

``samples_csum`` takes the prefix sum of int16 baseband from kernel K3
(the samples as one block of prefix_cuda.prefix_sum_blocks);
``timesearch`` and ``integrate_symbols``, the per-window forms the
symdemod and bitsync tools call, read it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from isee3_decoder_tpu_torch.config import ACTUALCLOCK
from isee3_decoder_tpu_torch.ops.prefix_cuda import prefix_sum_blocks
from isee3_decoder_tpu_torch.ops.syncword import argmax_first
from isee3_decoder_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class SymConfig:
    """Static symdemod configuration (symdemod.c:50-94)."""

    samprate: float = 250_000.0
    symrate: float = ACTUALCLOCK  # measured spacecraft clock default
    symbolclocks: int = 1  # subcarrier clocks per symbol (-C)
    window: float = 1.0  # seconds per estimation window (-w)

    @property
    def symbolsamples(self) -> float:
        return self.samprate / self.symrate

    @property
    def halfclock(self) -> float:
        return (0.5 / self.symbolclocks) * self.symbolsamples

    @property
    def nsymbols(self) -> int:
        # nsymbols = window * Symrate, C int truncation (symdemod.c:93)
        return int(self.window * self.symrate)

    @property
    def noffsets(self) -> int:
        # offsets -trunc(s/2) .. ceil(s/2)-1 (symdemod.c:273,305)
        s = self.symbolsamples
        return int(s / 2) + math.ceil(s / 2)


#: samples of zero padding the timing search's prefix sum gets past the
#: block: the JAX package's rule (its symbols.py:620-624), the span its
#: grouped plans read beyond the last edge plus 8 — here 8, since the
#: gather form reads no further than the last edge
SEARCH_PAD = 8

#: prefix-sum entries a channel that one chunk of the timing search
#: gathers: a whole 1 s window's sweep at 1024 sym/s and 250 ksps (245
#: offsets x 2049 edges)
SEARCH_ENTRIES = 245 * 2049

#: headroom on the JAX package's widened offset axis for per-channel start
#: spread (its symbols.py:274); here it only enters the clock trackers'
#: prefix-sum pads, which must match the JAX package's to read the same
#: entries at a recording's end
TRACK_DELTA = 384


def track_pad(cfg: SymConfig) -> int:
    """Samples of zero padding the host clock tracker's prefix sum gets
    past the recording (the JAX package's models/symdemod.py:254-260);
    the batched tracker adds its offset count (``noffsets``) to it."""
    return 16 * int(cfg.symbolsamples) + TRACK_DELTA + 576


class TimeSearchResult(NamedTuple):
    symphase: torch.Tensor  # (B,) int64 best timing offset in samples
    maxenergy: torch.Tensor  # (B,) float64 mean energy per symbol there


def prefix_sum(samples: torch.Tensor, pad_to: int | None = None) -> torch.Tensor:
    """(B, L) samples → (B, L+1) exclusive int32 prefix sum (the last
    column is the total).  ``pad_to`` (>= L) zero-extends the samples
    first, i.e. edge-extends the prefix sum."""
    if samples.ndim == 1:
        samples = samples[None, :]
    B, L = samples.shape
    x = samples.to(torch.int64)
    if pad_to is not None and pad_to > L:
        x = torch.nn.functional.pad(x, (0, pad_to - L))
    csum = torch.cumsum(x, dim=-1)
    zero = torch.zeros((B, 1), dtype=torch.int64, device=samples.device)
    # int64 → int32 keeps the low 32 bits: two's-complement wraparound
    return torch.cat([zero, csum], dim=-1).to(torch.int32)


def samples_csum(samples: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """(B, L) int16 baseband → (B, L + pad + 1) int32 exclusive prefix sum
    whose columns from L on hold the total: ``prefix_sum(samples, pad_to=L
    + pad)``, from kernel K3 on the samples as one block of L samples with
    pad + 1 tail columns (its plain version on a CPU tensor)."""
    if samples.ndim == 1:
        samples = samples[None, :]
    if samples.dtype != torch.int16 or samples.shape[1] == 0:
        raise ValueError(f"samples must be (B, L) int16 with L > 0, got "
                         f"{samples.dtype} {tuple(samples.shape)}")
    return prefix_sum_blocks(samples.contiguous()[None], tail=pad + 1)


def trial_edges(halfclock: float, nsymbols: int, symbolclocks: int) -> np.ndarray:
    """Float segment edges relative to firstsample for trial_demod-style
    absolute rounding; edge 0 is exactly 0."""
    nseg = 2 * symbolclocks * nsymbols
    return np.concatenate([[0.0], np.cumsum(np.full(nseg, halfclock))])


def search_edges(halfclock: float, nsymbols: int, symbolclocks: int) -> np.ndarray:
    """Integer switchpoints for timesearch-style relative rounding."""
    nseg = 2 * symbolclocks * nsymbols
    rel = np.rint(np.cumsum(np.full(nseg, halfclock))).astype(np.int64)
    return np.concatenate([[0], rel])


def _gather_clamped(csum: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """csum[b, idx[b, ...]] with indices clamped into the row."""
    B = csum.shape[0]
    flat = idx.reshape(B, -1).clamp(0, csum.shape[1] - 1)
    return csum.gather(1, flat).reshape(idx.shape)


def take_fill(csum: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """csum[b, idx[b, ...]] as ``jnp.take_along_axis`` reads it, which is
    how the JAX package's clock trackers read their prefix sum: an index
    in [-L, 0) counts from the row's end, and one outside [-L, L) reads
    INT32_MIN (its "fill" mode for int32)."""
    B, L = csum.shape
    flat = idx.reshape(B, -1).to(torch.int64)
    flat = torch.where(flat < 0, flat + L, flat)
    inside = (flat >= 0) & (flat < L)
    g = csum.gather(1, flat.clamp(0, L - 1))
    fill = torch.iinfo(csum.dtype).min
    return torch.where(inside, g, fill).reshape(idx.shape)


def integrate_from_csum(
    csum: torch.Tensor,
    firstsample: torch.Tensor | int,
    halfclock: float,
    nsymbols: int,
    symbolclocks: int,
    fill: bool = False,
) -> torch.Tensor:
    """(B, nsymbols) int32 integrators at trial_demod's absolute edge
    rounding nearbyint(firstsample + rel), evaluated EXACTLY in integers:
    the float64 edge table splits host-side into floor + {<.5, >.5, ==.5}
    classes, and half-to-even ties resolve from the parity of
    firstsample + floor(rel).  ``fill`` reads edges past the prefix sum
    as the JAX package's trackers do (take_fill), else clamped."""
    B = csum.shape[0]
    dev = csum.device
    first = torch.as_tensor(firstsample, dtype=torch.int64, device=dev).expand(B)
    rel = trial_edges(halfclock, nsymbols, symbolclocks)
    flo = np.floor(rel)
    frac = rel - flo
    site = "symdemod/trial_edges"
    flo_d = profiling.upload(site, flo.astype(np.int64), dev)
    up_d = profiling.upload(site, (frac > 0.5).astype(np.int64), dev)
    tie_d = profiling.upload(site, (frac == 0.5).astype(np.int64), dev)
    base = first[:, None] + flo_d[None, :]
    abs_edges = base + up_d[None, :] + tie_d[None, :] * (base & 1)
    g = (take_fill if fill else _gather_clamped)(csum, abs_edges)
    seg = (g[:, 1:] - g[:, :-1]).reshape(B, nsymbols, symbolclocks, 2)
    return (seg[..., 1] - seg[..., 0]).sum(dim=-1, dtype=torch.int32)


def timesearch_from_csum(
    csum: torch.Tensor,
    firstsample: torch.Tensor | int,
    halfclock: float,
    nsymbols: int,
    symbolclocks: int,
    noffsets: int,
    fill: bool = False,
    max_entries: int | None = SEARCH_ENTRIES,
) -> TimeSearchResult:
    """Full symbol-phase search over ±half a symbol (timesearch,
    symdemod.c:260-335) against a prefix sum.  Edges are firstsample +
    offset + nearbyint(m*halfclock) — the reference's *relative*
    rounding; the strict '>' comparison keeps the earliest maximal
    offset (symdemod.c:328-332).  ``fill`` as in integrate_from_csum.

    The offsets go in chunks whose gather holds at most ``max_entries``
    prefix-sum entries a channel (None: one chunk); every offset's
    energy is the same float64 sum over its symbols whatever the chunk,
    and the argmax runs over all offsets at once, so the result does not
    depend on the chunking."""
    B = csum.shape[0]
    dev = csum.device
    half = noffsets // 2
    first = torch.as_tensor(firstsample, dtype=torch.int64, device=dev).expand(B)
    offsets = torch.arange(-half, noffsets - half, dtype=torch.int64, device=dev)
    rel = profiling.upload("symdemod/search_edges",
                           search_edges(halfclock, nsymbols, symbolclocks), dev)
    step = noffsets if max_entries is None else max(max_entries // rel.numel(), 1)
    gather = take_fill if fill else _gather_clamped
    parts = []
    for o0 in range(0, noffsets, step):
        offs = offsets[o0 : o0 + step]
        abs_edges = first[:, None, None] + offs[None, :, None] + rel[None, None, :]
        # (B, chunk, nedges) int32; each buffer goes before the next is
        # made, so one chunk's peak is what max_entries bounds
        g = gather(csum, abs_edges)
        del abs_edges
        seg = (g[..., 1:] - g[..., :-1]).reshape(B, offs.numel(), nsymbols,
                                                  symbolclocks, 2)
        del g
        integ = (seg[..., 1] - seg[..., 0]).sum(dim=-1, dtype=torch.int32)
        del seg
        parts.append((integ.to(torch.float64) ** 2).sum(dim=-1))
    energy = torch.cat(parts, dim=1) / nsymbols
    best = argmax_first(energy, dim=-1)
    return TimeSearchResult(
        symphase=offsets[best],
        maxenergy=energy.gather(1, best[:, None])[:, 0],
    )


def finish_demod(
    integ: torch.Tensor, gain: torch.Tensor | float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scale integrators into offset-128 uint8 soft decisions and compute
    the mean per-symbol energy (symdemod.c:240-255)."""
    x = integ.to(torch.float64)
    energy = (x**2).mean(dim=-1)
    gain = torch.as_tensor(gain, dtype=torch.float64, device=integ.device)
    if gain.ndim == 1:
        gain = gain[:, None]
    soft = torch.clamp(gain * x + 128.0, 0.0, 255.0).to(torch.uint8)  # C cast
    return soft, energy


class DemodResult(NamedTuple):
    soft: torch.Tensor  # (B, nsymbols) uint8 offset-128 soft decisions
    integrators: torch.Tensor  # (B, nsymbols) int32 raw integrator values
    energy: torch.Tensor  # (B,) float64 mean energy per symbol


def integrate_symbols(
    samples: torch.Tensor,
    firstsample: torch.Tensor | int,
    halfclock: float,
    nsymbols: int,
    symbolclocks: int,
    gain: torch.Tensor | float = 0.0,
) -> DemodResult:
    """Manchester integrate-and-dump at one timing hypothesis
    (trial_demod, symdemod.c:202-256) on (B, L) baseband: segment edges
    nearbyint(firstsample + m·halfclock), the reference's absolute
    rounding.  ``gain`` scales the 8-bit output; 0 is an energy-only
    trial."""
    csum = samples_csum(samples)
    integ = integrate_from_csum(csum, firstsample, halfclock, nsymbols,
                                symbolclocks)
    soft, energy = finish_demod(integ, gain)
    return DemodResult(soft=soft, integrators=integ, energy=energy)


def timesearch(
    samples: torch.Tensor,
    firstsample: torch.Tensor | int,
    halfclock: float,
    nsymbols: int,
    symbolclocks: int,
    noffsets: int,
) -> TimeSearchResult:
    """Full symbol-phase search over ±half a symbol (timesearch,
    symdemod.c:260-335) on (B, L) baseband: edges firstsample + offset +
    nearbyint(m·halfclock), the reference's relative rounding; a strict
    '>' keeps the earliest maximal offset."""
    csum = samples_csum(samples, SEARCH_PAD)
    return timesearch_from_csum(csum, firstsample, halfclock, nsymbols,
                                symbolclocks, noffsets)
