"""symdemod stage model: windowed symbol-timing tracking over a stream.

The reference's main loop (symdemod.c:96-195) processes one ``window``
seconds of baseband per iteration: full timing search, optional clock
hill-climb (-t), then the real demodulation with gain =
100/sqrt(maxenergy).  The prefix sum of the whole block is computed once
(kernel K3); each window is a set of gathers at carry-dependent edges,
the carry being the per-channel firstsample.

Clock tracking (-t) runs the reference's single-channel hill climb with
its control flow on the host (``track_window``, ``symdemod_tracked``):
every probe is one small integrate-and-dump on the run device and one
read of its integrators.  models/symdemod_tracked.py batches the climb
over channels on a quantized clock grid.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.ops import symbols as sym_ops
from isee3_decoder_tpu_torch.ops.symbols import SymConfig


class SymWindowOut(NamedTuple):
    soft: torch.Tensor  # (nwindows, B, nsymbols) uint8 soft decisions
    symphase: torch.Tensor  # (nwindows, B) timing adjustment chosen
    energy: torch.Tensor  # (nwindows, B) max mean energy per symbol
    firstsample: torch.Tensor  # (nwindows, B) absolute window start used


def initial_firstsample(cfg: SymConfig) -> int:
    """firstsample = Symbolsamples/2 (symdemod.c:94, int truncation)."""
    return int(cfg.symbolsamples / 2)


def window_samples(cfg: SymConfig) -> int:
    """Samples consumed per window."""
    return int(cfg.window * cfg.samprate)


def symdemod_scan(
    samples: torch.Tensor,
    cfg: SymConfig,
    nwindows: int,
    firstsample0: torch.Tensor | int | None = None,
) -> tuple[torch.Tensor, SymWindowOut]:
    """Demodulate ``nwindows`` windows from (B, L) baseband samples →
    (final firstsample, outputs stacked over the window axis).  The
    prefix sum of int16 samples comes from kernel K3
    (ops/symbols.samples_csum), padded by the JAX package's rule."""
    csum = sym_ops.samples_csum(samples, sym_ops.SEARCH_PAD)
    return symdemod_scan_csum(csum, cfg, nwindows, firstsample0)


def symdemod_scan_csum(
    csum: torch.Tensor,
    cfg: SymConfig,
    nwindows: int,
    firstsample0: torch.Tensor | int | None = None,
) -> tuple[torch.Tensor, SymWindowOut]:
    """symdemod_scan against a precomputed (B, >=L+1) int32 exclusive
    prefix sum of the baseband whose last column holds the total (kernel
    K3 with tail >= 1)."""
    B = csum.shape[0]
    nsym = cfg.nsymbols
    if firstsample0 is None:
        firstsample0 = initial_firstsample(cfg)
    first = torch.as_tensor(firstsample0, dtype=torch.int64,
                            device=csum.device).expand(B).clone()
    outs = []
    for _ in range(nwindows):
        ts = sym_ops.timesearch_from_csum(
            csum, first, cfg.halfclock, nsym, cfg.symbolclocks, cfg.noffsets
        )
        first = first + ts.symphase
        integ = sym_ops.integrate_from_csum(
            csum, first, cfg.halfclock, nsym, cfg.symbolclocks
        )
        gain = 100.0 / torch.sqrt(ts.maxenergy)  # symdemod.c:190 "Hack"
        soft, _ = sym_ops.finish_demod(integ, gain)
        outs.append(SymWindowOut(soft=soft, symphase=ts.symphase,
                                 energy=ts.maxenergy, firstsample=first))
        # firstsample += nsymbols * Symbolsamples with C int truncation
        # of the double sum (symdemod.c:192)
        first = torch.trunc(
            first.to(torch.float64) + nsym * cfg.symbolsamples
        ).to(torch.int64)
    if not outs:
        empty = torch.empty((0, B), dtype=torch.int64, device=csum.device)
        return first, SymWindowOut(
            soft=torch.empty((0, B, nsym), dtype=torch.uint8, device=csum.device),
            symphase=empty, energy=empty.to(torch.float64), firstsample=empty,
        )
    return first, SymWindowOut(*(torch.stack(f) for f in zip(*outs)))


#: the clock trackers' work per tracked window since reset_track_stats():
#: "iterations" — hill-climb probes of the host tracker, while-loop
#: iterations of the batched one (each probes every channel still
#: climbing); "host_reads" — reads from the run device to the host
track_stats: dict[str, list[int]] = {"iterations": [], "host_reads": []}


def reset_track_stats() -> None:
    for v in track_stats.values():
        v.clear()


def track_window(
    csum_row: torch.Tensor,
    cfg: SymConfig,
    first: int,
    symbolsamples: float,
) -> tuple[np.ndarray, int, float, dict]:
    """One clock-tracked window of one channel (symdemod.c:133-195) from
    the (1, >= L + 1) int32 prefix sum ``csum_row``, starting at sample
    ``first`` with the clock estimate ``symbolsamples``.

    Timing search over ±half a symbol at the current clock, then the
    reference's hill climb on mean demodulated energy: probes ss + d,
    ss − d, first + p, first − p, a downward accept flipping the sign of
    its step, until two passes in a row change nothing; then the
    demodulation with gain 100/sqrt(maxenergy) at the post-climb symbol
    count.  Reads past the prefix sum go as the JAX package's tracker
    reads them (ops/symbols.take_fill).  Adds the window's probes and
    host reads to ``track_stats``.

    Returns (soft (nsym,) uint8 on the host, the next window's first
    sample ``int(first + nsym·symbolsamples)``, the new symbolsamples,
    info: symbolsamples, symrate, firstsample (this window's, after the
    climb), energy, symphase (its distance from the ``first`` given),
    iterations (probes) and host_reads).
    """
    c = cfg.symbolclocks
    wsamples = cfg.window * cfg.samprate
    reads = 0
    probes = 0

    def energy_at(first_s: int, symsamp: float) -> float:
        # the integrators come to the host and numpy takes the float64
        # mean of their squares, as in the JAX package: its rounding, also
        # where the sum passes 2^53 (reads past the prefix sum)
        nonlocal reads, probes
        nsym = int(wsamples / symsamp)
        half = (0.5 / c) * symsamp
        integ = sym_ops.integrate_from_csum(csum_row, first_s, half, nsym, c,
                                            fill=True)
        reads += 1
        probes += 1
        return float((integ.cpu().numpy().astype(np.float64) ** 2).mean())

    first_in = first
    nsym = int(wsamples / symbolsamples)
    half = (0.5 / c) * symbolsamples
    # C offset range -trunc(s/2) .. ceil(s/2)-1 (symdemod.c:273,305)
    noff = int(symbolsamples / 2) + math.ceil(symbolsamples / 2)
    ts = sym_ops.timesearch_from_csum(csum_row, first, half, nsym, c, noff,
                                      fill=True)
    first = first + int(ts.symphase[0])
    maxenergy = float(ts.maxenergy[0])
    reads += 2

    clock_incr = 0.5 * symbolsamples / wsamples
    phase_incr = 1
    nochange = 0
    while nochange < 2:
        e = energy_at(first, symbolsamples + clock_incr)
        if e > maxenergy:
            maxenergy, symbolsamples, nochange = e, symbolsamples + clock_incr, 0
            continue
        e = energy_at(first, symbolsamples - clock_incr)
        if e > maxenergy:
            maxenergy, symbolsamples = e, symbolsamples - clock_incr
            clock_incr, nochange = -clock_incr, 0
            continue
        nochange += 1
        e = energy_at(first + phase_incr, symbolsamples)
        if e > maxenergy:
            maxenergy, first, nochange = e, first + phase_incr, 0
            continue
        e = energy_at(first - phase_incr, symbolsamples)
        if e > maxenergy:
            maxenergy, first = e, first - phase_incr
            phase_incr, nochange = -phase_incr, 0
            continue
        nochange += 1

    # nsymbols is recomputed AFTER the climb ("Update in case Symrate has
    # changed a lot, but defer until now", symdemod.c), so the demod and
    # the window advance use the post-climb clock's count
    nsym = int(wsamples / symbolsamples)
    half = (0.5 / c) * symbolsamples
    integ = sym_ops.integrate_from_csum(csum_row, first, half, nsym, c,
                                        fill=True)
    soft, _ = sym_ops.finish_demod(integ, 100.0 / np.sqrt(maxenergy))
    soft = soft[0].cpu().numpy()
    reads += 1
    track_stats["iterations"].append(probes)
    track_stats["host_reads"].append(reads)
    info = dict(
        symbolsamples=symbolsamples,
        symrate=cfg.samprate / symbolsamples,
        firstsample=first,
        energy=maxenergy,
        symphase=first - first_in,
        iterations=probes,
        host_reads=reads,
    )
    return soft, int(first + nsym * symbolsamples), symbolsamples, info


def _track_channel(
    csum_row: torch.Tensor,
    cfg: SymConfig,
    nwindows: int,
) -> tuple[np.ndarray, list[dict]]:
    """One channel's clock-tracked demodulation (-t, symdemod.c:133-174):
    ``track_window`` once a window from the carried first sample and
    clock estimate."""
    symbolsamples = cfg.symbolsamples
    first = initial_firstsample(cfg)
    outs = []
    infos = []
    for w in range(nwindows):
        soft, first_next, symbolsamples, info = track_window(
            csum_row, cfg, first, symbolsamples)
        outs.append(soft)
        infos.append(dict(window=w, **{k: info[k] for k in (
            "symbolsamples", "symrate", "firstsample", "energy")}))
        first = first_next
    return np.concatenate(outs), infos


def symdemod_tracked(
    samples,
    cfg: SymConfig,
    nwindows: int,
    backend: str = "auto",
    device=None,
) -> tuple[np.ndarray, list[dict]]:
    """Clock-tracked demodulation (-t, symdemod.c:133-174) of (B, L) int16
    baseband on the card (or ``device``).

    Each channel runs the reference's single-channel hill climb on its
    own clock, phase and energy.  backend: "auto" takes this host tracker
    at B = 1 and the batched grid tracker (models/symdemod_tracked.py,
    one device program a window for all channels) at B > 1; "host" and
    "batched" force one.  The prefix sum comes from kernel K3, once a
    call.

    Returns (soft symbols (B, total) uint8, rows right-padded with 128
    where channels' clocks gave them fewer symbols; per-window info dicts
    whose array-valued fields stack the channels).
    """
    if backend not in ("auto", "host", "batched"):
        raise ValueError(f"unknown tracker backend {backend!r}")
    samples = _kernels.place(samples, device)
    if samples.ndim == 1:
        samples = samples[None, :]
    B = samples.shape[0]
    if backend == "batched" or (backend == "auto" and B > 1):
        from isee3_decoder_tpu_torch.models.symdemod_tracked import (
            symdemod_tracked_batched,
        )

        return symdemod_tracked_batched(samples, cfg, nwindows,
                                        device=samples.device)
    csum = sym_ops.samples_csum(samples, sym_ops.track_pad(cfg))

    streams = []
    chan_infos = []
    for b in range(B):
        soft_b, infos_b = _track_channel(csum[b : b + 1], cfg, nwindows)
        streams.append(soft_b)
        chan_infos.append(infos_b)

    total = max(s.size for s in streams)
    out = np.full((B, total), 128, np.uint8)
    for b, s in enumerate(streams):
        out[b, : s.size] = s
    infos = [
        dict(window=w, **{
            key: np.array([chan_infos[b][w][key] for b in range(B)])
            for key in ("symbolsamples", "symrate", "firstsample", "energy")})
        for w in range(nwindows)
    ]
    return out, infos
