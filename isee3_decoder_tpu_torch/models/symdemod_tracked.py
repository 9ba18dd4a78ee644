"""Batched clock/phase tracking (-t) for many channels at once.

models/symdemod.symdemod_tracked runs the reference's single-channel
hill climb (symdemod.c:133-174) per channel with its control on the
host: a 128-channel run costs ~128 times one channel.  Here every
channel climbs at once, with a few device ops per climb step for the
whole batch.

The quantized clock grid: every channel's clock estimate lives on the
grid ``ss_k = ss0 + k · incr0``, where ``incr0`` is the reference's climb
step at the nominal clock (0.5 · ss0 / window samples).  The edge tables
of every k (the float64 cumsum + nearbyint split of ops/symbols
``trial_edges`` / ``search_edges``) are built once on the host and sent
to the device once a call; a window gathers each channel's table row by
its ``k``, so the clock is data.  A window (``tracked_window``):

  * the window-start timing search over all offsets at the channel's
    clock (relative integer switchpoints), one (B, edges, offsets) slab
    of the prefix sum;
  * the hill climb as a loop over per-channel state machines (probe
    order ss+d, ss-d, first+p, first-p with sign flips and the two-pass
    no-change exit), one probe for every channel still climbing per
    iteration, and one host read of "all done" per iteration;
  * the final absolute-rounded integrate-and-dump and gain scaling
    (trial_demod, symdemod.c:202-256).

As in the JAX package (its models/symdemod_tracked.py), the step size is
held at incr0 where the C recomputes it from the current estimate each
window (a drift of |k|·incr0/ss0, < 0.1 % over the grid); B = 1 keeps the
host tracker, which follows the C.  The JAX package computes this in jnp
with no Pallas kernel; here it is plain torch on the run device, and the
prefix sum comes from kernel K3, once a call.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.models.symdemod import (
    initial_firstsample,
    track_stats,
)
from isee3_decoder_tpu_torch.ops import symbols as sym_ops
from isee3_decoder_tpu_torch.ops.symbols import SymConfig
from isee3_decoder_tpu_torch.ops.syncword import argmax_first


class TrackTables(NamedTuple):
    """Host-built per-k edge tables (module docstring)."""

    flo: np.ndarray  # (2K, E) int32   floor(trial edge)
    up: np.ndarray  # (2K, E) int8    frac > .5
    tie: np.ndarray  # (2K, E) int8    frac == .5 (half-to-even by parity)
    srch: np.ndarray  # (2K, E) int32   rint relative switchpoints
    nsym: np.ndarray  # (2K,)   int32   int(window·fs / ss_k)
    ss: np.ndarray  # (2K,)   float64 ss_k (host bookkeeping)
    k_range: int
    nsym_max: int
    noff: int


class DeviceTables(NamedTuple):
    """TrackTables' tables on the run device: E = 2·c·nsym_max + 1
    columns a row, 10 bytes a column (int8 ``up`` and ``tie``)."""

    flo: torch.Tensor  # (2K, E) int32
    up: torch.Tensor  # (2K, E) int8
    tie: torch.Tensor  # (2K, E) int8
    srch: torch.Tensor  # (2K, E) int32
    nsym: torch.Tensor  # (2K,) int32

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


class TrackedWindow(NamedTuple):
    soft: torch.Tensor  # (B, nsym_max) uint8, 128 past each row's n
    n: torch.Tensor  # (B,) int32 symbols of the window at the final clock
    first: torch.Tensor  # (B,) int64 window start after the climb
    k: torch.Tensor  # (B,) int64 final grid index
    symphase: torch.Tensor  # (B,) int64 timing search's adjustment
    maxe: torch.Tensor  # (B,) float64 mean energy at the final point
    iterations: int  # climb iterations (one probe of every live channel)
    host_reads: int  # reads of "all done" from the device


@functools.lru_cache(maxsize=4)
def build_track_tables(cfg: SymConfig, k_range: int = 512) -> TrackTables:
    """The tables of the clock grid k in [-k_range, k_range) for ``cfg``
    (cached per configuration and range)."""
    ss0 = cfg.symbolsamples
    incr0 = 0.5 * ss0 / (cfg.window * cfg.samprate)
    # the grid by the SAME sequential accumulation the host/C tracker
    # performs (Symbolsamples += clock_incr per accepted probe): a
    # monotone climb of |k| steps lands on a bitwise-identical float64
    # clock, so the nearbyint edge tables match the host's.  ss0 + k·incr0
    # in one multiply is ~1 ulp off, which flips exact-.5 rounding ties
    # (1-byte soft divergences at clocks like 80.02)
    ss = np.empty(2 * k_range, np.float64)
    ss[k_range] = ss0
    for i in range(k_range + 1, 2 * k_range):
        ss[i] = ss[i - 1] + incr0
    for i in range(k_range - 1, -1, -1):
        ss[i] = ss[i + 1] - incr0
    nsym = (cfg.window * cfg.samprate / ss).astype(np.int64)
    nsym_max = int(nsym.max())
    c = cfg.symbolclocks
    E = 2 * c * nsym_max + 1
    flo = np.empty((2 * k_range, E), np.int32)
    up = np.empty((2 * k_range, E), np.int8)
    tie = np.empty((2 * k_range, E), np.int8)
    srch = np.empty((2 * k_range, E), np.int32)
    for i, s in enumerate(ss):
        half = (0.5 / c) * s
        rel = sym_ops.trial_edges(half, nsym_max, c)  # exact f64 cumsum
        f = np.floor(rel)
        frac = rel - f
        flo[i] = f.astype(np.int32)
        up[i] = (frac > 0.5).astype(np.int8)
        tie[i] = (frac == 0.5).astype(np.int8)
        srch[i] = sym_ops.search_edges(half, nsym_max, c).astype(np.int32)
    noff = int(ss0 / 2) + math.ceil(ss0 / 2)
    return TrackTables(
        flo=flo, up=up, tie=tie, srch=srch,
        nsym=nsym.astype(np.int32), ss=ss,
        k_range=k_range, nsym_max=nsym_max, noff=noff,
    )


def device_tables(t: TrackTables, device) -> DeviceTables:
    """Send the tables to ``device`` (one copy each)."""
    return DeviceTables(*(torch.as_tensor(a).to(device) for a in (
        t.flo, t.up, t.tie, t.srch, t.nsym)))


def tracked_window(
    csum: torch.Tensor,
    first: torch.Tensor,
    k: torch.Tensor,
    tables: DeviceTables,
    nsym_max: int,
    noff: int,
    symbolclocks: int,
    k_range: int,
) -> TrackedWindow:
    """One tracked window for every channel of the (B, L) int32 prefix
    sum ``csum``: timing search, hill climb, final demod, from each
    channel's start ``first`` (B,) and grid index ``k`` (B,) in
    [-k_range, k_range).

    Energies are float64 sums of squared int32 integrators: exact, in any
    summation order, while a channel's sum stays below 2^53 (integrators
    below ~2^21 at 2048 symbols), which leaves every accept (e > maxe) to
    the data, not to the card's reduction order.  Past that, only reads
    beyond the prefix sum's pad (INT32_MIN fills) reach, and the sums
    round as the order falls."""
    B = csum.shape[0]
    L = csum.shape[1]
    c = symbolclocks
    dev = csum.device
    first = first.to(device=dev, dtype=torch.int64)
    k = k.to(device=dev, dtype=torch.int64)
    sym_j = torch.arange(nsym_max, device=dev)[None, :]

    def trial_integ(kk, fs):
        """Absolute-rounded integrate-and-dump at grid clock kk from
        sample fs (trial_demod's rounding through the per-k tables)."""
        row = kk + k_range
        base = fs[:, None] + tables.flo[row].to(torch.int64)
        edges = (base + tables.up[row].to(torch.int64)
                 + tables.tie[row].to(torch.int64) * (base & 1))
        g = sym_ops.take_fill(csum, edges)
        seg = (g[:, 1:] - g[:, :-1]).reshape(B, nsym_max, c, 2)
        return (seg[..., 1] - seg[..., 0]).sum(dim=-1, dtype=torch.int32)

    def masked_energy(integ, kk):
        n = tables.nsym[kk + k_range]
        valid = sym_j < n[:, None]
        sq = torch.where(valid, integ.to(torch.float64) ** 2, 0.0)
        return sq.sum(dim=-1) / n.to(torch.float64)

    # ---------- window-start timing search (relative rounding) ----------
    # the JAX package slices noff prefix-sum entries from each switchpoint
    # (dynamic_slice): a start is clamped into [0, L - noff] so the slice
    # fits, the whole slice shifting, where a single index is not clamped
    off0 = -(noff // 2)
    base = first[:, None] + off0 + tables.srch[k + k_range].to(torch.int64)
    starts = base.clamp(0, L - noff)
    idx = starts[:, :, None] + torch.arange(noff, device=dev)
    V = csum.gather(1, idx.reshape(B, -1)).reshape(B, -1, noff)
    D = V[:, 1:] - V[:, :-1]
    D = D.reshape(B, nsym_max, c, 2, noff)
    # int64 over the clocks of a symbol, as jnp's sum of int32 under x64
    I = (D[..., 1, :] - D[..., 0, :]).sum(dim=2, dtype=torch.int64)
    n_b = tables.nsym[k + k_range]
    valid = (sym_j < n_b[:, None])[..., None]
    energy_o = (torch.where(valid, I.to(torch.float64) ** 2, 0.0).sum(dim=1)
                / n_b[:, None].to(torch.float64))  # (B, noff)
    del V, D, I
    best = argmax_first(energy_o, dim=-1)
    symphase = off0 + best
    first = first + symphase
    maxe = energy_o.gather(1, best[:, None])[:, 0]

    # ---------- hill climb (symdemod.c:133-174 state machine) ----------
    one = torch.ones(B, dtype=torch.int64, device=dev)
    dirn = one.clone()  # clock step sign
    pi = one.clone()  # phase step sign
    phase = torch.zeros(B, dtype=torch.int64, device=dev)  # next proposal
    fails = torch.zeros(B, dtype=torch.int64, device=dev)  # in this pass
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iterations = 0
    reads = 0
    while True:
        reads += 1
        if bool(done.all()):
            break
        iterations += 1
        clock_probe = phase < 2
        sign = torch.where((phase & 1) == 0, one, -one)
        k_prop = torch.where(clock_probe, k + sign * dirn, k).clamp(
            -k_range, k_range - 1)
        f_prop = torch.where(clock_probe, first, first + sign * pi)
        e = masked_energy(trial_integ(k_prop, f_prop), k_prop)
        accept = ~done & (e > maxe)
        # accepts of a downward proposal flip its step (ci = -ci, pi = -pi)
        flip = accept & (phase == 1)
        flip_p = accept & (phase == 3)
        k = torch.where(accept & clock_probe, k_prop, k)
        first = torch.where(accept & ~clock_probe, f_prop, first)
        dirn = torch.where(flip, -dirn, dirn)
        pi = torch.where(flip_p, -pi, pi)
        maxe = torch.where(accept, e, maxe)
        phase_next = torch.where(accept, 0, (phase + 1) % 4)
        fails_next = torch.where(accept, 0, fails + 1)
        # a full pass of four fails ends the climb (the C nochange < 2 exit)
        done_next = done | (~done & (phase == 3) & (fails_next >= 4))
        fails_next = torch.where(phase == 3, 0, fails_next)
        phase = torch.where(done, phase, phase_next)
        fails = torch.where(done, fails, fails_next)
        done = done_next

    # ---------- final demod (trial_demod with gain) ----------
    integ = trial_integ(k, first)
    n_f = tables.nsym[k + k_range]
    soft, _ = sym_ops.finish_demod(integ, 100.0 / torch.sqrt(maxe))
    soft = torch.where(sym_j < n_f[:, None], soft, 128).to(torch.uint8)
    return TrackedWindow(soft=soft, n=n_f, first=first, k=k,
                         symphase=symphase, maxe=maxe,
                         iterations=iterations, host_reads=reads)


def symdemod_tracked_batched(
    samples,
    cfg: SymConfig,
    nwindows: int,
    k_range: int = 512,
    device=None,
) -> tuple[np.ndarray, list[dict]]:
    """Batched -t demodulation of (B, L) int16 baseband on the card (or
    ``device``): all channels tracked at once, one ``tracked_window`` a
    window.  The tables go to the device once a call, the prefix sum is
    one launch of kernel K3.

    Returns (soft (B, total) uint8, rows right-padded with 128, and
    per-window info dicts whose array fields stack the channels), as
    models/symdemod.symdemod_tracked does; each window adds its climb
    iterations and host reads to models/symdemod.track_stats."""
    samples = _kernels.place(samples, device)
    if samples.ndim == 1:
        samples = samples[None, :]
    B = samples.shape[0]
    t = build_track_tables(cfg, k_range)
    csum = sym_ops.samples_csum(samples, sym_ops.track_pad(cfg) + t.noff)
    tables = device_tables(t, samples.device)

    first = np.full((B,), initial_firstsample(cfg), np.int64)
    k = np.zeros((B,), np.int64)
    streams = [[] for _ in range(B)]
    infos = []
    for w in range(nwindows):
        out = tracked_window(
            csum, torch.as_tensor(first), torch.as_tensor(k), tables,
            t.nsym_max, t.noff, cfg.symbolclocks, t.k_range)
        # six reads of the window's results
        soft, n_f, first, k, symphase, maxe = (
            x.cpu().numpy() for x in (out.soft, out.n, out.first, out.k,
                                      out.symphase, out.maxe))
        track_stats["iterations"].append(out.iterations)
        track_stats["host_reads"].append(out.host_reads + 6)
        for b in range(B):
            streams[b].append(soft[b, : n_f[b]])
        ss = t.ss[k + t.k_range]
        infos.append(dict(
            window=w,
            symbolsamples=ss.copy(),
            symrate=cfg.samprate / ss,
            firstsample=first.copy(),
            energy=maxe.copy(),
            symphase=symphase.copy(),
        ))
        # the next window's start (C truncation of the float64 sum)
        first = np.trunc(first.astype(np.float64) + n_f * ss).astype(np.int64)

    rows = [np.concatenate(s) for s in streams]
    total = max(r.size for r in rows)
    out_soft = np.full((B, total), 128, np.uint8)
    for b, r in enumerate(rows):
        out_soft[b, : r.size] = r
    return out_soft, infos
