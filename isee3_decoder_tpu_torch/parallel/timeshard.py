"""Time-axis (sequence-parallel) sharding of the demod path (the port of
isee3_decoder_tpu/parallel/timeshard.py).

A long recording's time axis is split across devices, each shard with an
overlap-save halo of leading samples, so that its windows see the data
the sequential pipeline's windows see.  The carrier and timing loops
re-acquire inside each shard's halo: after the ramp-up a shard's windows
match the sequential pipeline's at the same absolute sample positions
(up to ±1 symbol of timing-phase seam on noisy signals), and frame sync
downstream absorbs the seams as it absorbs any loss of lock.

All shard arithmetic is in whole symdemod windows: chunk and halo are
multiples of window_samples, so shard windows land on sequential window
boundaries.  Shard s runs ``demod_to_symbols`` on the device of mesh
slot s (round robin), one shard after another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from isee3_decoder_tpu_torch.models.pipeline import PipelineConfig, demod_to_symbols
from isee3_decoder_tpu_torch.models.symdemod import window_samples
from isee3_decoder_tpu_torch.parallel.mesh import Mesh
from isee3_decoder_tpu_torch.parallel.sharding import on_device


@dataclasses.dataclass(frozen=True)
class TimeShardPlan:
    """How a (B, L) recording splits into time shards (window units)."""

    nshards: int
    chunk_windows: int  # payload windows per shard
    halo_windows: int  # leading ramp-up windows per shard
    window_len: int  # samples per window

    @property
    def chunk(self) -> int:
        return self.chunk_windows * self.window_len

    @property
    def shard_len(self) -> int:
        # +2 windows of slack: demod_to_symbols drops one trailing
        # window for the timing-search margin
        return (self.chunk_windows + self.halo_windows + 2) * self.window_len


def plan_time_shards(
    total_samples: int, nshards: int, cfg: PipelineConfig
) -> TimeShardPlan:
    """Halo: enough windows to cover carrier and timing re-acquisition
    (one FFT block and one full window), rounded up to whole windows."""
    wlen = window_samples(cfg.sym)
    if wlen % cfg.pm.fftsize:
        raise ValueError("window length must be a whole number of FFT "
                         "blocks for aligned time sharding")
    halo_w = 1 + (cfg.pm.fftsize + wlen - 1) // wlen
    total_w = total_samples // wlen
    chunk_w = max((total_w - halo_w - 2) // nshards, 1)
    return TimeShardPlan(
        nshards=nshards,
        chunk_windows=chunk_w,
        halo_windows=halo_w,
        window_len=wlen,
    )


def shard_views(iq: np.ndarray, plan: TimeShardPlan) -> np.ndarray:
    """(B, L) → (nshards, B, shard_len) overlapping copies.

    Shard s > 0 starts ``halo`` windows before its payload, so its window
    h + j is absolute window s·chunk_windows + j; shard 0 starts at
    sample 0 (its payload begins at window 0, no ramp-up needed)."""
    iq = np.asarray(iq)
    if iq.ndim == 1:
        iq = iq[None, :]
    B = iq.shape[0]
    halo = plan.halo_windows * plan.window_len
    if plan.chunk < halo and plan.nshards > 1:
        raise ValueError("chunk smaller than halo")
    out = np.zeros((plan.nshards, B, plan.shard_len), iq.dtype)
    for s in range(plan.nshards):
        start = max(s * plan.chunk - halo, 0)
        seg = iq[:, start : start + plan.shard_len]
        out[s, :, : seg.shape[1]] = seg
    return out


def demod_time_sharded(
    iq: np.ndarray,
    cfg: PipelineConfig,
    mesh: Mesh,
    nshards: int | None = None,
    axis: str = "ch",
) -> tuple[np.ndarray, TimeShardPlan]:
    """Demodulate a long recording with its time axis sharded over the
    mesh's ``axis``.  Returns (soft (nshards, B, S_shard) uint8, plan):
    shard s's window w covers absolute samples s·chunk + w·window_len."""
    iq = np.asarray(iq)
    if iq.ndim == 1:
        iq = iq[None, :]
    devs = mesh.devices[:, 0] if axis == "ch" else mesh.devices[0, :]
    n = mesh.shape[axis] if nshards is None else nshards
    plan = plan_time_shards(iq.shape[-1], n, cfg)
    soft = []
    for s, view in enumerate(shard_views(iq, plan)):
        dev = devs[s % len(devs)]
        with on_device(dev):
            soft.append(demod_to_symbols(torch.as_tensor(view).to(dev),
                                         cfg)[0].cpu().numpy())
    return np.stack(soft), plan


def stitch_shards(soft: np.ndarray, plan: TimeShardPlan,
                  cfg: PipelineConfig) -> np.ndarray:
    """Concatenate the shards' payload windows: shard 0 gives windows
    [0, chunk_windows), shard s > 0 windows [halo_windows, halo_windows +
    chunk_windows)."""
    nshards = soft.shape[0]
    nsym = cfg.sym.nsymbols
    h, c = plan.halo_windows, plan.chunk_windows
    parts = [soft[0, :, : c * nsym]]
    for s in range(1, nshards):
        parts.append(soft[s, :, h * nsym : (h + c) * nsym])
    return np.concatenate(parts, axis=-1)
