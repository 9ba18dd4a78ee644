"""Receive chain: pmdemod → prefix sum → symdemod → block decode.

The reference composes its stages as a UNIX pipeline of byte streams
(README.txt:9); here they compose as functions over a (channels, time)
batch of tensors on one device.  ``receive_block`` is the main path:

  1. ops/carrier.pm_demod_scan — kernel K1 for every locked block,
     torch.fft search + kernel K2 for cold-start / unlocked blocks;
  2. ops/prefix_cuda.prefix_sum_blocks — kernel K3, (T, B, n) int16
     baseband → (B, T·n + 1) int32 exclusive prefix sum;
  3. models/symdemod.symdemod_scan_csum — uint8 soft symbols;
  4. models/decode.decode_block_device — sync search, quicklook, QLEC,
     tier-1 Fano walk (kernel K4), one packed buffer;
  5. on the host: tier-2 Fano re-run (kernel K4) of lanes that ran out
     of cycles, then the fused Viterbi (kernels K5/K6) on every lane
     still undecoded (models/decode.viterbi_fallback_inplace).

``receive_block_wideband`` puts the polyphase channelizer in front: one
wide capture → ops/channelizer_cuda.channelize_raw_fused (kernel K7a) →
per-channel raw int16 → the same chain.  ``receive_blocks_pipelined``
drives ``receive_block`` over a stream of blocks with the result fetches
overlapped.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import FRAMESYMBOLS
from isee3_decoder_tpu_torch.models.decode import (
    DecodeConfig,
    FrameRecord,
    _finish,
    decode_block_device,
    decode_stream,
)
from isee3_decoder_tpu_torch.models.symdemod import (
    initial_firstsample,
    symdemod_scan_csum,
    window_samples,
)
from isee3_decoder_tpu_torch.ops.carrier import (
    PMBlockOut,
    PMConfig,
    init_carry,
    iq_from_interleaved,
    pm_demod_scan,
)
from isee3_decoder_tpu_torch.ops.channelizer import channelize
from isee3_decoder_tpu_torch.ops.channelizer_cuda import (
    channelize_raw_fused,
    quantize_raw,
    supports as fused_channelizer_supports,
    unpack_wide,
)
from isee3_decoder_tpu_torch.ops.prefix_cuda import prefix_sum_blocks
from isee3_decoder_tpu_torch.ops.symbols import SymConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    pm: PMConfig = PMConfig()
    sym: SymConfig = SymConfig()
    decode: DecodeConfig = DecodeConfig()


class PipelineResult(NamedTuple):
    frames: list[FrameRecord]
    soft_symbols: np.ndarray  # (B, S)
    baseband: np.ndarray  # (B, L) int16
    carrier_freq: np.ndarray  # (T, B)
    cn0: np.ndarray  # (T, B)


def _demod(iq: torch.Tensor, cfg: PipelineConfig
           ) -> tuple[torch.Tensor, PMBlockOut]:
    """(B, L) complex IQ — or (B, 2L) int16 interleaved I,Q, the
    reference's recording format (pmdemod.c:206-230) — → ((B, S) uint8
    soft symbols, pm scan outputs).  Trailing partial blocks are dropped
    as the reference's fread loops do (pmdemod.c:210-215,
    symdemod.c:124-125); one window of slack is left for the ± timing
    search."""
    if iq.ndim == 1:
        iq = iq[None, :]
    B = iq.shape[0]
    n = cfg.pm.fftsize
    vals = n if iq.is_complex() else 2 * n  # values per pm block
    nblocks = iq.shape[1] // vals
    blocks = iq[:, : nblocks * vals].reshape(B, nblocks, vals)
    first0 = initial_firstsample(cfg.sym)
    nwindows = max((nblocks * n - first0) // window_samples(cfg.sym) - 1, 0)

    _, pm_out = pm_demod_scan(init_carry(B, cfg.pm, device=iq.device), blocks,
                              cfg.pm)
    # one edge-extension column: the timing search of the last window may
    # read past the final sample
    csum = prefix_sum_blocks(pm_out.baseband, tail=1)
    _, sym_out = symdemod_scan_csum(csum, cfg.sym, nwindows)
    soft = sym_out.soft.transpose(0, 1).reshape(B, -1)
    return soft, pm_out


def demod_to_symbols(
    iq: torch.Tensor, cfg: PipelineConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """IQ → ((B, S) soft symbols, (B, L) int16 baseband, carrier_freq
    (T, B), cn0 (T, B))."""
    soft, pm_out = _demod(iq, cfg)
    T, B, n = pm_out.baseband.shape
    baseband = pm_out.baseband.transpose(0, 1).reshape(B, T * n)
    return soft, baseband, pm_out.carrier_freq, pm_out.cn0


def receive_block_device_soft(
    iq: torch.Tensor,
    nframes: int,
    npos: int,
    cfg: PipelineConfig = PipelineConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """The device part of the chain: IQ → (packed decode buffer, soft
    symbols), both on the IQ's device.  The soft symbols stay there so
    the host tail gathers only the failed lanes' frame windows."""
    soft, _ = _demod(iq, cfg)
    return decode_block_device(soft, nframes, npos, cfg.decode), soft


def _finish_block(
    buf_dev: torch.Tensor, soft_dev: torch.Tensor, B: int, nframes: int,
    cfg: PipelineConfig,
) -> tuple[FrameRecord, np.ndarray]:
    """Fetch the packed decode buffer and run the host tail (tier-2 Fano
    re-run, Viterbi fallback) on failed lanes."""
    return _finish(buf_dev.cpu().numpy(), soft_dev, B, nframes, cfg.decode)


def receive_block(
    iq,
    nframes: int,
    cfg: PipelineConfig = PipelineConfig(),
    npos: int | None = None,
    device=None,
) -> tuple[FrameRecord, np.ndarray]:
    """Receive one block: IQ → (FrameRecord with batch axis B*nframes,
    sync_start (B,)).  A CUDA tensor runs where it lies; any other input
    goes to the card unless ``device="cpu"`` is passed."""
    iq = _kernels.place(iq, device)
    if iq.ndim == 1:
        iq = iq[None, :]
    if npos is None:
        npos = FRAMESYMBOLS
    buf_dev, soft_dev = receive_block_device_soft(iq, nframes, npos, cfg)
    return _finish_block(buf_dev, soft_dev, iq.shape[0], nframes, cfg)


def run_pipeline(iq, cfg: PipelineConfig = PipelineConfig(),
                 device=None) -> PipelineResult:
    """End to end: IQ in, decoded frames out (the full
    ``pmdemod | symdemod | decode`` chain, stream decode)."""
    iq = _kernels.place(iq, device)
    soft, baseband, freq, cn0 = demod_to_symbols(iq, cfg)
    frames, _ = decode_stream(soft, cfg.decode, device=soft.device)
    return PipelineResult(
        frames=frames,
        soft_symbols=soft.cpu().numpy(),
        baseband=baseband.cpu().numpy(),
        carrier_freq=freq.cpu().numpy(),
        cn0=cn0.cpu().numpy(),
    )


def run_wideband(
    iq_wide,
    samprate: float,
    nchan: int,
    channels: list[int] | None = None,
    cfg: PipelineConfig | None = None,
    taps_per_branch: int = 8,
    device=None,
) -> PipelineResult:
    """Wideband capture → channelize → per-channel receive chain.

    Args:
      iq_wide: (L,) complex wideband samples at ``samprate``.
      nchan: polyphase channel count (per-channel rate samprate/nchan).
      channels: channel indices to demodulate (default: all).
      cfg: pipeline config for the channel rate; defaults to the
        standard 512 bps config at samprate/nchan."""
    fs_out = samprate / nchan
    if cfg is None:
        cfg = PipelineConfig(
            pm=PMConfig(samprate=fs_out, binsize=4.0, search_width=200.0),
            sym=SymConfig(samprate=fs_out),
        )
    y = channelize(_kernels.place(iq_wide, device), nchan, taps_per_branch)[0]
    if channels is not None:
        y = y[channels]
    return run_pipeline(y, cfg, device=y.device)


def wideband_raw(wide: torch.Tensor, nchan: int,
                 taps_per_branch: int = 8) -> torch.Tensor:
    """The wideband front end: one capture → (nchan, 2·nout) int16
    per-channel raw, the recording format the chain ingests.

    ``wide`` is (M·L,) int32 packed IQ (I low half, Q high half of each
    word), (2·M·L,) int16 interleaved I,Q, or (M·L,) complex64.  Packed
    input at a channel count the fused channelizer takes goes through it
    (kernel K7a on a CUDA tensor); every other form or count through the
    plain bank and trunc∘clip.  ``_kernels.backend_used["channelizer"]``
    says which ran."""
    if wide.dtype == torch.int32 and fused_channelizer_supports(nchan):
        return channelize_raw_fused(wide, nchan, taps_per_branch)
    if wide.dtype == torch.int32:
        wide = unpack_wide(wide)
    elif not wide.is_complex():
        wide = iq_from_interleaved(wide[: wide.shape[0] // 2 * 2])
    _kernels.note_backend("channelizer", "torch")
    return quantize_raw(channelize(wide, nchan, taps_per_branch)[0])


def receive_wideband_device_soft(
    wide: torch.Tensor,
    nchan: int,
    nframes: int,
    npos: int,
    cfg: PipelineConfig = PipelineConfig(),
    taps_per_branch: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ONE wideband capture → polyphase channelizer → the per-channel
    receive chain, all on the capture's device.  ``nchan`` is the channel
    count M; the per-channel rate is cfg.pm.samprate.  Returns (packed
    decode buffer for B = nchan, (nchan, S) soft symbols)."""
    raw = wideband_raw(wide, nchan, taps_per_branch)
    return receive_block_device_soft(raw, nframes, npos, cfg)


def receive_block_wideband(
    wide,
    nchan: int,
    nframes: int,
    cfg: PipelineConfig = PipelineConfig(),
    npos: int | None = None,
    taps_per_branch: int = 8,
    device=None,
) -> tuple[FrameRecord, np.ndarray]:
    """Receive one wideband block: capture → (FrameRecord with batch axis
    nchan*nframes, sync_start (nchan,)).  A CUDA tensor runs where it
    lies; any other input goes to the card unless ``device="cpu"``."""
    wide = _kernels.place(wide, device)
    if npos is None:
        npos = FRAMESYMBOLS
    buf_dev, soft_dev = receive_wideband_device_soft(
        wide, nchan, nframes, npos, cfg, taps_per_branch)
    return _finish_block(buf_dev, soft_dev, nchan, nframes, cfg)


def receive_blocks_pipelined(
    iq_blocks,
    nframes: int,
    cfg: PipelineConfig = PipelineConfig(),
    npos: int | None = None,
    depth: int = 2,
    device=None,
):
    """Pipelined receive chain: a generator over an iterable of
    (B, L) IQ blocks that yields (FrameRecord, sync_start) per block, in
    order.

    Up to ``depth`` blocks' device work is queued ahead of the oldest
    block's result fetch.  Each block's packed decode buffer is copied to
    pinned host memory without blocking, with an event recorded behind
    the copy; the fetch waits on that event alone, so it returns as soon
    as its own block is done, whatever was queued after it.  The pinned
    buffers are a ring of depth + 1, allocated as the first blocks arrive
    and reused from then on (pinning memory synchronizes the device; the
    records hold copies, so a buffer is free once its block is yielded).
    The soft symbols stay on the device for the host tail.

    Each unit of depth keeps one more block's IQ, soft symbols and result
    buffer on the device: lower the depth before the block length when
    device memory runs short."""
    if npos is None:
        npos = FRAMESYMBOLS

    def finish(host, event, soft, B):
        if event is not None:
            event.synchronize()
        return _finish(host.numpy(), soft, B, nframes, cfg.decode)

    depth = max(depth, 1)
    ring: list[torch.Tensor | None] = [None] * (depth + 1)
    pending: collections.deque = collections.deque()
    for n, iq in enumerate(iq_blocks):
        iq = _kernels.place(iq, device)
        if iq.ndim == 1:
            iq = iq[None, :]
        buf, soft = receive_block_device_soft(iq, nframes, npos, cfg)
        if buf.is_cuda:
            slot = n % (depth + 1)
            if ring[slot] is None or ring[slot].shape != buf.shape:
                ring[slot] = torch.empty_like(buf, device="cpu", pin_memory=True)
            host = ring[slot]
            host.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(buf.device))
        else:
            host, event = buf, None
        pending.append((host, event, soft, iq.shape[0]))
        if len(pending) > depth:
            yield finish(*pending.popleft())
    while pending:
        yield finish(*pending.popleft())
