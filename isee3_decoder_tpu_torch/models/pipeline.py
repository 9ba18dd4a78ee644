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

With ``PipelineConfig(pm_backend="fused_scan")``, steps 1-2 are one
launch of kernel K9 after the cold-start block (ops/carrier.
pm_demod_scan_csum): it carries the lock state from block to block and
writes the prefix sum, and the host reads one flag per call instead of
one scalar per pm block.

``receive_block_wideband`` puts the polyphase channelizer in front: one
wide capture → ops/channelizer_cuda.channelize_raw_fused (kernel K7a) →
per-channel raw int16 → the same chain.  ``receive_blocks_pipelined``
drives ``receive_block`` over a stream of blocks with the result fetches
overlapped.

``receive_stream`` is the streaming form, the reference's three
while(1) processes (pmdemod.c:204, symdemod.c:96, decode.c:149): one
chunk of a long recording a call, with the state those processes keep in
memory carried in a ``ChainCarry`` (pm lock, IQ remainder, baseband
window, symbol timing, soft symbols, decode lock), which
utils/checkpoint saves and restores.  Per chunk: ops/carrier.
pm_demod_scan (K1, K2) on whole pm blocks, models/symdemod.symdemod_scan
(prefix sum by K3), models/decode.decode_stream (K4; K5/K6 for the
Viterbi fallback).
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
    DecodeStreamState,
    FrameRecord,
    _finish,
    decode_block_device,
    decode_stream,
)
from isee3_decoder_tpu_torch.models.symdemod import (
    initial_firstsample,
    symdemod_scan,
    symdemod_scan_csum,
    window_samples,
)
from isee3_decoder_tpu_torch.ops.carrier import (
    PMCarry,
    PMConfig,
    _scan_fused_capable,
    init_carry,
    iq_from_interleaved,
    pm_demod_scan,
    pm_demod_scan_csum,
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
from isee3_decoder_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    pm: PMConfig = PMConfig()
    sym: SymConfig = SymConfig()
    decode: DecodeConfig = DecodeConfig()
    #: pm time-loop form: "auto" runs the block scan (K1 per locked block)
    #: and then the prefix sum (K3); "fused_scan" runs blocks 1..T-1 in one
    #: launch of K9, which emits the prefix sum itself, where
    #: carrier._scan_fused_capable allows (raw input, T >= 2, no Doppler
    #: rate, blocks a multiple of 8192 samples), else as "auto"
    pm_backend: str = "auto"


class PipelineResult(NamedTuple):
    frames: list[FrameRecord]
    soft_symbols: np.ndarray  # (B, S)
    baseband: np.ndarray  # (B, L) int16
    carrier_freq: np.ndarray  # (T, B)
    cn0: np.ndarray  # (T, B)


def _demod(iq: torch.Tensor, cfg: PipelineConfig):
    """(B, L) complex IQ — or (B, 2L) int16 interleaved I,Q, the
    reference's recording format (pmdemod.c:206-230) — → ((B, S) uint8
    soft symbols, (B, T·n + 1) int32 prefix sum of the baseband whose last
    column holds the total, carrier_freq (T, B), cn0 (T, B), and the
    (T, B, n) int16 baseband — None on the fused scan, which never
    writes it).  Trailing partial blocks are dropped as the reference's
    fread loops do (pmdemod.c:210-215, symdemod.c:124-125); one window of
    slack is left for the ± timing search."""
    if cfg.pm_backend not in ("auto", "fused_scan"):
        raise ValueError("pm_backend must be 'auto' or 'fused_scan', got "
                         f"{cfg.pm_backend!r}")
    if iq.ndim == 1:
        iq = iq[None, :]
    B = iq.shape[0]
    n = cfg.pm.fftsize
    vals = n if iq.is_complex() else 2 * n  # values per pm block
    nblocks = iq.shape[1] // vals
    blocks = iq[:, : nblocks * vals].reshape(B, nblocks, vals)
    first0 = initial_firstsample(cfg.sym)
    nwindows = max((nblocks * n - first0) // window_samples(cfg.sym) - 1, 0)
    carry = init_carry(B, cfg.pm, device=iq.device)

    # the csum's edge-extension column stands in for the window slack the
    # JAX package's fused scan requires (_fused_csum_ok)
    if (cfg.pm_backend == "fused_scan" and not iq.is_complex()
            and nwindows >= 1 and _scan_fused_capable(cfg.pm, n, nblocks)):
        _, csum, stats, _ = pm_demod_scan_csum(carry, blocks, cfg.pm, tail=1)
        baseband, freq, cn0 = None, stats.carrier_freq, stats.cn0
    else:
        _, pm_out = pm_demod_scan(carry, blocks, cfg.pm)
        # one edge-extension column: the timing search of the last window
        # may read past the final sample
        csum = prefix_sum_blocks(pm_out.baseband, tail=1)
        baseband, freq, cn0 = pm_out.baseband, pm_out.carrier_freq, pm_out.cn0
    _, sym_out = symdemod_scan_csum(csum, cfg.sym, nwindows)
    soft = sym_out.soft.transpose(0, 1).reshape(B, -1)
    return soft, csum, freq, cn0, baseband


def demod_to_symbols(
    iq: torch.Tensor, cfg: PipelineConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """IQ → ((B, S) soft symbols, (B, L) int16 baseband, carrier_freq
    (T, B), cn0 (T, B)).  On the fused scan the baseband is rebuilt from
    the prefix sum's differences."""
    soft, csum, freq, cn0, bb = _demod(iq, cfg)
    if bb is None:
        baseband = (csum[:, 1:] - csum[:, :-1]).to(torch.int16)
    else:
        T, B, n = bb.shape
        baseband = bb.transpose(0, 1).reshape(B, T * n)
    return soft, baseband, freq, cn0


def receive_block_device_soft(
    iq: torch.Tensor,
    nframes: int,
    npos: int,
    cfg: PipelineConfig = PipelineConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """The device part of the chain: IQ → (packed decode buffer, soft
    symbols), both on the IQ's device.  The soft symbols stay there so
    the host tail gathers only the failed lanes' frame windows."""
    profiling.count("driver/blocks")
    soft = _demod(iq, cfg)[0]
    return decode_block_device(soft, nframes, npos, cfg.decode), soft


def receive_block_device(
    iq: torch.Tensor,
    nframes: int,
    npos: int,
    cfg: PipelineConfig = PipelineConfig(),
) -> torch.Tensor:
    """The device part of the chain, buffer only: IQ → the packed decode
    buffer (models/decode.decode_block_device layout) on the IQ's
    device."""
    return receive_block_device_soft(iq, nframes, npos, cfg)[0]


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


class ChainCarry(NamedTuple):
    """The streaming chain's state between calls: what the reference's
    three while(1) loops keep in process memory (pmdemod.c:204,
    symdemod.c:96, decode.c:149).  Tensors lie on the run device;
    utils/checkpoint saves and restores the whole carry."""

    pm: PMCarry  # carrier estimate and lock
    iq_rem: torch.Tensor  # (B, r) IQ values short of a whole pm block
    bb: torch.Tensor  # (B, l) int16 baseband not yet consumed, contiguous
    bb_base: int  # absolute sample index of bb[:, 0] (kept even)
    bb_total: int  # baseband samples produced so far
    first: torch.Tensor  # (B,) int64 absolute symbol-timing position
    windows_done: int  # symdemod windows emitted so far
    soft: torch.Tensor  # (B, s) uint8 soft symbols not yet consumed
    soft_base: int  # absolute symbol index of soft[:, 0]
    dec: DecodeStreamState  # decode lock and positions (host)


def init_chain_carry(batch: int, cfg: PipelineConfig = PipelineConfig(),
                     device=None) -> ChainCarry:
    """A fresh carry for ``batch`` channels on the run device (the card
    unless ``device`` names another)."""
    dev = _kernels.run_device(device)
    return ChainCarry(
        pm=init_carry(batch, cfg.pm, device=dev),
        iq_rem=torch.zeros((batch, 0), dtype=torch.int16, device=dev),
        bb=torch.zeros((batch, 0), dtype=torch.int16, device=dev),
        bb_base=0,
        bb_total=0,
        first=torch.full((batch,), initial_firstsample(cfg.sym),
                         dtype=torch.int64, device=dev),
        windows_done=0,
        soft=torch.zeros((batch, 0), dtype=torch.uint8, device=dev),
        soft_base=0,
        dec=DecodeStreamState(batch),
    )


def chain_carry_template(manifest: dict, cfg: PipelineConfig = PipelineConfig(),
                         device=None) -> ChainCarry:
    """A fresh carry of the checkpointed one's shapes, to restore it onto
    (utils/checkpoint.restore_pytree): ``manifest`` is the checkpoint's
    (utils/checkpoint.load_manifest).  The buffers whose length varies
    from chunk to chunk (iq_rem, bb, soft) take their saved lengths, and
    iq_rem its saved type (int16 or complex64); restore_pytree checks
    every other leaf against init_chain_carry's."""
    saved = {m["path"]: m for m in manifest["leaves"]}
    if not {".first", ".iq_rem", ".bb", ".soft"} <= saved.keys():
        raise ValueError("the checkpoint holds no ChainCarry")
    carry = init_chain_carry(saved[".first"]["shape"][0], cfg, device)

    def buffer(name: str, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros(saved[name]["shape"], dtype=dtype,
                           device=carry.bb.device)

    return carry._replace(
        iq_rem=buffer(".iq_rem", getattr(torch, saved[".iq_rem"]["dtype"])),
        bb=buffer(".bb", torch.int16),
        soft=buffer(".soft", torch.uint8),
    )


def receive_stream(
    iq,
    cfg: PipelineConfig = PipelineConfig(),
    carry: ChainCarry | None = None,
    trim: bool = True,
    device=None,
) -> tuple[list[FrameRecord], ChainCarry]:
    """Process one chunk of a long recording, carrying the chain's state:
    consecutive calls on consecutive chunks give the soft symbols and
    frames of one call on the whole recording, with no re-acquisition at
    chunk boundaries.  ``iq`` is (B, 2r) int16 interleaved I,Q or (B, r)
    complex; frame ``start_symbol`` values are absolute symbol indices of
    the stream.  ``trim=False`` keeps every soft symbol in the carry.

    Runs on the carry's device (a new carry: the card unless ``device``
    names another)."""
    if carry is None:
        iq = _kernels.place(iq, device)
        carry = init_chain_carry(1 if iq.ndim == 1 else iq.shape[0], cfg,
                                 device=iq.device)
    iq = _kernels.place(iq, carry.bb.device)
    if iq.ndim == 1:
        iq = iq[None, :]
    B = iq.shape[0]
    n = cfg.pm.fftsize
    blockvals = n if iq.is_complex() else 2 * n  # values per pm block

    # ---- pmdemod: whole pm blocks; the remainder carries over
    stream = torch.cat([carry.iq_rem.to(iq.dtype), iq], dim=1)
    nblocks = stream.shape[1] // blockvals
    iq_rem = stream[:, nblocks * blockvals:].contiguous()
    pm_carry, bb, bb_total = carry.pm, carry.bb, carry.bb_total
    if nblocks:
        blocks = stream[:, : nblocks * blockvals].reshape(B, nblocks, blockvals)
        pm_carry, pm_out = pm_demod_scan(pm_carry, blocks, cfg.pm)
        new_bb = pm_out.baseband.transpose(0, 1).reshape(B, nblocks * n)
        bb = torch.cat([bb, new_bb], dim=1)
        bb_total += nblocks * n

    # ---- symdemod: the one-shot window count (demod_to_symbols) applied
    # to the stream so far
    wlen = window_samples(cfg.sym)
    first0 = initial_firstsample(cfg.sym)
    target = max((bb_total - first0) // wlen - 1, 0)
    nwin = target - carry.windows_done
    first, soft, bb_base = carry.first, carry.soft, carry.bb_base
    if nwin > 0:
        first_rel = first - bb_base
        if int(first_rel.min()) < 0:
            raise RuntimeError("receive_stream: symbol timing before the "
                               "carried baseband")
        _, sym_out = symdemod_scan(bb, cfg.sym, nwin, first_rel)
        soft = torch.cat([soft, sym_out.soft.transpose(0, 1).reshape(B, -1)],
                         dim=1)
        # advance the timing past the last window with the C truncation
        # walk of the double sum (symdemod.c:192)
        last_first = sym_out.firstsample[-1] + bb_base
        first = torch.trunc(
            last_first.to(torch.float64)
            + cfg.sym.nsymbols * cfg.sym.symbolsamples).to(torch.int64)
        # purge consumed baseband (symdemod.c:101-112 slide, with the
        # reference's 2-symbol lookback slop)
        keep_from = int(first.min()) - 2 * int(cfg.sym.symbolsamples) - 8
        slide = max(min(keep_from - bb_base, bb.shape[1]), 0)
        # round-half-to-even (nearbyint, symdemod.c:217) is invariant only
        # under EVEN shifts: keep bb_base even so edges relative to the
        # buffer round as the absolute ones do
        slide &= ~1
        bb = bb[:, slide:].contiguous()  # K3 takes contiguous rows
        bb_base += slide

    # ---- decode: the stream walk with the carried lock and position
    dec = carry.dec
    records, dec = decode_stream(soft, cfg.decode, dec, device=soft.device)
    records = [r._replace(start_symbol=r.start_symbol + carry.soft_base)
               for r in records]
    soft_base = carry.soft_base
    if trim:
        cut = int(dec.pos.min())
        if cut > 0:
            soft = soft[:, cut:].contiguous()
            dec.pos = dec.pos - cut
            soft_base += cut

    out = ChainCarry(
        pm=pm_carry,
        iq_rem=iq_rem,
        bb=bb,
        bb_base=bb_base,
        bb_total=bb_total,
        first=first,
        windows_done=target if nwin > 0 else carry.windows_done,
        soft=soft,
        soft_base=soft_base,
        dec=dec,
    )
    return records, out


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
        # on the CPU the buffer is the host's already: nothing to wait for
        profiling.read("driver/fetch", host if event is None else event)
        return _finish(host.numpy(), soft, B, nframes, cfg.decode)

    depth = max(depth, 1)
    ring: list[torch.Tensor | None] = [None] * (depth + 1)
    pending: collections.deque = collections.deque()
    for n, iq in enumerate(iq_blocks):
        with profiling.span("driver/submit", n):
            iq = _kernels.place(iq, device)
            if iq.ndim == 1:
                iq = iq[None, :]
            buf, soft = receive_block_device_soft(iq, nframes, npos, cfg)
            if buf.is_cuda:
                slot = n % (depth + 1)
                if ring[slot] is None or ring[slot].shape != buf.shape:
                    with profiling.span("driver/pin_ring"):
                        ring[slot] = torch.empty_like(buf, device="cpu",
                                                      pin_memory=True)
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
