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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import FRAMESYMBOLS
from isee3_decoder_tpu_torch.models.decode import (
    DecodeConfig,
    FrameRecord,
    _finish,
    decode_block_device,
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
    pm_demod_scan,
)
from isee3_decoder_tpu_torch.ops.prefix_cuda import prefix_sum_blocks
from isee3_decoder_tpu_torch.ops.symbols import SymConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    pm: PMConfig = PMConfig()
    sym: SymConfig = SymConfig()
    decode: DecodeConfig = DecodeConfig()


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
