"""The one traffic generator: a cell's file of parameters and a seed →
a pool of distinct blocks of raw int16 IQ on the device.

The waveforms are frozen copies of the receive chain's own synthesis
(utils/devicesignal.synthesize_iq_device and to_raw_int16, and
chip_smoke.py's mode_symbols and mode_capture), so a later change to
the program cannot move the yardstick.  Two forms, chosen by the
cell's ``"signal"``:

- ``"cyclic"``: each channel sends its own ``frames_sent`` frames as a
  symbol stream repeated to fill the block, phase in float32 (the
  512 bps bench block);
- ``"lead"``: ``lead_symbols`` random symbols, the frames, random
  filler, Manchester-coded on ``symbolclocks`` subcarrier cycles a
  symbol, phase in float64 cycles reduced mod 1, made one channel at a
  time (the 16 bps subcarrier mode's 194 s block).

Every seed gives the same sizes; only the frame bytes and the noise
draw change.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from reference.codec import (
    FRAMESYMBOLS,
    MCQLI24,
    SYNC_STATE,
    bytes_to_bits,
    encode_bits,
    frames_to_symbols,
    random_frames,
)


@dataclasses.dataclass
class Pool:
    """The cell's distinct blocks and what each channel of each sent."""

    blocks: list  # of (channels, 2·nsamples) int16 tensors on the device
    frames: list  # of (channels, frames_sent, 128) uint8 arrays
    nsamples: int  # complex samples a channel a block
    lead_symbols: int  # sent symbols before the first frame
    seconds: float  # recording seconds a channel a block

    @property
    def channels(self) -> int:
        return self.blocks[0].shape[0]


def block_samples(cfg: dict, cell: dict) -> int:
    """Complex samples a channel a block, as the repo's benches size
    them: ``"cyclic"`` sends frames_sent frames and ``slack_symbols`` of
    slack; ``"lead"`` sends windows enough for the lead and the frames,
    one window of slack and half a symbol, in whole pm blocks."""
    sps = cfg["samprate"] / cfg["symrate"]
    if cell["signal"] == "cyclic":
        seconds = (cell["frames_sent"] * FRAMESYMBOLS + cell["slack_symbols"]) / cfg["symrate"]
        return int(seconds * cfg["samprate"])
    nsym = int(cfg["window"] * cfg["symrate"])
    wlen = int(cfg["window"] * cfg["samprate"])
    n = fftsize(cfg)
    need = -(-(cell["lead_symbols"] + cell["frames_sent"] * FRAMESYMBOLS) // nsym)
    want = (need + 1) * wlen + int(sps / 2)
    return -(-want // n) * n


def fftsize(cfg: dict) -> int:
    """pmdemod.c:129-131: 2^round(log2(samprate / binsize))."""
    return 1 << int(np.rint(np.log2(cfg["samprate"] / cfg["binsize"])))


def sub_seed(seed: int, block: int, what: int) -> int:
    return (seed * 1_000_003 + block * 7919 + what) % (1 << 63)


def make_pool(cfg: dict, cell: dict, seed: int, device) -> Pool:
    """The cell's ``pool_blocks`` blocks from ``seed``."""
    nchan = cell["channels"]
    n = block_samples(cfg, cell)
    blocks, frames = [], []
    for b in range(cell["pool_blocks"]):
        rng = np.random.default_rng(sub_seed(seed, b, 1))
        fr = np.stack([random_frames(rng, cell["frames_sent"])
                       for _ in range(nchan)])
        gen = torch.Generator(device=device)
        gen.manual_seed(sub_seed(seed, b, 2))
        carriers = cell["carrier0_hz"] + cell["carrier_step_hz"] * np.arange(nchan)
        if cell["signal"] == "cyclic":
            iq = synthesize_iq_device(
                torch.as_tensor(fr, device=device),
                torch.as_tensor(carriers, dtype=torch.float32, device=device),
                gen, n, samprate=cfg["samprate"], symrate=cfg["symrate"],
                mod_index=cfg["mod_index"], amplitude=cell["amplitude"],
                noise_std=cell["noise_std"])
            raw = to_raw_int16(iq)
            del iq
        else:
            nsym = int(n / (cfg["samprate"] / cfg["symrate"])) + 2
            syms = np.stack([mode_symbols(fr[c], nsym, cell["lead_symbols"], rng)
                             for c in range(nchan)])
            raw = mode_capture(device, syms, n, cfg["samprate"], cfg["symrate"],
                               cfg["symbolclocks"], cfg["mod_index"],
                               cell["noise_std"], gen, cell["amplitude"], carriers)
        blocks.append(raw)
        frames.append(fr)
    lead = cell.get("lead_symbols", 0) if cell["signal"] == "lead" else 0
    return Pool(blocks=blocks, frames=frames, nsamples=n, lead_symbols=lead,
                seconds=n / cfg["samprate"])


def synthesize_iq_device(frames: torch.Tensor, carrier_hz: torch.Tensor,
                         generator: torch.Generator | None, nsamples: int,
                         samprate: float = 250_000.0, symrate: float = 1024.0,
                         mod_index: float = 1.1, amplitude: float = 12_000.0,
                         noise_std: float = 0.0) -> torch.Tensor:
    """(B, nframes, 128) uint8 frame bytes → (B, nsamples) complex64 IQ:
    the frames encoded from the sync state, Manchester, PM on carrier_hz
    with a 0.7 rad start phase, the symbol stream repeated to fill the
    block, plus complex Gaussian noise from ``generator``."""
    B = frames.shape[0]
    dev = frames.device
    bits = bytes_to_bits(frames.reshape(B, -1))
    syms = encode_bits(bits, SYNC_STATE, MCQLI24)
    nsym = syms.shape[-1]
    t = torch.arange(nsamples, dtype=torch.float32, device=dev)
    pos = t / np.float32(samprate / symrate)
    sym_idx = torch.floor(pos).to(torch.int64) % nsym
    second_half = (pos - torch.floor(pos)) >= 0.5
    level = torch.where(syms[:, sym_idx] > 0, 1.0, -1.0)
    d = torch.where(second_half[None, :], level, -level)
    ph = (2 * np.pi * carrier_hz.to(torch.float32)[:, None] * t[None, :]
          / samprate + mod_index * d + 0.7)
    iq = amplitude * torch.polar(torch.ones_like(ph), ph)
    if noise_std > 0:
        nr = torch.randn(iq.shape, generator=generator, device=dev)
        ni = torch.randn(iq.shape, generator=generator, device=dev)
        iq = iq + noise_std * torch.complex(nr, ni)
    return iq.to(torch.complex64)


def to_raw_int16(iq: torch.Tensor) -> torch.Tensor:
    """(B, L) complex → (B, 2L) int16 interleaved I,Q, truncated and
    clipped (the recording format, pmdemod.c:206-230)."""
    ri = torch.stack([iq.real, iq.imag], dim=-1).reshape(iq.shape[0], -1)
    return torch.trunc(torch.clamp(ri, -32767.0, 32767.0)).to(torch.int16)


def mode_symbols(frames: np.ndarray, nsym_total: int, lead: int,
                 rng: np.random.Generator) -> np.ndarray:
    """The sent symbol stream: ``lead`` random symbols, the frames
    encoded from the sync state, random filler up to nsym_total."""
    syms = frames_to_symbols(frames)
    tail = max(nsym_total - lead - syms.size, 0)
    return np.concatenate([rng.integers(0, 2, lead).astype(np.uint8), syms,
                           rng.integers(0, 2, tail).astype(np.uint8)])


def mode_capture(dev, syms: np.ndarray, nsamples: int, samprate: float,
                 symrate: float, symbolclocks: int, mod_index: float,
                 noise_std: float, gen: torch.Generator, amplitude: float,
                 carriers: np.ndarray) -> torch.Tensor:
    """(B, nsym) symbol streams → (B, 2·nsamples) int16 raw IQ: each
    stream Manchester-coded on ``symbolclocks`` subcarrier cycles a
    symbol, phase-modulated on its channel's carrier.  The carrier phase
    runs in float64 cycles reduced mod 1 (a float32 ramp loses the phase
    over 48 M samples); one channel at a time, so the float64
    temporaries stay a few GB."""
    nchan = syms.shape[0]
    out = torch.empty((nchan, 2 * nsamples), dtype=torch.int16, device=dev)
    ss = samprate / symrate
    t = torch.arange(nsamples, dtype=torch.float64, device=dev)
    pos = t / ss
    idx = torch.clamp(torch.floor(pos).to(torch.int64), max=syms.shape[1] - 1)
    half = torch.remainder((pos - idx) * symbolclocks, 1.0) >= 0.5
    del pos
    for c in range(nchan):
        row = torch.as_tensor(syms[c], device=dev)
        level = torch.where(row[idx] > 0, 1.0, -1.0).to(torch.float64)
        d = torch.where(half, level, -level)
        del level
        ph = 2 * math.pi * torch.remainder(t * (float(carriers[c]) / samprate), 1.0)
        iq = amplitude * torch.polar(torch.ones_like(ph), ph + mod_index * d + 0.7)
        del ph, d
        if noise_std > 0:
            iq = iq + noise_std * torch.complex(
                torch.randn(nsamples, generator=gen, device=dev, dtype=torch.float64),
                torch.randn(nsamples, generator=gen, device=dev, dtype=torch.float64))
        ri = torch.stack([iq.real, iq.imag], dim=-1).reshape(-1)
        out[c] = torch.trunc(torch.clamp(ri, -32767.0, 32767.0)).to(torch.int16)
        del iq, ri
    return out


def sent_frame_index(start_symbol: np.ndarray, lead: int, frames_sent: int,
                     cyclic: bool) -> np.ndarray:
    """Index of the sent frame a decoded lane starting at soft symbol
    ``start_symbol`` holds (the first window may start a symbol early or
    late, so the nearest frame start counts); -1 where none."""
    k = np.rint((np.asarray(start_symbol) - lead) / FRAMESYMBOLS).astype(np.int64)
    if cyclic:
        return k % frames_sent
    return np.where((k >= 0) & (k < frames_sent), k, -1)
