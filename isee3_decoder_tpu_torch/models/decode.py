"""decode stage model: frame sync + tiered frame decoding (decode.c:42-289).

The block decode runs on the device: sync search over a frame of
positions, quicklook (error-free frames), QLEC (algebraic correction of
scattered symbol errors) and the tier-1 Fano walk (kernel K4) at a
cycles-per-bit cap, packed into one uint8 buffer so the host pays one
fetch.  The host tail re-runs the lanes that ran out of cycles at the
full budget (same walk, so outcomes equal one full-budget pass), then
sends what is left to the Viterbi decoder (by default the fused
kernels K5/K6; ``viterbi_backend="jnp"`` takes the classic API, kernel
K10), in chunks sized by the decision-memory budget, under the reference
policy (decode.c:209-214):

  Viterbi runs iff it is enabled AND (Fano is disabled OR (Fano failed
  AND (the previous frame decoded OR -p persistent))).

``decode_block`` and the receive chain apply the persistent-hybrid form
(every failed lane); ``decode_frames_batch`` and ``decode_stream`` apply
the previous-frame gating.  Entry points take ``device=None``: a CUDA
tensor runs where it lies, anything else goes to the card unless the
caller passes ``device="cpu"`` (see ``_kernels.place``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import (
    DEFAULT_CODE,
    FRAMEBITS,
    FRAMESYMBOLS,
    SYNCBITS,
    SYNCWORD,
    SYNC_STATE,
    CodeSpec,
)
from isee3_decoder_tpu_torch.ops.encode import bits_to_bytes, encode_bits
from isee3_decoder_tpu_torch.ops.fano import FanoParams, fano_decode
from isee3_decoder_tpu_torch.ops import viterbi
from isee3_decoder_tpu_torch.ops.syncword import find_sync, verify_frame
from isee3_decoder_tpu_torch.ops.viterbi_fused import (
    decision_budget,
    frame_tape_bytes,
)
from isee3_decoder_tpu_torch.utils import profiling
from isee3_decoder_tpu_torch.utils.metrics import decoder_amplitudes, gen_met
from isee3_decoder_tpu_torch.utils.timeformat import format_hms

DECODER_NONE, DECODER_VITERBI, DECODER_FANO, DECODER_QUICKLOOK = 0, 1, 2, 3
DECODER_QLEC = 4  # quicklook + algebraic error correction (middle tier)


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decode configuration (decode.c:65-73 defaults)."""

    fano_enabled: bool = True
    viterbi_enabled: bool = True
    persistent: bool = False  # -p
    fano_scale: float = 8.0
    fano_delta: int = 32  # 4 * scale
    fano_maxcycles: int = 100
    #: tier-1 cycles-per-bit cap of the device walk; lanes that time out
    #: re-run on the host path at the full fano_maxcycles budget —
    #: identical outcomes, bounded tail latency.  None disables tiering.
    fano_tier1_maxcycles: int | None = 12
    code: CodeSpec = DEFAULT_CODE
    #: Viterbi decoder, the JAX package's names: "fused" (kernels K5/K6,
    #: the default here) or "jnp" (the classic API of ops/viterbi, kernel
    #: K10, int32 metrics — the JAX package's default); "inplace" runs
    #: K5/K6 too (the JAX package's XLA in-place step is not ported).
    #: All three give the same bits.  The port defaults to "fused", the
    #: decoder measured on the H100 for the bench's threshold regime.
    viterbi_backend: str = "fused"
    #: quicklook tier: accept the QLI candidate (qdecode.c:129-134) only
    #: when re-encoding it reproduces every hard decision and the frame
    #: ends in the syncword — exactly what Fano would return
    quicklook: bool = True
    #: QLEC tier between quicklook and Fano (no reference counterpart);
    #: strict_labels() switches it off for reference-label parity
    qlec: bool = True

    @staticmethod
    def strict_labels(**kw) -> "DecodeConfig":
        """A config whose decoder LABELS match decode.c (no QLEC tier)."""
        kw.setdefault("qlec", False)
        return DecodeConfig(**kw)

    def mettab(self) -> np.ndarray:
        """Fano metric table for threshold operation at Eb/N0 = 3 dB with
        symdemod's amplitude-100 normalization (decode.c:120-135)."""
        sig, noise = decoder_amplitudes(100.0, 1.0)
        return gen_met(sig, noise, 0.5, self.fano_scale)

    def fano_params(self) -> FanoParams:
        return FanoParams(delta=self.fano_delta, maxcycles=self.fano_maxcycles)

    def fano_params_tier1(self) -> FanoParams:
        cap = self.fano_maxcycles
        if self.fano_tier1_maxcycles is not None:
            cap = min(self.fano_tier1_maxcycles, cap)
        return FanoParams(delta=self.fano_delta, maxcycles=cap)


class FrameRecord(NamedTuple):
    """Decoded frames, one row per lane (host numpy arrays)."""

    data: np.ndarray  # (L, FRAMEBITS//8) uint8 frame bytes
    good: np.ndarray  # (L,) bool — syncword verified (lock)
    decoder: np.ndarray  # (L,) int — DECODER_* code
    start_symbol: np.ndarray  # (L,) int64 symbol index of frame start
    fano_cycles: np.ndarray  # (L,) int32


@functools.lru_cache(maxsize=8)
def _mettab_device(cfg: DecodeConfig, device: torch.device) -> torch.Tensor:
    """cfg.mettab() computed once per config and device (gen_met
    integrates erf per bin on the host)."""
    return torch.as_tensor(cfg.mettab(), dtype=torch.int32, device=device)


def _tail(code: CodeSpec) -> int:
    return SYNCWORD & ((1 << (code.k - 1)) - 1)


def _gather_frames(
    symbols: torch.Tensor, sync_start: torch.Tensor, nframes: int
) -> torch.Tensor:
    """(B, S) soft symbols → (B*nframes, FRAMESYMBOLS) consecutive frames
    after each channel's sync, lane order channel-major."""
    B, S = symbols.shape
    dev = symbols.device
    starts = (sync_start.to(torch.int64)[:, None] + SYNCBITS
              + FRAMESYMBOLS * torch.arange(nframes, device=dev)[None, :])
    idx = (starts[..., None]
           + torch.arange(FRAMESYMBOLS, device=dev)[None, None, :]).reshape(B, -1)
    top = int(profiling.read("decode/frame_bound", idx.max()))
    if top >= S:
        raise ValueError(f"frame window past end of soft stream ({top} >= {S})")
    return symbols.gather(1, idx).reshape(B * nframes, FRAMESYMBOLS)


def _quicklook_frames(fsyms: torch.Tensor, code: CodeSpec):
    """Quick-look candidate bits + exact verification (qdecode.c:129-134):
    hard(s1)^hard(s2)^1 recovers the data delayed by one bit; accepted
    only if re-encoding from SYNC_STATE reproduces every hard decision.
    Returns (bits (L, FRAMEBITS) uint8, ok (L,) bool)."""
    L = fsyms.shape[0]
    hard = (fsyms.to(torch.int32) > 128).to(torch.uint8)
    pairs = hard.reshape(L, -1, 2)
    ql = pairs[..., 0] ^ pairs[..., 1] ^ 1  # bit t-1 at pair t
    last = torch.full((L, 1), SYNCWORD & 1, dtype=torch.uint8, device=fsyms.device)
    bits = torch.cat([ql[:, 1:], last], dim=1)
    resyms, _ = encode_bits(bits, SYNC_STATE, code)
    ok = (resyms == hard).all(dim=-1) & verify_frame(bits)
    return bits, ok


def _qlec_frames(fsyms: torch.Tensor, ql_bits: torch.Tensor, code: CodeSpec,
                 rounds: int = 2):
    """Middle decode tier: algebraic error correction on the quicklook
    candidate.  Re-encoding the candidate against the hard symbols gives
    a residual whose burst starts mark wrong bits; flip them and accept
    only when the remaining residual is exactly explained (plus the
    syncword check).  Returns (bits (L, FRAMEBITS) uint8, ok (L,) bool)."""
    L = fsyms.shape[0]
    w = code.k - 1
    hard = (fsyms.to(torch.int32) > 128).to(torch.uint8)

    def pair_bad(bits):
        resyms, _ = encode_bits(bits, SYNC_STATE, code)
        return (resyms ^ hard).reshape(L, FRAMEBITS, 2).amax(dim=-1)

    def prev_any(pb):
        """Any bad pair among the previous w pairs (burst masking)."""
        padded = torch.nn.functional.pad(pb, (w, 0))
        acc = torch.zeros_like(pb)
        for d in range(1, w + 1):
            acc = acc | padded[:, w - d : w - d + FRAMEBITS]
        return acc

    def explained_by(flips):
        return torch.nn.functional.pad(flips[:, :-1], (1, 0))

    bits = ql_bits
    flips = torch.zeros((L, FRAMEBITS), dtype=torch.uint8, device=fsyms.device)
    for _ in range(rounds):
        pb_un = pair_bad(bits) & (1 - explained_by(flips))
        start = pb_un & (1 - prev_any(pb_un))
        start[:, FRAMEBITS - 1] = 0  # the last bit is the syncword LSB
        bits = bits ^ start
        flips = flips | start
    unexplained = (pair_bad(bits) & (1 - explained_by(flips))).sum(dim=-1)
    ok = (flips.sum(dim=-1) > 0) & (unexplained == 0) & verify_frame(bits)
    return bits, ok


def _decode_frames_core(
    symbols: torch.Tensor,
    sync_start: torch.Tensor,
    nframes: int,
    cfg: DecodeConfig,
):
    """Tiered frame decode: gather → quicklook → QLEC → tier-1 Fano.

    Returns (data, good, decoder, ok, cycles) device tensors, lane order
    channel-major; ``ok`` marks lanes decoded by a device tier.  The Fano
    walk is skipped when every lane was decoded by a cheaper tier (a
    walk of all-skipped lanes returns nothing that is used)."""
    fsyms = _gather_frames(symbols, sync_start, nframes)
    L = fsyms.shape[0]
    dev = fsyms.device
    none = torch.zeros(L, dtype=torch.bool, device=dev)
    if cfg.quicklook:
        ql_bits, ql_ok = _quicklook_frames(fsyms, cfg.code)
    else:
        ql_bits = torch.zeros((L, FRAMEBITS), dtype=torch.uint8, device=dev)
        ql_ok = none
    if cfg.qlec and cfg.quicklook:
        ec_bits, ec_ok = _qlec_frames(fsyms, ql_bits, cfg.code)
        ec_ok = ec_ok & ~ql_ok
    else:
        ec_bits, ec_ok = ql_bits, none
    pre_ok = ql_ok | ec_ok
    bits = torch.where(ec_ok[:, None], ec_bits, ql_bits)
    cycles = torch.zeros(L, dtype=torch.int32, device=dev)
    fano_ok = none
    if cfg.fano_enabled and not profiling.read("decode/pre_ok", pre_ok.all()):
        res = fano_decode(
            fsyms, _mettab_device(cfg, dev), FRAMEBITS, SYNC_STATE,
            _tail(cfg.code), cfg.code, cfg.fano_params_tier1(), skip=pre_ok,
        )
        fano_ok = ~pre_ok & (res.goodbits == FRAMEBITS)
        bits = torch.where(pre_ok[:, None], bits, res.bits)
        cycles = torch.where(pre_ok, 0, res.cycles).to(torch.int32)
    ok = pre_ok | fano_ok
    good = pre_ok | (fano_ok & verify_frame(bits))
    # a lane whose Fano walk ran reports FANO even when it timed out
    # (decode.c:200 labels the attempt before it runs)
    decoder = torch.where(
        ql_ok, DECODER_QUICKLOOK,
        torch.where(ec_ok, DECODER_QLEC,
                    DECODER_FANO if cfg.fano_enabled else DECODER_NONE),
    ).to(torch.int32)
    return bits_to_bytes(bits), good, decoder, ok, cycles


def decode_block_device(
    symbols: torch.Tensor,
    nframes: int,
    npos: int = FRAMESYMBOLS,
    cfg: DecodeConfig = DecodeConfig(),
) -> torch.Tensor:
    """Sync search + tiered frame decode packed into ONE uint8 buffer on
    the symbols' device.  Lanes with ``ok`` False still owe the tier-2
    re-run (fano_tier2_inplace) and the Viterbi fallback.

    Buffer layout for L = B*nframes lanes:
      [0, 16L)       frame bytes (L × FRAMEBITS/8)
      [16L, 17L)     good flags
      [17L, 18L)     decoder codes
      [18L, 19L)     ok flags
      [19L, 23L)     fano cycles, int32 little-endian per lane
      [23L, 23L+4B)  sync_start per channel, int32 little-endian
    """
    with profiling.span("decode/tiers"):
        ss, _ = find_sync(symbols[:, : npos + SYNCBITS], npos, cfg.code)
        data, good, decoder, ok, cycles = _decode_frames_core(
            symbols, ss, nframes, cfg)
    return torch.cat([
        data.reshape(-1),
        good.to(torch.uint8),
        decoder.to(torch.uint8),
        ok.to(torch.uint8),
        cycles.to(torch.int32).contiguous().view(torch.uint8),
        ss.to(torch.int32).contiguous().view(torch.uint8),
    ])


def unpack_block_buffer(
    buf: np.ndarray, B: int, nframes: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split a decode_block_device result buffer into
    (data, good, decoder, ok, cycles, sync_start)."""
    L = B * nframes
    nb = FRAMEBITS // 8
    data = buf[: nb * L].reshape(L, nb).copy()
    good = buf[nb * L : nb * L + L].astype(bool)
    decoder = buf[nb * L + L : nb * L + 2 * L].astype(np.int32)
    ok = buf[nb * L + 2 * L : nb * L + 3 * L].astype(bool)
    cycles = buf[nb * L + 3 * L : nb * L + 7 * L].view(np.int32).copy()
    ss = buf[nb * L + 7 * L :].view(np.int32).astype(np.int64)
    return data, good, decoder, ok, cycles, ss


def _gather_failed_lanes(
    starts: np.ndarray, symbols: torch.Tensor, sub: np.ndarray, nframes: int
) -> torch.Tensor:
    """Frame-symbol windows (on the symbols' device) for the failed-lane
    subset ``sub`` of a block with ``nframes`` frames per channel."""
    idx = starts.reshape(-1)[sub, None] + np.arange(FRAMESYMBOLS)[None, :]
    if idx.size and idx.max() >= symbols.shape[-1]:
        raise ValueError(
            f"frame window past end of soft stream: max index {idx.max()}"
            f" >= {symbols.shape[-1]}"
        )
    dev = symbols.device
    rows = symbols[profiling.upload("host_tail/lanes", sub // nframes, dev)]
    return rows.gather(1, profiling.upload("host_tail/lanes", idx, dev))


def fano_tier2_inplace(
    data: np.ndarray,
    good: np.ndarray,
    decoder: np.ndarray,
    ok: np.ndarray,
    cycles: np.ndarray,
    starts: np.ndarray,
    symbols: torch.Tensor,
    nframes: int,
    cfg: DecodeConfig,
) -> None:
    """Full-budget Fano re-run of the lanes that timed out at the tier-1
    cap; patches the result arrays in place.  Every straggler is patched
    from the full-budget walk — still-failed ones too, whose partial
    bits and cycle counts must match one flat full-budget pass."""
    if (
        not cfg.fano_enabled
        or cfg.fano_tier1_maxcycles is None
        or cfg.fano_tier1_maxcycles >= cfg.fano_maxcycles
    ):
        return
    sub = np.nonzero(~ok)[0]
    if sub.size == 0:
        return
    profiling.count("host_tail/tier2_lanes", sub.size)
    site = "host_tail/fano_tier2"
    with profiling.span(site):
        fsyms = _gather_failed_lanes(starts, symbols, sub, nframes)
        res = fano_decode(
            fsyms, _mettab_device(cfg, fsyms.device), FRAMEBITS, SYNC_STATE,
            _tail(cfg.code), cfg.code, cfg.fano_params(),
        )
        fano_ok = profiling.read(site, res.goodbits == FRAMEBITS)
        data[sub] = profiling.read(site, bits_to_bytes(res.bits))
        good[sub] = fano_ok & profiling.read(site, verify_frame(res.bits))
        decoder[sub] = np.where(fano_ok, DECODER_FANO, decoder[sub])
        ok[sub] = fano_ok
        cycles[sub] = profiling.read(site, res.cycles)


def _viterbi_decode(fsyms: torch.Tensor, cfg: DecodeConfig) -> torch.Tensor:
    """(L, FRAMESYMBOLS) soft symbols → (L, FRAMEBITS) uint8 bits from
    SYNC_STATE to SYNC_STATE by the decoder ``cfg.viterbi_backend``
    names: the fused K5/K6 or the classic K10 on a CUDA tensor, their
    plain versions on a CPU one.  Frames go in chunks as large as the
    decision-memory budget allows (either decoder holds one tape of
    FRAMEBITS·n/8 bytes per frame; see decision_budget)."""
    per = frame_tape_bytes(FRAMEBITS, cfg.code)
    chunk = max(decision_budget(fsyms.device) // per, 1)
    return torch.cat([
        viterbi.decode_frames(fsyms[lo : lo + chunk], FRAMEBITS, SYNC_STATE,
                              SYNC_STATE, cfg.code, cfg.viterbi_backend)
        for lo in range(0, fsyms.shape[0], chunk)])


def viterbi_fallback_inplace(
    data: np.ndarray,
    good: np.ndarray,
    decoder: np.ndarray,
    ok: np.ndarray,
    starts: np.ndarray,
    symbols: torch.Tensor,
    nframes: int,
    cfg: DecodeConfig,
) -> None:
    """Viterbi over every lane no Fano or cheaper tier decoded
    (persistent-hybrid policy); patches the result arrays in place."""
    sub = np.nonzero(~ok)[0]
    if not cfg.viterbi_enabled or sub.size == 0:
        return
    profiling.count("host_tail/viterbi_lanes", sub.size)
    _viterbi_patch(data, good, decoder, sub,
                   _gather_failed_lanes(starts, symbols, sub, nframes), cfg)


def _viterbi_patch(data, good, decoder, sub, fsyms, cfg) -> None:
    """Decode the frames ``fsyms`` of lanes ``sub`` by Viterbi and patch
    the result arrays."""
    site = "host_tail/viterbi"
    with profiling.span(site):
        vbits = _viterbi_decode(fsyms, cfg)
        data[sub] = profiling.read(site, bits_to_bytes(vbits))
        good[sub] = profiling.read(site, verify_frame(vbits))
    decoder[sub] = DECODER_VITERBI


def decode_block(
    symbols,
    nframes: int,
    cfg: DecodeConfig = DecodeConfig(),
    npos: int = FRAMESYMBOLS,
    device=None,
) -> tuple[FrameRecord, np.ndarray]:
    """Block decode: one device pass + one fetch, then the host-driven
    tier-2 Fano re-run and Viterbi fallback on failed lanes.

    Returns (FrameRecord with batch axis B*nframes, sync_start (B,))."""
    symbols = _kernels.place(symbols, device)
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    B = symbols.shape[0]
    buf = decode_block_device(symbols, nframes, npos, cfg).cpu().numpy()
    return _finish(buf, symbols, B, nframes, cfg)


def _finish(buf: np.ndarray, symbols: torch.Tensor, B: int, nframes: int,
            cfg: DecodeConfig) -> tuple[FrameRecord, np.ndarray]:
    """Unpack a block buffer and run the host tail (tier-2 Fano, Viterbi
    fallback) on failed lanes — shared by decode_block and the receive
    chain."""
    profiling.count("host_tail/calls")
    data, good, decoder, ok, cycles, ss = unpack_block_buffer(buf, B, nframes)
    starts = ss[:, None] + SYNCBITS + FRAMESYMBOLS * np.arange(nframes)[None, :]
    if (~ok).any():
        fano_tier2_inplace(data, good, decoder, ok, cycles, starts, symbols,
                           nframes, cfg)
        viterbi_fallback_inplace(data, good, decoder, ok, starts, symbols,
                                 nframes, cfg)
    rec = FrameRecord(
        data=data,
        good=good,
        decoder=decoder,
        start_symbol=starts.reshape(-1),
        fano_cycles=cycles,
    )
    return rec, ss


def decode_frames_batch(
    symbols,
    sync_start,
    nframes: int,
    cfg: DecodeConfig = DecodeConfig(),
    prev_lock: np.ndarray | bool = False,
    device=None,
) -> FrameRecord:
    """Throughput mode: decode ``nframes`` consecutive frames per channel
    after a known sync, channels × frames as one batch of lanes.

    With ``cfg.persistent`` (-p) the Viterbi fallback runs on every Fano
    failure in one batch.  Without it the reference's previous-frame
    gating applies (decode.c:209-214): frame f of a channel falls back
    to Viterbi only if frame f-1 of that channel decoded — a serial pass
    over the frame axis, batched across channels.  ``prev_lock`` (B,)
    is the lock entering frame 0 (the reference starts unlocked).

    Returns one FrameRecord with batch axis B*nframes (channel-major)."""
    symbols = _kernels.place(symbols, device)
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    B = symbols.shape[0]
    sync_start = np.broadcast_to(np.asarray(sync_start, np.int64), (B,)).copy()
    starts = (sync_start[:, None] + SYNCBITS
              + FRAMESYMBOLS * np.arange(nframes)[None, :])
    L = B * nframes
    data = np.zeros((L, FRAMEBITS // 8), np.uint8)
    good = np.zeros(L, bool)
    decoder = np.full(L, DECODER_NONE, np.int32)
    decode_ok = np.zeros(L, bool)
    cycles = np.zeros(L, np.int32)

    device_tiers = cfg.fano_enabled or cfg.quicklook
    if device_tiers:
        ss = torch.as_tensor(sync_start, device=symbols.device)
        data, good, decoder, decode_ok, cycles = (
            x.cpu().numpy() for x in _decode_frames_core(symbols, ss, nframes, cfg))
        if (~decode_ok).any():
            fano_tier2_inplace(data, good, decoder, decode_ok, cycles, starts,
                               symbols, nframes, cfg)

    if cfg.viterbi_enabled:
        if cfg.persistent or not device_tiers:
            viterbi_fallback_inplace(data, good, decoder, decode_ok, starts,
                                     symbols, nframes, cfg)
        else:
            lock = np.broadcast_to(np.asarray(prev_lock, bool), (B,)).copy()
            for f in range(nframes):
                idx = np.arange(B) * nframes + f
                need = ~decode_ok[idx] & lock
                if need.any():
                    sub = idx[need]
                    _viterbi_patch(data, good, decoder, sub, _gather_failed_lanes(
                        starts, symbols, sub, nframes), cfg)
                    decode_ok[sub] = True
                lock = good[idx].copy()

    return FrameRecord(data=data, good=good, decoder=decoder,
                       start_symbol=starts.reshape(-1), fano_cycles=cycles)


class DecodeStreamState:
    """Per-channel stream walk state (host side)."""

    def __init__(self, batch: int):
        self.batch = batch
        self.lock = np.zeros(batch, bool)
        self.pos = np.zeros(batch, np.int64)  # absolute index of buffer start
        self.sync_start = np.zeros(batch, np.int64)


def _gather_windows(symbols: torch.Tensor, starts: np.ndarray,
                    length: int) -> torch.Tensor:
    """(B, length) windows of ``symbols`` at per-channel starts."""
    idx = starts[:, None] + np.arange(length)[None, :]
    return symbols.gather(1, torch.as_tensor(idx, device=symbols.device))


def decode_stream(
    symbols,
    cfg: DecodeConfig = DecodeConfig(),
    state: DecodeStreamState | None = None,
    max_frames: int | None = None,
    device=None,
) -> tuple[list[FrameRecord], DecodeStreamState]:
    """Walk a (B, S) soft-symbol stream, emitting decoded frames.

    Mirrors the decode.c main loop: sync re-search when unlocked
    (decode.c:162-193), tiered decode with the gated Viterbi fallback,
    verification, purge (decode.c:269-281).  The state can be carried
    across calls for true streaming."""
    symbols = _kernels.place(symbols, device)
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    B, S = symbols.shape
    dev = symbols.device
    if state is None:
        state = DecodeStreamState(B)
    mettab = _mettab_device(cfg, dev)
    tail = _tail(cfg.code)

    records: list[FrameRecord] = []
    while max_frames is None or len(records) < max_frames:
        if (state.pos + FRAMESYMBOLS + SYNCBITS > S).any():
            break
        if not state.lock.all():
            wins = _gather_windows(symbols, state.pos, FRAMESYMBOLS + SYNCBITS)
            ss, _ = find_sync(wins, FRAMESYMBOLS, cfg.code)
            state.sync_start = np.where(state.lock, 0,
                                        ss.cpu().numpy().astype(np.int64))
        else:
            state.sync_start[:] = 0
        frame_start = state.pos + state.sync_start + SYNCBITS
        if (frame_start + FRAMESYMBOLS > S).any():
            break
        fsyms = _gather_windows(symbols, frame_start, FRAMESYMBOLS)

        decoder = np.full(B, DECODER_NONE, np.int32)
        bits = np.zeros((B, FRAMEBITS), np.uint8)
        cycles = np.zeros(B, np.int32)
        pre_ok = np.zeros(B, bool)
        if cfg.quicklook:
            qbits, qok = _quicklook_frames(fsyms, cfg.code)
            ql_ok = qok.cpu().numpy()
            bits[ql_ok] = qbits.cpu().numpy()[ql_ok]
            decoder[ql_ok] = DECODER_QUICKLOOK
            pre_ok = ql_ok
            if cfg.qlec:
                ec_bits, ec_ok = _qlec_frames(fsyms, qbits, cfg.code)
                ec_ok = ec_ok.cpu().numpy() & ~ql_ok
                bits[ec_ok] = ec_bits.cpu().numpy()[ec_ok]
                decoder[ec_ok] = DECODER_QLEC
                pre_ok = ql_ok | ec_ok
        decode_ok = pre_ok.copy()

        if cfg.fano_enabled:
            res = fano_decode(fsyms, mettab, FRAMEBITS, SYNC_STATE, tail,
                              cfg.code, cfg.fano_params_tier1(),
                              skip=torch.as_tensor(pre_ok, device=dev))
            fano_ok = ~pre_ok & (res.goodbits == FRAMEBITS).cpu().numpy()
            decoder = np.where(pre_ok, decoder, DECODER_FANO).astype(np.int32)
            bits = np.where(pre_ok[:, None], bits,
                            res.bits.cpu().numpy()).astype(np.uint8)
            decode_ok = pre_ok | fano_ok
            cycles = np.where(pre_ok, 0, res.cycles.cpu().numpy()).astype(np.int32)
            # tier 2: full-budget re-run of the lanes that timed out at the
            # tier-1 cap (the same walk: results equal one full pass)
            tiered = (cfg.fano_tier1_maxcycles is not None
                      and cfg.fano_tier1_maxcycles < cfg.fano_maxcycles)
            if tiered and (~decode_ok).any():
                sub = np.nonzero(~decode_ok)[0]
                res2 = fano_decode(fsyms[torch.as_tensor(sub, device=dev)],
                                   mettab, FRAMEBITS, SYNC_STATE, tail,
                                   cfg.code, cfg.fano_params())
                bits[sub] = res2.bits.cpu().numpy()
                cycles[sub] = res2.cycles.cpu().numpy()
                decode_ok[sub] = (res2.goodbits == FRAMEBITS).cpu().numpy()

        if cfg.viterbi_enabled:
            # decode.c:209-214 fallback policy
            if not cfg.fano_enabled:
                need_vit = np.ones(B, bool)
            else:
                need_vit = (cfg.persistent | state.lock) & ~decode_ok
            if need_vit.any():
                sub = np.nonzero(need_vit)[0]
                vbits = _viterbi_decode(fsyms[torch.as_tensor(sub, device=dev)],
                                        cfg)
                bits[sub] = vbits.cpu().numpy()
                decoder[sub] = DECODER_VITERBI
                decode_ok[sub] = True  # Viterbi always returns a frame

        bits_t = torch.from_numpy(bits)
        good = decode_ok & verify_frame(bits_t).numpy()
        state.lock = good.copy()
        records.append(FrameRecord(
            data=bits_to_bytes(bits_t).numpy(),
            good=good,
            decoder=decoder,
            start_symbol=frame_start.copy(),
            fano_cycles=cycles,
        ))
        # purge the decoded frame (decode.c:269-281): the buffer now
        # starts at the sync sequence of the frame just decoded
        state.pos = state.pos + state.sync_start + FRAMESYMBOLS
        state.sync_start[:] = 0
    return records, state


def format_frame(rec: FrameRecord, channel: int, frame_no: int,
                 symrate: float = 1024.0) -> str:
    """Pretty-print one channel's frame like decode.c:249-265."""
    name = {
        DECODER_VITERBI: "Viterbi",
        DECODER_FANO: "Fano",
        DECODER_QUICKLOOK: "Quicklook",
        DECODER_QLEC: "Quicklook-EC",
    }.get(int(rec.decoder[channel]), "None")
    start = int(rec.start_symbol[channel])
    head = (
        f"Frame {frame_no:,} at symbol {start:,} "
        f"({format_hms(start / symrate)}) with {name} "
        f"{'' if rec.good[channel] else '(bad)'}"
    )
    data = rec.data[channel]
    body = [" ".join(f"{b:02x}" for b in data[i : i + 16])
            for i in range(0, len(data), 16)]
    return head + "\n" + "\n".join(body) + "\n"
