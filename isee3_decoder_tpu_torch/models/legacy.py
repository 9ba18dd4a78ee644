"""Legacy-tool capabilities: vdecode / qdecode / framer / icesync — the
port of isee3_decoder_tpu/models/legacy.py.

* ``qdecode_stream``   — quick-look-in decode (qdecode.c:129-134)
* ``auto_phase_flip``  — per-stream symbol-pair phasing by dual sync
                         correlators (vdecode.c:110-141, qdecode.c:95-128)
* ``vdecode_stream``   — streaming Viterbi with fixed decode delay and
                         re-encode symbol-error accounting (vdecode.c)
* ``frame_bits``       — syncword framer over a decoded bit stream
                         (framer.c:61-95)
* ``icesync_frames``   — waveform-domain FFT sync correlation + block
                         Viterbi with known boundary states (icesync.c)
* ``ebn0_from_symbol_errors`` — inverse-erfc Eb/N0 estimate
                         (icesync.c:393-402,414-443)
* ``bitsync_frames``   — whole-file symbol sync + streaming Viterbi +
                         syncword framing (bitsync.c)

Functions that compute on tensors take ``device=None``: the card unless
the caller asks for "cpu" (a CUDA tensor runs where it lies); the FFT
sync search and the templates are host numpy, as in the JAX package.
"""

from __future__ import annotations

import os
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
    CodeSpec,
    sync_vector,
)
from isee3_decoder_tpu_torch.ops import symbols as sym_ops
from isee3_decoder_tpu_torch.ops import viterbi
from isee3_decoder_tpu_torch.ops import viterbi_inplace as vip
from isee3_decoder_tpu_torch.ops.encode import bits_to_bytes, encode_bits
from isee3_decoder_tpu_torch.ops.syncword import framer_positions, phase_sync_peaks
from isee3_decoder_tpu_torch.ops.viterbi_fused import stream_update_fused


def _rows(x, device) -> torch.Tensor:
    x = _kernels.place(x, device)
    return x[None, :] if x.ndim == 1 else x


def qdecode_stream(symbols, code: CodeSpec = DEFAULT_CODE,
                   device=None) -> torch.Tensor:
    """Quick-look decode of a phased symbol stream: for each pair,
    bit = hard(s1) ^ hard(s2) ^ 1 (qdecode.c:129-134).  Output bits are
    the data stream delayed by one bit (poly1^poly2 == 0b10).  (B, L//2)
    uint8."""
    s = _rows(symbols, device).to(torch.int32) > 128
    pairs = s[:, : (s.shape[1] // 2) * 2].reshape(s.shape[0], -1, 2)
    return (pairs[..., 0] ^ pairs[..., 1] ^ True).to(torch.uint8)


def auto_phase_flip(symbols: np.ndarray, code: CodeSpec = DEFAULT_CODE,
                    device=None) -> tuple[np.ndarray, np.ndarray]:
    """Symbol-pair phasing of each stream from the sync correlation peaks
    on even vs odd alignments over the first frame (vdecode.c:110-141):
    returns (aligned_symbols, phase (B,) int64).

    Phase 1 means the stream started mid-pair; one symbol is dropped.
    With mixed flips the common length is L - max(flip): unflipped
    streams lose their last symbol to keep the batch rectangular."""
    symbols = np.asarray(symbols)
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    head = symbols[:, : FRAMESYMBOLS + SYNCBITS]
    even, odd = phase_sync_peaks(_kernels.place(head, device), code)
    # vdecode flips when the out-phase (even-ending) peak is stronger
    flips = (even > odd).cpu().numpy().astype(np.int64)
    maxf = int(flips.max()) if flips.size else 0
    L = symbols.shape[1] - maxf
    out = np.stack([symbols[b, f : f + L] for b, f in enumerate(flips)])
    return out, flips


class VdecodeResult(NamedTuple):
    bits: np.ndarray  # (B, nbits) decoded bits ('0'/'1' stream of vdecode)
    symbol_errors: np.ndarray  # (B,) re-encode hard-decision mismatches


def _vdecode_classic(syms: torch.Tensor, nbits: int, decode_delay: int,
                     code: CodeSpec) -> list[torch.Tensor]:
    """Chunked update_blk (K10) + vectorized fixed-delay chainbacks on a
    circular tape of chunk + delay slots."""
    B = syms.shape[0]
    chunk = 4096
    st = viterbi.create(min(nbits, chunk) + decode_delay, B, code, 0,
                        device=syms.device)
    parts = []
    done = 0
    while done < nbits:
        n = min(chunk, nbits - done)
        st = viterbi.update_blk(st, syms[:, 2 * done : 2 * (done + n)], code)
        # every end time whose full `delay` lookback is on the tape
        lo = decode_delay if done == 0 else 0
        parts.append(viterbi.streaming_decodebits_window(st, decode_delay,
                                                         n - lo, code))
        done += n
    return parts


def _vdecode_fused(syms: torch.Tensor, nbits: int, decode_delay: int,
                   code: CodeSpec) -> list[torch.Tensor]:
    """K5/K6 on the rotating-layout circular tape, in cycle-aligned
    chunks; the last one erasure-padded to whole cycles."""
    B = syms.shape[0]
    w = code.k - 1
    chunk = max((4096 // w) * w, w)
    # tape: a multiple of the chunk covering skip + chunk + delay
    tape_len = chunk * (1 + -(-(decode_delay + w) // chunk))
    st = vip.stream_create(tape_len, B, code, 0, device=syms.device)
    parts = []
    done = 0
    while done < nbits:
        n = min(chunk, nbits - done)
        npad = -(-n // w) * w
        block = torch.full((B, 2 * npad), 128, dtype=torch.uint8,
                           device=syms.device)
        block[:, : 2 * n] = syms[:, 2 * done : 2 * (done + n)]
        st = stream_update_fused(st, block, code)
        lo = max(decode_delay - done, 0)
        if n - lo > 0:
            parts.append(vip.stream_decodebits(st, decode_delay, n - lo, code,
                                               skip=npad - n))
        done += n
    return parts


def vdecode_stream(symbols, decode_delay: int = 200,
                   code: CodeSpec = DEFAULT_CODE, backend: str = "jnp",
                   device=None) -> VdecodeResult:
    """Streaming Viterbi decode of a phased soft-symbol stream
    (vdecode.c:142-185): per symbol pair one update, one bit chained back
    at the fixed ``decode_delay``, the first ``decode_delay`` bits
    suppressed — as a chunked block update + vectorized chainbacks from
    state 0, with the tape bounded at chunk + delay planes.  The decoded
    bits are re-encoded and compared with the hard-sliced symbols.

    The emitted stream is the data delayed by decode_delay + K - 2 trellis
    steps, as in the reference.  backend: "jnp" (the classic API, kernel
    K10) or "fused" (K5/K6 on the rotating-layout tape; "inplace" names it
    too, as in ops/viterbi.BACKENDS); the same bits."""
    syms = _rows(symbols, device)
    B, L = syms.shape
    nbits = L // 2
    syms = syms[:, : 2 * nbits]
    if viterbi.resolve_backend(backend) == "fused":
        parts = _vdecode_fused(syms, nbits, decode_delay, code)
    else:
        parts = _vdecode_classic(syms, nbits, decode_delay, code)
    bits = (torch.cat(parts, dim=1) if parts
            else torch.zeros((B, 0), dtype=torch.uint8, device=syms.device))

    # re-encode self-check (vdecode.c:155-183) at the matching lag
    lag = code.k - 2  # decodebit output lags the data by K-2 bits
    errs = torch.zeros(B, dtype=torch.int64)
    if bits.shape[1] > lag:
        re_syms, _ = encode_bits(bits[:, lag:], 0, code)
        hard = (syms[:, : re_syms.shape[1]] > 128).to(torch.uint8)
        errs = (re_syms[:, 2 * code.k :] != hard[:, 2 * code.k :]).sum(dim=1)
    return VdecodeResult(bits=bits.cpu().numpy(),
                         symbol_errors=errs.cpu().numpy())


class FramerResult(NamedTuple):
    frames: list[np.ndarray]  # decoded 128-byte frames per match
    positions: list[int]  # bit index of frame end (syncword last bit)


def frame_bits(bits: np.ndarray, channel: int = 0, device=None) -> FramerResult:
    """Frame a decoded bit stream on the 40-bit syncword (framer.c:61-95):
    a frame for every position whose preceding 1024 bits end in the
    syncword."""
    t = _rows(bits, device)
    pos = torch.nonzero(framer_positions(t)[channel])[:, 0].tolist()
    keep = [p for p in pos if p + 1 >= FRAMEBITS]
    frames = [bits_to_bytes(t[channel, p + 1 - FRAMEBITS : p + 1]).cpu().numpy()
              for p in keep]
    return FramerResult(frames=frames, positions=keep)


# ---------------------------------------------------------------------------
# icesync: waveform-domain FFT frame sync + block Viterbi
# ---------------------------------------------------------------------------


def manchester_sync_template(symbolsamples: float,
                             code: CodeSpec = DEFAULT_CODE) -> np.ndarray:
    """Sample-rate ±1 sync template (generate_sync, icesync.c:55-141): the
    last SYNCBITS encoded sync symbols Manchester-expanded, symbol 1
    mapping to (-1, +1)."""
    sv = np.asarray(sync_vector(code))
    out = np.zeros(int(SYNCBITS * symbolsamples) + 1)
    ind = 0
    for k in range(SYNCBITS):
        first = sv[k] == 1
        while ind < (k + 0.5) * symbolsamples:
            out[ind] = -1.0 if first else 1.0
            ind += 1
        while ind < (k + 1) * symbolsamples:
            out[ind] = 1.0 if first else -1.0
            ind += 1
    return out[:ind]


def fft_sync_search(samples: np.ndarray, template: np.ndarray, low: int,
                    high: int, plot_path: str | None = None) -> int | None:
    """FFT cross-correlation sync search (fft_sync_search,
    icesync.c:145-208): the peak lag in [low, high), or None.

    With ``plot_path`` the whole correlation is written in the reference's
    plot format (icesync.c:173-186: a ``signed double`` header, then one
    ``dot i value`` line per lag, scaled as FFTW's unnormalized inverse)."""
    n = len(samples)
    size = 1 << int(np.ceil(np.log2(n + len(template))))
    fa = np.fft.rfft(samples, size)
    fb = np.fft.rfft(template, size)
    corr = np.fft.irfft(fa * np.conj(fb), size)
    if plot_path is not None:
        with open(plot_path, "w") as plot:
            plot.write("signed double\n")
            for i, v in enumerate(corr * size):
                plot.write(f"dot {i} {v:f}\n")
    high = min(high, size)
    if not np.any(samples):
        return None
    seg = corr[low:high]
    if seg.size == 0 or seg.max() <= 0:
        return None
    return low + int(np.argmax(seg))


class IcesyncFrame(NamedTuple):
    start_sample: int
    data: np.ndarray  # 128 frame bytes
    symbol_errors: int
    ebn0_db: float | None
    min_metric: int
    max_metric: int


def icesync_frames(samples: np.ndarray, samprate: float = 250_000.0,
                   symrate: float = 1024.475, clock_tolerance: float = 5.0,
                   max_frames: int | None = None,
                   code: CodeSpec = DEFAULT_CODE, plot_dir: str | None = None,
                   device=None) -> list[IcesyncFrame]:
    """Whole-file frame sync + block Viterbi decode (icesync.c:211-411).

    Finds successive sync positions by FFT correlation (a whole-frame
    search to acquire, ±clock_tolerance to track), integrates Manchester
    symbols at fixed boundaries (C int truncation, icesync.c:347-359),
    decodes each frame with the classic API (K10 on the card, int32
    metrics) between known 0x819fbe boundary states, and estimates Eb/N0
    from re-encode symbol errors.  ``plot_dir``: each acquisition search
    writes its correlation there as ``sync.<begin>.plot``, as the
    reference does in its working directory (icesync.c:173-186)."""
    dev = _kernels.run_device(device)
    samples = np.asarray(samples, np.int64)
    symbolsamples = samprate / symrate
    framesamples = symbolsamples * 2 * FRAMEBITS
    template = manchester_sync_template(symbolsamples, code)
    state = SYNCWORD & 0xFFFFFF
    cs = np.concatenate([[0], np.cumsum(samples)])
    i = np.arange(2 * FRAMEBITS)

    out: list[IcesyncFrame] = []
    begin = 0
    startsync: int | None = None
    while begin + framesamples < len(samples) and (
            max_frames is None or len(out) < max_frames):
        if startsync is None:
            # the reference correlates exactly Framesamples of input
            # (icesync.c:153-161), zero-padded beyond
            s = fft_sync_search(
                samples[begin : begin + int(framesamples)], template, 0,
                int(framesamples),
                plot_path=(None if plot_dir is None
                           else os.path.join(plot_dir, f"sync.{begin}.plot")))
            if s is None:
                begin += int(framesamples)
                continue
            startsync = begin + s
        start = startsync + int(framesamples) // 2
        low = int(0.5 * framesamples - clock_tolerance)
        high = int(0.5 * framesamples + clock_tolerance)
        e = fft_sync_search(samples[start : start + int(framesamples)],
                            template, low, high)
        if e is None:
            begin = startsync + int(framesamples)
            startsync = None
            continue
        endsync = start + e

        firstsample = int(SYNCBITS * symbolsamples + startsync)
        ind = (firstsample + i * symbolsamples).astype(np.int64)
        mid = (firstsample + (i + 0.5) * symbolsamples).astype(np.int64)
        last = (firstsample + (i + 1.0) * symbolsamples).astype(np.int64)
        s = -(cs[mid] - cs[ind]) + (cs[last] - cs[mid])
        soft = torch.as_tensor(np.clip(s + 128, 0, 255).astype(np.uint8),
                               device=dev)

        st = viterbi.create(FRAMEBITS, 1, code, state, device=dev)
        st = viterbi.update_blk(st, soft, code)
        bits = viterbi.chainback(st, FRAMEBITS, state, code)[0]
        re_syms, _ = encode_bits(bits, state, code)
        symerrors = int((re_syms != (soft > 128).to(torch.uint8)).sum())
        out.append(IcesyncFrame(
            start_sample=startsync,
            data=bits_to_bytes(bits).cpu().numpy(),
            symbol_errors=symerrors,
            ebn0_db=ebn0_from_symbol_errors(symerrors, 2 * FRAMEBITS),
            min_metric=int(viterbi.min_metric(st)[0]),
            max_metric=int(viterbi.max_metric(st)[0]),
        ))
        startsync = endsync
    return out


class BitsyncResult(NamedTuple):
    frames: list[np.ndarray]  # decoded 128-byte frames
    bits: np.ndarray  # the decoded bit stream
    infos: list[dict]  # per frame window: firstsample, energy, symrate


def bitsync_frames(samples: np.ndarray, samprate: float = 250_000.0,
                   symrate: float = 1024.467, decode_delay: int = 200,
                   code: CodeSpec = DEFAULT_CODE, device=None) -> BitsyncResult:
    """Whole-file symbol sync + streaming Viterbi + syncword framing, the
    capability of ``bitsync.c``: per frame a symbol-phase search over
    ±half a symbol (bitsync.c:133-186) and the integrate-and-dump at the
    best phase, gain 75/sqrt(energy) (bitsync.c:228); then pair phasing
    by the sync correlators (bitsync.c:208-226), the fixed-delay
    streaming Viterbi (``vdecode_stream``: kernel K10 on the card) and
    40-bit syncword framing (bitsync.c:256-270).

    The JAX package sums the whole file again for every frame; here one
    prefix sum of the file (kernel K3) serves every frame — the same
    values, since each frame's reads lie inside the file."""
    samples = np.asarray(samples, np.int16)
    symbolsamples = samprate / symrate
    halfclock = 0.5 * symbolsamples
    framesym = FRAMESYMBOLS
    noff = 2 * int(symbolsamples / 2) + 1
    firstsample = int(symbolsamples / 2)
    csum = sym_ops.samples_csum(_rows(samples, device), sym_ops.SEARCH_PAD)
    infos = []
    soft_all = []
    while firstsample + (framesym + 1) * symbolsamples < len(samples):
        ts = sym_ops.timesearch_from_csum(csum, firstsample, halfclock,
                                          framesym, 1, noff)
        firstsample += int(ts.symphase[0])
        integ = sym_ops.integrate_from_csum(csum, firstsample, halfclock,
                                            framesym, 1)[0].cpu().numpy()
        energy = float((integ.astype(np.float64) ** 2).mean())
        gain = 75.0 / np.sqrt(energy)  # bitsync.c:228 "Hack"
        soft_all.append(np.clip(gain * integ + 128, 0, 255).astype(np.uint8))
        infos.append(dict(firstsample=firstsample, energy=energy,
                          symrate=symrate))
        firstsample = int(firstsample + framesym * symbolsamples)
    if not soft_all:
        return BitsyncResult(frames=[], bits=np.zeros(0, np.uint8), infos=[])
    dev = csum.device
    stream = np.concatenate(soft_all)
    aligned, _ = auto_phase_flip(stream[None, :], code, device=dev)
    dec = vdecode_stream(aligned, decode_delay, code, device=dev)
    framed = frame_bits(dec.bits, device=dev)
    return BitsyncResult(frames=framed.frames, bits=dec.bits[0], infos=infos)


def inverse_erf(z: float, terms: int = 100) -> float:
    """Series-expansion inverse error function (erf1, icesync.c:414-437)."""
    c = [1.0]
    for k in range(1, terms):
        s = 0.0
        for m in range(k):
            s += c[m] * c[k - 1 - m] / ((m + 1) * (2 * m + 1))
        c.append(s)
    x = z * np.sqrt(np.pi) / 2
    return float(sum(c[k] / (2 * k + 1) * x ** (2 * k + 1) for k in range(terms)))


def ebn0_from_symbol_errors(symerrors: int, nsymbols: int) -> float | None:
    """Eb/N0 estimate from the re-encode symbol error rate
    (icesync.c:392-402): esn0_amp = erfc^-1(2·SER), Eb/N0 = 2·esn0²;
    None for no errors ("> 10.5 dB" in the reference)."""
    if symerrors == 0:
        return None
    esn0 = inverse_erf(1 - 2.0 * symerrors / nsymbols)
    esn0 = esn0 * esn0
    return float(10 * np.log10(2 * esn0))
