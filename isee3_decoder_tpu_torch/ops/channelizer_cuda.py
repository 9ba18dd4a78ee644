"""Kernels K7a / K7b: the fused polyphase channelizer, and its plain
PyTorch version.

``channelize_raw_fused`` replaces the TPU kernels ``kern`` (critically
sampled bank) and ``kern2`` (2× oversampled bank) of
isee3_decoder_tpu/ops/channelizer_pallas.py:177 and :213; the CUDA source
is csrc/channelizer.cu.  One packed-int32 capture (I in the low 16 bits
of each word, Q in the high 16 — byte-identical to the interleaved int16
recording) goes in; (nchan, 2·nout) int16 interleaved I,Q per channel
comes out, ready for the receive chain's raw int16 ingestion.

A CUDA tensor goes through the kernel (or the wrapper raises); a CPU
tensor through ``channelize_raw_plain``: unpack → ops/channelizer
.channelize → trunc∘clip → int16.  Kernel and plain agree to 1 LSB on
well under 1 % of the samples (float32 rounding at truncation
boundaries: the kernel's FFT and the library's sum in other orders).
Both emit what the plain bank emits: nout = L − P + 1 frames at
oversample 1; at oversample 2 twice the frames both of its streams have
(2·(L − P), or 2·(L − P + 1) when at least half a frame trails the last
whole one).

The kernel takes channel counts that are powers of two from 32 to 256
(its transform is two register DFT stages, M = M1 × M2, ``pfb_plan``)
and up to 16 taps per branch (its register ring); ``channelize_raw_fused``
raises ``ValueError`` for any other count, on either device, and for more
taps on the card.  Its output rows have a pitch of ``pitch_words``: the
(nchan, 2·nout) result is a view of an (nchan, pitch) word buffer, rows
16-byte aligned, on either device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.ops import carrier
from isee3_decoder_tpu_torch.ops.channelizer import channelize, default_taps

MIN_NCHAN, MAX_NCHAN = 32, 256
_SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90


def supports(nchan: int) -> bool:
    """True for the channel counts the kernel takes."""
    return (MIN_NCHAN <= nchan <= MAX_NCHAN) and nchan & (nchan - 1) == 0


def _nsamp(nwords: int, nchan: int, P: int, oversample: int) -> int:
    """Output samples per channel of the plain bank for an nwords capture:
    the even stream has nwords // M − P + 1 frames, the odd stream (from
    word M/2 on) (nwords − M/2) // M − P + 1; the oversampled bank
    interleaves as many of each as both have."""
    even = nwords // nchan - P + 1
    if oversample == 1:
        return even
    odd = (nwords - nchan // 2) // nchan - P + 1
    return 2 * min(even, odd)


def _check(wide_packed: torch.Tensor, nchan: int, P: int, oversample: int) -> int:
    """Validate what both versions take; returns the output sample count."""
    if not supports(nchan):
        raise ValueError(
            f"fused channelizer needs nchan a power of two in "
            f"{MIN_NCHAN}..{MAX_NCHAN}, got {nchan}")
    if oversample not in (1, 2):
        raise ValueError("oversample must be 1 or 2")
    if wide_packed.dtype != torch.int32 or wide_packed.ndim != 1:
        raise ValueError(f"wide_packed must be (nchan*L,) int32, got "
                         f"{wide_packed.dtype} {tuple(wide_packed.shape)}")
    if P < 1:
        raise ValueError(f"taps_per_branch = {P} must be positive")
    nsamp = _nsamp(wide_packed.shape[0], nchan, P, oversample)
    if nsamp < 1:
        raise ValueError(f"capture too short: {wide_packed.shape[0] // nchan} "
                         f"frames < {P + oversample}")
    return nsamp


@functools.lru_cache(maxsize=16)
def _default_taps(nchan: int, P: int, oversample: int,
                  device: torch.device) -> torch.Tensor:
    """The default prototype on the device, made once: a copy from host
    memory per call would wait for the stream's earlier work."""
    return torch.as_tensor(default_taps(nchan, P, oversample),
                           dtype=torch.float32, device=device).reshape(-1)


def _taps(nchan: int, P: int, oversample: int, taps, device) -> torch.Tensor:
    if taps is None:
        h = _default_taps(nchan, P, oversample, torch.device(device))
    else:
        h = torch.as_tensor(taps, dtype=torch.float32,
                            device=device).reshape(-1).contiguous()
    if h.shape[0] != nchan * P:
        raise ValueError(f"taps must have nchan*taps_per_branch = {nchan * P} "
                         f"values, got {h.shape[0]}")
    return h


def unpack_wide(wide_packed: torch.Tensor) -> torch.Tensor:
    """(N,) packed int32 → (N,) complex64: I the sign-extended low half,
    Q the high half."""
    return carrier.iq_from_interleaved(wide_packed.contiguous().view(torch.int16))


def quantize_raw(chans: torch.Tensor) -> torch.Tensor:
    """(M, nout) complex → (M, 2·nout) int16 interleaved I,Q: saturate at
    ±32767, then truncate toward zero (torch's .to(int16) would wrap)."""
    ri = torch.stack([chans.real, chans.imag], dim=-1).reshape(chans.shape[0], -1)
    return torch.trunc(torch.clamp(ri, -32767.0, 32767.0)).to(torch.int16)


def channelize_raw_plain(
    wide_packed: torch.Tensor,
    nchan: int,
    taps_per_branch: int = 8,
    taps=None,
    oversample: int = 1,
) -> torch.Tensor:
    """Plain version of K7a / K7b: one packed-int32 capture →
    (nchan, 2·nout) int16 through the plain bank."""
    chans = channelize(unpack_wide(wide_packed), nchan, taps_per_branch, taps,
                       oversample)[0]
    return quantize_raw(chans)


# the kernel's launch geometry (csrc/channelizer.cu): threads a block,
# frames a tap task walks, the register rings it has, and for each channel
# count M the split M = M1 x M2 of its DFT and the tile of output samples
PFB_THREADS = 256
PFB_RUN = 16
PFB_RINGS = (8, 16)
PFB_SPLIT = {32: (8, 4, 128), 64: (8, 8, 64), 128: (16, 8, 32),
             256: (16, 16, 32)}
_SM_SMEM = 233_472  # bytes of shared memory on one SM; a block reserves 1 KB
_SM_REGS = 65_536


def pitch_words(nsamp: int) -> int:
    """The output's row pitch in (I, Q) words: nsamp rounded up to 32
    words, so every row starts on a 128-byte line (a multiple of 16 bytes,
    which the spin-down's aligned path needs) and each warp's store of 32
    consecutive words is one whole line."""
    return -(-nsamp // 32) * 32


@functools.lru_cache(maxsize=64)
def pfb_plan(nchan: int, P: int, oversample: int, nsamp: int,
             sms: int = 132) -> dict:
    """The launch plan of K7a / K7b (csrc/channelizer.cu ``pfb_kernel``):

    - ``tile`` output samples a tile, ``frames`` = tile / oversample frames
      of each stream; ``ntiles`` tiles, the last one partial when tile does
      not divide nsamp;
    - ``split`` (M1, M2): M1-point DFTs in registers for each (sample, r2),
      then M2-point ones for each (sample, k1);
    - ``ring`` PR: the register ring of a tap task (8 or 16 float pairs,
      taps zero past P), ``run`` frames a task walks; M·tile / run tap
      tasks a tile, over ``threads`` threads;
    - ``stages`` = 2 input stages of ``stage_words`` words: frames + PR
      frames and 4 words for a copy that starts on the 16-byte boundary
      below the tile; ``copy_words`` the words a tile needs, (frames + P −
      1)·M (+ M/2 at oversample 2);
    - ``smem`` bytes a block: the stages, a (tile, M + 1) float2
      workspace, 2M + 2 float2 twiddles (the table, then from M + 1 on the
      same with odd k1 negated) and two mbarriers; ``blocks_per_sm`` by
      shared memory and by ``regs`` registers a thread (64 with a ring of
      8 and 8-point first DFTs, else 80; the kernel's __launch_bounds__
      asks for as many blocks); ``grid`` = min(ntiles, blocks_per_sm ·
      sms) persistent blocks;
    - ``pitch`` words of an output row (``pitch_words``).

    Raises ValueError for a channel count the kernel does not take, a
    block past one block's shared memory, or P beyond the largest ring."""
    if not supports(nchan):
        raise ValueError(f"fused channelizer needs nchan a power of two in "
                         f"{MIN_NCHAN}..{MAX_NCHAN}, got {nchan}")
    if oversample not in (1, 2):
        raise ValueError("oversample must be 1 or 2")
    if P < 1 or nsamp < 1:
        raise ValueError(f"P = {P} and nsamp = {nsamp} must be positive")
    m1, m2, tile = PFB_SPLIT[nchan]
    ring = next((r for r in PFB_RINGS if P <= r), P)
    frames = tile // oversample
    stage_words = (frames + ring) * nchan + 4
    smem = 4 * (2 * stage_words + 2 * tile * (nchan + 1) + 4 * nchan + 4) + 16
    if smem > _SMEM_MAX:
        raise ValueError(f"taps_per_branch = {P} at nchan = {nchan} needs "
                         f"{smem} bytes of shared memory (max {_SMEM_MAX})")
    if ring not in PFB_RINGS:
        raise ValueError(f"taps_per_branch = {P}: the kernel's register ring "
                         f"holds at most {PFB_RINGS[-1]} taps")
    ntiles = -(-nsamp // tile)
    regs = 64 if ring == 8 and m1 == 8 else 80
    blocks = min(_SM_SMEM // (smem + 1024), _SM_REGS // (PFB_THREADS * regs))
    return {"tile": tile, "frames": frames, "ntiles": ntiles,
            "split": (m1, m2), "ring": ring, "run": PFB_RUN,
            "threads": PFB_THREADS, "stages": 2, "stage_words": stage_words,
            "copy_words": (frames + P - 1) * nchan
            + (nchan // 2 if oversample == 2 else 0),
            "smem": smem, "regs": regs, "blocks_per_sm": blocks,
            "grid": min(ntiles, blocks * sms), "pitch": pitch_words(nsamp)}


@functools.lru_cache(maxsize=8)
def _twiddles(nchan: int, device: torch.device) -> torch.Tensor:
    """(M, 2) float32: W_M^{r2·k1} = exp(−2πi·r2·k1/M) at row r2·M1 + k1,
    the turn between the kernel's two DFT stages; made in float64,
    rounded to float32 once."""
    m1, m2, _ = PFB_SPLIT[nchan]
    rk = np.outer(np.arange(m2), np.arange(m1)).reshape(-1)
    ang = -2.0 * np.pi * rk / nchan
    tab = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.as_tensor(tab, device=device)


def _padded(nchan: int, nsamp: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """An (nchan, pitch) int32 output and its (nchan, 2·nsamp) int16 view."""
    words = torch.empty((nchan, pitch_words(nsamp)), dtype=torch.int32,
                        device=device)
    return words, words.view(torch.int16)[:, : 2 * nsamp]


def channelize_raw_fused(
    wide_packed: torch.Tensor,
    nchan: int,
    taps_per_branch: int = 8,
    taps=None,
    oversample: int = 1,
) -> torch.Tensor:
    """K7a (oversample 1) / K7b (oversample 2): one packed-int32 wideband
    capture → (nchan, 2·nout) int16 raw.

    Args:
      wide_packed: (nchan*L,) int32 packed IQ samples at rate
        nchan·samprate (I = low 16 bits, Q = high 16, sign-extended).
      nchan: channel count M, a power of two in 32..256.
      taps: optional prototype filter, len M·taps_per_branch (default the
        Kaiser sinc of ops/channelizer.prototype_lowpass with the plain
        bank's cutoff per oversample mode).
      oversample: 1 = critically sampled; 2 = the 2× oversampled bank
        (hop M/2; the odd output samples' odd bins sign-flipped), in which
        a carrier at a channel edge stays unaliased and decodable.

    Returns (nchan, 2·nout) int16 interleaved I,Q per channel at rate
    oversample·fs_in/M: nout = L − P + 1 at oversample 1, the plain
    bank's 2·min(even, odd frames) at 2; a view whose rows lie
    2·pitch_words(nout) values apart.
    """
    P = taps_per_branch
    nsamp = _check(wide_packed, nchan, P, oversample)
    if not _kernels.use_kernel(wide_packed):
        _kernels.note_backend("channelizer", "torch")
        _, raw = _padded(nchan, nsamp, wide_packed.device)
        raw.copy_(channelize_raw_plain(wide_packed, nchan, P, taps, oversample))
        return raw
    if not wide_packed.is_contiguous():
        raise ValueError("wide_packed must be contiguous")
    dev = wide_packed.device
    plan = pfb_plan(nchan, P, oversample, nsamp,
                    torch.cuda.get_device_properties(dev).multi_processor_count)
    h = _taps(nchan, P, oversample, taps, dev)
    words, raw = _padded(nchan, nsamp, dev)
    name = "channelize" if oversample == 1 else "channelize2"
    err = _kernels.lib().channelize_launch(
        wide_packed.data_ptr(), wide_packed.shape[0], h.data_ptr(),
        _twiddles(nchan, dev).data_ptr(), nchan, P, plan["ring"], plan["tile"],
        plan["threads"], oversample, nsamp, plan["pitch"], plan["grid"],
        words.data_ptr(), plan["smem"], _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "channelize_launch")
    _kernels.count_launch(name)
    _kernels.note_backend("channelizer", "cuda")
    return raw
