"""The ISEE-3 telemetry code and framing, in plain PyTorch and NumPy.

A frozen copy of the receive chain's definitions (code.h:54-63,
decode.c:21-24, encode.c:17-35): the MCQLI-24 code, the frame and sync
constants, the convolutional encoder, bit packing and the Fano metric
table (metrics.c:24-89).  The traffic generator encodes with it and the
plain reference decodes with it; neither reads the program under test.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

try:
    from scipy.special import erf
except ImportError:  # pragma: no cover
    erf = np.vectorize(math.erf)


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """A rate-1/2 convolutional code: the generator polynomials, the
    constraint length K and the two output-inversion flags."""

    name: str
    poly1: int
    poly2: int
    k: int
    g1flip: int = 0
    g2flip: int = 0

    @property
    def nstates(self) -> int:
        return 1 << (self.k - 1)

    @property
    def kbits(self) -> int:
        """State bits the encoder taps: the reference's encoder state is
        an unmasked 64-bit word, so a polynomial longer than K taps
        further history bits."""
        return max(self.k, self.poly1.bit_length(), self.poly2.bit_length())

    @property
    def state_mask(self) -> int:
        return (1 << (self.k - 1)) - 1


MCQLI24 = CodeSpec("MCQLI24", 0o073665667, 0o073665665, 24, 0, 1)
CODES = {c.name: c for c in (MCQLI24,)}

FRAMEBITS = 1024
FRAMESYMBOLS = 2 * FRAMEBITS
SYNCBITS = 34  # the last 34 encoded sync symbols are invariant
SYNCWORD = 0x12FC819FBE  # the last 5 bytes of every frame
SYNC_STATE = SYNCWORD & 0xFFFFFF  # encoder state after the syncword


def parity(x: int) -> int:
    return x.bit_count() & 1


@functools.lru_cache(maxsize=None)
def sync_vector(code: CodeSpec = MCQLI24) -> tuple[int, ...]:
    """The 34 invariant encoded sync symbols: the syncword's 5 bytes
    through the encoder from state 0, the last SYNCBITS of 80 symbols
    (decode.c:37-40)."""
    enc = 0
    syms = []
    for byte in SYNCWORD.to_bytes(5, "big"):
        for i in range(7, -1, -1):
            enc = (enc << 1) | ((byte >> i) & 1)
            syms.append(code.g1flip ^ parity(enc & code.poly1))
            syms.append(code.g2flip ^ parity(enc & code.poly2))
    return tuple(syms[-SYNCBITS:])


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 bytes → bits, MSB first."""
    data = data.to(torch.uint8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """Bits, MSB first → uint8 bytes."""
    n = bits.shape[-1] // 8
    b = bits.reshape(*bits.shape[:-1], n, 8).to(torch.int32)
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def encode_bits(bits: torch.Tensor, encstate: int = 0,
                code: CodeSpec = MCQLI24) -> torch.Tensor:
    """(..., nbits) 0/1 bits → (..., 2·nbits) uint8 symbols, POLY1's at
    even indices, from the encoder state ``encstate`` (bit j holds the
    input bit of j + 1 steps before)."""
    kb = code.kbits
    bits = bits.to(torch.int32)
    lead = bits.shape[:-1]
    nbits = bits.shape[-1]
    hist = torch.tensor([(encstate >> j) & 1 for j in range(kb - 2, -1, -1)],
                        dtype=torch.int32, device=bits.device)
    x = torch.cat([hist.expand(*lead, kb - 1), bits], dim=-1)

    def correlate(poly: int, flip: int) -> torch.Tensor:
        acc = torch.zeros_like(bits)
        for j in range(kb):
            if (poly >> j) & 1:
                acc = acc ^ x[..., kb - 1 - j: kb - 1 - j + nbits]
        return acc ^ 1 if flip else acc

    s1 = correlate(code.poly1, code.g1flip)
    s2 = correlate(code.poly2, code.g2flip)
    return torch.stack([s1, s2], dim=-1).reshape(*lead, 2 * nbits).to(torch.uint8)


def verify_frame(bits: torch.Tensor) -> torch.Tensor:
    """True where the (..., FRAMEBITS) bits end in the syncword
    (decode.c:237-247)."""
    last40 = bits[..., -40:].to(torch.int64)
    weights = 1 << torch.arange(39, -1, -1, dtype=torch.int64, device=bits.device)
    return (last40 * weights).sum(dim=-1) == SYNCWORD


def random_frames(rng: np.random.Generator, nframes: int) -> np.ndarray:
    """(nframes, 128) frame bytes, each ending in the syncword's bytes."""
    frames = rng.integers(0, 256, (nframes, FRAMEBITS // 8), dtype=np.uint8)
    frames[:, -5:] = list(SYNCWORD.to_bytes(5, "big"))
    return frames


def frames_to_symbols(frames: np.ndarray, code: CodeSpec = MCQLI24) -> np.ndarray:
    """A contiguous stream of frames encoded from the sync state."""
    bits = bytes_to_bits(torch.as_tensor(np.asarray(frames).reshape(-1)))
    return encode_bits(bits, SYNC_STATE, code).numpy()


def _normal(x: np.ndarray) -> np.ndarray:
    return 0.5 + 0.5 * erf(x / np.sqrt(2.0))


def gen_met(signal: float, noise: float, bias: float, scale: float) -> np.ndarray:
    """(2, 256) int32 log-likelihood metric table of the 8-bit
    offset-binary AWGN channel (metrics.c:24-89)."""
    s = np.arange(256, dtype=np.float64)
    right0 = _normal((s - 128 + 0.5 + signal) / noise)
    right1 = _normal((s - 128 + 0.5 - signal) / noise)
    right0[255] = 1.0
    right1[255] = 1.0
    p0 = np.diff(right0, prepend=0.0)
    p1 = np.diff(right1, prepend=0.0)
    psum = p0 + p1
    with np.errstate(divide="ignore", invalid="ignore"):
        m0 = np.where(p0 == 0, -33.0, np.log2(2 * p0 / psum) - bias)
        m1 = np.where(p1 == 0, -33.0, np.log2(2 * p1 / psum) - bias)
    eq = p0 == p1
    m0 = np.where(eq, -bias, m0)
    m1 = np.where(eq, -bias, m1)
    return np.rint(np.stack([m0, m1]) * scale).astype(np.int32)


def fano_mettab(scale: float) -> np.ndarray:
    """decode.c:120-135: symdemod normalizes the total amplitude to 100;
    the table assumes operation at Es/N0 = 0 dB (Eb/N0 = 3 dB)."""
    noise = 100.0 / np.sqrt(3.0)
    return gen_met(noise * np.sqrt(2.0), noise, 0.5, scale)
