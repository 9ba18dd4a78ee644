"""Log-likelihood metric tables for the soft-decision decoders.

Capability parity with ``metrics.c:24-89``: build ``mettab[2][256]`` for an
8-bit offset-binary quantized AWGN/BPSK channel from first principles, with
a configurable bias (0 for Viterbi, the code rate for sequential decoding)
and scale.  Host-side float64 numpy, to match the C ``erf``/``log2``/
``lrint`` arithmetic exactly.  A copy of the JAX package's
``utils/metrics.py`` (numpy only; its ``utils`` package imports JAX),
held equal by tests/test_torch_codec.py.
"""

from __future__ import annotations

import math

import numpy as np

try:  # scipy is present in the image, but keep a stdlib fallback
    from scipy.special import erf
except ImportError:  # pragma: no cover
    erf = np.vectorize(math.erf)


def _normal(x: np.ndarray) -> np.ndarray:
    """Normal CDF (metrics.c:19-21)."""
    return 0.5 + 0.5 * erf(x / np.sqrt(2.0))


def gen_met(signal: float, noise: float, bias: float, scale: float) -> np.ndarray:
    """Generate the (2, 256) int32 metric table (metrics.c:24-89).

    Bins are centered on their nominal values; bin 0 and 255 absorb the
    tails.  Probabilities that underflow to equality are treated as
    erasures; log2(0) is approximated as -33 (metrics.c:65-77).
    """
    s = np.arange(256, dtype=np.float64)
    inv_noise = 1.0 / noise
    right0 = _normal((s - 128 + 0.5 + signal) * inv_noise)
    right1 = _normal((s - 128 + 0.5 - signal) * inv_noise)
    right0[255] = 1.0
    right1[255] = 1.0
    p0 = np.diff(right0, prepend=0.0)
    p1 = np.diff(right1, prepend=0.0)

    psum = p0 + p1
    with np.errstate(divide="ignore", invalid="ignore"):
        m0 = np.where(p0 == 0, -33.0, np.log2(2 * p0 / psum) - bias)
        m1 = np.where(p1 == 0, -33.0, np.log2(2 * p1 / psum) - bias)
    # p0 == p1 (both underflowed or exactly balanced): erasure
    eq = p0 == p1
    m0 = np.where(eq, -bias, m0)
    m1 = np.where(eq, -bias, m1)

    mettab = np.stack([m0, m1]) * scale
    # lrint = round half to even
    return np.rint(mettab).astype(np.int32)


def decoder_amplitudes(total_amp: float = 100.0, est_esn0: float = 1.0) -> tuple[float, float]:
    """Split a total amplitude into (signal, noise) at an assumed Es/N0.

    Mirrors ``decode.c:120-132``: symdemod normalizes total amplitude to
    100; assuming operation at the Fano threshold (Es/N0 = 0 dB,
    Eb/N0 = 3 dB) gives the signal/noise split used for the metric table.
    """
    noise_amp = total_amp / np.sqrt(1 + 2 * est_esn0)
    sig_amp = noise_amp * np.sqrt(2 * est_esn0)
    return sig_amp, noise_amp
