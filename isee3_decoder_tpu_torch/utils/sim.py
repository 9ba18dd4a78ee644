"""AWGN/BPSK channel simulator for the 8-bit quantized soft channel
(sim.c) — the port of isee3_decoder_tpu/utils/sim.py.

The reference builds 256-bin CDF tables for the two transmit symbols
(``setup_channel``, sim.c:17-28) and samples by binary search against
``random()`` (``simulate``, sim.c:31-51), plus a direct Gaussian
alternative (``addnoise``, sim.c:150-158).  Here the draws come from an
explicit ``torch.Generator``, so a run is reproducible from its seed; the
numbers differ from the JAX package's ``jax.random`` draws for the same
seed.  ``sample_channel`` does the CDF lookup of given uniforms, so both
packages can be fed the same ones.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from isee3_decoder_tpu_torch.utils.metrics import _normal


@functools.lru_cache(maxsize=16)
def channel_cdf(signal: float, noise: float) -> np.ndarray:
    """(2, 256) float64 CDF at the right edge of each sample bin
    (setup_channel, sim.c:17-28), in probability space; bin 255 absorbs
    the upper tail."""
    s = np.arange(256, dtype=np.float64)
    inv_noise = 1.0 / noise
    cdf0 = _normal((s - 128 + 0.5 + signal) * inv_noise)
    cdf1 = _normal((s - 128 + 0.5 - signal) * inv_noise)
    cdf0[255] = 1.0
    cdf1[255] = 1.0
    return np.stack([cdf0, cdf1])


def sample_channel(u: torch.Tensor, tx: torch.Tensor, signal: float,
                   noise: float) -> torch.Tensor:
    """Soft receive symbols for 0/1 transmit symbols ``tx`` from the
    uniforms ``u`` of the same shape: the smallest bin s with
    u <= cdf[tx][s] (searchsorted, left), compared in float64.  uint8."""
    cdf = torch.as_tensor(channel_cdf(signal, noise), device=u.device)
    uu = u.to(torch.float64).contiguous()
    s0 = torch.searchsorted(cdf[0], uu, side="left")
    s1 = torch.searchsorted(cdf[1], uu, side="left")
    s = torch.where(tx.to(torch.int32) == 0, s0, s1)
    return torch.clamp(s, 0, 255).to(torch.uint8)


def simulate(generator: torch.Generator, tx: torch.Tensor, signal: float,
             noise: float) -> torch.Tensor:
    """Sample soft receive symbols for 0/1 transmit symbols (sim.c:31-51):
    float32 uniforms from ``generator`` (on tx's device) through
    sample_channel."""
    u = torch.rand(tx.shape, generator=generator, device=tx.device,
                   dtype=torch.float32)
    return sample_channel(u, tx, signal, noise)


def addnoise(generator: torch.Generator, sym: torch.Tensor, signal: float,
             noise: float) -> torch.Tensor:
    """Gaussian alternative sampler (sim.c:150-158): offset-128 BPSK +
    AWGN, rounded half to even and clipped to uint8."""
    mean = 128.0 + signal * (2 * sym.to(torch.float32) - 1)
    sample = mean + noise * torch.randn(sym.shape, generator=generator,
                                        device=sym.device, dtype=torch.float32)
    return torch.clamp(torch.round(sample), 0, 255).to(torch.uint8)


def ebn0_to_noise(signal: float, ebn0_db: float, rate: float = 0.5) -> float:
    """Noise amplitude for a given Eb/N0 (vtest224.c:93-95, fanotest.c:92):
    BPSK sees half the noise power; sqrt turns power into voltage."""
    return signal / math.sqrt(2 * rate * 10.0 ** (ebn0_db / 10.0))
