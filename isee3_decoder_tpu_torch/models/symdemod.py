"""symdemod stage model: windowed symbol-timing tracking over a stream.

The reference's main loop (symdemod.c:96-195) processes one ``window``
seconds of baseband per iteration: full timing search, then the real
demodulation with gain = 100/sqrt(maxenergy).  The prefix sum of the
whole block is computed once; each window is a set of gathers at
carry-dependent edges, the carry being the per-channel firstsample.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from isee3_decoder_tpu_torch.ops import symbols as sym_ops
from isee3_decoder_tpu_torch.ops.symbols import SymConfig


class SymWindowOut(NamedTuple):
    soft: torch.Tensor  # (nwindows, B, nsymbols) uint8 soft decisions
    symphase: torch.Tensor  # (nwindows, B) timing adjustment chosen
    energy: torch.Tensor  # (nwindows, B) max mean energy per symbol
    firstsample: torch.Tensor  # (nwindows, B) absolute window start used


def initial_firstsample(cfg: SymConfig) -> int:
    """firstsample = Symbolsamples/2 (symdemod.c:94, int truncation)."""
    return int(cfg.symbolsamples / 2)


def window_samples(cfg: SymConfig) -> int:
    """Samples consumed per window."""
    return int(cfg.window * cfg.samprate)


def symdemod_scan(
    samples: torch.Tensor,
    cfg: SymConfig,
    nwindows: int,
    firstsample0: torch.Tensor | int | None = None,
) -> tuple[torch.Tensor, SymWindowOut]:
    """Demodulate ``nwindows`` windows from (B, L) baseband samples →
    (final firstsample, outputs stacked over the window axis).  The
    prefix sum of int16 samples comes from kernel K3
    (ops/symbols.samples_csum), padded by the JAX package's rule."""
    csum = sym_ops.samples_csum(samples, sym_ops.SEARCH_PAD)
    return symdemod_scan_csum(csum, cfg, nwindows, firstsample0)


def symdemod_scan_csum(
    csum: torch.Tensor,
    cfg: SymConfig,
    nwindows: int,
    firstsample0: torch.Tensor | int | None = None,
) -> tuple[torch.Tensor, SymWindowOut]:
    """symdemod_scan against a precomputed (B, >=L+1) int32 exclusive
    prefix sum of the baseband whose last column holds the total (kernel
    K3 with tail >= 1)."""
    B = csum.shape[0]
    nsym = cfg.nsymbols
    if firstsample0 is None:
        firstsample0 = initial_firstsample(cfg)
    first = torch.as_tensor(firstsample0, dtype=torch.int64,
                            device=csum.device).expand(B).clone()
    outs = []
    for _ in range(nwindows):
        ts = sym_ops.timesearch_from_csum(
            csum, first, cfg.halfclock, nsym, cfg.symbolclocks, cfg.noffsets
        )
        first = first + ts.symphase
        integ = sym_ops.integrate_from_csum(
            csum, first, cfg.halfclock, nsym, cfg.symbolclocks
        )
        gain = 100.0 / torch.sqrt(ts.maxenergy)  # symdemod.c:190 "Hack"
        soft, _ = sym_ops.finish_demod(integ, gain)
        outs.append(SymWindowOut(soft=soft, symphase=ts.symphase,
                                 energy=ts.maxenergy, firstsample=first))
        # firstsample += nsymbols * Symbolsamples with C int truncation
        # of the double sum (symdemod.c:192)
        first = torch.trunc(
            first.to(torch.float64) + nsym * cfg.symbolsamples
        ).to(torch.int64)
    if not outs:
        empty = torch.empty((0, B), dtype=torch.int64, device=csum.device)
        return first, SymWindowOut(
            soft=torch.empty((0, B, nsym), dtype=torch.uint8, device=csum.device),
            symphase=empty, energy=empty.to(torch.float64), firstsample=empty,
        )
    return first, SymWindowOut(*(torch.stack(f) for f in zip(*outs)))
