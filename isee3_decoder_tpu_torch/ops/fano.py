"""Batched soft-decision Fano sequential decoder (fano.c).

Per-node 4-way branch metrics (fano.c:70-80), the threshold walk with
delta tightening/relaxation (fano.c:110-189), known tail-bit forcing
(fano.c:141-147) and a cycles-per-bit timeout (fano.c:106,110).  The
walk itself runs in kernel K4 (``fano_cuda.fano_walk``) on the card and
in its plain lockstep version on the CPU; the metric precompute and the
root-node setup stay here, as they stay in jnp outside the JAX
package's Pallas call.  Codes of fewer than 30 effective state bits
(MCQLI-24 and the other K=24 codes) take the packed walk with an int32
state word; the wide codes (MCQLI32, MJ, LL, BLLF47, JSODP47, MCQLI48,
JQLIODP48, J50, J60) take K4's wide variant with an int64 one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from isee3_decoder_tpu_torch.config import DEFAULT_CODE, CodeSpec
from isee3_decoder_tpu_torch.utils import profiling


class FanoResult(NamedTuple):
    bits: torch.Tensor  # (B, nbits) uint8 decoded bits (valid up to goodbits)
    goodbits: torch.Tensor  # (B,) int32 — == nbits on success (fano.c:195)
    metric: torch.Tensor  # (B,) int32 final path metric (fano.c:190)
    cycles: torch.Tensor  # (B,) int32 forward-look count (fano.c:191)

    @property
    def success(self) -> torch.Tensor:
        return self.goodbits == self.bits.shape[-1]


@dataclasses.dataclass(frozen=True)
class FanoParams:
    """Search parameters (decode.c:66-73 defaults)."""

    delta: int = 32  # threshold step (Fano_delta = 4 * Fano_scale)
    maxcycles: int = 100  # forward looks per bit before giving up


def _parity(x: torch.Tensor) -> torch.Tensor:
    """Parity of the set bits (encode.c:4-6) by XOR folding; an int64
    word folds its high half in first."""
    if x.dtype == torch.int64:
        x = x ^ (x >> 32)
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


def _makesyms(enc: torch.Tensor, code: CodeSpec) -> torch.Tensor:
    """Symbol pair for an encoder state: POLY1 in bit 1, POLY2 in bit 0
    (fano.c:28-34, including its quirk of XORing G1FLIP into bit 0 after
    the shift — harmless, every catalogued code has G1FLIP == 0)."""
    s1 = (_parity(enc & code.poly1) << 1) ^ code.g1flip
    s2 = _parity(enc & code.poly2) ^ code.g2flip
    return s1 | s2


def _metrics4(symbols: torch.Tensor, mettab: torch.Tensor, nbits: int) -> torch.Tensor:
    """(B, nbits, 4) int32 branch metrics per node (fano.c:70-80)."""
    B = symbols.shape[0]
    mettab = mettab.to(device=symbols.device, dtype=torch.int32)
    syms = symbols.to(torch.int64).reshape(B, nbits, 2)
    m_s0 = mettab[:, syms[..., 0]]  # (2, B, nbits)
    m_s1 = mettab[:, syms[..., 1]]
    return torch.stack(
        [
            m_s0[0] + m_s1[0],
            m_s0[0] + m_s1[1],
            m_s0[1] + m_s1[0],
            m_s0[1] + m_s1[1],
        ],
        dim=-1,
    ).contiguous()


def fano_decode(
    symbols: torch.Tensor,
    mettab: torch.Tensor,
    nbits: int,
    encstate: int | torch.Tensor = 0,
    tailbits: int | torch.Tensor = 0,
    code: CodeSpec = DEFAULT_CODE,
    params: FanoParams = FanoParams(),
    skip: torch.Tensor | None = None,
) -> FanoResult:
    """Decode (B, 2*nbits) uint8 offset-binary soft symbols with the Fano
    algorithm.

    Args:
      mettab: (2, 256) int32 metric table from gen_met.
      nbits: frame length including the K-1 tail.
      encstate: starting encoder state (decode.c passes SYNCWORD & 0xffffff).
      tailbits: known tail sequence forced at the last K-1 nodes.
      skip: optional (B,) bool — lanes already decoded by a cheaper
        tier start done (their result rows are meaningless).

    ``goodbits == nbits`` signals success as the reference's return value
    does (fano.c:38,204).

    Codes of 30 or more state bits (JAX fano.py:162) take the wide walk:
    their host-int ``encstate`` / ``tailbits`` go in as int64 lanes.
    """
    if is_wide(code):
        return _fano_decode_wide(symbols, mettab, nbits, encstate, tailbits,
                                 code, params, skip)
    return _fano_decode_packed(symbols, mettab, nbits, encstate, tailbits,
                               code, params, skip)


def is_wide(code: CodeSpec) -> bool:
    """True for the codes whose walk carries 30 or more state bits."""
    return code.kbits + 1 >= 31


def _fano_decode_packed(
    symbols: torch.Tensor,
    mettab: torch.Tensor,
    nbits: int,
    encstate: int | torch.Tensor = 0,
    tailbits: int | torch.Tensor = 0,
    code: CodeSpec = DEFAULT_CODE,
    params: FanoParams = FanoParams(),
    skip: torch.Tensor | None = None,
) -> FanoResult:
    """The packed single-word walk: root setup here, walk in K4 (or its
    plain version on the CPU)."""
    from isee3_decoder_tpu_torch.ops import fano_cuda

    if symbols.ndim == 1:
        symbols = symbols[None, :]
    metrics4, regs = _walk_inputs(symbols, mettab, nbits, encstate, tailbits,
                                  code, skip)
    bits, stats = fano_cuda.fano_walk(metrics4, regs, code, params.delta,
                                      params.maxcycles)
    return _result(bits, stats, nbits)


def _fano_decode_wide(
    symbols: torch.Tensor,
    mettab: torch.Tensor,
    nbits: int,
    encstate: int | torch.Tensor,
    tailbits: int | torch.Tensor,
    code: CodeSpec,
    params: FanoParams,
    skip: torch.Tensor | None,
) -> FanoResult:
    """The wide walk (JAX ``_fano_decode_wide``, fano.py:528) for codes of
    30 to 60 state bits: root setup here, walk in K4's wide variant (or
    its plain version on the CPU).  The JAX package splits the encoder
    state into two int32 words because its jit truncates wide ints; torch
    has int64 and kbits <= 60, so the state is one int64 word here."""
    from isee3_decoder_tpu_torch.ops import fano_cuda

    if symbols.ndim == 1:
        symbols = symbols[None, :]
    metrics4, regs = _walk_inputs(symbols, mettab, nbits, encstate, tailbits,
                                  code, skip)
    bits, stats = fano_cuda.fano_walk_wide(metrics4, regs, code, params.delta,
                                           params.maxcycles)
    return _result(bits, stats, nbits)


def _result(bits: torch.Tensor, stats: torch.Tensor, nbits: int) -> FanoResult:
    """The walk's (bits, [np, gamma, cycles, t]) as a FanoResult."""
    goodbits = stats[:, 0] + 1
    # fano.c:193-202 as used by decode.c:201: only the first goodbits/8
    # FULL bytes of the path are copied out, the rest stays zero
    node = torch.arange(nbits, dtype=torch.int32, device=bits.device)[None, :]
    valid = node < ((goodbits // 8) * 8)[:, None]
    bits = torch.where(valid, bits, 0).to(torch.uint8)
    return FanoResult(bits=bits, goodbits=goodbits, metric=stats[:, 1],
                      cycles=stats[:, 2])


def _walk_inputs(
    symbols: torch.Tensor,
    mettab: torch.Tensor,
    N: int,
    encstate: int | torch.Tensor,
    tailbits: int | torch.Tensor,
    code: CodeSpec,
    skip: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The walk's inputs for (B, 2N) soft symbols: (B, N, 4) int32 branch
    metrics and (B, 5) root registers [tm0, tm1, enc, done, tailbits],
    int32 for the packed walk and int64 for the wide one."""
    B = symbols.shape[0]
    dev = symbols.device
    metrics4 = _metrics4(symbols, mettab, N)
    word = torch.int64 if is_wide(code) else torch.int32

    def lanes(v) -> torch.Tensor:
        if word == torch.int64 and isinstance(v, int):
            v = _signed64(v)
        return profiling.upload("fano/registers", v, dev, word).expand(B)

    # root node (fano.c:81-107): the encoder hypothesis only matters mod
    # 2^kbits, which frees bit kbits of the tape word for the branch index
    encmask = (1 << code.kbits) - 1
    enc0 = (lanes(encstate) << 1) & encmask
    lsym0 = _makesyms(enc0, code).to(torch.int64)
    root = metrics4[:, 0]
    m0 = root.gather(1, lsym0[:, None])[:, 0]
    m1 = root.gather(1, (3 ^ lsym0)[:, None])[:, 0]
    better1 = m1 >= m0  # reference: m0 > m1 selects the 0-branch first
    done0 = (torch.zeros(B, dtype=word, device=dev) if skip is None
             else torch.as_tensor(skip, device=dev).expand(B).to(word))
    regs = torch.stack(
        [
            torch.where(better1, m1, m0).to(word),
            torch.where(better1, m0, m1).to(word),
            enc0 | better1.to(word),
            done0,
            lanes(tailbits),
        ],
        dim=1,
    ).contiguous()
    return metrics4, regs


def _signed64(v: int) -> int:
    """A host int's low 64 bits as a signed int64 value (the wide walk
    reads bits 0..59 of a state and 0..58 of a tail)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v
