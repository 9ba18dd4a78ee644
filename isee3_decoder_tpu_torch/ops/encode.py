"""Vectorized convolutional encoder (encode.c:17-35).

Each output symbol is a binary correlation of the last K input bits with
the generator taps, so a whole batch of frames encodes as K shifted XOR
accumulations — the same formulation as the JAX package.
"""

from __future__ import annotations

import torch

from isee3_decoder_tpu_torch.config import DEFAULT_CODE, CodeSpec
from isee3_decoder_tpu_torch.utils import profiling


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """Unpack uint8 bytes to bits, MSB first (encode.c:26 bit order)."""
    data = data.to(torch.uint8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """Pack bits (MSB first) into uint8 bytes; inverse of bytes_to_bits."""
    n = bits.shape[-1] // 8
    b = bits.reshape(*bits.shape[:-1], n, 8).to(torch.int32)
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def _poly_taps(poly: int, kb: int) -> tuple[int, ...]:
    """Delays j where the polynomial has a 1 bit (kb = CodeSpec.kbits)."""
    return tuple(j for j in range(kb) if (poly >> j) & 1)


def encode_bits(
    bits: torch.Tensor,
    encstate: torch.Tensor | int = 0,
    code: CodeSpec = DEFAULT_CODE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode a block of data bits.

    Args:
      bits: (..., nbits) 0/1 data bits, transmitted in order.
      encstate: (...,) tensor or scalar starting encoder state (low
        kbits used; bit j holds the input bit from j+1 steps before).
      code: code spec.

    Returns (symbols (..., 2*nbits) uint8 with POLY1 at even indices,
    final kbits-wide encoder state (...,) int64).
    """
    kb = code.kbits
    dev = bits.device
    bits = bits.to(torch.int32)
    lead = bits.shape[:-1]
    nbits = bits.shape[-1]
    if isinstance(encstate, int):
        hist = profiling.upload(
            "encode/state", [(encstate >> j) & 1 for j in range(kb - 2, -1, -1)],
            dev, torch.int32,
        ).expand(*lead, kb - 1)
    else:
        if kb > 62:
            raise ValueError(f"{code.name}: tensor encstate carries 62 bits")
        es = encstate.to(torch.int64)
        shifts = torch.arange(kb - 2, -1, -1, dtype=torch.int64, device=dev)
        hist = ((es[..., None] >> shifts) & 1).to(torch.int32)
        hist = hist.expand(*lead, kb - 1)
    x = torch.cat([hist, bits], dim=-1)

    def correlate(poly: int, flip: int) -> torch.Tensor:
        acc = torch.zeros_like(bits)
        for j in _poly_taps(poly, kb):
            acc = acc ^ x[..., kb - 1 - j : kb - 1 - j + nbits]
        return acc ^ 1 if flip else acc

    s1 = correlate(code.poly1, code.g1flip)
    s2 = correlate(code.poly2, code.g2flip)
    symbols = torch.stack([s1, s2], dim=-1).reshape(*lead, 2 * nbits)
    weights = 1 << torch.arange(kb, dtype=torch.int64, device=dev)
    tail = x[..., x.shape[-1] - kb :].flip(-1).to(torch.int64)
    final_state = (tail * weights).sum(dim=-1)
    return symbols.to(torch.uint8), final_state


def encode_bytes(
    data: torch.Tensor,
    encstate: torch.Tensor | int = 0,
    code: CodeSpec = DEFAULT_CODE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Byte-level wrapper of the reference's API (encode.c:17-22)."""
    return encode_bits(bytes_to_bits(data), encstate, code)


def reencode_symbol_errors(
    decoded_bits: torch.Tensor,
    soft_symbols: torch.Tensor,
    encstate: torch.Tensor | int,
    code: CodeSpec = DEFAULT_CODE,
) -> torch.Tensor:
    """Re-encode decoded bits and count hard-decision symbol mismatches
    (..., ) int64: the reference chain's self-check (icesync.c:381-390,
    vdecode.c:174-177), re-encoding the decoder's output and comparing it
    with hard slices (> 128) of the received soft symbols to estimate the
    channel's symbol error rate."""
    symbols, _ = encode_bits(decoded_bits, encstate, code)
    hard = (soft_symbols.to(torch.int32) > 128).to(torch.uint8)
    return (symbols != hard).sum(dim=-1)
