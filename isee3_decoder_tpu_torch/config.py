"""Convolutional code definitions and framing constants (code.h:20-175,
decode.c:21-24, symdemod.c:15-18).

The port's own copy of ``isee3_decoder_tpu.config``: the port imports
nothing of the JAX package.  tests/test_torch_codec.py holds every
``CodeSpec`` of the catalogue, the constants and ``sync_vector`` equal
to the JAX package's, so the two cannot drift apart silently.
"""

from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """A rate-1/2 binary convolutional code: the two generator
    polynomials, the constraint length K and the two output-inversion
    flags (code.h:59-63)."""

    name: str
    poly1: int
    poly2: int
    k: int
    g1flip: int = 0
    g2flip: int = 0

    @property
    def nstates(self) -> int:
        """Number of trellis states, 2**(K-1)."""
        return 1 << (self.k - 1)

    @property
    def kbits(self) -> int:
        """Effective constraint width in state bits.  The reference
        carries an unmasked 64-bit encoder state (encode.c:27,
        fano.c:13-19), so a polynomial longer than K still taps those
        extra history bits; any state masking must use this width."""
        return max(self.k, self.poly1.bit_length(), self.poly2.bit_length())

    @property
    def state_mask(self) -> int:
        return (1 << (self.k - 1)) - 1

    @property
    def encstate_mask(self) -> int:
        return (1 << self.k) - 1


def _octal(s: str) -> int:
    return int(s, 8)


# The full catalogue from code.h.  Names follow the reference comments.
MCQLI24 = CodeSpec("MCQLI24", _octal("073665667"), _octal("073665665"), 24, 0, 1)
MCQLI32 = CodeSpec("MCQLI32", 0xBBEF6BB7, 0xBBEF6BB5, 32)
MJ = CodeSpec("MJ", 0xB840A20F, 0xB840A20D, 32)
LL = CodeSpec("LL", 0xF2D05351, 0xE4613C47, 32)
RJ1 = CodeSpec("RJ1", _octal("074121017"), _octal("074121015"), 24)
RJ2 = CodeSpec("RJ2", _octal("073541017"), _octal("073541015"), 24)
BJ24 = CodeSpec("BJ24", _octal("054220245"), _octal("063557533"), 24)
QR24 = CodeSpec("QR24", _octal("026241177"), _octal("037620515"), 24)
OT24 = CodeSpec("OT24", _octal("062650457"), _octal("062650455"), 24)
JP24 = CodeSpec("JP24", _octal("052431655"), _octal("061411757"), 24)
MCQLI48 = CodeSpec("MCQLI48", _octal("06556767373665667"), _octal("06556767373665665"), 48)
JQLIODP48 = CodeSpec("JQLIODP48", _octal("05634247020121017"), _octal("05634247020121015"), 48)
BLLF47 = CodeSpec("BLLF47", 1, _octal("0531746407671547"), 45)
JSODP47 = CodeSpec("JSODP47", 1, _octal("03331355751514473"), 47)
J60 = CodeSpec("J60", 1, _octal("073607331355751514473"), 60)
J50 = CodeSpec("J50", _octal("075634247020121017"), _octal("075634247020121015"), 50)

CODES = {
    c.name: c
    for c in (
        MCQLI24, MCQLI32, MJ, LL, RJ1, RJ2, BJ24, QR24, OT24, JP24,
        MCQLI48, JQLIODP48, BLLF47, JSODP47, J60, J50,
    )
}

#: The active code, as in the reference build (code.h:2).
DEFAULT_CODE = MCQLI24

# Framing constants (decode.c:21-24, symdemod.c:15-18)
FRAMEBITS = 1024  # bits per minor frame
FRAMESYMBOLS = 2 * FRAMEBITS  # rate-1/2 code
SYNCBITS = 34  # last 34 encoded sync symbols are invariant
SYNCWORD = 0x12FC819FBE  # last 5 bytes of every frame
SYNC_STATE = SYNCWORD & 0xFFFFFF  # known encoder state after sync (decode.c:220)

NOMINALCLOCK = 1024.0
ACTUALCLOCK = 1024.545058  # measured spacecraft clock @128 sps (symdemod.c:18)


def parity(x: int) -> int:
    """Parity of an arbitrary-width Python int (encode.c:4-6)."""
    return bin(x).count("1") & 1


@functools.lru_cache(maxsize=None)
def sync_vector(code: CodeSpec = DEFAULT_CODE) -> tuple[int, ...]:
    """The 34 invariant encoded sync symbols, derived as icesync.c:55-74
    does: the 5 syncword bytes through the encoder from state 0, keeping
    the last SYNCBITS of the 80 symbols (equals decode.c:37-40)."""
    data = SYNCWORD.to_bytes(5, "big")
    enc = 0
    syms = []
    for byte in data:
        for i in range(7, -1, -1):
            enc = (enc << 1) | ((byte >> i) & 1)
            syms.append(code.g1flip ^ parity(enc & code.poly1))
            syms.append(code.g2flip ^ parity(enc & code.poly2))
    return tuple(syms[-SYNCBITS:])
