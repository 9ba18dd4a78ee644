"""Convolutional code definitions and framing constants (code.h:20-175,
decode.c:21-24, symdemod.c:15-18).

Re-exported unchanged from ``isee3_decoder_tpu.config``: that module is
pure Python, and the JAX package's ``__init__`` imports nothing else, so
importing it loads no JAX.  It is the only module of the JAX package the
port imports.
"""

from isee3_decoder_tpu.config import (
    ACTUALCLOCK,
    CODES,
    DEFAULT_CODE,
    FRAMEBITS,
    FRAMESYMBOLS,
    SYNCBITS,
    SYNCWORD,
    SYNC_STATE,
    CodeSpec,
    sync_vector,
)

__all__ = [
    "ACTUALCLOCK",
    "CODES",
    "DEFAULT_CODE",
    "FRAMEBITS",
    "FRAMESYMBOLS",
    "SYNCBITS",
    "SYNCWORD",
    "SYNC_STATE",
    "CodeSpec",
    "sync_vector",
]
