"""Shared CLI plumbing (the JAX package's cli/_io.py): binary stream IO
with the reference's byte contracts — int16 I,Q pairs in, int16
baseband, uint8 soft symbols."""

from __future__ import annotations

import sys

import numpy as np


def open_input(path: str | None):
    """File argument or stdin, binary (pmdemod.c:167-203)."""
    if path:
        return open(path, "rb")
    return sys.stdin.buffer


def read_exact(f, nbytes: int) -> bytes:
    """Read exactly nbytes or whatever remains at EOF."""
    chunks = []
    got = 0
    while got < nbytes:
        b = f.read(nbytes - got)
        if not b:
            break
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def read_iq_block(f, nsamples: int) -> np.ndarray | None:
    """nsamples of interleaved little-endian int16 I,Q → (2·nsamples,)
    int16, the form the pm kernels read, or None at EOF (a partial block
    is dropped, pmdemod.c:210-215)."""
    raw = read_exact(f, nsamples * 4)
    if len(raw) < nsamples * 4:
        return None
    return np.frombuffer(raw, "<i2").astype(np.int16)


def write_int16(data: np.ndarray) -> None:
    sys.stdout.buffer.write(np.asarray(data, "<i2").tobytes())
    sys.stdout.buffer.flush()


def write_bytes(data: np.ndarray) -> None:
    sys.stdout.buffer.write(np.asarray(data, np.uint8).tobytes())
    sys.stdout.buffer.flush()


def status(msg: str) -> None:
    """Status on stderr so stdout stays a clean data pipe (README.txt:14)."""
    print(msg, file=sys.stderr, flush=True)


def run_main(main) -> None:
    """CLI entry wrapper: exit silently on closed stdout (SIGPIPE), like
    the C tools, instead of dumping a BrokenPipeError traceback."""
    try:
        code = main()
    except BrokenPipeError:
        try:
            sys.stdout.close()
        except OSError:
            pass
        code = 0
    except KeyboardInterrupt:
        code = 130
    sys.exit(code)
