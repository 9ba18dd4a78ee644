"""Shared CLI plumbing (the JAX package's cli/_io.py, the parts the
port's tools use)."""

from __future__ import annotations

import sys


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
