"""ctypes binding of the native IO runtime (native/isee3_io.cpp): the
port's own loader, with the API of the JAX package's utils/native.

The library is built from the repository's source at first use, with
``g++`` and the flags of native/Makefile, into
``<repo>/build/native_io/libisee3_io_<hash>.so`` (git-ignored), the hash
taken over the source, the flags and the CPU that ``-march=native``
resolves to (a copy of the tree on another machine builds its own);
nothing is written into native/, and no library but one this loader
built is loaded.  ``available()`` says whether the build
and load succeeded.

These are host tools, not device kernels: ``iq_deinterleave`` and
``StreamReader`` keep numpy paths for a machine without a compiler, as
the JAX package's do; the golden codecs (``conv_encode``,
``viterbi_decode_frame``) are the independent reference that the port's
encoder and Viterbi decoders are checked against where JAX is absent,
and raise when the library is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "isee3_io.cpp"
BUILD_DIR = _ROOT / "build" / "native_io"
#: native/Makefile's CXXFLAGS and link line
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-lpthread")

_LIB: ctypes.CDLL | None = None
_TRIED = False
#: why the last build or load failed ("" when it succeeded)
build_error = ""


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: set CXX to a C++17 compiler")
    return cxx


def _native_arch(cxx: str) -> str:
    """The target ``-march=native`` selects on this machine."""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, timeout=60)
    return " ".join(line.split()[-1] for line in out.stdout.splitlines()
                    if line.strip().startswith("-march="))


def library_path(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Where the library for the current source, flags and CPU lies."""
    cxx = _compiler()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((cxx, *CXXFLAGS, *LDFLAGS, _native_arch(cxx))).encode())
    return pathlib.Path(build_dir) / f"libisee3_io_{h.hexdigest()[:16]}.so"


def build_library(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile native/isee3_io.cpp into ``build_dir`` unless the library
    for the current source is there already; return its path.  Raises
    RuntimeError when there is no compiler or the compile fails."""
    path = library_path(build_dir)
    if path.exists():
        return path
    cxx = _compiler()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        out = subprocess.run(
            [cxx, *CXXFLAGS, *LDFLAGS[:1], "-o", str(tmp), str(SOURCE),
             *LDFLAGS[1:]],
            capture_output=True, text=True, timeout=300,
        )
        if out.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({out.returncode}):\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.iq_deinterleave.restype = None
    lib.iq_deinterleave.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.conv_encode.restype = ctypes.c_uint64
    lib.conv_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64,
    ]
    lib.viterbi_decode_frame.restype = ctypes.c_int
    lib.viterbi_decode_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.stream_reader_create.restype = ctypes.c_void_p
    lib.stream_reader_create.argtypes = [ctypes.c_int, ctypes.c_int64]
    lib.stream_reader_read.restype = ctypes.c_int64
    lib.stream_reader_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.stream_reader_destroy.restype = None
    lib.stream_reader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> ctypes.CDLL | None:
    """The library, built and loaded on first use; None when that failed
    (``build_error`` says why)."""
    global _LIB, _TRIED, build_error
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _bind(ctypes.CDLL(str(build_library())))
            build_error = ""
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            build_error = str(e)
    return _LIB


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {build_error}")
    return lib


def iq_deinterleave(raw: np.ndarray, flip: bool = False) -> np.ndarray:
    """Interleaved int16 I,Q → complex64 (native when available); ``flip``
    swaps I and Q (pmdemod.c:218-230)."""
    raw = np.ascontiguousarray(raw, "<i2")
    n = raw.size // 2
    lib = _load()
    if lib is None:
        arr = raw.astype(np.float32).reshape(-1, 2)
        i, q = (arr[:, 1], arr[:, 0]) if flip else (arr[:, 0], arr[:, 1])
        return (i + 1j * q).astype(np.complex64)
    out_i = np.empty(n, np.float32)
    out_q = np.empty(n, np.float32)
    lib.iq_deinterleave(
        raw.ctypes.data, n, out_i.ctypes.data, out_q.ctypes.data, int(flip)
    )
    return (out_i + 1j * out_q).astype(np.complex64)


def conv_encode(data: np.ndarray, code, state: int = 0) -> tuple[np.ndarray, int]:
    """Golden encoder: uint8 bytes, MSB first → (symbols (16 per byte)
    uint8, the final K-bit encoder state)."""
    lib = _require()
    data = np.ascontiguousarray(data, np.uint8)
    out = np.empty(data.size * 16, np.uint8)
    final = lib.conv_encode(
        data.ctypes.data, data.size, out.ctypes.data,
        code.poly1, code.poly2, code.k, code.g1flip, code.g2flip,
        state & ((1 << 64) - 1),
    )
    return out, int(final)


def viterbi_decode_frame(
    syms: np.ndarray, nbits: int, start_state: int, end_state: int, code
) -> np.ndarray:
    """Golden Viterbi decode of one frame of 2·nbits soft symbols →
    (nbits,) uint8 bits.  Its decision tape takes nbits · 2^(K-1) bytes
    (805 MB for a 96-bit frame at K = 24)."""
    lib = _require()
    syms = np.ascontiguousarray(syms, np.uint8)
    if syms.size != 2 * nbits:
        raise ValueError(f"{syms.size} symbols for {nbits} bits")
    out = np.empty(nbits, np.uint8)
    r = lib.viterbi_decode_frame(
        syms.ctypes.data, nbits, start_state & 0xFFFFFFFF,
        end_state & 0xFFFFFFFF, code.poly1, code.poly2, code.k, code.g1flip,
        code.g2flip, out.ctypes.data,
    )
    if r != 0:
        raise RuntimeError(f"viterbi_decode_frame returned {r}")
    return out


class StreamReader:
    """Background-thread ring-buffer reader over a file descriptor (the
    native reader when available, buffered reads of a dup of ``fd``
    otherwise).  ``read(n)`` returns n bytes, fewer only at end of
    stream.  Close it, or use it as a context manager."""

    def __init__(self, fd: int, capacity: int = 1 << 24):
        lib = _load()
        self._lib = lib
        self._file = None
        self._handle = None
        if lib is None:
            self._file = os.fdopen(os.dup(fd), "rb", buffering=0)
        else:
            self._handle = lib.stream_reader_create(fd, capacity)

    def read(self, nbytes: int) -> bytes:
        if self._handle is None:
            chunks = []
            got = 0
            while got < nbytes:
                b = self._file.read(nbytes - got)
                if not b:
                    break
                chunks.append(b)
                got += len(b)
            return b"".join(chunks)
        buf = np.empty(nbytes, np.uint8)
        n = self._lib.stream_reader_read(self._handle, buf.ctypes.data, nbytes)
        return buf[:n].tobytes()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.stream_reader_destroy(self._handle)
            self._handle = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "StreamReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
