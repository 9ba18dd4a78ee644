"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface (no PyTorch
headers): one ``nvcc`` per source, all started together, compiles them
and one more links the shared library, in a few seconds; ``ctypes``
binds it.  The library lands in
``<repo>/build/torch_kernels/`` (git-ignored) under a name carrying a
hash of the sources and flags, so an edited source rebuilds at the next
first use and an unchanged one loads straight away.

Each wrapper (ops/*_cuda.py) adds one to its kernel's launch count where
it launches the kernel, and records per stage which backend ran
(``backend_used``), so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

#: kernel name → launches since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "pm_locked": 0,
    "spin_down": 0,
    "prefix_sum": 0,
    "fano_walk": 0,
    "viterbi_a": 0,
    "viterbi_b": 0,
    "channelize": 0,
    "channelize2": 0,
    "windowed_dft": 0,
    "pm_scan": 0,
    "viterbi_acs": 0,
}
#: pipeline stage ("channelizer", "pm", "csum", "fano", "viterbi", and
#: "search" for K8, "pm_scan" for K9) → "cuda" or "torch", last run;
#: "pm_locked" reads K1's search design ("columns" or "direct",
#: carrier_cuda.pm_locked_plan); "spin" the spin-down design of K1 or K2
#: ("cluster" or "two_pass", carrier_cuda.spin_plan); "fano_walk" reads
#: K4's design ("warp" or "thread", fano_cuda.fano_walk_plan; "warp64"
#: or "thread64" for its wide variant);
#: "pm_scan" reads "fallback" when the fused scan's result was discarded
#: for the block scan (carrier.pm_demod_scan_csum); "viterbi_path" reads
#: "classic" (K10, ops/viterbi) or "fused" (K5/K6) for the Viterbi
#: decoder that ran on the card
backend_used: dict[str, str] = {}

_lib: ctypes.CDLL | None = None
_plain_forced = False
#: seconds build_library() spent in nvcc in this process (0.0: cached)
last_build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong
_U64 = ctypes.c_uint64
_SIGNATURES = {
    # packed, row_stride, iw, B, n, K, samprate, binsize, flip, dop,
    # chirp, tab, smem, spin_cluster, spin_threads, bb, stat, spec, cyc,
    # mom, stream
    "pm_locked_launch": (_P, _I, _P, _I, _I, _I, _F, _F, _I, _D, _P,
                         _P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    # packed, row_stride, freq, divide, B, n, samprate, flip, dop,
    # cluster, threads, bb, stat, mom, stream
    "spin_down_launch": (_P, _I, _P, _I, _I, _I, _F, _I, _D, _I, _I, _P,
                         _P, _P, _P),
    # blocks, T, B, n, tail, out, ws, tile, threads, grid, smem, stream
    "prefix_sum_launch": (_P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P),
    # metrics4, regs, B, N, tail_start, kb, delta, max_total, poly1,
    # poly2, g1flip, g2flip, warp_lanes, smem, tape, bits, stats, stream
    "fano_walk_launch": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P, _P, _P, _P),
    # the same with the wide variant's int64 regs and 64-bit polynomials
    "fano_walk_wide_launch": (_P, _P, _I, _I, _I, _I, _I, _I, _U64, _U64,
                              _I, _I, _I, _I, _P, _P, _P, _P),
    # metrics, syms, base, dec, dec_bstride, dec_tstride, B, rowb, colb,
    # nsteps, q1, q2, g1flip, g2flip, tiles, threads, smem, stream
    "viterbi_a_launch": (_P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P),
    # metrics, syms, dec, dec_bstride, dec_tstride, mins, B, rowb, colb,
    # nsteps, q1, q2, g1flip, g2flip, smem, stream
    "viterbi_b_launch": (_P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P),
    # wide, nwords, taps, twid, M, P, ring, TS, threads, oversample, nsamp,
    # pitch, grid, out, smem_bytes, stream
    "channelize_launch": (_P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _I,
                          _P, _I, _P),
    # packed, row_stride, first1, wlen, B, n, K, flip, samprate, binsize,
    # tab, smem, spec, freq, cyc, peak, stream
    "windowed_dft_launch": (_P, _L, _P, _P, _I, _I, _I, _I, _F, _F, _P, _I,
                            _P, _P, _P, _P, _P),
    # n, tab, stream
    "twiddle_table_launch": (_I, _P, _P),
    # packed, row_stride, bb0, init, B, T, n, K, samprate, binsize, width,
    # thr, top, flip, tail, tab, smem, csum, stat, tot, stream
    "pm_scan_launch": (_P, _L, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                       _I, _I, _P, _I, _P, _P, _P, _P),
    # metrics, out, syms, adjust, gmin, reset, renorm, dec, B, hbits,
    # elem_size, q1, q2, g1flip, g2flip, stream
    "viterbi_acs_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _P),
}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    backend_used.clear()


def note_backend(stage: str, backend: str) -> None:
    backend_used[stage] = backend


@contextlib.contextmanager
def plain_reference():
    """Run the plain PyTorch version of every kernel even on CUDA
    tensors, for as long as the block lasts.  For verification only:
    it lets a check run the same main path twice on the card — once
    through the kernels, once through their plain versions — and
    compare.  Nothing in the package enters it."""
    global _plain_forced
    prev = _plain_forced
    _plain_forced = True
    try:
        yield
    finally:
        _plain_forced = prev


def use_kernel(t) -> bool:
    """True when ``t`` lives on a CUDA device and no plain_reference()
    block is open: the wrapper must launch its kernel (or raise)."""
    return t.is_cuda and not _plain_forced


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (pathlib.Path(cuda_home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


def build_library() -> pathlib.Path:
    """Compile csrc/*.cu into the build directory unless a library for
    the current sources already exists there; return its path.  Each
    source compiles in an nvcc of its own, all at once; one more links."""
    global last_build_seconds
    lib_path = BUILD_DIR / f"libisee3_kernels_{_source_hash()}.so"
    if lib_path.exists():
        return lib_path
    work = BUILD_DIR / f"obj.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [work / f"{src.stem}.o" for src in _sources()]
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                  for src, o in zip(_sources(), objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        tmp.unlink(missing_ok=True)
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def run_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device``, which defaults to
    "cuda".  With no card, only ``device="cpu"`` runs: the port never
    falls back to the CPU by itself."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def place(x, device=None) -> torch.Tensor:
    """The input of an entry point as a tensor on the device it runs on:
    a CUDA tensor stays where it lies unless ``device`` names another;
    anything else goes to run_device(device)."""
    if device is None and isinstance(x, torch.Tensor) and x.is_cuda:
        return x
    return torch.as_tensor(x, device=run_device(device))
