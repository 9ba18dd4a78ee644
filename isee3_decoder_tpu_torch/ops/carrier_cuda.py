"""Kernels K1 (locked pm block), K2 (spin-down), K8 (windowed DFT
search) and K9 (the pm scan in one launch) and their plain PyTorch
versions.

K1 ``pm_locked_fused`` replaces the TPU kernel ``_locked_kernel``
(isee3_decoder_tpu/ops/carrier_pallas.py:687); K2 ``spin_down_fused``
replaces ``_spin_kernel`` (carrier_pallas.py:214); K8
``windowed_dft_raw`` replaces ``_kernel`` (carrier_pallas.py:63), and
``windowed_search_raw`` runs it with K1's peak pass in one launch; K9
``pm_scan_locked_fused`` replaces ``_scan_kernel`` (carrier_pallas.py:363).
The CUDA source is csrc/carrier.cu.  A CUDA tensor goes through the
kernel (or the wrapper raises); a CPU tensor through the plain version
beside it, which is the JAX package's XLA path written in PyTorch
(windowed DFT by einsum, masked last-max peak, Quinn, five-moment
spin-down, int16 emission).  The launch plans (``pm_locked_plan``,
``spin_plan``, ``windowed_search_plan``, ``pm_scan_plan``) pick each
kernel's design on shape.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.ops import carrier
from isee3_decoder_tpu_torch.ops.prefix_cuda import prefix_sum_blocks_plain

SPIN_CHUNK = 4096  # samples per "two_pass" moments/emit block (csrc/carrier.cu)
SPIN_THREADS = 256  # threads of a "two_pass" block
CHIRP_CHUNK = 8192  # de-chirp coefficient chunk (csrc/carrier.cu)
SPIN_SPT = 16  # samples a thread of the "cluster" design holds
SPIN_GROUP = 8  # consecutive samples it loads and stores at once
SPIN_CLUSTER_MAX = 8  # the portable thread-block cluster size
SCAN_CHUNK = 8192  # the TPU kernels' chunk: K9's gate, K1's over K8 + K2
_SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90


def _iq_from_packed(packed: torch.Tensor, flip: bool) -> torch.Tensor:
    return carrier.iq_from_interleaved(packed.view(torch.int16), flip)


@functools.lru_cache(maxsize=8)
def chirp_table(n: int, dop: float, device: torch.device) -> torch.Tensor:
    """(n,) complex64 de-chirp phasors exp(-2πi φ(i)), φ(i) = dop·i(i+1)/2
    mod 1 in float64 (pmdemod.c:232-244, restarted every block).  The
    DFT search rotates the data by them: the chirp phase has an h·l cross
    term, so it cannot fold into the two DFT factors."""
    ii = np.arange(n, dtype=np.float64)
    ang = 2.0 * np.pi * ((dop * (ii * (ii + 1.0) / 2.0)) % 1.0)
    tab = np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)
    return torch.view_as_complex(torch.as_tensor(tab, device=device))


@functools.lru_cache(maxsize=8)
def chirp_cycles(n: int, dop: float, device: torch.device) -> torch.Tensor:
    """(n,) float32 de-chirp phase in cycles as the spin-down folds it into
    its mix angle: per 8192-sample chunk k, φ(j) = A + B256·(j//256) +
    Bk·(j%256) + C·j² with the chunk base reduced mod 1 in float64 (every
    traced term stays small enough for float32)."""
    j = torch.arange(min(n, CHIRP_CHUNK), dtype=torch.int32, device=device)
    jh, jl, jf = (j // 256).float(), (j % 256).float(), j.float()
    parts = []
    for k in range(-(-n // CHIRP_CHUNK)):
        base = float(k) * CHIRP_CHUNK
        A = (0.5 * dop * base * base + 0.5 * dop * base) % 1.0
        Bk = (dop * base + 0.5 * dop) % 1.0
        B256 = (256.0 * Bk) % 1.0
        f32 = np.float32
        parts.append(f32(A) + f32(B256) * jh + f32(Bk) * jl
                     + f32(0.5 * dop) * (jf * jf))
    return torch.cat(parts)[:n]


def spin_down_plain(
    packed: torch.Tensor, carrier_freq: torch.Tensor, samprate: float,
    flip: bool = False, dop: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2: (B, n) packed int32 IQ + (B,) Hz →
    (baseband int16 (B, n), amp, cn0_db).  ``dop`` (cycles/sample²)
    folds the Doppler de-chirp into the mix angle."""
    iq = _iq_from_packed(packed, flip)
    extra = chirp_cycles(iq.shape[1], dop, iq.device) if dop else None
    rotated, amp, cn0 = carrier.spin_down(iq, carrier_freq, samprate, extra)
    return carrier.emit_baseband(rotated), amp, cn0


def _locked_bins(iq: torch.Tensor, first1: torch.Tensor, K: int,
                 dop: float) -> torch.Tensor:
    """K1's search bins: the windowed DFT of the de-chirped samples."""
    search = iq * chirp_table(iq.shape[1], dop, iq.device) if dop else iq
    return carrier.windowed_dft(search, first1, K)


def pm_locked_bins_plain(packed: torch.Tensor, first1: torch.Tensor, K: int,
                         flip: bool = False, dop: float = 0.0) -> torch.Tensor:
    """The (B, K) complex64 window bins pm_locked_plain searches: bins
    first1 .. first1+K-1 (mod n) of the de-chirped row's n-point DFT."""
    return _locked_bins(_iq_from_packed(packed, flip), first1, K, dop)


def pm_locked_plain(
    packed: torch.Tensor,
    first1: torch.Tensor,
    wlen: torch.Tensor,
    K: int,
    samprate: float,
    binsize: float,
    flip: bool = False,
    dop: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1: (B, n) packed int32 IQ, window start bins
    first1 = firstbin-1 and wlen = lastbin-firstbin → (baseband int16,
    carrier_freq, amp, cn0_db)."""
    iq = _iq_from_packed(packed, flip)
    n = iq.shape[1]
    S = _locked_bins(iq, first1, K, dop)
    freq, _ = carrier.windowed_peak(S, first1, wlen, binsize, samprate)
    extra = chirp_cycles(n, dop, iq.device) if dop else None
    rotated, amp, cn0 = carrier.spin_down(iq, freq, samprate, extra)
    return carrier.emit_baseband(rotated), freq, amp, cn0


def _check_packed(packed: torch.Tensor, out: torch.Tensor | None) -> None:
    if packed.dtype != torch.int32 or packed.ndim != 2:
        raise ValueError(f"packed must be (B, n) int32, got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if packed.stride(1) != 1:
        raise ValueError("packed rows must be contiguous")
    B, n = packed.shape
    if n % 256 != 0 or n <= 0:
        raise ValueError(f"n = {n} must be a positive multiple of 256")
    if B < 1 or B > 65535:
        raise ValueError(f"B = {B} out of range 1..65535")
    if out is not None and (out.dtype != torch.int16
                            or tuple(out.shape) != (B, n)
                            or not out.is_contiguous()
                            or out.device != packed.device):
        raise ValueError("out must be a contiguous (B, n) int16 tensor "
                         "on the input's device")


@functools.lru_cache(maxsize=64)
def spin_plan(n: int, B: int, design: str | None = None) -> dict:
    """The spin-down's launch plan (csrc/carrier.cu ``spin_launch``, run by
    K2 and by K1 after its search) for B rows of n samples, chosen on
    shape:

    - ``"cluster"`` for n up to SPIN_CLUSTER_MAX · CHIRP_CHUNK = 65,536:
      ``spin_cluster_kernel``, one thread-block cluster of ``cluster`` =
      ⌈n / 8192⌉ blocks per row (grid (cluster, B)).  A block of a cluster
      of more than one owns one whole CHIRP_CHUNK, 512 threads × SPIN_SPT
      samples; a lone block (n ≤ 8192) ⌈n / 16⌉ threads rounded up to a
      warp.  Rank r, thread t, slot (p, e) holds sample r·chunk +
      SPIN_GROUP·(p·threads + t) + e (slots past n hold nothing), so a
      block's samples share one de-chirp chunk, r·chunk // CHIRP_CHUNK.
      Each sample is read once, spun once and kept in registers until the
      cluster's moments are summed; no scratch.
    - ``"two_pass"`` for longer rows: ``moments_kernel`` + ``emit_kernel``,
      grid (⌈n / SPIN_CHUNK⌉, B) of SPIN_THREADS threads, thread t, step j
      of chunk k holding sample k·SPIN_CHUNK + j·SPIN_THREADS + t; each
      pass reads the row and spins it, the moments go through an f64
      scratch of (B, ⌈n / SPIN_CHUNK⌉, 5).

    ``design`` pins one, for checks that hold both against the plain
    version; "cluster" raises where a cluster cannot hold the row.  Raises
    ValueError on what no design takes: n not a positive multiple of 256,
    n ≥ 2^30 (int32 sample indices), B outside 1..65535 (the grid's y)."""
    if n <= 0 or n % 256 != 0 or n >= 1 << 30:
        raise ValueError(f"n = {n} must be a positive multiple of 256 below "
                         "2^30")
    if not 1 <= B <= 65535:
        raise ValueError(f"B = {B} out of range 1..65535")
    cluster = -(-n // CHIRP_CHUNK)
    if design is None:
        design = "cluster" if cluster <= SPIN_CLUSTER_MAX else "two_pass"
    if design == "two_pass":
        nchunk = -(-n // SPIN_CHUNK)
        return {"design": "two_pass", "cluster": 0, "threads": SPIN_THREADS,
                "samples_per_thread": SPIN_CHUNK // SPIN_THREADS,
                "chunk": SPIN_CHUNK, "grid": (nchunk, B)}
    if design != "cluster":
        raise ValueError(f"unknown spin-down design {design!r}")
    if cluster > SPIN_CLUSTER_MAX:
        raise ValueError(f"n = {n}: a cluster of {SPIN_CLUSTER_MAX} blocks "
                         f"holds at most {SPIN_CLUSTER_MAX * CHIRP_CHUNK} "
                         "samples")
    threads = 512 if cluster > 1 else -(-n // (32 * SPIN_SPT)) * 32
    return {"design": "cluster", "cluster": cluster, "threads": threads,
            "samples_per_thread": SPIN_SPT, "group": SPIN_GROUP,
            "chunk": threads * SPIN_SPT, "grid": (cluster, B)}


def _spin_scratch(plan: dict, device) -> torch.Tensor | None:
    """The "two_pass" design's f64 moment scratch (B, chunks, 5)."""
    if plan["design"] != "two_pass":
        return None
    nchunk, B = plan["grid"]
    return torch.empty((B, nchunk, 5), dtype=torch.float64, device=device)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _put(bb: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    if out is None:
        return bb
    out.copy_(bb)
    return out


def pm_locked_fused(
    packed: torch.Tensor,
    first1: torch.Tensor,
    wlen: torch.Tensor,
    K: int,
    samprate: float,
    binsize: float,
    flip: bool = False,
    dop: float = 0.0,
    out: torch.Tensor | None = None,
    spin_design: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: one locked pm block, window search to int16 emission →
    (baseband int16 (B, n), carrier_freq, amp, cn0_db), all float32.

    ``K`` bins first1 .. first1+K-1 are evaluated (carrier._window_bins);
    callers pass the carrier._fast_search_ok gate, so 1 <= wlen <= K-2.
    ``dop`` (cycles/sample²) de-chirps; ``out`` receives the baseband.
    The search runs in the design ``pm_locked_plan`` picks, the spin-down
    in the one ``spin_plan`` picks (``_kernels.backend_used["pm_locked"]``
    and ``["spin"]``); ``spin_design`` pins the latter, for checks against
    the plain version only."""
    if not _kernels.use_kernel(packed):
        _kernels.note_backend("pm", "torch")
        bb, freq, amp, cn0 = pm_locked_plain(packed, first1, wlen, K,
                                             samprate, binsize, flip, dop)
        return _put(bb, out), freq, amp, cn0
    _check_packed(packed, out)
    B, n = packed.shape
    plan = pm_locked_plan(n, K)
    spin = spin_plan(n, B, spin_design)
    dev = packed.device
    iw = torch.stack([first1, wlen], dim=1).to(device=dev,
                                                dtype=torch.int32).contiguous()
    if iw.shape != (B, 2):
        raise ValueError("first1 and wlen must be (B,)")
    bb = out if out is not None else torch.empty((B, n), dtype=torch.int16,
                                                 device=dev)
    stat = torch.empty((B, 4), dtype=torch.float32, device=dev)
    cyc = torch.empty((B,), dtype=torch.float32, device=dev)
    mom = _spin_scratch(spin, dev)
    chirp = chirp_table(n, dop, dev) if dop else None
    columns = plan["design"] == "columns"
    spec = None if columns else torch.empty((B, K, 2), dtype=torch.float32,
                                            device=dev)
    err = _kernels.lib().pm_locked_launch(
        packed.data_ptr(), packed.stride(0), iw.data_ptr(), B, n, K,
        kernel_samprate(samprate), float(np.float32(binsize)), int(flip),
        float(dop), _ptr(chirp),
        twiddle_table(n, dev).data_ptr() if columns else None, plan["smem"],
        spin["cluster"], spin["threads"], bb.data_ptr(), stat.data_ptr(),
        _ptr(spec), cyc.data_ptr(), _ptr(mom), _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "pm_locked_launch")
    _kernels.count_launch("pm_locked")
    _kernels.note_backend("pm", "cuda")
    _kernels.note_backend("pm_locked", plan["design"])
    _kernels.note_backend("spin", spin["design"])
    return bb, stat[:, 2], stat[:, 0], stat[:, 1]


def spin_down_fused(
    packed: torch.Tensor,
    carrier_freq: torch.Tensor,
    samprate: float,
    flip: bool = False,
    dop: float = 0.0,
    out: torch.Tensor | None = None,
    design: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: spin-down at the given carrier + int16 emission →
    (baseband int16 (B, n), amp, cn0_db).  ``dop`` (cycles/sample²)
    de-chirps; ``out`` receives the baseband when given.  Runs in the
    design ``spin_plan`` picks (``_kernels.backend_used["spin"]``);
    ``design`` pins one, for checks against the plain version only.  On
    "cluster" the kernel divides the carrier by the sample rate itself
    (``__fdiv_rn``, carrier.carrier_cycles' rounding), so a float32
    carrier on the card costs no other launch."""
    if not _kernels.use_kernel(packed):
        _kernels.note_backend("pm", "torch")
        bb, amp, cn0 = spin_down_plain(packed, carrier_freq, samprate, flip,
                                       dop)
        return _put(bb, out), amp, cn0
    _check_packed(packed, out)
    B, n = packed.shape
    plan = spin_plan(n, B, design)
    dev = packed.device
    if carrier_freq.shape != (B,):
        raise ValueError("carrier_freq must be (B,)")
    freq = carrier_freq.to(device=dev, dtype=torch.float32).contiguous()
    cluster = plan["design"] == "cluster"
    # the two passes take cycles/sample, the cluster kernel divides itself
    cin = freq if cluster else carrier.carrier_cycles(freq, samprate)
    bb = out if out is not None else torch.empty((B, n), dtype=torch.int16,
                                                 device=dev)
    stat = torch.empty((B, 2), dtype=torch.float32, device=dev)
    mom = _spin_scratch(plan, dev)
    err = _kernels.lib().spin_down_launch(
        packed.data_ptr(), packed.stride(0), cin.data_ptr(), int(cluster), B,
        n, kernel_samprate(samprate), int(flip), float(dop), plan["cluster"],
        plan["threads"], bb.data_ptr(), stat.data_ptr(), _ptr(mom),
        _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "spin_down_launch")
    _kernels.count_launch("spin_down")
    _kernels.note_backend("pm", "cuda")
    _kernels.note_backend("spin", plan["design"])
    return bb, stat[:, 0], stat[:, 1]


def kernel_samprate(samprate: float) -> float:
    """The sample rate as the kernels take it: rounded to float32, so the
    "cluster" spin-down's ``__fdiv_rn(Hz, samprate)`` is carrier.
    carrier_cycles' float32 division."""
    return float(np.float32(samprate))


def windowed_dft_raw_plain(packed: torch.Tensor, first1: torch.Tensor, K: int,
                           flip: bool = False) -> torch.Tensor:
    """Plain version of K8: (B, n) packed int32 IQ + (B,) window start bins
    → (B, K) complex64 DFT bins first1 .. first1+K-1."""
    return carrier.windowed_dft(_iq_from_packed(packed, flip), first1, K)


def windowed_search_raw_plain(
    packed: torch.Tensor, first1: torch.Tensor, wlen: torch.Tensor, K: int,
    samprate: float, binsize: float, flip: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K8 with its peak pass: → (bins (B, K) complex64,
    carrier_freq float32, peak bin int64)."""
    S = windowed_dft_raw_plain(packed, first1, K, flip)
    freq, peak = carrier.windowed_peak(S, first1, wlen, binsize, samprate)
    return S, freq, peak


WD_THREADS = 256  # threads of a K8 block (csrc/carrier.cu)
WD_ROWS = 16  # K8's column DFT length: n = WD_ROWS * columns
WD_NB = 4  # bins of each of its residue classes a K8 warp sums at once


@functools.lru_cache(maxsize=64)
def windowed_search_plan(n: int, K: int) -> dict:
    """K8's launch plan for rows of n samples and K bins (csrc/carrier.cu
    ``windowed_search_kernel``): one block of WD_THREADS threads per
    channel; sample i = columns·h + c is row h < WD_ROWS of column c, a
    thread takes the columns c ≡ tid (mod WD_THREADS); bin k goes to warp
    k mod 8, which sums the residue classes k mod 16 = w and w + 8, WD_NB
    bins of each at a time, its lane ℓ the columns c = 32m + ℓ.  Shared memory: the column DFTs (8n
    bytes), the staged row (4n), the twiddles W_n^{32j} (n/4) and W_n^j,
    j < 32 (256), the K bins (8K), the row copy's mbarrier (8) and the
    warps' peak candidates (128).  The whole row is staged at once, so K8
    takes the n whose plan fits one block's shared memory (n ≤ 18,688 at
    K = 53; the narrowband path's n is a power of two below 8192);
    anything else raises."""
    if n <= 0 or n % 256 != 0:
        raise ValueError(f"n = {n} must be a positive multiple of 256")
    if not 1 <= K <= n:
        raise ValueError(f"K = {K} window bins out of range 1..{n}")
    smem = 12 * n + n // 4 + 256 + 8 * K + 8 + 128
    if smem > _SMEM_MAX:
        raise ValueError(f"n = {n}, K = {K}: K8 stages the whole row and "
                         f"needs {smem} bytes of shared memory, over "
                         f"{_SMEM_MAX}")
    return {"threads": WD_THREADS, "warps": WD_THREADS // 32,
            "rows": WD_ROWS, "columns": n // WD_ROWS, "batch": WD_NB,
            "smem": smem}


@functools.lru_cache(maxsize=16)
def twiddle_table(n: int, device: torch.device) -> torch.Tensor:
    """(n, 2) float32 W_n^j = exp(-2πij/n), the double sincospi rounded to
    float32, built on the card at first use (csrc/carrier.cu)."""
    tab = torch.empty((n, 2), dtype=torch.float32, device=device)
    err = _kernels.lib().twiddle_table_launch(n, tab.data_ptr(),
                                              _kernels.stream_ptr(device))
    _kernels.check(err, "twiddle_table_launch")
    return tab


def _as_i32(x: torch.Tensor, dev) -> torch.Tensor:
    if x.dtype == torch.int32 and x.device == dev and x.is_contiguous():
        return x
    return x.to(device=dev, dtype=torch.int32).contiguous()


def _windowed_dft_launch(packed, first1, wlen, K, flip, samprate=0.0,
                         binsize=0.0):
    """Launch K8 (with ``wlen``, its peak pass too) on a CUDA tensor →
    (spec (B, K, 2) float32, freq (B,) float32, peak (B,) int64; the last
    two None without ``wlen``), all views of one buffer."""
    _check_packed(packed, None)
    B, n = packed.shape
    peak = wlen is not None
    if peak and K < 3:  # the peak reads the bins around it
        raise ValueError(f"K = {K} window bins out of range 3..{n}")
    plan = windowed_search_plan(n, K)
    if first1.shape != (B,):
        raise ValueError("first1 must be (B,)")
    if peak and wlen.shape != (B,):
        raise ValueError("wlen must be (B,)")
    dev = packed.device
    first1 = _as_i32(first1, dev)
    wlen = _as_i32(wlen, dev) if peak else None
    # spec (2BK floats), freq, cyc (B each), peak (B int64)
    buf = torch.empty(2 * B * K + 4 * B, dtype=torch.float32, device=dev)
    ptr = buf.data_ptr()
    err = _kernels.lib().windowed_dft_launch(
        packed.data_ptr(), packed.stride(0), first1.data_ptr(),
        wlen.data_ptr() if peak else None, B, n, K, int(flip),
        float(np.float32(samprate)), float(np.float32(binsize)),
        twiddle_table(n, dev).data_ptr(), plan["smem"], ptr,
        ptr + 8 * B * K, ptr + 8 * B * K + 4 * B, ptr + 8 * B * K + 8 * B,
        _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "windowed_dft_launch")
    _kernels.count_launch("windowed_dft")
    _kernels.note_backend("search", "cuda")
    spec = buf[: 2 * B * K].view(B, K, 2)
    if not peak:
        return spec, None, None
    nb = 2 * B * K
    return spec, buf[nb: nb + B], buf[nb + 2 * B:].view(torch.int64)


def windowed_dft_raw(packed: torch.Tensor, first1: torch.Tensor, K: int,
                     flip: bool = False) -> torch.Tensor:
    """K8: the windowed DFT search alone → (B, K) complex64 bins
    first1_b .. first1_b+K-1 of each row's n-point DFT (the bins K1
    computes in its first pass)."""
    if not _kernels.use_kernel(packed):
        _kernels.note_backend("search", "torch")
        return windowed_dft_raw_plain(packed, first1, K, flip)
    return torch.view_as_complex(_windowed_dft_launch(packed, first1, None, K,
                                                      flip)[0])


def windowed_search_raw(
    packed: torch.Tensor, first1: torch.Tensor, wlen: torch.Tensor, K: int,
    samprate: float, binsize: float, flip: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8 followed in the same launch by K1's peak pass (masked last-max
    peak + Quinn, carrier.windowed_peak) → (bins (B, K) complex64,
    carrier_freq float32, peak bin int64).  Callers pass the
    carrier._fast_search_ok gate, so 1 <= wlen <= K-2."""
    if not _kernels.use_kernel(packed):
        _kernels.note_backend("search", "torch")
        return windowed_search_raw_plain(packed, first1, wlen, K, samprate,
                                         binsize, flip)
    spec, freq, peak = _windowed_dft_launch(packed, first1, wlen, K, flip,
                                            samprate, binsize)
    return torch.view_as_complex(spec), freq, peak


def _scan_constants(samprate, binsize, search_width, cn0_threshold):
    """The scan kernel's float32 constants, rounded as the TPU kernel
    rounds them: fs, bin size, half width, threshold, fs/2 - bin size."""
    f32 = np.float32
    top = f32(f32(samprate) / f32(2.0)) - f32(binsize)
    return tuple(float(v) for v in (f32(samprate), f32(binsize),
                                     f32(search_width), f32(cn0_threshold),
                                     top))


def scan_window(center: torch.Tensor, cn0: torch.Tensor, samprate: float,
                binsize: float, search_width: float, cn0_threshold: float,
                wmax: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9's per-block window (carrier_pallas.py:407-427): the per-channel
    copy of carrier._fast_search_ok in float32 with true divisions →
    (first1 int32, wlen int32, ok bool); a failing channel gets the safe
    window first1 0, wlen 1."""
    fs, bsz, w, thr, top = _scan_constants(samprate, binsize, search_width,
                                           cn0_threshold)
    bsz_t = torch.tensor(bsz, dtype=torch.float32, device=center.device)
    lo, hi = center - w, center + w
    first = torch.trunc(lo / bsz_t).to(torch.int32)
    last = torch.trunc(hi / bsz_t).to(torch.int32)
    ok = ((cn0 > thr) & (lo >= bsz) & (hi < top) & (first >= 1)
          & (last > first) & (last - first <= wmax - 2))
    first1 = torch.where(ok, first, 1) - 1
    wlen = torch.where(ok, last - first, 1)
    return first1.to(torch.int32), wlen.to(torch.int32), ok


def pm_scan_locked_plain(
    packed_blocks: torch.Tensor,
    bb0: torch.Tensor,
    init: torch.Tensor,
    samprate: float,
    binsize: float,
    search_width: float,
    cn0_threshold: float,
    wmax: int,
    flip: bool = False,
    tail: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K9: per block t = 1..T-1 the window formula, the
    plain K1 and the carry update; then the prefix sum of all T blocks."""
    B, T, n = packed_blocks.shape
    center, cn0 = init[:, 3].clone(), init[:, 1].clone()
    bbs = [bb0]
    rows = [torch.stack([init[:, 0], init[:, 1], init[:, 2],
                         torch.ones_like(center), torch.zeros_like(center),
                         init[:, 3]], dim=1)]
    for t in range(1, T):
        first1, wlen, ok = scan_window(center, cn0, samprate, binsize,
                                       search_width, cn0_threshold, wmax)
        bb, freq, amp, cn0 = pm_locked_plain(packed_blocks[:, t], first1, wlen,
                                             wmax, samprate, binsize, flip)
        center = torch.where(cn0 > np.float32(cn0_threshold), freq, center)
        bbs.append(bb)
        rows.append(torch.stack([amp, cn0, freq, ok.to(torch.float32), center,
                                 center], dim=1))
    csum = prefix_sum_blocks_plain(torch.stack(bbs), tail + 1)
    tot = csum[:, T * n]
    return csum[:, : T * n + tail], torch.stack(rows, dim=1), tot


SCAN_THREADS = 512  # threads of a K9 block (csrc/carrier.cu)
CD_COLS = 32  # columns of one K9 column-DFT pass: a warp's lanes
CD_NBW = 8  # bins of a K9 warp in one round of the outer sum
_SCAN_STATIC_SMEM = 1024  # K9's static shared memory, rounded up


@functools.lru_cache(maxsize=64)
def pm_scan_plan(n: int, K: int) -> dict:
    """K9's launch plan for blocks of n samples and K window bins
    (csrc/carrier.cu ``pm_scan_kernel``): one block of SCAN_THREADS = 512
    threads (16 warps) per channel.  Sample i = C·h + m is row h < 256 of
    column m < C = n/256; a pass takes CD_COLS columns m = 32p + lane:
    stage 1 in warp w the 16-point DFT over h1 of the rows h = 16·h1 + w,
    stage 2 in warp w the 16-point DFT over h0 for the residues
    r = w + 16·r1, each (column, residue) once.  The outer sum
    X[f] = Σ_m W_n^{f·m} Y_m[f mod 256] runs in rounds of 16·CD_NBW bins:
    bin k = k0 + w + 16·j goes to warp w, slot j, each lane summing its
    column over the passes.  Shared memory: the stage-1 tile (16·16·32
    float2), the pass's column DFTs (256·32 float2), W_256^j (256 float2),
    the outer twiddles of two passes (2·16·CD_NBW float2) and the K bins,
    beside ~1 KB of static shared memory — the same for every n, so the
    plan covers every n that is a multiple of 256·CD_COLS = 8192 (the
    fused scan's gate, carrier._scan_fused_capable) for K ≤ 2048
    (carrier._fast_search_capable); anything else raises."""
    if n <= 0 or n % (256 * CD_COLS) != 0:
        raise ValueError(f"n = {n} must be a positive multiple of "
                         f"{256 * CD_COLS}")
    if not 3 <= K <= n:
        raise ValueError(f"K = {K} window bins out of range 3..{n}")
    bins = (SCAN_THREADS // 32) * CD_NBW
    smem = (16 * 16 * CD_COLS + 256 * CD_COLS + 256 + 2 * bins + K) * 8
    if smem > _SMEM_MAX - _SCAN_STATIC_SMEM:
        raise ValueError(f"n = {n}, K = {K}: K9 needs {smem} bytes of shared "
                         f"memory, over {_SMEM_MAX - _SCAN_STATIC_SMEM}")
    return {"threads": SCAN_THREADS, "warps": SCAN_THREADS // 32,
            "columns": n // 256, "columns_per_pass": CD_COLS,
            "passes": n // 256 // CD_COLS, "bins_per_warp": CD_NBW,
            "bins_per_round": bins, "rounds": -(-K // bins), "smem": smem}


DFT_THREADS = 256  # threads of a "direct" K1 dft_kernel block (csrc/carrier.cu)
DFT_KT = 16  # bins of a "direct" dft_kernel block


@functools.lru_cache(maxsize=64)
def pm_locked_plan(n: int, K: int) -> dict:
    """K1's launch plan for rows of n samples and K window bins
    (csrc/carrier.cu ``pm_locked_launch``), chosen on shape between two
    hand-written searches, each followed by the same spin passes:

    - ``"columns"`` for n a multiple of 256·CD_COLS = 8192 (every locked
      block of the 250 ksps chain and of the de-chirped blocks):
      ``locked_search_kernel``, K9's split and K9's plan (pm_scan_plan:
      one block of 512 threads per channel, passes of 32 columns, rounds
      of 128 bins, the same shared memory), the peak in the same launch;
    - ``"direct"`` for the other n K1 takes (de-chirped blocks below 8192
      samples, e.g. the narrowband chain's n = 4096 with a Doppler rate):
      ``dft_kernel`` (grid of ⌈K/16⌉ bin tiles × B, 256 threads, the
      direct sum over the n/256 rows of each column) and ``peak_kernel``.

    K1 takes n a positive multiple of 256 and 3 <= K <= n within one
    block's shared memory; anything else raises."""
    if n <= 0 or n % 256 != 0:
        raise ValueError(f"n = {n} must be a positive multiple of 256")
    if not 3 <= K <= n:
        raise ValueError(f"K = {K} window bins out of range 3..{n}")
    if n % (256 * CD_COLS) == 0:
        return {**pm_scan_plan(n, K), "design": "columns"}
    smem = (n // 256 + (DFT_THREADS // 32) * DFT_KT) * 8
    if smem > _SMEM_MAX:
        raise ValueError(f"n = {n}: twiddle table exceeds shared memory")
    return {"design": "direct", "threads": DFT_THREADS, "rows": n // 256,
            "passes": 1, "bins_per_round": DFT_KT, "rounds": -(-K // DFT_KT),
            "smem": smem}


def pm_scan_locked_fused(
    packed_blocks: torch.Tensor,
    bb0: torch.Tensor,
    init: torch.Tensor,
    samprate: float,
    binsize: float,
    search_width: float,
    cn0_threshold: float,
    wmax: int,
    flip: bool = False,
    dop: float = 0.0,
    tail: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9: pm blocks 1..T-1 in one launch, emitting the prefix sum.

    packed_blocks (B, T, n) int32 words, bb0 (B, n) int16 block-0 baseband
    from the cold-start step, init (B, 4) float32 [amp, cn0, freq, centre
    after block 0] → (csum (B, T·n + tail) int32 exclusive prefix sum of
    the baseband, columns past T·n holding the total; stat (B, T, 6)
    float32 [amp, cn0, freq, ok, centre, centre]; totals (B,) int32).
    ``wmax`` is the window bin count (carrier._window_bins).  A block whose
    window fails the locked-path preconditions has ok 0: the caller then
    discards the result (carrier.pm_demod_scan_csum).  The kernel has no
    de-chirp: a non-zero ``dop`` is refused."""
    if dop:
        raise ValueError("pm_scan_locked_fused has no Doppler de-chirp")
    if packed_blocks.ndim != 3 or packed_blocks.shape[1] < 2:
        raise ValueError("packed_blocks must be (B, T, n) with T >= 2, got "
                         f"{tuple(packed_blocks.shape)}")
    if not _kernels.use_kernel(packed_blocks):
        _kernels.note_backend("pm_scan", "torch")
        return pm_scan_locked_plain(packed_blocks, bb0, init, samprate,
                                    binsize, search_width, cn0_threshold, wmax,
                                    flip, tail)
    B, T, n = packed_blocks.shape
    dev = packed_blocks.device
    if packed_blocks.dtype != torch.int32:
        raise ValueError(f"packed_blocks must be int32, got {packed_blocks.dtype}")
    if packed_blocks.stride(2) != 1 or packed_blocks.stride(1) != n:
        raise ValueError("packed_blocks: each channel's T blocks must be "
                         "contiguous")
    if bb0.dtype != torch.int16 or tuple(bb0.shape) != (B, n) \
            or not bb0.is_contiguous() or bb0.device != dev:
        raise ValueError("bb0 must be a contiguous (B, n) int16 tensor on the "
                         "input's device")
    if init.dtype != torch.float32 or tuple(init.shape) != (B, 4) \
            or not init.is_contiguous() or init.device != dev:
        raise ValueError("init must be a contiguous (B, 4) float32 tensor on "
                         "the input's device")
    if B < 1 or tail < 0 or T * n + tail >= 2**31:
        raise ValueError(f"unsupported K9 shape B={B} T={T} n={n} K={wmax} "
                         f"tail={tail}")
    plan = pm_scan_plan(n, wmax)
    fs, bsz, w, thr, top = _scan_constants(samprate, binsize, search_width,
                                           cn0_threshold)
    csum = torch.empty((B, T * n + tail), dtype=torch.int32, device=dev)
    stat = torch.empty((B, T, 6), dtype=torch.float32, device=dev)
    tot = torch.empty((B,), dtype=torch.int32, device=dev)
    err = _kernels.lib().pm_scan_launch(
        packed_blocks.data_ptr(), packed_blocks.stride(0), bb0.data_ptr(),
        init.data_ptr(), B, T, n, wmax, fs, bsz, w, thr, top, int(flip), tail,
        twiddle_table(n, dev).data_ptr(), plan["smem"], csum.data_ptr(),
        stat.data_ptr(), tot.data_ptr(),
        _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "pm_scan_launch")
    _kernels.count_launch("pm_scan")
    _kernels.note_backend("pm_scan", "cuda")
    return csum, stat, tot
