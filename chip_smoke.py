#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, checks each kernel against its
plain PyTorch version on the card at the receive chain's bench shapes,
then drives the main path (``models.pipeline.receive_block``, default
decode configuration: QLEC and the Viterbi fallback on) on a 128-channel,
250 ksps block synthesized on the card, in the clean (noise_std 2500),
mid (noise_std 50000) and threshold (noise_std 110000, where lanes reach
the fused Viterbi, kernels K5/K6) regimes, and checks the decoded frames
against the transmitted ones.  Then the wideband path: one packed-int32
capture of 128 channel slots x 2^21 frames through the fused polyphase
channelizer (kernel K7a) and the same chain
(``receive_block_wideband``); an edge-carrier capture through the 2x
oversampled bank (kernel K7b) and ``receive_block`` at the doubled
channel rate; four blocks through ``receive_blocks_pipelined``; the
clean, mid and threshold blocks again with
``PipelineConfig(pm_backend="fused_scan")`` (kernel K9 runs the pm
blocks after the cold start in one launch; the threshold block falls
back to the block scan); a narrowband block (128 channels at
32,768 sps, n = 4096) whose locked blocks search with kernel K8; and
the classic Viterbi API (kernel K10, one launch per trellis step): K10
against its plain version at K=24, the threshold block again with
``DecodeConfig(viterbi_backend="jnp")``, ``vdecode_stream`` on both
backends, ``icesync_frames`` on Manchester baseband, and the ``vtest``
CLI in a subprocess.  Then the streaming chain (phase 13:
``receive_stream`` on the clean and mid recordings in ragged chunks
against one call, its soft symbols bit for bit, a checkpointed resume,
and a 16-channel threshold stream through K5/K6), the reference's
stage tools as processes on the card (phase 14: ``pmdemod | symdemod |
decode`` over pipes, ``bitsync``, ``symdemod -t`` on a recording sent at
the measured clock, ``fanotest``) and clock tracking at 128 channels
(phase 15: half the channels sent at 1024.0 sym/s, half at 1024.545,
demodulated at 1024.0 untracked and through ``symdemod_tracked_batched``,
both decoded; the tracked soft symbols against the kernels' plain
versions and batching invariance).  Then the wide Fano walk (phase 16:
``fano_decode`` on MCQLI32, J50 and J60 frames of 1024 bits encoded by
the native golden encoder, through K4's wide variant with a 64-bit
state word, held bit for bit against its plain twin on both designs and
timed at 256 lanes), the native golden library (phase 17: built from
native/isee3_io.cpp; its encoder against the port's at MCQLI24 and J60,
its Viterbi against K10 and K5/K6 on a noisy MCQLI-24 frame) and
``parallel/`` on logical shards of the card (phase 18: the clean block
through ``receive_block_sharded`` on a (4, 1) mesh byte for byte against
the unsharded buffer, on the default and the fused-scan pm backend,
``decode_frame_sharded`` at MCQLI-24 on (1, 2) and (1, 4) meshes against
``decode_frame``, ``demod_time_sharded`` + ``stitch_shards`` decoding
the frames sent).
Then the float64 pm branch (phase 19: the clean block through
``receive_block`` with ``PMConfig(dtype=torch.float64)``, every lane
walking K4: its frames those of the float32 run, no pm kernel launched
(K1, K2, K8, K9), K3 and K4 launched; its baseband on four channels
against the same on the CPU, and the float32 and float64 pm stages'
times).  Then the reference's other two operational modes (phase 20:
2048 bps, 4096 sym/s, at 128 channels clean, at the bench's mid Eb/N0
and at its threshold Eb/N0 (the Viterbi fallback), and 16 bps on the
1024 Hz subcarrier, 32 sym/s and 32 clocks a symbol, at 16 channels x
194 s clean and below the clean signal (where a whole symbol window may
come out inverted and lanes reach Fano), all at 250 ksps, through
``receive_block`` and again through the plain path on the same IQ; K1,
K2 and K3 against their plain versions at the modes' shapes, K3 on rows
whose sums wrap int32; the symbol stage's ms and peak memory a channel
beside the 512 bps bench's, the chunked timing search against one
gather; the batched clock tracker on 16 channels sent at 32 sym/s on
the measured clock, its window-start search chunked against one
gather; the stage tools as processes in both modes).  Then the JAX
suite's channel statistics on the port's own channel (phase 21: the
hard symbol error rate against theory, the MCQLI-24 Fano operating
point, the FER sweep with both Viterbi decoders on the frames Fano
deleted, K4 against its plain walk on 16 lanes).  Last, after
every timed block, the
device time of kernels K1 (its search launch and spin-down apart), K2,
K8, K5, K6, K9 and K4 under torch.profiler (phase 12).  K2 and K1's spin-down are
checked on both designs ("cluster", one thread-block cluster per
channel, which the main path takes, and "two_pass", for rows longer than
a cluster holds).  K4 is checked on both its designs
("warp", one warp per lane, which the main path takes, and "thread",
one thread per lane, for lanes too long for shared memory).
Fails (non-zero exit, no result line) without a CUDA device, on a build
error, or when any check fails.  Imports no JAX.

Output, in order: one line per phase; the card's name and power limit
(nvidia-smi); one JSON line with every kernel's launches on the main
path (and of phases 13-14 alone, ``stream_cli_launches``, and of phase
15, ``tracking_launches``, of phase 20, ``modes_launches``, and of
phase 21, ``stats_launches``; K4's
wide variant, ``fano_walk_wide``, is a
line of its own with phase 16's launches and per-code times under
``codes``), its error
against the plain version, its time, the plain
version's, the least time the card could take (``bound_ms``: the larger
of the bytes it must move over the HBM rate and the operations it must
do over the peak rate of their type, for this run's inputs; for K4,
whose walk is a serial chain, also the slowest lane's micro-steps at the
least latency of one, ``latency_bound_ms``) and, where
one PyTorch call computes the same function, that call's time (and for
K1, K2, K8, K5, K6, K9 and K4 the kernel's device time, ``device_ms``;
for K2 also the "two_pass" design's time, ``two_pass_ms``; for K1 also
its search launch's and spin-down's device times, the search's
bound and, as its yardstick, torch.fft.fft over all bins of the same
rows, ``search_*``); last,
the JSON line {"ok": true, "device": {...}}.  Phases 3 to 6, 9, 10 and
11 end with profile lines: per-stage milliseconds of three runs of the block,
and the device busy time of one run under torch.profiler.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "isee3_decoder_tpu_torch"
# runs ``{pkg}.cli.{tool}`` as ``python -c TOOL_SHIM <counts.json> args``
# and writes the process's kernel launch counts, the backend of each
# stage and the clock trackers' probes and reads per window
# (models/symdemod.track_stats) to counts.json when the tool exits
TOOL_SHIM = """import json, sys
from {pkg} import _kernels
from {pkg}.cli import _io, {tool} as tool
from {pkg}.models import symdemod
out = sys.argv.pop(1)
try:
    _io.run_main(tool.main)
finally:
    with open(out, "w") as f:
        json.dump({{"launches": _kernels.LAUNCHES,
                   "backend": _kernels.backend_used,
                   "track": symdemod.track_stats}}, f)
"""

# bench configuration (the JAX package's bench.py)
SAMPRATE = 250_000.0
SYMRATE = 1024.0
NCHAN = 128
NFRAMES_TX = 4
NOISE_CLEAN = 2500.0
NOISE_MID = 50000.0
NOISE_THRESHOLD = 110000.0
# clock tracking (phases 14, 15): channels sent at the nominal clock and at
# the measured spacecraft clock (ACTUALCLOCK), demodulated from 1024.0
TRACK_SYMRATES = (1024.0, 1024.545)

# Peak rates of one H100 SXM at its full 700 W (NVIDIA's data sheet; the
# card's own power limit is printed beside the results).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # FMA counted as two operations
# the SM boost clock, and the INT32 lanes: 132 SMs x 64 at that clock
SM_CLOCK_HZ = 1.98e9
I32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
# int16 operations on the same lanes packed two to a word (VIADD.16x2,
# VIMNMX.S16x2)
I16X2_OPS_PER_S = 2 * I32_OPS_PER_S
# int16 operations an ACS pair of the fused Viterbi (K5, K6) needs: four
# adds and two compare-selects, whose compares are the decisions; the
# branch metrics of a step come from its symbols and a table of parities,
# counted as none.  Per Fano micro-step in csrc/fano.cu (forward look,
# threshold update, encoder step with two parities, metric selects,
# bookkeeping) int32 operations, address arithmetic excluded
ACS_OPS_PER_PAIR = 6
FANO_OPS_PER_STEP = 30
# The least latency, in SM clock cycles, of one Fano micro-step's
# dependent chain on sm_90, whatever the design: a lane's walk is serial
# and each micro-step needs a value the step before it chose, at least
# one shared-memory or L1 load (~30 cycles: the next node's metrics on an
# advance, the record a backtrack lands on) plus the forward look's
# dependent add, compare and select (~4 cycles each) before the next
# step can start: ~40 cycles.  A launch can end no sooner than its
# slowest lane's micro-steps x this latency.
FANO_STEP_CYCLES = 40
# integer operations per butterfly of K10 in csrc/viterbi_acs.cu (two
# AND+POPC+AND+XOR branch bits, two symbol selects, the adjust, the
# complementary metric, four adds, two compares, two selects), address
# arithmetic and the ballot excluded
ACS10_OPS_PER_BUTTERFLY = 22

# torch.profiler sessions a device-time reading may take: a session on
# the card now and then records none of its kernels
PROFILE_TRIES = 3
# calls of fn a session makes under the profiler's warm-up (tracing on,
# events dropped) before the counted ones: the first launches after the
# tracing starts may go unrecorded
PROFILE_WARMUP = 5
# calls of one kernel counted in a phase-12 session
PROFILE_CALLS = 20

# narrowband path (phase 10): the reference's -r option at 32,768 sps,
# binsize 8 -> n = 4096, below the 8192-sample chunk of the fused kernels,
# so a locked block searches with K8 and spins down with K2
NB_SAMPRATE = 32_768.0
NB_BINSIZE = 8.0
NB_CARRIER0 = 4000.0
NB_SPACING = 37.0

# wideband regime (the JAX package's bench.py): one capture of NCHAN slots
# x 2^21 frames; edge-carrier path: 32 slots of 128 kHz at 4.096 Msps, so
# the 2x oversampled channel rate is 256 ksps
WIDE_FRAMES = 1 << 21
TAPS_PER_BRANCH = 8
EDGE_NCHAN = 32
EDGE_SAMPRATE = 4_096_000.0
EDGE_SLOT = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over reps calls (after one warm
    call), timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, ops_per_s: float,
          chain_cycles: float = 0.0) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate of their type, whichever is larger.
    ``chain_cycles``, for a kernel whose work is a serial chain of
    dependent operations (K4's walk), adds the latency term: the longest
    chain's cycles at the SM clock (``latency_bound_ms``).  Those are
    operations too, issued one after another, so a bound they set reads
    "operations"."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / ops_per_s, chain_cycles / SM_CLOCK_HZ) * 1e3
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if chain_cycles:
        out["latency_bound_ms"] = chain_cycles / SM_CLOCK_HZ * 1e3
    return out


def dft_ops(n: int, K: int) -> float:
    """float32 operations per row for K bins of an n-point DFT: the
    direct sum's complex MAC (8) per sample and bin, or a radix-2 FFT's
    5·n·log2(n) for every bin, whichever is fewer — the least the search
    must do, whatever form a kernel gives it."""
    return min(8.0 * n * K, 5.0 * n * math.log2(n))


def bench_block(dev, nchan: int, nsamples: int, noise_std: float, seed: int,
                frames_seed: int = 0, samprate: float = SAMPRATE,
                carrier0: float = 20_000.0, spacing: float = 137.0):
    """(frames (F, 128) uint8, (nchan, 2*nsamples) int16 raw IQ on dev,
    carriers): the same frames on every channel, carriers carrier0 +
    spacing·i (the bench: 20 kHz + 137 Hz·i at 250 ksps)."""
    import torch

    from isee3_decoder_tpu_torch.utils.devicesignal import (
        random_frames,
        synthesize_iq_device,
        to_raw_int16,
    )

    frames = random_frames(np.random.default_rng(frames_seed), NFRAMES_TX)
    frames_dev = torch.as_tensor(
        np.ascontiguousarray(np.broadcast_to(frames, (nchan, *frames.shape))),
        device=dev,
    )
    carriers = torch.as_tensor(carrier0 + spacing * np.arange(nchan),
                               dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    iq = synthesize_iq_device(frames_dev, carriers, gen, nsamples,
                              samprate=samprate, symrate=SYMRATE,
                              noise_std=noise_std)
    return frames, to_raw_int16(iq), carriers


def check_k1(args, binsize: float, design: str, label: str) -> int:
    """K1 (pm_locked_fused) against its plain version on ``args``, with
    the tolerances of tests/test_carrier_raw.py: peak bins equal,
    frequency within 5e-3 Hz, amplitude within rtol 1e-5, C/N0 within
    1e-2 dB, baseband within 1 LSB; the wrapper must report ``design``
    and the "cluster" spin-down.
    Returns the baseband's largest difference in LSB."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.ops import carrier_cuda

    bb_k, f_k, a_k, c_k = carrier_cuda.pm_locked_fused(*args)
    got = _kernels.backend_used.get("pm_locked")
    spin = _kernels.backend_used.get("spin")
    bb_p, f_p, a_p, c_p = carrier_cuda.pm_locked_plain(*args)
    pk_k = torch.round(f_k / binsize)
    pk_p = torch.round(f_p / binsize)
    err = int((bb_k.int() - bb_p.int()).abs().max())
    log(f"  {label} ({got} design, spin-down {spin}): peak bins equal "
        f"{bool((pk_k == pk_p).all())}, "
        f"max |dfreq| {float((f_k - f_p).abs().max()):.3e} Hz, "
        f"max amp rel {float(((a_k - a_p) / a_p).abs().max()):.3e}, "
        f"max |dcn0| {float((c_k - c_p).abs().max()):.3e} dB, "
        f"max |dbaseband| {err} LSB")
    require(got == design, f"{label}: the {got} design ran, not {design}")
    require(spin == "cluster", f"{label}: the spin-down ran on {spin}")
    require(bool((pk_k == pk_p).all()), f"{label}: peak bins differ")
    require(float((f_k - f_p).abs().max()) <= 5e-3, f"{label}: freq off")
    require(torch.allclose(a_k, a_p, rtol=1e-5, atol=0), f"{label}: amp off")
    require(float((c_k - c_p).abs().max()) <= 1e-2, f"{label}: cn0 off")
    require(err <= 1, f"{label}: baseband off by more than 1 LSB")
    return err


def check_k2(packed, f, samprate: float, shape: str = "") -> int:
    """K2 (spin_down_fused) on both its designs against its plain version
    on the same inputs, with the tolerances of tests/test_carrier_raw.py:
    amplitude within rtol 1e-5, C/N0 within 1e-2 dB, baseband within 1
    LSB; the wrapper must report the design pinned, and take "cluster"
    unpinned.  Returns the baseband's largest difference in LSB."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.ops import carrier_cuda

    shape = shape or " x ".join(map(str, packed.shape))
    bb_p, a_p, c_p = carrier_cuda.spin_down_plain(packed, f, samprate)
    worst = 0
    for design in ("cluster", "two_pass", None):
        bb_k, a_k, c_k = carrier_cuda.spin_down_fused(packed, f, samprate,
                                                      design=design)
        got = _kernels.backend_used.get("spin")
        err = int((bb_k.int() - bb_p.int()).abs().max())
        log(f"  K2 spin_down at {shape} ({got} design"
            f"{'' if design else ', unpinned'}): max amp rel "
            f"{float(((a_k - a_p) / a_p).abs().max()):.3e}, max |dcn0| "
            f"{float((c_k - c_p).abs().max()):.3e} dB, max |dbaseband| "
            f"{err} LSB")
        require(got == (design or "cluster"),
                f"K2 at {shape}: the {got} design ran, not {design}")
        require(torch.allclose(a_k, a_p, rtol=1e-5, atol=0),
                f"K2 at {shape} on {got}: amp off")
        require(float((c_k - c_p).abs().max()) <= 1e-2,
                f"K2 at {shape} on {got}: cn0 off")
        require(err <= 1, f"K2 at {shape} on {got}: baseband off by more "
                "than 1 LSB")
        worst = max(worst, err)
    return worst


def check_kernels(dev, nchan: int = NCHAN, n_lanes: int = 256) -> dict:
    """Phase 2: every kernel against its plain version on the same
    inputs, at the main path's shapes.  Returns per-kernel records."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import FRAMEBITS
    from isee3_decoder_tpu_torch.ops import carrier, carrier_cuda, fano_cuda
    from isee3_decoder_tpu_torch.ops import prefix_cuda

    out = {}
    cfg = carrier.PMConfig(samprate=SAMPRATE, binsize=4.0, search_width=200.0)
    n = cfg.fftsize
    args, iq, carriers = k1_inputs(dev, nchan)
    packed, K = args[0], args[3]

    # ---- K1: locked pm block (tolerances of tests/test_carrier_raw.py)
    err = check_k1(args, cfg.actual_binsize, "columns",
                   f"K1 pm_locked at {nchan} x {n}, K = {K}")
    # reads the packed IQ, writes the int16 baseband; the window bins'
    # DFT, then the spin-down's phase step and rotation (8 per sample).
    # No one PyTorch call does K1's whole function; the search launch's
    # yardstick is torch.fft.fft over all n bins of the same rows
    # (search_library_ms), its bound the packed words read once.
    out["pm_locked"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: carrier_cuda.pm_locked_fused(*args), 20),
        plain_ms=cuda_ms(lambda: carrier_cuda.pm_locked_plain(*args), 5),
        library_ms=None,
        search_library_ms=cuda_ms(lambda: torch.fft.fft(iq, dim=-1), 20),
        search_bound_ms=bound(nchan * n * 4 + nchan * 8, nchan * dft_ops(n, K),
                              F32_OPS_PER_S)["bound_ms"],
        **bound(nchan * n * (4 + 2), nchan * (dft_ops(n, K) + 8.0 * n),
                F32_OPS_PER_S),
    )
    r = out["pm_locked"]
    log(f"  K1 {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound "
        f"{r['bound_ms']:.4f} by {r['bound_by']}); the search's yardstick "
        f"torch.fft.fft over all {n} bins {r['search_library_ms']:.4f} ms, "
        f"its bound {r['search_bound_ms']:.4f} ms")
    del iq, args

    # ---- K2: spin-down at a given carrier, on both designs, at the bench
    #      shape and at the narrowband path's 128 x 4096
    f = carriers + 0.125
    err = check_k2(packed, f, cfg.samprate)
    out["spin_down"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: carrier_cuda.spin_down_fused(packed, f,
                                                        cfg.samprate), 20),
        plain_ms=cuda_ms(lambda: carrier_cuda.spin_down_plain(
            packed, f, cfg.samprate), 5),
        two_pass_ms=cuda_ms(lambda: carrier_cuda.spin_down_fused(
            packed, f, cfg.samprate, design="two_pass"), 20),
        library_ms=None,
        # packed words in, int16 out; the phase step and complex rotation
        # per sample (sincos not counted)
        **bound(nchan * n * (4 + 2), 8.0 * nchan * n, F32_OPS_PER_S),
    )
    r = out["spin_down"]
    log(f"  K2 {r['ms']:.4f} ms on cluster (two_pass "
        f"{r['two_pass_ms']:.4f}, plain {r['plain_ms']:.3f}, bound "
        f"{r['bound_ms']:.4f} by {r['bound_by']})")
    _, nb_raw, nb_car = bench_block(dev, nchan, 4096, NOISE_CLEAN, seed=8,
                                    samprate=NB_SAMPRATE,
                                    carrier0=NB_CARRIER0, spacing=NB_SPACING)
    check_k2(carrier.pack_raw(nb_raw), nb_car + 0.125, NB_SAMPRATE,
             f"{nchan} x 4096")
    del packed, nb_raw

    # ---- K3: prefix sum, exact, at T=32 blocks (8.4 s of signal) and at
    #      the narrowband path's 67 pm blocks of 4096 (phase 10)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for key, T3, n3 in (("", 32, n), ("narrowband_", 67, 4096)):
        bb = torch.randint(-32768, 32768, (T3, nchan, n3), generator=gen,
                           device=dev, dtype=torch.int32).to(torch.int16)
        cs_k = prefix_cuda.prefix_sum_blocks(bb, tail=1)
        cs_p = prefix_cuda.prefix_sum_blocks_plain(bb, tail=1)
        err = int((cs_k.long() - cs_p.long()).abs().max())
        log(f"  K3 prefix_sum: {tuple(cs_k.shape)} max |diff| {err}")
        require(err == 0, f"K3 prefix sum not exact at {tuple(bb.shape)}")
        del cs_p
        # the library yardstick: one torch.cumsum over the same values in
        # the output's (B, T*n) order (inclusive, no tail column), timed
        # only here
        flat = bb.permute(1, 0, 2).reshape(nchan, -1).contiguous()
        rec = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: prefix_cuda.prefix_sum_blocks(bb, tail=1), 10),
            plain_ms=cuda_ms(
                lambda: prefix_cuda.prefix_sum_blocks_plain(bb, 1), 3),
            library_ms=cuda_ms(
                lambda: torch.cumsum(flat, dim=1, dtype=torch.int32), 10),
            **bound(bb.numel() * 2 + cs_k.numel() * 4, bb.numel(),
                    I32_OPS_PER_S),
        )
        if key:
            out["prefix_sum"].update({key + k: v for k, v in rec.items()})
        else:
            out["prefix_sum"] = rec
        log(f"  K3 at {T3} x {nchan} x {n3}: {rec['ms']:.4f} ms (bound "
            f"{rec['bound_ms']:.4f} by {rec['bound_by']}, torch.cumsum "
            f"{rec['library_ms']:.4f}, plain {rec['plain_ms']:.3f})")
        del bb, cs_k, flat

    # ---- K4: the Fano walk alone, on both designs — metric precompute
    # and root setup are done once, outside the timed calls; bits and
    # [np, gamma, cycles, t] exact
    dcfg, cases = k4_inputs(dev, n_lanes)
    rec = {"max_abs_err": 0, "library_ms": None}
    for name, m4, regs, maxcycles in cases:
        args = (m4, regs, dcfg.code, dcfg.fano_delta, maxcycles)
        start, end = _events()
        start.record()
        bits_p, st_p = fano_cuda.fano_walk_plain(*args)  # slow: timed once
        end.record()
        torch.cuda.synchronize()
        steps = int(st_p[:, 2].max())  # the slowest lane's micro-steps
        nfail = int((st_p[:, 0] + 1 != FRAMEBITS).sum())
        for design in ("warp", "thread"):
            bits_k, st_k = fano_cuda.fano_walk(*args, design=design)
            require(torch.equal(bits_k, bits_p), f"K4 {design}: bits differ")
            require(torch.equal(st_k, st_p),
                    f"K4 {design}: np/gamma/cycles/t differ")
            if name == "a":
                ms = cuda_ms(lambda: fano_cuda.fano_walk(*args, design=design),
                             5)
                rec["ms" if design == "warp" else "thread_ms"] = ms
        log(f"  K4 fano_walk ({name}): {m4.shape[0]} lanes at {maxcycles} "
            f"cycles/bit: both designs identical; {nfail} timed out, max "
            f"cycles {steps}")
        if name == "b":
            require(nfail > 0, "K4 small batch has no timed-out lane")
            continue
        fano_cuda.fano_walk(*args)
        require(_kernels.backend_used.get("fano_walk") == "warp",
                "K4: the plan did not pick the warp design")
        rec.update(
            plain_ms=start.elapsed_time(end), max_lane_steps=steps,
            ns_per_step=rec["ms"] * 1e6 / steps,
            thread_ns_per_step=rec["thread_ms"] * 1e6 / steps,
            **bound(m4.numel() * 4 + regs.numel() * 4
                    + m4.shape[0] * m4.shape[1] + st_p.numel() * 4,
                    int(st_p[:, 2].sum()) * FANO_OPS_PER_STEP, I32_OPS_PER_S,
                    steps * FANO_STEP_CYCLES))
        log(f"  K4 at {m4.shape[0]} lanes: warp {rec['ms']:.4f} ms "
            f"({rec['ns_per_step']:.1f} ns per micro-step), thread "
            f"{rec['thread_ms']:.4f} ms ({rec['thread_ns_per_step']:.1f}); "
            f"latency bound {rec['latency_bound_ms']:.4f} ms "
            f"({steps} steps x {FANO_STEP_CYCLES} cycles)")
    out["fano_walk"] = rec
    out.update(check_viterbi(dev))
    return out


def k4_inputs(dev, n_lanes: int = 256):
    """K4's calls as phase 2 makes them (kernel_turns.py builds the same
    frames): (DecodeConfig(), [(name, metrics4, regs, cycles/bit)]): (a)
    n_lanes lanes at sigma 75 and the tier-1 cap (12 cycles/bit), (b) 16
    lanes at sigma 110 at 2 cycles/bit, some timing out."""
    import torch

    from isee3_decoder_tpu_torch.utils.kernel_turns import k4_walk_inputs

    dcfg, a, b = k4_walk_inputs(torch, np, dev, n_lanes)
    return dcfg, [("a", *a, dcfg.fano_params_tier1().maxcycles),
                  ("b", *b, 2)]


def k1_inputs(dev, nchan: int = NCHAN):
    """K1's call at the bench shape, nchan x 65,536, K = 107, on a clean
    block (seed 5) of carriers 20 kHz + 137 Hz·i, each locked on its own
    carrier → (pm_locked_fused's positional arguments, the block as
    complex64 IQ, the carriers)."""
    from isee3_decoder_tpu_torch.ops import carrier

    cfg = carrier.PMConfig(samprate=SAMPRATE, binsize=4.0, search_width=200.0)
    _, raw, carriers = bench_block(dev, nchan, cfg.fftsize, NOISE_CLEAN,
                                   seed=5)
    return (locked_k1_args(raw, carriers, cfg),
            carrier.iq_from_interleaved(raw), carriers)


def locked_k1_args(raw, carriers, cfg) -> tuple:
    """pm_locked_fused's positional arguments for one pm block of raw IQ
    (B, 2n) with every channel locked on its carrier under PMConfig
    ``cfg``."""
    import torch

    from isee3_decoder_tpu_torch.ops import carrier

    carry = carrier.PMCarry(search_center=carriers,
                            cn0=torch.full_like(carriers, 60.0))
    require(carrier._fast_search_ok(carry, cfg), "K1 inputs not locked")
    first, last = carrier._search_window(carry.search_center, carry.cn0, cfg)
    return (carrier.pack_raw(raw), first - 1, last - first,
            carrier._window_bins(cfg), cfg.samprate, cfg.actual_binsize)


def k8_inputs(dev, nchan: int = NCHAN):
    """The narrowband path's K8 call at 128 x 4096, K = 53, on a clean
    block of locked carriers → (cfg, carry, raw block, the arguments of
    windowed_search_raw)."""
    import torch

    from isee3_decoder_tpu_torch.ops import carrier

    cfg = carrier.PMConfig(samprate=NB_SAMPRATE, binsize=NB_BINSIZE,
                           search_width=200.0)
    _, raw, carriers = bench_block(dev, nchan, cfg.fftsize, NOISE_CLEAN,
                                   seed=8, samprate=NB_SAMPRATE,
                                   carrier0=NB_CARRIER0, spacing=NB_SPACING)
    carry = carrier.PMCarry(search_center=carriers,
                            cn0=torch.full_like(carriers, 60.0))
    require(carrier._fast_search_ok(carry, cfg), "K8 inputs not locked")
    first, last = carrier._search_window(carry.search_center, carry.cn0, cfg)
    # the main path's call: K8 with the peak + Quinn pass in its launch
    return cfg, carry, raw, (carrier.pack_raw(raw), first - 1, last - first,
                             carrier._window_bins(cfg), cfg.samprate,
                             cfg.actual_binsize)


def k9_inputs(dev, nchan: int = NCHAN):
    """K9's inputs at the bench shape, nchan x 32 x 65,536, K = 107, from
    a clean block (seed 9) and its cold-start step → (PMConfig,
    pm_scan_locked_fused's positional arguments)."""
    import torch

    from isee3_decoder_tpu_torch.ops import carrier

    cfg = carrier.PMConfig(samprate=SAMPRATE, binsize=4.0, search_width=200.0)
    n, K, T = cfg.fftsize, carrier._window_bins(cfg), 32
    _, raw, _ = bench_block(dev, nchan, T * n, NOISE_CLEAN, seed=9)
    blocks = raw.reshape(nchan, T, 2 * n)
    carry1, out0 = carrier.pm_demod_block_raw(
        carrier.init_carry(nchan, cfg, device=dev), blocks[:, 0], cfg)
    init = torch.stack([torch.zeros_like(out0.cn0), out0.cn0,
                        out0.carrier_freq, carry1.search_center], dim=1)
    return cfg, (carrier.pack_raw(blocks), out0.baseband, init,
                      cfg.samprate, cfg.actual_binsize, cfg.search_width,
                      cfg.cn0_threshold, K)


def check_search_kernels(dev, nchan: int = NCHAN) -> dict:
    """Phase 2's K8/K9 part.  K8 (the windowed DFT search alone) at the
    narrowband path's shape, 128 x 4096, K = 53, beside K1 and the whole
    K8 + peak + K2 block step at the same n; K9 (the pm scan in one
    launch) at the bench shape, 128 x 32 x 65,536, K = 107.  Tolerances
    of tests/test_carrier_raw.py: peak bins and lock/ok lanes equal,
    frequency and centre within 5e-3 Hz, C/N0 within 1e-2 dB, amplitude
    within rtol 1e-5, baseband (K9: from the prefix sum's differences)
    within 1 LSB."""
    import torch

    from isee3_decoder_tpu_torch.ops import carrier, carrier_cuda

    out = {}
    # ---- K8 at n = 4096
    cfg, carry, raw, search = k8_inputs(dev, nchan)
    packed, first1, K, n = search[0], search[1], search[3], cfg.fftsize
    s_k, f_k, pk_k = carrier_cuda.windowed_search_raw(*search)
    s_p, f_p, pk_p = carrier_cuda.windowed_search_raw_plain(*search)
    s_d = carrier_cuda.windowed_dft_raw(packed, first1, K)
    err = float((s_k - s_p).abs().max())
    rel = err / float(s_p.abs().max())
    log(f"  K8 windowed_dft: {nchan} x {n}, K = {K}: peak bins equal "
        f"{bool(torch.equal(pk_k, pk_p))}, max |dfreq| "
        f"{float((f_k - f_p).abs().max()):.3e} Hz, max |dbin| {err:.3e} "
        f"({rel:.3e} of the largest bin), bins alone == with the peak pass "
        f"{bool(torch.equal(s_d, s_k))}")
    require(torch.equal(pk_k, pk_p), "K8 peak bins differ")
    require(float((f_k - f_p).abs().max()) <= 5e-3, "K8 freq off")
    require(rel <= 1e-5, "K8 bins off")
    require(torch.equal(s_d, s_k), "K8 bins differ with the peak pass")
    iq = carrier.iq_from_interleaved(raw)

    out["windowed_dft"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: carrier_cuda.windowed_search_raw(*search), 50),
        plain_ms=cuda_ms(lambda: carrier_cuda.windowed_search_raw_plain(
            *search), 10),
        # every bin of the block, a superset of the K the search needs
        library_ms=cuda_ms(lambda: torch.fft.fft(iq, dim=-1), 50),
        # packed words in, K complex bins and the peak's frequency out;
        # the window bins' DFT (the peak's few operations per bin aside)
        **bound(nchan * n * 4 + nchan * (K * 8 + 4), nchan * dft_ops(n, K),
                F32_OPS_PER_S),
    )

    def k8_block():
        f, _ = carrier.find_carrier_windowed_raw(packed, carry, cfg)
        return carrier_cuda.spin_down_fused(packed, f, cfg.samprate)

    # K1's "direct" design at n = 4096: the narrowband chain's locked
    # block with a Doppler rate (and the phase-10 K1 dispatch without one)
    k1_args = search  # K1 takes the same window
    for doppler in (0.0, 50.0):
        check_k1((*search, False, doppler / cfg.samprate**2),
                 cfg.actual_binsize, "direct",
                 f"K1 pm_locked at {nchan} x {n}, K = {K}, Doppler rate "
                 f"{doppler:.0f} Hz/s")
    r = out["windowed_dft"]
    log(f"  K8 with its peak pass {r['ms']:.4f} ms (bins alone "
        f"{cuda_ms(lambda: carrier_cuda.windowed_dft_raw(packed, first1, K), 50):.4f}"
        f", plain {r['plain_ms']:.4f}, torch.fft.fft "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f} by "
        f"{r['bound_by']}); locked block at n = {n}: K1 "
        f"{cuda_ms(lambda: carrier_cuda.pm_locked_fused(*k1_args), 50):.4f} ms,"
        f" K8 + peak + K2 {cuda_ms(k8_block, 50):.4f} ms")
    del packed, raw, iq, s_k, s_p, s_d

    # ---- K9 at the bench shape
    cfg, args = k9_inputs(dev, nchan)
    n, K, T = cfg.fftsize, args[-1], args[0].shape[1]
    cs_k, st_k, tot_k = carrier_cuda.pm_scan_locked_fused(*args, tail=1)
    cs_p, st_p, tot_p = carrier_cuda.pm_scan_locked_plain(*args, tail=1)
    bb_k = (cs_k[:, 1:] - cs_k[:, :-1]).to(torch.int16)
    bb_p = (cs_p[:, 1:] - cs_p[:, :-1]).to(torch.int16)
    err = int(raw_diff(bb_k, bb_p)[0])
    thr = cfg.cn0_threshold
    lanes = {name: float((st_k[..., i] - st_p[..., i]).abs().max())
             for i, name in enumerate(("amp", "cn0", "freq", "ok", "_",
                                       "centre"))}
    log(f"  K9 pm_scan: {nchan} x {T} x {n}, K = {K}: ok lanes equal "
        f"{bool(torch.equal(st_k[..., 3], st_p[..., 3]))} (all ok "
        f"{bool((st_k[:, 1:, 3] > 0).all())}), locks equal "
        f"{bool(torch.equal(st_k[..., 1] > thr, st_p[..., 1] > thr))}, max "
        f"|dfreq| {lanes['freq']:.3e} Hz, |dcentre| {lanes['centre']:.3e} Hz,"
        f" |dcn0| {lanes['cn0']:.3e} dB, max amp rel "
        f"{float(((st_k[:, 1:, 0] - st_p[:, 1:, 0]) / st_p[:, 1:, 0]).abs().max()):.3e}"
        f", max |dbaseband| {err} LSB, totals equal the last column "
        f"{bool(torch.equal(tot_k, cs_k[:, -1]))}")
    require(bool((st_k[:, 1:, 3] > 0).all()), "K9: a clean block failed its "
            "window")
    require(torch.equal(st_k[..., 3], st_p[..., 3]), "K9 ok lanes differ")
    require(torch.equal(st_k[..., 1] > thr, st_p[..., 1] > thr),
            "K9 locks differ")
    require(lanes["freq"] <= 5e-3 and lanes["centre"] <= 5e-3, "K9 freq off")
    require(lanes["cn0"] <= 1e-2, "K9 cn0 off")
    require(torch.allclose(st_k[..., 0], st_p[..., 0], rtol=1e-5, atol=0),
            "K9 amp off")
    require(err <= 1, "K9 baseband off by more than 1 LSB")
    require(torch.equal(tot_k, cs_k[:, -1]), "K9 totals differ from the "
            "edge-extension column")
    del bb_k, bb_p, cs_p, st_p
    out["pm_scan"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: carrier_cuda.pm_scan_locked_fused(*args, tail=1), 5),
        plain_ms=cuda_ms(lambda: carrier_cuda.pm_scan_locked_plain(
            *args, tail=1), 2),
        library_ms=None,
        # packed words and block 0's baseband in, the int32 prefix sum
        # out; in blocks 1..T-1 the window bins' DFT and the spin-down
        **bound(nchan * T * n * 4 + nchan * n * 2 + cs_k.numel() * 4,
                nchan * (T - 1) * (dft_ops(n, K) + 8.0 * n), F32_OPS_PER_S),
    )
    r = out["pm_scan"]
    log(f"  K9 {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound "
        f"{r['bound_ms']:.3f} by {r['bound_by']})")
    return out


def cycle_inputs(dev, B: int, seed: int):
    """One K=24 cycle's inputs for B frames: random metrics inside the
    renorm range, the row and column phases' symbols and a base →
    (metrics int16, row syms, column syms, base)."""
    import torch

    from isee3_decoder_tpu_torch.config import DEFAULT_CODE as code
    from isee3_decoder_tpu_torch.ops import viterbi_cuda as vc

    w, rowb, _ = vc._geometry(code)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    m0 = ri(0, 12000, (B, code.nstates)).to(torch.int16)
    syms = ri(0, 256, (B, 2 * w))
    return (m0, syms[:, : 2 * rowb].contiguous(),
            syms[:, 2 * rowb :].contiguous(), ri(1, 600, (B,)))


def viterbi_cycle_check(dev, B: int, seed: int) -> dict:
    """K5 (with a non-zero base) and K6 over one whole K=24 cycle of B
    frames of random metrics inside the renorm range, against their
    plain versions: metrics, decision words and row minima exact.
    Returns their records: kernel and plain ms, bound."""
    import torch

    from isee3_decoder_tpu_torch.config import DEFAULT_CODE as code
    from isee3_decoder_tpu_torch.ops import viterbi_cuda as vc

    w, rowb, _ = vc._geometry(code)
    n = code.nstates
    m0, sa, sb, base = cycle_inputs(dev, B, seed)
    mk, mp = m0.clone(), m0.clone()
    _, dk = vc.cycle_a(mk, sa, code, rowb, base)
    _, dp = vc.cycle_a_plain(mp, sa, code, rowb, base)
    require(torch.equal(mk, mp) and torch.equal(dk, dp),
            f"K5 differs from its plain version at B={B}")
    _, dk, nk = vc.cycle_b(mk, sb, code, w - rowb)
    _, dp, npl = vc.cycle_b_plain(mp, sb, code, w - rowb)
    require(torch.equal(mk, mp) and torch.equal(dk, dp) and torch.equal(nk, npl),
            f"K6 differs from its plain version at B={B}")
    del dk, dp, m0
    # timed on the same buffers; the metrics drift from call to call,
    # which changes no work the kernels do
    da = torch.empty((B, rowb, n // 32), dtype=torch.int32, device=dev)
    db = torch.empty((B, w - rowb, n // 32), dtype=torch.int32, device=dev)

    rec = {
        "viterbi_a": dict(
            max_abs_err=0,
            ms=cuda_ms(lambda: vc.cycle_a(mk, sa, code, rowb, base, da), 10),
            plain_ms=cuda_ms(lambda: vc.cycle_a_plain(mp, sa, code, rowb, base,
                                                      da), 2),
            library_ms=None,
            **bound(B * (4 * n + rowb * n // 8) + sa.numel() * 4 + B * 4,
                    B * rowb * (n // 2) * ACS_OPS_PER_PAIR, I16X2_OPS_PER_S),
        ),
        "viterbi_b": dict(
            max_abs_err=0,
            ms=cuda_ms(lambda: vc.cycle_b(mk, sb, code, w - rowb, db), 10),
            plain_ms=cuda_ms(lambda: vc.cycle_b_plain(mp, sb, code, w - rowb,
                                                      db), 2),
            library_ms=None,
            **bound(B * (4 * n + (w - rowb) * n // 8 + (1 << rowb) * 4)
                    + sb.numel() * 4, B * (w - rowb) * (n // 2)
                    * ACS_OPS_PER_PAIR, I16X2_OPS_PER_S),
        ),
    }
    a, b_ = rec["viterbi_a"], rec["viterbi_b"]
    log(f"  K5/K6 one K=24 cycle at B={B}: exact; K5 {a['ms']:.4f} ms (plain "
        f"{a['plain_ms']:.3f}, bound {a['bound_ms']:.4f}), K6 {b_['ms']:.4f} "
        f"ms (plain {b_['plain_ms']:.3f}, bound {b_['bound_ms']:.4f})")
    return rec


def check_viterbi(dev) -> dict:
    """Phase 2's K5/K6 part: one cycle at B=2, then whole-frame decodes
    of 2 noisy K=24 frames through the kernels and through their plain
    versions (bits exact), with the frame's ACS and traceback timed
    apart."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import DEFAULT_CODE as code
    from isee3_decoder_tpu_torch.config import FRAMEBITS, SYNC_STATE
    from isee3_decoder_tpu_torch.ops.encode import bytes_to_bits, encode_bits
    from isee3_decoder_tpu_torch.ops.viterbi_fused import (
        chainback_planes,
        decode_frame_fused,
        update_frame_fused_planes,
    )
    from isee3_decoder_tpu_torch.ops.viterbi_inplace import START_BIAS
    from isee3_decoder_tpu_torch.utils.devicesignal import random_frames

    rec = viterbi_cycle_check(dev, 2, seed=24)
    rng = np.random.default_rng(6)
    sent = bytes_to_bits(torch.as_tensor(random_frames(rng, 2), device=dev))
    syms, _ = encode_bits(sent, SYNC_STATE, code)
    noise = torch.as_tensor(rng.normal(0.0, 80.0, syms.shape),
                            dtype=torch.float32, device=dev)
    soft = torch.clamp(torch.round((syms.float() * 2 - 1) * 100 + noise) + 128,
                       0, 255).to(torch.uint8)
    bits_k = decode_frame_fused(soft, FRAMEBITS, SYNC_STATE, SYNC_STATE, code)
    start, end = _events()
    start.record()
    with _kernels.plain_reference():
        bits_p = decode_frame_fused(soft, FRAMEBITS, SYNC_STATE, SYNC_STATE,
                                    code)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    require(torch.equal(bits_k, bits_p), "K=24 frame decode: kernel path and "
            "plain path give different bits")

    def metrics0():
        m = torch.full((2, code.nstates), START_BIAS, dtype=torch.int16,
                       device=dev)
        m[:, SYNC_STATE & code.state_mask] = 0
        return m

    m = metrics0()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, dec, _ = update_frame_fused_planes(m, soft, FRAMEBITS, code)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    chainback_planes(dec, FRAMEBITS, SYNC_STATE, code)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    frame = {"frames": 2, "acs_ms": round((t1 - t0) * 1e3, 3),
             "chainback_ms": round((t2 - t1) * 1e3, 3),
             "plain_decode_ms": round(plain_ms, 3),
             "bit_errors": int((bits_k != sent.to(torch.uint8)).sum())}
    log(f"  K5/K6 decode of 2 K=24 frames: kernel == plain; "
        f"{json.dumps(frame)}")
    return rec


def _events():
    import torch

    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def timed_runs(run):
    """The main path: launch counts are set to 0 just before the counted
    run() and read just after; four more runs are timed.  run() returns
    (record, sync starts).  Returns (record, [seconds of each run],
    launches, backends)."""
    import torch

    from isee3_decoder_tpu_torch import _kernels

    times = []
    torch.cuda.synchronize()
    _kernels.reset_launches()
    for i in range(5):
        t0 = time.perf_counter()
        rec, _ = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(_kernels.LAUNCHES)
            backends = dict(_kernels.backend_used)
    return rec, times, launches, backends


def timed_receive(iq, nframes: int, cfg):
    from isee3_decoder_tpu_torch.models.pipeline import receive_block

    return timed_runs(lambda: receive_block(iq, nframes, cfg))


def _ms(times) -> str:
    return "/".join(f"{t * 1e3:.1f}" for t in times)


def stage_ms(iq, nframes: int, cfg, front=None) -> dict:
    """Wall milliseconds of each stage of one receive_block, called one
    by one as pipeline._demod and receive_block call them, with a
    synchronize after each.  ``front`` turns ``iq`` (a wide capture) into
    the per-channel raw first, as receive_block_wideband does."""
    import torch

    from isee3_decoder_tpu_torch.config import FRAMESYMBOLS
    from isee3_decoder_tpu_torch.models.decode import _finish, decode_block_device
    from isee3_decoder_tpu_torch.models.symdemod import (
        initial_firstsample,
        symdemod_scan_csum,
        window_samples,
    )
    from isee3_decoder_tpu_torch.ops.carrier import (
        _scan_fused_capable,
        init_carry,
        pm_demod_scan,
        pm_demod_scan_csum,
    )
    from isee3_decoder_tpu_torch.ops.prefix_cuda import prefix_sum_blocks

    out = {}
    torch.cuda.synchronize()
    t = [time.perf_counter()]

    def mark(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = round((now - t[0]) * 1e3, 3)
        t[0] = now

    if front is not None:
        iq = front(iq)
        mark("channelizer")
    B, n = iq.shape[0], cfg.pm.fftsize
    nblocks = iq.shape[1] // (2 * n)
    blocks = iq[:, : nblocks * 2 * n].reshape(B, nblocks, 2 * n)
    nwindows = max((nblocks * n - initial_firstsample(cfg.sym))
                   // window_samples(cfg.sym) - 1, 0)
    carry = init_carry(B, cfg.pm, device=iq.device)
    if cfg.pm_backend == "fused_scan" and _scan_fused_capable(cfg.pm, n,
                                                               nblocks):
        csum = pm_demod_scan_csum(carry, blocks, cfg.pm, tail=1)[1]
        mark("pm_scan+csum (K9)")
    else:
        _, pm_out = pm_demod_scan(carry, blocks, cfg.pm)
        mark("pm_scan")
        csum = prefix_sum_blocks(pm_out.baseband, tail=1)
        mark("prefix_sum")
    _, sym_out = symdemod_scan_csum(csum, cfg.sym, nwindows)
    soft = sym_out.soft.transpose(0, 1).reshape(B, -1)
    mark("symdemod")
    buf = decode_block_device(soft, nframes, FRAMESYMBOLS, cfg.decode)
    buf = buf.cpu().numpy()
    mark("decode_device+fetch")
    _finish(buf, soft, B, nframes, cfg.decode)
    mark("host_tail")
    return out


def device_busy(fn) -> dict:
    """One fn() under torch.profiler: wall ms, the union of the device's
    busy intervals in ms, and the busiest device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    per_name: dict = {}
    for s, e, name in spans:
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
        tot, cnt = per_name.get(name[:60], (0.0, 0))
        per_name[name[:60]] = (tot + (e - s), cnt + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": round(wall, 3), "device_busy_ms": round(busy / 1e3, 3),
            "top_ms_count": [(k, round(v / 1e3, 3), c) for k, (v, c) in top]}


def profile_block(iq, nframes: int, cfg, regime: str, run=None,
                  front=None) -> None:
    """Three stage breakdowns and one profiled run of the block
    (receive_block unless ``run`` is given)."""
    from isee3_decoder_tpu_torch.models.pipeline import receive_block

    stages = [stage_ms(iq, nframes, cfg, front) for _ in range(3)]
    prof = device_busy(run or (lambda: receive_block(iq, nframes, cfg)))
    log("  profile " + json.dumps({"regime": regime, "stages_ms": stages,
                                   **prof}))


def frame_stats(rec, frames, nchan: int, nframes: int) -> tuple[int, int]:
    good, matched = rec.good.sum(), matched_mask(rec, frames, nchan, nframes)
    return int(good), int(matched.sum())


def matched_mask(rec, frames, nchan: int, nframes: int) -> np.ndarray:
    """Lanes that are good and equal one of the transmitted frames."""
    return np.array([bool(g) and any(np.array_equal(d, fr) for fr in frames)
                     for g, d in zip(rec.good, rec.data)])


def decoder_mix(rec) -> dict:
    from isee3_decoder_tpu_torch.models import decode as d

    names = {d.DECODER_NONE: "none", d.DECODER_VITERBI: "viterbi",
             d.DECODER_FANO: "fano", d.DECODER_QUICKLOOK: "quicklook",
             d.DECODER_QLEC: "qlec"}
    vals, counts = np.unique(rec.decoder, return_counts=True)
    return {names[int(v)]: int(c) for v, c in zip(vals, counts)}


def raw_diff(a, b) -> tuple[int, float]:
    """(max |a - b|, share of samples that differ) of two int16 tensors,
    in chunks of rows so no int32 copy of a whole 1 GiB output is made."""
    worst, ndiff = 0, 0
    for r in range(0, a.shape[0], 8):
        d = (a[r : r + 8].int() - b[r : r + 8].int()).abs()
        worst = max(worst, int(d.max()))
        ndiff += int((d > 0).sum())
    return worst, ndiff / a.numel()


def random_packed(dev, nwords: int, seed: int):
    """nwords packed IQ words, I and Q uniform in +-20000."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    iq = torch.randint(-20000, 20000, (2, nwords), generator=gen, device=dev,
                       dtype=torch.int32)
    return (iq[0] & 0xFFFF) | (iq[1] << 16)


def check_channelizer(dev, nchan: int = NCHAN, frames: int = WIDE_FRAMES) -> dict:
    """Phase 2's K7a/K7b part: the fused channelizer against its plain
    version (the plain bank + trunc-clip) on random captures whose length
    leaves whole tiles, a partial last tile and a partial last frame (the
    last one starting 12 bytes past a 16-byte boundary), then at the
    wideband block's shape, where both are timed.  At most 1 LSB apart on
    under 1 % of the samples: float32 rounding at truncation boundaries.
    The output rows are 16-byte aligned (cc.pitch_words)."""
    import torch

    from isee3_decoder_tpu_torch.ops import channelizer_cuda as cc

    P = TAPS_PER_BRANCH
    names = {1: "channelize", 2: "channelize2"}
    for os_, nfr, extra, off in ((1, 4096 + P - 1, 0, 0), (2, 4096 + P, 0, 0),
                                 (1, 3000, 5, 0), (2, 3001, nchan // 2 + 1, 3)):
        packed = random_packed(dev, nfr * nchan + extra + off, seed=nfr)[off:]
        got = cc.channelize_raw_fused(packed, nchan, P, oversample=os_)
        want = cc.channelize_raw_plain(packed, nchan, P, oversample=os_)
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"K7 {names[os_]}: shape {tuple(got.shape)} vs plain "
                f"{tuple(want.shape)}")
        require(got.stride(0) % 8 == 0 and got.data_ptr() % 16 == 0,
                f"K7 {names[os_]}: rows not 16-byte aligned")
        worst, share = raw_diff(got, want)
        log(f"  K7 {names[os_]}: {nfr} frames + {extra} words at word "
            f"offset {off} -> {tuple(got.shape)}, max |diff| {worst} LSB, "
            f"{share:.5%} differ")
        require(worst <= 1 and share < 0.01, f"K7 {names[os_]} disagrees")

    out = {}
    packed = random_packed(dev, frames * nchan, seed=7)
    logm = int(np.log2(nchan))
    for os_ in (1, 2):
        got = cc.channelize_raw_fused(packed, nchan, P, oversample=os_)
        want = cc.channelize_raw_plain(packed, nchan, P, oversample=os_)
        require(got.shape == want.shape, f"K7 {names[os_]}: shapes differ")
        worst, share = raw_diff(got, want)
        require(worst <= 1 and share < 0.01,
                f"K7 {names[os_]} disagrees at the block shape")
        nsamp = got.shape[1] // 2
        del got, want
        out[names[os_]] = dict(
            max_abs_err=worst,
            ms=cuda_ms(lambda: cc.channelize_raw_fused(
                packed, nchan, P, oversample=os_), 10),
            plain_ms=cuda_ms(lambda: cc.channelize_raw_plain(
                packed, nchan, P, oversample=os_), 2),
            library_ms=None,
            # every word read once, every (I, Q) pair written once; P tap
            # multiply-adds on I and Q and, as an FFT, 5 log2(M) operations
            # per output sample and channel
            **bound(packed.numel() * 4 + nchan * nsamp * 4,
                    float(nchan) * nsamp * (4 * P + 5 * logm), F32_OPS_PER_S),
        )
        torch.cuda.empty_cache()
        r = out[names[os_]]
        plan = cc.pfb_plan(nchan, P, os_, nsamp,
                           torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
        log(f"  K7 {names[os_]} at {nchan} x {frames} frames: max |diff| "
            f"{worst} LSB, {share:.5%} differ; {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']})"
            f"; plan: tile {plan['tile']}, split {plan['split']}, ring "
            f"{plan['ring']}, {plan['smem']} B shared, {plan['blocks_per_sm']} "
            f"blocks an SM, grid {plan['grid']}, pitch {plan['pitch']} words")
    return out


def frames_available(soft) -> int:
    """Whole frames after the latest channel's first sync."""
    from isee3_decoder_tpu_torch.config import FRAMESYMBOLS, SYNCBITS
    from isee3_decoder_tpu_torch.ops.syncword import find_sync

    ss, _ = find_sync(soft[:, : FRAMESYMBOLS + SYNCBITS], FRAMESYMBOLS)
    return int((soft.shape[1] - int(ss.max()) - SYNCBITS) // FRAMESYMBOLS)


def own_frames_mask(rec, per_chan, nframes: int) -> np.ndarray:
    """Lanes that are good and equal a frame their own channel sent."""
    return np.array([bool(g) and any(np.array_equal(d, fr)
                                     for fr in per_chan[lane // nframes])
                     for lane, (g, d) in enumerate(zip(rec.good, rec.data))])


def phase_wideband(dev, cfg, nchan: int = NCHAN, frames: int = WIDE_FRAMES):
    """Phase 6: one wide capture carrying a different frame stream in each
    of nchan slots -> receive_block_wideband.  Returns the launches of
    the counted run."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.models.pipeline import (
        demod_to_symbols,
        receive_block_wideband,
        wideband_raw,
    )
    from isee3_decoder_tpu_torch.utils.devicesignal import (
        random_frames,
        synthesize_wideband_device,
        to_packed_wide,
    )

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    per_chan = np.stack([random_frames(rng, NFRAMES_TX) for _ in range(nchan)])
    carriers = torch.as_tensor(20_000.0 + 137.0 * np.arange(nchan),
                               dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    # amplitude within the capture's 16-bit range (the slots' carriers
    # add); noise scaled with it, so each slot's C/N0 is the clean regime's
    amp = min(12_000.0, 30_000.0 / nchan)
    wide = synthesize_wideband_device(
        torch.as_tensor(per_chan, device=dev), carriers, gen, frames, nchan,
        samprate=cfg.pm.samprate, symrate=cfg.sym.symrate, amplitude=amp,
        noise_std=NOISE_CLEAN * amp / 12_000.0)
    packed = to_packed_wide(wide)
    del wide
    torch.cuda.empty_cache()
    soft = demod_to_symbols(wideband_raw(packed, nchan, TAPS_PER_BRANCH), cfg)[0]
    nframes = frames_available(soft)
    require(nframes >= 1, "wideband: no whole frame in the block")
    del soft

    def run():
        return receive_block_wideband(packed, nchan, nframes, cfg,
                                      taps_per_branch=TAPS_PER_BRANCH)

    run()  # warm-up of the decode half
    rec, times, launches, backends = timed_runs(run)
    own = own_frames_mask(rec, per_chan, nframes)
    log(f"phase 6 wideband: 1 capture of {nchan} slots x {frames} frames "
        f"({packed.numel() * 4 / 2**30:.2f} GiB packed), {nframes} frames per "
        f"channel, receive_block_wideband {_ms(times)} ms (counted run, then 4 "
        f"more); good {int(rec.good.sum())}/{rec.good.size}, from their own "
        f"channel {int(own.sum())}; decoders {decoder_mix(rec)}; launches "
        f"{launches}; backend {backends} ({time.perf_counter() - t0:.1f} s)")
    for stage in ("channelizer", "pm", "csum"):
        require(backends.get(stage) == "cuda",
                f"wideband: stage {stage} did not run on CUDA")
    require(launches["channelize"] == 1,
            "wideband: K7a must launch once per block")
    require(bool((own == rec.good).all()),
            "wideband: a good frame was not sent on its own channel")
    require(int(rec.good.sum()) == rec.good.size,
            "wideband: not every frame decoded")
    # the same call through every kernel's plain version, on the card
    with _kernels.plain_reference():
        rec_p, ss_p = run()
    rec_k, ss_k = run()
    for field in ("data", "good", "decoder"):
        require(np.array_equal(getattr(rec_k, field), getattr(rec_p, field)),
                f"wideband: kernel and plain paths differ in {field}")
    require(np.array_equal(ss_k, ss_p), "wideband: sync differs")
    log(f"  kernel path == plain path over {nchan} channels: bytes, good "
        f"flags, decoder labels")
    profile_block(packed, nframes, cfg, "wideband", run=run,
                  front=lambda w: wideband_raw(w, nchan, TAPS_PER_BRANCH))
    return launches


def edge_capture(dev, frames: np.ndarray, carrier_hz: float, samprate: float,
                 nsamples: int, symrate: float, amplitude: float,
                 noise_std: float, seed: int):
    """One PM downlink at carrier_hz in a capture at samprate, packed
    int32.  The carrier phase runs in float64 cycles reduced mod 1: at
    megahertz offsets over millions of samples a float32 ramp loses the
    phase."""
    import torch

    from isee3_decoder_tpu_torch.config import DEFAULT_CODE, SYNC_STATE
    from isee3_decoder_tpu_torch.ops.encode import bytes_to_bits, encode_bits
    from isee3_decoder_tpu_torch.utils.devicesignal import to_packed_wide

    bits = bytes_to_bits(torch.as_tensor(frames, device=dev).reshape(1, -1))
    syms, _ = encode_bits(bits, SYNC_STATE, DEFAULT_CODE)
    t = torch.arange(nsamples, dtype=torch.float64, device=dev)
    pos = t * (symrate / samprate)
    idx = torch.floor(pos).to(torch.int64) % syms.shape[-1]
    level = torch.where(syms[0, idx] > 0, 1.0, -1.0)
    d = torch.where(pos - torch.floor(pos) >= 0.5, level, -level)
    cycles = torch.remainder(t * (carrier_hz / samprate), 1.0)
    ph = (2 * np.pi * cycles + 1.1 * d + 0.7).to(torch.float32)
    del t, pos, idx, level, d, cycles
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    iq = amplitude * torch.polar(torch.ones_like(ph), ph)
    iq = iq + noise_std * torch.complex(
        torch.randn(ph.shape, generator=gen, device=dev),
        torch.randn(ph.shape, generator=gen, device=dev))
    return to_packed_wide(iq)


def phase_edge(dev, nchan: int = EDGE_NCHAN, samprate: float = EDGE_SAMPRATE,
               symrate: float = SYMRATE, slot: int = EDGE_SLOT):
    """Phase 7: a downlink whose carrier sits exactly on the edge between
    slots ``slot`` and ``slot + 1`` -> the 2x oversampled bank (kernel
    K7b) -> both neighbouring rows through receive_block at the doubled
    channel rate.  Returns the launches of the path."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.models.decode import DecodeConfig
    from isee3_decoder_tpu_torch.models.pipeline import (
        PipelineConfig,
        demod_to_symbols,
        receive_block,
    )
    from isee3_decoder_tpu_torch.ops import channelizer_cuda as cc
    from isee3_decoder_tpu_torch.ops.carrier import PMConfig
    from isee3_decoder_tpu_torch.ops.channelizer import channel_center
    from isee3_decoder_tpu_torch.ops.symbols import SymConfig
    from isee3_decoder_tpu_torch.utils.devicesignal import random_frames

    t0 = time.perf_counter()
    fs_out = 2 * samprate / nchan
    frames = random_frames(np.random.default_rng(7), 3)
    nsamples = int((3 * 2048 + 400) / symrate * samprate)
    packed = edge_capture(
        dev, frames, channel_center(slot, samprate, nchan) + fs_out / 4,
        samprate, nsamples, symrate, amplitude=3000.0, noise_std=30.0, seed=7)
    cfg = PipelineConfig(
        pm=PMConfig(samprate=fs_out, binsize=4.0, search_width=200.0),
        sym=SymConfig(samprate=fs_out, symrate=symrate),
        decode=DecodeConfig(),
    )
    # sizing pass (also the warm-up): how many whole frames the block holds
    raw = cc.channelize_raw_fused(packed, nchan, TAPS_PER_BRANCH, oversample=2)
    soft, _, freq, _ = demod_to_symbols(raw[slot : slot + 2].contiguous(), cfg)
    nframes = frames_available(soft)
    require(nframes >= 1, "edge carrier: no whole frame in the block")
    del raw, soft
    torch.cuda.synchronize()
    _kernels.reset_launches()
    raw = cc.channelize_raw_fused(packed, nchan, TAPS_PER_BRANCH, oversample=2)
    rows = raw[slot : slot + 2].contiguous()
    rec, _ = receive_block(rows, nframes, cfg)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    backends = dict(_kernels.backend_used)
    want = cc.channelize_raw_plain(packed, nchan, TAPS_PER_BRANCH, oversample=2)
    worst, share = raw_diff(raw, want)
    found = freq[-1].tolist()
    matched = matched_mask(rec, frames, 2, nframes)
    log(f"phase 7 edge carrier: {nchan} slots at {samprate:.0f} sps, carrier "
        f"on the edge of slots {slot}/{slot + 1}, K7b -> {tuple(raw.shape)} at "
        f"{fs_out:.0f} sps (vs plain: max |diff| {worst} LSB, {share:.5%} "
        f"differ); carriers found {found} Hz; {nframes} frames per row, good "
        f"{int(rec.good.sum())}/{rec.good.size}, matched {int(matched.sum())}; "
        f"decoders {decoder_mix(rec)}; launches {launches}; backend {backends} "
        f"({time.perf_counter() - t0:.1f} s)")
    require(worst <= 1 and share < 0.01, "edge carrier: K7b disagrees with plain")
    require(launches["channelize2"] >= 1, "edge carrier: K7b never launched")
    require(backends.get("channelizer") == "cuda",
            "edge carrier: channelizer did not run on CUDA")
    require(abs(found[0] - fs_out / 4) < 50.0 and abs(found[1] + fs_out / 4) < 50.0,
            "edge carrier: carrier not at +-fs_out/4 in the neighbouring rows")
    require(bool((matched == rec.good).all()),
            "edge carrier: a good frame was not sent")
    require(int(matched.sum()) >= 1, "edge carrier: no good, matched frame")
    return launches


def phase_pipelined(dev, nsamples: int, nframes: int, cfg, nblocks: int = 4,
                    label: str = "8"):
    """Phase 8: nblocks clean blocks through receive_blocks_pipelined
    (depth 2) give, in order, the records of as many receive_block calls
    (more blocks than depth + 1, so a pinned result buffer is used twice);
    wall time per block of both loops."""
    import torch

    from isee3_decoder_tpu_torch.models.pipeline import (
        receive_block,
        receive_blocks_pipelined,
    )

    t0 = time.perf_counter()
    # a different frame stream in each block, so the order shows
    blocks = [bench_block(dev, NCHAN, nsamples, NOISE_CLEAN, seed=20 + i,
                          frames_seed=20 + i)[1] for i in range(nblocks)]
    torch.cuda.synchronize()
    walls = {}
    for name in ("loop", "pipelined", "pipelined", "loop"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if name == "loop":
            got = [receive_block(b, nframes, cfg) for b in blocks]
        else:
            got = list(receive_blocks_pipelined(blocks, nframes, cfg, depth=2))
        torch.cuda.synchronize()
        walls.setdefault(name, []).append((time.perf_counter() - t1) / nblocks)
        if name == "loop":
            serial = got
        else:
            piped = got
    require(len(piped) == nblocks, "pipelined: wrong number of blocks")
    for i, ((rp, sp), (rs, ss)) in enumerate(zip(piped, serial)):
        for field in ("data", "good", "decoder", "fano_cycles", "start_symbol"):
            require(np.array_equal(getattr(rp, field), getattr(rs, field)),
                    f"pipelined: block {i} differs from receive_block in {field}")
        require(np.array_equal(sp, ss), f"pipelined: block {i} sync differs")
        require(bool(rp.good.all()), f"pipelined: block {i} has a bad frame")
    require(not np.array_equal(serial[0][0].data, serial[1][0].data),
            "pipelined: the blocks carry the same frames, order is unchecked")
    log(f"phase {label} pipelined: {nblocks} clean blocks, depth 2 == receive_block "
        f"block by block; ms per block: plain loop {_ms(walls['loop'])}, "
        f"pipelined {_ms(walls['pipelined'])} "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_fused_scan(dev, nsamples: int, nframes: int, pm, sym, rec_thr):
    """Phase 9: the clean and mid bench blocks with
    pm_backend="fused_scan" (kernel K9 for blocks 1..31) against "auto"
    on the same IQ: frames, good flags and labels equal on all 128
    channels; per block K9 once, K2 once (the cold-start block), no K1,
    no K3; block times of both in turns, a stage profile and device busy
    of the fused block; then the pipelined driver with the fused scan;
    then a threshold block, whose unlocked channels send the call to the
    block scan, giving phase 5's frames (``rec_thr``).  Returns the
    launches of the counted runs."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.models.decode import DecodeConfig
    from isee3_decoder_tpu_torch.models.pipeline import (
        PipelineConfig,
        receive_block,
    )

    t0 = time.perf_counter()
    launches = {}
    for regime, noise, seed, dcfg in (
            ("clean", NOISE_CLEAN, 0, DecodeConfig()),
            ("mid", NOISE_MID, 99, DecodeConfig.strict_labels())):
        auto = PipelineConfig(pm=pm, sym=sym, decode=dcfg)
        fused = PipelineConfig(pm=pm, sym=sym, decode=dcfg,
                               pm_backend="fused_scan")
        frames, iq, _ = bench_block(dev, NCHAN, nsamples, noise, seed=seed)
        receive_block(iq, nframes, fused)  # warm-up
        rec_f, t_f, lf, bf = timed_runs(lambda: receive_block(iq, nframes,
                                                              fused))
        rec_a, t_a, _, _ = timed_runs(lambda: receive_block(iq, nframes, auto))
        t_f2 = timed_runs(lambda: receive_block(iq, nframes, fused))[1]
        good, matched = frame_stats(rec_f, frames, NCHAN, nframes)
        log(f"phase 9 fused scan, {regime}: {NCHAN} ch x {nframes} frames, "
            f"receive_block fused {_ms(t_f)} / {_ms(t_f2)} ms, auto "
            f"{_ms(t_a)} ms (same IQ, in turns); good {good}/"
            f"{rec_f.good.size}, matched {matched}; decoders "
            f"{decoder_mix(rec_f)}; launches {lf}; backend {bf}")
        for field in ("data", "good", "decoder", "start_symbol"):
            require(np.array_equal(getattr(rec_f, field), getattr(rec_a, field)),
                    f"fused scan {regime}: differs from auto in {field}")
        require(matched == good, f"fused scan {regime}: a good frame was not "
                "sent")
        require(lf["pm_scan"] == 1 and lf["spin_down"] == 1
                and lf["pm_locked"] == 0 and lf["prefix_sum"] == 0,
                f"fused scan {regime}: launches per block {lf}")
        require(bf.get("pm_scan") == "cuda" and bf.get("pm") == "cuda",
                f"fused scan {regime}: K9 did not run on CUDA")
        for k, v in lf.items():
            launches[k] = launches.get(k, 0) + v
        profile_block(iq, nframes, fused, f"{regime} fused scan",
                      run=lambda: receive_block(iq, nframes, fused))
        del iq
    log(f"  fused scan == auto over {NCHAN} channels, clean and mid: bytes, "
        "good flags, decoder labels, start symbols")

    fused = PipelineConfig(pm=pm, sym=sym, decode=DecodeConfig(),
                           pm_backend="fused_scan")
    phase_pipelined(dev, nsamples, nframes, fused, label="9 fused scan")

    frames, iq, _ = bench_block(dev, NCHAN, nsamples, NOISE_THRESHOLD, seed=11)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    rec, _ = receive_block(iq, nframes, fused)
    torch.cuda.synchronize()
    lt, bt = dict(_kernels.LAUNCHES), dict(_kernels.backend_used)
    log(f"phase 9 fused scan, threshold: launches {lt}; backend {bt}; good "
        f"{int(rec.good.sum())}/{rec.good.size}; decoders {decoder_mix(rec)} "
        f"({time.perf_counter() - t0:.1f} s)")
    require(bt.get("pm_scan") == "fallback" and lt["pm_scan"] == 1
            and lt["prefix_sum"] == 1,
            "fused scan threshold: the fallback was not taken")
    for field in ("data", "good", "decoder", "start_symbol"):
        require(np.array_equal(getattr(rec, field), getattr(rec_thr, field)),
                f"fused scan threshold: differs from phase 5 in {field}")
    log("  fused scan threshold block: fallback taken, frames == phase 5's")
    return launches


def phase_narrowband(dev, nchan: int = NCHAN):
    """Phase 10: 128 channels at 32,768 sps, binsize 8 -> n = 4096 (67 pm
    blocks in 8.39 s), carriers 4000 Hz + 37 Hz·i (channels 4, 12, ...
    sit on a half bin; clean noise still locks them) through
    receive_block: each locked block searches with K8 (its peak pass in
    the same launch) and spins down with K2, no K1.  Then the same block
    with K1 for every locked block, timed in turns, frames equal.
    Returns the launches of the counted run."""
    from isee3_decoder_tpu_torch.models.decode import DecodeConfig
    from isee3_decoder_tpu_torch.models.pipeline import (
        PipelineConfig,
        demod_to_symbols,
        receive_block,
    )
    from isee3_decoder_tpu_torch.ops.carrier import PMConfig
    from isee3_decoder_tpu_torch.ops.symbols import SymConfig

    t0 = time.perf_counter()
    cfg = PipelineConfig(
        pm=PMConfig(samprate=NB_SAMPRATE, binsize=NB_BINSIZE,
                    search_width=200.0),
        sym=SymConfig(samprate=NB_SAMPRATE, symrate=SYMRATE),
        decode=DecodeConfig(),
    )
    nsamples = int((NFRAMES_TX * 2048 + 400) / SYMRATE * NB_SAMPRATE)
    frames, iq, carriers = bench_block(dev, nchan, nsamples, NOISE_CLEAN,
                                       seed=10, samprate=NB_SAMPRATE,
                                       carrier0=NB_CARRIER0,
                                       spacing=NB_SPACING)
    soft, _, freq, cn0 = demod_to_symbols(iq, cfg)  # warm-up; frames
    nframes = frames_available(soft)
    require(nframes >= 1, "narrowband: no whole frame in the block")
    nblocks = freq.shape[0]
    rec, times, launches, backends = timed_runs(
        lambda: receive_block(iq, nframes, cfg))
    good, matched = frame_stats(rec, frames, nchan, nframes)
    log(f"phase 10 narrowband: {nchan} ch at {NB_SAMPRATE:.0f} sps, n = "
        f"{cfg.pm.fftsize}, {nblocks} pm blocks, {nframes} frames per "
        f"channel, receive_block {_ms(times)} ms (counted run, then 4 more); "
        f"max |carrier - found| {float((freq[-1] - carriers).abs().max()):.3f}"
        f" Hz; good {good}/{rec.good.size}, matched {matched}; decoders "
        f"{decoder_mix(rec)}; launches {launches}; backend {backends} "
        f"({time.perf_counter() - t0:.1f} s)")
    require(bool((cn0[1:] > cfg.pm.cn0_threshold).all()),
            "narrowband: a channel lost lock")
    require(matched == rec.good.size, "narrowband: not every frame decoded")
    require(launches["windowed_dft"] == nblocks - 1
            and launches["spin_down"] == nblocks
            and launches["pm_locked"] == 0,
            f"narrowband: launches per block {launches}")
    require(backends.get("search") == "cuda", "narrowband: K8 not on CUDA")
    profile_block(iq, nframes, cfg, "narrowband")

    # what the K8 branch costs end to end: the same IQ with every locked
    # block on K1 (the dispatch for n a multiple of the chunk), in turns
    # with the K8 dispatch; a measurement, not a path of the package
    from isee3_decoder_tpu_torch.ops import carrier_cuda

    chunk = carrier_cuda.SCAN_CHUNK
    carrier_cuda.SCAN_CHUNK = 256
    try:
        rec1, t_k1, l_k1, b_k1 = timed_runs(lambda: receive_block(iq, nframes,
                                                                  cfg))
        profile_block(iq, nframes, cfg, "narrowband, K1 dispatch")
    finally:
        carrier_cuda.SCAN_CHUNK = chunk
    t_k8 = timed_runs(lambda: receive_block(iq, nframes, cfg))[1]
    log(f"  narrowband receive_block with K1 for the locked blocks "
        f"{_ms(t_k1)} ms against K8 + K2 {_ms(t_k8)} ms (same IQ, in turns);"
        f" launches {l_k1}")
    require(l_k1["pm_locked"] == nblocks - 1 and l_k1["windowed_dft"] == 0,
            f"narrowband K1 dispatch: launches {l_k1}")
    require(b_k1.get("pm_locked") == "direct",
            f"narrowband K1 dispatch: K1 design {b_k1.get('pm_locked')}")
    for field in ("data", "good", "decoder", "start_symbol"):
        require(np.array_equal(getattr(rec1, field), getattr(rec, field)),
                f"narrowband: K1 and K8 dispatch differ in {field}")
    return launches


def viterbi_lanes_check(iq, nframes: int, cfg, rec, label: str,
                        lanes=None) -> int:
    """Up to 2 of a block's Viterbi lanes (or the given ``lanes``) again
    through the decode stage's Viterbi decoder
    (``cfg.decode.viterbi_backend``), with the kernels and under
    plain_reference(): the bits must be equal.  Returns the number of
    lanes checked."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import FRAMESYMBOLS
    from isee3_decoder_tpu_torch.models.decode import (
        DECODER_VITERBI,
        _viterbi_decode,
    )
    from isee3_decoder_tpu_torch.models.pipeline import receive_block_device_soft

    _, soft = receive_block_device_soft(iq, nframes, FRAMESYMBOLS, cfg)
    if lanes is None:
        lanes = np.nonzero(rec.decoder == DECODER_VITERBI)[0][:2]
    fsyms = torch.stack([soft[lane // nframes, s : s + FRAMESYMBOLS]
                         for lane, s in zip(lanes, rec.start_symbol[lanes])])
    bits_k = _viterbi_decode(fsyms, cfg.decode)
    with _kernels.plain_reference():
        bits_p = _viterbi_decode(fsyms, cfg.decode)
    require(torch.equal(bits_k, bits_p),
            f"{label}: Viterbi lanes differ between kernels and plain")
    log(f"  {lanes.size} Viterbi lane(s) kernel path == plain path "
        f"(viterbi_backend {cfg.decode.viterbi_backend!r})")
    return int(lanes.size)


def check_viterbi_acs(dev, batch: int) -> dict:
    """Phase 11(a): K10 against its plain version at K=24, 8 trellis
    steps at B=2 in int16 and in int32 and at B=``batch`` in int32 (the
    threshold block's Viterbi batch, the main path's shape), from random
    metrics inside the renorm range, each step fed the previous one's
    minimum: new metrics, decision words and minima bit-equal.  Then
    K10's ms per step (CUDA events) beside the plain version's and the
    bound, at B=1 and B=8 in both types and at B=``batch`` in int32,
    each launch's output checked bit-equal to the plain version's on the
    same buffers; the main-path record is returned."""
    import torch

    from isee3_decoder_tpu_torch.config import DEFAULT_CODE as code
    from isee3_decoder_tpu_torch.ops import viterbi_acs_cuda as vac

    n = code.nstates
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    for B, dtype in ((2, torch.int16), (2, torch.int32), (batch, torch.int32)):
        mk = mp = ri(0, 12000, (B, n)).to(dtype)
        ak = ap = torch.zeros(B, dtype=torch.int32, device=dev)
        for t in range(8):
            syms = ri(0, 256, (B, 2))
            mk, dk, ak = vac.acs_step(mk, syms, ak, code)
            mp, dp, ap = vac.acs_step_plain(mp, syms, ap, code)
            require(torch.equal(mk, mp) and torch.equal(dk, dp)
                    and torch.equal(ak, ap),
                    f"K10 differs from its plain version (B={B}, {dtype}, "
                    f"step {t})")
    del mk, mp, dk, dp

    def timed(B: int, dtype) -> dict:
        """K10 as update_blk launches it (buffers made beforehand; the
        minimum cell is not reset, which changes no work and leaves the
        same minimum): CUDA-event ms per launch, and the kernel's own
        time under torch.profiler; then the outputs of these launches
        against the plain version on the same inputs, bit-equal."""
        m = ri(0, 12000, (B, n)).to(dtype)
        out = torch.empty_like(m)
        dec = torch.empty((B, n // 32), dtype=torch.int32, device=dev)
        syms = ri(0, 256, (B, 2))
        adj = ri(0, 600, (B,))
        gmin = torch.full((B,), vac.INT32_MAX, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run():
            vac.launch(m, syms, adj, out, dec, gmin, code, stream=stream)

        e = m.element_size()
        rec = dict(
            ms=cuda_ms(run, 50),
            device_ms=kernel_device_ms(run, 50, "viterbi_acs_kernel"),
            plain_ms=cuda_ms(lambda: vac.acs_step_plain(m, syms, adj, code), 3),
            library_ms=None,
            **bound(B * (2 * n * e + n // 8) + syms.numel() * 4 + 2 * B * 4,
                    B * (n // 2) * ACS10_OPS_PER_BUTTERFLY, I32_OPS_PER_S),
        )
        want = vac.acs_step_plain(m, syms, adj, code)
        require(torch.equal(dec, want[1]) and torch.equal(gmin, want[2]),
                f"K10 timed at B={B} {dtype}: decisions or minimum differ "
                "from the plain version")
        rec["max_abs_err"] = int((out.to(torch.int64)
                                  - want[0].to(torch.int64)).abs().max())
        require(rec["max_abs_err"] == 0,
                f"K10 timed at B={B} {dtype}: metrics differ from the plain "
                "version")
        return rec

    table = {f"B={B} {str(dt)[6:]}": timed(B, dt) for B in (1, 8)
             for dt in (torch.int16, torch.int32)}
    rec = timed(batch, torch.int32)
    table[f"B={batch} int32 (main path)"] = rec
    log(f"phase 11 classic Viterbi (a): K10 == plain at K=24, 8 steps, B=2 "
        f"int16 and int32, B={batch} int32 (metrics, decisions, minima "
        "bit-equal; each timed shape's outputs too); ms per step "
        + json.dumps({k: {f: round(v[f], 5) for f in (
            "ms", "device_ms", "plain_ms", "bound_ms")}
                      for k, v in table.items()}))
    return {"viterbi_acs": rec}


def profiled_kernels(fn, reps: int, name: str = "") -> list:
    """The kernels whose name holds ``name`` that torch.profiler records
    over reps calls of fn (after one warm call), as (name, device ms):
    each session runs PROFILE_WARMUP calls in the schedule's warm-up,
    then the reps counted ones, and a session that records fewer than
    reps // 2 such kernels is made again, up to PROFILE_TRIES times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        got: list = []

        def ready(prof):
            got.extend((e.name, (e.time_range.end - e.time_range.start) / 1e3)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA and name in e.name)

        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=PROFILE_WARMUP,
                                       active=reps, repeat=1),
                     on_trace_ready=ready) as prof:
            for _ in range(PROFILE_WARMUP + reps):
                fn()
                torch.cuda.synchronize()
                prof.step()
        if len(got) >= reps // 2:
            return got
    fail(f"profiler saw {len(got)} {name or 'kernel'} launches in {reps} calls "
         f"in each of {PROFILE_TRIES} sessions")


def kernel_device_ms(fn, reps: int, name: str) -> float:
    """Mean device milliseconds of the kernels whose name holds ``name``
    over the launches torch.profiler records in reps calls of fn."""
    spans = [ms for _, ms in profiled_kernels(fn, reps, name)]
    return sum(spans) / len(spans)


def calls_device_ms(fn, reps: int) -> tuple[float, float, list[str]]:
    """Device milliseconds per call of fn summed over every kernel it
    launches, the kernels per call and their names, over reps calls
    (after one warm call) under torch.profiler."""
    total, per_call, by_name = kernels_device_ms(fn, reps)
    return total, per_call, sorted(by_name)


def kernels_device_ms(fn, reps: int) -> tuple[float, float, dict]:
    """calls_device_ms with the device milliseconds per call of each
    kernel by name: (total ms per call, kernels per call, {name: ms})."""
    ev = profiled_kernels(fn, reps)
    by_name: dict[str, float] = {}
    for kname, ms in ev:
        by_name[kname] = by_name.get(kname, 0.0) + ms / reps
    return sum(by_name.values()), len(ev) / reps, by_name


def profile_kernels(dev, checks: dict, batch: int) -> None:
    """Phase 12: the device time of K1, K2, K3, K8, K5, K6, K9 and K4 from
    torch.profiler, beside their CUDA-event times of phase 2 and 5 (the
    profiler's hooks slow every later launch of the process, so this runs
    after every timed block).  K8 at the narrowband shape, with
    torch.fft.fft's device time over all bins of the same block, must show
    one kernel per call; K1 at the bench shape must show its search launch
    and the cluster spin-down, timed apart, with torch.fft.fft over all bins
    of the same rows; K2 on the same rows must show the cluster spin-down
    alone; K5/K6 over one K=24 cycle at B=2 and at the threshold
    block's batch (the record keeps the latter); K9 and K3 at the bench
    shapes of phase 2; K4 at phase 2's case (a), 256 lanes at 12 cycles/bit."""
    import torch

    from isee3_decoder_tpu_torch.config import DEFAULT_CODE as code
    from isee3_decoder_tpu_torch.ops import carrier, carrier_cuda, fano_cuda
    from isee3_decoder_tpu_torch.ops import prefix_cuda
    from isee3_decoder_tpu_torch.ops import viterbi_cuda as vc

    _, _, raw, search = k8_inputs(dev)
    iq = carrier.iq_from_interleaved(raw)
    k8_dev, per_call, names = calls_device_ms(
        lambda: carrier_cuda.windowed_search_raw(*search), 50)
    require(all("windowed_search_kernel" in nm for nm in names)
            and per_call <= 1.0,
            f"K8: {per_call} kernels per call ({names}), not one")
    fft_dev = calls_device_ms(lambda: torch.fft.fft(iq, dim=-1), 50)[0]
    checks["windowed_dft"].update(device_ms=k8_dev, library_device_ms=fft_dev)
    nbins = iq.shape[1]
    del raw, iq, search
    w, rowb, _ = vc._geometry(code)
    dev_ms = {}
    for B in (2, batch):
        m, sa, sb, base = cycle_inputs(dev, B, seed=26)
        da = torch.empty((B, rowb, code.nstates // 32), dtype=torch.int32,
                         device=dev)
        db = torch.empty((B, w - rowb, code.nstates // 32), dtype=torch.int32,
                         device=dev)
        dev_ms[B] = (
            kernel_device_ms(lambda: vc.cycle_a(m, sa, code, rowb, base, da),
                             PROFILE_CALLS, "viterbi_a_kernel"),
            kernel_device_ms(lambda: vc.cycle_b(m, sb, code, w - rowb, db),
                             PROFILE_CALLS, "viterbi_b_kernel"))
        del m, da, db
    checks["viterbi_a"]["device_ms"], checks["viterbi_b"]["device_ms"] = \
        dev_ms[batch]
    # K1 at the bench shape of phase 2: the search launch and the spin
    # passes apart, beside torch.fft.fft over all bins of the same rows
    k1_args, iq, carriers = k1_inputs(dev)
    k1_dev, per_call, by_name = kernels_device_ms(
        lambda: carrier_cuda.pm_locked_fused(*k1_args), 20)
    search = {k: v for k, v in by_name.items() if "locked_search_kernel" in k}
    spin = {k: v for k, v in by_name.items() if "spin_cluster_kernel" in k}
    # (the third kernel of a call is the wrapper's stack of the window
    # into one (B, 2) int32 tensor)
    require(len(search) == 1 and len(spin) == 1 and per_call <= 3.0
            and not any(k2 in k for k in by_name
                        for k2 in ("dft_kernel", "peak_kernel",
                                   "moments_kernel", "emit_kernel")),
            f"K1: {per_call} kernels per call ({sorted(by_name)}), not the "
            f"search launch and the cluster spin-down")
    fft1_dev = calls_device_ms(lambda: torch.fft.fft(iq, dim=-1), 20)[0]
    checks["pm_locked"].update(
        device_ms=k1_dev, search_device_ms=sum(search.values()),
        spin_device_ms=sum(spin.values()), search_library_device_ms=fft1_dev)
    r = checks["pm_locked"]
    log(f"phase 12 K1 at {NCHAN} x {iq.shape[1]}, K = {k1_args[3]}: "
        f"{k1_dev:.4f} ms device time per call in {per_call:.0f} kernels: "
        + ", ".join(f"{k.split('(')[0]} {v:.4f}" for k, v in by_name.items())
        + f"; search {r['search_device_ms']:.4f} ms (bound "
        f"{r['search_bound_ms']:.4f}), torch.fft.fft over all bins "
        f"{fft1_dev:.4f} ms")
    # K2 at the same rows, 0.125 Hz off the carriers: one launch a call
    f2 = carriers + 0.125
    k2_dev, per_call, names = calls_device_ms(
        lambda: carrier_cuda.spin_down_fused(k1_args[0], f2, SAMPRATE), 20)
    require(len(names) == 1 and "spin_cluster_kernel" in names[0]
            and per_call <= 1.0,
            f"K2: {per_call} kernels per call ({names}), not the cluster "
            f"spin-down alone")
    checks["spin_down"]["device_ms"] = k2_dev
    log(f"phase 12 K2 at {NCHAN} x {iq.shape[1]}: {k2_dev:.4f} ms device "
        f"time in one kernel per call")
    del k1_args, iq, f2
    _, args = k9_inputs(dev)
    k9_dev = kernel_device_ms(
        lambda: carrier_cuda.pm_scan_locked_fused(*args, tail=1),
        PROFILE_CALLS, "pm_scan_kernel")
    checks["pm_scan"]["device_ms"] = k9_dev
    del args
    # K3 at the bench shape of phase 2: its one launch (the workspace's
    # memset is no kernel)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bb = torch.randint(-32768, 32768, (32, NCHAN, 65536), generator=gen,
                       device=dev, dtype=torch.int32).to(torch.int16)
    k3_dev = kernel_device_ms(
        lambda: prefix_cuda.prefix_sum_blocks(bb, tail=1), PROFILE_CALLS,
        "prefix_tile_kernel")
    checks["prefix_sum"]["device_ms"] = k3_dev
    del bb
    # K4 at phase 2's case (a): its one launch on the warp design
    dcfg, cases = k4_inputs(dev)
    _, m4, regs, maxcycles = cases[0]
    k4_dev = kernel_device_ms(
        lambda: fano_cuda.fano_walk(m4, regs, dcfg.code, dcfg.fano_delta,
                                    maxcycles),
        PROFILE_CALLS, "fano_warp_kernel")
    checks["fano_walk"]["device_ms"] = k4_dev
    del m4, regs, cases
    log(f"phase 12 device time (torch.profiler): K8 {k8_dev:.5f} ms in one "
        f"kernel per call, torch.fft.fft {fft_dev:.5f} ms (all {nbins} bins); "
        f"K5/K6 at K=24: "
        + ", ".join(f"B={B} {a:.4f} / {b:.4f} ms" for B, (a, b)
                    in dev_ms.items())
        + f"; K9 at {NCHAN} x 32 x 65,536, K = 107: {k9_dev:.4f} ms; K3 at "
        f"32 x {NCHAN} x 65,536: {k3_dev:.4f} ms; K4 "
        f"(warp) at 256 lanes, 12 cycles/bit: {k4_dev:.4f} ms")
    torch.cuda.empty_cache()


def classic_threshold(dev, nsamples: int, nframes: int, pm, sym,
                      rec_thr) -> dict:
    """Phase 11(b): phase 5's threshold block with DecodeConfig(
    viterbi_backend="jnp"): phase 5's frames, flags, labels and start
    symbols on all 128 channels, K10 1024 times per frame chunk and no
    K5/K6; the host tail of both backends in turns on the same IQ, and a
    profile.  Returns the counted run's launches."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import FRAMEBITS
    from isee3_decoder_tpu_torch.models.decode import (
        DECODER_VITERBI,
        DecodeConfig,
    )
    from isee3_decoder_tpu_torch.models.pipeline import (
        PipelineConfig,
        receive_block,
    )

    t0 = time.perf_counter()
    classic = PipelineConfig(pm=pm, sym=sym,
                             decode=DecodeConfig(viterbi_backend="jnp"))
    fused = PipelineConfig(pm=pm, sym=sym, decode=DecodeConfig())
    _, iq, _ = bench_block(dev, NCHAN, nsamples, NOISE_THRESHOLD, seed=11)
    receive_block(iq, nframes, classic)  # warm-up
    torch.cuda.synchronize()
    _kernels.reset_launches()
    rec, _ = receive_block(iq, nframes, classic)
    torch.cuda.synchronize()
    launches, bb = dict(_kernels.LAUNCHES), dict(_kernels.backend_used)
    nvit = int((rec.decoder == DECODER_VITERBI).sum())
    log(f"phase 11 classic Viterbi (b): threshold block, viterbi_backend="
        f"\"jnp\": {nvit} Viterbi lanes; launches {launches}; backend {bb} "
        f"({time.perf_counter() - t0:.1f} s)")
    for field in ("data", "good", "decoder", "start_symbol"):
        require(np.array_equal(getattr(rec, field), getattr(rec_thr, field)),
                f"classic Viterbi threshold block: differs from phase 5 in "
                f"{field}")
    nk10 = launches["viterbi_acs"]
    require(launches["viterbi_a"] == 0 and launches["viterbi_b"] == 0,
            "classic Viterbi threshold block: K5/K6 launched")
    require(nk10 > 0 and nk10 % FRAMEBITS == 0
            and nk10 // FRAMEBITS <= max(nvit, 1),
            f"classic Viterbi threshold block: K10 launched {nk10} times "
            f"for {nvit} lanes")
    require(bb.get("viterbi") == "cuda" and bb.get("viterbi_path") == "classic",
            "classic Viterbi threshold block: K10 did not run")
    tails = {"fused": [], "jnp": []}
    for name in ("fused", "jnp", "jnp", "fused"):
        cfg = classic if name == "jnp" else fused
        tails[name].append(stage_ms(iq, nframes, cfg)["host_tail"])
    log(f"  frames == phase 5's on all {NCHAN} channels, {nk10 // FRAMEBITS} "
        f"frame chunk(s); host tail (Viterbi) ms in turns, same IQ: fused "
        f"{tails['fused']}, classic {tails['jnp']}")
    viterbi_lanes_check(iq, nframes, classic, rec, "classic Viterbi threshold "
                        "block")
    profile_block(iq, nframes, classic, "threshold, classic Viterbi")
    return launches


def classic_vdecode(dev) -> dict:
    """Phase 11(c): vdecode_stream at K=24 on a noisy 3-frame stream: the
    jnp (K10) and fused (K5/K6) backends give the same bits and symbol
    errors, and the bits are the data at lag delay + K - 2.  Returns the
    jnp run's launches."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import DEFAULT_CODE as code
    from isee3_decoder_tpu_torch.config import FRAMEBITS
    from isee3_decoder_tpu_torch.models.legacy import vdecode_stream
    from isee3_decoder_tpu_torch.ops.encode import encode_bits

    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    nbits, delay = 3 * FRAMEBITS, 200
    data = torch.as_tensor(rng.integers(0, 2, nbits), device=dev)
    syms, _ = encode_bits(data, 0, code)
    noise = torch.as_tensor(rng.normal(0.0, 45.0, syms.shape),
                            dtype=torch.float32, device=dev)
    soft = torch.clamp(torch.round((syms.float() * 2 - 1) * 100 + noise) + 128,
                       0, 255).to(torch.uint8)
    out, launches = {}, {}
    for backend in ("jnp", "fused"):
        _kernels.reset_launches()
        t1 = time.perf_counter()
        out[backend] = vdecode_stream(soft, delay, code, backend, device=dev)
        dt = time.perf_counter() - t1
        launches[backend] = dict(_kernels.LAUNCHES)
        log(f"  vdecode {backend}: {dt * 1e3:.1f} ms, symbol errors "
            f"{out[backend].symbol_errors.tolist()}, launches "
            f"{ {k: v for k, v in launches[backend].items() if v} }")
    a, b = out["jnp"], out["fused"]
    lag = code.k - 2
    require(launches["jnp"]["viterbi_acs"] == nbits, "vdecode jnp: K10 "
            "launches")
    require(np.array_equal(a.bits, b.bits)
            and np.array_equal(a.symbol_errors, b.symbol_errors),
            "vdecode: the jnp and fused backends differ")
    require(np.array_equal(a.bits[0, lag:],
                           data[: a.bits.shape[1] - lag].cpu().numpy()),
            "vdecode: bits differ from the data at lag delay + K - 2")
    require(0 < int(a.symbol_errors[0]) < 200, "vdecode: symbol errors "
            f"{a.symbol_errors.tolist()} (a few expected)")
    log(f"phase 11 classic Viterbi (c): vdecode_stream K=24, {nbits} bits, "
        f"delay {delay}: jnp == fused, bits == data at lag {delay + lag} "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches["jnp"]


def manchester(symbols: np.ndarray, symbolsamples: float) -> np.ndarray:
    """±1 Manchester waveform of 0/1 symbols (icesync.c:90-98: symbol 1 is
    -1 then +1)."""
    nsym = len(symbols)
    pos = np.arange(int(np.ceil(nsym * symbolsamples))) / symbolsamples
    idx = np.minimum(pos.astype(np.int64), nsym - 1)
    level = np.where(symbols[idx] > 0, 1.0, -1.0)
    return np.where(pos - idx >= 0.5, level, -level)


def classic_icesync(dev) -> dict:
    """Phase 11(d): icesync_frames on Manchester baseband of 3 frames at
    16,384 sps (tests/test_cli_and_legacy.py's synthetic case): a sent
    frame matched with fewer than 50 symbol errors.  Returns the run's
    launches."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import DEFAULT_CODE as code
    from isee3_decoder_tpu_torch.config import FRAMEBITS, SYNC_STATE
    from isee3_decoder_tpu_torch.models.legacy import icesync_frames
    from isee3_decoder_tpu_torch.ops.encode import bytes_to_bits, encode_bits
    from isee3_decoder_tpu_torch.utils.devicesignal import random_frames

    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    frames = random_frames(rng, 3)
    fbits = bytes_to_bits(torch.as_tensor(frames.reshape(-1)))
    fsyms = encode_bits(fbits, SYNC_STATE, code)[0].numpy()
    samprate = 16384.0
    wave = manchester(fsyms, samprate / 1024.0)
    samples = (60.0 * wave + rng.normal(0, 8, len(wave))).astype(np.int64)
    _kernels.reset_launches()
    got = icesync_frames(samples, samprate, 1024.0, max_frames=2, code=code,
                         device=dev)
    launches = dict(_kernels.LAUNCHES)
    matched = [fr for fr in got
               if any(np.array_equal(fr.data, f) for f in frames)]
    log(f"phase 11 classic Viterbi (d): icesync {len(got)} frames, matched "
        f"{len(matched)}, symbol errors {[fr.symbol_errors for fr in got]}, "
        f"metric ranges {[(fr.min_metric, fr.max_metric) for fr in got]}; "
        f"K10 launches {launches['viterbi_acs']} "
        f"({time.perf_counter() - t0:.1f} s)")
    require(matched and all(fr.symbol_errors < 50 for fr in matched),
            "icesync: no transmitted frame matched")
    require(launches["viterbi_acs"] == FRAMEBITS * len(got),
            "icesync: K10 launches")
    return launches


def classic_vtest() -> None:
    """Phase 11(e): the vtest CLI in a subprocess on the card: FER 0/8 at
    5 dB on the classic decoder, then the time trial of both backends."""
    t0 = time.perf_counter()
    args = "-l 1024 -n 8 -b 8"

    def run(cmd: list) -> str:
        r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                           timeout=300)
        require(r.returncode == 0, f"vtest failed: {r.stderr[-2000:]}")
        return r.stdout

    # the BER run and the two time trials in one process: one start-up
    ber = f"{args} -e 5 --backend jnp"
    trials = [f"{args} --backend {b}" for b in ("jnp", "fused")]
    out = run([sys.executable, "-c", "import sys; from "
               f"{PKG}.cli import vtest; [vtest.main(a.split()) for a in "
               "sys.argv[1:]]", ber, *trials])
    bers = [ln for ln in out.splitlines() if ln.startswith("BER ")]
    speeds = [ln for ln in out.splitlines() if ln.startswith("decoder speed")]
    require(len(bers) == 1 and len(speeds) == 2, f"vtest: {out[-500:]}")
    log(f"  vtest {ber}: {bers[0]}")
    require("FER 0/8 " in bers[0], "vtest -e 5: frame errors")
    for t, sp in zip(trials, speeds):
        log(f"  vtest {t}: {sp}")
    log(f"phase 11 classic Viterbi (e): vtest CLI ok "
        f"({time.perf_counter() - t0:.1f} s)")

def flat_records(records) -> list:
    """(start symbol, good, decoder, bytes) of every lane of a list of
    FrameRecords, in stream order."""
    return [(int(r.start_symbol[b]), bool(r.good[b]), int(r.decoder[b]),
             bytes(r.data[b]))
            for r in records for b in range(r.data.shape[0])]


def stream_chunks(iq, cuts, cfg, carry=None, trim: bool = True,
                  stop: int | None = None):
    """receive_stream over iq[:, lo:hi] for consecutive cuts (int16
    values), a synchronize after each chunk: (records, carry, wall seconds
    of each chunk).  ``stop`` ends after that many chunks."""
    import torch

    from isee3_decoder_tpu_torch.models.pipeline import receive_stream

    recs, walls = [], []
    pairs = list(zip(cuts[:-1], cuts[1:]))[:stop]
    for lo, hi in pairs:
        t0 = time.perf_counter()
        r, carry = receive_stream(iq[:, lo:hi], cfg, carry, trim=trim)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        recs.extend(r)
    return recs, carry, walls


def stream_regime(dev, iq, cfg, label: str, seconds: float) -> tuple:
    """One recording through receive_stream: one call on the whole
    recording, then ragged chunks (1 s, 3,000 samples — less than one pm
    block —, 2 s, the rest) with trim=False, whose frames must equal the
    one call's and whose soft symbols must equal demod_to_symbols' bit for
    bit; then the chunks again, stopped after the second, the carry saved
    with save_pytree, restored onto a fresh template on the card and
    resumed: the same frames again.  Returns (the chunked run's flat
    records, its launches, its backends)."""
    import tempfile

    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.models.pipeline import (
        chain_carry_template,
        demod_to_symbols,
        receive_stream,
    )
    from isee3_decoder_tpu_torch.utils import checkpoint

    B = iq.shape[0]
    sr = int(cfg.pm.samprate)
    cuts = [0, 2 * sr, 2 * (sr + 3000), 2 * (3 * sr + 3000), iq.shape[1]]
    t0 = time.perf_counter()
    one, _ = receive_stream(iq, cfg)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    want = flat_records(one)
    soft1 = demod_to_symbols(iq, cfg)[0]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    recs, carry, walls = stream_chunks(iq, cuts, cfg, trim=False)
    launches, backends = dict(_kernels.LAUNCHES), dict(_kernels.backend_used)
    got = flat_records(recs)
    require(got == want, f"stream {label}: chunked frames differ from one "
            f"call ({len(got)} against {len(want)} lanes)")
    require(carry.soft_base == 0, f"stream {label}: soft trimmed")
    n = min(carry.soft.shape[1], soft1.shape[1])
    require(n >= soft1.shape[1] - cfg.sym.nsymbols
            and torch.equal(carry.soft[:, :n], soft1[:, :n]),
            f"stream {label}: chunked soft symbols differ from the one-shot "
            f"soft symbols")
    # stop after the second chunk, checkpoint, restore on the card, resume
    early, half, _ = stream_chunks(iq, cuts, cfg, stop=2)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "carry.npz")
        t1 = time.perf_counter()
        checkpoint.save_pytree(path, half)
        template = chain_carry_template(checkpoint.load_manifest(path), cfg,
                                        device=dev)
        restored = checkpoint.restore_pytree(path, template)
        t_ckpt = time.perf_counter() - t1
        nbytes = os.path.getsize(path)
    require(restored.bb.is_cuda and restored.soft.is_cuda
            and restored.first.is_cuda, f"stream {label}: restored carry not "
            f"on the card")
    late, _, _ = stream_chunks(iq, cuts[2:], cfg, carry=restored)
    require(flat_records(early) + flat_records(late) == want,
            f"stream {label}: the resumed stream's frames differ")
    good = sum(1 for f in got if f[1])
    mix: dict = {}
    for f in got:
        mix[f[2]] = mix.get(f[2], 0) + 1
    wall = sum(walls)
    log(f"  stream {label}: {B} ch x {seconds:.2f} s, {len(got)} frames "
        f"({good} good), decoders {mix}; ms per chunk "
        f"{[round(w * 1e3, 3) for w in walls]} (one call "
        f"{t_one * 1e3:.3f}); real time {B * seconds / wall:.1f} channels; "
        f"chunked == one call, soft symbols bit-exact; checkpoint "
        f"{nbytes} bytes, save + restore {t_ckpt * 1e3:.1f} ms, resumed == "
        f"one call; launches {launches}")
    return got, launches, backends


def phase_stream(dev, nsamples: int, pm, sym, rec_thr, nframes: int) -> dict:
    """Phase 13: the streaming chain (models/pipeline.receive_stream) at
    the bench configuration on the clean and mid recordings of phases 3
    and 4 (128 channels, 8.39 s; mid with the bench's DecodeConfig(),
    QLEC on), and a threshold recording: the 16 channels of phase 5's
    block with the most Viterbi lanes, decoded with the reference's -p
    (``DecodeConfig(persistent=True)``: the Viterbi fallback on every
    Fano failure, not only after a good frame, which two frames a channel
    seldom give), so that K5/K6 run inside decode_stream.  Returns the
    launches of the chunked runs."""
    import torch

    from isee3_decoder_tpu_torch.models.decode import (
        DECODER_QLEC,
        DECODER_VITERBI,
        DecodeConfig,
    )
    from isee3_decoder_tpu_torch.models.pipeline import PipelineConfig

    t0 = time.perf_counter()
    seconds = nsamples / SAMPRATE
    cfg = PipelineConfig(pm=pm, sym=sym, decode=DecodeConfig())
    total: dict = {}
    for label, noise, seed in (("clean", NOISE_CLEAN, 0), ("mid", NOISE_MID,
                                                            99)):
        frames, iq, _ = bench_block(dev, NCHAN, nsamples, noise, seed=seed)
        got, launches, backends = stream_regime(dev, iq, cfg, label, seconds)
        sent = {f.tobytes() for f in frames}
        require(all(f[3] in sent for f in got if f[1]),
                f"stream {label}: a good frame was not sent")
        require(sum(1 for f in got if f[1]) >= NCHAN * (nframes - 1),
                f"stream {label}: too few good frames")
        for k in ("pm_locked", "spin_down", "prefix_sum"):
            require(launches[k] > 0, f"stream {label}: kernel {k} never "
                    f"launched")
        require(backends.get("pm") == "cuda" and backends.get("csum") == "cuda",
                f"stream {label}: pm / csum stage not on CUDA")
        if label == "mid":
            nqlec = sum(1 for f in got if f[2] == DECODER_QLEC)
            require(nqlec > 0, "stream mid: no QLEC label")
            require(launches["fano_walk"] > 0, "stream mid: K4 never launched")
            log(f"  stream mid: {nqlec} QLEC labels on the card")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del iq
    # threshold: phase 5's block, the 16 channels with the most Viterbi
    # lanes there
    frames, iq, _ = bench_block(dev, NCHAN, nsamples, NOISE_THRESHOLD, seed=11)
    per_chan = (rec_thr.decoder == DECODER_VITERBI).reshape(NCHAN, -1).sum(1)
    chans = np.argsort(-per_chan, kind="stable")[:16]
    iq16 = iq[torch.as_tensor(np.sort(chans), device=dev)].contiguous()
    del iq
    persistent = PipelineConfig(pm=pm, sym=sym,
                                decode=DecodeConfig(persistent=True))
    got, launches, backends = stream_regime(dev, iq16, persistent,
                                            "threshold (-p)", seconds)
    sent = {f.tobytes() for f in frames}
    nvit = sum(1 for f in got if f[2] == DECODER_VITERBI)
    require(nvit > 0 and launches["viterbi_a"] > 0
            and launches["viterbi_b"] > 0,
            f"stream threshold: K5/K6 never launched ({nvit} Viterbi lanes)")
    require(backends.get("viterbi") == "cuda", "stream threshold: Viterbi "
            "not on CUDA")
    nbad_sent = sum(1 for f in got if f[1] and f[3] not in sent)
    require(nbad_sent == 0, f"stream threshold: {nbad_sent} good frames "
            f"were not sent")
    log(f"  stream threshold: {nvit} Viterbi lanes; every good frame sent")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    del iq16
    torch.cuda.empty_cache()
    log(f"phase 13 stream: clean, mid, threshold chunked == one call, "
        f"checkpointed resume == one call; launches {total} "
        f"({time.perf_counter() - t0:.1f} s)")
    return total


def parse_hex_frames(text: str) -> list:
    """(good, 128 bytes) of each frame the decode tool printed."""
    from isee3_decoder_tpu_torch.config import FRAMEBITS

    out, cur, good = [], [], False
    for line in text.splitlines():
        if line.startswith("Frame "):
            cur, good = [], "(bad)" not in line
        elif line.strip() and all(len(t) == 2 for t in line.split()):
            cur.extend(int(t, 16) for t in line.split())
            if len(cur) == FRAMEBITS // 8:
                out.append((good, bytes(cur)))
                cur = []
    return out


def phase_cli(dev) -> dict:
    """Phase 14: the reference's stage tools as port processes on the
    card: a one-channel 10 s recording made on the card written to a file,
    ``pmdemod -W 100 | symdemod -c 1024. | decode`` over pipes (the
    baseband teed to a file), then ``bitsync -c 1024`` on that baseband;
    a second recording sent at the measured clock, 1024.545 Hz, through
    ``pmdemod -W 100 | symdemod -t -c 1024. | decode`` (clock tracking);
    and ``fanotest -l 1024 -n 256 -e 3`` (kernel K4).  Every good frame
    decode prints must be a sent one, and decode and bitsync must each
    match one at least; bitsync's frames must equal bitsync_frames' on the
    same baseband through the kernels' plain versions.  Each tool runs
    under a shim (TOOL_SHIM) that writes its kernel launch counts,
    backends and tracking counts on exit; returns the launches' sum."""
    import shlex
    import tempfile

    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.models.legacy import bitsync_frames

    from isee3_decoder_tpu_torch.utils.devicesignal import (
        random_frames,
        synthesize_iq_device,
        to_raw_int16,
    )

    t0 = time.perf_counter()
    frames = random_frames(np.random.default_rng(31), 5)
    nsamples = int(10.0 * SAMPRATE)

    def recording(symrate: float, seed: int) -> np.ndarray:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        iq = synthesize_iq_device(
            torch.as_tensor(frames[None], device=dev),
            torch.tensor([20_000.0], device=dev), gen, nsamples,
            samprate=SAMPRATE, symrate=symrate, noise_std=NOISE_CLEAN)
        return to_raw_int16(iq)[0].cpu().numpy()

    sent = {f.tobytes() for f in frames}
    total: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        rec, bb = os.path.join(tmp, "input.iq"), os.path.join(tmp, "bb.raw")
        rec_t = os.path.join(tmp, "input_1024.545.iq")
        recording(SYMRATE, 31).tofile(rec)
        recording(TRACK_SYMRATES[1], 32).tofile(rec_t)
        outs = {t: os.path.join(tmp, f"{t}.json")
                for t in ("pmdemod", "symdemod", "decode", "bitsync",
                          "pmdemod_t", "symdemod_t", "decode_t", "fanotest")}

        def tool(name: str, args: str) -> str:
            shim = shlex.quote(TOOL_SHIM.format(pkg=PKG,
                                                tool=name.split("_")[0]))
            return f"{sys.executable} -c {shim} {outs[name]} {args}"

        pipe = (f"set -o pipefail; {tool('pmdemod', f'-q -W 100 {rec}')} "
                f"| tee {bb} | {tool('symdemod', '-q -c 1024.')} "
                f"| {tool('decode', '')}")
        t1 = time.perf_counter()
        r = subprocess.run(["bash", "-c", pipe], cwd=HERE, capture_output=True,
                           text=True, timeout=300)
        t_pipe = time.perf_counter() - t1
        require(r.returncode == 0, f"CLI pipeline failed: {r.stderr[-2000:]}")
        decoded = parse_hex_frames(r.stdout)
        good = [d for g, d in decoded if g]
        require(good and all(d in sent for d in good),
                f"CLI pipeline: good frames {len(good)}, not all sent: "
                f"{r.stdout[-1500:]}")
        t1 = time.perf_counter()
        rb = subprocess.run(["bash", "-c", tool("bitsync", f"-c 1024 {bb}")],
                            cwd=HERE, capture_output=True, text=True,
                            timeout=300)
        t_bitsync = time.perf_counter() - t1
        require(rb.returncode == 0, f"bitsync failed: {rb.stderr[-2000:]}")
        bframes = [d for _, d in parse_hex_frames(rb.stdout)]
        nbmatch = sum(1 for d in bframes if d in sent)
        require(nbmatch >= 1, f"bitsync: no sent frame among {len(bframes)}")
        t1 = time.perf_counter()
        with _kernels.plain_reference():
            plain = bitsync_frames(np.fromfile(bb, "<i2"), SAMPRATE, 1024.0,
                                   device=dev)
        t_plain = time.perf_counter() - t1
        pframes = [bytes(np.asarray(f, np.uint8)) for f in plain.frames]
        require(bframes == pframes, f"bitsync: frames differ from the plain "
                f"versions' ({len(bframes)} against {len(pframes)})")
        # clock tracking: a recording sent at 1024.545 Hz, demodulated
        # from 1024.0 with -t
        pipe_t = (f"set -o pipefail; {tool('pmdemod_t', f'-q -W 100 {rec_t}')}"
                  f" | {tool('symdemod_t', '-t -c 1024.')} "
                  f"| {tool('decode_t', '')}")
        t1 = time.perf_counter()
        rt = subprocess.run(["bash", "-c", pipe_t], cwd=HERE,
                            capture_output=True, text=True, timeout=300)
        t_track = time.perf_counter() - t1
        require(rt.returncode == 0, f"tracked pipeline failed: "
                f"{rt.stderr[-2000:]}")
        decoded_t = parse_hex_frames(rt.stdout)
        good_t = [d for g, d in decoded_t if g]
        require(all(d in sent for d in good_t), f"tracked pipeline: a good "
                f"frame was not sent: {rt.stdout[-1500:]}")
        clocks_t = [ln.split("clock ")[1].split(" Hz")[0]
                    for ln in rt.stderr.splitlines() if "samp/sym" in ln]
        t1 = time.perf_counter()
        rf = subprocess.run(["bash", "-c", tool(
            "fanotest", "-l 1024 -n 256 -e 3")], cwd=HERE,
            capture_output=True, text=True, timeout=300)
        t_fano = time.perf_counter() - t1
        require(rf.returncode == 0, f"fanotest failed: {rf.stderr[-2000:]}")
        fano_line = rf.stdout.strip().splitlines()[-1]
        require(fano_line.startswith("trials 256 "),
                f"fanotest: {rf.stdout[-1000:]}")
        per_tool, track = {}, {}
        for name, path in outs.items():
            with open(path) as f:
                rec_l = json.load(f)
            per_tool[name] = {k: v for k, v in rec_l["launches"].items() if v}
            for k, v in rec_l["launches"].items():
                total[k] = total.get(k, 0) + v
            if not name.startswith("decode"):
                require(all(v == "cuda" for k, v in rec_l["backend"].items()
                            if k in ("pm", "csum", "fano", "viterbi")),
                        f"{name}: a stage off the card: {rec_l['backend']}")
            track[name] = rec_l["track"]
    for name, k in (("pmdemod", "pm_locked"), ("pmdemod", "spin_down"),
                    ("symdemod", "prefix_sum"), ("bitsync", "prefix_sum"),
                    ("bitsync", "viterbi_acs"), ("symdemod_t", "prefix_sum"),
                    ("fanotest", "fano_walk")):
        require(per_tool[name].get(k, 0) > 0, f"{name}: kernel {k} never "
                f"launched")
    reads = track["symdemod_t"]["host_reads"]
    require(reads and per_tool["symdemod_t"]["prefix_sum"] == len(reads),
            "symdemod -t: not one prefix sum (K3) a window")
    log(f"phase 14 CLI: pmdemod -W 100 | symdemod -c 1024. | decode on a 10 s "
        f"recording: {len(decoded)} frames, {len(good)} good, all sent "
        f"({t_pipe:.1f} s); bitsync -c 1024: {len(bframes)} frames, "
        f"{nbmatch} sent, == plain versions ({t_bitsync:.1f} s, plain "
        f"{t_plain:.1f} s)")
    log(f"  symdemod -t -c 1024. on a 10 s recording sent at "
        f"{TRACK_SYMRATES[1]} Hz: {len(decoded_t)} frames, {len(good_t)} "
        f"good, all sent ({t_track:.1f} s); {len(reads)} windows, probes a "
        f"window {track['symdemod_t']['iterations']}, host reads a window "
        f"{reads}; clock estimates {clocks_t} Hz")
    log(f"  fanotest -l 1024 -n 256 -e 3: {fano_line} ({t_fano:.1f} s, K4 "
        f"launches {per_tool['fanotest'].get('fano_walk', 0)})")
    log(f"  launches per tool {per_tool} ({time.perf_counter() - t0:.1f} s)")
    return total


def phase_tracking(dev, nsamples: int, pm, sym) -> dict:
    """Phase 15: clock tracking at 128 channels.  Half the channels of a
    250 ksps block are sent at 1024.0 sym/s, half at 1024.545 (the
    measured spacecraft clock); pm_demod_scan (K1, K2) makes the baseband,
    which is demodulated at ``sym`` (1024.0) twice: untracked
    (symdemod_scan) and tracked (symdemod_tracked_batched, its prefix sum
    from K3), and both are decoded (find_sync, decode_frames_batch: K4,
    K5/K6 for the Viterbi fallback).  Every good frame must be a sent one;
    the tracked soft symbols must equal the same call's under
    plain_reference() bit for bit, and 4 channels tracked alone their rows
    of the 128-channel call.  Returns the counted run's launches."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import FRAMESYMBOLS, SYNCBITS
    from isee3_decoder_tpu_torch.models import symdemod as sd
    from isee3_decoder_tpu_torch.models.decode import (
        DecodeConfig,
        decode_frames_batch,
    )
    from isee3_decoder_tpu_torch.models.symdemod_tracked import (
        build_track_tables,
        device_tables,
        symdemod_tracked_batched,
    )
    from isee3_decoder_tpu_torch.ops.carrier import init_carry, pm_demod_scan
    from isee3_decoder_tpu_torch.ops.syncword import find_sync
    from isee3_decoder_tpu_torch.utils.devicesignal import (
        random_frames,
        synthesize_iq_device,
        to_raw_int16,
    )

    t0 = time.perf_counter()
    half = NCHAN // 2
    frames = random_frames(np.random.default_rng(15), NFRAMES_TX)
    raws = []
    for h, symrate in enumerate(TRACK_SYMRATES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(150 + h)
        carriers = torch.as_tensor(
            20_000.0 + 137.0 * (h * half + np.arange(half)),
            dtype=torch.float32, device=dev)
        iq = synthesize_iq_device(
            torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
                frames, (half, *frames.shape))), device=dev),
            carriers, gen, nsamples, samprate=SAMPRATE, symrate=symrate,
            noise_std=NOISE_CLEAN)
        raws.append(to_raw_int16(iq))
        del iq
    raw = torch.cat(raws)
    del raws
    n = pm.fftsize
    T = raw.shape[1] // (2 * n)
    nwin = (T * n - sd.initial_firstsample(sym)) // sd.window_samples(sym) - 1

    def decode(soft):
        soft = torch.as_tensor(soft, device=dev)
        ss, _ = find_sync(soft[:, : FRAMESYMBOLS + SYNCBITS], FRAMESYMBOLS)
        nf = int((soft.shape[1] - int(ss.max()) - SYNCBITS) // FRAMESYMBOLS)
        rec = decode_frames_batch(soft, ss.cpu().numpy(), nf, DecodeConfig(),
                                  device=dev)
        return rec, nf

    def halves(rec, nf) -> list:
        ok = matched_mask(rec, frames, NCHAN, nf)
        out = []
        for h in range(2):
            lanes = slice(h * half * nf, (h + 1) * half * nf)
            out.append((int(rec.good[lanes].sum()), int(ok[lanes].sum()),
                        half * nf))
        return out

    _kernels.reset_launches()
    sd.reset_track_stats()
    _, pm_out = pm_demod_scan(init_carry(NCHAN, pm, device=dev),
                              raw[:, : T * 2 * n].reshape(NCHAN, T, 2 * n), pm)
    bb = pm_out.baseband.transpose(0, 1).reshape(NCHAN, T * n).contiguous()
    del pm_out, raw
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, untracked = sd.symdemod_scan(bb, sym, nwin)
    soft_u = untracked.soft.transpose(0, 1).reshape(NCHAN, -1)
    torch.cuda.synchronize()
    t_untracked = time.perf_counter() - t1
    t1 = time.perf_counter()
    soft_t, infos = symdemod_tracked_batched(bb, sym, nwin)
    t_tracked = time.perf_counter() - t1
    iters = list(sd.track_stats["iterations"])
    reads = list(sd.track_stats["host_reads"])
    rec_u, nf_u = decode(soft_u)
    rec_t, nf_t = decode(soft_t)
    launches = dict(_kernels.LAUNCHES)
    backends = dict(_kernels.backend_used)
    for k in ("pm_locked", "spin_down", "prefix_sum", "fano_walk"):
        require(launches[k] > 0, f"tracking: kernel {k} never launched")
    require(launches["prefix_sum"] == 2, "tracking: not one K3 launch a "
            f"demodulation ({launches['prefix_sum']})")
    require(backends.get("csum") == "cuda", "tracking: K3 not on the card")
    stats_u, stats_t = halves(rec_u, nf_u), halves(rec_t, nf_t)
    for label, stats in (("untracked", stats_u), ("tracked", stats_t)):
        for h, (good, matched, _) in enumerate(stats):
            require(good == matched, f"tracking, {label}, channels sent at "
                    f"{TRACK_SYMRATES[h]}: a good frame was not sent "
                    f"({good} good, {matched} sent)")

    # the tracked soft symbols through the kernels' plain versions
    with _kernels.plain_reference():
        soft_p, infos_p = symdemod_tracked_batched(bb, sym, nwin)
    require(np.array_equal(soft_t, soft_p), "tracking: soft symbols differ "
            "from plain_reference()'s")
    for wt, wp in zip(infos, infos_p):
        for key in wt:
            require(np.array_equal(wt[key], wp[key]), f"tracking: info "
                    f"{key} differs from plain_reference()'s")
    # batching invariance: 4 channels alone == their rows of the batch
    pick = [0, 1, half, half + 1]
    soft_4, infos_4 = symdemod_tracked_batched(bb[pick], sym, nwin)
    require(np.array_equal(soft_4, soft_t[pick, : soft_4.shape[1]])
            and (soft_t[pick, soft_4.shape[1]:] == 128).all(),
            "tracking: 4 channels alone differ from their rows of the batch")
    for w4, wt in zip(infos_4, infos):
        for key in ("symbolsamples", "firstsample", "energy", "symphase"):
            require(np.array_equal(w4[key], wt[key][pick]), f"tracking: "
                    f"{key} of 4 channels alone differs from the batch's")

    # the tables' upload alone, and the untracked demod's time beside it
    t = build_track_tables(sym, 512)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tables = device_tables(t, dev)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t1
    est = [infos[-1]["symrate"][h * half : (h + 1) * half] for h in range(2)]
    del bb
    torch.cuda.empty_cache()
    log(f"phase 15 tracking: {NCHAN} ch x {T * n / SAMPRATE:.2f} s, "
        f"{half} sent at {TRACK_SYMRATES[0]} and {half} at "
        f"{TRACK_SYMRATES[1]} sym/s, demodulated at {sym.symrate}: "
        f"{nwin} windows; frames (good, sent, possible) untracked "
        f"{stats_u[0]} / {stats_u[1]}, tracked {stats_t[0]} / {stats_t[1]} "
        f"(first half / second half); every good frame sent; tracked == "
        f"plain_reference() bit for bit, 4 channels alone == their rows")
    log(f"  last window's clock estimates, Hz: first half min "
        f"{est[0].min():.6f} mean {est[0].mean():.6f} max {est[0].max():.6f};"
        f" second half min {est[1].min():.6f} mean {est[1].mean():.6f} max "
        f"{est[1].max():.6f}")
    log(f"  tracked {t_tracked * 1e3 / nwin:.3f} ms a window "
        f"({t_tracked * 1e3:.3f} ms for {nwin}, the tables' upload and K3 "
        f"included), untracked {t_untracked * 1e3 / nwin:.3f} ms a window; "
        f"hill-climb iterations a window {iters}; host reads a window "
        f"{reads}; tables {tables.nbytes} bytes, upload "
        f"{t_upload * 1e3:.3f} ms; launches {launches} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"  card: {card_line()}")
    return launches


# ---- phases 16-18 (wide Fano walk, native golden library, parallel/)

#: the wide codes phase 16 walks, and its frames: 1024 bits from state
#: 0x2A, the tail the low k-1 bits of WIDE_TAIL, BPSK at amplitude 100
#: plus Gaussian noise of WIDE_SIGMA, cut at WIDE_CYCLES cycles a bit
#: (some lanes time out), the metric table of DecodeConfig()
WIDE_CODES = ("MCQLI32", "J50", "J60")
WIDE_TAIL = 0x155AA55AA55AA
WIDE_START = 0x2A
WIDE_SIGMA = 70.0
WIDE_CYCLES = 4
WIDE_LANES = 64
WIDE_TIMED_LANES = 256
WIDE_TIMED_CYCLES = 12


def wide_frames(dev, code, lanes: int, seed: int):
    """``lanes`` random 1024-bit frames ending in the code's tail, encoded
    by the native golden encoder (native.conv_encode) and sent through
    the noisy channel → (bits (lanes, 1024) uint8, soft symbols on dev,
    tail)."""
    import torch

    from isee3_decoder_tpu_torch.config import FRAMEBITS
    from isee3_decoder_tpu_torch.utils import native

    rng = np.random.default_rng(seed)
    tail = WIDE_TAIL & ((1 << (code.k - 1)) - 1)
    bits = rng.integers(0, 2, (lanes, FRAMEBITS), dtype=np.uint8)
    for j in range(code.k - 1):
        bits[:, FRAMEBITS - 1 - j] = (tail >> j) & 1
    syms = np.stack([native.conv_encode(row, code, WIDE_START)[0]
                     for row in np.packbits(bits, axis=1)])
    noisy = (syms * 2.0 - 1.0) * 100.0 + rng.normal(0.0, WIDE_SIGMA, syms.shape)
    soft = np.clip(np.round(noisy) + 128, 0, 255).astype(np.uint8)
    return bits, torch.as_tensor(soft, device=dev), tail


def phase_wide_fano(dev) -> tuple[dict, dict]:
    """Phase 16: K4's wide variant (64-bit state word) for MCQLI32, J50
    and J60 at 1024 nodes.  The main path: ``ops/fano.fano_decode`` on 64
    noisy lanes of each code (launch counts set to 0 just before, read
    just after), its good frames the ones sent (encoded by the native
    golden encoder); then the walk alone against its plain twin (the
    step-by-step int64 walk) on the card, bit for bit on both designs,
    the plain twin timed once; then the kernel timed at 256 lanes and
    WIDE_TIMED_CYCLES cycles a bit.  Returns (the main path's launches,
    the kernels-line record of the wide variant)."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import CODES, FRAMEBITS
    from isee3_decoder_tpu_torch.models.decode import DecodeConfig
    from isee3_decoder_tpu_torch.ops import fano_cuda
    from isee3_decoder_tpu_torch.ops.fano import (
        FanoParams,
        _walk_inputs,
        fano_decode,
    )

    t0 = time.perf_counter()
    dcfg = DecodeConfig()
    mettab = torch.as_tensor(dcfg.mettab(), device=dev)
    inputs = {name: wide_frames(dev, CODES[name], WIDE_LANES, seed=160 + i)
              for i, name in enumerate(WIDE_CODES)}
    params = FanoParams(dcfg.fano_delta, WIDE_CYCLES)
    fano_decode(inputs["J60"][1][:2], mettab, FRAMEBITS, WIDE_START,
                inputs["J60"][2], CODES["J60"], params)  # warm-up
    torch.cuda.synchronize()
    _kernels.reset_launches()
    results = {name: fano_decode(soft, mettab, FRAMEBITS, WIDE_START, tail,
                                 CODES[name], params)
               for name, (_, soft, tail) in inputs.items()}
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    backends = dict(_kernels.backend_used)
    require(launches["fano_walk"] == len(WIDE_CODES),
            f"wide Fano: fano_walk launches {launches['fano_walk']}")
    require(backends.get("fano_walk") == "warp64",
            f"wide Fano: K4 design {backends.get('fano_walk')}")
    rec = {"max_abs_err": 0, "library_ms": None, "codes": {}}
    for name, (bits, soft, tail) in inputs.items():
        code = CODES[name]
        res = results[name]
        good = (res.goodbits == FRAMEBITS).cpu().numpy()
        sent = np.array([np.array_equal(res.bits[i].cpu().numpy(), bits[i])
                         for i in range(WIDE_LANES)])
        require(good.any(), f"wide Fano {name}: no frame decoded")
        require(bool(sent[good].all()), f"wide Fano {name}: a good frame "
                "is not the one sent")
        # the walk alone against its plain twin, both designs
        m4, regs = _walk_inputs(soft, mettab, FRAMEBITS, WIDE_START, tail,
                                code, None)
        args = (m4, regs, code, dcfg.fano_delta, WIDE_CYCLES)
        start, end = _events()
        start.record()
        bits_p, st_p = fano_cuda.fano_walk_wide_plain(*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        for design in ("warp", "thread"):
            bits_k, st_k = fano_cuda.fano_walk_wide(*args, design=design)
            require(torch.equal(bits_k, bits_p),
                    f"K4 wide {name} {design}: bits differ from plain")
            require(torch.equal(st_k, st_p),
                    f"K4 wide {name} {design}: np/gamma/cycles/t differ")
        nfail = int((st_p[:, 0] + 1 != FRAMEBITS).sum())
        steps = int(st_p[:, 2].max())
        require(nfail > 0, f"wide Fano {name}: no lane timed out")
        require(int(st_p[:, 2][st_p[:, 0] + 1 == FRAMEBITS].max()) > FRAMEBITS,
                f"wide Fano {name}: no decoded lane backtracked")
        ms = cuda_ms(lambda: fano_cuda.fano_walk_wide(*args), 5)
        c = dict(ms=ms, plain_ms=plain_ms, max_lane_steps=steps,
                 good=int(good.sum()), timed_out=nfail,
                 **bound(m4.numel() * 4 + regs.numel() * 8 + bits_k.numel()
                         + st_k.numel() * 4,
                         int(st_k[:, 2].sum()) * FANO_OPS_PER_STEP,
                         I32_OPS_PER_S, steps * FANO_STEP_CYCLES))
        # timed at 256 lanes, the tier-1 cap
        _, soft256, _ = wide_frames(dev, code, WIDE_TIMED_LANES, seed=170)
        m4b, regsb = _walk_inputs(soft256, mettab, FRAMEBITS, WIDE_START,
                                  tail, code, None)
        argsb = (m4b, regsb, code, dcfg.fano_delta, WIDE_TIMED_CYCLES)
        bits_b, st_b = fano_cuda.fano_walk_wide(*argsb)
        steps_b = int(st_b[:, 2].max())
        c.update(
            ms_256=cuda_ms(lambda: fano_cuda.fano_walk_wide(*argsb), 5),
            thread_ms_256=cuda_ms(
                lambda: fano_cuda.fano_walk_wide(*argsb, design="thread"), 3),
            max_lane_steps_256=steps_b,
            good_256=int((st_b[:, 0] + 1 == FRAMEBITS).sum()),
            bound_ms_256=bound(
                m4b.numel() * 4 + regsb.numel() * 8 + bits_b.numel()
                + st_b.numel() * 4, int(st_b[:, 2].sum()) * FANO_OPS_PER_STEP,
                I32_OPS_PER_S, steps_b * FANO_STEP_CYCLES)["bound_ms"])
        c["ns_per_step_256"] = c["ms_256"] * 1e6 / steps_b
        rec["codes"][name] = c
        log(f"  K4 wide {name}: {WIDE_LANES} lanes at {WIDE_CYCLES} cycles/bit"
            f" == plain on both designs; good {c['good']}, timed out {nfail}, "
            f"max cycles {steps}; {ms:.4f} ms (plain {plain_ms:.1f}, bound "
            f"{c['bound_ms']:.4f} by {c['bound_by']}); at "
            f"{WIDE_TIMED_LANES} lanes, {WIDE_TIMED_CYCLES} cycles/bit: warp "
            f"{c['ms_256']:.4f} ms ({c['ns_per_step_256']:.1f} ns per "
            f"micro-step, {steps_b} steps), thread {c['thread_ms_256']:.4f}, "
            f"bound {c['bound_ms_256']:.4f}, good {c['good_256']}")
    # the kernels line's numbers: J60's 64-lane case (same inputs for the
    # kernel, the plain twin and the bound)
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "latency_bound_ms",
                "max_lane_steps"):
        rec[key] = rec["codes"]["J60"][key]
    log(f"phase 16 wide Fano: {', '.join(WIDE_CODES)} at {FRAMEBITS} nodes "
        f"through fano_decode, launches {launches['fano_walk']} (design "
        f"{backends.get('fano_walk')}), good frames == sent; K4 wide == plain "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches, rec


def phase_native(dev) -> None:
    """Phase 17: the native golden library, built from native/isee3_io.cpp
    into build/native_io/: the port's encoder == conv_encode at MCQLI24
    and J60, and on a noisy MCQLI-24 frame of 96 bits the classic
    decoder (K10), the fused decoder (K5/K6) and viterbi_decode_frame
    give the same bits."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import CODES, MCQLI24
    from isee3_decoder_tpu_torch.ops import viterbi
    from isee3_decoder_tpu_torch.ops.encode import bytes_to_bits, encode_bits
    from isee3_decoder_tpu_torch.ops.viterbi_fused import decode_frame_fused
    from isee3_decoder_tpu_torch.utils import native

    t0 = time.perf_counter()
    require(native.available(), f"native library: {native.build_error}")
    rng = np.random.default_rng(17)
    for name in ("MCQLI24", "J60"):
        code = CODES[name]
        data = rng.integers(0, 256, 128, dtype=np.uint8)
        state = int(rng.integers(0, 1 << 62)) & ((1 << code.k) - 1)
        syms_n, final_n = native.conv_encode(data, code, state)
        syms_t, final_t = encode_bits(
            bytes_to_bits(torch.as_tensor(data, device=dev)), state, code)
        require(np.array_equal(syms_t.cpu().numpy(), syms_n),
                f"native: encode_bits != conv_encode at {name}")
        require(int(final_t) & ((1 << code.k) - 1) == final_n,
                f"native: final state differs at {name}")
    nbits = 96
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    bits[-(MCQLI24.k - 1):] = 0
    syms, _ = native.conv_encode(np.packbits(bits), MCQLI24, 0)
    noisy = np.clip(np.where(syms > 0, 168.0, 88.0)
                    + rng.normal(0, 28.0, syms.shape), 0, 255).astype(np.uint8)
    t1 = time.perf_counter()
    golden = native.viterbi_decode_frame(noisy, nbits, 0, 0, MCQLI24)
    t_golden = time.perf_counter() - t1
    soft = torch.as_tensor(noisy, device=dev)[None, :]
    _kernels.reset_launches()
    k10 = viterbi.decode_frame(soft, nbits, 0, 0, MCQLI24, device=dev)
    fused = decode_frame_fused(soft, nbits, 0, 0, MCQLI24)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    require(launches["viterbi_acs"] == nbits and launches["viterbi_a"] > 0
            and launches["viterbi_b"] > 0, f"native: launches {launches}")
    require(np.array_equal(k10[0].cpu().numpy(), golden),
            "native: K10 decode_frame != viterbi_decode_frame")
    require(np.array_equal(fused[0].cpu().numpy(), golden),
            "native: K5/K6 decode_frame_fused != viterbi_decode_frame")
    hard = (noisy > 128).astype(np.uint8)
    log(f"phase 17 native golden: {native.library_path().name} built; "
        f"encode_bits == conv_encode at MCQLI24 and J60; a noisy 96-bit "
        f"MCQLI-24 frame ({int((hard != syms).sum())} hard symbol errors): "
        f"K10 == K5/K6 == viterbi_decode_frame ({t_golden:.2f} s on the "
        f"host), == sent {np.array_equal(golden, bits)}; launches K10 "
        f"{launches['viterbi_acs']}, K5 {launches['viterbi_a']}, K6 "
        f"{launches['viterbi_b']} ({time.perf_counter() - t0:.1f} s)")


def timed_call(fn):
    """(fn(), seconds) with the card synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_parallel(dev, nsamples: int, nframes: int, cfg) -> dict:
    """Phase 18: parallel/ on logical shards of one card (a mesh whose
    devices repeat): the bench block's clean regime through
    receive_block_sharded over a (4, 1) mesh == receive_block_device's
    buffer byte for byte, on the default and the fused-scan pm backend,
    with its time beside the unsharded block's and each shard's alone;
    decode_frame_sharded at MCQLI-24, 1024 bits,
    B = 2 on (1, 2) and (1, 4) meshes == ops/viterbi.decode_frame; the
    timeshard tests' narrowband recording (complex IQ: the plain pm path,
    then K3) through demod_time_sharded + stitch_shards decodes the
    frames sent.  Returns the launches of the three paths (each counted
    from 0)."""
    import dataclasses

    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import FRAMESYMBOLS, MCQLI24, SYNC_STATE
    from isee3_decoder_tpu_torch.models.decode import (
        DecodeConfig,
        decode_stream,
    )
    from isee3_decoder_tpu_torch.models.pipeline import (
        PipelineConfig,
        demod_to_symbols,
        receive_block_device,
    )
    from isee3_decoder_tpu_torch.ops import viterbi
    from isee3_decoder_tpu_torch.ops.carrier import PMConfig
    from isee3_decoder_tpu_torch.ops.encode import encode_bits
    from isee3_decoder_tpu_torch.ops.symbols import SymConfig
    from isee3_decoder_tpu_torch.parallel import (
        decode_frame_sharded,
        demod_time_sharded,
        make_mesh,
        receive_block_sharded,
        shard_channels,
        stitch_shards,
    )
    from isee3_decoder_tpu_torch.utils import testsignal

    t0 = time.perf_counter()
    total: dict = {}

    def count(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # (a) the channel-sharded receive chain
    frames, iq, _ = bench_block(dev, NCHAN, nsamples, NOISE_CLEAN, seed=0)
    mesh4 = make_mesh(4, 1, devices=[dev] * 4)
    buf_1, t_1 = timed_call(lambda: receive_block_device(iq, nframes,
                                                         FRAMESYMBOLS, cfg))
    torch.cuda.synchronize()
    _kernels.reset_launches()
    buf_s, t_s = timed_call(lambda: receive_block_sharded(iq, nframes, cfg,
                                                          mesh4))
    la = dict(_kernels.LAUNCHES)
    count(la)
    require(torch.equal(buf_s, buf_1),
            "parallel: sharded receive buffer != unsharded")
    for k in ("pm_locked", "spin_down", "prefix_sum"):
        require(la[k] > 0, f"parallel: receive_block_sharded never launched {k}")
    shard_s = [timed_call(lambda b=b: receive_block_device(
        b, nframes, FRAMESYMBOLS, cfg))[1] for b in shard_channels(iq, mesh4)]
    _, t_1b = timed_call(lambda: receive_block_device(iq, nframes,
                                                      FRAMESYMBOLS, cfg))
    _, t_sb = timed_call(lambda: receive_block_sharded(iq, nframes, cfg,
                                                       mesh4))
    log(f"  parallel (a): receive_block_sharded over (4, 1) of cuda:0, "
        f"{NCHAN} ch x {nframes} frames: buffer == unsharded "
        f"({buf_s.numel()} bytes); sharded {t_s * 1e3:.1f} / "
        f"{t_sb * 1e3:.1f} ms against unsharded {t_1 * 1e3:.1f} / "
        f"{t_1b * 1e3:.1f} ms; per shard of {NCHAN // 4} ch alone "
        f"{'/'.join(f'{t * 1e3:.1f}' for t in shard_s)} ms; launches {la}")
    # the same on the fused scan, one host read a shard's pm stage
    fcfg = dataclasses.replace(cfg, pm_backend="fused_scan")
    fbuf_1 = receive_block_device(iq, nframes, FRAMESYMBOLS, fcfg)
    fbuf_s = receive_block_sharded(iq, nframes, fcfg, mesh4)
    require(torch.equal(fbuf_s, fbuf_1),
            "parallel: sharded fused-scan buffer != unsharded")
    tf_1 = [timed_call(lambda: receive_block_device(
        iq, nframes, FRAMESYMBOLS, fcfg))[1] for _ in range(2)]
    tf_s = [timed_call(lambda: receive_block_sharded(
        iq, nframes, fcfg, mesh4))[1] for _ in range(2)]
    tf_shard = [timed_call(lambda b=b: receive_block_device(
        b, nframes, FRAMESYMBOLS, fcfg))[1] for b in shard_channels(iq, mesh4)]
    log(f"  parallel (a) on pm_backend=\"fused_scan\": buffer == unsharded; "
        f"sharded {_ms(tf_s)} ms against unsharded {_ms(tf_1)} ms; per shard "
        f"alone {_ms(tf_shard)} ms")
    del iq, buf_s, buf_1, fbuf_s, fbuf_1
    torch.cuda.empty_cache()

    # (b) the state-sharded Viterbi at the mission code's full lattice
    rng = np.random.default_rng(18)
    nbits, B = 1024, 2
    bits = torch.as_tensor(rng.integers(0, 2, (B, nbits)), device=dev)
    for j in range(MCQLI24.k - 1):  # the sync state's bits end each frame
        bits[:, nbits - 1 - j] = (SYNC_STATE >> j) & 1
    syms, end = encode_bits(bits, SYNC_STATE, MCQLI24)
    noise = torch.as_tensor(rng.normal(0, 60, syms.shape), device=dev)
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise)
                       + 128, 0, 255).to(torch.uint8)
    end_state = int(end[0]) & MCQLI24.state_mask
    require(bool((end & MCQLI24.state_mask == end_state).all()),
            "parallel: the frames' end states differ")
    _kernels.reset_launches()
    want, t_k10 = timed_call(lambda: viterbi.decode_frame(
        soft, nbits, SYNC_STATE, end_state, MCQLI24, device=dev))
    count(_kernels.LAUNCHES)
    require(torch.equal(want, bits.to(torch.uint8)),
            "parallel: the unsharded decode is not the frames sent")
    steps = {}
    for S in (2, 4):
        mesh = make_mesh(1, S, devices=[dev] * S)
        got, t_sh = timed_call(lambda: decode_frame_sharded(
            soft, mesh, nbits, SYNC_STATE, end_state, MCQLI24))
        require(torch.equal(got, want),
                f"parallel: decode_frame_sharded on (1, {S}) != decode_frame")
        steps[S] = t_sh * 1e3 / nbits
        del got
        torch.cuda.empty_cache()
    log(f"  parallel (b): decode_frame_sharded MCQLI-24, {nbits} bits, B = "
        f"{B} == decode_frame on (1, 2) and (1, 4) of cuda:0; ms a step "
        f"(whole decode incl. chainback / {nbits}): S=2 {steps[2]:.3f}, S=4 "
        f"{steps[4]:.3f}, unsharded K10 path {t_k10 * 1e3 / nbits:.3f}")

    # (c) the time-sharded demod on the timeshard tests' narrowband config
    tcfg = PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=8.0),
        sym=SymConfig(samprate=32768.0, symrate=256.0, window=0.5),
        decode=DecodeConfig())
    trng = np.random.default_rng(1)
    tframes = testsignal.random_frames(trng, 4)
    tiq = testsignal.synthesize_iq(tframes, samprate=32768.0, symrate=256.0,
                                   carrier=4104.0, noise_std=300.0, rng=trng)
    _kernels.reset_launches()
    (soft_sh, plan), t_ts = timed_call(lambda: demod_time_sharded(
        tiq, tcfg, make_mesh(4, 1, devices=[dev] * 4)))
    lc = dict(_kernels.LAUNCHES)
    count(lc)
    stream = stitch_shards(soft_sh, plan, tcfg)
    recs, _ = decode_stream(stream, tcfg.decode, device=dev)
    goods = [bytes(r.data[0]) for r in recs if r.good[0]]
    sent = {bytes(f) for f in tframes}
    soft_seq = demod_to_symbols(torch.as_tensor(tiq, device=dev)[None, :],
                                tcfg)[0]
    recs_seq, _ = decode_stream(soft_seq, tcfg.decode, device=dev)
    seq = [bytes(r.data[0]) for r in recs_seq if r.good[0]]
    require(len(goods) >= 1 and all(g in sent for g in goods),
            "parallel: the stitched stream's good frames are not the ones sent")
    require(goods == seq, "parallel: stitched frames != sequential frames")
    # complex IQ takes the plain pm path, as in the JAX package: K3 only
    require(lc["prefix_sum"] >= plan.nshards,
            f"parallel: demod_time_sharded launches {lc}")
    log(f"  parallel (c): demod_time_sharded over 4 logical shards "
        f"({plan.chunk_windows} windows a shard, halo {plan.halo_windows}), "
        f"{t_ts * 1e3:.1f} ms: {len(goods)} good frames, all sent, == the "
        f"sequential demod's; launches {lc}")
    log(f"phase 18 parallel: sharded buffer, sharded Viterbi and stitched "
        f"frames == unsharded ({time.perf_counter() - t0:.1f} s)")
    return total


def phase_float64(dev, nsamples: int, nframes: int, pm, sym) -> dict:
    """Phase 19: the float64 pm branch (the JAX package's C-matching
    golden mode, plain torch in complex128 by the config's dtype) on the
    clean bench block through receive_block, quicklook and QLEC off so
    every lane walks K4: frames all good, all sent and those of the
    float32 run on the same config; backend_used["pm"] "plain_f64"; K1,
    K2, K8 and K9 launched 0 times, K3 and K4 more.  The float64 baseband
    of four channels against the same on the CPU (<= 1 LSB), the count
    of samples where the float32 and float64 basebands differ, and the
    pm stage's ms in both precisions.  Returns the float64 run's
    launches."""
    import dataclasses

    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.models.decode import DecodeConfig
    from isee3_decoder_tpu_torch.models.pipeline import (
        PipelineConfig,
        demod_to_symbols,
        receive_block,
    )

    t0 = time.perf_counter()
    walk = DecodeConfig(quicklook=False, qlec=False)
    cfg32 = PipelineConfig(pm=pm, sym=sym, decode=walk)
    cfg64 = PipelineConfig(pm=dataclasses.replace(pm, dtype=torch.float64),
                           sym=sym, decode=walk)
    frames, iq, _ = bench_block(dev, NCHAN, nsamples, NOISE_CLEAN, seed=0)
    rec32, ss32 = receive_block(iq, nframes, cfg32)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    rec64, ss64 = receive_block(iq, nframes, cfg64)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    backends = dict(_kernels.backend_used)
    good, matched = frame_stats(rec64, frames, NCHAN, nframes)
    require(matched == rec64.good.size,
            f"float64: {matched} of {rec64.good.size} frames good and sent")
    for field in ("data", "good", "start_symbol"):
        require(np.array_equal(getattr(rec64, field), getattr(rec32, field)),
                f"float64: frames differ from the float32 run's in {field}")
    require(np.array_equal(ss64, ss32), "float64: sync starts differ")
    require(backends.get("pm") == "plain_f64",
            f"float64: pm stage ran {backends.get('pm')!r}")
    for k in ("pm_locked", "spin_down", "windowed_dft", "pm_scan"):
        require(launches[k] == 0, f"float64: pm kernel {k} launched "
                                  f"{launches[k]} times")
    for k in ("prefix_sum", "fano_walk"):
        require(launches[k] > 0, f"float64: kernel {k} never launched")

    bb32 = demod_to_symbols(iq, cfg32)[1]
    bb64 = demod_to_symbols(iq, cfg64)[1]
    d32 = (bb64.to(torch.int32) - bb32.to(torch.int32)).abs()
    n32, max32 = int((d32 > 0).sum()), int(d32.max())
    del bb32, d32
    bb_cpu = demod_to_symbols(iq[:4].cpu(), cfg64)[1]
    dcpu = (bb64[:4].cpu().to(torch.int32) - bb_cpu.to(torch.int32)).abs()
    ncpu, maxcpu = int((dcpu > 0).sum()), int(dcpu.max())
    require(maxcpu <= 1, f"float64: card vs CPU baseband off by {maxcpu} LSB")
    del bb64
    st32 = [stage_ms(iq, nframes, cfg32)["pm_scan"] for _ in range(3)]
    st64 = [stage_ms(iq, nframes, cfg64)["pm_scan"] for _ in range(3)]
    log(f"  float64: {NCHAN} ch x {nframes} frames, good {good}/"
        f"{rec64.good.size}, matched {matched}, == the float32 run's frames; "
        f"decoders {decoder_mix(rec64)} (float32 {decoder_mix(rec32)}); "
        f"launches {launches}; backend {backends}")
    log(f"  float64 baseband: card vs CPU on 4 ch x {dcpu.shape[1]} samples: "
        f"{ncpu} differ, max {maxcpu} LSB; float32 vs float64 on {NCHAN} ch: "
        f"{n32} of {NCHAN * dcpu.shape[1]} samples differ, max {max32} LSB")
    log(f"  float64 pm stage {'/'.join(f'{t:.3f}' for t in st64)} ms against "
        f"float32 {'/'.join(f'{t:.3f}' for t in st32)} ms (stage_ms, 3 runs); "
        f"card: {card_line()}")
    log(f"phase 19 float64: frames == float32, no pm kernel, K3 and K4 ran "
        f"({time.perf_counter() - t0:.1f} s)")
    del iq
    return launches


# ---- phase 20: the reference's other two operational modes

#: the operational modes of phase 20 (SURVEY.md:48-49): 2048 bps at 4096
#: sym/s (0.5 s frames, the bench's 128 channels) and 16 bps on the 1024
#: Hz subcarrier (32 sym/s, 32 clocks a symbol, 64 s frames; 16 channels,
#: ~3.1 GB of int16 IQ on the card), each with the JAX package's own
#: configs (tests/test_mode_2048bps.py, tests/test_mode16bps_and_fer.py)
MODE_LEAD = 20
FAST_SYMRATE = 4096.0
FAST_FRAMES = 8
# the bench's mid Eb/N0 (noise 50000 at 1024 sym/s) at 4x the symbol rate
FAST_NOISE_MID = 25_000.0
# 2048 bps at threshold: the bench's threshold Eb/N0 (noise 110,000 at
# amplitude 12,000) at 4x the symbol rate, noise 13,750 at amplitude
# 3000 (Eb/N0 ≈ 3.6 dB by (A·sin 1.1)^2 · 61 / σ^2), decoded all 896
# lanes by Fano on the card: the 512 bps block's carrier, 6 dB weaker
# against its noise, is what sends its lanes to Viterbi.  Noise 10,000 at
# amplitude 2000 is Eb/N0 ≈ 2.9 dB, near the ~2.5 dB Fano threshold, with
# 32,767 at 3.3 sigma (at 11,000, 2.1 dB, the fallback took 126 lanes
# and 4 of its frames passed the syncword with payload errors)
FAST_THRESHOLD_AMPLITUDE = 2000.0
FAST_NOISE_THRESHOLD = 10_000.0
SLOW_SYMRATE = 32.0
SLOW_CLOCKS = 32
SLOW_NCHAN = 16
SLOW_FRAMES = 3
SLOW_MOD_INDEX = 0.7
# the stage tools' 16 bps recording (-r 32768)
SLOW_TOOL_RATE = 32_768.0
# 16 bps below the clean signal: amplitude 900 keeps the noise inside
# int16 (32,767 is 3.5 sigma); noise 9400 there is Es/N0 (900·sin 0.7)^2
# · 7812.5 / (2 · 9400^2) ≈ 14.9, as noise 17,000 at amplitude 9000 and
# 8192 sps, where tools/inversion_sweep.py's CPU sweep found inverted
# windows in every seed
SLOW_NOISY_AMPLITUDE = 900.0
SLOW_NOISE_NOISY = 9400.0


def mode_symbols(frames: np.ndarray, nsym_total: int, seed: int) -> np.ndarray:
    """The sent symbol stream: MODE_LEAD random symbols, the frames
    encoded from the sync state, random filler up to nsym_total."""
    from isee3_decoder_tpu_torch.utils.testsignal import frames_to_symbols

    rng = np.random.default_rng(seed)
    syms = frames_to_symbols(frames)
    tail = max(nsym_total - MODE_LEAD - syms.size, 0)
    return np.concatenate([rng.integers(0, 2, MODE_LEAD).astype(np.uint8),
                           syms, rng.integers(0, 2, tail).astype(np.uint8)])


def mode_capture(dev, syms: np.ndarray, nchan: int, nsamples: int,
                 samprate: float, symrate: float, symbolclocks: int,
                 mod_index: float, noise_std: float, seed: int,
                 amplitude: float = 12_000.0, carrier0: float = 20_000.0):
    """(nchan, 2·nsamples) int16 raw IQ on the card: the symbol stream
    Manchester-coded on ``symbolclocks`` cycles of a subcarrier a symbol
    (utils/testsignal.manchester_waveform's rule), phase-modulated on
    carriers carrier0 + 137 Hz·i.  As edge_capture does, the carrier phase
    runs in float64 cycles reduced mod 1 (a float32 ramp loses the phase
    over 48 M samples); one channel at a time, so the float64 temporaries
    stay a few GB."""
    import torch

    syms_d = torch.as_tensor(syms, device=dev)
    out = torch.empty((nchan, 2 * nsamples), dtype=torch.int16, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ss = samprate / symrate
    t = torch.arange(nsamples, dtype=torch.float64, device=dev)
    pos = t / ss
    idx = torch.clamp(torch.floor(pos).to(torch.int64), max=syms.size - 1)
    half = torch.remainder((pos - idx) * symbolclocks, 1.0) >= 0.5
    level = torch.where(syms_d[idx] > 0, 1.0, -1.0).to(torch.float64)
    d = torch.where(half, level, -level)
    del pos, idx, half, level
    for c in range(nchan):
        carrier = carrier0 + 137.0 * c
        ph = 2 * np.pi * torch.remainder(t * (carrier / samprate), 1.0)
        iq = amplitude * torch.polar(torch.ones_like(ph), ph + mod_index * d
                                     + 0.7)
        if noise_std > 0:
            iq = iq + noise_std * torch.complex(
                torch.randn(nsamples, generator=gen, device=dev,
                            dtype=torch.float64),
                torch.randn(nsamples, generator=gen, device=dev,
                            dtype=torch.float64))
        ri = torch.stack([iq.real, iq.imag], dim=-1).reshape(-1)
        out[c] = torch.trunc(torch.clamp(ri, -32767.0, 32767.0)).to(torch.int16)
        del ph, iq, ri
    return out


def check_mode_capture(dev) -> float:
    """mode_capture against utils/testsignal.synthesize_iq (numpy, float64)
    at noise 0 on 0.3 s of the 16 bps mode and of the 2048 bps mode: the
    complex values within 1e-6 of the amplitude.  Returns the worst
    difference (in units of the int16 scale)."""
    from isee3_decoder_tpu_torch.utils.testsignal import (
        random_frames,
        synthesize_iq,
    )

    frames = random_frames(np.random.default_rng(3), 1)
    worst = 0.0
    for symrate, clocks in ((SLOW_SYMRATE, SLOW_CLOCKS), (FAST_SYMRATE, 1)):
        n = int(0.3 * SAMPRATE)
        syms = mode_symbols(frames, 0, seed=4)
        want = synthesize_iq(frames, samprate=SAMPRATE, symrate=symrate,
                             carrier=20_000.0, mod_index=SLOW_MOD_INDEX,
                             symbolclocks=clocks, lead_symbols=MODE_LEAD,
                             rng=np.random.default_rng(4))[:n]
        got = mode_capture(dev, syms, 1, n, SAMPRATE, symrate, clocks,
                           SLOW_MOD_INDEX, 0.0, seed=0)[0].cpu().numpy()
        # the int16 wire form: truncation of values within 1e-6 of each
        # other differs only where one sits on an integer
        w = np.stack([want.real, want.imag], axis=-1).reshape(-1)
        err = np.abs(got.astype(np.float64) - np.trunc(w))
        worst = max(worst, float(err.max()))
        require(float(err.max()) <= 1.0 and float((err > 0).mean()) < 1e-4,
                f"mode capture: {symrate} sym/s differs from synthesize_iq "
                f"(max {err.max()}, share {(err > 0).mean()})")
    return worst


def symbol_stage(csum, cfg, nwindows: int) -> tuple:
    """symdemod_scan_csum once: (soft symbols, ms, the peak allocation
    above what was allocated before it, in bytes)."""
    import torch

    from isee3_decoder_tpu_torch.models.symdemod import symdemod_scan_csum

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, out = symdemod_scan_csum(csum, cfg, nwindows)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out.soft, ms, torch.cuda.max_memory_allocated() - base


def mode_csum(iq, cfg):
    """The pm stage and K3 of receive_block: (csum, the number of
    windows, the (T, B, n) baseband)."""
    from isee3_decoder_tpu_torch.models.symdemod import (
        initial_firstsample,
        window_samples,
    )
    from isee3_decoder_tpu_torch.ops.carrier import init_carry, pm_demod_scan
    from isee3_decoder_tpu_torch.ops.prefix_cuda import prefix_sum_blocks

    B, n = iq.shape[0], cfg.pm.fftsize
    nblocks = iq.shape[1] // (2 * n)
    blocks = iq[:, : nblocks * 2 * n].reshape(B, nblocks, 2 * n)
    nwin = max((nblocks * n - initial_firstsample(cfg.sym))
               // window_samples(cfg.sym) - 1, 0)
    _, pm_out = pm_demod_scan(init_carry(B, cfg.pm, device=iq.device), blocks,
                              cfg.pm)
    return prefix_sum_blocks(pm_out.baseband, tail=1), nwin, pm_out.baseband


def mode_kernel_checks(iq, cfg, label: str, bb) -> None:
    """K1, K2 and K3 of the mode's chain against their plain versions at
    its shapes: K1 on block 5 of the capture, locked on its carriers,
    with the mode's search width; K2 on the cold-start block; K3 on the
    mode's (T, B, n) baseband, exact."""
    import torch

    from isee3_decoder_tpu_torch.ops import carrier
    from isee3_decoder_tpu_torch.ops.prefix_cuda import (
        prefix_sum_blocks,
        prefix_sum_blocks_plain,
    )

    n = cfg.pm.fftsize
    B = iq.shape[0]
    carriers = torch.as_tensor(20_000.0 + 137.0 * np.arange(B),
                               dtype=torch.float32, device=iq.device)
    args = locked_k1_args(iq[:, 5 * 2 * n : 6 * 2 * n].contiguous(),
                          carriers, cfg.pm)
    check_k1(args, cfg.pm.binsize, "columns", f"{label} K1 at {B} x {n}, "
             f"K = {args[3]}")
    check_k2(carrier.pack_raw(iq[:, : 2 * n].contiguous()), carriers,
             cfg.pm.samprate, f"{label} {B} x {n}")
    got = prefix_sum_blocks(bb, tail=1)
    want = prefix_sum_blocks_plain(bb, tail=1)
    require(torch.equal(got, want), f"{label}: K3 differs from plain")
    log(f"  {label} K3 at {tuple(bb.shape)}: == plain")


def k3_wrap_check(dev, T: int, B: int, n: int) -> None:
    """K3 at the 16 bps row length on rows whose running sum passes 2^31
    (random non-negative int16, mean ~16,384): the kernel wraps as its
    plain twin does, exactly."""
    import torch

    from isee3_decoder_tpu_torch.ops.prefix_cuda import (
        prefix_sum_blocks,
        prefix_sum_blocks_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    blocks = torch.randint(0, 32767, (T, B, n), generator=gen, device=dev,
                           dtype=torch.int16)
    got = prefix_sum_blocks(blocks, tail=1)
    want = prefix_sum_blocks_plain(blocks, tail=1)
    total = int(blocks[:, 0].to(torch.int64).sum())
    require(total > 2**31, "K3 wrap check: the row's sum stays below 2^31")
    require(torch.equal(got, want), "K3 wrap check: kernel != plain")
    log(f"  K3 at ({T}, {B}, {n}) on rows summing to {total:,} (past 2^31 "
        f"{total // 2**31} times): kernel == plain, wrapped alike")
    del blocks, got, want
    torch.cuda.empty_cache()


def timesearch_memory(csum, cfg) -> dict:
    """One window's timing search on 2 channels chunked (SEARCH_ENTRIES)
    and in one gather: equal bit for bit, and each one's peak allocation
    above the prefix sum, in bytes."""
    import torch

    from isee3_decoder_tpu_torch.models.symdemod import initial_firstsample
    from isee3_decoder_tpu_torch.ops import symbols as sym_ops

    c2 = csum[:2]
    out = {}
    res = {}
    for name, cap in (("chunked", sym_ops.SEARCH_ENTRIES), ("one_gather", None)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res[name] = sym_ops.timesearch_from_csum(
            c2, initial_firstsample(cfg), cfg.halfclock, cfg.nsymbols,
            cfg.symbolclocks, cfg.noffsets, max_entries=cap)
        torch.cuda.synchronize()
        out[name] = torch.cuda.max_memory_allocated() - base
    require(torch.equal(res["chunked"].symphase, res["one_gather"].symphase)
            and torch.equal(res["chunked"].maxenergy,
                            res["one_gather"].maxenergy),
            "timing search: chunked differs from one gather on the card")
    return out


def mode_cell(label: str, cfg, iq, frames, plain_channels: int,
              plain_decode=None, reps: int = 5, all_sent: bool = True) -> tuple:
    """One cell: receive_block with kernels (counted run, then reps - 1
    more timed), the symbol stage's ms and peak allocation, the kernel
    path against the plain path on ``plain_channels`` channels (with
    ``plain_decode`` in place of the cell's decode configuration on both
    sides when given: lower Fano caps keep the plain walk short).  With
    ``all_sent`` False the caller checks which good frames were sent.
    Returns (launches of the counted run, the record, the frames a
    channel, symbol-stage peak bytes a channel, the csum, the soft
    symbols)."""
    import dataclasses

    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.models.pipeline import (
        demod_to_symbols,
        receive_block,
    )

    t0 = time.perf_counter()
    B = iq.shape[0]
    soft = demod_to_symbols(iq, cfg)[0]  # warm-up; frames available
    nframes = frames_available(soft)
    require(nframes >= 1, f"{label}: no whole frame in the block")
    times = []
    torch.cuda.synchronize()
    _kernels.reset_launches()
    for i in range(reps):
        t1 = time.perf_counter()
        rec, ss = receive_block(iq, nframes, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        if i == 0:
            launches = dict(_kernels.LAUNCHES)
            backends = dict(_kernels.backend_used)
    good, matched = frame_stats(rec, frames, B, nframes)
    csum, nwin, bb = mode_csum(iq, cfg)
    soft_k, sym_ms, peak = symbol_stage(csum, cfg.sym, nwin)
    require(torch.equal(soft_k.transpose(0, 1).reshape(B, -1), soft),
            f"{label}: the symbol stage differs from demod_to_symbols'")
    log(f"  {label}: {B} ch x {nframes} frames after the first sync, "
        f"receive_block {_ms(times)} ms (counted run, then {reps - 1} more); "
        f"good {good}/{rec.good.size}, matched {matched}; decoders "
        f"{decoder_mix(rec)}; launches {launches}; backend {backends}")
    log(f"  {label}: symbol stage {sym_ms:.3f} ms for {nwin} windows, peak "
        f"{peak / 2**20:.1f} MiB above the prefix sum ({peak / B / 2**20:.2f} "
        f"MiB a channel); card: {card_line()}")
    if all_sent:
        require(matched == good, f"{label}: a good frame was not sent")
    for stage in ("pm", "csum"):
        require(backends.get(stage) == "cuda", f"{label}: {stage} off CUDA")
    for k in ("pm_locked", "spin_down", "prefix_sum"):
        require(launches[k] > 0, f"{label}: kernel {k} never launched")
    mode_kernel_checks(iq, cfg, label, bb)
    del bb
    # the kernel path against the plain path on the same IQ
    sub = iq[:plain_channels].contiguous()
    pcfg = (cfg if plain_decode is None
            else dataclasses.replace(cfg, decode=plain_decode))
    rec_k, ss_k = receive_block(sub, nframes, pcfg)
    soft_pk = demod_to_symbols(sub, pcfg)[0]
    with _kernels.plain_reference():
        rec_p, ss_p = receive_block(sub, nframes, pcfg)
        soft_pp = demod_to_symbols(sub, pcfg)[0]
    for field in ("data", "good", "decoder", "start_symbol"):
        require(np.array_equal(getattr(rec_k, field), getattr(rec_p, field)),
                f"{label}: kernel and plain paths differ in {field}")
    require(np.array_equal(ss_k, ss_p), f"{label}: sync differs")
    dsoft = (soft_pk.int() - soft_pp.int()).abs()
    nsoft, maxsoft = int((dsoft > 0).sum()), int(dsoft.max())
    # K1/K2 are within 1 LSB of their plain versions; a 1-LSB step in the
    # baseband may move a soft symbol by one level, not more
    require(maxsoft <= 1, f"{label}: soft symbols differ by {maxsoft}")
    log(f"  {label}: kernel path == plain path on {plain_channels} ch "
        f"(bytes, flags, labels, starts; decoders {decoder_mix(rec_k)}); soft "
        f"symbols differ in {nsoft} of {soft_pk.numel()} by <= {maxsoft} "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches, rec, nframes, peak / B, csum, soft


def inverted_windows(soft, syms: np.ndarray, nsym: int) -> tuple:
    """Hard decisions (soft > 128) of a (B, S) soft-symbol tensor against
    the sent symbol stream, soft symbol i against sent symbol i + offset
    for the offset in (-1, 0, 1) that agrees best on the channel (the
    first window's search may start a whole symbol early or late), by
    symdemod window of ``nsym`` symbols: (per channel, the windows with
    more than half their symbols wrong, i.e. inverted; per channel, the
    wrong symbols outside them)."""
    hard = (soft > 128).cpu().numpy().astype(np.uint8)
    n = (min(hard.shape[1], syms.size) - 1) // nsym * nsym
    inv, scattered = [], []
    for row in hard:
        per_win = min(
            ((row[:n] != np.roll(syms, -off)[:n]).reshape(-1, nsym).sum(-1)
             for off in (0, -1, 1)), key=lambda w: int(w.sum()))
        inv.append(np.nonzero(2 * per_win > nsym)[0].tolist())
        scattered.append(int(per_win[2 * per_win <= nsym].sum()))
    return inv, scattered


def mode_tools(dev) -> dict:
    """The stage tools as processes in both modes: a 10 s 2048 bps
    recording through ``pmdemod -W 200 | symdemod -c 4096. -w 0.5 |
    decode``, and a 16 bps recording at -r 32768 (3 frames after the
    lead, sent at 32 sym/s on the measured clock, carrier 4 kHz) through
    ``pmdemod -r 32768 -b 8 -W 100 | symdemod -r 32768 -c 32 | decode``
    (its locked blocks search by K8, as phase 10's): every good frame a
    sent one, one at least.  Returns the tools' launches."""
    import shlex
    import tempfile

    from isee3_decoder_tpu_torch.config import ACTUALCLOCK, NOMINALCLOCK
    from isee3_decoder_tpu_torch.utils.devicesignal import random_frames

    frames = random_frames(np.random.default_rng(41), 20)
    sent = {f.tobytes() for f in frames}
    slow_rate = SLOW_SYMRATE * ACTUALCLOCK / NOMINALCLOCK
    cases = {
        "2048": (frames, SAMPRATE, FAST_SYMRATE, 1, 10.0, 20_000.0,
                 "-q -W 200", "-q -c 4096. -w 0.5"),
        "16": (frames[:SLOW_FRAMES], SLOW_TOOL_RATE, slow_rate, SLOW_CLOCKS,
               (MODE_LEAD + SLOW_FRAMES * 2048) / slow_rate + 3.0, 4000.0,
               "-q -r 32768 -b 8 -W 100", "-q -r 32768 -c 32"),
    }
    total: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, (fr, fs, symrate, clocks, secs, carrier0, pm_args,
                   sym_args) in cases.items():
            t0 = time.perf_counter()
            n = int(secs * fs)
            syms = mode_symbols(fr, int(n / (fs / symrate)) + 2, seed=42)
            rec = os.path.join(tmp, f"mode{mode}.iq")
            mode_capture(dev, syms, 1, n, fs, symrate, clocks,
                         SLOW_MOD_INDEX if clocks > 1 else 1.1,
                         NOISE_CLEAN, seed=43, carrier0=carrier0)[0].cpu(
                         ).numpy().tofile(rec)
            outs = {t: os.path.join(tmp, f"{t}{mode}.json")
                    for t in ("pmdemod", "symdemod", "decode")}

            def tool(name: str, args: str) -> str:
                shim = shlex.quote(TOOL_SHIM.format(pkg=PKG, tool=name))
                return f"{sys.executable} -c {shim} {outs[name]} {args}"

            pipe = (f"set -o pipefail; {tool('pmdemod', f'{pm_args} {rec}')} "
                    f"| {tool('symdemod', sym_args)} | {tool('decode', '')}")
            r = subprocess.run(["bash", "-c", pipe], cwd=HERE,
                               capture_output=True, text=True, timeout=300)
            require(r.returncode == 0,
                    f"{mode} bps tools failed: {r.stderr[-2000:]}")
            decoded = parse_hex_frames(r.stdout)
            good = [d for g, d in decoded if g]
            require(good and all(d in sent for d in good),
                    f"{mode} bps tools: good frames {len(good)}, not all "
                    f"sent: {r.stdout[-1500:]}")
            per_tool = {}
            for name, path in outs.items():
                with open(path) as f:
                    counts = json.load(f)["launches"]
                per_tool[name] = {k: v for k, v in counts.items() if v}
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
            log(f"  {mode} bps tools: pmdemod {pm_args} | symdemod {sym_args}"
                f" | decode on {secs:.1f} s at {fs:.0f} sps: {len(decoded)} "
                f"frames, {len(good)} good, all sent; launches {per_tool} "
                f"({time.perf_counter() - t0:.1f} s)")
    return total


def mode_tracked(dev, slow, n: int, ts512: dict, ts16: dict) -> dict:
    """The batched tracker in the 16 bps mode at 250 ksps: 16 channels
    sent at 32 sym/s on the measured spacecraft clock (32 x 1024.545 /
    1024), their baseband demodulated untracked (symdemod_scan_csum) and
    by symdemod_tracked_batched, from the nominal 32.0 and from the
    measured clock (``symdemod -c 32``'s start), all four decoded by
    decode_stream.  Every good frame must be a sent one, and from the
    measured clock every frame after the first sync must decode tracked;
    from 32.0 the frames are counted.  The tracked window-start search
    chunked must equal one gather, its peak a channel within 2x the 512
    bps search's (``ts512``; ``ts16`` is the untracked 16 bps search's);
    2 channels over 8 windows equal their plain_reference() run.  Returns
    the launches (pm stage, K3 three times, the decodes)."""
    import dataclasses

    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import ACTUALCLOCK, NOMINALCLOCK
    from isee3_decoder_tpu_torch.models import symdemod as sd
    from isee3_decoder_tpu_torch.models.decode import DecodeConfig, decode_stream
    from isee3_decoder_tpu_torch.models.symdemod_tracked import (
        build_track_tables,
        device_tables,
        symdemod_tracked_batched,
        window_start_energies,
    )
    from isee3_decoder_tpu_torch.ops import symbols as sym_ops
    from isee3_decoder_tpu_torch.utils.devicesignal import random_frames

    t0 = time.perf_counter()
    label = "16 bps tracked"
    sent_rate = SLOW_SYMRATE * ACTUALCLOCK / NOMINALCLOCK
    frames = random_frames(np.random.default_rng(28), SLOW_FRAMES)
    sent = {f.tobytes() for f in frames}
    syms = mode_symbols(frames, int(n / (SAMPRATE / sent_rate)) + 2, seed=28)
    iq = mode_capture(dev, syms, SLOW_NCHAN, n, SAMPRATE, sent_rate,
                      SLOW_CLOCKS, SLOW_MOD_INDEX, NOISE_CLEAN, seed=29)
    B = SLOW_NCHAN
    torch.cuda.synchronize()
    _kernels.reset_launches()
    csum, nwin, bb = mode_csum(iq, slow)
    del iq
    bb = bb.transpose(0, 1).reshape(B, -1).contiguous()

    def frames_of(soft) -> tuple[int, int, int]:
        recs, _ = decode_stream(torch.as_tensor(soft, device=dev),
                                DecodeConfig(), device=dev)
        good = [bytes(r.data[b]) for r in recs for b in range(B)
                if r.good[b]]
        return len(good), sum(d in sent for d in good), len(recs) * B

    for start, symrate in (("32.0", SLOW_SYMRATE),
                           ("the measured clock", sent_rate)):
        sym = dataclasses.replace(slow.sym, symrate=symrate)
        sd.reset_track_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, out = sd.symdemod_scan_csum(csum, sym, nwin)
        soft_u = out.soft.transpose(0, 1).reshape(B, -1)
        torch.cuda.synchronize()
        t_untracked = time.perf_counter() - t1
        del out
        t1 = time.perf_counter()
        soft_t, infos = symdemod_tracked_batched(bb, sym, nwin)
        t_tracked = time.perf_counter() - t1
        iters = list(sd.track_stats["iterations"])
        reads = list(sd.track_stats["host_reads"])
        stats_u, stats_t = frames_of(soft_u), frames_of(soft_t)
        est = infos[-1]["symrate"]
        log(f"  {label}: {B} ch x {n / SAMPRATE:.1f} s sent at "
            f"{sent_rate:.6f} sym/s, demodulated from {start} "
            f"({symrate:.6f}): {nwin} windows; frames (good, sent, decoded) "
            f"untracked {stats_u}, tracked {stats_t}; clock estimates, sym/s: "
            f"window 0 {infos[0]['symrate'].min():.6f}-"
            f"{infos[0]['symrate'].max():.6f}, last window {est.min():.6f}-"
            f"{est.max():.6f}")
        log(f"  {label}, from {start}: tracked {t_tracked * 1e3 / nwin:.3f} ms "
            f"a window ({t_tracked * 1e3:.1f} ms for {nwin}, the tables and K3 "
            f"included), untracked {t_untracked * 1e3 / nwin:.3f}; climb "
            f"iterations a window min {min(iters)} mean {np.mean(iters):.2f} "
            f"max {max(iters)} (first 8 windows {iters[:8]}); host reads a "
            f"window mean {np.mean(reads):.2f} max {max(reads)}")
        for name, (good, matched, _) in (("untracked", stats_u),
                                         ("tracked", stats_t)):
            require(good == matched, f"{label}, {name} from {start}: a good "
                    f"frame was not sent ({good} good, {matched} sent)")
    del csum
    launches = dict(_kernels.LAUNCHES)
    require(launches["prefix_sum"] == 3, f"{label}: not one K3 launch a "
            f"demodulation ({launches['prefix_sum']})")
    require(stats_t[0] == B * (SLOW_FRAMES - 1), f"{label}: {stats_t[0]} "
            f"frames decoded tracked from the measured clock, not every one "
            f"after the first sync ({B * (SLOW_FRAMES - 1)})")
    slow = dataclasses.replace(slow, sym=sym)

    # the window-start search on 2 channels, chunked and in one gather
    t = build_track_tables(slow.sym, 512)
    tables = device_tables(t, dev)
    c2 = sym_ops.samples_csum(bb[:2], sym_ops.track_pad(slow.sym) + t.noff)
    first = torch.full((2,), sd.initial_firstsample(slow.sym),
                       dtype=torch.int64, device=dev)
    k = torch.zeros(2, dtype=torch.int64, device=dev)
    peak, res = {}, {}
    for name, cap in (("chunked", sym_ops.SEARCH_ENTRIES), ("one_gather", None)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res[name] = window_start_energies(c2, first, k, tables, t.nsym_max,
                                          t.noff, SLOW_CLOCKS, t.k_range,
                                          max_entries=cap)
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 2
    require(torch.equal(res["chunked"], res["one_gather"]),
            f"{label}: the window-start search chunked differs from one "
            "gather in an offset's energy")
    require(peak["chunked"] <= ts512["chunked"],
            f"{label}: the window-start search's peak a channel "
            f"({peak['chunked'] / 2**20:.2f} MiB) is over 2x the 512 bps "
            f"search's ({ts512['chunked'] / 2 / 2**20:.2f} MiB)")
    del c2, tables

    # 2 channels, 8 windows, with K3 and under plain_reference()
    soft_k2, infos_k2 = symdemod_tracked_batched(bb[:2], slow.sym, 8)
    with _kernels.plain_reference():
        soft_p2, infos_p2 = symdemod_tracked_batched(bb[:2], slow.sym, 8)
    require(np.array_equal(soft_k2, soft_p2)
            and all(np.array_equal(a[key], b[key]) for a, b in
                    zip(infos_k2, infos_p2) for key in a),
            f"{label}: 2 channels differ from plain_reference()'s")
    require(np.array_equal(soft_k2, soft_t[:2, : soft_k2.shape[1]]),
            f"{label}: 2 channels alone differ from their rows of the batch")
    del bb
    torch.cuda.empty_cache()
    log(f"  {label}: every good frame sent, every frame after the first "
        f"sync decoded tracked from the measured clock; 2 ch x 8 windows == "
        f"plain_reference(); launches {launches}")
    log(f"  {label}: window-start search on 2 ch, peak a channel chunked "
        f"{peak['chunked'] / 2**20:.2f} MiB, one gather "
        f"{peak['one_gather'] / 2**20:.2f} ({peak['one_gather'] / peak['chunked']:.1f}x), "
        f"every offset's energy equal; "
        f"the untracked search's chunked {ts16['chunked'] / 2 / 2**20:.2f} / "
        f"one gather {ts16['one_gather'] / 2 / 2**20:.2f}; 512 bps search "
        f"chunked {ts512['chunked'] / 2 / 2**20:.2f} "
        f"({time.perf_counter() - t0:.1f} s); card: {card_line()}")
    return launches


def phase_modes(dev) -> dict:
    """Phase 20: the reference's 2048 bps and 16 bps subcarrier modes
    through receive_block at 250 ksps, IQ made on the card by
    mode_capture (checked against utils/testsignal.synthesize_iq first):
    2048 bps at 128 channels clean and at the bench's mid Eb/N0, 16 bps
    at 16 channels clean; each against the plain path on the same IQ,
    its kernels against their plain versions at its shapes, the timing
    search's memory a channel beside the 512 bps bench's; then the stage
    tools as processes in both modes.  Returns the launches of the
    counted runs and the tools."""
    import torch

    from isee3_decoder_tpu_torch.models.decode import (
        DECODER_FANO,
        DECODER_VITERBI,
        DecodeConfig,
    )
    from isee3_decoder_tpu_torch.models.pipeline import PipelineConfig
    from isee3_decoder_tpu_torch.models.symdemod import window_samples
    from isee3_decoder_tpu_torch.ops.prefix_cuda import prefix_sum_blocks
    from isee3_decoder_tpu_torch.ops.carrier import PMConfig
    from isee3_decoder_tpu_torch.ops.symbols import SymConfig
    from isee3_decoder_tpu_torch.utils.devicesignal import random_frames

    t0 = time.perf_counter()
    worst = check_mode_capture(dev)
    log(f"  mode capture == synthesize_iq at noise 0 on 0.3 s of each mode "
        f"(max {worst} LSB after truncation)")
    launches: dict = {}

    def add(path_launches):
        for k, v in path_launches.items():
            launches[k] = launches.get(k, 0) + v

    def nsamples_for(sym, nframes_tx: int, n: int) -> int:
        # windows enough for the frames after the lead, one of slack, in
        # whole pm blocks
        need = -(-(MODE_LEAD + nframes_tx * 2048) // sym.nsymbols)
        want = (need + 1) * window_samples(sym) + int(sym.symbolsamples / 2)
        return -(-want // n) * n

    # 512 bps (the bench): the symbol stage's peak a channel, on 16
    # channels of random baseband, as the 16 bps cell's channel count
    bench = SymConfig(samprate=SAMPRATE, symrate=SYMRATE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    bb = torch.randint(-3000, 3000, (1, SLOW_NCHAN, 3 * int(SAMPRATE)),
                       generator=gen, device=dev, dtype=torch.int16)
    csum = prefix_sum_blocks(bb, tail=1)
    del bb
    symbol_stage(csum, bench, 1)  # warm-up
    _, ms512, peak512 = symbol_stage(csum, bench, 1)
    ts512 = timesearch_memory(csum, bench)
    del csum
    log(f"  512 bps bench symbol stage on {SLOW_NCHAN} ch, 1 window: "
        f"{ms512:.3f} ms, peak {peak512 / SLOW_NCHAN / 2**20:.2f} MiB a "
        f"channel; one window's search on 2 ch: chunked {ts512['chunked'] / 2 / 2**20:.2f}"
        f" MiB a channel, one gather {ts512['one_gather'] / 2 / 2**20:.2f}")

    # ---- 2048 bps, 128 channels
    fast = PipelineConfig(
        pm=PMConfig(samprate=SAMPRATE, binsize=4.0, search_width=200.0),
        sym=SymConfig(samprate=SAMPRATE, symrate=FAST_SYMRATE, window=0.5),
        decode=DecodeConfig())
    frames = random_frames(np.random.default_rng(20), FAST_FRAMES)
    n = nsamples_for(fast.sym, FAST_FRAMES, fast.pm.fftsize)
    syms = mode_symbols(frames, int(n / fast.sym.symbolsamples) + 2, seed=20)
    peaks = {}
    # the plain path's Fano walk under low caps (a lane that times out
    # walks its whole budget, ~0.5 ms a micro-step in the plain loop)
    low_caps = DecodeConfig(viterbi_enabled=False, fano_tier1_maxcycles=1,
                            fano_maxcycles=3)
    for label, noise, seed, amp in (
            ("2048 bps clean", NOISE_CLEAN, 22, 12_000.0),
            ("2048 bps mid", FAST_NOISE_MID, 23, 12_000.0),
            ("2048 bps threshold", FAST_NOISE_THRESHOLD, 26,
             FAST_THRESHOLD_AMPLITUDE)):
        iq = mode_capture(dev, syms, NCHAN, n, SAMPRATE, FAST_SYMRATE, 1, 1.1,
                          noise, seed, amplitude=amp)
        clean = noise == NOISE_CLEAN
        cell, rec, nframes, peaks[label], csum, _ = mode_cell(
            label, fast, iq, frames, NCHAN if clean else 8,
            None if clean else DecodeConfig(viterbi_enabled=False,
                                            fano_maxcycles=40)
            if noise == FAST_NOISE_MID else low_caps)
        add(cell)
        if clean:
            require(int(rec.good.sum()) == rec.good.size
                    and nframes == FAST_FRAMES - 1,
                    f"2048 bps clean: {int(rec.good.sum())} of "
                    f"{rec.good.size} frames, {nframes} a channel")
            ts = timesearch_memory(csum, fast.sym)
            log(f"  2048 bps search on 2 ch: chunked {ts['chunked'] / 2 / 2**20:.2f}"
                f" MiB a channel, one gather {ts['one_gather'] / 2 / 2**20:.2f}")
        else:
            if (rec.decoder == DECODER_FANO).any():
                require(cell["fano_walk"] > 0, f"{label}: K4 never launched")
            if noise == FAST_NOISE_THRESHOLD:
                require((rec.decoder == DECODER_VITERBI).any(),
                        f"{label}: no lane reached Viterbi")
            if (rec.decoder == DECODER_VITERBI).any():
                require(cell["viterbi_a"] > 0 and cell["viterbi_b"] > 0,
                        f"{label}: K5/K6 never launched")
                viterbi_lanes_check(iq, nframes, fast, rec, label)
        del iq, csum
        torch.cuda.empty_cache()

    # ---- 16 bps on the subcarrier, 16 channels
    slow = PipelineConfig(
        pm=PMConfig(samprate=SAMPRATE, binsize=4.0, search_width=100.0),
        sym=SymConfig(samprate=SAMPRATE, symrate=SLOW_SYMRATE,
                      symbolclocks=SLOW_CLOCKS),
        decode=DecodeConfig())
    frames = random_frames(np.random.default_rng(24), SLOW_FRAMES)
    n = nsamples_for(slow.sym, SLOW_FRAMES, slow.pm.fftsize)
    syms = mode_symbols(frames, int(n / slow.sym.symbolsamples) + 2, seed=24)
    iq = mode_capture(dev, syms, SLOW_NCHAN, n, SAMPRATE, SLOW_SYMRATE,
                      SLOW_CLOCKS, SLOW_MOD_INDEX, NOISE_CLEAN, seed=25)
    log(f"  16 bps capture: {SLOW_NCHAN} ch x {n / SAMPRATE:.1f} s "
        f"({iq.numel() * 2 / 2**30:.2f} GiB int16 IQ)")
    label = "16 bps clean"
    cell, rec, nframes, peaks[label], csum, _ = mode_cell(
        label, slow, iq, frames, SLOW_NCHAN, reps=2)
    add(cell)
    require(int(rec.good.sum()) == rec.good.size
            and nframes == SLOW_FRAMES - 1,
            f"16 bps: {int(rec.good.sum())} of {rec.good.size} frames, "
            f"{nframes} a channel")
    ts = timesearch_memory(csum, slow.sym)
    log(f"  16 bps search on 2 ch: chunked {ts['chunked'] / 2 / 2**20:.2f} "
        f"MiB a channel, one gather {ts['one_gather'] / 2 / 2**20:.2f} "
        f"({ts['one_gather'] / ts['chunked']:.1f}x)")
    require(ts["chunked"] <= 2 * ts512["chunked"]
            and peaks[label] <= 2 * peak512 / SLOW_NCHAN,
            "16 bps: the timing search's working set a channel is over 2x "
            "the 512 bps one's")
    del iq, csum
    torch.cuda.empty_cache()
    k3_wrap_check(dev, n // slow.pm.fftsize, SLOW_NCHAN, slow.pm.fftsize)

    # ---- 16 bps below the clean signal: a whole symdemod window may come
    # out inverted (the window-start search takes a start half a
    # subcarrier cycle off), and the lanes it hits reach Fano / Viterbi
    iq = mode_capture(dev, syms, SLOW_NCHAN, n, SAMPRATE, SLOW_SYMRATE,
                      SLOW_CLOCKS, SLOW_MOD_INDEX, SLOW_NOISE_NOISY, seed=27,
                      amplitude=SLOW_NOISY_AMPLITUDE)
    label = "16 bps noisy"
    cell, rec, nframes, peaks[label], csum, soft = mode_cell(
        label, slow, iq, frames, 4, low_caps, reps=2, all_sent=False)
    add(cell)
    nsym = slow.sym.nsymbols
    inv, scattered = inverted_windows(soft, syms, nsym)
    require(cell["fano_walk"] > 0, f"{label}: K4 never launched")
    # a good frame that was not sent: the Viterbi fallback across an
    # inverted window, whose syncword (all decode.c verifies) came out
    # right; the same bits on the plain path
    sent_ok = matched_mask(rec, frames, SLOW_NCHAN, nframes)
    false_good = np.nonzero(rec.good & ~sent_ok)[0]
    for lane in false_good:
        c, s0 = lane // nframes, int(rec.start_symbol[lane])
        hit = [w for w in inv[c] if s0 // nsym <= w <= (s0 + 2047) // nsym]
        require(rec.decoder[lane] == DECODER_VITERBI and hit,
                f"{label}: lane {lane}, good and not sent, is no Viterbi "
                f"frame across an inverted window")
    if (rec.decoder == DECODER_VITERBI).any():
        require(cell["viterbi_a"] > 0 and cell["viterbi_b"] > 0,
                f"{label}: K5/K6 never launched")
        viterbi_lanes_check(iq, nframes, slow, rec, label,
                            false_good[:4] if false_good.size else None)
    log(f"  {label}: amplitude {SLOW_NOISY_AMPLITUDE:.0f}, noise "
        f"{SLOW_NOISE_NOISY:.0f}; inverted windows a channel {inv}; "
        f"channels with one {sum(1 for w in inv if w)} of {SLOW_NCHAN}; wrong "
        f"symbols outside them a channel {scattered}; good frames not sent "
        f"{false_good.size}, lanes {false_good.tolist()} (each a Viterbi "
        f"frame across an inverted window); records a channel (start, good, "
        f"good and sent, decoder) "
        f"{[[(int(rec.start_symbol[c * nframes + f]), int(rec.good[c * nframes + f]), int(sent_ok[c * nframes + f]), int(rec.decoder[c * nframes + f])) for f in range(nframes)] for c in range(SLOW_NCHAN)]}")
    del iq, csum, soft
    torch.cuda.empty_cache()

    # ---- the batched tracker in the 16 bps mode: channels sent at 32 sym/s
    # on the measured spacecraft clock, demodulated from 32.0
    add(mode_tracked(dev, slow, n, ts512, ts))

    add(mode_tools(dev))
    log(f"phase 20 modes: 2048 bps (128 ch, clean, mid, threshold) and 16 "
        f"bps subcarrier (16 ch, clean, noisy, tracked) == plain path, every "
        f"good frame sent; symbol "
        f"stage peak a channel "
        f"{ {k: round(v / 2**20, 2) for k, v in peaks.items()} } MiB against "
        f"512 bps {peak512 / SLOW_NCHAN / 2**20:.2f}; launches {launches} "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches


# ---- phase 21: the port's channel statistics

#: frames a point of phase 21's Fano checks (the JAX suite's tests run 24
#: and 16), and the channel's symbols a point of its hard-BER check
#: (400,000 there)
STATS_FRAMES = 1024
STATS_SYMBOLS = 4_000_000
#: frames a batch of the K=24 Viterbi decoders: a frame's decision tape
#: is 1 GiB
STATS_VITERBI_BATCH = 8
STATS_VITERBI_FRAMES = 16


def phase_statistics(dev) -> dict:
    """Phase 21: the JAX suite's statistical checks (tests/
    test_ber_regression.py:20, :36; tests/test_mode16bps_and_fer.py:80)
    on the port's own channel (utils/sim.simulate on a CUDA generator) at
    larger counts, through K4 (fano_decode), K10 (ops/viterbi.decode_frame)
    and K5 + K6 (ops/viterbi_fused.decode_frame_fused), with the same
    asserts: the hard symbol error rate within 25 % + 2e-4 of theory at
    Es/N0 -1, 1, 3 dB; at Eb/N0 3.5 dB no undetected error, at least 75 %
    of frames finished, under 10 cycles a bit; the FER sweep at 2.5, 3.0,
    4.0 dB (deletions monotone, at most 2/16 at 4.0 dB, not all at 2.5, no
    undetected error) and both Viterbi decoders giving the sent bits of
    frames Fano deleted at 3.0 dB (at 2.5 dB if none was).  No undetected
    error is allowed in the JAX tests' counts of frames (the first 24 at
    3.5 dB, 16 a point of the sweep); one past them is counted in the
    table and must be the plain walk's too (K4 adds no error).  Then K4
    against its plain walk (on the CPU, ~4x quicker a micro-step than on
    the card) on 16 lanes at 2.5 dB under a cap of 4 cycles a bit, so
    some time out.  Prints the BER / FER table; returns the launches
    before the comparisons."""
    import torch

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import (
        FRAMEBITS,
        MCQLI24,
        SYNC_STATE,
        SYNCWORD,
    )
    from isee3_decoder_tpu_torch.ops.encode import encode_bits
    from isee3_decoder_tpu_torch.ops.fano import FanoParams, fano_decode
    from isee3_decoder_tpu_torch.ops.viterbi import decode_frames
    from isee3_decoder_tpu_torch.utils.metrics import gen_met
    from isee3_decoder_tpu_torch.utils.sim import ebn0_to_noise, simulate

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    _kernels.reset_launches()
    table = []

    # ---- the channel's hard symbol error rate against theory
    for esn0_db in (-1.0, 1.0, 3.0):
        noise = 60.0 / (10 ** (esn0_db / 20.0)) / math.sqrt(2.0)
        rx = simulate(gen, torch.zeros(STATS_SYMBOLS, dtype=torch.uint8,
                                       device=dev), 60.0, noise)
        ser = float((rx > 128).double().mean())
        want = 0.5 * math.erfc(60.0 / (noise * math.sqrt(2.0)))
        table.append(f"Es/N0 {esn0_db:+.1f} dB: hard SER {ser:.6f}, theory "
                     f"{want:.6f} ({STATS_SYMBOLS:,} symbols)")
        require(abs(ser - want) < 0.25 * want + 2e-4,
                f"statistics: SER {ser} against {want} at {esn0_db} dB")

    def frames_of(start_state: int, tail: int):
        rng = np.random.default_rng(31)
        bits = np.zeros((STATS_FRAMES, FRAMEBITS), np.uint8)
        bits[:, : FRAMEBITS - 64] = rng.integers(0, 2, (STATS_FRAMES,
                                                        FRAMEBITS - 64))
        for j in range(MCQLI24.k - 1):
            bits[:, FRAMEBITS - 1 - j] = (tail >> j) & 1
        syms, _ = encode_bits(torch.as_tensor(bits, device=dev), start_state,
                              MCQLI24)
        return bits, syms

    def fano(syms, bits, ebn0, start_state, tail, params):
        noise = ebn0_to_noise(100.0, ebn0)
        mettab = torch.as_tensor(gen_met(100.0, noise, 0.5, 8.0), device=dev)
        rx = simulate(gen, syms, 100.0, noise)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = fano_decode(rx, mettab, FRAMEBITS, start_state, tail, MCQLI24,
                          params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        finished = res.goodbits.cpu().numpy() == FRAMEBITS
        errs = (res.bits.cpu().numpy() != bits).any(axis=1)
        cycles = res.cycles.cpu().numpy()
        cpb = float(cycles[finished].mean() / FRAMEBITS) if finished.any() \
            else float("nan")
        for lane in np.nonzero(finished & errs)[0]:
            wrong = np.nonzero(res.bits[lane].cpu().numpy() != bits[lane])[0]
            log(f"  undetected error at Eb/N0 {ebn0} dB, lane {lane}: "
                f"{wrong.size} wrong bits in [{wrong.min()}, {wrong.max()}], "
                f"{cycles[lane]} cycles, metric {int(res.metric[lane])}")
            undetected.append((f"{ebn0} dB, lane {lane}", rx[lane: lane + 1],
                               mettab, start_state, tail, params))
        return rx, mettab, finished, errs, cpb, ms

    undetected = []

    # ---- the Fano operating point: MCQLI-24 at 3.5 dB, FanoParams(32, 200)
    bits0, syms0 = frames_of(0, 0)
    _, _, fin35, errs, cpb, ms = fano(syms0, bits0, 3.5, 0, 0,
                                      FanoParams(32, 200))
    table.append(f"Eb/N0 3.5 dB, FanoParams(32, 200): {STATS_FRAMES} frames, "
                 f"finished {int(fin35.sum())}, undetected "
                 f"{int((fin35 & errs).sum())}, {cpb:.3f} cycles a bit on the "
                 f"finished, K4 {ms:.1f} ms")
    require(not (fin35 & errs)[:24].any(),
            "statistics: undetected error at 3.5 dB")
    require(fin35.mean() >= 0.75, f"statistics: deletion rate "
            f"{1 - fin35.mean():.3f} at 3.5 dB")
    require(cpb < 10, f"statistics: {cpb} cycles a bit at 3.5 dB")

    # ---- the FER sweep: frames from the sync state, the tail forced
    tail = SYNCWORD & ((1 << (MCQLI24.k - 1)) - 1)
    bits, syms = frames_of(SYNC_STATE, tail)
    deletion, deleted = {}, {}
    rx25 = met25 = None
    for ebn0 in (2.5, 3.0, 4.0):
        rx, met, fin, errs, cpb, ms = fano(syms, bits, ebn0, SYNC_STATE,
                                           tail, FanoParams(32, 100))
        if ebn0 == 2.5:
            rx25, met25 = rx, met
        deletion[ebn0] = 1.0 - float(fin.mean())
        deleted[ebn0] = (rx[torch.as_tensor(~fin, device=dev)],
                         np.nonzero(~fin)[0])
        table.append(f"Eb/N0 {ebn0} dB, FanoParams(32, 100): {STATS_FRAMES} "
                     f"frames, deleted {int((~fin).sum())} (FER "
                     f"{deletion[ebn0]:.5f}), undetected "
                     f"{int((fin & errs).sum())}, {cpb:.3f} cycles a bit on "
                     f"the finished, K4 {ms:.1f} ms")
        require(not (fin & errs)[:16].any(),
                f"statistics: undetected error at {ebn0} dB")
    require(deletion[4.0] <= deletion[3.0] <= deletion[2.5] + 1e-9,
            f"statistics: deletion rates not monotone {deletion}")
    require(deletion[4.0] <= 2 / 16, f"statistics: deletion {deletion}")
    require(deletion[2.5] < 1.0, "statistics: every frame deleted at 2.5 dB")

    # ---- the hybrid policy: both Viterbi decoders on the deleted frames
    at = 3.0 if deleted[3.0][1].size else 2.5
    rxd, idx = deleted[at]
    rxd, idx = rxd[:STATS_VITERBI_FRAMES], idx[:STATS_VITERBI_FRAMES]
    vit_ms = {}
    for backend in ("jnp", "fused"):
        got = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for lo in range(0, idx.size, STATS_VITERBI_BATCH):
            got.append(decode_frames(rxd[lo: lo + STATS_VITERBI_BATCH],
                                     FRAMEBITS, SYNC_STATE, SYNC_STATE,
                                     MCQLI24, backend).cpu().numpy())
            torch.cuda.empty_cache()
        vit_ms[backend] = (time.perf_counter() - t1) * 1e3
        if idx.size:
            got = np.concatenate(got)
            require(np.array_equal(got, bits[idx]), f"statistics: the "
                    f"{backend} Viterbi decoder missed the sent bits of "
                    f"{int((got != bits[idx]).any(axis=1).sum())} of "
                    f"{idx.size} deleted frames at {at} dB")
    table.append(f"Viterbi on {idx.size} of the frames Fano deleted at {at} "
                 f"dB: sent bits from K10 ({vit_ms['jnp']:.1f} ms) and K5+K6 "
                 f"({vit_ms['fused']:.1f} ms), in batches of "
                 f"{STATS_VITERBI_BATCH}")
    launches = dict(_kernels.LAUNCHES)
    require(launches["fano_walk"] > 0, "statistics: K4 never launched")
    if idx.size:
        for k in ("viterbi_acs", "viterbi_a", "viterbi_b"):
            require(launches[k] > 0, f"statistics: {k} never launched")

    # ---- K4 against its plain walk: 16 lanes at 2.5 dB, and every
    # undetected error
    for name, rx, met, st, tl, params in [
            ("2.5 dB, 16 lanes, FanoParams(32, 4)", rx25[:16], met25,
             SYNC_STATE, tail, FanoParams(32, 4))] + [
            (f"the undetected error at {case[0]}", *case[1:])
            for case in undetected]:
        t1 = time.perf_counter()
        r_k = fano_decode(rx, met, FRAMEBITS, st, tl, MCQLI24, params)
        r_p = fano_decode(rx.cpu(), met.cpu(), FRAMEBITS, st, tl, MCQLI24,
                          params)
        for field in ("bits", "goodbits", "metric", "cycles"):
            require(torch.equal(getattr(r_k, field).cpu(),
                                getattr(r_p, field)),
                    f"statistics, {name}: K4 and the plain walk differ in "
                    f"{field}")
        done = int((r_k.goodbits == FRAMEBITS).sum())
        log(f"  K4 == plain walk at {name}: bits, goodbits, metric, cycles "
            f"equal; {done} finished, {rx.shape[0] - done} timed out; max cycles "
            f"{int(r_k.cycles.max())} ({time.perf_counter() - t1:.1f} s)")
    log(f"phase 21 statistics: the port's channel (utils/sim.simulate on a "
        f"CUDA generator) through K4, K10 and K5+K6, the JAX suite's asserts "
        f"held; launches {launches} ({time.perf_counter() - t0:.1f} s); card: "
        f"{card_line()}")
    for line in table:
        log(f"  {line}")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: package {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.models.decode import (
        DECODER_VITERBI,
        DecodeConfig,
    )
    from isee3_decoder_tpu_torch.models.pipeline import (
        PipelineConfig,
        demod_to_symbols,
        receive_block,
    )
    from isee3_decoder_tpu_torch.ops.carrier import PMConfig
    from isee3_decoder_tpu_torch.ops.symbols import SymConfig

    # ---- phase 1: build
    t0 = time.perf_counter()
    path = _kernels.build_library()
    _kernels.lib()
    log(f"phase 1 build: {path.name} nvcc {_kernels.last_build_seconds:.1f} s "
        f"(phase {time.perf_counter() - t0:.1f} s)")

    # ---- phase 2: kernels vs plain PyTorch on the card
    t0 = time.perf_counter()
    checks = check_kernels(dev)
    checks.update(check_search_kernels(dev))
    checks.update(check_channelizer(dev))
    log(f"phase 2 kernels vs plain: ok ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 3: main path, clean regime, 128 channels
    seconds = (NFRAMES_TX * 2048 + 400) / SYMRATE
    nsamples = int(seconds * SAMPRATE)
    pm = PMConfig(samprate=SAMPRATE, binsize=4.0, search_width=200.0)
    sym = SymConfig(samprate=SAMPRATE, symrate=SYMRATE)
    cfg = PipelineConfig(pm=pm, sym=sym, decode=DecodeConfig())
    t0 = time.perf_counter()
    frames, iq, _ = bench_block(dev, NCHAN, nsamples, NOISE_CLEAN, seed=0)
    soft = demod_to_symbols(iq, cfg)[0]  # warm-up; frames available
    nframes = frames_available(soft)
    require(nframes >= 1, "no whole frame in the block")
    del soft
    receive_block(iq, nframes, cfg)  # warm-up of the decode half
    rec, t_clean, launches, backends = timed_receive(iq, nframes, cfg)
    good, matched = frame_stats(rec, frames, NCHAN, nframes)
    log(f"phase 3 clean: {NCHAN} ch x {nframes} frames, receive_block "
        f"{_ms(t_clean)} ms (counted run, then 4 more); good {good}/{rec.good.size}, matched "
        f"{matched}; decoders {decoder_mix(rec)}; launches {launches}; "
        f"backend {backends} ({time.perf_counter() - t0:.1f} s)")
    require(matched == rec.good.size, "clean regime: not every frame decoded")
    for k in ("pm_locked", "spin_down", "prefix_sum"):
        require(launches[k] > 0, f"clean regime: kernel {k} never launched")
    require(backends.get("pm") == "cuda" and backends.get("csum") == "cuda",
            "clean regime: pm / csum stage did not run on CUDA")
    require(backends.get("pm_locked") == "columns",
            "clean regime: K1 did not search by its column design")
    require(backends.get("spin") == "cluster",
            "clean regime: the spin-down did not run on its cluster design")
    profile_block(iq, nframes, cfg, "clean")
    del iq

    # ---- phase 4: main path, mid regime
    t0 = time.perf_counter()
    mid = PipelineConfig(pm=pm, sym=sym, decode=DecodeConfig.strict_labels())
    frames, iq, _ = bench_block(dev, NCHAN, nsamples, NOISE_MID, seed=99)
    # kernel path vs plain path on 8 channels; maxcycles lowered alike for
    # both so the plain tier-2 walk stays short
    small = PipelineConfig(pm=pm, sym=sym, decode=DecodeConfig.strict_labels(
        viterbi_enabled=False, fano_maxcycles=40))
    iq8 = iq[:8].contiguous()
    rec_k, ss_k = receive_block(iq8, nframes, small)
    with _kernels.plain_reference():
        rec_p, ss_p = receive_block(iq8, nframes, small)
    for field in ("data", "good", "decoder", "fano_cycles", "start_symbol"):
        require(np.array_equal(getattr(rec_k, field), getattr(rec_p, field)),
                f"mid regime 8 ch: kernel and plain paths differ in {field}")
    require(np.array_equal(ss_k, ss_p), "mid regime 8 ch: sync differs")
    log(f"  8 ch kernel path == plain path: decoders {decoder_mix(rec_k)}, "
        f"cycles {rec_k.fano_cycles.tolist()}")
    rec, t_mid, launches_mid, backends_mid = timed_receive(iq, nframes, mid)
    for k, v in launches_mid.items():
        launches[k] += v
    good, matched = frame_stats(rec, frames, NCHAN, nframes)
    log(f"phase 4 mid: {NCHAN} ch x {nframes} frames, receive_block "
        f"{_ms(t_mid)} ms (counted run, then 4 more); good {good}/"
        f"{rec.good.size}, matched {matched}; decoders {decoder_mix(rec)}; "
        f"launches {launches_mid}; backend {backends_mid} "
        f"({time.perf_counter() - t0:.1f} s)")
    require(launches_mid["fano_walk"] > 0, "mid regime: K4 never launched")
    require(backends_mid.get("fano") == "cuda", "mid regime: Fano not on CUDA")
    require(backends_mid.get("fano_walk") == "warp",
            "mid regime: K4 did not walk by its warp design")
    require(backends_mid.get("spin") == "cluster",
            "mid regime: the spin-down did not run on its cluster design")
    # the same block with the default DecodeConfig() (QLEC labels on): the
    # strict run's frames, only the labels may differ
    rec_q, _ = receive_block(iq, nframes, PipelineConfig(
        pm=pm, sym=sym, decode=DecodeConfig()))
    for field in ("data", "good", "start_symbol"):
        require(np.array_equal(getattr(rec_q, field), getattr(rec, field)),
                f"mid regime, QLEC on: differs from strict labels in {field}")
    log(f"  mid with DecodeConfig() (QLEC on): frames == strict_labels()'s; "
        f"decoders {decoder_mix(rec_q)} (strict {decoder_mix(rec)})")
    profile_block(iq, nframes, mid, "mid")
    del iq

    # ---- phase 5: main path, threshold regime (the Viterbi fallback)
    t0 = time.perf_counter()
    thr = PipelineConfig(pm=pm, sym=sym, decode=DecodeConfig())
    frames, iq, _ = bench_block(dev, NCHAN, nsamples, NOISE_THRESHOLD, seed=11)
    receive_block(iq, nframes, thr)  # warm-up
    rec, t_thr, launches_thr, backends_thr = timed_receive(iq, nframes, thr)
    rec_thr = rec
    for k, v in launches_thr.items():
        launches[k] += v
    good, matched = frame_stats(rec, frames, NCHAN, nframes)
    possible = rec.good.size
    vit = np.nonzero(rec.decoder == DECODER_VITERBI)[0]
    log(f"phase 5 threshold: {NCHAN} ch x {nframes} frames, receive_block "
        f"{_ms(t_thr)} ms (counted run, then 4 more); good {good}/{possible}, "
        f"matched {matched}; decoders {decoder_mix(rec)}; launches "
        f"{launches_thr}; backend {backends_thr} "
        f"({time.perf_counter() - t0:.1f} s)")
    false_good = rec.good & ~matched_mask(rec, frames, NCHAN, nframes)
    if false_good.any():
        log(f"  good frames not sent: lanes {np.nonzero(false_good)[0].tolist()}"
            f", decoders {rec.decoder[false_good].tolist()}")
    require(matched == good, "threshold regime: a good frame was not sent")
    require(good >= 0.9 * possible, "threshold regime: fewer than 90 % good")
    require(vit.size >= 1, "threshold regime: no lane reached Viterbi")
    require(launches_thr["viterbi_a"] > 0 and launches_thr["viterbi_b"] > 0,
            "threshold regime: K5/K6 never launched")
    require(backends_thr.get("viterbi") == "cuda",
            "threshold regime: Viterbi not on CUDA")
    require(launches_thr["fano_walk"] > 0
            and backends_thr.get("fano_walk") == "warp",
            "threshold regime: K4 did not walk by its warp design")
    require(backends_thr.get("spin") == "cluster",
            "threshold regime: the spin-down did not run on its cluster "
            "design")
    # up to 2 of the Viterbi lanes again: kernels vs plain versions
    viterbi_lanes_check(iq, nframes, thr, rec, "threshold regime")
    # K5/K6 timed at the batch the main path's fallback ran
    checks.update(viterbi_cycle_check(dev, int(vit.size), seed=25))
    profile_block(iq, nframes, thr, "threshold")
    del iq
    torch.cuda.empty_cache()

    # ---- phases 6-8: wideband, edge carrier, pipelined block stream
    for path_launches in (phase_wideband(dev, cfg), phase_edge(dev)):
        for k, v in path_launches.items():
            launches[k] += v
    phase_pipelined(dev, nsamples, nframes, cfg)

    # ---- phases 9-10: the fused pm scan (K9), the narrowband path (K8)
    for path_launches in (phase_fused_scan(dev, nsamples, nframes, pm, sym,
                                           rec_thr),
                          phase_narrowband(dev)):
        for k, v in path_launches.items():
            launches[k] += v

    # ---- phase 11: the classic Viterbi API (K10)
    t0 = time.perf_counter()
    checks.update(check_viterbi_acs(
        dev, max(int((rec_thr.decoder == DECODER_VITERBI).sum()), 1)))
    for path_launches in (classic_threshold(dev, nsamples, nframes, pm, sym,
                                            rec_thr),
                          classic_vdecode(dev), classic_icesync(dev)):
        for k, v in path_launches.items():
            launches[k] += v
    torch.cuda.empty_cache()
    classic_vtest()
    log(f"phase 11: ok ({time.perf_counter() - t0:.1f} s)")

    # ---- phases 13-15: the streaming chain with its checkpoint, the stage
    # tools, clock tracking (run before phase 12, whose profiler must come
    # last)
    new_launches: dict = {}
    for path_launches in (phase_stream(dev, nsamples, pm, sym, rec_thr,
                                       nframes),
                          phase_cli(dev)):
        for k, v in path_launches.items():
            launches[k] += v
            new_launches[k] = new_launches.get(k, 0) + v
    for k in ("pm_locked", "spin_down", "prefix_sum", "fano_walk", "viterbi_a",
              "viterbi_b", "viterbi_acs"):
        require(new_launches.get(k, 0) > 0,
                f"phases 13-14: kernel {k} never launched")
    track_launches = phase_tracking(dev, nsamples, pm, sym)
    for k, v in track_launches.items():
        launches[k] += v

    # ---- phases 16-19: the wide Fano walk, the native golden library,
    # parallel/ on logical shards, the float64 pm branch (before phase 12
    # as well)
    wide_launches, checks["fano_walk_wide"] = phase_wide_fano(dev)
    phase_native(dev)
    parallel_launches = phase_parallel(dev, nsamples, nframes, cfg)
    float64_launches = phase_float64(dev, nsamples, nframes, pm, sym)
    for path_launches in (wide_launches, parallel_launches, float64_launches):
        for k, v in path_launches.items():
            launches[k] += v
    torch.cuda.empty_cache()

    # ---- phase 20: the 2048 bps and 16 bps subcarrier modes (before
    # phase 12 as well)
    modes_launches = phase_modes(dev)
    for k, v in modes_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()

    # ---- phase 21: the channel statistics through K4, K10, K5 + K6
    # (before phase 12 as well)
    stats_launches = phase_statistics(dev)
    for k, v in stats_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()

    # ---- phase 12: device times under torch.profiler, after every timed run
    profile_kernels(dev, checks, max(int((rec_thr.decoder ==
                                          DECODER_VITERBI).sum()), 1))
    for k, v in launches.items():
        require(v > 0, f"kernel {k} never launched on the main path")

    src = f"{PKG}/csrc/"
    meta = {
        "pm_locked": ("carrier.cu", "isee3_decoder_tpu/ops/carrier_pallas.py:687"),
        "spin_down": ("carrier.cu", "isee3_decoder_tpu/ops/carrier_pallas.py:214"),
        "prefix_sum": ("prefix.cu", "isee3_decoder_tpu/ops/prefix_pallas.py:65"),
        "fano_walk": ("fano.cu", "isee3_decoder_tpu/ops/fano_pallas.py:106"),
        "viterbi_a": ("viterbi.cu",
                      "isee3_decoder_tpu/ops/viterbi_pallas_fused.py:157"),
        "viterbi_b": ("viterbi.cu",
                      "isee3_decoder_tpu/ops/viterbi_pallas_fused.py:203"),
        "channelize": ("channelizer.cu",
                       "isee3_decoder_tpu/ops/channelizer_pallas.py:177"),
        "channelize2": ("channelizer.cu",
                        "isee3_decoder_tpu/ops/channelizer_pallas.py:213"),
        "windowed_dft": ("carrier.cu",
                         "isee3_decoder_tpu/ops/carrier_pallas.py:63"),
        "pm_scan": ("carrier.cu", "isee3_decoder_tpu/ops/carrier_pallas.py:363"),
        "viterbi_acs": ("viterbi_acs.cu",
                        "isee3_decoder_tpu/ops/viterbi_pallas.py:39"),
        # K4's wide variant: the XLA wide walk of the JAX package
        "fano_walk_wide": ("fano.cu", "isee3_decoder_tpu/ops/fano.py:528"),
    }
    launches["fano_walk_wide"] = wide_launches["fano_walk"]
    # kernels whose design was rebuilt for the card, as the line names it
    designs = {
        "viterbi_b": "register stages: j steps by warp shuffles, decisions "
                     "by lane ballots, the row as int16 pairs",
        "fano_walk": "one warp per lane: its metrics and tape in shared "
                     "memory, backtrack runs by ballots",
        "fano_walk_wide": "K4 on a 64-bit state word (24-byte tape "
                          "records): one warp per lane, as K4",
        "spin_down": "cluster: one thread-block cluster per channel, one "
                     "read and one sincosf a sample, the moments across the "
                     "cluster by distributed shared memory",
        "prefix_sum": "tiles along each channel with a decoupled look-back: "
                      "persistent blocks take tiles by ticket, two cp.async "
                      "stages, 16-byte stores from a padded staging buffer",
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": src + meta[name][0],
            "replaces": meta[name][1],
            **({"design": designs[name]} if name in designs else {}),
            "launches": launches[name],
            "stream_cli_launches": new_launches.get(name, 0),
            "tracking_launches": track_launches.get(name, 0),
            "modes_launches": modes_launches.get(name, 0),
            "stats_launches": stats_launches.get(name, 0),
            **{key: checks[name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            **{key: checks[name][key] for key in (
                "device_ms", "library_device_ms", "search_device_ms",
                "spin_device_ms", "search_bound_ms", "search_library_ms",
                "search_library_device_ms", "latency_bound_ms",
                "max_lane_steps", "ns_per_step", "thread_ms",
                "thread_ns_per_step", "two_pass_ms", "narrowband_ms",
                "narrowband_plain_ms", "narrowband_library_ms",
                "narrowband_bound_ms", "codes")
               if key in checks[name]},
        }
        for name in meta
    ]
    log(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
