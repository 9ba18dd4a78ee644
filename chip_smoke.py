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
channel rate; and three blocks through ``receive_blocks_pipelined``.
Fails (non-zero exit, no result line) without a CUDA device, on a build
error, or when any check fails.  Imports no JAX.

Output, in order: one line per phase; the card's name and power limit
(nvidia-smi); one JSON line with every kernel's launches on the main
path, its error against the plain version, its time, the plain
version's, the least time the card could take (``bound_ms``: the larger
of the bytes it must move over the HBM rate and the operations it must
do over the peak rate of their type, for this run's inputs) and, where
one PyTorch call computes the same function, that call's time; last,
the JSON line {"ok": true, "device": {...}}.  Phases 3 to 6 each end
with a profile line: per-stage milliseconds of three runs of the block,
and the device busy time of one run under torch.profiler.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "isee3_decoder_tpu_torch"

# bench configuration (the JAX package's bench.py)
SAMPRATE = 250_000.0
SYMRATE = 1024.0
NCHAN = 128
NFRAMES_TX = 4
NOISE_CLEAN = 2500.0
NOISE_MID = 50000.0
NOISE_THRESHOLD = 110000.0

# Peak rates of one H100 SXM at its full 700 W (NVIDIA's data sheet; the
# card's own power limit is printed beside the results).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # FMA counted as two operations
# INT32 lanes: 132 SMs x 64 x 1.98 GHz boost clock
I32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per ACS pair in csrc/viterbi.cu (two AND+POPC+AND+
# XOR parities, symbol selects and add, 510-mt, four adds, two compares,
# two selects) and per Fano micro-step in csrc/fano.cu (forward look,
# threshold update, encoder step with two parities, metric selects,
# bookkeeping) — counted from the kernels' source, address arithmetic
# excluded
ACS_OPS_PER_PAIR = 20
FANO_OPS_PER_STEP = 30

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


def bound(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bench_block(dev, nchan: int, nsamples: int, noise_std: float, seed: int,
                frames_seed: int = 0):
    """(frames (F, 128) uint8, (nchan, 2*nsamples) int16 raw IQ on dev):
    the same frames on every channel, carriers 20 kHz + 137 Hz·i."""
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
    carriers = torch.as_tensor(20_000.0 + 137.0 * np.arange(nchan),
                               dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    iq = synthesize_iq_device(frames_dev, carriers, gen, nsamples,
                              samprate=SAMPRATE, symrate=SYMRATE,
                              noise_std=noise_std)
    return frames, to_raw_int16(iq), carriers


def check_kernels(dev, nchan: int = NCHAN, n_lanes: int = 256) -> dict:
    """Phase 2: every kernel against its plain version on the same
    inputs, at the main path's shapes.  Returns per-kernel records."""
    import torch

    from isee3_decoder_tpu_torch.config import FRAMEBITS, SYNC_STATE
    from isee3_decoder_tpu_torch.models.decode import DecodeConfig, _tail
    from isee3_decoder_tpu_torch.ops import carrier, carrier_cuda, fano_cuda
    from isee3_decoder_tpu_torch.ops import prefix_cuda
    from isee3_decoder_tpu_torch.ops.encode import bytes_to_bits, encode_bits
    from isee3_decoder_tpu_torch.ops.fano import FanoParams, _walk_inputs

    out = {}
    cfg = carrier.PMConfig(samprate=SAMPRATE, binsize=4.0, search_width=200.0)
    n = cfg.fftsize
    _, raw, carriers = bench_block(dev, nchan, n, NOISE_CLEAN, seed=5)
    packed = carrier.pack_raw(raw)

    # ---- K1: locked pm block (tolerances of tests/test_carrier_raw.py)
    carry = carrier.PMCarry(search_center=carriers,
                            cn0=torch.full_like(carriers, 60.0))
    require(carrier._fast_search_ok(carry, cfg), "K1 inputs not locked")
    first, last = carrier._search_window(carry.search_center, carry.cn0, cfg)
    K = carrier._window_bins(cfg)
    args = (packed, first - 1, last - first, K, cfg.samprate,
            cfg.actual_binsize)
    bb_k, f_k, a_k, c_k = carrier_cuda.pm_locked_fused(*args)
    bb_p, f_p, a_p, c_p = carrier_cuda.pm_locked_plain(*args)
    pk_k = torch.round(f_k / cfg.actual_binsize)
    pk_p = torch.round(f_p / cfg.actual_binsize)
    err = int((bb_k.int() - bb_p.int()).abs().max())
    log(f"  K1 pm_locked: peak bins equal {bool((pk_k == pk_p).all())}, "
        f"max |dfreq| {float((f_k - f_p).abs().max()):.3e} Hz, "
        f"max amp rel {float(((a_k - a_p) / a_p).abs().max()):.3e}, "
        f"max |dcn0| {float((c_k - c_p).abs().max()):.3e} dB, "
        f"max |dbaseband| {err} LSB")
    require(bool((pk_k == pk_p).all()), "K1 peak bins differ")
    require(float((f_k - f_p).abs().max()) <= 5e-3, "K1 freq off")
    require(torch.allclose(a_k, a_p, rtol=1e-5, atol=0), "K1 amp off")
    require(float((c_k - c_p).abs().max()) <= 1e-2, "K1 cn0 off")
    require(err <= 1, "K1 baseband off by more than 1 LSB")
    # reads the packed IQ, writes the int16 baseband; a complex MAC (8
    # float32 operations) per sample and searched bin
    out["pm_locked"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: carrier_cuda.pm_locked_fused(*args), 20),
        plain_ms=cuda_ms(lambda: carrier_cuda.pm_locked_plain(*args), 5),
        library_ms=None,
        **bound(nchan * n * (4 + 2), 8.0 * K * n * nchan, F32_OPS_PER_S),
    )

    # ---- K2: spin-down at a given carrier
    f = carriers + 0.125
    bb_k, a_k, c_k = carrier_cuda.spin_down_fused(packed, f, cfg.samprate)
    bb_p, a_p, c_p = carrier_cuda.spin_down_plain(packed, f, cfg.samprate)
    err = int((bb_k.int() - bb_p.int()).abs().max())
    log(f"  K2 spin_down: max amp rel "
        f"{float(((a_k - a_p) / a_p).abs().max()):.3e}, max |dcn0| "
        f"{float((c_k - c_p).abs().max()):.3e} dB, max |dbaseband| {err} LSB")
    require(torch.allclose(a_k, a_p, rtol=1e-5, atol=0), "K2 amp off")
    require(float((c_k - c_p).abs().max()) <= 1e-2, "K2 cn0 off")
    require(err <= 1, "K2 baseband off by more than 1 LSB")
    out["spin_down"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: carrier_cuda.spin_down_fused(packed, f,
                                                        cfg.samprate), 20),
        plain_ms=cuda_ms(lambda: carrier_cuda.spin_down_plain(
            packed, f, cfg.samprate), 5),
        library_ms=None,
        # phase step and complex rotation per sample (sincos not counted)
        **bound(nchan * n * (4 + 2), 8.0 * nchan * n, F32_OPS_PER_S),
    )
    del packed, raw

    # ---- K3: prefix sum, exact, at T=32 blocks (8.4 s of signal)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bb = torch.randint(-32768, 32768, (32, nchan, n), generator=gen,
                       device=dev, dtype=torch.int32).to(torch.int16)
    cs_k = prefix_cuda.prefix_sum_blocks(bb, tail=1)
    cs_p = prefix_cuda.prefix_sum_blocks_plain(bb, tail=1)
    err = int((cs_k.long() - cs_p.long()).abs().max())
    log(f"  K3 prefix_sum: {tuple(cs_k.shape)} max |diff| {err}")
    require(err == 0, "K3 prefix sum not exact")
    # the library yardstick: one torch.cumsum over the same values in the
    # output's (B, T*n) order (inclusive, no tail column), timed only here
    flat = bb.permute(1, 0, 2).reshape(nchan, -1).contiguous()
    out["prefix_sum"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: prefix_cuda.prefix_sum_blocks(bb, tail=1), 10),
        plain_ms=cuda_ms(lambda: prefix_cuda.prefix_sum_blocks_plain(bb, 1), 3),
        library_ms=cuda_ms(lambda: torch.cumsum(flat, dim=1, dtype=torch.int32),
                           10),
        **bound(bb.numel() * 2 + cs_k.numel() * 4, bb.numel(), I32_OPS_PER_S),
    )
    del bb, cs_k, cs_p, flat

    # ---- K4: the Fano walk alone — metric precompute and root setup are
    # done once, outside the timed calls; bits and [np, gamma, cycles, t]
    # exact
    dcfg = DecodeConfig()
    mettab = torch.as_tensor(dcfg.mettab(), device=dev)
    rng = np.random.default_rng(4)

    def walk_inputs(lanes: int, sigma: float):
        from isee3_decoder_tpu_torch.utils.devicesignal import random_frames

        data = torch.as_tensor(random_frames(rng, lanes), device=dev)
        syms, _ = encode_bits(bytes_to_bits(data), SYNC_STATE, dcfg.code)
        noise = torch.as_tensor(rng.normal(0.0, sigma, syms.shape),
                                dtype=torch.float32, device=dev)
        soft = torch.clamp(torch.round((syms.float() * 2 - 1) * 100 + noise)
                           + 128, 0, 255).to(torch.uint8)
        return _walk_inputs(soft, mettab, FRAMEBITS, SYNC_STATE,
                            _tail(dcfg.code), dcfg.code, None)

    plain_fano_ms = 0.0
    cases = ((walk_inputs(n_lanes, 75.0), dcfg.fano_params_tier1()),
             (walk_inputs(16, 110.0), FanoParams(dcfg.fano_delta, 2)))
    for (m4, regs), params in cases:
        args = (m4, regs, dcfg.code, params.delta, params.maxcycles)
        bits_k, st_k = fano_cuda.fano_walk(*args)
        start, end = _events()
        start.record()
        bits_p, st_p = fano_cuda.fano_walk_plain(*args)  # slow: timed once
        end.record()
        torch.cuda.synchronize()
        if m4.shape[0] == n_lanes:
            plain_fano_ms = start.elapsed_time(end)
        require(torch.equal(bits_k, bits_p), "K4 bits differ")
        require(torch.equal(st_k, st_p), "K4 np/gamma/cycles/t differ")
        nfail = int((st_k[:, 0] + 1 != FRAMEBITS).sum())
        log(f"  K4 fano_walk: {m4.shape[0]} lanes at {params.maxcycles} "
            f"cycles/bit: identical; {nfail} timed out, max cycles "
            f"{int(st_k[:, 2].max())}")
        if m4.shape[0] == 16:
            require(nfail > 0, "K4 small batch has no timed-out lane")
    (m4, regs), params = cases[0]
    _, st = fano_cuda.fano_walk(m4, regs, dcfg.code, params.delta,
                                params.maxcycles)
    steps = int(st[:, 2].sum())  # micro-steps this run's lanes walk
    out["fano_walk"] = dict(
        max_abs_err=0,
        ms=cuda_ms(lambda: fano_cuda.fano_walk(
            m4, regs, dcfg.code, params.delta, params.maxcycles), 5),
        plain_ms=plain_fano_ms,
        library_ms=None,
        **bound(m4.numel() * 4 + regs.numel() * 4 + m4.shape[0] * m4.shape[1]
                + st.numel() * 4, steps * FANO_OPS_PER_STEP, I32_OPS_PER_S),
    )
    out.update(check_viterbi(dev))
    return out


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
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    m0 = ri(0, 12000, (B, n)).to(torch.int16)
    syms = ri(0, 256, (B, 2 * w))
    sa, sb = syms[:, : 2 * rowb].contiguous(), syms[:, 2 * rowb :].contiguous()
    base = ri(1, 600, (B,))
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
                    B * rowb * (n // 2) * ACS_OPS_PER_PAIR, I32_OPS_PER_S),
        ),
        "viterbi_b": dict(
            max_abs_err=0,
            ms=cuda_ms(lambda: vc.cycle_b(mk, sb, code, w - rowb, db), 10),
            plain_ms=cuda_ms(lambda: vc.cycle_b_plain(mp, sb, code, w - rowb,
                                                      db), 2),
            library_ms=None,
            **bound(B * (4 * n + (w - rowb) * n // 8 + (1 << rowb) * 4)
                    + sb.numel() * 4, B * (w - rowb) * (n // 2)
                    * ACS_OPS_PER_PAIR, I32_OPS_PER_S),
        ),
    }
    log(f"  K5/K6 one K=24 cycle at B={B}: exact; K5 "
        f"{rec['viterbi_a']['ms']:.3f} ms (plain {rec['viterbi_a']['plain_ms']:.3f},"
        f" bound {rec['viterbi_a']['bound_ms']:.3f}), K6 "
        f"{rec['viterbi_b']['ms']:.3f} ms (plain {rec['viterbi_b']['plain_ms']:.3f},"
        f" bound {rec['viterbi_b']['bound_ms']:.3f})")
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
    from isee3_decoder_tpu_torch.ops.carrier import init_carry, pm_demod_scan
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
    _, pm_out = pm_demod_scan(init_carry(B, cfg.pm, device=iq.device), blocks,
                              cfg.pm)
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
    leaves whole tiles, a partial last tile and a partial last frame, then
    at the wideband block's shape, where both are timed.  At most 1 LSB
    apart on under 1 % of the samples: float32 rounding at truncation
    boundaries."""
    import torch

    from isee3_decoder_tpu_torch.ops import channelizer_cuda as cc

    P = TAPS_PER_BRANCH
    names = {1: "channelize", 2: "channelize2"}
    for os_, nfr, extra in ((1, 4096 + P - 1, 0), (2, 4096 + P, 0),
                            (1, 3000, 5), (2, 3001, nchan // 2 + 1)):
        packed = random_packed(dev, nfr * nchan + extra, seed=nfr)
        got = cc.channelize_raw_fused(packed, nchan, P, oversample=os_)
        want = cc.channelize_raw_plain(packed, nchan, P, oversample=os_)
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"K7 {names[os_]}: shape {tuple(got.shape)} vs plain "
                f"{tuple(want.shape)}")
        worst, share = raw_diff(got, want)
        log(f"  K7 {names[os_]}: {nfr} frames + {extra} words -> "
            f"{tuple(got.shape)}, max |diff| {worst} LSB, {share:.5%} differ")
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
        log(f"  K7 {names[os_]} at {nchan} x {frames} frames: max |diff| "
            f"{worst} LSB, {share:.5%} differ; {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']})")
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


def phase_pipelined(dev, nsamples: int, nframes: int, cfg, nblocks: int = 4):
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
    log(f"phase 8 pipelined: {nblocks} clean blocks, depth 2 == receive_block "
        f"block by block; ms per block: plain loop {_ms(walls['loop'])}, "
        f"pipelined {_ms(walls['pipelined'])} "
        f"({time.perf_counter() - t0:.1f} s)")


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
    from isee3_decoder_tpu_torch.config import FRAMESYMBOLS
    from isee3_decoder_tpu_torch.models.decode import (
        DECODER_VITERBI,
        DecodeConfig,
        _viterbi_decode,
    )
    from isee3_decoder_tpu_torch.models.pipeline import (
        PipelineConfig,
        demod_to_symbols,
        receive_block,
        receive_block_device_soft,
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
    profile_block(iq, nframes, mid, "mid")
    del iq

    # ---- phase 5: main path, threshold regime (the Viterbi fallback)
    t0 = time.perf_counter()
    thr = PipelineConfig(pm=pm, sym=sym, decode=DecodeConfig())
    frames, iq, _ = bench_block(dev, NCHAN, nsamples, NOISE_THRESHOLD, seed=11)
    receive_block(iq, nframes, thr)  # warm-up
    rec, t_thr, launches_thr, backends_thr = timed_receive(iq, nframes, thr)
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
    # up to 2 of the Viterbi lanes again: kernels vs plain versions
    _, soft = receive_block_device_soft(iq, nframes, FRAMESYMBOLS, thr)
    lanes = vit[:2]
    fsyms = torch.stack([soft[lane // nframes, s : s + FRAMESYMBOLS]
                         for lane, s in zip(lanes, rec.start_symbol[lanes])])
    bits_k = _viterbi_decode(fsyms, thr.decode)
    with _kernels.plain_reference():
        bits_p = _viterbi_decode(fsyms, thr.decode)
    require(torch.equal(bits_k, bits_p),
            "threshold regime: Viterbi lanes differ between kernels and plain")
    del soft, fsyms
    log(f"  {lanes.size} Viterbi lane(s) kernel path == plain path")
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
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": src + meta[name][0],
            "replaces": meta[name][1],
            "launches": launches[name],
            **{key: checks[name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
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
