"""Time kernels K1, K2, K3, K4, K7a, K7b, K8, K5, K6 and K9 of one
checkout of the port, for comparing two trees in turns on one card.

    python isee3_decoder_tpu_torch/utils/kernel_turns.py --tree DIR [--label L]
        [--kernels k8,k5,k6,k9,k1,k2,k3,k3nb,k4,k7a,k7b]

imports ``isee3_decoder_tpu_torch`` from the checkout at DIR (this file
imports nothing of the package before that, so it can time an older
tree), builds its kernels, and prints one JSON line:

- K8 with its peak pass (``carrier_cuda.windowed_search_raw``) at the
  narrowband path's shape, 128 x 4096, K = 53: CUDA-event ms per call
  over 50 calls, and device ms per call and kernels per call under
  torch.profiler; ``torch.fft.fft`` over all 4096 bins of the same block
  the same two ways;
- K5 (``viterbi_cuda.cycle_a``) over a whole K = 24 row phase at B = 10,
  the threshold block's batch: event ms and device ms per launch;
- K6 (``viterbi_cuda.cycle_b``) over a whole K = 24 column phase (15
  steps) at B = 10: event ms and device ms per launch;
- K9 (``carrier_cuda.pm_scan_locked_fused``, the pm scan in one launch)
  at the bench shape, 128 x 32 x 65,536, K = 107, on a clean block
  (noise 2500): event ms and device ms per launch;
- K1 (``carrier_cuda.pm_locked_fused``, one locked pm block) at the bench
  shape, 128 x 65,536, K = 107, on a clean block: event ms and device ms
  per call, and the device ms of each kernel it launches, and of its
  search launch and its spin-down apart (``search_device_ms``,
  ``spin_device_ms``);
- K2 (``carrier_cuda.spin_down_fused``, the spin-down at a given carrier)
  at the bench shape, 128 x 65,536, on a clean block of carriers 20 kHz +
  137 Hz·i spun down 0.125 Hz off them, without and with flip and a
  40 Hz/s Doppler rate (``k2``, ``k2fd``), and at the narrowband path's
  shape, 128 x 4096 (``k2nb``): event ms and device ms per call, and the
  spin design the wrapper reports;
- K4 (``fano_cuda.fano_walk``, the Fano walk alone, MCQLI-24 frames of
  1024 bits from ``np.random.default_rng(4)`` as chip_smoke.py phase 2
  builds them) in three cases: (a) 256 lanes at sigma 75 and the tier-1
  cap, 12 cycles/bit; (b) 16 lanes at sigma 110 and the full budget,
  100 cycles/bit, at least one lane timing out; (c) the slowest lane of
  (a) alone.  Event ms and device ms per call, the largest lane's
  micro-steps and ns per micro-step (event ms over those steps); (c)
  against (a) separates one micro-step's latency from the cost of lanes
  sharing a warp;
- K7a and K7b (``channelizer_cuda.channelize_raw_fused`` at oversample 1
  and 2, 8 taps a branch) on one packed capture of 128 slots x 2^21
  frames (1 GiB, I and Q uniform in +-20000), and K7b also at the edge
  path's shape (``k7b_edge``: 32 slots, the 26,176,000 words of
  chip_smoke.py phase 7): event ms and device ms per call, the launch
  plan where the tree has one, and the bytes bound (every word read
  once, every (I, Q) pair written once, at 3.35 TB/s);
- K3 (``prefix_cuda.prefix_sum_blocks``, tail = 1) at the bench shape,
  32 x 128 x 65,536 (``k3``), and at the narrowband path's, 67 x 128 x
  4096 (``k3nb``), on random int16 from a seeded torch.Generator: event
  ms and device ms per call (the workspace's memset included; ``kernels``
  has it apart), the launch plan where the tree has one, the bytes bound
  (2 bytes read and 4 written a sample, 4 a tail column), and
  ``torch.cumsum(..., dtype=torch.int32)`` over the same values in (B,
  T·n) order timed both ways (``cumsum_ms``, ``cumsum_device_ms``), the
  library yardstick.

Each kernel's result is held against its plain version first (K8: peak
bins equal, frequency within 5e-3 Hz, bins within 1e-5 of the largest;
K5: bit for bit; K6: metrics, decision words and row minima bit for
bit; K9: ok lanes and locks equal, frequency and centre
within 5e-3 Hz, C/N0 within 1e-2 dB, baseband within 1 LSB; K1:
frequency within 5e-3 Hz, amplitude within rtol 1e-5, C/N0 within 1e-2
dB, baseband within 1 LSB; K2: amplitude within rtol 1e-5, C/N0
within 1e-2 dB, baseband within 1 LSB; K4: bits and [np, gamma, cycles, t] bit for
bit, against ``fano_walk_plain`` run on the CPU once per set of inputs
and kept in build/kernel_turns/ for the later turns of a call; K7a/K7b:
at most 1 LSB from ``channelize_raw_plain`` on under 1 % of the values;
K3: equal to ``prefix_sum_blocks_plain``).
Every
CUDA-event time is taken before the first torch.profiler session, which
slows every later launch of the process.  Needs a CUDA card; the card's nvidia-smi name and power limit
are in the line.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def _event_ms(torch, fn, reps: int) -> float:
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


def _device_ms(torch, fn, reps: int, warmup: int = 5) -> tuple[float, float, dict]:
    """(device ms per call summed over every kernel, kernels per call,
    device ms per call of each kernel by name) under torch.profiler, over
    reps calls after ``warmup`` calls in the schedule's warm-up (tracing
    on, events dropped: the first launches after the tracing starts may
    go unrecorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    count = 0

    def ready(prof):
        nonlocal count
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms = (e.time_range.end - e.time_range.start) / 1e3 / reps
                by_name[e.name] = by_name.get(e.name, 0.0) + ms
                count += 1

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=reps,
                                   repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(warmup + reps):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return sum(by_name.values()), count / reps, by_name


KERNELS = ("k8", "k5", "k6", "k9", "k1", "k2", "k3", "k3nb", "k4", "k7a",
           "k7b")
# K3's shapes: the bench block's 32 pm blocks of 65,536, and the
# narrowband block's 67 of 4096, 128 channels each
K3_SHAPES = {"k3": (32, 128, 65536), "k3nb": (67, 128, 4096)}
# the edge path's capture (chip_smoke.py phase 7): 3 frames of 2048
# symbols and 400 more at 1024 sym/s, 4.096 Msps
EDGE_WORDS = int((3 * 2048 + 400) / 1024.0 * 4_096_000.0)
HBM_BYTES_PER_S = 3.35e12
# kernel names of the spin-down in any tree: the two passes (older trees,
# and the "two_pass" design) and the cluster kernel
SPIN_KERNELS = ("moments_kernel", "emit_kernel", "spin_cluster_kernel")


def k4_walk_inputs(torch, np, dev, lanes: int = 256):
    """K4's inputs as chip_smoke.py phase 2 and this tool build them:
    MCQLI-24 frames of 1024 bits from np.random.default_rng(4), BPSK at
    amplitude 100 plus Gaussian noise, quantized to offset-binary soft
    symbols → (DecodeConfig(), (metrics4, regs) of ``lanes`` lanes at
    sigma 75, (metrics4, regs) of 16 lanes at sigma 110)."""
    from isee3_decoder_tpu_torch.config import FRAMEBITS, SYNC_STATE
    from isee3_decoder_tpu_torch.models.decode import DecodeConfig, _tail
    from isee3_decoder_tpu_torch.ops.encode import bytes_to_bits, encode_bits
    from isee3_decoder_tpu_torch.ops.fano import _walk_inputs
    from isee3_decoder_tpu_torch.utils.devicesignal import random_frames

    dcfg = DecodeConfig()
    mettab = torch.as_tensor(dcfg.mettab(), device=dev)
    rng = np.random.default_rng(4)

    def walk_inputs(n: int, sigma: float):
        data = torch.as_tensor(random_frames(rng, n), device=dev)
        syms, _ = encode_bits(bytes_to_bits(data), SYNC_STATE, dcfg.code)
        noise = torch.as_tensor(rng.normal(0.0, sigma, syms.shape),
                                dtype=torch.float32, device=dev)
        soft = torch.clamp(torch.round((syms.float() * 2 - 1) * 100 + noise)
                           + 128, 0, 255).to(torch.uint8)
        return _walk_inputs(soft, mettab, FRAMEBITS, SYNC_STATE,
                            _tail(dcfg.code), dcfg.code, None)

    return dcfg, walk_inputs(lanes, 75.0), walk_inputs(16, 110.0)


def _k4_plain(torch, fano_cuda, m4, regs, code, delta, maxcycles):
    """fano_walk_plain's (bits, stats) for these inputs, run on the CPU
    once and kept in build/kernel_turns/ under a hash of the inputs, so
    the later turns of a call load it."""
    import hashlib

    h = hashlib.sha256()
    for t in (m4, regs):
        h.update(t.cpu().numpy().tobytes())
    h.update(f"{code.name} {delta} {maxcycles}".encode())
    cache = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "kernel_turns" / f"k4_plain_{h.hexdigest()[:16]}.pt")
    if cache.exists():
        bits, stats = torch.load(cache)
    else:
        bits, stats = fano_cuda.fano_walk_plain(m4.cpu(), regs.cpu(), code,
                                                delta, maxcycles)
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_suffix(f".{os.getpid()}.tmp")
        torch.save((bits, stats), tmp)
        os.replace(tmp, cache)
    return bits.to(m4.device), stats.to(m4.device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="checkout to import")
    ap.add_argument("--label", default=None)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    args_cli = ap.parse_args()
    want = set(args_cli.kernels.split(","))
    if not want <= set(KERNELS):
        ap.error(f"unknown kernels {sorted(want - set(KERNELS))}")
    sys.path.insert(0, str(pathlib.Path(args_cli.tree).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import DEFAULT_CODE as code
    from isee3_decoder_tpu_torch.ops import carrier, carrier_cuda, fano_cuda
    from isee3_decoder_tpu_torch.ops import viterbi_cuda as vc
    from isee3_decoder_tpu_torch.utils.devicesignal import (
        random_frames,
        synthesize_iq_device,
        to_raw_int16,
    )

    dev = torch.device("cuda", 0)
    _kernels.lib()
    out = {"label": args_cli.label or args_cli.tree, "card": _card(),
           "package": str(pathlib.Path(_kernels.__file__).parent)}
    gen = torch.Generator(device=dev)
    # (name, function, reps, record, key prefix: "" for the kernel, else a
    # library yardstick's): every event time is taken first, in this
    # order, then every device time
    timed = []
    oks = []

    # ---- K8 at the narrowband path's shape
    if "k8" in want:
        B = 128
        cfg = carrier.PMConfig(samprate=32768.0, binsize=8.0,
                               search_width=200.0)
        n, K = cfg.fftsize, carrier._window_bins(cfg)
        gen.manual_seed(8)
        frames = torch.as_tensor(random_frames(np.random.default_rng(8), B),
                                 device=dev)[:, None, :]
        freqs = torch.as_tensor(4000.0 + 37.0 * np.arange(B),
                                dtype=torch.float32, device=dev)
        iq = synthesize_iq_device(frames, freqs, gen, n, samprate=cfg.samprate,
                                  noise_std=2500.0)
        raw = to_raw_int16(iq)
        packed = carrier.pack_raw(raw)
        carry = carrier.PMCarry(search_center=freqs,
                                cn0=torch.full_like(freqs, 60.0))
        first, last = carrier._search_window(carry.search_center, carry.cn0,
                                              cfg)
        search = (packed, first - 1, last - first, K, cfg.samprate,
                  cfg.actual_binsize)
        s_k, f_k, pk_k = carrier_cuda.windowed_search_raw(*search)
        s_p, f_p, pk_p = carrier_cuda.windowed_search_raw_plain(*search)
        rel = float((s_k - s_p).abs().max()) / float(s_p.abs().max())
        ok8 = (bool(torch.equal(pk_k, pk_p)) and rel <= 1e-5
               and float((f_k - f_p).abs().max()) <= 5e-3)
        x = carrier.iq_from_interleaved(raw)

        def k8():
            carrier_cuda.windowed_search_raw(*search)

        def fft():
            torch.fft.fft(x, dim=-1)

        out["k8"] = {"shape": f"{B} x {n}, K = {K}", "ok": ok8,
                     "rel_err": rel}
        timed += [("k8", k8, 50, out["k8"], ""),
                  ("k8", fft, 50, out["k8"], "fft_")]
        oks.append(ok8)

    # ---- K5 over a whole K = 24 row phase at the threshold block's batch
    B = 10
    w, rowb, _ = vc._geometry(code)
    if "k5" in want:
        gen.manual_seed(25)
        m0 = torch.randint(0, 12000, (B, code.nstates), generator=gen,
                           device=dev, dtype=torch.int32).to(torch.int16)
        syms = torch.randint(0, 256, (B, 2 * rowb), generator=gen, device=dev,
                             dtype=torch.int32)
        base = torch.randint(1, 600, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
        mk, mp = m0.clone(), m0.clone()
        _, dk = vc.cycle_a(mk, syms, code, rowb, base)
        _, dp = vc.cycle_a_plain(mp, syms, code, rowb, base)
        ok5 = bool(torch.equal(mk, mp) and torch.equal(dk, dp))
        da = torch.empty((B, rowb, code.nstates // 32), dtype=torch.int32,
                         device=dev)

        def k5():
            vc.cycle_a(mk, syms, code, rowb, base, da)

        out["k5"] = {"shape": f"K = 24, B = {B}, {rowb} steps", "ok": ok5}
        timed.append(("k5", k5, 20, out["k5"], ""))
        oks.append(ok5)
        del dk, dp, m0

    # ---- K6 over a whole K = 24 column phase at the same batch
    if "k6" in want:
        nb = w - rowb
        gen.manual_seed(26)
        m0 = torch.randint(0, 12000, (B, code.nstates), generator=gen,
                           device=dev, dtype=torch.int32).to(torch.int16)
        sb = torch.randint(0, 256, (B, 2 * nb), generator=gen, device=dev,
                           dtype=torch.int32)
        m6, m6p = m0.clone(), m0.clone()
        _, dk, nk = vc.cycle_b(m6, sb, code, nb)
        _, dp, npl = vc.cycle_b_plain(m6p, sb, code, nb)
        ok6 = bool(torch.equal(m6, m6p) and torch.equal(dk, dp)
                   and torch.equal(nk, npl))
        del dk, dp, m6p, m0
        db = torch.empty((B, nb, code.nstates // 32), dtype=torch.int32,
                         device=dev)

        def k6():
            vc.cycle_b(m6, sb, code, nb, db)

        out["k6"] = {"shape": f"K = 24, B = {B}, {nb} steps", "ok": ok6}
        timed.append(("k6", k6, 20, out["k6"], ""))
        oks.append(ok6)

    # ---- K9, K1 and K2 at the bench shape
    if want & {"k9", "k1", "k2"}:
        B, T = 128, 32
        cfg = carrier.PMConfig(samprate=250_000.0, binsize=4.0,
                               search_width=200.0)
        n, K = cfg.fftsize, carrier._window_bins(cfg)
        frames = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
            random_frames(np.random.default_rng(0), 4), (B, 4, 128))),
            device=dev)
        freqs = torch.as_tensor(20_000.0 + 137.0 * np.arange(B),
                                dtype=torch.float32, device=dev)
    if "k9" in want:
        gen.manual_seed(9)
        iq = synthesize_iq_device(frames, freqs, gen, T * n,
                                  samprate=cfg.samprate, symrate=1024.0,
                                  noise_std=2500.0)
        blocks = to_raw_int16(iq).reshape(B, T, 2 * n)
        del iq
        carry1, out0 = carrier.pm_demod_block_raw(
            carrier.init_carry(B, cfg, device=dev), blocks[:, 0], cfg)
        init = torch.stack([torch.zeros_like(out0.cn0), out0.cn0,
                            out0.carrier_freq, carry1.search_center], dim=1)
        args = (carrier.pack_raw(blocks), out0.baseband, init, cfg.samprate,
                cfg.actual_binsize, cfg.search_width, cfg.cn0_threshold, K)
        del blocks
        cs_k, st_k, _ = carrier_cuda.pm_scan_locked_fused(*args, tail=1)
        cs_p, st_p, _ = carrier_cuda.pm_scan_locked_plain(*args, tail=1)
        bb_err = int(((cs_k[:, 1:] - cs_k[:, :-1]).to(torch.int16).int()
                      - (cs_p[:, 1:] - cs_p[:, :-1]).to(torch.int16).int())
                     .abs().max())
        d = (st_k - st_p).abs().amax(dim=(0, 1))
        thr = cfg.cn0_threshold
        ok9 = (bool((st_k[:, 1:, 3] > 0).all())
               and bool(torch.equal(st_k[..., 3], st_p[..., 3]))
               and bool(torch.equal(st_k[..., 1] > thr, st_p[..., 1] > thr))
               and float(d[2]) <= 5e-3 and float(d[5]) <= 5e-3
               and float(d[1]) <= 1e-2 and bb_err <= 1)
        del cs_k, cs_p, st_k, st_p

        def k9():
            carrier_cuda.pm_scan_locked_fused(*args, tail=1)

        out["k9"] = {"shape": f"{B} x {T} x {n}, K = {K}", "ok": ok9,
                     "max_dfreq_hz": float(d[2]), "max_dcn0_db": float(d[1]),
                     "max_dbaseband_lsb": bb_err}
        timed.append(("k9", k9, 5, out["k9"], ""))
        oks.append(ok9)

    # ---- K1 at the bench shape: one clean block of locked carriers
    if "k1" in want:
        gen.manual_seed(5)
        iq = synthesize_iq_device(frames, freqs, gen, n, samprate=cfg.samprate,
                                  symrate=1024.0, noise_std=2500.0)
        raw1 = to_raw_int16(iq)
        del iq
        carry = carrier.PMCarry(search_center=freqs,
                                cn0=torch.full_like(freqs, 60.0))
        first, last = carrier._search_window(carry.search_center, carry.cn0,
                                              cfg)
        k1_args = (carrier.pack_raw(raw1), first - 1, last - first, K,
                   cfg.samprate, cfg.actual_binsize)
        bb_p, f_p, a_p, c_p = carrier_cuda.pm_locked_plain(*k1_args)
        bb_k, f_k, a_k, c_k = carrier_cuda.pm_locked_fused(*k1_args)
        err1 = int((bb_k.int() - bb_p.int()).abs().max())
        ok1 = (float((f_k - f_p).abs().max()) <= 5e-3
               and bool(torch.allclose(a_k, a_p, rtol=1e-5, atol=0))
               and float((c_k - c_p).abs().max()) <= 1e-2 and err1 <= 1)
        out["k1"] = {"shape": f"{B} x {n}, K = {K}", "ok": ok1,
                     "max_dfreq_hz": float((f_k - f_p).abs().max()),
                     "max_dbaseband_lsb": err1,
                     "design": _kernels.backend_used.get("pm_locked")}
        del bb_k, bb_p

        def k1():
            carrier_cuda.pm_locked_fused(*k1_args)

        timed.append(("k1", k1, 20, out["k1"], ""))
        oks.append(ok1)

    # ---- K2 at the bench shape (without, then with flip and a Doppler
    #      rate) and at the narrowband path's
    if "k2" in want:
        narrow = carrier.PMConfig(samprate=32768.0, binsize=8.0,
                                  search_width=200.0)
        for name, c2, flip, doppler in (("k2", cfg, False, 0.0),
                                        ("k2fd", cfg, True, 40.0),
                                        ("k2nb", narrow, False, 0.0)):
            n2 = c2.fftsize
            f2 = torch.as_tensor(
                (20_000.0 + 137.0 * np.arange(B)) if n2 == n
                else (4000.0 + 37.0 * np.arange(B)),
                dtype=torch.float32, device=dev)
            gen.manual_seed(2)
            fr = torch.as_tensor(random_frames(np.random.default_rng(2), B),
                                 device=dev)[:, None, :]
            iq = synthesize_iq_device(fr, f2, gen, n2, samprate=c2.samprate,
                                      symrate=1024.0, noise_std=2500.0)
            pk2 = carrier.pack_raw(to_raw_int16(iq))
            del iq
            spin = (pk2, (-1.0 if flip else 1.0) * f2 + 0.125, c2.samprate,
                    flip, doppler / c2.samprate**2)
            bb_p, a_p, c_p = carrier_cuda.spin_down_plain(*spin)
            bb_k, a_k, c_k = carrier_cuda.spin_down_fused(*spin)
            err2 = int((bb_k.int() - bb_p.int()).abs().max())
            ok2 = (bool(torch.allclose(a_k, a_p, rtol=1e-5, atol=0))
                   and float((c_k - c_p).abs().max()) <= 1e-2 and err2 <= 1)
            out[name] = {"shape": f"{B} x {n2}", "flip": flip,
                         "doppler_hz_per_s": doppler, "ok": ok2,
                         "max_dbaseband_lsb": err2,
                         "max_dcn0_db": float((c_k - c_p).abs().max()),
                         "design": _kernels.backend_used.get("spin",
                                                             "two_pass")}
            del bb_k, bb_p

            def k2(spin=spin):
                carrier_cuda.spin_down_fused(*spin)

            timed.append((name, k2, 50, out[name], ""))
            oks.append(ok2)

    # ---- K4: the Fano walk alone in cases (a), (b), (c)
    if "k4" in want:
        dcfg, a, b = k4_walk_inputs(torch, np, dev)
        delta = dcfg.fano_delta
        runs = []
        for name, (m4, regs), maxcycles in (
                ("a", a, dcfg.fano_params_tier1().maxcycles),
                ("b", b, dcfg.fano_maxcycles)):
            bits_p, st_p = _k4_plain(torch, fano_cuda, m4, regs, dcfg.code,
                                     delta, maxcycles)
            runs.append((name, m4, regs, maxcycles, bits_p, st_p))
            if name == "a":  # (c): the lane of (a) that walks longest
                i = int(st_p[:, 2].argmax())
                runs.append(("c", m4[i:i + 1].contiguous(),
                             regs[i:i + 1].contiguous(), maxcycles,
                             bits_p[i:i + 1], st_p[i:i + 1]))
        for name, m4, regs, maxcycles, bits_p, st_p in runs:
            bits_k, st_k = fano_cuda.fano_walk(m4, regs, dcfg.code, delta,
                                               maxcycles)
            timed_out = int((st_p[:, 0] + 1 != m4.shape[1]).sum())
            # (b) must hold a lane that walks its whole budget
            ok4 = (bool(torch.equal(bits_k, bits_p)
                        and torch.equal(st_k, st_p))
                   and (name != "b" or timed_out > 0))
            rec = {"lanes": m4.shape[0], "cycles_per_bit": maxcycles,
                   "ok": ok4, "max_lane_steps": int(st_p[:, 2].max()),
                   "timed_out": timed_out,
                   "design": _kernels.backend_used.get("fano_walk",
                                                       "thread")}
            out[f"k4{name}"] = rec
            oks.append(ok4)

            def k4(m4=m4, regs=regs, maxcycles=maxcycles):
                fano_cuda.fano_walk(m4, regs, dcfg.code, delta, maxcycles)

            timed.append((f"k4{name}", k4, 5 if name == "b" else 10, rec, ""))

    # ---- K7a and K7b at 128 x 2^21 frames; K7b at the edge path's shape
    if want & {"k7a", "k7b"}:
        from isee3_decoder_tpu_torch.ops import channelizer_cuda as cc

        def capture(nwords: int, seed: int):
            gen.manual_seed(seed)
            iq = torch.randint(-20000, 20000, (2, nwords), generator=gen,
                               device=dev, dtype=torch.int32)
            return (iq[0] & 0xFFFF) | (iq[1] << 16)

        P = 8
        wide = capture(128 << 21, 7)
        cases = [c for c in (("k7a", wide, 128, 1), ("k7b", wide, 128, 2))
                 if c[0] in want]
        if "k7b" in want:
            cases.append(("k7b_edge", capture(EDGE_WORDS, 3), 32, 2))
        for name, x, M, os_ in cases:
            got = cc.channelize_raw_fused(x, M, P, oversample=os_)
            ref = cc.channelize_raw_plain(x, M, P, oversample=os_)
            worst, ndiff = 0, 0
            for r in range(0, M, 8):
                d = (got[r:r + 8].int() - ref[r:r + 8].int()).abs()
                worst = max(worst, int(d.max()))
                ndiff += int((d > 0).sum())
            share = ndiff / ref.numel()
            nsamp = ref.shape[1] // 2
            ok7 = worst <= 1 and share < 0.01
            out[name] = {
                "shape": f"{M} x {x.numel() // M} frames, oversample {os_}",
                "ok": ok7, "max_abs_err": worst, "share_differ": share,
                "row_stride": got.stride(0),
                "plan": (cc.pfb_plan(M, P, os_, nsamp)
                         if hasattr(cc, "pfb_plan") else None),
                "bound_ms": (4 * x.numel() + 4 * M * nsamp)
                / HBM_BYTES_PER_S * 1e3}
            del got, ref
            torch.cuda.empty_cache()

            def k7(x=x, M=M, os_=os_):
                cc.channelize_raw_fused(x, M, P, oversample=os_)

            timed.append((name, k7, 10, out[name], ""))
            oks.append(ok7)

    # ---- K3 at the bench shape and at the narrowband path's
    if want & set(K3_SHAPES):
        from isee3_decoder_tpu_torch.ops import prefix_cuda

        for name, (T3, B3, n3) in K3_SHAPES.items():
            if name not in want:
                continue
            gen.manual_seed(3)
            bb = torch.randint(-32768, 32768, (T3, B3, n3), generator=gen,
                               device=dev, dtype=torch.int32).to(torch.int16)
            got = prefix_cuda.prefix_sum_blocks(bb, tail=1)
            ok3 = bool(torch.equal(
                got, prefix_cuda.prefix_sum_blocks_plain(bb, 1)))
            del got
            torch.cuda.empty_cache()
            flat = bb.permute(1, 0, 2).reshape(B3, T3 * n3).contiguous()
            plan = (prefix_cuda.prefix_plan(T3, B3, n3, 1)
                    if hasattr(prefix_cuda, "prefix_plan") else None)
            out[name] = {
                "shape": f"{T3} x {B3} x {n3}, tail 1", "ok": ok3,
                "plan": plan and {k: v for k, v in plan.items()
                                  if not k.startswith("row_")},
                "bound_ms": (6 * bb.numel() + 4 * B3) / HBM_BYTES_PER_S * 1e3}

            def k3(bb=bb):
                prefix_cuda.prefix_sum_blocks(bb, tail=1)

            def cumsum(flat=flat):
                torch.cumsum(flat, dim=1, dtype=torch.int32)

            timed += [(name, k3, 20, out[name], ""),
                      (name, cumsum, 20, out[name], "cumsum_")]
            oks.append(ok3)

    for name, fn, reps, rec, pre in timed:
        rec[pre + "ms"] = _event_ms(torch, fn, reps)
        if name.startswith("k4"):
            rec["ns_per_step"] = rec["ms"] * 1e6 / rec["max_lane_steps"]
    for name, fn, reps, rec, pre in timed:
        dms, per_call, by_name = _device_ms(torch, fn, reps)
        if pre:
            rec.update({pre + "device_ms": dms,
                        pre + "kernels_per_call": per_call})
        else:
            rec.update(device_ms=dms, kernels_per_call=per_call,
                       kernels=by_name)
        if name == "k1":
            spin = sum(v for k, v in by_name.items()
                       if any(s in k for s in SPIN_KERNELS))
            rec.update(spin_device_ms=spin, search_device_ms=sum(
                v for k, v in by_name.items() if "locked_search_kernel" in k))
    print(json.dumps(out), flush=True)
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main())
