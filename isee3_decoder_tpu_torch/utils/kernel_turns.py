"""Time kernels K1, K8, K5, K6 and K9 of one checkout of the port, for
comparing two trees in turns on one card.

    python isee3_decoder_tpu_torch/utils/kernel_turns.py --tree DIR [--label L]

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
  per call, and the device ms of each kernel it launches (the search and
  the spin passes apart).

Each kernel's result is held against its plain version first (K8: peak
bins equal, frequency within 5e-3 Hz, bins within 1e-5 of the largest;
K5: bit for bit; K6: metrics, decision words and row minima bit for
bit; K9: ok lanes and locks equal, frequency and centre
within 5e-3 Hz, C/N0 within 1e-2 dB, baseband within 1 LSB; K1:
frequency within 5e-3 Hz, amplitude within rtol 1e-5, C/N0 within 1e-2
dB, baseband within 1 LSB).  Every CUDA-event time is taken before the
first torch.profiler session, which slows every later launch of the
process.  Needs a CUDA card; the card's nvidia-smi name and power limit
are in the line.
"""

from __future__ import annotations

import argparse
import json
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="checkout to import")
    ap.add_argument("--label", default=None)
    args_cli = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args_cli.tree).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    from isee3_decoder_tpu_torch import _kernels
    from isee3_decoder_tpu_torch.config import DEFAULT_CODE as code
    from isee3_decoder_tpu_torch.ops import carrier, carrier_cuda
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

    # ---- K8 at the narrowband path's shape
    B = 128
    cfg = carrier.PMConfig(samprate=32768.0, binsize=8.0, search_width=200.0)
    n, K = cfg.fftsize, carrier._window_bins(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    frames = torch.as_tensor(random_frames(np.random.default_rng(8), B),
                             device=dev)[:, None, :]
    freqs = torch.as_tensor(4000.0 + 37.0 * np.arange(B), dtype=torch.float32,
                            device=dev)
    iq = synthesize_iq_device(frames, freqs, gen, n, samprate=cfg.samprate,
                              noise_std=2500.0)
    raw = to_raw_int16(iq)
    packed = carrier.pack_raw(raw)
    carry = carrier.PMCarry(search_center=freqs,
                            cn0=torch.full_like(freqs, 60.0))
    first, last = carrier._search_window(carry.search_center, carry.cn0, cfg)
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

    # (name, function, reps, record): every event time is taken first, in
    # this order, then every device time
    timed = []
    out["k8"] = {"shape": f"{B} x {n}, K = {K}", "ok": ok8, "rel_err": rel}
    timed += [("k8", k8, 50, out["k8"]), ("fft", fft, 50, out["k8"])]

    # ---- K5 over a whole K = 24 row phase at the threshold block's batch
    B = 10
    w, rowb, _ = vc._geometry(code)
    gen.manual_seed(25)
    m0 = torch.randint(0, 12000, (B, code.nstates), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int16)
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
    timed.append(("k5", k5, 20, out["k5"]))
    del dk, dp, m0

    # ---- K6 over a whole K = 24 column phase at the same batch
    nb = w - rowb
    gen.manual_seed(26)
    m0 = torch.randint(0, 12000, (B, code.nstates), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int16)
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
    timed.append(("k6", k6, 20, out["k6"]))

    # ---- K9 at the bench shape
    B, T = 128, 32
    cfg = carrier.PMConfig(samprate=250_000.0, binsize=4.0, search_width=200.0)
    n, K = cfg.fftsize, carrier._window_bins(cfg)
    frames = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
        random_frames(np.random.default_rng(0), 4), (B, 4, 128))), device=dev)
    freqs = torch.as_tensor(20_000.0 + 137.0 * np.arange(B),
                            dtype=torch.float32, device=dev)
    gen.manual_seed(9)
    iq = synthesize_iq_device(frames, freqs, gen, T * n, samprate=cfg.samprate,
                              symrate=1024.0, noise_std=2500.0)
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
    timed.append(("k9", k9, 5, out["k9"]))

    # ---- K1 at the bench shape: one clean block of locked carriers
    gen.manual_seed(5)
    iq = synthesize_iq_device(frames, freqs, gen, n, samprate=cfg.samprate,
                              symrate=1024.0, noise_std=2500.0)
    raw1 = to_raw_int16(iq)
    del iq
    carry = carrier.PMCarry(search_center=freqs,
                            cn0=torch.full_like(freqs, 60.0))
    first, last = carrier._search_window(carry.search_center, carry.cn0, cfg)
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

    timed.append(("k1", k1, 20, out["k1"]))

    for name, fn, reps, rec in timed:
        rec["fft_ms" if name == "fft" else "ms"] = _event_ms(torch, fn, reps)
    for name, fn, reps, rec in timed:
        dms, per_call, by_name = _device_ms(torch, fn, reps)
        if name == "fft":
            rec.update(fft_device_ms=dms, fft_kernels_per_call=per_call)
        else:
            rec.update(device_ms=dms, kernels_per_call=per_call,
                       kernels=by_name)
    print(json.dumps(out), flush=True)
    return 0 if ok8 and ok5 and ok6 and ok9 and ok1 else 1


if __name__ == "__main__":
    sys.exit(main())
