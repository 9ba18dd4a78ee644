"""What host threads would cost parallel/'s shards: the same work for S
shards run one after another in one thread (what parallel/sharding does)
and at the same time in S threads, each on a CUDA stream of its own.

    python -m tools.shard_threads [--shards 4] [--device cuda] [--nops 3000]

Cases: ``ops+read``, a shard's loop of small out-of-place torch ops on a
(32, 1024) float32 tensor with a host read of one value every 50 ops (as
a pm block's lock check is); and, on a card, ``receive``: 32-channel
quarters of chip_smoke.py's clean bench block (250 ksps, two frames
decoded) through ``receive_block_device``, the stage
``receive_block_sharded`` runs.  Prints one JSON line: per case the ms
of the one-thread and the threaded run (best of 3) and their ratio, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import threading
import time

import numpy as np
import torch


def in_threads(stage, jobs: list[tuple]) -> list:
    """``stage(*args)`` for every job, a host thread each; on a card each
    thread runs on its own stream, which waits for the caller's first,
    and the caller's stream waits for all of them after the join."""
    dev = jobs[0][0].device
    caller = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    streams = [torch.cuda.Stream(dev) if caller else None for _ in jobs]
    out, errors = [None] * len(jobs), []

    def work(i):
        try:
            if caller is None:
                out[i] = stage(*jobs[i])
                return
            streams[i].wait_stream(caller)
            with torch.cuda.device(dev), torch.cuda.stream(streams[i]):
                out[i] = stage(*jobs[i])
        except BaseException as exc:
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for s in streams:
        if s is not None:
            caller.wait_stream(s)
    if errors:
        raise errors[0]
    return out


def _ops_read(x: torch.Tensor, nops: int) -> float:
    acc = 0.0
    for k in range(nops):
        y = x * 2.0 + 1.0
        if k % 50 == 0:
            acc = float(y[0, 0])
    return acc


def _best_ms(fn, dev: torch.device) -> float:
    best = float("inf")
    for _ in range(3):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _case(stage, jobs: list[tuple], dev: torch.device) -> dict:
    in_threads(stage, jobs)  # warm-up: kernels built, tables made
    seq = _best_ms(lambda: [stage(*j) for j in jobs], dev)
    thr = _best_ms(lambda: in_threads(stage, jobs), dev)
    return {"one_thread_ms": seq, "threads_ms": thr, "ratio": thr / seq}


def _receive_jobs(dev: torch.device, shards: int):
    from isee3_decoder_tpu_torch.config import FRAMESYMBOLS
    from isee3_decoder_tpu_torch.models.pipeline import (
        PipelineConfig,
        receive_block_device,
    )
    from isee3_decoder_tpu_torch.ops.carrier import PMConfig
    from isee3_decoder_tpu_torch.ops.symbols import SymConfig
    from isee3_decoder_tpu_torch.utils.devicesignal import (
        random_frames,
        synthesize_iq_device,
        to_raw_int16,
    )

    # chip_smoke.py's block: four frames sent, the first two decoded
    nchan, nframes = 32 * shards, 2
    nsamples = int((4 * 2048 + 400) / 1024.0 * 250_000)
    frames = random_frames(np.random.default_rng(0), 4)
    frames_dev = torch.as_tensor(np.ascontiguousarray(
        np.broadcast_to(frames, (nchan, *frames.shape))), device=dev)
    carriers = torch.as_tensor(20_000.0 + 137.0 * np.arange(nchan),
                               dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    iq = to_raw_int16(synthesize_iq_device(frames_dev, carriers, gen, nsamples,
                                           noise_std=2500.0))
    cfg = PipelineConfig(pm=PMConfig(samprate=250_000.0, binsize=4.0,
                                     search_width=200.0),
                         sym=SymConfig(samprate=250_000.0, symrate=1024.0))

    def stage(block):
        return receive_block_device(block, nframes, FRAMESYMBOLS, cfg)

    return stage, [(iq[32 * s: 32 * (s + 1)],) for s in range(shards)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    ap.add_argument("--nops", type=int, default=3000)
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    xs = [(torch.ones((32, 1024), device=dev), a.nops) for _ in range(a.shards)]
    cases = {"ops+read": _case(_ops_read, xs, dev)}
    card = "cpu"
    if dev.type == "cuda":
        cases["receive"] = _case(*_receive_jobs(dev, a.shards), dev)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps({"device": str(dev), "card": card, "shards": a.shards,
                      "nops": a.nops, "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
