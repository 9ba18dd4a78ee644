#!/usr/bin/env python3
"""Archive-replay benchmark of isee3_decoder_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json once, from the root of a checkout.

Set-up: a pool of distinct blocks of raw int16 IQ made on the card from
the seed (benchmark/yardstick/traffic.py, the cell's file under
benchmark/cells/), the kernel library built or loaded, one block of the
cell's shape through the receive chain.  The window: the pool's blocks,
cycled, back to back into ``models.pipeline.receive_blocks_pipelined``
(depth 2) — one station replaying its recordings, a closed loop — until
``--seconds`` have passed and every pool block has been fed; the blocks
in flight are drained.  An operation is one frame a pool block holds
whole (yardstick/check.py): ``attempted`` and ``failed`` count the
pool's frames once each, however often the window replayed them.
``realtime_channels`` is the channel-seconds of 250 ksps IQ of every
block completed over the time from the first block's submission to the
last block's frames.  Then the plain reference (benchmark/reference/)
decodes channels drawn from the seed of every pool block the window
completed, and each completion is compared with it (yardstick/check.py).

The process pins itself to HOST_CORES of the cores it may use and runs
torch's host ops on INTRA_OP_THREADS threads, so that runs of a cell do
not differ by where the scheduler puts the driver's thread.

``--trace 1``: spans at the layers' entry functions, torch.profiler over
the cell's ``trace_blocks`` blocks a third of the way into the window,
and the cell's per-layer metrics in place of the end-to-end ones.

The last line of standard output is the result, one JSON object; the
numbers compared and their limits are the last lines of standard
error.  Fails, with no result, where there is no CUDA device, where
the program cannot be imported, or where JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import torch  # noqa: E402

# the program under test; a checkout without it fails here, before any run
from isee3_decoder_tpu_torch import _kernels  # noqa: E402
from isee3_decoder_tpu_torch.config import CODES  # noqa: E402
from isee3_decoder_tpu_torch.models import pipeline  # noqa: E402
from isee3_decoder_tpu_torch.models.decode import DecodeConfig  # noqa: E402
from isee3_decoder_tpu_torch.ops.carrier import PMConfig  # noqa: E402
from isee3_decoder_tpu_torch.ops.symbols import SymConfig  # noqa: E402
from reference.chain import receive  # noqa: E402
from yardstick import check, guard, traffic  # noqa: E402
from yardstick.manifest import Manifest  # noqa: E402
from yardstick.roofline import front_end_least_s  # noqa: E402
from yardstick.trace import ProfilerWindow, reduce_events, spans_installed  # noqa: E402

PACKAGE = guard.PORT
DEPTH = 2
#: cores the run keeps to (the last of those it may use), and torch's
#: intra-op threads on them
HOST_CORES = 4
INTRA_OP_THREADS = 4


def pin_host(cores: int = HOST_CORES, threads: int = INTRA_OP_THREADS) -> list:
    """Keep this process, and the threads it starts from now on, to the
    last ``cores`` of the cores it may use; returns them."""
    allowed = sorted(os.sched_getaffinity(0))
    keep = allowed[-cores:] if cores else allowed
    os.sched_setaffinity(0, keep)
    if threads:
        torch.set_num_threads(threads)
    return keep


def log(msg: str) -> None:
    print(f"bench: {msg}", flush=True)


def pipeline_config(cfg: dict):
    """The configuration file → the program's PipelineConfig."""
    d = dict(cfg["decode"])
    d["code"] = CODES[d["code"]]
    return pipeline.PipelineConfig(
        pm=PMConfig(samprate=cfg["samprate"], binsize=cfg["binsize"],
                    search_width=cfg["search_width"],
                    cn0_threshold=cfg["cn0_threshold"],
                    dtype=getattr(torch, cfg["pm_dtype"])),
        sym=SymConfig(samprate=cfg["samprate"], symrate=cfg["symrate"],
                      symbolclocks=cfg["symbolclocks"], window=cfg["window"]),
        decode=DecodeConfig(**d),
        pm_backend=cfg["pm_backend"],
    )


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda") -> dict:
    """One run of cell ``name``; returns the result object (the checks
    under ``"checks"``, last).  ``setup_s`` counts from the process's
    start."""
    dev = torch.device(device)
    work = manifest.workload(name)
    cfg = manifest.config(work["config"])
    cell = manifest.cell(name)
    pcfg = pipeline_config(cfg)
    nframes = cell["frames_whole"]
    if dev.type == "cuda":
        _kernels.lib()
    pool = traffic.make_pool(cfg, cell, seed, dev)
    channels, P = pool.channels, len(pool.blocks)
    for _ in pipeline.receive_blocks_pipelined([pool.blocks[0]], nframes, pcfg,
                                               depth=DEPTH, device=dev):
        pass
    _sync(dev)
    setup_s = time.perf_counter() - T_START

    # the channels the check compares, drawn from the seed; the timed
    # path's soft symbols of them are kept as each block's host tail
    # takes them
    sampled = check.sample_channels(seed, channels, cell["check_channels"], P)
    sampled_dev = [torch.as_tensor(sampled[p], device=dev) for p in range(P)]
    soft_kept = []

    # ---- the window
    takes, yields, recs = [], [], []
    prof = ProfilerWindow() if trace else None
    # the first traced block; host times the profiler ran
    state = {"k0": None, "t_prof": None}

    def feed():
        k = 0
        start = time.perf_counter()
        while True:
            now = time.perf_counter()
            tracing_owed = trace and (state["k0"] is None
                                      or k < state["k0"] + cell["trace_blocks"])
            if k >= P and now - start >= seconds and not tracing_owed:
                return
            if trace and state["k0"] is None and now - start >= seconds / 3:
                state["k0"] = k
                prof.start()
                state["t_prof"] = [time.perf_counter(), None]
            takes.append(time.perf_counter())
            yield pool.blocks[k % P]
            k += 1

    _kernels.reset_launches()
    spans = (spans_installed(manifest.layers(), PACKAGE) if trace
             else contextlib.nullcontext())
    with spans:
        finish = pipeline._finish  # the traced run's span around it, if any

        def finish_keeping_soft(buf, soft, *args, **kwargs):
            soft_kept.append(soft.index_select(0, sampled_dev[len(soft_kept) % P]))
            return finish(buf, soft, *args, **kwargs)

        pipeline._finish = finish_keeping_soft
        try:
            # looked up here, where the traced run's spans have wrapped it
            for rec, ss in pipeline.receive_blocks_pipelined(feed(), nframes, pcfg,
                                                             depth=DEPTH, device=dev):
                yields.append(time.perf_counter())
                recs.append(rec)
                k0 = state["k0"]
                if trace and k0 is not None and len(recs) == k0 + cell["trace_blocks"]:
                    prof.stop()
                    state["t_prof"][1] = time.perf_counter()
        finally:
            pipeline._finish = finish
    _sync(dev)
    done = len(recs)
    elapsed = yields[-1] - takes[0]
    launches = {k: v / done for k, v in _kernels.LAUNCHES.items() if v}
    backends = dict(_kernels.backend_used)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"card {card_line() if dev.type == 'cuda' else 'cpu'}; {done} blocks of "
        f"{channels} ch x {pool.seconds:.6f} s in {elapsed:.6f} s; setup "
        f"{setup_s:.3f} s")
    log(f"launches per block {json.dumps(launches)}; backend {json.dumps(backends)}")

    summary = None
    if trace:
        k0, nb = state["k0"], cell["trace_blocks"]
        p0, p1 = state["t_prof"]
        block_ms = [(y - t) * 1e3 for t, y in zip(takes, yields)
                    if y < p0 or t > p1]
        # the untraced blocks' pace: one yield to the next, outside the
        # profiler and its export, while blocks were still fed (the
        # drain's yields follow one another closely)
        gaps = [(y1 - y0) * 1e3 for y0, y1 in zip(yields, yields[1:])
                if (y1 < p0 or y0 > p1) and y0 < takes[-1]]
        n = traffic.fftsize(cfg)
        least = {"front_end": front_end_least_s(cfg, channels,
                                                pool.nsamples // n, n)[0]}
        summary = reduce_events(prof.events, block_ms, least,
                                period_ms=sum(gaps) / len(gaps) if gaps else None)
        prof.events = None
        share = summary.unattributed_s / summary.device_s if summary.device_s else 0.0
        log(f"traced blocks {k0}..{k0 + nb - 1}, calls {json.dumps(summary.calls)}: "
            f"device time charged to no layer "
            f"{100 * share:.4f} % of {summary.device_s:.6f} s; by layer (s) "
            f"{json.dumps(summary.layer_s)}; kernels by layer "
            f"{json.dumps(summary.layer_kernels)}")

    # ---- correctness, once the window has closed and its state is freed
    t_ref = time.perf_counter()
    lanes = {p: check.lanes_of(sampled[p], nframes) for p in range(P)}
    completions = [(k % P, check.take_lanes(rec, lanes[k % P], channels * nframes),
                    soft_kept[k].cpu().numpy() if k < len(soft_kept) else None)
                   for k, rec in enumerate(recs)]
    soft_kept.clear()
    due = sorted({c[0] for c in completions})
    rows = {p: pool.blocks[p][torch.as_tensor(sampled[p], device=dev)] for p in due}
    cyclic = cell["signal"] == "cyclic"
    ops = check.operations([(k % P, check.failed_lanes(rec, pool.frames[k % P], nframes,
                                                       pool.lead_symbols, cyclic))
                            for k, rec in enumerate(recs)])
    del recs
    pool.blocks.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    refs = {p: receive(rows.pop(p), cfg, nframes) for p in due}
    verdict = check.compare(completions, refs, cell["limits"])
    log(f"operations: {ops['attempted']} frames of {len(due)} pool blocks, "
        f"{ops['failed']} failed, {ops['unsteady']} of them in some completions only")
    log(f"reference on {len(due)} pool blocks x {cell['check_channels']} ch: "
        f"{time.perf_counter() - t_ref:.3f} s; {len(completions)} completions compared; "
        f"numbers {json.dumps(verdict['numbers'])}")

    result = {
        "correct": verdict["correct"],
        "attempted": ops["attempted"],
        "failed": ops["failed"],
    }
    if trace:
        metrics = {}
        for m in manifest.per_layer(name):
            value = manifest.reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        rate = done * channels * pool.seconds / elapsed
        result["metrics"] = {
            "realtime_channels": {"value": rate, "unit": "channels"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if trace:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": verdict["numbers"][k], "limit": v}
                        for k, v in verdict["limits"].items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = Manifest()
    chips = manifest.workload(args.workload)["chips"]
    cores = pin_host()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    log(f"host cores {cores}, {torch.get_num_threads()} intra-op threads")
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = guard.forbidden_loaded(sys.modules)
    if found:
        print(f"bench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
