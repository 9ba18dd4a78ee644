"""The 16 bps subcarrier mode below the clean signal, through both
packages on the CPU: where a 1 s symbol window comes out inverted.

    JAX_PLATFORMS=cpu python -m tools.inversion_sweep [--seeds 42 1 2 3]
        [--noises 12000 13000 ... 25000] [--out sweep.jsonl]

The signal is tests/test_mode16bps_and_fer.py's full-frame case (8192
sps, 32 sym/s, 32 clocks a symbol, binsize 8, amplitude 9000, mod index
0.7, 3 frames after a 20-symbol lead), at each noise level and seed.  For
each run and each package (the JAX package ``isee3_decoder_tpu`` and the
port ``isee3_decoder_tpu_torch``, the port on its plain CPU path) it
writes one JSON line: the wrong hard decisions against the sent symbols
(at the symbol offset that agrees best), grouped by symdemod window (a
window with more than half its symbols wrong is counted as inverted),
each such window's ``symphase`` and its neighbours', the soft symbols
that differ between the packages, and decode_stream's records (start
symbol, good flag, decoder label).  It
imports JAX, so it is a comparison tool beside the tests, not part of
the port.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np

FS = 8192.0
SYMRATE = 32.0
CLOCKS = 32
LEAD = 20
NFRAMES = 3
AMPLITUDE = 9000.0
MOD_INDEX = 0.7
CARRIER = 1700.0


def signal(seed: int, noise: float):
    """(complex IQ, sent symbols, frames) of the test's case at ``noise``:
    frames, then the lead, then the noise, all from one seeded rng."""
    from isee3_decoder_tpu_torch.utils import testsignal

    rng = np.random.default_rng(seed)
    frames = testsignal.random_frames(rng, NFRAMES)
    lead = copy.deepcopy(rng).integers(0, 2, LEAD).astype(np.uint8)
    iq = testsignal.synthesize_iq(
        frames, samprate=FS, symrate=SYMRATE, carrier=CARRIER,
        mod_index=MOD_INDEX, amplitude=AMPLITUDE, noise_std=noise,
        symbolclocks=CLOCKS, lead_symbols=LEAD, rng=rng)
    sent = np.concatenate([lead, testsignal.frames_to_symbols(frames)])
    return iq, sent, frames


def wrong_windows(soft: np.ndarray, sent: np.ndarray, nsym: int) -> dict:
    """Hard decisions (soft > 128) against the sent symbols, soft symbol i
    against sent symbol i + offset for the offset in (-1, 0, 1) that
    agrees best (the first window's search may start a whole symbol
    early or late): the offset, the wrong symbols' indices, and per
    window that has any, its count of wrong symbols."""
    hard = (soft > 128).astype(np.uint8)
    best = None
    for off in (0, -1, 1):
        lo = max(-off, 0)
        n = min(hard.size, sent.size - off)
        wrong = lo + np.nonzero(hard[lo:n] != sent[lo + off: n + off])[0]
        if best is None or wrong.size < best[1].size:
            best = (off, wrong)
    off, wrong = best
    per_window: dict[int, int] = {}
    for i in wrong:
        per_window[int(i) // nsym] = per_window.get(int(i) // nsym, 0) + 1
    return {"offset": off, "wrong": wrong.tolist(), "per_window": per_window}


def run_jax(iq, cfg_kwargs: dict):
    import jax.numpy as jnp

    from isee3_decoder_tpu.models import pipeline as jpipe
    from isee3_decoder_tpu.models import symdemod as jsd
    from isee3_decoder_tpu.models.decode import decode_stream
    from isee3_decoder_tpu.ops.carrier import PMConfig
    from isee3_decoder_tpu.ops.symbols import SymConfig

    cfg = jpipe.PipelineConfig(pm=PMConfig(**cfg_kwargs["pm"]),
                               sym=SymConfig(**cfg_kwargs["sym"]))
    soft, bb, _, _ = jpipe.demod_to_symbols(jnp.asarray(iq), cfg)
    soft = np.asarray(soft)
    nwin = soft.shape[1] // cfg.sym.nsymbols
    _, out = jsd.symdemod_scan(bb, cfg.sym, nwin)
    symphase = np.asarray(out.symphase)[:, 0]
    recs, _ = decode_stream(soft, cfg.decode)
    return soft[0], symphase, recs


def run_torch(iq, cfg_kwargs: dict):
    import torch

    from isee3_decoder_tpu_torch.models import pipeline as tpipe
    from isee3_decoder_tpu_torch.models import symdemod as tsd
    from isee3_decoder_tpu_torch.models.decode import decode_stream
    from isee3_decoder_tpu_torch.ops.carrier import PMConfig
    from isee3_decoder_tpu_torch.ops.symbols import SymConfig

    cfg = tpipe.PipelineConfig(pm=PMConfig(**cfg_kwargs["pm"]),
                               sym=SymConfig(**cfg_kwargs["sym"]))
    soft, bb, _, _ = tpipe.demod_to_symbols(
        torch.from_numpy(iq.astype(np.complex64)), cfg)
    nwin = soft.shape[1] // cfg.sym.nsymbols
    _, out = tsd.symdemod_scan(bb, cfg.sym, nwin)
    symphase = out.symphase[:, 0].numpy()
    recs, _ = decode_stream(soft, cfg.decode, device="cpu")
    return soft.numpy()[0], symphase, recs


def one_run(seed: int, noise: float) -> list[dict]:
    iq, sent, frames = signal(seed, noise)
    cfg_kwargs = {"pm": dict(samprate=FS, binsize=8.0, search_width=100.0),
                  "sym": dict(samprate=FS, symrate=SYMRATE,
                              symbolclocks=CLOCKS)}
    sent_frames = {bytes(f) for f in frames}
    out, softs = [], {}
    for pkg, run in (("jax", run_jax), ("torch", run_torch)):
        t0 = time.perf_counter()
        soft, symphase, recs = run(iq, cfg_kwargs)
        softs[pkg] = soft
        ww = wrong_windows(soft, sent, CLOCKS)
        inverted = sorted(w for w, c in ww["per_window"].items()
                          if 2 * c > CLOCKS)
        scattered = sum(c for w, c in ww["per_window"].items()
                        if w not in inverted)
        out.append({
            "pkg": pkg, "seed": seed, "noise": noise,
            "offset": ww["offset"],
            "inverted": inverted,
            "per_window": {str(w): c for w, c in
                           sorted(ww["per_window"].items())},
            "scattered": scattered,
            "symphase": {str(w): symphase[max(w - 1, 0): w + 2].tolist()
                         for w in inverted},
            "records": [(int(r.start_symbol[0]), bool(r.good[0]),
                         int(r.decoder[0]),
                         bool(r.good[0]) and bytes(r.data[0]) in sent_frames)
                        for r in recs],
            "seconds": round(time.perf_counter() - t0, 1),
        })
    n = min(softs["jax"].size, softs["torch"].size)
    d = softs["jax"][:n].astype(int) - softs["torch"][:n].astype(int)
    for o in out:
        o["soft_differ"] = int((d != 0).sum())
        o["soft_max_diff"] = int(np.abs(d).max()) if n else 0
        o["nsoft"] = n
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[42, 1, 2, 3])
    p.add_argument("--noises", type=float, nargs="+",
                   default=[float(x) for x in range(12_000, 26_000, 1000)])
    p.add_argument("--out", default=None,
                   help="append the JSON lines to this file too")
    a = p.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    # as tests/conftest.py: the JAX side's timing-search sums in float64
    jax.config.update("jax_enable_x64", True)
    for seed in a.seeds:
        for noise in a.noises:
            for line in one_run(seed, noise):
                text = json.dumps(line)
                print(text, flush=True)
                if a.out:
                    with open(a.out, "a") as f:
                        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
