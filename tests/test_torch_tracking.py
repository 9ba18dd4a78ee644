"""PyTorch port: clock tracking (-t) against the JAX package on the CPU,
bit for bit — the batched tracker's tables, one tracked window (also on
a recording that ends inside it, where the timing search's slices clamp
and the integrations read past the prefix sum), the batched tracker over
whole recordings at one and at different clocks, and the host tracker
(models/symdemod.symdemod_tracked, backend "host") at B = 1 and 2.

Inputs are Manchester baseband made with numpy from a seed at 32,768 sps
(32 samples a symbol at the nominal 1024 Hz), sent a little off the
nominal clock so the climb has work; the JAX side runs with x64 on
(tests/conftest.py), as its own tracker tests do."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models import symdemod as jsymdemod
from isee3_decoder_tpu.models import symdemod_tracked as jtracked
from isee3_decoder_tpu.ops import symbols as jsym
from isee3_decoder_tpu_torch.models import symdemod as tsymdemod
from isee3_decoder_tpu_torch.models import symdemod_tracked as ttracked
from isee3_decoder_tpu_torch.ops import symbols as tsym
from isee3_decoder_tpu_torch.utils import testsignal

SAMPRATE = 32768.0


def _baseband(seed: int, symrate: float, seconds: float, amp: float = 2000.0,
              noise: float = 150.0, samprate: float = SAMPRATE,
              clocks: int = 1) -> np.ndarray:
    """int16 Manchester baseband of random symbols sent at ``symrate`` on
    ``clocks`` subcarrier cycles a symbol, ``seconds`` long."""
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 2, int(seconds * symrate) + 8).astype(np.uint8)
    wave = testsignal.manchester_waveform(syms, samprate / symrate,
                                          symbolclocks=clocks)
    x = amp * wave + rng.normal(0, noise, len(wave))
    return x[: int(seconds * samprate)].astype(np.int16)


def _configs(samprate: float = SAMPRATE, symrate: float = 1024.0,
             clocks: int = 1):
    return (jsym.SymConfig(samprate=samprate, symrate=symrate,
                           symbolclocks=clocks),
            tsym.SymConfig(samprate=samprate, symrate=symrate,
                           symbolclocks=clocks))


# A mean energy below this, over at most 2048 symbols, is an exact float64
# sum of squared integers: equal in any summation order.  Above it (only
# where a window reads past the prefix sum's pad, into jnp's INT32_MIN
# fills) the last bit depends on the order, and XLA's order for a row
# sum is none that torch's reductions reproduce: there the energies are
# held to 2 ulps, everything else still bit for bit.
EXACT_ENERGY = 2.0**53 / 2048


def _assert_energy_equal(got, want, name: str = "energy"):
    got, want = np.asarray(got), np.asarray(want)
    exact = want < EXACT_ENERGY
    np.testing.assert_array_equal(got[exact], want[exact], err_msg=name)
    np.testing.assert_allclose(got[~exact], want[~exact], rtol=2 * 2.0**-52,
                               atol=0, err_msg=name)


def _assert_tracked_equal(got, want):
    """Soft symbols and every info field the JAX side gives, equal."""
    soft_t, infos_t = got
    soft_j, infos_j = want
    np.testing.assert_array_equal(soft_t, np.asarray(soft_j))
    assert len(infos_t) == len(infos_j)
    for it, ij in zip(infos_t, infos_j):
        assert set(it) == set(ij)
        for key in ij:
            if key == "energy":
                _assert_energy_equal(it[key], ij[key])
            else:
                np.testing.assert_array_equal(np.asarray(it[key]),
                                              np.asarray(ij[key]),
                                              err_msg=key)


@pytest.mark.parametrize("samprate,symrate,clocks",
                         [(SAMPRATE, 1024.0, 1), (SAMPRATE, 512.0, 2),
                          (250_000.0, 1024.0, 1)])
def test_build_track_tables_match_jax(samprate, symrate, clocks):
    jcfg, tcfg = _configs(samprate, symrate, clocks)
    want = jtracked.build_track_tables(jcfg, 512)
    got = ttracked.build_track_tables(tcfg, 512)
    for field in ("flo", "up", "tie", "srch", "nsym", "ss"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (got.k_range, got.nsym_max, got.noff) == (
        want.k_range, want.nsym_max, want.noff)
    assert got.tie.any() or samprate == SAMPRATE
    assert ttracked.build_track_tables(tcfg, 512) is got  # cached


@pytest.mark.parametrize("seconds", [1.6, 0.6],
                         ids=["whole_window", "ends_inside"])
def test_tracked_window_matches_jax(seconds):
    """One window for 3 channels at grid indices 0, 5, -7: soft, symbol
    count, start, grid index, timing adjustment and energy equal.  The
    0.6 s recording ends inside the window: the timing search's slices
    clamp their starts into the prefix sum (the whole slice shifts) and
    the integrations read INT32_MIN past it, as jnp does."""
    jcfg, tcfg = _configs()
    x = np.stack([_baseband(40 + b, 1024.0 + 0.2 * b, seconds)
                  for b in range(3)])
    t = ttracked.build_track_tables(tcfg, 512)
    jt = jtracked.build_track_tables(jcfg, 512)
    pad = tsym.track_pad(tcfg) + t.noff
    csum_j = jsym.prefix_sum(jnp.asarray(x), pad_to=x.shape[1] + pad)
    csum_t = tsym.samples_csum(torch.from_numpy(x), pad)
    np.testing.assert_array_equal(csum_t.numpy(), np.asarray(csum_j))
    first = np.array([16, 30, 9], np.int64)
    k = np.array([0, 5, -7], np.int64)
    want = jtracked._tracked_window_device(
        csum_j, jnp.asarray(first, jnp.int32), jnp.asarray(k, jnp.int32),
        jnp.asarray(jt.flo), jnp.asarray(jt.up, jnp.int32),
        jnp.asarray(jt.tie, jnp.int32), jnp.asarray(jt.srch),
        jnp.asarray(jt.nsym), jt.nsym_max, jt.noff, jcfg.symbolclocks,
        jt.k_range)
    got = ttracked.tracked_window(
        csum_t, torch.from_numpy(first), torch.from_numpy(k),
        ttracked.device_tables(t, "cpu"), t.nsym_max, t.noff,
        tcfg.symbolclocks, t.k_range)
    for name, a, b in zip(("soft", "n", "first", "k", "symphase"),
                          got[:5], want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    _assert_energy_equal(got.maxe.numpy(), want[5], "maxe")
    assert got.iterations >= 4 and got.host_reads == got.iterations + 1
    # whole window: every energy exact; ends inside: the search's slices
    # run past the prefix sum (their starts clamp) and the energies are
    # the INT32_MIN fills'
    L = csum_t.shape[1]
    inside = first - t.noff // 2 + t.srch[k + t.k_range, -1] + t.noff <= L
    assert inside.all() if seconds > 1 else not inside.any()
    assert (np.asarray(want[5]) < EXACT_ENERGY).all() == (seconds > 1)


# the 16 bps subcarrier mode at 8192 sps: 32 sym/s, 32 clocks a symbol
# (256 samples a symbol, 8 a subcarrier cycle), 1 s windows of 32 symbols
SUB_FS = 8192.0


@pytest.mark.parametrize("clocks_hz", [(1024.25,), (1024.4,),
                                       (1024.0, 1024.3, 1023.8),
                                       (32.0, 32.01, 31.99)],
                         ids=["1024.25", "1024.4", "three_clocks",
                              "16bps_three_clocks"])
def test_batched_tracker_matches_jax(clocks_hz):
    if clocks_hz[0] < 1000:
        # 16 bps: 5 s of subcarrier baseband, 4 windows
        jcfg, tcfg = _configs(SUB_FS, 32.0, 32)
        x = np.stack([_baseband(60 + b, f, 5.0, samprate=SUB_FS, clocks=32)
                      for b, f in enumerate(clocks_hz)])
        nwin = 4
    else:
        jcfg, tcfg = _configs()
        x = np.stack([_baseband(60 + b, f, 3.2)
                      for b, f in enumerate(clocks_hz)])
        nwin = 3
    want = jtracked.symdemod_tracked_batched(x, jcfg, nwin)
    got = ttracked.symdemod_tracked_batched(x, tcfg, nwin, device="cpu")
    _assert_tracked_equal(got, want)
    # the batched tracker is also symdemod_tracked's "auto" at B > 1
    if len(clocks_hz) > 1:
        _assert_tracked_equal(
            tsymdemod.symdemod_tracked(x, tcfg, nwin, device="cpu"), want)


@pytest.mark.parametrize("case", ["whole_window", "ends_inside", "16bps"])
@pytest.mark.parametrize("per_chunk", [1, 3, 10])
def test_window_start_search_chunked_equals_one_gather(case, per_chunk):
    """The tracked window's start search in chunks of offsets (down to one
    offset a chunk, and chunk sizes that do not divide the offsets) gives
    one gather's energy at every offset for every channel, bit for bit:
    on a whole window, on a recording that ends inside it (the slices'
    starts clamp into the prefix sum), and in the 16 bps mode (an
    inversion by half a subcarrier cycle, a few samples away, is the
    runner-up there)."""
    if case == "16bps":
        _, tcfg = _configs(SUB_FS, 32.0, 32)
        x = np.stack([_baseband(30 + b, f, 1.6, samprate=SUB_FS, clocks=32,
                                noise=900.0)
                      for b, f in enumerate((32.0, 32.01, 31.99))])
    else:
        _, tcfg = _configs()
        x = np.stack([_baseband(40 + b, 1024.0 + 0.2 * b,
                                1.6 if case == "whole_window" else 0.6)
                      for b in range(3)])
    t = ttracked.build_track_tables(tcfg, 512)
    tables = ttracked.device_tables(t, "cpu")
    csum = tsym.samples_csum(torch.from_numpy(x), tsym.track_pad(tcfg)
                             + t.noff)
    first = torch.tensor([16, 30, 9], dtype=torch.int64)
    k = torch.tensor([0, 5, -7], dtype=torch.int64)
    args = (csum, first, k, tables, t.nsym_max, t.noff, tcfg.symbolclocks,
            t.k_range)
    # per_chunk offsets a chunk, the bound not a multiple of the row
    entries = (per_chunk + 1) * t.srch.shape[1] - 1
    assert -(-t.noff // per_chunk) >= 3  # at least three chunks
    want = ttracked.window_start_energies(*args, max_entries=None)
    for got in (ttracked.window_start_energies(*args, max_entries=entries),
                ttracked.window_start_energies(*args)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    if case == "ends_inside":
        L = csum.shape[1]
        srch = t.srch[k.numpy() + t.k_range]
        assert (first.numpy()[:, None] - t.noff // 2 + srch + t.noff
                > L).any()


@pytest.mark.parametrize("nchan", [1, 2])
def test_host_tracker_matches_jax(nchan):
    """The reference's single-channel climb, each channel on its own."""
    jcfg, tcfg = _configs()
    x = np.stack([_baseband(80 + b, 1024.4 - 0.5 * b, 3.1)
                  for b in range(nchan)])
    want = jsymdemod.symdemod_tracked(x, jcfg, 3, backend="host")
    tsymdemod.reset_track_stats()
    got = tsymdemod.symdemod_tracked(x, tcfg, 3, backend="host",
                                     device="cpu")
    _assert_tracked_equal(got, want)
    stats = tsymdemod.track_stats
    assert len(stats["iterations"]) == 3 * nchan
    # each probe reads its integrators; the search two scalars; the
    # window's soft symbols one read
    assert all(r == i + 3 for r, i in zip(stats["host_reads"],
                                          stats["iterations"]))


def test_trackers_on_a_recording_that_ends_inside_the_last_window():
    """2.5 s and 3 windows: the last window's reads run past the prefix
    sum's pad, into jnp's INT32_MIN fills; both trackers still give the
    JAX package's bytes and infos."""
    jcfg, tcfg = _configs()
    x = _baseband(5, 1024.4, 2.5)[None]
    _assert_tracked_equal(
        tsymdemod.symdemod_tracked(x, tcfg, 3, device="cpu"),
        jsymdemod.symdemod_tracked(x, jcfg, 3, backend="host"))
    _assert_tracked_equal(
        ttracked.symdemod_tracked_batched(x, tcfg, 3, device="cpu"),
        jtracked.symdemod_tracked_batched(x, jcfg, 3))


def test_batched_tracker_batching_invariance():
    """Channels tracked together == each tracked alone (per-channel
    accept masks may not couple lanes)."""
    _, tcfg = _configs()
    x = np.stack([_baseband(90 + b, 1024.0 + 0.15 * b, 3.1)
                  for b in range(3)])
    soft_all, infos_all = ttracked.symdemod_tracked_batched(x, tcfg, 3,
                                                            device="cpu")
    for b in range(3):
        soft_1, infos_1 = ttracked.symdemod_tracked_batched(
            x[b : b + 1], tcfg, 3, device="cpu")
        n = soft_1.shape[1]
        np.testing.assert_array_equal(soft_all[b, :n], soft_1[0])
        for wa, w1 in zip(infos_all, infos_1):
            for key in ("symbolsamples", "firstsample", "energy"):
                assert wa[key][b] == w1[key][0]


def test_trackers_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tcfg = _configs()
    x = _baseband(1, 1024.0, 1.2)[None]
    for backend in ("host", "batched"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsymdemod.symdemod_tracked(x, tcfg, 1, backend=backend)
    with pytest.raises(ValueError, match="backend"):
        tsymdemod.symdemod_tracked(x, tcfg, 1, backend="grid",
                                   device="cpu")
