"""PyTorch port vs the JAX package: the prefix-sum kernel K3 and the
symbol demodulator.  All exact: integer prefix sums, and float64 energies
of integer integrators (exact sums), so every timing decision and soft
symbol matches given an identical prefix sum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models import symdemod as jsd
from isee3_decoder_tpu.ops import prefix_pallas as jpp
from isee3_decoder_tpu.ops import symbols as jsym
from isee3_decoder_tpu_torch.models import symdemod as tsd
from isee3_decoder_tpu_torch.ops import prefix_cuda as tpp
from isee3_decoder_tpu_torch.ops import symbols as tsym
from isee3_decoder_tpu_torch.utils import convert

SYM = jsym.SymConfig(samprate=32768.0, symrate=512.0, window=0.5)


def _baseband(seed: int, B: int, nsamples: int, symbolsamples: float,
              noise: float) -> np.ndarray:
    """Manchester baseband (int16) with random data and timing offsets."""
    rng = np.random.default_rng(seed)
    t = np.arange(nsamples)
    rows = []
    for b in range(B):
        pos = (t + rng.uniform(0, symbolsamples)) / symbolsamples
        data = rng.integers(0, 2, int(pos[-1]) + 2) * 2 - 1
        level = data[pos.astype(np.int64)]
        wave = np.where((pos % 1.0) >= 0.5, level, -level) * 3000.0
        rows.append(np.clip(np.round(wave + rng.normal(0, noise, nsamples)),
                            -32768, 32767))
    return np.stack(rows).astype(np.int16)


@pytest.mark.parametrize("T,B,n", [(3, 8, 256), (2, 16, 1024)])
def test_k3_plain_matches_pallas_prefix_kernel(T, B, n):
    rng = np.random.default_rng(T * n)
    blocks = rng.integers(-32768, 32768, (T, B, n)).astype(np.int16)
    want = np.asarray(jpp.prefix_sum_blocks(jnp.asarray(blocks), interpret=True))
    got = tpp.prefix_sum_blocks(torch.from_numpy(blocks))
    np.testing.assert_array_equal(got.numpy(), want)
    # tail columns: the edge extension equals the JAX padded prefix sum
    flat = np.swapaxes(blocks, 0, 1).reshape(B, T * n)
    got = tpp.prefix_sum_blocks(torch.from_numpy(blocks), tail=3)
    padded = np.asarray(jsym.prefix_sum(jnp.asarray(flat), pad_to=T * n + 2))
    np.testing.assert_array_equal(got.numpy(), padded)
    np.testing.assert_array_equal(
        tsym.prefix_sum(torch.from_numpy(flat), pad_to=T * n + 2).numpy(), padded
    )


@pytest.mark.parametrize("B,L", [(8, 1024), (16, 3 * 2048), (8, 65536)])
def test_k3_prefix_sum_flat_matches_pallas(B, L):
    # K3's second call site: (B, L) int16 → (B, L) int32, no tail column;
    # a row of 32767s runs up to 2^31 - 2^16 at L = 65536
    rng = np.random.default_rng(B + L)
    samples = rng.integers(-32768, 32768, (B, L)).astype(np.int16)
    samples[0] = 32767
    want = np.asarray(jpp.prefix_sum_flat(jnp.asarray(samples),
                                          interpret=True))
    got = tpp.prefix_sum_flat(torch.from_numpy(samples))
    assert got.dtype == torch.int32 and got.shape == (B, L)
    np.testing.assert_array_equal(got.numpy(), want)


def test_integrate_and_timesearch_match_jax():
    bb = _baseband(1, 3, 40_000, SYM.symbolsamples, 900.0)
    csum = np.array(jsym.prefix_sum(jnp.asarray(bb), pad_to=bb.shape[1] + 512))
    first = np.array([32, 37, 90])
    args = (SYM.halfclock, SYM.nsymbols, SYM.symbolclocks)
    np.testing.assert_array_equal(
        tsym.integrate_from_csum(torch.from_numpy(csum),
                                 torch.from_numpy(first), *args).numpy(),
        np.asarray(jsym.integrate_from_csum(jnp.asarray(csum),
                                            jnp.asarray(first), *args)),
    )
    ts_t = tsym.timesearch_from_csum(torch.from_numpy(csum),
                                     torch.from_numpy(first), *args, SYM.noffsets)
    ts_j = jsym.timesearch_from_csum(jnp.asarray(csum), jnp.asarray(first),
                                     *args, SYM.noffsets)
    np.testing.assert_array_equal(ts_t.symphase.numpy(), np.asarray(ts_j.symphase))
    np.testing.assert_array_equal(ts_t.maxenergy.numpy(),
                                  np.asarray(ts_j.maxenergy))


def test_symdemod_scan_csum_soft_symbols_exact():
    """Identical csum in → identical soft symbols, phases, energies and
    window starts out."""
    bb = _baseband(2, 4, 3 * 16384 + 1000, SYM.symbolsamples, 1200.0)
    nwin = 2
    csum = np.array(jsym.prefix_sum(jnp.asarray(bb), pad_to=bb.shape[1] + 1024))
    tsym_cfg = convert.sym_config(SYM)
    f_t, out_t = tsd.symdemod_scan_csum(torch.from_numpy(csum), tsym_cfg, nwin)
    f_j, out_j = jsd.symdemod_scan_csum(jnp.asarray(csum), SYM, nwin)
    np.testing.assert_array_equal(out_t.soft.numpy(), np.asarray(out_j.soft))
    np.testing.assert_array_equal(out_t.symphase.numpy(), np.asarray(out_j.symphase))
    np.testing.assert_array_equal(out_t.energy.numpy(), np.asarray(out_j.energy))
    np.testing.assert_array_equal(out_t.firstsample.numpy(),
                                  np.asarray(out_j.firstsample))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    # the same through the samples entry point (each pads its own csum)
    _, out_t2 = tsd.symdemod_scan(torch.from_numpy(bb), tsym_cfg, nwin)
    _, out_j2 = jsd.symdemod_scan(jnp.asarray(bb), SYM, nwin)
    np.testing.assert_array_equal(out_t2.soft.numpy(), np.asarray(out_j2.soft))


# (samprate, symrate, symbolclocks, window) → the JAX timesearch tier its
# edge table takes (symbols.py:512-535): symbol groups, framed slices, or
# the elementwise gather; the port computes every one as the gather
TIER_CASES = {
    "grouped": (32768.0, 512.0, 1, 0.5),
    "grouped_c2": (10000.0, 333.3, 2, 0.25),
    "framed": (30000.0, 2048.0, 1, 0.5),
    "gather": (10000.0, 1024.0, 2, 1.0),
}


@pytest.mark.parametrize("case", list(TIER_CASES))
def test_timesearch_matches_every_jax_tier(case):
    """The JAX package's grouped and framed timesearch tiers compute the
    gather tier's function from the same prefix-sum entries; the port's
    one formulation gives each tier's symbol phase exactly and its energy
    within f32 summation order."""
    fs, sr, clocks, window = TIER_CASES[case]
    cfg = jsym.SymConfig(samprate=fs, symrate=sr, symbolclocks=clocks,
                         window=window)
    rel = jsym.search_edges(cfg.halfclock, cfg.nsymbols, cfg.symbolclocks)
    groups = jsym._symbol_group_plan(rel, cfg.noffsets, cfg.symbolclocks)
    framed = jsym._framing_plan(rel, cfg.noffsets) if groups is None else None
    tier = ("grouped" if groups is not None
            else "framed" if framed is not None else "gather")
    assert tier == case.split("_")[0]
    nsamples = int(rel[-1]) + 4 * cfg.noffsets + 200
    bb = _baseband(7, 3, nsamples, cfg.symbolsamples / cfg.symbolclocks, 900.0)
    csum = np.array(jsym.prefix_sum(jnp.asarray(bb), pad_to=nsamples + 1024))
    first = np.array([cfg.noffsets, cfg.noffsets + 5, 2 * cfg.noffsets])
    args = (cfg.halfclock, cfg.nsymbols, cfg.symbolclocks, cfg.noffsets)
    ts_t = tsym.timesearch_from_csum(torch.from_numpy(csum),
                                     torch.from_numpy(first), *args)
    ts_j = jsym.timesearch_from_csum(jnp.asarray(csum), jnp.asarray(first),
                                     *args)
    np.testing.assert_array_equal(ts_t.symphase.numpy(),
                                  np.asarray(ts_j.symphase))
    np.testing.assert_allclose(ts_t.maxenergy.numpy(),
                               np.asarray(ts_j.maxenergy), rtol=1e-6)


# the three operational modes at 250 ksps (SURVEY.md:48-49): 512 bps
# (245 offsets x 2049 edges a channel, one chunk), 2048 bps (61 x 8193,
# one chunk) and 16 bps on the 1024 Hz subcarrier (7813 x 2049: 32
# chunks of 245 offsets, the last one short)
MODE_SHAPES = {
    "512bps": (1024.0, 1),
    "2048bps": (4096.0, 1),
    "16bps_subcarrier": (32.0, 32),
}


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("mode", list(MODE_SHAPES))
def test_timesearch_chunked_equals_one_gather(mode, fill):
    """The offset sweep in chunks of at most SEARCH_ENTRIES prefix-sum
    entries a channel gives the one-gather result bit for bit: symphase,
    maxenergy and the earliest maximum where offsets tie across chunk
    borders (channel 1's baseband is all zeros, so every offset ties).
    A smaller chunk (7 offsets) cuts the 512 and 2048 bps sweeps, which
    SEARCH_ENTRIES leaves whole.
    ``fill`` reads as the trackers do: channel 0 starts so late that its
    last edges read past the prefix sum (INT32_MIN fills)."""
    symrate, clocks = MODE_SHAPES[mode]
    cfg = tsym.SymConfig(samprate=250_000.0, symrate=symrate,
                         symbolclocks=clocks)
    nsamples = 250_000 + 2 * cfg.noffsets
    bb = _baseband(11, 2, nsamples, cfg.symbolsamples / clocks, 900.0)
    bb[1] = 0
    csum = tsym.prefix_sum(torch.from_numpy(bb), pad_to=nsamples + 8)
    late = nsamples - 250_000 + cfg.noffsets // 2 if fill else cfg.noffsets
    first = torch.tensor([late, cfg.noffsets])
    args = (csum, first, cfg.halfclock, cfg.nsymbols, clocks, cfg.noffsets)
    nedges = 2 * clocks * cfg.nsymbols + 1
    want = tsym.timesearch_from_csum(*args, fill=fill, max_entries=None)
    assert int(want.symphase[1]) == -(cfg.noffsets // 2)
    whole = tsym.SEARCH_ENTRIES >= cfg.noffsets * nedges
    for max_entries in (tsym.SEARCH_ENTRIES,) + ((7 * nedges,) if whole else ()):
        got = tsym.timesearch_from_csum(*args, fill=fill,
                                        max_entries=max_entries)
        assert torch.equal(got.symphase, want.symphase)
        assert torch.equal(got.maxenergy, want.maxenergy)
    if not whole:  # 16 bps: 32 chunks
        assert -(-cfg.noffsets // (tsym.SEARCH_ENTRIES // nedges)) == 32
