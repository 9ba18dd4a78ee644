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
