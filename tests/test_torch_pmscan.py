"""PyTorch port vs the JAX package: the pm scan in one launch (kernel K9,
``pm_backend="fused_scan"``) and the windowed DFT search alone (kernel
K8).

The kernels run here in their plain PyTorch versions (CPU tensors)
against the JAX package's Pallas kernels in interpret mode, on inputs
made with numpy from a seed.  Tolerances are those of
tests/test_carrier_raw.py: f32 sums run in another order, so peak bins,
lock decisions and ok lanes are equal, frequency and search centre
within 5e-3 Hz, C/N0 within 1e-2 dB, and each int16 baseband sample
(taken from the prefix sum's differences) within 1 LSB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models import pipeline as jpipe
from isee3_decoder_tpu.models.decode import DecodeConfig
from isee3_decoder_tpu.models.symdemod import initial_firstsample, window_samples
from isee3_decoder_tpu.ops import carrier as jc
from isee3_decoder_tpu.ops import carrier_pallas as jp
from isee3_decoder_tpu.ops import prefix_pallas
from isee3_decoder_tpu.ops.symbols import SymConfig
from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.models import pipeline as tpipe
from isee3_decoder_tpu_torch.ops import carrier as tc
from isee3_decoder_tpu_torch.ops import carrier_cuda as tk
from isee3_decoder_tpu_torch.ops.prefix_cuda import prefix_sum_blocks_plain
from isee3_decoder_tpu_torch.utils import convert
from tests.test_pmdemod import pm_signal
from tests.test_torch_pipeline import _iq

NCH = 8  # the JAX kernels tile channels by 8


def _jcfg(binsize: float, search_width: float = 100.0) -> jc.PMConfig:
    return jc.PMConfig(samprate=32768.0, binsize=binsize,
                       search_width=search_width,
                       search_backend="pallas_interpret")


def _raw_blocks(cfg, T: int, seed: int, lost: int | None = None) -> np.ndarray:
    """(NCH, T, 2n) int16 raw blocks: PM carriers 2000 + 137 Hz·i plus
    noise; channel ``lost`` carries noise only from block 1 on."""
    rng = np.random.default_rng(seed)
    n = cfg.fftsize
    data = rng.integers(0, 2, 128 * T) * 2 - 1
    iq = np.stack([
        pm_signal(T * n, cfg.samprate, 2000.0 + 137.0 * i, 1.1, data, 32.0,
                  amp=12000)
        + rng.normal(0, 300, T * n) + 1j * rng.normal(0, 300, T * n)
        for i in range(NCH)
    ])
    if lost is not None:
        iq[lost, n:] = rng.normal(0, 300, (T - 1) * n) \
            + 1j * rng.normal(0, 300, (T - 1) * n)
    ri = np.stack([iq.real, iq.imag], axis=-1).reshape(NCH, -1)
    return np.trunc(np.clip(ri, -32767, 32767)).astype(np.int16).reshape(
        NCH, T, 2 * n)


def _baseband(csum: np.ndarray, tots: np.ndarray) -> np.ndarray:
    """Per-sample baseband from an exclusive prefix sum and its totals."""
    full = np.concatenate([csum, tots[:, None]], axis=1).astype(np.int64)
    return np.diff(full, axis=1).astype(np.int32)


def test_k9_plain_matches_pallas_scan_kernel():
    """K9's plain version against the JAX _scan_kernel (interpret) on the
    same packed blocks, block-0 baseband and init lanes (from the JAX
    cold-start step)."""
    cfg = _jcfg(4.0)
    T, n = 3, cfg.fftsize
    raw = _raw_blocks(cfg, T, seed=12)
    carry1, out0 = jc.pm_demod_block_raw(jc.init_carry(NCH, cfg),
                                         jnp.asarray(raw[:, 0]), cfg)
    init = np.stack([np.zeros(NCH, np.float32), np.asarray(out0.cn0),
                     np.asarray(out0.carrier_freq),
                     np.asarray(carry1.search_center)], axis=1
                    ).astype(np.float32)
    bb0 = np.array(out0.baseband)
    K = jc._window_bins(cfg)
    args = (cfg.samprate, cfg.actual_binsize, cfg.search_width,
            cfg.cn0_threshold, K)
    cs_j, st_j, tot_j = jp.pm_scan_locked_fused(
        jp.pack_raw(jnp.asarray(raw)), jnp.asarray(bb0), jnp.asarray(init),
        *args, interpret=True)
    cs_t, st_t, tot_t = tk.pm_scan_locked_fused(
        tc.pack_raw(torch.from_numpy(raw)), torch.from_numpy(bb0),
        torch.from_numpy(init), *args)
    st_j, st_t = np.asarray(st_j), st_t.numpy()
    assert (st_j[:, 1:, 3] > 0).all()
    np.testing.assert_array_equal(st_t[..., 3], st_j[..., 3])  # ok lanes
    thr = cfg.cn0_threshold
    np.testing.assert_array_equal(st_t[..., 1] > thr, st_j[..., 1] > thr)
    np.testing.assert_allclose(st_t[..., 2], st_j[..., 2], atol=5e-3)
    np.testing.assert_allclose(st_t[..., 5], st_j[..., 5], atol=5e-3)
    np.testing.assert_allclose(st_t[..., 1], st_j[..., 1], atol=1e-2)
    assert cs_t.shape == (NCH, T * n)
    bb_t = _baseband(cs_t.numpy(), tot_t.numpy())
    bb_j = _baseband(np.asarray(cs_j), np.asarray(tot_j))
    assert np.abs(bb_t - bb_j).max() <= 1
    np.testing.assert_array_equal(bb_t[:, :n], bb0)  # block 0 enters as given
    # totals are the sum of every sample, wrapped to int32
    np.testing.assert_array_equal(
        tot_t.numpy(), bb_t.sum(axis=1).astype(np.int64).astype(np.int32))
    # the edge-extension columns repeat the total
    cs_tail, _, tot_tail = tk.pm_scan_locked_fused(
        tc.pack_raw(torch.from_numpy(raw)), torch.from_numpy(bb0),
        torch.from_numpy(init), *args, tail=2)
    assert torch.equal(cs_tail[:, : T * n], cs_t)
    assert torch.equal(cs_tail[:, T * n:], tot_tail[:, None].expand(NCH, 2))


def test_pm_demod_scan_csum_falls_back_when_a_channel_loses_lock():
    """Channel 3 carries noise only from block 1 on, so its window fails
    in block 2: both packages discard the fused result and run the block
    scan + prefix sum from the initial carry.  The port's result is its
    own block scan + plain K3, exactly."""
    cfg = _jcfg(4.0)
    T, n = 3, cfg.fftsize
    raw = _raw_blocks(cfg, T, seed=13, lost=3)
    tcfg = convert.pm_config(cfg)
    rb = torch.from_numpy(raw)
    _kernels.reset_launches()
    c_t, cs_t, st_t, tot_t = tc.pm_demod_scan_csum(tc.init_carry(NCH, tcfg),
                                                   rb, tcfg)
    assert _kernels.backend_used["pm_scan"] == "fallback"
    c_b, out_b = tc.pm_demod_scan(tc.init_carry(NCH, tcfg), rb, tcfg)
    assert torch.equal(cs_t, prefix_sum_blocks_plain(out_b.baseband))
    assert torch.equal(st_t.carrier_freq, out_b.carrier_freq)
    assert torch.equal(st_t.locked, out_b.locked)
    assert torch.equal(c_t.search_center, c_b.search_center)
    assert not bool(out_b.locked[1:, 3].any())

    c_j, cs_j, st_j, tot_j = jc.pm_demod_scan_csum(
        jc.init_carry(NCH, cfg), jnp.asarray(raw), cfg)
    np.testing.assert_array_equal(st_t.locked.numpy(), np.asarray(st_j.locked))
    np.testing.assert_allclose(st_t.carrier_freq.numpy(),
                               np.asarray(st_j.carrier_freq), atol=5e-3)
    bb_t = _baseband(cs_t.numpy(), tot_t.numpy())
    bb_j = _baseband(np.asarray(cs_j), np.asarray(tot_j))
    assert np.abs(bb_t - bb_j).max() <= 1


def test_receive_block_fused_scan_matches_jax():
    """receive_block with pm_backend="fused_scan" on both packages (the
    JAX one with its kernels interpreted): frame bytes, good flags,
    decoder labels, start symbols and sync starts equal; baseband within
    1 LSB."""
    cfg = jpipe.PipelineConfig(
        pm=_jcfg(4.0),
        sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5),
        decode=DecodeConfig(viterbi_enabled=False),
        csum_backend="pallas_interpret",
        pm_backend="fused_scan",
    )
    _, iq = _iq(14, [900.0] * NCH)
    n = cfg.pm.fftsize
    nblocks = iq.shape[1] // (2 * n)
    nwindows = (nblocks * n - initial_firstsample(cfg.sym)) \
        // window_samples(cfg.sym) - 1
    # both gates of the JAX fused scan pass, so both packages run it
    assert jc._scan_fused_capable(cfg.pm, NCH, n, nblocks)
    assert jpipe._fused_csum_ok(cfg, NCH, n, nblocks, nwindows)
    tcfg = convert.pipeline_config(cfg)
    assert tcfg.pm_backend == "fused_scan"

    rec_j, ss_j = jpipe.receive_block(iq, 1, cfg)
    _kernels.reset_launches()
    rec_t, ss_t = tpipe.receive_block(torch.from_numpy(iq), 1, tcfg,
                                      device="cpu")
    assert _kernels.backend_used["pm_scan"] == "torch"  # ran, no fallback
    np.testing.assert_array_equal(ss_t, ss_j)
    for f in ("data", "good", "decoder", "start_symbol"):
        np.testing.assert_array_equal(getattr(rec_t, f), getattr(rec_j, f), f)
    assert rec_t.good.all()

    _, bb_j, _, _ = jpipe.demod_to_symbols(jnp.asarray(iq), cfg)
    _, bb_t, _, _ = tpipe.demod_to_symbols(torch.from_numpy(iq), tcfg)
    assert bb_t.dtype == torch.int16 and bb_t.shape == bb_j.shape
    diff = np.abs(bb_t.numpy().astype(np.int32) - np.asarray(bb_j, np.int32))
    assert diff.max() <= 1, diff.max()


def test_unknown_pm_backend_raises():
    tcfg = tpipe.PipelineConfig(pm_backend="pallas")
    with pytest.raises(ValueError, match="pm_backend"):
        tpipe.demod_to_symbols(torch.zeros((1, 2 * 65536), dtype=torch.int16),
                               tcfg)


def test_pipeline_config_converts_pm_backend():
    cfg = jpipe.PipelineConfig(pm_backend="fused_scan")
    assert convert.pipeline_config(cfg).pm_backend == "fused_scan"
    assert convert.pipeline_config(jpipe.PipelineConfig()).pm_backend == "auto"


def test_k8_plain_matches_pallas_windowed_dft():
    """K8's plain version against find_carrier_windowed_raw with the JAX
    _kernel interpreted, at n = 4096 (binsize 8)."""
    cfg = _jcfg(8.0)
    raw = _raw_blocks(cfg, 1, seed=15)[:, 0]
    freqs = 2000.0 + 137.0 * np.arange(NCH)
    carry = jc.PMCarry(search_center=jnp.asarray(freqs, jnp.float32),
                       cn0=jnp.full((NCH,), 60.0, jnp.float32))
    f_j, pk_j = jc.find_carrier_windowed_raw(jp.pack_raw(jnp.asarray(raw)),
                                             carry, cfg, interpret=True)
    f_t, pk_t = tc.find_carrier_windowed_raw(
        tc.pack_raw(torch.from_numpy(raw)), convert.pm_carry(carry),
        convert.pm_config(cfg))
    np.testing.assert_array_equal(pk_t.numpy(), np.asarray(pk_j))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=5e-3)


def test_pm_demod_scan_n4096_takes_k8_and_matches_jax():
    """Three raw blocks at n = 4096: cold start, then locked blocks that
    search with K8 and spin down with K2 (the JAX package: its
    windowed_dft_raw + spin_down_raw), carry threaded across blocks."""
    cfg = _jcfg(8.0)
    T = 3
    raw = _raw_blocks(cfg, T, seed=16)
    # the JAX package's K8 branch needs its default 32-bit mode (the
    # suite's x64 makes its lax.cond branches return float64 and float32)
    with jax.enable_x64(False):
        c_j, out_j = jc.pm_demod_scan(jc.init_carry(NCH, cfg),
                                      jnp.asarray(raw), cfg)
    tcfg = convert.pm_config(cfg)
    _kernels.reset_launches()
    c_t, out_t = tc.pm_demod_scan(tc.init_carry(NCH, tcfg),
                                  torch.from_numpy(raw), tcfg)
    assert _kernels.backend_used["search"] == "torch"  # the K8 branch ran
    assert np.asarray(out_j.locked).all()
    np.testing.assert_array_equal(out_t.locked.numpy(), np.asarray(out_j.locked))
    np.testing.assert_allclose(out_t.carrier_freq.numpy(),
                               np.asarray(out_j.carrier_freq), atol=5e-3)
    np.testing.assert_allclose(out_t.cn0.numpy(), np.asarray(out_j.cn0),
                               atol=1e-2)
    np.testing.assert_allclose(c_t.search_center.numpy(),
                               np.asarray(c_j.search_center), atol=5e-3)
    diff = np.abs(out_t.baseband.numpy().astype(np.int32)
                  - np.asarray(out_j.baseband, np.int32))
    assert diff.max() <= 1, diff.max()
