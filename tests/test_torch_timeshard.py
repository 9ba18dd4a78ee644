"""Time-axis sharding in the port (isee3_decoder_tpu_torch/parallel/
timeshard.py) against the JAX package's (tests/test_timeshard.py): the
same plan and shard views, shards within the pipeline's tolerance of
JAX's, and stitched streams that decode the sequential demod's frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models.pipeline import PipelineConfig
from isee3_decoder_tpu.ops.carrier import PMConfig
from isee3_decoder_tpu.ops.symbols import SymConfig
from isee3_decoder_tpu.parallel import make_mesh as jmake_mesh
from isee3_decoder_tpu.parallel import timeshard as jts
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu_torch.models.decode import DecodeConfig, decode_stream
from isee3_decoder_tpu_torch.models.pipeline import demod_to_symbols
from isee3_decoder_tpu_torch.parallel import make_mesh
from isee3_decoder_tpu_torch.parallel import timeshard as ts
from isee3_decoder_tpu_torch.utils import convert

CPU4 = [torch.device("cpu")] * 4


def make_cfg():
    # window (0.5 s = 16384 samples) is a whole number of FFT blocks
    # (4096); the carrier on a bin centre (4104 = 513 * 8 Hz)
    return PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=8.0),
        sym=SymConfig(samprate=32768.0, symrate=256.0, window=0.5),
    )


def _recording(seed, nframes, noise):
    cfg = make_cfg()
    rng = np.random.default_rng(seed)
    frames = testsignal.random_frames(rng, nframes)
    iq = testsignal.synthesize_iq(
        frames, samprate=cfg.pm.samprate, symrate=cfg.sym.symrate,
        carrier=4104.0, noise_std=noise, rng=rng)
    return cfg, frames, iq


@pytest.mark.parametrize("total,nshards", [(557_056, 4), (300_000, 2),
                                           (1_000_000, 3), (40_000, 1)])
def test_plan_and_views_match_jax(total, nshards):
    cfg = make_cfg()
    plan = ts.plan_time_shards(total, nshards, convert.pipeline_config(cfg))
    jplan = jts.plan_time_shards(total, nshards, cfg)
    assert dataclass_fields(plan) == dataclass_fields(jplan)
    assert (plan.chunk, plan.shard_len) == (jplan.chunk, jplan.shard_len)
    iq = (np.arange(total) % 1013).astype(np.complex64)[None, :]
    if plan.chunk < plan.halo_windows * plan.window_len and nshards > 1:
        with pytest.raises(ValueError, match="halo"):
            ts.shard_views(iq, plan)
        return
    np.testing.assert_array_equal(ts.shard_views(iq, plan),
                                  jts.shard_views(iq, jplan))


def dataclass_fields(p):
    return (p.nshards, p.chunk_windows, p.halo_windows, p.window_len)


def test_plan_refuses_unaligned_windows():
    cfg = convert.pipeline_config(PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=8.0),
        sym=SymConfig(samprate=32768.0, symrate=256.0, window=0.3)))
    with pytest.raises(ValueError, match="FFT blocks"):
        ts.plan_time_shards(500_000, 2, cfg)


def test_time_sharded_matches_jax_and_sequential():
    """Four shards on a (4, 1) mesh of logical CPU shards: each shard's
    soft symbols equal JAX's shard in all but a sliver of symbols (the
    pipeline's tolerance: baseband within 1 LSB lets a symbol on the
    decision edge flip), and after the halo ramp-up every window matches
    the sequential demod at the same absolute window (±1 symbol seam),
    as tests/test_timeshard.py:39-80 asks of the JAX package."""
    cfg, _, iq = _recording(0, 2, 400.0)
    tcfg = convert.pipeline_config(cfg)
    mesh = make_mesh(n_channels_axis=4, n_state_axis=1, devices=CPU4)
    soft_sh, plan = ts.demod_time_sharded(iq, tcfg, mesh)
    assert plan.nshards == 4
    jsoft, jplan = jts.demod_time_sharded(iq, cfg, jmake_mesh(4, 1))
    assert dataclass_fields(plan) == dataclass_fields(jplan)
    jsoft = np.asarray(jsoft)
    assert soft_sh.shape == jsoft.shape
    assert (soft_sh != jsoft).mean() < 1e-3

    soft_seq = demod_to_symbols(torch.from_numpy(iq)[None, :], tcfg)[0]
    soft_seq = soft_seq.numpy()[0]
    nsym = tcfg.sym.nsymbols
    h, c = plan.halo_windows, plan.chunk_windows
    total_match, total_cnt = 0.0, 0
    for s in range(1, plan.nshards):
        for j in range(c):
            a = soft_sh[s, 0, (h + j) * nsym:(h + j + 1) * nsym]
            b = soft_seq[(s * c + j) * nsym:(s * c + j + 1) * nsym]
            if len(a) < nsym or len(b) < nsym:
                continue
            total_match += max((a[2:-2] == b[2 - d:len(b) - 2 - d]).mean()
                               for d in (-1, 0, 1))
            total_cnt += 1
    assert total_cnt > 0
    assert total_match / total_cnt > 0.99


def test_stitched_stream_decodes():
    """The stitched shards decode the frames sent, the same good-frame
    payloads as the sequential demod (tests/test_timeshard.py:83-110)."""
    cfg, frames, iq = _recording(1, 4, 300.0)
    tcfg = convert.pipeline_config(cfg)
    mesh = make_mesh(n_channels_axis=4, n_state_axis=1, devices=CPU4)
    soft_sh, plan = ts.demod_time_sharded(iq, tcfg, mesh)
    stream = ts.stitch_shards(soft_sh, plan, tcfg)
    jstream = jts.stitch_shards(soft_sh, plan, cfg)
    np.testing.assert_array_equal(stream, jstream)
    recs, _ = decode_stream(stream, DecodeConfig(), device="cpu")
    goods = [r for r in recs if r.good[0]]
    assert len(goods) >= 1
    for r in goods:
        assert any(np.array_equal(r.data[0], f) for f in frames)
    soft_seq = demod_to_symbols(torch.from_numpy(iq)[None, :], tcfg)[0]
    recs_seq, _ = decode_stream(soft_seq.numpy(), DecodeConfig(), device="cpu")
    seq_payloads = [bytes(r.data[0]) for r in recs_seq if r.good[0]]
    assert seq_payloads, "sequential decode produced no good frames"
    assert [bytes(r.data[0]) for r in goods] == seq_payloads
