"""The port's channel- and time-sharded entry points (parallel/) on meshes
of repeated CPU devices, in both pm precisions: byte for byte the
unsharded results, and a shard's exception reaches the caller.  The
shards run one after another (the card's run is in
tests/test_torch_cuda.py and chip_smoke.py phase 18)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models.pipeline import PipelineConfig
from isee3_decoder_tpu.ops.carrier import PMConfig
from isee3_decoder_tpu.ops.symbols import SymConfig
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu_torch import parallel as tpar
from isee3_decoder_tpu_torch.models import pipeline as tpipe
from isee3_decoder_tpu_torch.models.decode import unpack_block_buffer
from isee3_decoder_tpu_torch.parallel import sharding, timeshard
from isee3_decoder_tpu_torch.utils import convert

S = 4
CPU4 = [torch.device("cpu")] * S
DTYPES = pytest.mark.parametrize("dtype", [np.float32, np.float64],
                                 ids=["float32", "float64"])


def _channels(dtype=np.float32) -> tuple[np.ndarray, np.ndarray, object]:
    """Four clean channels at 32,768 sps, locked search (K1's path in
    float32, the plain golden branch in float64), as raw int16."""
    rng = np.random.default_rng(40)
    frames = testsignal.random_frames(rng, 3)
    chans = [testsignal.iq_to_int16(testsignal.synthesize_iq(
        frames, samprate=32768.0, symrate=512.0, carrier=4000.0 + 900.0 * c,
        noise_std=500.0, lead_symbols=20, rng=np.random.default_rng(300 + c)))
        for c in range(S)]
    L = min(len(q) for q in chans)
    cfg = convert.pipeline_config(PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0,
                    dtype=dtype),
        sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5)))
    return frames, np.stack([q[:L] for q in chans]), cfg


@DTYPES
def test_receive_block_sharded_equals_unsharded(dtype):
    frames, iq, cfg = _channels(dtype)
    want = tpipe.receive_block_device(torch.from_numpy(iq), 1, 2048, cfg)
    got = tpar.receive_block_sharded(iq, 1, cfg,
                                     tpar.make_mesh(S, 1, devices=CPU4))
    assert torch.equal(got, want)
    data, good, *_ = unpack_block_buffer(got.numpy(), S, 1)
    assert good.all()
    for d in data:
        assert any(np.array_equal(d, f) for f in frames)


@DTYPES
def test_demod_to_symbols_sharded_equals_unsharded(dtype):
    _, iq, cfg = _channels(dtype)
    want = tpipe.demod_to_symbols(torch.from_numpy(iq), cfg)
    got = tpar.demod_to_symbols_sharded(iq, cfg,
                                        tpar.make_mesh(S, 1, devices=CPU4))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@DTYPES
def test_demod_time_sharded_equals_each_view(dtype):
    """Each time shard's soft symbols equal demod_to_symbols on its view."""
    cfg = convert.pipeline_config(PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=8.0, dtype=dtype),
        sym=SymConfig(samprate=32768.0, symrate=256.0, window=0.5)))
    rng = np.random.default_rng(41)
    iq = testsignal.synthesize_iq(
        testsignal.random_frames(rng, 2), samprate=32768.0, symrate=256.0,
        carrier=4104.0, noise_std=400.0, rng=rng)
    plan = timeshard.plan_time_shards(iq.shape[-1], S, cfg)
    want = [tpipe.demod_to_symbols(torch.from_numpy(v), cfg)[0].numpy()
            for v in timeshard.shard_views(iq[None, :], plan)]
    soft, plan2 = tpar.demod_time_sharded(iq, cfg,
                                          tpar.make_mesh(S, 1, devices=CPU4))
    assert plan2 == plan
    np.testing.assert_array_equal(soft, np.stack(want))


def test_a_sharded_entry_point_raises_a_shard_error(monkeypatch):
    _, iq, cfg = _channels()
    stage = sharding.receive_block_device

    def failing(block, *args):
        if int(block[0, 0]) == int(iq[2, 0]):
            raise RuntimeError("channel block 2")
        return stage(block, *args)

    monkeypatch.setattr(sharding, "receive_block_device", failing)
    assert len({int(v) for v in iq[:, 0]}) == S
    with pytest.raises(RuntimeError, match="channel block 2"):
        tpar.receive_block_sharded(iq, 1, cfg, tpar.make_mesh(S, 1, devices=CPU4))
