"""The port's multi-device layer (isee3_decoder_tpu_torch/parallel) on
logical shards: meshes of repeated CPU devices, against the port's
unsharded functions and the JAX package's sharded ones on its 8 forced
CPU devices (tests/test_parallel.py, tests/test_viterbi_sharded_k24.py)."""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu import parallel as jpar
from isee3_decoder_tpu.config import CodeSpec
from isee3_decoder_tpu.models.pipeline import PipelineConfig
from isee3_decoder_tpu.ops.carrier import PMConfig
from isee3_decoder_tpu.ops.encode import encode_bits
from isee3_decoder_tpu.ops.symbols import SymConfig
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu_torch import parallel as tpar
from isee3_decoder_tpu_torch.config import MCQLI24
from isee3_decoder_tpu_torch.models import pipeline as tpipe
from isee3_decoder_tpu_torch.ops import viterbi
from isee3_decoder_tpu_torch.parallel.mesh import channel_blocks
from isee3_decoder_tpu_torch.utils import convert

K9F = CodeSpec("TESTK9F", 0o713, 0o715, 9, 0, 1)
K17 = CodeSpec("TESTK17", 0o247153, 0o367615, 17, 0, 0)
CPU8 = [torch.device("cpu")] * 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _noisy(rng, code, B, nbits, lo=88, hi=168, spread=60):
    bits = rng.integers(0, 2, (B, nbits), dtype=np.uint8)
    bits[:, -(code.k - 1):] = 0
    syms, _ = encode_bits(jnp.asarray(bits), 0, code)
    soft = np.clip(np.where(np.asarray(syms) > 0, hi, lo).astype(np.int32)
                   + rng.integers(-spread, spread, syms.shape), 0, 255)
    return bits, soft.astype(np.uint8)


def test_state_sharded_viterbi_matches_single_device_and_jax():
    """K9F on a (2, 4) mesh: the four-move shuffle exchange gives the
    port's decode_frame and the JAX decode_frame_sharded bit for bit."""
    rng = np.random.default_rng(0)
    bits, noisy = _noisy(rng, K9F, 2, 80)
    mesh = tpar.make_mesh(n_channels_axis=2, n_state_axis=4, devices=CPU8)
    got = tpar.decode_frame_sharded(noisy, mesh, 80, 0, 0, K9F).numpy()
    want = viterbi.decode_frame(noisy, 80, 0, 0, K9F, device="cpu").numpy()
    jmesh = jpar.make_mesh(n_channels_axis=2, n_state_axis=4)
    jgot = np.asarray(jpar.decode_frame_sharded(jnp.asarray(noisy), jmesh, 80,
                                                0, 0, K9F))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(want, bits)


@pytest.mark.parametrize("ch,state", [(1, 1), (1, 2), (2, 2), (1, 8), (4, 2)])
def test_update_blk_sharded_matches_jax(ch, state):
    """The sharded ACS's final metrics and decision words equal the JAX
    update_blk_sharded's on every mesh shape (the words as int32)."""
    rng = np.random.default_rng(ch * 10 + state)
    _, noisy = _noisy(rng, K9F, 4, 40)
    metrics = np.full((4, K9F.nstates), 5000, np.int32)
    metrics[:, 0] = 0
    mesh = tpar.make_mesh(ch, state, devices=CPU8)
    m_t, d_t = tpar.update_blk_sharded(metrics, noisy, mesh, 40, K9F)
    jmesh = jpar.make_mesh(ch, state)
    m_j, d_j = jpar.update_blk_sharded(jnp.asarray(metrics), jnp.asarray(noisy),
                                       jmesh, 40, K9F)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(d_t.numpy(),
                                  np.asarray(d_j).astype(np.uint32).view(np.int32))


def test_k17_sharded_over_eight_shards():
    """A 2^16-state lattice over a (1, 8) mesh == the unsharded decoder."""
    rng = np.random.default_rng(17)
    bits, noisy = _noisy(rng, K17, 1, 64, spread=50)
    mesh = tpar.make_mesh(n_channels_axis=1, n_state_axis=8, devices=CPU8)
    got = tpar.decode_frame_sharded(noisy, mesh, 64, 0, 0, K17).numpy()
    want = viterbi.decode_frame(noisy, 64, 0, 0, K17, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, bits)


def test_k24_sharded_matches_unsharded():
    """The real MCQLI-24 lattice, 2^23 states over 8 shards, a noisy
    96-bit frame (tests/test_viterbi_sharded_k24.py:34-48); ~7 s on the
    CPU."""
    rng = np.random.default_rng(77)
    bits = rng.integers(0, 2, (1, 96), dtype=np.uint8)
    bits[:, -(MCQLI24.k - 1):] = 0
    syms, _ = encode_bits(jnp.asarray(bits), 0, MCQLI24)
    soft = np.where(np.asarray(syms) > 0, 168.0, 88.0)
    soft = np.clip(soft + rng.normal(0, 28.0, soft.shape), 0, 255).astype(np.uint8)
    mesh = tpar.make_mesh(n_channels_axis=1, n_state_axis=8, devices=CPU8)
    got = tpar.decode_frame_sharded(soft, mesh, 96, 0, 0, MCQLI24).numpy()
    want = viterbi.decode_frame(soft, 96, 0, 0, MCQLI24, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def _demod_cfg():
    return PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=8.0),
        sym=SymConfig(samprate=32768.0, symrate=128.0, window=0.5),
    )


def test_channel_sharded_demod_matches_single_device():
    """8 channels over an (8, 1) mesh: soft symbols equal to the port's
    unsharded demod_to_symbols, carrier freq within rtol 1e-5
    (tests/test_parallel.py:53-78); against the JAX sharded demod
    within the pipeline tests' tolerance (baseband 1 LSB, freq 5e-3 Hz)."""
    rng = np.random.default_rng(1)
    cfg = _demod_cfg()
    frames = testsignal.random_frames(rng, 1)
    iq = np.stack([
        testsignal.synthesize_iq(
            frames, samprate=32768.0, symrate=128.0, carrier=2000.0 + 130.0 * c,
            noise_std=500.0, rng=np.random.default_rng(100 + c),
        )[: 3 * cfg.pm.fftsize]
        for c in range(8)
    ])
    tcfg = convert.pipeline_config(cfg)
    mesh = tpar.make_mesh(n_channels_axis=8, n_state_axis=1, devices=CPU8)
    soft_s, bb_s, f_s, c_s = tpar.demod_to_symbols_sharded(iq, tcfg, mesh)
    soft_1, bb_1, f_1, c_1 = tpipe.demod_to_symbols(torch.from_numpy(iq), tcfg)
    np.testing.assert_array_equal(soft_s.numpy(), soft_1.numpy())
    np.testing.assert_array_equal(bb_s.numpy(), bb_1.numpy())
    np.testing.assert_allclose(f_s.numpy(), f_1.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(c_s.numpy(), c_1.numpy())
    jmesh = jpar.make_mesh(n_channels_axis=8, n_state_axis=1)
    soft_j, bb_j, f_j, _ = jpar.demod_to_symbols_sharded(iq, cfg, jmesh)
    assert soft_s.shape == np.asarray(soft_j).shape
    diff = np.abs(bb_s.numpy().astype(np.int32) - np.asarray(bb_j, np.int32))
    assert diff.max() <= 1
    np.testing.assert_allclose(f_s.numpy(), np.asarray(f_j), atol=5e-3)


@pytest.mark.parametrize("ch,state", [(4, 2), (8, 1), (2, 4), (1, 8)])
def test_mesh_shapes(ch, state):
    mesh = tpar.make_mesh(n_channels_axis=ch, n_state_axis=state, devices=CPU8)
    assert mesh.shape == {"ch": ch, "state": state}
    assert mesh.devices.shape == (ch, state) and mesh.size == 8
    jmesh = jpar.make_mesh(n_channels_axis=ch, n_state_axis=state)
    assert dict(jmesh.shape) == mesh.shape
    assert tpar.make_mesh(n_state_axis=state, devices=CPU8).shape["ch"] == 8 // state


def test_mesh_refusals_and_channel_blocks():
    with pytest.raises(ValueError, match="devices"):
        tpar.make_mesh(3, 3, devices=CPU8)
    mesh = tpar.make_mesh(4, 1, devices=CPU8)
    assert [s for _, s in tpar.channel_sharding(mesh, 2).shards(8)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="equal"):
        tpar.shard_channels(np.zeros((6, 4)), mesh)
    with pytest.raises(ValueError, match="equal"):
        channel_blocks(10, 4)
    blocks = tpar.shard_channels(np.arange(16).reshape(8, 2), mesh)
    assert [b.tolist() for b in blocks] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                            [[8, 9], [10, 11]],
                                            [[12, 13], [14, 15]]]


def test_make_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()


@pytest.mark.slow
def test_channel_sharded_receive_block_matches_single_device():
    """The fused IQ→frames chain sharded over 8 channels returns the
    unsharded packed buffer byte for byte (tests/test_parallel.py:81-122)."""
    from isee3_decoder_tpu_torch.models.decode import unpack_block_buffer

    rng = np.random.default_rng(5)
    frames = testsignal.random_frames(rng, 4)
    chans = [testsignal.synthesize_iq(
        frames, samprate=250_000.0, symrate=1024.0, carrier=20_000.0 + 140.0 * c,
        noise_std=800.0, lead_symbols=20, rng=np.random.default_rng(200 + c))
        for c in range(8)]
    L = min(len(q) for q in chans)
    iq = np.stack([q[:L] for q in chans])
    cfg = convert.pipeline_config(PipelineConfig(
        pm=PMConfig(samprate=250_000.0, binsize=4.0, search_width=100.0),
        sym=SymConfig(samprate=250_000.0, symrate=1024.0)))
    mesh = tpar.make_mesh(n_channels_axis=8, n_state_axis=1, devices=CPU8)
    buf_s = tpar.receive_block_sharded(iq, 1, cfg, mesh).numpy()
    buf_1 = tpipe.receive_block_device(torch.from_numpy(iq), 1, 2048, cfg).numpy()
    np.testing.assert_array_equal(buf_s, buf_1)
    data, good, *_ = unpack_block_buffer(buf_s, 8, 1)
    assert good.all()
    for ch in range(8):
        assert any(np.array_equal(data[ch], fr) for fr in frames)


def test_merge_block_buffers_sections():
    """Block buffers of 3 and 1 channels at 2 frames a channel merge
    section by section into the 4-channel layout."""
    from isee3_decoder_tpu_torch.parallel.sharding import merge_block_buffers

    def buf(B, base):
        L = 2 * B
        secs = [np.full(L * 128, base, np.uint8), np.full(L, base + 1, np.uint8),
                np.full(L, base + 2, np.uint8), np.full(L, base + 3, np.uint8),
                np.full(4 * L, base + 4, np.uint8), np.full(4 * B, base + 5, np.uint8)]
        return torch.from_numpy(np.concatenate(secs)), secs

    (a, sa), (b, sb) = buf(3, 10), buf(1, 20)
    got = merge_block_buffers([a, b], [3, 1], 2).numpy()
    want = np.concatenate([np.concatenate([x, y]) for x, y in zip(sa, sb)])
    np.testing.assert_array_equal(got, want)


WORKER = textwrap.dedent("""
    import sys, torch
    import torch.distributed as dist
    sys.path.insert(0, sys.argv[3])
    from isee3_decoder_tpu_torch.parallel.mesh import init_multihost, process_channels
    coord, pid = sys.argv[1], int(sys.argv[2])
    init_multihost(coordinator=coord, num_processes=2, process_id=pid)
    assert dist.get_world_size() == 2 and dist.get_rank() == pid
    rows = process_channels(8)
    assert rows == slice(4 * pid, 4 * pid + 4), rows
    x = torch.tensor([float(rows.start)])
    dist.all_reduce(x)
    assert x.item() == 4.0, x
    dist.destroy_process_group()
    print(f"proc {pid} OK", flush=True)
""")


@pytest.mark.slow
def test_two_process_init_multihost(tmp_path):
    """Two CPU processes join one gloo world through init_multihost, each
    owns its block of 4 of 8 channels, and an all-reduce crosses them."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [subprocess.Popen([sys.executable, str(script), addr, str(i), ROOT],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out
