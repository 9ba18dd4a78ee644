"""PyTorch port: utils/checkpoint (the .npz format version 2 with its
JSON manifest) — the checkpoint cases of tests/test_checkpoint_and_more.py
on the port's states, and files that cross between the packages: one
written by the JAX package restores in the port and one written by the
port restores in the JAX package."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.config import CodeSpec
from isee3_decoder_tpu.ops import carrier as jcarrier
from isee3_decoder_tpu.ops import viterbi as jviterbi
from isee3_decoder_tpu.utils import checkpoint as jckpt
from isee3_decoder_tpu_torch.models.decode import DecodeStreamState
from isee3_decoder_tpu_torch.ops import viterbi
from isee3_decoder_tpu_torch.ops import viterbi_inplace as vip
from isee3_decoder_tpu_torch.ops.carrier import PMConfig, init_carry, pm_demod_block
from isee3_decoder_tpu_torch.ops.encode import encode_bits
from isee3_decoder_tpu_torch.ops.viterbi_fused import stream_update_fused
from isee3_decoder_tpu_torch.utils import checkpoint, convert
from isee3_decoder_tpu_torch.utils.checkpoint import (
    load_manifest,
    restore_pytree,
    save_pytree,
)

JK7 = CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)
K7 = convert.code_spec(JK7)
K15 = convert.code_spec(CodeSpec("TESTK15", 0o46321, 0o51445, 15, 0, 1))


def _soft(bits: np.ndarray, code) -> torch.Tensor:
    syms, _ = encode_bits(torch.from_numpy(bits), 0, code)
    return torch.where(syms > 0, 200, 56).to(torch.uint8)


def test_viterbi_state_checkpoint_roundtrip(tmp_path):
    """A classic Viterbi decode interrupted mid-frame and restored from
    disk decodes the frame (the checkpoint the reference lacks, SURVEY.md
    §5.4)."""
    rng = np.random.default_rng(0)
    nbits = 120
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    bits[-(K7.k - 1):] = 0
    soft = _soft(bits, K7)
    st = viterbi.create(nbits, 1, K7, 0, device="cpu")
    st = viterbi.update_blk(st, soft[:nbits], K7)  # half the frame
    path = tmp_path / "vit_state.npz"
    save_pytree(path, st)
    st2 = restore_pytree(path, viterbi.create(nbits, 1, K7, 0, device="cpu"))
    assert isinstance(st2.dp, int) and st2.dp == st.dp
    st2 = viterbi.update_blk(st2, soft[nbits:], K7)
    got = viterbi.chainback(st2, nbits, 0, K7)[0].numpy()
    np.testing.assert_array_equal(got, bits)


def test_pm_carry_checkpoint(tmp_path):
    cfg = PMConfig(samprate=32768.0, binsize=8.0, search_width=100.0)
    n = cfg.fftsize
    t = np.arange(2 * n)
    iq = torch.from_numpy(
        (9000 * np.exp(1j * 2 * np.pi * 1500.0 * t / cfg.samprate))
        .astype(np.complex64))
    c = init_carry(1, cfg, device="cpu")
    c, _ = pm_demod_block(c, iq[None, :n], cfg)
    save_pytree(tmp_path / "pm.npz", c)
    c2 = restore_pytree(tmp_path / "pm.npz", init_carry(1, cfg, device="cpu"))
    _, out_a = pm_demod_block(c, iq[None, n:], cfg)
    _, out_b = pm_demod_block(c2, iq[None, n:], cfg)
    assert torch.equal(out_a.baseband, out_b.baseband)


def test_fused_stream_state_checkpoint_roundtrip(tmp_path):
    """The fused streaming decoder's circular tape survives a save and
    restore mid-stream: the resumed decoder emits an uninterrupted run's
    fixed-delay bits."""
    w = K15.k - 1
    rng = np.random.default_rng(9)
    nbits, delay, chunk = 280, 40, 10 * w  # two cycle-aligned chunks
    soft = _soft(rng.integers(0, 2, nbits, dtype=np.uint8), K15)

    def run(st, start):
        outs, done = [], start
        while done < nbits:
            n = min(chunk, nbits - done)
            st = stream_update_fused(st, soft[2 * done: 2 * (done + n)][None],
                                     K15)
            lo = max(delay - done, 0)
            if n - lo > 0:
                outs.append(vip.stream_decodebits(st, delay, n - lo, K15))
            done += n
        return st, outs

    def fresh():
        return vip.stream_create(2 * chunk, 1, K15, 0, device="cpu")

    _, outs_ref = run(fresh(), 0)
    want = torch.cat(outs_ref, dim=1)
    st_half = stream_update_fused(fresh(), soft[: 2 * chunk][None], K15)
    path = tmp_path / "fused_stream.npz"
    save_pytree(path, st_half)
    restored = restore_pytree(path, fresh())
    assert (restored.dp, restored.total) == (st_half.dp, st_half.total)
    _, outs_resumed = run(restored, chunk)
    got = torch.cat([vip.stream_decodebits(st_half, delay, chunk - delay, K15)]
                    + outs_resumed, dim=1)
    assert torch.equal(got, want)


def test_checkpoint_manifest_validation(tmp_path):
    """The versioned manifest (format 2) refuses structure, shape and
    dtype drift instead of unflattening the wrong state."""
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": np.ones(4, np.float32)}}
    p = tmp_path / "state.npz"
    save_pytree(p, tree)

    man = load_manifest(p)
    assert man["format_version"] == 2
    assert man["nleaves"] == 2
    assert man["leaves"][0] == {"path": "['a']", "dtype": "int32",
                                "shape": [2, 3]}
    assert man["leaves"][1]["path"] == "['b']['c']"

    out = restore_pytree(p, {"a": torch.zeros((2, 3), dtype=torch.int32),
                             "b": {"c": np.zeros(4, np.float32)}})
    assert torch.equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"]["c"], tree["b"]["c"])

    with pytest.raises(ValueError, match="shape"):
        restore_pytree(p, {"a": torch.zeros((3, 2), dtype=torch.int32),
                           "b": {"c": np.zeros(4, np.float32)}})
    with pytest.raises(ValueError, match="dtype"):
        restore_pytree(p, {"a": torch.zeros((2, 3), dtype=torch.int64),
                           "b": {"c": np.zeros(4, np.float32)}})
    with pytest.raises(ValueError, match="path"):
        restore_pytree(p, {"a": torch.zeros((2, 3), dtype=torch.int32),
                           "z": {"c": np.zeros(4, np.float32)}})
    with pytest.raises(ValueError, match="leaves"):
        restore_pytree(p, {"a": torch.zeros((2, 3), dtype=torch.int32)})


def test_key_paths_are_the_jax_packages():
    """The manifest's key paths and leaf order are jax.tree_util's for
    the same structure (NamedTuples, dicts in key order, lists, tuples,
    None, scalars); DecodeStreamState goes by its four fields."""
    import jax

    dec = DecodeStreamState(2)
    tree = {"z": [1, (np.zeros(2), None)], "a": init_carry(3, PMConfig(),
                                                          device="cpu"),
            "m": 2.5}
    jtree = {"z": [1, (np.zeros(2), None)],
             "a": jcarrier.init_carry(3, jcarrier.PMConfig()), "m": 2.5}
    want = [jax.tree_util.keystr(kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert [p for p, _ in checkpoint._flatten(tree)] == want
    assert [p for p, _ in checkpoint._flatten({"d": dec})] == [
        "['d'].batch", "['d'].lock", "['d'].pos", "['d'].sync_start"]


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A PM carry, a classic Viterbi state's metrics, renorm and dp, and a
    list of arrays saved by the JAX package restore bit for bit onto the
    port's template of the same structure."""
    cfg = jcarrier.PMConfig(samprate=32768.0, binsize=8.0, search_width=100.0)
    n = cfg.fftsize
    t = np.arange(n)
    iq = 9000 * np.exp(1j * 2 * np.pi * 1500.0 * t / cfg.samprate)
    c, _ = jcarrier.pm_demod_block(jcarrier.init_carry(2, cfg),
                                   jnp.asarray(np.stack([iq, iq])), cfg)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 40, dtype=np.uint8)
    st = jviterbi.update_blk(jviterbi.create(40, 1, JK7, 0),
                             jnp.asarray(_soft(bits, K7).numpy()[:40]), JK7)
    tree = {"pm": c, "metrics": st.metrics, "renorm": st.renorm,
            "dp": int(st.dp), "bits": [bits, np.int64(7)]}
    path = tmp_path / "from_jax.npz"
    jckpt.save_pytree(path, tree)

    template = {
        "pm": init_carry(2, convert.pm_config(cfg), device="cpu"),
        "metrics": torch.zeros(tuple(st.metrics.shape),
                               dtype=convert.torch_dtype(st.metrics.dtype)),
        "renorm": torch.zeros(1, dtype=torch.int32),
        "dp": 0,
        "bits": [np.zeros(40, np.uint8), np.int64(0)],
    }
    got = restore_pytree(path, template)
    np.testing.assert_array_equal(got["pm"].search_center.numpy(),
                                  np.asarray(c.search_center))
    np.testing.assert_array_equal(got["pm"].cn0.numpy(), np.asarray(c.cn0))
    np.testing.assert_array_equal(got["metrics"].numpy(),
                                  np.asarray(st.metrics))
    assert got["dp"] == int(st.dp) and isinstance(got["dp"], int)
    np.testing.assert_array_equal(got["bits"][0], bits)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A port checkpoint (tensors on the CPU, a PM carry, scalars, a
    nested list) restores through the JAX package's restore_pytree onto
    its own template."""
    cfg = PMConfig(samprate=32768.0, binsize=8.0, search_width=100.0)
    c = init_carry(2, cfg, 1234.5, device="cpu")
    tree = {"pm": c, "count": 17, "soft": [torch.arange(5, dtype=torch.uint8)],
            "lock": np.array([True, False])}
    path = tmp_path / "from_port.npz"
    save_pytree(path, tree)
    jtemplate = {"pm": jcarrier.init_carry(2, jcarrier.PMConfig()),
                 "count": 0, "soft": [np.zeros(5, np.uint8)],
                 "lock": np.zeros(2, bool)}
    got = jckpt.restore_pytree(path, jtemplate)
    np.testing.assert_array_equal(np.asarray(got["pm"].search_center),
                                  np.full(2, 1234.5, np.float32))
    np.testing.assert_array_equal(np.asarray(got["pm"].cn0), c.cn0.numpy())
    assert int(got["count"]) == 17
    np.testing.assert_array_equal(got["soft"][0], np.arange(5))
    np.testing.assert_array_equal(got["lock"], [True, False])
