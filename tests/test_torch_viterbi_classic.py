"""PyTorch port vs the JAX package: the classic Viterbi API
(ops/viterbi.py) and the plain version of kernel K10
(``acs_step_plain``) against the JAX ``viterbi`` module and its Pallas
step (``acs_step_pallas`` / ``update_blk_pallas``, interpret mode).
Integer outputs: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu import config as jcfg
from isee3_decoder_tpu.ops import encode_bits, viterbi as jv
from isee3_decoder_tpu.ops.viterbi_pallas import acs_step_pallas, update_blk_pallas
from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import FRAMEBITS
from isee3_decoder_tpu_torch.models import decode as td
from isee3_decoder_tpu_torch.ops import viterbi as tv
from isee3_decoder_tpu_torch.ops import viterbi_acs_cuda as tacs
from isee3_decoder_tpu_torch.utils import convert

K7 = jcfg.CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)
K9F = jcfg.CodeSpec("TESTK9F", 0o713, 0o715, 9, 0, 1)
K15 = jcfg.CodeSpec("TESTK15", 0o46321, 0o51445, 15, 0, 1)
CODES = {"K7": K7, "K9F": K9F, "K15": K15, "MCQLI24": jcfg.MCQLI24}
DTYPES = {"int16": (jnp.int16, torch.int16), "int32": (jnp.int32, torch.int32)}


def noisy(rng, code, nbits, B=None):
    """Bits (tail zeroed) and their noisy soft symbols, as
    tests/test_viterbi_pallas.py makes them."""
    shape = (nbits,) if B is None else (B, nbits)
    bits = rng.integers(0, 2, shape, dtype=np.uint8)
    bits[..., -(code.k - 1):] = 0
    syms, _ = encode_bits(jnp.asarray(bits), 0, code)
    soft = np.clip(np.where(np.asarray(syms) > 0, 170, 86).astype(np.int32)
                   + rng.integers(-80, 80, np.shape(syms)), 0, 255)
    return bits, soft.astype(np.uint8)


def _u32(x) -> np.ndarray:
    return np.asarray(x, np.uint32).view(np.int32)


def _same_state(ts, js):
    np.testing.assert_array_equal(ts.metrics.numpy(), np.asarray(js.metrics))
    np.testing.assert_array_equal(ts.decisions.numpy(), _u32(js.decisions))
    np.testing.assert_array_equal(ts.renorm.numpy(), np.asarray(js.renorm))
    assert ts.dp == int(js.dp)


@pytest.mark.parametrize("name", list(CODES))
def test_branch_bits_match_jax(name):
    code = CODES[name]
    for got, want in zip(tv.branch_bits(convert.code_spec(code)),
                         jv.branch_bits(code)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("tile_rows", [16, 32])
def test_acs_step_plain_matches_pallas(tile_rows):
    """K10's plain version == the TPU kernel (interpreted): new metrics,
    packed decisions and the global minimum, with a non-zero adjust."""
    rng = np.random.default_rng(tile_rows)
    B = 3
    m = rng.integers(-3000, 3000, (B, K15.nstates)).astype(np.int16)
    syms = rng.integers(0, 256, (B, 2)).astype(np.int32)
    adjust = rng.integers(0, 400, B).astype(np.int32)
    jm, jd, jg = acs_step_pallas(jnp.asarray(m), jnp.asarray(syms),
                                 jnp.asarray(adjust), K15, tile_rows=tile_rows,
                                 interpret=True)
    tm, td_, tg = tacs.acs_step_plain(torch.from_numpy(m), torch.from_numpy(syms),
                                      torch.from_numpy(adjust),
                                      convert.code_spec(K15))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(td_.numpy(), _u32(jd))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    # on a CPU tensor the wrapper runs the plain version, into given buffers
    out = torch.empty_like(tm)
    dec = torch.empty_like(td_)
    got = tacs.acs_step(torch.from_numpy(m), torch.from_numpy(syms),
                        torch.from_numpy(adjust), convert.code_spec(K15),
                        out=out, dec=dec)
    assert got[0] is out and got[1] is dec
    assert torch.equal(out, tm) and torch.equal(dec, td_)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_update_blk_matches_jax(dtype):
    """update_blk on the CPU (the plain K10 with the adjust fold) == the
    JAX update_blk (per-step renorm) and, in int16, update_blk_pallas:
    metrics, tape (wrapped: tape_len < nbits), dp and renorm — in two
    calls, the second carrying the state."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    B, nbits, tape = 3, 24, 20
    _, soft = noisy(rng, K15, 2 * nbits, B)
    tcode = convert.code_spec(K15)
    js = jv.create(tape, B, K15, 7, jdt)
    ts = tv.create(tape, B, tcode, 7, tdt, device="cpu")
    _kernels.reset_launches()
    for part in (soft[:, : 2 * nbits], soft[:, 2 * nbits :]):
        js = jv.update_blk(js, jnp.asarray(part), K15)
        ts = tv.update_blk(ts, part, tcode)
        _same_state(ts, js)
    assert _kernels.backend_used == {"viterbi": "torch", "viterbi_path": "classic"}
    assert _kernels.LAUNCHES["viterbi_acs"] == 0
    if dtype == "int16":
        jp = update_blk_pallas(jv.create(tape, B, K15, 7, jdt), jnp.asarray(soft),
                               K15, tile_rows=16, interpret=True)
        _same_state(ts, jp)


@pytest.fixture(scope="module")
def carried():
    """One JAX state after 60 noisy K15 steps on a 50-slot tape (so it has
    wrapped), and the same state carried into the port."""
    rng = np.random.default_rng(11)
    _, soft = noisy(rng, K15, 60, 2)
    js = jv.update_blk(jv.create(50, 2, K15, 0), jnp.asarray(soft), K15)
    return js, convert.viterbi_state(js, "cpu")


@pytest.mark.parametrize("fn,args", [
    ("chainback", (50, 0x1234)),
    ("decodebit", (40, 0)),
    ("decodebit", (33, 5)),
    ("decodeword", (45, 0)),
    ("decodeword", (70, 3)),
    ("decodeword", (20, 1)),
    ("streaming_decodebits_window", (20, 30)),
    ("streaming_decodebits_window", (30, 7)),
])
def test_chainbacks_match_jax(carried, fn, args):
    js, ts = carried
    want = np.asarray(getattr(jv, fn)(js, *args, K15))
    got = getattr(tv, fn)(ts, *args, convert.code_spec(K15))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_streaming_decodebits_full_tape_matches_jax():
    rng = np.random.default_rng(12)
    nbits = 48
    _, soft = noisy(rng, K9F, nbits, 2)
    js = jv.update_blk(jv.create(nbits, 2, K9F, 0), jnp.asarray(soft), K9F)
    ts = convert.viterbi_state(js, "cpu")
    for delay in (12, 30):
        np.testing.assert_array_equal(
            tv.streaming_decodebits(ts, delay, convert.code_spec(K9F)).numpy(),
            np.asarray(jv.streaming_decodebits(js, delay, K9F)))


def test_state_metrics_match_jax(carried):
    js, ts = carried
    np.testing.assert_array_equal(tv.best_state(ts).numpy(),
                                  np.asarray(jv.best_state(js)))
    np.testing.assert_array_equal(tv.min_metric(ts).numpy(),
                                  np.asarray(jv.min_metric(js)))
    np.testing.assert_array_equal(tv.max_metric(ts).numpy(),
                                  np.asarray(jv.max_metric(js)))
    # init re-biases a state for a new frame as JAX's does
    ji = jv.init(js, jnp.asarray([3, 9]), K15)
    ti = tv.init(ts, torch.tensor([3, 9]), convert.code_spec(K15))
    np.testing.assert_array_equal(ti.metrics.numpy(), np.asarray(ji.metrics))
    assert ti.dp == int(ji.dp) == 0


@pytest.mark.parametrize("name,nbits", [("K7", 80), ("K9F", 100), ("K15", 96)])
def test_decode_frame_matches_jax(name, nbits):
    """Batched frames with non-zero start and end states."""
    code = CODES[name]
    rng = np.random.default_rng(code.k)
    B = 3
    _, soft = noisy(rng, code, nbits, B)
    start = rng.integers(0, code.nstates, B)
    end = rng.integers(0, code.nstates, B)
    want = np.asarray(jv.decode_frame(jnp.asarray(soft), nbits,
                                      jnp.asarray(start), jnp.asarray(end), code))
    got = tv.decode_frame(soft, nbits, torch.from_numpy(start),
                          torch.from_numpy(end), convert.code_spec(code),
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_frame_int16_matches_jax():
    rng = np.random.default_rng(3)
    _, soft = noisy(rng, K15, 120, 2)
    want = np.asarray(jv.decode_frame(jnp.asarray(soft), 120, 0, 0, K15,
                                      jnp.int16))
    got = tv.decode_frame(torch.from_numpy(soft), 120, 0, 0,
                          convert.code_spec(K15), torch.int16, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_viterbi_decode_backends_agree():
    """The decode stage's classic ("jnp") and fused decoders give the same
    bits on noisy 1024-bit K15 frames; "inplace" is the fused one."""
    rng = np.random.default_rng(21)
    _, soft = noisy(rng, K15, FRAMEBITS, 2)
    fsyms = torch.from_numpy(soft)
    out = {}
    for backend in ("jnp", "fused", "inplace"):
        cfg = td.DecodeConfig(code=convert.code_spec(K15),
                              viterbi_backend=backend)
        _kernels.reset_launches()
        out[backend] = td._viterbi_decode(fsyms, cfg)
        assert _kernels.backend_used["viterbi_path"] == (
            "classic" if backend == "jnp" else "fused")
    assert torch.equal(out["jnp"], out["fused"])
    assert torch.equal(out["jnp"], out["inplace"])
    with pytest.raises(ValueError, match="unknown Viterbi backend 'xla'"):
        td._viterbi_decode(fsyms, td.DecodeConfig(viterbi_backend="xla"))


def test_backend_names_resolve_in_one_place():
    """The JAX package's three names map onto the port's two decoders."""
    assert {b: tv.resolve_backend(b) for b in ("jnp", "fused", "inplace")} == {
        "jnp": "jnp", "fused": "fused", "inplace": "fused"}
    with pytest.raises(ValueError, match="unknown Viterbi backend"):
        tv.resolve_backend("xla")


def test_update_blk_leaves_the_input_state():
    """A state decoded twice gives the same result: update_blk writes only
    the tape in place, never the input metrics or renorm."""
    rng = np.random.default_rng(8)
    code = convert.code_spec(K9F)
    soft = torch.from_numpy(rng.integers(0, 256, (2, 40)).astype(np.uint8))
    st = tv.create(30, 2, code, 3, device="cpu")
    m0, r0 = st.metrics.clone(), st.renorm.clone()
    a = tv.update_blk(st, soft, code)
    a_metrics = a.metrics.clone()
    b = tv.update_blk(st, soft, code)
    assert torch.equal(st.metrics, m0) and torch.equal(st.renorm, r0)
    assert torch.equal(a_metrics, b.metrics)
    assert torch.equal(a.renorm, b.renorm)


def test_decode_config_carries_the_backend():
    from isee3_decoder_tpu.models import decode as jd

    assert convert.decode_config(jd.DecodeConfig()).viterbi_backend == "jnp"
    assert convert.decode_config(
        jd.DecodeConfig(viterbi_backend="fused")).viterbi_backend == "fused"
    assert td.DecodeConfig().viterbi_backend == "fused"


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.create(4, 1, convert.code_spec(K7))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.decode_frame(np.zeros(16, np.uint8), 8, code=convert.code_spec(K7))


def test_kernel_library_name_covers_the_k10_source(tmp_path, monkeypatch):
    """The built library's name hashes csrc/viterbi_acs.cu too, so an
    edited K10 source never loads a stale library."""
    import shutil

    assert "viterbi_acs.cu" in [p.name for p in _kernels._sources()]
    assert "viterbi_acs_launch" in _kernels._SIGNATURES
    assert "viterbi_acs" in _kernels.LAUNCHES
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    before = _kernels._source_hash()
    with open(csrc / "viterbi_acs.cu", "a") as f:
        f.write("\n")
    assert _kernels._source_hash() != before
