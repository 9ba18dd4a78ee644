"""PyTorch port vs the JAX package: the fused Viterbi slice — geometry and
column planes, the plain versions of kernels K5/K6 (``cycle_a_plain`` /
``cycle_b_plain``) against the JAX Pallas kernels in interpret mode,
whole-frame decodes, the streaming path, the decision-memory guard and
the traceback wrapper's checks.
Integer paths: everything is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu import config as jcfg
from isee3_decoder_tpu.ops import encode_bits, viterbi
from isee3_decoder_tpu.ops import viterbi_inplace as jvip
from isee3_decoder_tpu.ops import viterbi_pallas_fused as jvf
from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.ops import viterbi_cuda as tvc
from isee3_decoder_tpu_torch.ops import viterbi_fused as tvf
from isee3_decoder_tpu_torch.ops import viterbi_inplace as tvip
from isee3_decoder_tpu_torch.utils import convert

K15 = jcfg.CodeSpec("TESTK15", 0o46321, 0o51445, 15, 0, 1)  # ROWB 1, COLB 13
K18 = jcfg.CodeSpec("TESTK18", 0o654321, 0o735271, 18, 0, 1)  # ROWB 2, COLB 15
CODES = {"K15": K15, "K18": K18, "MCQLI24": jcfg.MCQLI24}


def noisy(rng, code, nbits):
    """Bits (tail zeroed) and their noisy hard-ish soft symbols, as
    tests/test_viterbi_fused.py makes them."""
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    bits[-(code.k - 1):] = 0
    syms, _ = encode_bits(jnp.asarray(bits), 0, code)
    return bits, np.clip(
        np.where(np.asarray(syms) > 0, 170, 86).astype(np.int32)
        + rng.integers(-80, 80, 2 * nbits), 0, 255).astype(np.uint8)


def _u32(x) -> np.ndarray:
    return np.asarray(x, np.uint32).view(np.int32)


@pytest.mark.parametrize("name", list(CODES))
def test_geometry_masks_and_planes_match_jax(name):
    code = CODES[name]
    tcode = convert.code_spec(code)
    assert tvc._geometry(tcode) == jvf._geometry(code)
    w, rowb, _ = jvf._geometry(code)
    for t in range(w):
        assert tvc._step_masks(tcode, t) == jvf._step_masks(code, t)
    assert tvip._branch_masks(tcode) == jvip._branch_masks(code)
    s = np.arange(0, 1 << w, 977, dtype=np.int64)
    for t in (0, 1, w - 1, w, 3 * w + 5):
        assert tvip.perm_t(t, tcode) == jvip.perm_t(t, code)
        assert tvip._rotl(0b1011, t, w) == jvip._rotl(0b1011, t, w)
        np.testing.assert_array_equal(
            tvip.state_position(torch.from_numpy(s), t, tcode).numpy(),
            np.asarray(jvip.state_position(s, t, code)))
    for nsteps in (1, w - rowb):
        np.testing.assert_array_equal(tvc._colpar_planes(tcode, nsteps),
                                      jvf._colpar_planes(code, nsteps))


def _metrics(rng, B, code):
    return rng.integers(0, 3000, (B, code.nstates)).astype(np.int16)


@pytest.mark.parametrize("name,nsteps", [("K15", 1), ("K18", 1), ("K18", 2)])
def test_cycle_a_plain_matches_jax(name, nsteps):
    """K5's plain version: row-pairing steps with a non-zero deferred
    renorm base, metrics and decision words exact."""
    code = CODES[name]
    rng = np.random.default_rng(nsteps + code.k)
    B = 2
    m = _metrics(rng, B, code)
    syms = rng.integers(0, 256, (B, 2 * nsteps)).astype(np.int32)
    base = rng.integers(0, 400, B).astype(np.int32)
    jm, jd = jvf.cycle_a(jnp.asarray(m), jnp.asarray(syms), code, nsteps,
                         interpret=True, base=jnp.asarray(base))
    tm = torch.from_numpy(m.copy())
    out, td = tvc.cycle_a(tm, torch.from_numpy(syms), convert.code_spec(code),
                          nsteps, torch.from_numpy(base))
    assert out is tm  # updated in place
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(td.numpy(), _u32(jd))


@pytest.mark.parametrize("name,nsteps", [("K15", 13), ("K15", 5), ("K18", 15),
                                         ("K18", 7)])
def test_cycle_b_plain_matches_jax(name, nsteps):
    """K6's plain version: column-pairing steps, full and partial; the
    minimum of its per-row minima is the JAX kernel's global minimum."""
    code = CODES[name]
    rng = np.random.default_rng(nsteps * code.k)
    B = 2
    m = _metrics(rng, B, code)
    syms = rng.integers(0, 256, (B, 2 * nsteps)).astype(np.int32)
    jm, jd, jmin = jvf.cycle_b(jnp.asarray(m), jnp.asarray(syms), code, nsteps,
                               interpret=True)
    tm = torch.from_numpy(m.copy())
    _, td, tmins = tvc.cycle_b(tm, torch.from_numpy(syms),
                               convert.code_spec(code), nsteps)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(td.numpy(), _u32(jd))
    assert tmins.shape == (B, 1 << jvf._geometry(code)[1])
    np.testing.assert_array_equal(tmins.amin(dim=1).numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmins.numpy(),
                                  tm.numpy().reshape(B, tmins.shape[1], -1)
                                  .min(axis=2))


def _decode_pair(code, rx, nbits, start=0, end=0):
    want = np.asarray(viterbi.decode_frame(jnp.asarray(rx), nbits, start, end,
                                           code))
    got = tvf.decode_frame_fused(torch.from_numpy(rx), nbits, start, end,
                                 convert.code_spec(code))
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


@pytest.mark.parametrize(
    "name,nbits",
    [("K15", 9), ("K15", 42), ("K18", 40),
     pytest.param("MCQLI24", 48, marks=pytest.mark.slow)],
)
def test_decode_frame_fused_matches_jax(name, nbits):
    """Sub-cycle, remainder and (K18) two-step row phase lengths."""
    code = CODES[name]
    bits, rx = noisy(np.random.default_rng(nbits), code, nbits)
    got = _decode_pair(code, rx, nbits)
    if name == "MCQLI24":
        np.testing.assert_array_equal(got[0], bits)


def test_decode_frame_fused_batched_nonzero_start():
    rng = np.random.default_rng(1)
    rx = np.stack([noisy(rng, K15, 30)[1] for _ in range(2)])
    _decode_pair(K15, rx, 30, 0x0AAA & K15.state_mask, 0)


def test_update_frame_fused_layouts_agree():
    """The planes layout (B, nbits, n/32) and the flat (nbits, B, n/32)
    layout hold the same planes, the JAX package's decisions and renorm
    totals."""
    rng = np.random.default_rng(5)
    nbits = 31  # two whole cycles (W = 14) and a remainder of 3
    rx = np.stack([noisy(rng, K15, nbits)[1] for _ in range(2)])
    m0 = np.full((2, K15.nstates), viterbi.START_BIAS, np.int16)
    m0[:, 0] = 0
    jm, jdec, jtot = jvf.update_frame_fused(jnp.asarray(m0), jnp.asarray(rx),
                                            nbits, K15, interpret=True)
    code = convert.code_spec(K15)
    tm, tdec, ttot = tvf.update_frame_fused_planes(
        torch.from_numpy(m0.copy()), torch.from_numpy(rx), nbits, code)
    fm, fdec, ftot = tvf.update_frame_fused(torch.from_numpy(m0.copy()),
                                            torch.from_numpy(rx), nbits, code)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(fm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ttot.numpy(), np.asarray(jtot))
    np.testing.assert_array_equal(ftot.numpy(), np.asarray(jtot))
    np.testing.assert_array_equal(fdec.numpy(), _u32(jdec))
    np.testing.assert_array_equal(tdec.transpose(0, 1).numpy(), _u32(jdec))


def test_streaming_fused_matches_classic():
    """The port's fused streaming (cycle-aligned chunks into the circular
    tape, erasure-padded final chunk + skip) reproduces the JAX classic
    kernel's fixed-delay outputs — from its own start, and when it takes
    over a JAX fused stream part-way through convert.stream_state."""
    rng = np.random.default_rng(22)
    w = K15.k - 1
    nbits, delay = 300, 60
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    syms, _ = encode_bits(jnp.asarray(bits), 0, K15)
    soft = np.where(np.asarray(syms) > 0, 200, 56).astype(np.uint8)
    st2 = viterbi.create(nbits, 1, K15, 0)
    st2 = viterbi.update_blk(st2, jnp.asarray(soft), K15)
    want = np.asarray(viterbi.streaming_decodebits(st2, delay, K15))

    code = convert.code_spec(K15)
    chunk = 10 * w
    tape_len = 2 * chunk

    def run(st, done, outs):
        while done < nbits:
            n = min(chunk, nbits - done)
            npad = -(-n // w) * w
            block = np.full((1, 2 * npad), 128, np.uint8)
            block[0, : 2 * n] = soft[2 * done : 2 * (done + n)]
            st = tvf.stream_update_fused(st, torch.from_numpy(block), code)
            lo = max(delay - done, 0)
            if n - lo > 0:
                outs.append(tvip.stream_decodebits(st, delay, n - lo, code,
                                                   skip=npad - n).numpy())
            done += n
        return np.concatenate(outs, axis=1)

    got = run(tvip.stream_create(tape_len, 1, code, 0, device="cpu"), 0, [])
    np.testing.assert_array_equal(got, want)

    # JAX fused stream for the first chunk, then the port takes over
    jst = jvip.stream_create(tape_len, 1, K15, 0)
    jst = jvf.stream_update_fused(
        jst, jnp.asarray(soft[None, : 2 * chunk]), K15, interpret=True)
    tst = convert.stream_state(jst)
    assert (tst.dp, tst.total) == (chunk, chunk)
    first = np.asarray(jvip.stream_decodebits(jst, delay, chunk - delay, K15))
    np.testing.assert_array_equal(
        tvip.stream_decodebits(tst, delay, chunk - delay, code).numpy(), first)
    np.testing.assert_array_equal(run(tst, chunk, [first]), want)


def test_stream_update_refuses_unaligned_chunks():
    code = convert.code_spec(K15)
    st = tvip.stream_create(28, 1, code, device="cpu")
    with pytest.raises(ValueError, match="multiple of W"):
        tvf.stream_update_fused(st, torch.full((1, 2 * 13), 128, dtype=torch.uint8),
                                code)
    st = tvf.stream_update_fused(st, torch.full((1, 2 * 14), 128,
                                                dtype=torch.uint8), code)
    st.dp = 20
    with pytest.raises(ValueError, match="wrap"):
        tvf.stream_update_fused(st, torch.full((1, 2 * 14), 128,
                                               dtype=torch.uint8), code)


def test_decision_budget_guard(monkeypatch):
    """Oversized batches raise before anything is allocated; small codes
    pass; ISEE3_FUSED_DEC_BYTES overrides the budget."""
    monkeypatch.delenv("ISEE3_FUSED_DEC_BYTES", raising=False)
    mc = convert.code_spec(jcfg.MCQLI24)
    syms = torch.full((16, 2048), 128, dtype=torch.uint8)
    with pytest.raises(ValueError, match="chunk the batch"):
        tvf.decode_frame_fused(syms, 1024, 0, 0, mc)  # 16 GiB of tape
    with pytest.raises(ValueError, match="chunk the batch"):
        tvf._check_decision_budget(8, 1024, mc, "cpu")
    tvf._check_decision_budget(2, 1024, mc, "cpu")
    tvf._check_decision_budget(8, 1024, convert.code_spec(K15), "cpu")
    monkeypatch.setenv("ISEE3_FUSED_DEC_BYTES", str(3 * 2**20))
    with pytest.raises(ValueError, match="chunk the batch"):
        tvf._check_decision_budget(2, 1024, convert.code_spec(K15), "cpu")
    tvf._check_decision_budget(1, 1024, convert.code_spec(K15), "cpu")


def test_kernel_wrappers_check_their_inputs():
    code = convert.code_spec(K15)
    with pytest.raises(ValueError, match="14 <= K <= 24"):
        tvc.cycle_a(torch.zeros((1, 64), dtype=torch.int16),
                    torch.zeros((1, 2), dtype=torch.int32),
                    convert.code_spec(jcfg.CodeSpec("K7", 0o171, 0o133, 7)), 1)
    with pytest.raises(ValueError, match="int32 view"):
        tvc.cycle_b(torch.zeros((1, code.nstates), dtype=torch.int16),
                    torch.zeros((1, 2), dtype=torch.int32), code, 1,
                    torch.zeros((1, 2, code.nstates // 32), dtype=torch.int32))


@pytest.mark.parametrize("fault", ["dtype", "contiguous", "planes", "code"])
def test_traceback_wrapper_checks_its_inputs(fault):
    """viterbi_cuda.traceback refuses, before it picks kernel or plain
    twin, a tape the kernel does not take."""
    code = convert.code_spec(K15)
    nbits, words = 6, code.nstates // 32
    dec = torch.zeros((2, nbits, words), dtype=torch.int32)
    match = {"dtype": "int32 planes", "contiguous": "contiguous",
             "planes": "int32 planes", "code": "14 <= K <= 24"}[fault]
    if fault == "dtype":
        dec = dec.to(torch.int64)
    elif fault == "contiguous":
        dec = torch.zeros((nbits, 2, words), dtype=torch.int32).transpose(0, 1)
    elif fault == "planes":
        nbits += 1
    else:
        code = convert.code_spec(jcfg.CodeSpec("K13", 0o12345, 0o16543, 13))
    with pytest.raises(ValueError, match=match):
        tvc.traceback(dec, nbits, 0, code)


@pytest.mark.parametrize("name,nbits", [("K15", 1), ("K15", 37), ("K18", 100)])
def test_chainback_planes_per_lane_end_states(name, nbits):
    """A (B,) tensor of end states traces each frame back from its own
    state: the same bits as B single-frame calls with int end states (the
    per-lane form the traceback kernel takes as a pointer)."""
    code = convert.code_spec(CODES[name])
    gen = torch.Generator().manual_seed(nbits)
    dec = torch.randint(-2**31, 2**31, (3, nbits, code.nstates // 32),
                        generator=gen, dtype=torch.int64).to(torch.int32)
    ends = torch.randint(0, code.nstates, (3,), generator=gen)
    got = tvf.chainback_planes(dec, nbits, ends, code)
    for b in range(3):
        assert torch.equal(got[b : b + 1], tvf.chainback_planes(
            dec[b : b + 1], nbits, int(ends[b]), code))
    assert _kernels.backend_used["traceback"] == "torch"
