"""Launch plans of the kernels K5 (csrc/viterbi.cu ``viterbi_a_kernel``),
K6 (csrc/viterbi.cu ``viterbi_b_kernel``), K8 (csrc/carrier.cu
``windowed_search_kernel``), K9 (csrc/carrier.cu ``pm_scan_kernel``), K7a
and K7b (csrc/channelizer.cu ``pfb_kernel``) and the spin-down of K1 and
K2 (csrc/carrier.cu ``spin_cluster_kernel``) and K3 (csrc/prefix.cu
``prefix_tile_kernel``), checked on the CPU: the tiles cover every state, sample, column and bin
exactly once, every decision word has one writer, shared memory stays
within one block's limit, and K6's swizzled row puts a warp's accesses
in 32 banks.  The kernels' index arithmetic is mirrored here (the radix
stages of K5 with their split branch parities; K6's register stages,
lane steps by exchange and (mt, mm) table; the 16 x C split of K8 with
its integer phase walks; K9's 256-point column DFTs by two 16-point
stages and its outer sum; K7's rounded bulk copies, register ring and
M1 x M2 DFT split; the spin-down's group phase and summation order; K3's
input groups, decoupled look-back and single and 16-byte stores) and
held against the plain versions (the spin-down also against the JAX
package's kernel in interpret mode), since the kernels themselves run
only on the card.
"""

import itertools

import numpy as np
import pytest
import torch

from isee3_decoder_tpu_torch.config import CODES, DEFAULT_CODE, SYNC_STATE, CodeSpec
from isee3_decoder_tpu_torch.models.decode import DecodeConfig
from isee3_decoder_tpu_torch.ops import carrier, carrier_cuda, channelizer_cuda
from isee3_decoder_tpu_torch.ops import fano_cuda, prefix_cuda
from isee3_decoder_tpu_torch.ops import viterbi_cuda
from isee3_decoder_tpu_torch.ops.encode import encode_bits
from isee3_decoder_tpu_torch.ops.fano import _walk_inputs
from isee3_decoder_tpu_torch.ops.viterbi_inplace import _branch_masks, _rotr

SMEM_MAX = 232_448


def _code(k: int) -> CodeSpec:
    # two k-bit polynomials with the top and bottom taps set
    rng = np.random.default_rng(k)
    p1, p2 = (int(v) | 1 | (1 << (k - 1)) for v in rng.integers(0, 1 << k, 2))
    return CodeSpec(f"TESTK{k}", p1, p2, k, k % 2, 0)


# ---------------------------------------------------------------- K5 plan

@pytest.mark.parametrize("k", range(14, 25))
def test_k5_tiles_cover_every_state_and_word_once(k):
    code = _code(k)
    w, rowb, colb = viterbi_cuda._geometry(code)
    plan = viterbi_cuda.cycle_a_plan(code)
    assert plan["smem"] <= SMEM_MAX
    assert plan["threads"] % 32 == 0 and 128 <= plan["threads"] <= 1024
    states = np.zeros(1 << w, dtype=np.int64)
    words = np.zeros((1 << w) // 32, dtype=np.int64)
    for x in range(plan["tiles"]):
        pos, wd = viterbi_cuda.cycle_a_tile(code, x)
        states[pos] += 1
        words[wd] += 1
        # the words a tile writes are exactly those its positions' bits
        # fall in (the decision-word contract of ops/viterbi_inplace.py)
        contract = np.unique((pos >> 12) * 128 + (pos & 127))
        assert np.array_equal(contract, np.unique(wd))
        # 16-byte vectors: 8 contiguous columns per (row, j), 32-byte runs
        # of words per row
        assert (pos.reshape(-1, 8) - pos.reshape(-1, 8)[:, :1] == np.arange(8)).all()
        assert (wd.reshape(-1, 8) % 8 == np.arange(8)).all()
    assert (states == 1).all()
    assert (words == 1).all()
    # a cluster's tiles hold whole 64-byte runs: 32 consecutive int16
    # columns of each (row, j)
    assert plan["tiles"] % plan["cluster"] == 0
    for x0 in range(0, plan["tiles"], plan["cluster"]):
        pos = np.concatenate([viterbi_cuda.cycle_a_tile(code, x)[0]
                              for x in range(x0, x0 + plan["cluster"])])
        runs = np.unique(pos >> 5)
        assert len(pos) == 32 * len(runs)


def _parity(x):
    x = np.asarray(x, dtype=np.int64)
    for sh in (16, 8, 4, 2, 1):
        x = x ^ (x >> sh)
    return x & 1


def _k5_stages(m16, syms, code, nsteps, base):
    """numpy mirror of viterbi_a_kernel: radix stages of up to three steps
    on row sets rbase | (x << lowbit), the branch metric read from a
    4-entry table per step at the XOR of two 2-bit codes (row base and
    column; the stage's row bits), int16 storage between stages →
    (metrics int16, decision bits (B, nsteps, n))."""
    w, rowb, colb = viterbi_cuda._geometry(code)
    B = m16.shape[0]
    nrows, ncols = 1 << rowb, 1 << colb
    q1, q2 = _branch_masks(code)
    colmask = ncols - 1
    cols = np.arange(ncols, dtype=np.int64)
    v = m16.reshape(B, nrows, ncols).astype(np.int64)
    d = np.zeros((B, nsteps, nrows, ncols), dtype=bool)
    s = syms.astype(np.int64)
    for t0 in range(0, nsteps, 3):
        S = min(3, nsteps - t0)
        lowbit = rowb - t0 - S
        if t0 == 0:
            v = v - base[:, None, None]
        for rho in range(nrows >> S):
            rbase = ((rho >> lowbit) << (lowbit + S)) | (rho & ((1 << lowbit) - 1))
            for u in range(S):
                t = t0 + u
                hb = S - 1 - u
                m1, m2 = _rotr(q1, t, w), _rotr(q2, t, w)
                # 2-bit codes b0 + 2 b1: row base and column, per column
                cc = (_parity(rbase & (m1 >> colb)) ^ code.g1flip
                      ^ _parity(cols & (m1 & colmask))) \
                    | (_parity(rbase & (m2 >> colb)) ^ code.g2flip
                       ^ _parity(cols & (m2 & colmask))) << 1
                s0, s1 = s[:, 2 * t], s[:, 2 * t + 1]
                table = np.stack([s0 + s1, 255 - s0 + s1, s0 + 255 - s1,
                                  510 - s0 - s1], axis=1)  # (B, 4)
                for pi in range(1 << (S - 1)):
                    xlo = ((pi >> hb) << (hb + 1)) | (pi & ((1 << hb) - 1))
                    xhi = xlo | (1 << hb)
                    xcode = _parity((xlo << lowbit) & (m1 >> colb)) \
                        | _parity((xlo << lowbit) & (m2 >> colb)) << 1
                    mt = np.take_along_axis(table, np.broadcast_to(
                        cc ^ xcode, (B, ncols)), axis=1)
                    mm = 510 - mt
                    rlo, rhi = rbase | (xlo << lowbit), rbase | (xhi << lowbit)
                    lo, hi = v[:, rlo], v[:, rhi]
                    a0, a1, a2, a3 = lo + mt, hi + mm, lo + mm, hi + mt
                    d[:, t, rlo], d[:, t, rhi] = a0 > a1, a2 > a3
                    v[:, rlo] = np.where(a0 > a1, a1, a0)
                    v[:, rhi] = np.where(a2 > a3, a3, a2)
        v = v.astype(np.int16).astype(np.int64)  # int16 between stages
    return v.reshape(B, -1).astype(np.int16), d.reshape(B, nsteps, -1)


@pytest.mark.parametrize("k,nsteps", [(14, None), (18, None), (18, 1),
                                      (20, None), (20, 2), (21, 4)])
def test_k5_stage_arithmetic_matches_plain(k, nsteps):
    """The kernel's decomposition (stages, row sets, split parities, ties
    keeping a0 / a2) against cycle_a_plain, bit for bit, with many equal
    metrics and symbols 127/128 so that ties occur."""
    code = _code(k)
    w, rowb, _ = viterbi_cuda._geometry(code)
    nsteps = rowb if nsteps is None else nsteps
    rng = np.random.default_rng(k * 10 + nsteps)
    B = 2
    m0 = np.concatenate([rng.integers(0, 12000, (1, code.nstates)),
                         rng.integers(0, 3, (1, code.nstates)) * 255]
                        ).astype(np.int16)
    syms = np.concatenate([rng.integers(0, 256, (1, 2 * nsteps)),
                           rng.integers(127, 129, (1, 2 * nsteps))]
                          ).astype(np.int32)
    base = np.array([517, 0], dtype=np.int64)
    got_m, got_d = _k5_stages(m0, syms, code, nsteps, base)
    mp = torch.as_tensor(m0.copy())
    _, dp = viterbi_cuda.cycle_a_plain(mp, torch.as_tensor(syms), code, nsteps,
                                       torch.as_tensor(base, dtype=torch.int32))
    assert np.array_equal(got_m, mp.numpy())
    want = torch.as_tensor(
        viterbi_cuda._pack_words(torch.as_tensor(got_d.reshape(-1, code.nstates)))
        .reshape(B, nsteps, -1))
    assert torch.equal(want, dp)


# ---------------------------------------------------------------- K6 plan

def _k6_all_columns(stage):
    """(items, 32 lanes, values) columns of every item of a K6 stage."""
    return np.stack([viterbi_cuda.cycle_b_columns(stage, it)
                     for it in range(stage["items"])])


def _word_of(cols):
    """Decision word of a column in its row's slice of a plane (the
    contract of ops/viterbi_inplace.py; the bit is (c >> 7) & 31)."""
    return ((cols >> 12) << 7) | (cols & 127)


@pytest.mark.parametrize("k,nsteps", [(k, n) for k in range(14, 25)
                                      for n in (1, 4, None)])
def test_k6_plan_covers_every_column_and_word_once(k, nsteps):
    code = _code(k)
    _, _, colb = viterbi_cuda._geometry(code)
    plan = viterbi_cuda.cycle_b_plan(code, nsteps)
    nsteps = colb if nsteps is None else nsteps
    assert plan["smem"] <= SMEM_MAX
    # two blocks share an SM (228 KB, 1 KB of each block reserved)
    assert 2 * (plan["smem"] + 1024) <= 233_472
    assert plan["threads"] % 32 == 0
    # the stages run the pair bits s = COLB-1, COLB-2, … in order, a
    # register step on a register bit, a lane step on a j bit
    steps = [s for st in plan["stages"] for s in st["steps"]]
    assert steps == list(range(colb - 1, colb - 1 - nsteps, -1))
    ncols = 1 << colb
    for st in plan["stages"]:
        assert st["steps"] == tuple(steps[st["first"]:st["first"]
                                          + len(st["steps"])])
        assert all(s in st["reg"] or s in viterbi_cuda.B_LANE_BITS
                   for s in st["steps"])
        assert len(st["steps"]) <= plan["dsteps"]
        cols = _k6_all_columns(st)
        # every column of the row once per stage
        assert np.array_equal(np.bincount(cols.ravel(), minlength=ncols),
                              np.ones(ncols, dtype=np.int64))
        # lane j holds the columns of bit j of their decision words, and a
        # (item, value) ballot over the lanes is one whole word: each of
        # a step's words once per stage
        assert ((cols >> 7) & 31 == np.arange(32)[None, :, None]).all()
        words = _word_of(cols)
        assert (words == words[:, :1]).all()
        assert np.array_equal(np.bincount(words[:, 0].ravel(),
                                          minlength=ncols // 32),
                              np.ones(ncols // 32, dtype=np.int64))


@pytest.mark.parametrize("colb", [12, 13, 14, 15])
def test_k6_swizzle_is_a_bijection_without_bank_conflicts(colb):
    code = _code(colb + 2)
    assert viterbi_cuda._geometry(code)[2] == colb
    ncols = 1 << colb
    addr = viterbi_cuda.cycle_b_word(np.arange(0, ncols, 2))
    assert np.array_equal(np.sort(addr), np.arange(ncols // 2))
    # every warp access of every stage: a word (value pair v, v+1) of 32
    # lanes hits 32 banks
    for st in viterbi_cuda.cycle_b_plan(code)["stages"]:
        banks = viterbi_cuda.cycle_b_word(_k6_all_columns(st)[..., 0::2]) % 32
        assert (np.sort(banks, axis=1) == np.arange(32)[None, :, None]).all()
    # the row's 16-byte vectors: vector e (words 4e .. 4e+3) goes whole to
    # chunk e ^ (j >> 2), word k at position k ^ (j & 3), which is where
    # cycle_b_word puts it; 8 vectors of a quarter warp cover 32 banks
    e = np.arange(ncols // 8)
    j = (e >> 4) & 31
    k = np.arange(4)
    chunk = e ^ (j >> 2)
    assert np.array_equal(
        4 * chunk[:, None] + (k[None, :] ^ (j[:, None] & 3)),
        viterbi_cuda.cycle_b_word(2 * (4 * e[:, None] + k[None, :])))
    banks = (4 * chunk[:, None] + k).reshape(-1, 32) % 32
    assert (np.sort(banks, axis=1) == np.arange(32)).all()


def _k6_table(code, nsteps, syms):
    """(B, rows, nsteps, 8, 4, 2, 2) packed tables as viterbi_b_kernel
    builds them per block: entry [jj][k][cb] holds two words (x, y) of two
    int16 halves each.  mt(v) is the branch metric of step jj at the
    column code cb of an item's base, XORed with the row's code and the
    flips and with the code of value v's offset in its stage; x = (mt,
    mt) and y = (mm, mm) of values (2k, 2k+1), or at column bit 0's step
    x = (mt, mm), y = (mm, mt) of value 2k."""
    w, rowb, colb = viterbi_cuda._geometry(code)
    plan = viterbi_cuda.cycle_b_plan(code, nsteps)
    q1, q2 = _branch_masks(code)
    B = syms.shape[0]
    rows = np.arange(1 << rowb, dtype=np.int64)
    tab = np.zeros((B, 1 << rowb, nsteps, 8, 4, 2, 2), dtype=np.int64)
    cb = np.arange(4)
    for st in plan["stages"]:
        v = np.arange(1 << len(st["reg"]), dtype=np.int64)
        x = sum(((v >> k) & 1) << b for k, b in enumerate(st["reg"]))
        for u, s in enumerate(st["steps"]):
            jj = st["first"] + u
            m1, m2 = _rotr(q1, rowb + jj, w), _rotr(q2, rowb + jj, w)
            rc = ((_parity(rows & (m1 >> colb)) ^ code.g1flip)
                  | (_parity(rows & (m2 >> colb)) ^ code.g2flip) << 1)
            xc = _parity(x & m1) | _parity(x & m2) << 1
            code4 = rc[:, None, None] ^ xc[None, :, None] ^ cb[None, None, :]
            s0 = syms[:, 2 * jj, None, None, None].astype(np.int64)
            s1 = syms[:, 2 * jj + 1, None, None, None].astype(np.int64)
            mt = (np.where(code4 & 1, 255 - s0, s0)
                  + np.where(code4 & 2, 255 - s1, s1))  # (B, rows, NV, 4)
            lo, hi = mt[:, :, 0::2], mt[:, :, 1::2]
            nk = lo.shape[2]
            if s == 0:
                words = ((lo, 510 - lo), (510 - lo, lo))
            else:
                words = ((lo, hi), (510 - lo, 510 - hi))
            for xy, (h0, h1) in enumerate(words):
                tab[:, :, jj, :nk, :, xy, 0] = h0
                tab[:, :, jj, :nk, :, xy, 1] = h1
    return tab


def _i16(x):
    """int16 wrap-around of each halfword sum (the packed adds)."""
    return ((x + 32768) & 0xFFFF) - 32768


def _k6_stages(m16, syms, code, nsteps):
    """numpy mirror of viterbi_b_kernel: the row as int16 pairs at
    cycle_b_word between stages; per stage and item, lane j's words
    (values 2k, 2k+1 as two int16 halves) in registers; register steps
    pair words (or the halves of a word at column bit 0), lane steps pair
    lanes j, j ^ 2^(s-7) (the shuffle: each lane decides its own
    position); the packed (mt, mm) read from the block's table at the
    item's column code; halfword sums with int16 wrap-around; each min
    reports a <= b and the decision is its negation (a tie keeps the
    first operand), one lane ballot per half → (metrics int16, decision
    words (B, nsteps, n/32) int32, row minima (B, rows))."""
    w, rowb, colb = viterbi_cuda._geometry(code)
    plan = viterbi_cuda.cycle_b_plan(code, nsteps)
    q1, q2 = _branch_masks(code)
    B = m16.shape[0]
    nrows, ncols = 1 << rowb, 1 << colb
    tab = _k6_table(code, nsteps, syms)
    lane = np.arange(32)
    # the row's words (c, c+1) at cycle_b_word(c)
    m = m16.reshape(B, nrows, ncols).astype(np.int64)
    words = np.zeros((B, nrows, ncols // 2), dtype=np.int64)
    c = np.arange(0, ncols, 2)
    words[:, :, viterbi_cuda.cycle_b_word(c)] = ((m[..., 0::2] & 0xFFFF)
                                                 | (m[..., 1::2] & 0xFFFF) << 16)
    dec = np.full((B, nsteps, nrows, ncols // 32), -1, dtype=np.int64)

    def vmin(a, b):  # per-half min and the decision !(a <= b)
        return np.minimum(a, b), ~(a <= b)

    for st in plan["stages"]:
        cols = _k6_all_columns(st)  # (items, 32, NV)
        wa = viterbi_cuda.cycle_b_word(cols[..., 0::2])  # (items, 32, NP)
        wv = words[:, :, wa]
        # (B, rows, items, 32, NP, 2 halves)
        W = np.stack([_i16(wv & 0xFFFF), _i16(wv >> 16)], axis=-1)
        nw = W.shape[-2]
        c0 = cols[..., 0]
        for u, s in enumerate(st["steps"]):
            jj = st["first"] + u
            t = rowb + jj
            mk1 = _rotr(q1, t, w) & (ncols - 1)
            mk2 = _rotr(q2, t, w) & (ncols - 1)
            lanestep = s in viterbi_cuda.B_LANE_BITS
            c0s = c0 & ~(1 << s) if lanestep else c0
            cb = _parity(c0s & mk1) | _parity(c0s & mk2) << 1  # (items, 32)
            tj = tab[:, :, jj][:, :, np.arange(nw)[None, None, :],
                               cb[:, :, None]]  # (B, rows, items, 32, NP, 2, 2)
            X, Y = tj[..., 0, :], tj[..., 1, :]
            if lanestep:
                high = ((lane >> (s - 7)) & 1)[:, None, None] == 1
                P = W[:, :, :, lane ^ (1 << (s - 7))]
                kk, sw = _i16(W + X), _i16(P + Y)
                W, d = vmin(np.where(high, sw, kk), np.where(high, kk, sw))
            elif s == 0:
                W, d = vmin(_i16(W[..., :1] + X), _i16(W[..., 1:] + Y))
            else:
                hw = st["reg"].index(s) - 1  # the word bit the step pairs
                klo = np.array([k for k in range(nw) if not k >> hw & 1])
                khi = klo | (1 << hw)
                lo, hi = W[..., klo, :], W[..., khi, :]
                Xl, Yl = X[..., klo, :], Y[..., klo, :]
                W = W.copy()
                d = np.zeros(W.shape, dtype=bool)
                W[..., klo, :], d[..., klo, :] = vmin(_i16(lo + Xl), _i16(hi + Yl))
                W[..., khi, :], d[..., khi, :] = vmin(_i16(lo + Yl), _i16(hi + Xl))
            d = d.reshape(*d.shape[:-2], -1)  # values 2k + half
            ballot = (d.astype(np.int64) << lane[:, None]).sum(axis=3)
            widx = _word_of(cols[:, 0, :])  # (items, NV)
            assert (dec[:, jj][:, :, widx] == -1).all()
            dec[:, jj][:, :, widx] = ballot
        mins = W.reshape(B, nrows, -1).min(axis=-1)
        words[:, :, wa] = (W[..., 0] & 0xFFFF) | (W[..., 1] & 0xFFFF) << 16
    out = np.zeros((B, nrows, ncols), dtype=np.int64)
    out[..., 0::2] = words[:, :, viterbi_cuda.cycle_b_word(c)] & 0xFFFF
    out[..., 1::2] = words[:, :, viterbi_cuda.cycle_b_word(c)] >> 16
    dec32 = dec.astype(np.uint32).view(np.int32).reshape(B, nsteps, -1)
    return (out.astype(np.uint16).view(np.int16).reshape(B, -1), dec32,
            mins.astype(np.int32))


# the largest metric K6 is given: a cycle starts within the (K-1)*510
# spread above the subtracted minimum and K5's 8 row steps add at most
# 510 each, at K = 24
K6_TOP = 23 * 510 + 8 * 510


def k6_top_inputs(rng, B, n, nsteps):
    """Metrics within 255 below K6_TOP and symbols 0/255 (branch metrics
    0, 255 or 510), so that the packed int16 sums run at the top of the
    range K6 keeps exact."""
    m0 = (K6_TOP - rng.integers(0, 256, (B, n))).astype(np.int16)
    syms = (rng.integers(0, 2, (B, 2 * nsteps)) * 255).astype(np.int32)
    return m0, syms


@pytest.mark.parametrize("data", ["random", "ties", "top"])
@pytest.mark.parametrize("k,nsteps", [(14, None), (14, 2), (16, None),
                                      (16, 9), (18, None), (18, 4), (20, 5),
                                      (20, None)])
def test_k6_stage_arithmetic_matches_plain(k, nsteps, data):
    """The kernel's decomposition (register stages, lane steps by
    exchange, the packed table of (mt, mm), halfword arithmetic, ballots
    as decision words, int16 storage between stages) against
    cycle_b_plain, bit for bit, for
    whole and partial column phases (K20 with 5 steps stops inside the
    j steps, K16 with 9 inside stage B), on random metrics, on metrics
    in multiples of 255 with symbols 127/128, where ties decide, and on
    metrics at the top of what reaches K6 at K = 24, where the int16
    sums are largest."""
    code = _code(k)
    _, _, colb = viterbi_cuda._geometry(code)
    nsteps = colb if nsteps is None else nsteps
    rng = np.random.default_rng(k * 100 + nsteps)
    B = 2
    if data == "random":
        m0 = rng.integers(0, 12000, (B, code.nstates)).astype(np.int16)
        syms = rng.integers(0, 256, (B, 2 * nsteps)).astype(np.int32)
    elif data == "ties":
        m0 = (rng.integers(0, 3, (B, code.nstates)) * 255).astype(np.int16)
        syms = rng.integers(127, 129, (B, 2 * nsteps)).astype(np.int32)
    else:
        m0, syms = k6_top_inputs(rng, B, code.nstates, nsteps)
    got_m, got_d, got_mins = _k6_stages(m0, syms, code, nsteps)
    mp = torch.as_tensor(m0.copy())
    _, dp, mins = viterbi_cuda.cycle_b_plain(mp, torch.as_tensor(syms), code,
                                             nsteps)
    if data == "top":
        assert int(mp.max()) > K6_TOP + nsteps * 100
    assert np.array_equal(got_m, mp.numpy())
    assert np.array_equal(got_d, dp.numpy())
    assert np.array_equal(got_mins, mins.numpy())


# ---------------------------------------------------------------- K8 plan

# the n the narrowband path gives K8 (a power of two below 8192) and the
# card tests' 8192 and 12288, each at a few window widths
K8_SIZES = [(n, K) for n in (512, 1024, 2048, 4096, 8192, 12288)
            for K in (3, 53, 203, min(n, 2048))]


@pytest.mark.parametrize("n,K", K8_SIZES)
def test_k8_plan_covers_every_sample_and_bin_once(n, K):
    plan = carrier_cuda.windowed_search_plan(n, K)
    assert plan["smem"] <= SMEM_MAX
    C, rows, threads, warps = (plan["columns"], plan["rows"],
                               plan["threads"], plan["warps"])
    assert rows * C == n
    # sample i = C h + c: column c's thread is c mod threads
    h, c = np.divmod(np.arange(n), C)
    owner = np.zeros((threads, rows * -(-C // threads)), dtype=np.int64)
    np.add.at(owner, (c % threads, (c // threads) * rows + h), 1)
    assert owner.sum() == n and owner.max() == 1
    # bin k → warp k mod warps, its class (k mod 16) // warps, slot k // 16:
    # each bin once
    k = np.arange(K)
    ncls = 16 // warps
    seen = np.zeros((warps, ncls, -(-K // 16)), dtype=np.int64)
    np.add.at(seen, (k % warps, (k % 16) // warps, k // 16), 1)
    assert seen.sum() == K and seen.max() == 1
    m, lane = np.divmod(np.arange(C), 32)
    assert np.array_equal(32 * m + lane, np.arange(C))


@pytest.mark.parametrize("n", [18944, 32768, 65536])
def test_k8_plan_refuses_rows_it_cannot_stage(n):
    with pytest.raises(ValueError, match="shared memory"):
        carrier_cuda.windowed_search_plan(n, 53)


def _w(num, den):
    return np.exp(-2j * np.pi * (np.asarray(num, dtype=np.float64) / den))


def _dft16_radix4(x):
    """The kernel's dft16: 4-point DFTs over h1, twiddles W_16^{r1 h2},
    4-point DFTs over h2 → (..., 16) with x[..., r] = A[r]."""
    W4 = _w(np.outer(np.arange(4), np.arange(4)), 4)
    y = x.reshape(*x.shape[:-1], 4, 4)  # [h1][h2]
    y = np.einsum("rh,...hk->...rk", W4, y)  # [r1][h2]
    y = y * _w(np.outer(np.arange(4), np.arange(4)), 16)
    y = np.einsum("...rh,sh->...rs", y, W4)  # [r1][r2]
    return y.transpose(*range(y.ndim - 2), -1, -2).reshape(x.shape)  # r1 + 4 r2


def _k8_split(iq, first1, K):
    """numpy mirror of windowed_search_kernel's sum: A[r][c] by the column
    DFT, then per warp its residue classes, WD_NB bins of each at a time,
    with the integer phase walks q, qm, p."""
    B, n = iq.shape
    C, N32 = n // 16, n // 32
    nb = carrier_cuda.WD_NB
    tab = _w(np.arange(n), n)
    tw32 = tab[32 * np.arange(N32)]
    lanes = np.arange(32)
    M = -(-C // 32)
    out = np.zeros((B, K), dtype=np.complex128)
    for b in range(B):
        A = _dft16_radix4(iq[b].reshape(16, C).T).T  # [r][c]
        Apad = np.concatenate([A, np.zeros((16, 32 * M - C))], axis=1)
        f0 = int(first1[b]) % n
        warps = carrier_cuda.WD_THREADS // 32
        for warp, c in itertools.product(range(warps), range(16 // warps)):
            fm = (f0 + warp + warps * c) % n
            qc, phc = fm % N32, (fm * lanes) % n
            t0 = 0
            while 16 * t0 + warp < K:
                q, p = qc, phc.copy()
                for t in range(nb):
                    if t:
                        q = q + 16 % N32 - (N32 if q + 16 % N32 >= N32 else 0)
                        d = (16 * lanes) % n
                        p = p + d - np.where(p + d >= n, n, 0)
                    acc = np.zeros(32, dtype=np.complex128)
                    qm = 0
                    for m in range(M):
                        acc += tw32[qm] * Apad[fm & 15, 32 * m + lanes]
                        qm = qm + q - (N32 if qm + q >= N32 else 0)
                    k = warp + warps * c + 16 * (t0 + t)
                    if k < K:
                        out[b, k] = (acc * tw32[p >> 5] * tab[p & 31]).sum()
                step = 16 * nb
                qc = qc + step % N32 - (N32 if qc + step % N32 >= N32 else 0)
                d = (step * lanes) % n
                phc = phc + d - np.where(phc + d >= n, n, 0)
                t0 += nb
    return out


@pytest.mark.parametrize("n,K,first", [(4096, 53, [3, 700]), (768, 9, [-5, 40]),
                                       (12288, 103, [1000, 12280])])
def test_k8_split_matches_plain(n, K, first):
    """The kernel's 16 x C split and phase walks give the plain bins
    (float64 here: the mirror checks the index arithmetic, the card tests
    the float32 rounding)."""
    rng = np.random.default_rng(n)
    raw = rng.integers(-3000, 3000, (len(first), 2 * n)).astype(np.int16)
    first1 = torch.tensor(first, dtype=torch.int64)
    want = carrier_cuda.windowed_dft_raw_plain(carrier.pack_raw(torch.as_tensor(raw)),
                                              first1, K).numpy()
    iq = raw[:, 0::2].astype(np.float64) + 1j * raw[:, 1::2]
    got = _k8_split(iq, first1.numpy(), K)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _acc_root8(u, o):
    """numpy copy of csrc/carrier.cu acc_root8's eight cases: u·W_8^o."""
    h = np.float32(0.70710678118654752)
    x, y = u.real, u.imag
    return [complex(x, y), complex(h * (x + y), h * (y - x)), complex(y, -x),
            complex(h * (y - x), -h * (x + y)), complex(-x, -y),
            complex(-h * (x + y), h * (x - y)), complex(-y, x),
            complex(h * (x - y), h * (x + y))][o]


@pytest.mark.parametrize("n", [512, 1024, 2048, 4096])
def test_k8_eighth_roots_match_the_table(n):
    """For n = 512·MC, K8 turns the bins f + 16t of a class by
    W_{n/32}^{f m} · W_8^{((t m) mod MC)·8/MC} instead of one table load
    each: the same twiddle, and its eight cases are u·W_8^o."""
    MC, N32 = n // 512, n // 32
    rng = np.random.default_rng(n)
    for o in range(8):
        u = complex(*rng.normal(size=2))
        assert abs(_acc_root8(u, o) - u * _w(o, 8)) <= 1e-6 * abs(u)
    for f in rng.integers(0, n, 5):
        for m in range(MC):
            for t in range(4):
                o = ((t * m) % MC) * (8 // MC)
                want = _w((f + 16 * t) * m % N32, N32)
                assert abs(_w(f * m % N32, N32) * _w(o, 8) - want) < 1e-12


# ---------------------------------------------------------------- K9 plan

def _check_column_plan(plan, n, K):
    """The column-DFT plan of K9 (and of K1's "columns" design) loads
    every sample once, computes every (column, residue) once and gives
    every bin one (round, warp, slot)."""
    assert plan["smem"] + 1024 <= SMEM_MAX
    threads, warps, cpp = (plan["threads"], plan["warps"],
                           plan["columns_per_pass"])
    C, passes = plan["columns"], plan["passes"]
    assert threads == 32 * warps and warps == 16 and cpp == 32
    assert 256 * C == n and passes * cpp == C
    lane, warp = np.arange(threads) % 32, np.arange(threads) // 32
    loads = np.zeros(n, dtype=np.int64)
    ys = np.zeros((C, 256), dtype=np.int64)
    for p in range(passes):
        # stage 1: rows 16 h1 + warp of column 32 p + lane
        for h1 in range(16):
            np.add.at(loads, C * (16 * h1 + warp) + cpp * p + lane, 1)
        # stage 2: residues warp + 16 r1 of the same column
        for r1 in range(16):
            np.add.at(ys, (cpp * p + lane, warp + 16 * r1), 1)
    assert (loads == 1).all() and (ys == 1).all()
    # bin k = k0 + warp + 16 j → (round, warp, slot j): each once
    k = np.arange(K)
    rnd, rest = np.divmod(k, plan["bins_per_round"])
    seen = np.zeros((plan["rounds"], warps, plan["bins_per_warp"]),
                    dtype=np.int64)
    np.add.at(seen, (rnd, rest % warps, rest // warps), 1)
    assert seen.sum() == K and seen.max() == 1


@pytest.mark.parametrize("n,K", [(n, K) for n in (8192, 16384, 65536, 131072)
                                 for K in (53, 107)])
def test_k9_plan_covers_every_column_residue_and_bin_once(n, K):
    _check_column_plan(carrier_cuda.pm_scan_plan(n, K), n, K)


def test_k9_plan_covers_what_the_gate_admits():
    """Every n the fused scan's gate admits (a multiple of 8192 below
    2^23) at every K the locked search admits (<= 2048) has a plan; other
    n raise."""
    for n in (8192, 24576, 65536, 1 << 20, (1 << 23) - 8192):
        for K in (3, 107, 2048):
            assert carrier_cuda.pm_scan_plan(n, K)["rounds"] == -(-K // 128)
    for n in (4096, 12288, 65536 + 256):
        with pytest.raises(ValueError, match="multiple of 8192"):
            carrier_cuda.pm_scan_plan(n, 53)


def _dft16_regs(x):
    """The kernel's dft16 on (..., 16) complex, in its register order:
    4-point DFTs over h1 (h = 4 h1 + h2), the turn W_16^{r1 h2}, 4-point
    DFTs over h2 → position 4 r1 + r2 holds bin r1 + 4 r2."""
    k4 = torch.arange(4, dtype=torch.float64)
    W4 = torch.exp(-2j * torch.pi * torch.outer(k4, k4) / 4)
    y = x.reshape(*x.shape[:-1], 4, 4)  # [h1][h2]
    y = torch.einsum("rh,...hk->...rk", W4, y)  # [r1][h2]
    y = y * torch.exp(-2j * torch.pi * torch.outer(k4, k4) / 16)
    y = torch.einsum("...rh,sh->...rs", y, W4)  # [r1][r2]
    return y.reshape(x.shape)


def _k9_columns(iq, first1, K, chirp=None):
    """torch mirror of pm_scan_kernel's window bins (column_dft256_pass,
    outer_sum_pass, outer_sum_finish) in complex128: per pass of 32
    columns the stage-1 tile T[r0][h0][lane] turned by W_256^{r0 h0}, the
    stage-2 column DFTs Ys[r][lane], then per warp w and slot j the bin
    k0 + w + 16 j summed over the passes with twiddles tab[base + 512 p j]
    from the W_n^j table, the lane factor tab[(u lane) mod n] after the
    last pass, and the sum over the lanes.  ``chirp`` (n,): K1's de-chirp
    phasors, indexed like the row (i = C h + m), rotating each sample as
    the column pass loads it."""
    B, n = iq.shape
    C = n // 256
    tab = torch.exp(-2j * torch.pi * torch.arange(n, dtype=torch.float64) / n)
    tw256 = tab[::C]  # W_256^j
    pos = torch.arange(16)
    res = pos // 4 + 4 * (pos % 4)  # the bin in register position pos
    h0 = torch.arange(16)
    lane = torch.arange(32)
    warp, slot = torch.arange(16)[:, None], torch.arange(8)[None, :]
    out = torch.zeros((B, K), dtype=torch.complex128)
    for b in range(B):
        x = torch.as_tensor(iq[b])
        if chirp is not None:
            x = x * chirp
        x = x.reshape(256, C)  # [h][m]
        for k0 in range(0, K, 128):
            u0 = (int(first1[b]) + k0 + warp[:, 0]) % n  # (16,)
            d = (32 * u0) % n
            base = torch.zeros(16, dtype=torch.int64)
            acc = torch.zeros((16, 8, 32), dtype=torch.complex128)
            for p in range(C // 32):
                cols = x[:, 32 * p: 32 * p + 32].reshape(16, 16, 32)  # h1, h0, lane
                regs = _dft16_regs(cols.permute(1, 2, 0))  # [h0][lane][pos]
                T = torch.zeros((16, 16, 32), dtype=torch.complex128)
                T[res] = (regs * tw256[torch.outer(h0, res)][:, None, :]
                          ).permute(2, 0, 1)  # [r0][h0][lane]
                regs2 = _dft16_regs(T.permute(0, 2, 1))  # [r0][lane][pos]
                Ys = torch.zeros((256, 32), dtype=torch.complex128)
                Ys[(torch.arange(16)[:, None] + 16 * res[None, :]).reshape(-1)] = \
                    regs2.permute(0, 2, 1).reshape(256, 32)
                r = (u0[:, None] + 16 * slot) & 255  # (16, 8)
                ph = base[:, None] + 512 * p * slot
                ph = torch.where(ph >= n, ph - n, ph)
                acc += Ys[r] * tab[ph][:, :, None]
                base = base + d
                base = torch.where(base >= n, base - n, base)
            u = u0[:, None] + 16 * slot
            u = torch.where(u >= n, u - n, u)
            v = (acc * tab[(u[:, :, None] * lane) % n]).sum(-1)  # (16, 8)
            k = k0 + warp + 16 * slot
            keep = k < K
            out[b, k[keep]] = v[keep]
    return out


@pytest.mark.parametrize("n,K,first", [
    (8192, 53, [3, 230, 8192 - 53]),        # 230: f mod 256 wraps
    (65536, 107, [5000, 250, 65536 - 40]),  # the last: past the top edge
    (16384, 203, [100, 16384 - 203]),       # two rounds of bins
])
def test_k9_column_split_matches_fft_and_plain(n, K, first):
    """The kernel's split (two 16-point stages with the W_256 turn, passes
    of 32 columns, outer twiddles from the W_n^j table) gives torch.fft.fft's
    bins and the plain windowed DFT's, within 1e-5 of the largest bin
    (complex128 here: the mirror checks the index arithmetic, the card
    tests the float32 rounding)."""
    rng = np.random.default_rng(n + K)
    raw = rng.integers(-3000, 3000, (len(first), 2 * n)).astype(np.int16)
    first1 = torch.tensor(first, dtype=torch.int64)
    iq = raw[:, 0::2].astype(np.float64) + 1j * raw[:, 1::2]
    got = _k9_columns(iq, first1.numpy(), K)
    idx = (first1[:, None] + torch.arange(K)) % n
    fft = torch.gather(torch.fft.fft(torch.as_tensor(iq)), 1, idx)
    assert (got - fft).abs().max() <= 1e-5 * fft.abs().max()
    plain = carrier_cuda.windowed_dft_raw_plain(
        carrier.pack_raw(torch.as_tensor(raw)), first1, K)
    assert (got - plain).abs().max() <= 1e-5 * plain.abs().max()


# ---------------------------------------------------------------- K1 plan

@pytest.mark.parametrize("n,K", [(n, K) for n in (8192, 16384, 65536, 131072)
                                 for K in (3, 53, 107, 129, 203)])
def test_k1_plan_covers_every_column_residue_and_bin_once(n, K):
    """K1's "columns" design is K9's split at K9's plan: every sample
    loaded once, every (column, residue) computed once, every bin of the
    window in one (round, warp, slot)."""
    plan = carrier_cuda.pm_locked_plan(n, K)
    assert plan["design"] == "columns"
    assert plan["rounds"] == -(-K // 128) and plan["passes"] == n // 8192
    _check_column_plan(plan, n, K)


@pytest.mark.parametrize("n", [768, 4096, 18944])
def test_k1_plan_picks_direct_below_the_column_split(n):
    """n a multiple of 256 but not of 8192 (the de-chirped narrowband
    blocks) takes the direct sum: ⌈K/16⌉ bin tiles of 256 threads, each
    summing its column over the n/256 rows; shared memory holds those
    rows' twiddles and the warps' partial bins."""
    for K in (3, 53, 107):
        plan = carrier_cuda.pm_locked_plan(n, K)
        assert plan["design"] == "direct"
        assert plan["threads"] == 256 and plan["rows"] == n // 256
        assert plan["rounds"] * plan["bins_per_round"] >= K
        assert (plan["rounds"] - 1) * plan["bins_per_round"] < K
        assert plan["smem"] == (n // 256 + 128) * 8 <= SMEM_MAX


@pytest.mark.parametrize("n,K,match", [
    (1000, 53, "multiple of 256"), (0, 53, "multiple of 256"),
    (8192, 2, "out of range"), (4096, 4097, "out of range"),
    ((1 << 23) - 256, 53, "shared memory"),
])
def test_k1_plan_refuses_what_k1_does_not_take(n, K, match):
    with pytest.raises(ValueError, match=match):
        carrier_cuda.pm_locked_plan(n, K)


@pytest.mark.parametrize("n,K,first,doppler", [
    (8192, 53, [-20, 8192 - 30, 230], 40.0),   # below 0, past n, mod 256
    (16384, 107, [-5, 16384 - 100], -25.0),    # a falling chirp
    (8192, 203, [-150, 8192 - 120], 0.0),      # two rounds, no de-chirp
])
def test_k1_column_split_matches_fft_and_plain(n, K, first, doppler):
    """The "columns" design's bins (K9's split with the de-chirp rotating
    each loaded sample, windows wrapping below 0 and past n) give
    torch.fft.fft's bins of the de-chirped row and pm_locked_plain's
    bins, within 1e-5 of the largest bin (complex128 mirror; the card
    tests the float32 rounding)."""
    assert carrier_cuda.pm_locked_plan(n, K)["design"] == "columns"
    samprate = 32768.0
    dop = doppler / samprate**2
    rng = np.random.default_rng(n + K)
    raw = rng.integers(-3000, 3000, (len(first), 2 * n)).astype(np.int16)
    first1 = torch.tensor(first, dtype=torch.int64)
    iq = raw[:, 0::2].astype(np.float64) + 1j * raw[:, 1::2]
    chirp = (carrier_cuda.chirp_table(n, dop, torch.device("cpu"))
             .to(torch.complex128) if dop else None)
    got = _k9_columns(iq, first1.numpy(), K, chirp)
    row = torch.as_tensor(iq) * (chirp if dop else 1.0)
    idx = (first1[:, None] + torch.arange(K)) % n
    fft = torch.gather(torch.fft.fft(row), 1, idx)
    assert (got - fft).abs().max() <= 1e-5 * fft.abs().max()
    plain = carrier_cuda.pm_locked_bins_plain(
        carrier.pack_raw(torch.as_tensor(raw)), first1, K, dop=dop)
    assert (got - plain).abs().max() <= 1e-5 * plain.abs().max()


# ---------------------------------------------------------------- K4 plan

K7 = CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)


@pytest.mark.parametrize("code", [K7, DEFAULT_CODE], ids=["K7", "MCQLI24"])
@pytest.mark.parametrize("B,N", [(1, 1024), (12, 1024), (137, 1024),
                                 (256, 1024), (1000, 1024), (5000, 64),
                                 (37, 7263), (37, 7264), (3, 20000)])
def test_k4_plan_covers_every_lane_once(code, B, N):
    """Every lane is walked by exactly one warp (or thread) of one block;
    a block's shared memory holds its lanes' metrics and tapes within
    one block's limit; the "warp" design spreads the lanes over the SMs
    (no block holds more lanes than ⌈B / 132⌉ unless shared memory or
    1024 threads cap it)."""
    if N < code.k:
        pytest.skip("shorter than the code")
    plan = fano_cuda.fano_walk_plan(B, N, code, 12)
    lanes = plan["lanes"]
    seen = np.zeros(B, dtype=np.int64)
    for blk in range(plan["grid"]):
        for w in range(lanes):
            if blk * lanes + w < B:
                seen[blk * lanes + w] += 1
    assert (seen == 1).all()
    assert (plan["grid"] - 1) * lanes < B
    assert plan["smem"] <= SMEM_MAX and plan["threads"] <= 1024
    if plan["design"] == "warp":
        lane_smem = (2 * N + 1) * 16
        assert plan["threads"] == 32 * lanes
        assert plan["smem"] == lanes * lane_smem
        assert lanes == min(-(-B // 132), SMEM_MAX // lane_smem, 32)
    else:
        assert plan == {"design": "thread", "lanes": 32, "threads": 32,
                        "grid": -(-B // 32), "smem": 0}


@pytest.mark.parametrize("N", [24, 1024, 4096, 7263, 7264, 8192, 20000])
def test_k4_plan_picks_thread_exactly_when_a_lane_does_not_fit(N):
    """"warp" wherever one lane's metrics and tape, (2N + 1) x 16 bytes,
    fit in one block's shared memory; "thread" exactly where they do not,
    and pinning "warp" there raises."""
    fits = (2 * N + 1) * 16 <= SMEM_MAX
    plan = fano_cuda.fano_walk_plan(8, N, DEFAULT_CODE, 12)
    assert plan["design"] == ("warp" if fits else "thread")
    assert fano_cuda.fano_walk_plan(8, N, DEFAULT_CODE, 12,
                                    "thread")["design"] == "thread"
    if fits:
        assert fano_cuda.fano_walk_plan(8, N, DEFAULT_CODE, 12,
                                        "warp")["design"] == "warp"
    else:
        with pytest.raises(ValueError, match="shared memory"):
            fano_cuda.fano_walk_plan(8, N, DEFAULT_CODE, 12, "warp")


@pytest.mark.parametrize("B,N,code,maxcycles,match", [
    (0, 1024, DEFAULT_CODE, 12, "unsupported"),
    (4, 23, DEFAULT_CODE, 12, "unsupported"),
    (4, 1024, DEFAULT_CODE, 2**21, "unsupported"),
    (4, 1024, CodeSpec("TESTK31", (1 << 30) | 1, (1 << 30) | 3, 31, 0, 0),
     12, "state bits"),
    (4, 1024, DEFAULT_CODE, 12, "unknown K4 design"),
])
def test_k4_plan_refuses_what_k4_does_not_take(B, N, code, maxcycles, match):
    design = "lanes" if match == "unknown K4 design" else None
    with pytest.raises(ValueError, match=match):
        fano_cuda.fano_walk_plan(B, N, code, maxcycles, design)


def _k4_serial_scan(T, np_, t, tail_start, kb):
    """The "thread" design's backward scan (csrc/fano.cu fano_kernel):
    the first record from the top with gamma < t relaxes at j + 1, the
    first untried branch below the tail toggles at j → (target, toggle,
    records read)."""
    for j in range(np_ - 1, -1, -1):
        if T[j, 0] < t:
            return j + 1, False, np_ - j
        if j < tail_start and (T[j, 3] >> kb) == 0:
            return j, True, np_ - j
    return 0, False, np_


def _k4_ballot_search(T, np_, t, tail_start, kb):
    """numpy mirror of the "warp" design's search (csrc/fano.cu
    fano_warp_kernel): lane i reads record top - i, two ballots, the
    lowest set lane of either decides (relax where its relax bit is set)
    → (target, toggle, 32-record chunks read)."""
    lane = np.arange(32)
    top, chunks = np_ - 1, 0
    while top >= 0:
        chunks += 1
        j = top - lane
        valid = j >= 0
        rec = T[np.maximum(j, 0)]
        relax_bits = int(((valid & (rec[:, 0] < t)).astype(np.int64)
                          << lane).sum())
        toggle = valid & (j < tail_start) & ((rec[:, 3] >> kb) == 0)
        hits = relax_bits | int((toggle.astype(np.int64) << lane).sum())
        if hits:
            i = (hits & -hits).bit_length() - 1
            tog = not (relax_bits >> i) & 1
            return (top - i if tog else top - i + 1), tog, chunks
        top -= 32
    return 0, False, chunks


def _k4_max_rule(T, np_, t, tail_start, kb):
    """The JAX walk's rule (fano_pallas.py:146-158): jr, jt the last
    nodes below np with gamma < t and with an untried branch below the
    tail; toggle at jt when jt > jr, else relax at jr + 1."""
    j = np.arange(np_)
    jr = int(j[T[:np_, 0] < t].max(initial=-1))
    jt = int(j[(j < tail_start) & ((T[:np_, 3] >> kb) == 0)].max(initial=-1))
    return (jt, True) if jt > jr else (jr + 1, False)


def _k4_warp_walk(m4, regs, code, delta, maxcycles, seen):
    """Python mirror of the "warp" design's walk, lane by lane: the
    tightening by mask (delta a power of two); the symbol pair of the
    next advance carried from the last one; the top record (node np - 1)
    kept in registers, so a backtrack run that ends there (relax where
    the walk stands, or toggle the top record) reads no tape; the ballot
    search over the records below it otherwise.  At every violation the
    outcome is held against the serial scan and the JAX rule on the tape
    as it stands; ``seen`` counts the violations by kind → (bits (B, N)
    uint8, stats (B, 4) int32).  A wide code (30 or more state bits)
    walks as the 64-bit instance does: tail shifts up to 63."""
    B, N, _ = m4.shape
    kb, tail_start = code.kbits, N - (code.k - 1)
    tail_max = 63 if kb + 1 >= 31 else 31
    encmask = (1 << kb) - 1
    assert delta & (delta - 1) == 0
    p1 = (code.poly1 >> 1) & (encmask >> 1)
    p2 = (code.poly2 >> 1) & (encmask >> 1)
    q1, q2 = p1 & 1, p2 & 1
    bits = np.zeros((B, N), dtype=np.uint8)
    stats = np.zeros((B, 4), dtype=np.int32)

    def par(x):
        return bin(x).count("1") & 1

    def pair(e):  # the symbol pair of an advance from state e
        return ((par(e & p1) << 1) ^ code.g1flip) | (par(e & p2) ^ code.g2flip)

    for b in range(B):
        tm0, tm1, enc, skip, tailbits = (int(v) for v in regs[b])
        T = np.zeros((N + 1, 4), dtype=np.int64)
        np_ = t = cycles = g = ibr = 0
        top = (0, 0, 0, 0)  # the record of node np - 1, for np >= 1
        ls, tmc = pair(enc), tm0
        while not skip:
            adv = (enc << 1) & encmask
            # the pair of the advance after the next, for either new bit,
            # from the parities of adv: parity((adv | 1) & p) flips by p & 1
            pa1, pa2 = par(adv & p1), par(adv & p2)
            ls0 = ((pa1 << 1) ^ code.g1flip) | (pa2 ^ code.g2flip)
            ls1 = (((pa1 ^ q1) << 1) ^ code.g1flip) | (pa2 ^ q2 ^ code.g2flip)
            assert (ls0, ls1) == (pair(adv), pair(adv | 1))
            ngamma = g + tmc
            if ngamma >= t:
                t_fwd = t + ((ngamma - t) & -delta) if g < t + delta else t
                assert t_fwd == (t + delta * ((ngamma - t) // delta)
                                 if g < t + delta else t)
                if np_ == N - 1:
                    t = t_fwd
                    cycles += 1
                    break
                top = (g, tm0, tm1, (ibr << kb) | enc)
                T[np_] = top
                m = [int(v) for v in m4[b, np_ + 1]]
                if np_ + 1 >= tail_start:
                    bit = (tailbits >> min(max(N - np_ - 2, 0), tail_max)) & 1
                    a0 = a1 = m[(bit * 3) ^ ls]
                else:
                    a0, a1 = m[ls], m[3 ^ ls]
                    bit = int(a1 >= a0)
                tm0, tm1 = max(a0, a1), min(a0, a1)
                tmc, enc, ls = tm0, adv | bit, ls1 if bit else ls0
                g, ibr, np_, t = ngamma, 0, np_ + 1, t_fwd
            else:
                serial = _k4_serial_scan(T, np_, t, tail_start, kb)
                rule = _k4_max_rule(T, np_, t, tail_start, kb)
                seen["violations"] += 1
                seen["np_below_32"] += np_ < 32
                seen["in_tail"] += np_ > tail_start
                if np_ == 0 or top[0] < t:  # relax where the walk stands
                    assert np_ == 0 or top == tuple(T[np_ - 1])
                    target, toggle = np_, False
                    seen["relax_top"] += 1
                    enc ^= int(ibr != 0)
                    ibr, tmc, t = 0, tm0, t - delta
                else:
                    if np_ - 1 < tail_start and (top[3] >> kb) == 0:
                        target, toggle = np_ - 1, True  # toggle the top
                        seen["toggle_top"] += 1
                    else:  # ballots over the records below the top
                        target, toggle, chunks = _k4_ballot_search(
                            T, np_ - 1, t, tail_start, kb)
                        seen["ballot"] += 1
                        seen["chunks"] = max(seen["chunks"], chunks)
                    rec = tuple(int(v) for v in T[target])
                    bibr = rec[3] >> kb
                    g, tm0, tm1 = rec[0], rec[1], rec[2]
                    enc = (rec[3] & encmask) ^ int(toggle or bibr != 0)
                    ibr = bibr + 1 if toggle else 0
                    tmc = tm1 if toggle else tm0
                    t = t if toggle else t - delta
                    np_ = target
                    top = (tuple(int(v) for v in T[np_ - 1]) if np_ >= 1
                           else (0, 0, 0, 0))
                assert (target, toggle) == serial[:2] == rule
                ls = pair(enc)
            cycles += 1
            if cycles >= maxcycles * N:
                break
        bits[b, :np_] = T[:np_, 3] & 1
        if np_ < N:
            bits[b, np_] = enc & 1
        stats[b] = (np_, g, cycles, t)
    return bits, stats


@pytest.mark.parametrize("code,nbits,lanes,sigma,maxcycles", [
    (K7, 64, 37, 85.0, 6),
    (DEFAULT_CODE, 1024, 6, 60.0, 3),
    (DEFAULT_CODE, 64, 8, 95.0, 12),
], ids=["K7", "MCQLI24", "MCQLI24-short"])
def test_k4_ballot_search_matches_the_serial_scan(code, nbits, lanes, sigma,
                                                  maxcycles):
    """On tapes recorded from real seeded walks, the "warp" design's
    search (the top record from registers, then ballots below it) finds
    the serial scan's target and toggle (and the JAX walk's jr/jt
    rule's) at every violation, including nodes in the tail and np < 32;
    the mirror walk gives fano_walk_plain's bits and [np, gamma, cycles,
    t]."""
    rng = np.random.default_rng(nbits + lanes)
    data = torch.as_tensor(rng.integers(0, 2, (lanes, nbits)))
    start = SYNC_STATE & ((1 << (code.k - 1)) - 1)
    syms, _ = encode_bits(data, start, code)
    noise = torch.as_tensor(rng.normal(0, sigma, syms.shape))
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise)
                       + 128, 0, 255).to(torch.uint8)
    mettab = torch.as_tensor(DecodeConfig().mettab())
    skip = torch.as_tensor(rng.random(lanes) < 0.15)
    m4, regs = _walk_inputs(soft, mettab, nbits, start, 0, code, skip)
    seen = dict(violations=0, np_below_32=0, in_tail=0, relax_top=0,
                toggle_top=0, ballot=0, chunks=0)
    bits, stats = _k4_warp_walk(m4.numpy(), regs.numpy(), code, 32, maxcycles,
                                seen)
    bits_p, stats_p = fano_cuda.fano_walk_plain(m4, regs, code, 32, maxcycles)
    assert np.array_equal(bits, bits_p.numpy())
    assert np.array_equal(stats, stats_p.numpy())
    assert seen["violations"] > 100
    assert min(seen["relax_top"], seen["toggle_top"], seen["ballot"]) > 0
    assert seen["np_below_32"] > 0 and seen["in_tail"] > 0
    assert (stats[:, 0] + 1 != nbits).any()  # a lane timed out


@pytest.mark.parametrize("seed", range(6))
def test_k4_ballot_search_on_sparse_tapes(seed):
    """Tapes whose hits lie deep (beyond the first 32 records, or none at
    all), with relax and toggle on one record: the ballot search walks
    down 32 records at a time and agrees with the serial scan and the JAX
    rule on every (np, t)."""
    rng = np.random.default_rng(seed)
    kb, n = 24, 200
    tail_start = n - 23
    gam = rng.integers(0, 400, n + 1)
    ibr = (rng.random(n + 1) < 0.97).astype(np.int64)  # mostly tried
    T = np.stack([gam, np.zeros_like(gam), np.zeros_like(gam),
                  (ibr << kb) | rng.integers(0, 1 << kb, n + 1)], axis=1)
    deep = 0
    for np_ in range(0, n + 1):
        for t in (-10, 5, 60, 200, 401):
            got = _k4_ballot_search(T, np_, t, tail_start, kb)
            assert got[:2] == _k4_serial_scan(T, np_, t, tail_start, kb)[:2]
            assert got[:2] == _k4_max_rule(T, np_, t, tail_start, kb)
            deep += got[2] > 1
    assert deep > 0


# ---------------------------------------------------------------- K4 wide

WIDE = [CODES[n] for n in ("MCQLI32", "J50", "J60")]


@pytest.mark.parametrize("N", [64, 1024, 4096, 5810, 5811, 8192])
def test_k4_wide_plan_records_and_switch(N):
    """The wide variant's plan: 24-byte records, a lane's metrics and
    tape 16N + 24(N + 1) bytes rounded up to 16 (so every lane's metrics
    stay 16-byte aligned); "warp" exactly where a lane fits (N <= 5810),
    4-5 lanes a block at N = 1024, "thread" beyond, and pinning "warp"
    there raises."""
    code = CODES["J60"]
    lane = fano_cuda.lane_bytes(N, fano_cuda.WIDE_RECORD_BYTES)
    assert lane % 16 == 0 and 0 <= lane - (16 * N + 24 * (N + 1)) < 16
    assert fano_cuda.lane_bytes(N, fano_cuda.RECORD_BYTES) == (2 * N + 1) * 16
    plan = fano_cuda.fano_walk_plan(1000, N, code, 12,
                                    rec_bytes=fano_cuda.WIDE_RECORD_BYTES)
    fits = lane <= SMEM_MAX
    assert fits == (N <= 5810)
    assert plan["design"] == ("warp" if fits else "thread")
    if fits:
        assert plan["smem"] == plan["lanes"] * lane <= SMEM_MAX
        assert plan["lanes"] == min(-(-1000 // 132), SMEM_MAX // lane, 32)
        if N == 1024:
            assert SMEM_MAX // lane == 5
    else:
        with pytest.raises(ValueError, match="shared memory"):
            fano_cuda.fano_walk_plan(8, N, code, 12, "warp",
                                     rec_bytes=fano_cuda.WIDE_RECORD_BYTES)


@pytest.mark.parametrize("code,rec_bytes,match", [
    (CODES["MCQLI32"], 16, "state bits"),
    (CODES["J60"], 16, "state bits"),
    (CodeSpec("TESTK61", (1 << 60) | 1, (1 << 60) | 3, 61, 0, 0), 24,
     "at most 60"),
    (CODES["J50"], 32, "16 or 24"),
])
def test_k4_wide_plan_refusals(code, rec_bytes, match):
    with pytest.raises(ValueError, match=match):
        fano_cuda.fano_walk_plan(4, 1024, code, 12, rec_bytes=rec_bytes)


@pytest.mark.parametrize("kb", [32, 50, 60])
def test_k4_wide_tape_word(kb):
    """numpy mirror of the wide record: {gamma, tm0, tm1, pad} int32 and
    the 64-bit word (ibr << kb) | enc, 24 bytes; unpacking by a logical
    shift and a kb-bit mask gives back enc and ibr at every kb, the
    word's top bit stays clear (ibr <= 1, kb <= 60), and tail bit j of a
    64-bit tail is one shift."""
    rng = np.random.default_rng(kb)
    rec = np.dtype([("g", "<i4"), ("tm0", "<i4"), ("tm1", "<i4"),
                    ("pad", "<i4"), ("w", "<u8")], align=True)
    assert rec.itemsize == fano_cuda.WIDE_RECORD_BYTES
    assert rec.fields["w"][1] == 16
    mask = np.uint64((1 << kb) - 1)
    enc = rng.integers(0, 1 << kb, 1000, dtype=np.uint64)
    enc[:2] = (0, (1 << kb) - 1)
    ibr = rng.integers(0, 2, 1000).astype(np.uint64)
    tape = np.zeros(1000, rec)
    tape["g"] = rng.integers(-5000, 5000, 1000)
    tape["w"] = (ibr << np.uint64(kb)) | enc
    raw = np.frombuffer(tape.tobytes(), np.uint8).reshape(1000, 24)
    w = raw[:, 16:].copy().view("<u8")[:, 0]
    assert np.array_equal(w & mask, enc)
    assert np.array_equal(w >> np.uint64(kb), ibr)
    assert (w >> np.uint64(63) == 0).all()
    assert np.array_equal(raw[:, :4].copy().view("<i4")[:, 0], tape["g"])
    tail = int(rng.integers(0, 1 << 62)) | (1 << (kb - 2))
    for j in range(kb - 1):
        assert (np.uint64(tail) >> np.uint64(j)) & np.uint64(1) == (tail >> j) & 1


@pytest.mark.parametrize("code", WIDE, ids=lambda c: c.name)
def test_k4_wide_warp_walk_matches_the_wide_plain(code):
    """The "warp" design's walk on the 64-bit word (the Python mirror,
    ballot search against the serial scan and the JAX rule at every
    violation) gives the wide plain version's bits and [np, gamma,
    cycles, t]: the collapsed walk and the step-by-step one agree."""
    rng = np.random.default_rng(code.k)
    lanes, nbits, maxcycles = 6, 128, 4
    tail = int(rng.integers(0, 1 << (code.k - 1)))
    data = torch.as_tensor(rng.integers(0, 2, (lanes, nbits)))
    for j in range(code.k - 1):
        data[:, nbits - 1 - j] = (tail >> j) & 1
    syms, _ = encode_bits(data, 5, code)
    noise = torch.as_tensor(rng.normal(0, 80.0, syms.shape))
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise)
                       + 128, 0, 255).to(torch.uint8)
    mettab = torch.as_tensor(DecodeConfig().mettab())
    m4, regs = _walk_inputs(soft, mettab, nbits, 5, tail, code, None)
    assert regs.dtype == torch.int64
    seen = dict(violations=0, np_below_32=0, in_tail=0, relax_top=0,
                toggle_top=0, ballot=0, chunks=0)
    bits, stats = _k4_warp_walk(m4.numpy(), regs.numpy(), code, 32, maxcycles,
                                seen)
    bits_p, stats_p = fano_cuda.fano_walk_wide_plain(m4, regs, code, 32,
                                                     maxcycles)
    assert np.array_equal(bits, bits_p.numpy())
    assert np.array_equal(stats, stats_p.numpy())
    assert seen["violations"] > 50 and seen["ballot"] > 0


# ---------------------------------------------------------------- spin-down plan

SPIN_NS = (256, 768, 4096, 8192, 12288, 18944, 40960, 65536, 65792, 131072)


def _spin_index(plan, n):
    """The sample each (rank or chunk, slot, thread, position) of the
    plan's design holds, -1 past n: "cluster" rank r, slot p, thread t,
    position e → r·chunk + GROUP·(p·threads + t) + e; "two_pass" chunk k,
    step j, thread t → k·SPIN_CHUNK + j·threads + t."""
    T = plan["threads"]
    if plan["design"] == "cluster":
        G = plan["group"]
        r, p, t, e = np.ix_(np.arange(plan["cluster"]),
                            np.arange(plan["samples_per_thread"] // G),
                            np.arange(T), np.arange(G))
        idx = r * plan["chunk"] + G * (p * T + t) + e
    else:
        k, j, t = np.ix_(np.arange(plan["grid"][0]),
                         np.arange(plan["samples_per_thread"]), np.arange(T))
        idx = k * plan["chunk"] + j * T + t
    return np.where(idx < n, idx, -1)


@pytest.mark.parametrize("design", [None, "two_pass"])
@pytest.mark.parametrize("n", SPIN_NS)
def test_spin_plan_covers_every_sample_once(n, design):
    """Every sample of a row is held by exactly one (rank, thread, slot) —
    (chunk, thread, step) on "two_pass" — on the design the plan picks
    ("cluster" up to 8 blocks of 8192 samples, "two_pass" beyond) and on
    "two_pass" pinned."""
    plan = carrier_cuda.spin_plan(n, 128, design)
    idx = _spin_index(plan, n)
    assert np.array_equal(np.sort(idx[idx >= 0]), np.arange(n))
    want = design or ("cluster" if n <= 8 * 8192 else "two_pass")
    assert plan["design"] == want
    if want == "cluster":
        assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 512
        assert 1 <= plan["cluster"] <= 8
        assert (plan["cluster"] - 1) * plan["chunk"] < n
        # a lone block: n rounded up to a warp's 512 samples; else a
        # block per de-chirp chunk
        assert (plan["chunk"] < n + 512 if plan["cluster"] == 1
                else plan["chunk"] == carrier_cuda.CHIRP_CHUNK)
        assert plan["grid"] == (plan["cluster"], 128)
    else:
        assert plan["grid"] == (-(-n // carrier_cuda.SPIN_CHUNK), 128)


@pytest.mark.parametrize("n", [n for n in SPIN_NS if n <= 8 * 8192])
def test_spin_plan_blocks_keep_to_one_chirp_chunk(n):
    """A "cluster" block takes one de-chirp chunk, r·chunk // 8192, for
    all its samples (the kernel computes one Chirp a block), and a group
    of 8 starts at a multiple of 8, so its samples share idx >> 8 and j >> 8
    (spun_group's hoisting)."""
    plan = carrier_cuda.spin_plan(n, 8)
    idx = _spin_index(plan, n)
    for r in range(plan["cluster"]):
        held = idx[r][idx[r] >= 0]
        assert np.unique(held // carrier_cuda.CHIRP_CHUNK).tolist() == [
            r * plan["chunk"] // carrier_cuda.CHIRP_CHUNK]
    first = idx[..., 0]
    first = first[first >= 0]
    assert (first % 8 == 0).all()
    assert np.array_equal(idx[idx >= 0] >> 8,
                          np.broadcast_to(idx[..., :1], idx.shape)[idx >= 0] >> 8)


@pytest.mark.parametrize("n,B,design,match", [
    (1000, 8, None, "multiple of 256"), (0, 8, None, "multiple of 256"),
    (1 << 30, 8, None, "multiple of 256"), (4096, 0, None, "out of range"),
    (4096, 65536, None, "out of range"),
    (65792, 8, "cluster", "at most 65536"),
    (131072, 8, "cluster", "at most 65536"), (4096, 8, "warp", "unknown"),
])
def test_spin_plan_refuses_what_no_design_takes(n, B, design, match):
    with pytest.raises(ValueError, match=match):
        carrier_cuda.spin_plan(n, B, design)


@pytest.mark.parametrize("samprate", [250_000.0, 32_768.0, 256_000.0,
                                      2_048_000.0 / 7])
def test_spin_kernel_cycles_round_as_carrier_cycles(samprate):
    """The "cluster" kernel divides the carrier by the sample rate itself:
    __fdiv_rn(Hz, fs) with fs as the wrapper passes it
    (carrier_cuda.kernel_samprate), the IEEE float32 quotient — bit-equal
    to carrier.carrier_cycles, which K1, K2's plain version and the
    "two_pass" design use."""
    rng = np.random.default_rng(int(samprate))
    f = np.concatenate([rng.uniform(-samprate / 2, samprate / 2, 4000),
                        20_000.0 + 137.0 * np.arange(128) + 0.125,
                        [0.0, -0.0, 1e-3]]).astype(np.float32)
    fs = np.float32(carrier_cuda.kernel_samprate(samprate))
    assert float(fs) == carrier_cuda.kernel_samprate(samprate)
    kernel = np.divide(f, fs)  # round to nearest, as __fdiv_rn
    plain = carrier.carrier_cycles(torch.from_numpy(f), samprate).numpy()
    assert kernel.dtype == plain.dtype == np.float32
    assert np.array_equal(kernel.view(np.int32), plain.view(np.int32))


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _spin_cluster_mirror(packed, freq, samprate, flip=False, dop=0.0):
    """The "cluster" design's arithmetic and summation order in torch:
    per sample spun_group's phase (the group's c256·(idx >> 8) and chirp
    head once, (idx & 255) as the group's first plus e), one sincos and
    the rotation; float per-thread partials over the slots (p, e) in
    order; double over a warp as the shuffle tree sums it, over the warps
    in order, over the ranks in order; finish_moments and emit_sample in
    float32.  → (baseband int16, amp, cn0, cycles of every sample as
    spun_group computes them)."""
    B, n = packed.shape
    plan = carrier_cuda.spin_plan(n, B)
    assert plan["design"] == "cluster"
    idx = torch.as_tensor(_spin_index(plan, n))      # (C, NG, T, G)
    valid = idx >= 0
    sidx = idx.clamp(min=0)
    words = packed[:, sidx.flatten()].reshape(B, *idx.shape)
    lo = (words << 16 >> 16).float()
    hi = (words >> 16).float()
    i_, q_ = (hi, lo) if flip else (lo, hi)
    c = freq.to(torch.float32) / _f32(np.float32(samprate))
    c256 = torch.remainder(c * 256.0, 1.0)
    cb = c[:, None, None, None, None]
    idx0 = sidx[..., :1]
    e = torch.arange(plan["group"], dtype=torch.float32)
    hi_t = c256[:, None, None, None, None] * (idx0 >> 8).float()
    lo_t = cb * ((idx0 & 255).float() + e)
    cyc = hi_t + lo_t
    if dop:
        k = sidx[:, :1, :1, :1] // carrier_cuda.CHIRP_CHUNK   # a block's chunk
        j0 = (idx0 & (carrier_cuda.CHIRP_CHUNK - 1))
        parts = []
        for r in range(plan["cluster"]):
            base = float(r * plan["chunk"] // carrier_cuda.CHIRP_CHUNK) * 8192
            hd = 0.5 * dop
            Bk = (dop * base + hd) % 1.0
            parts.append((np.float32((hd * base * base + hd * base) % 1.0),
                          np.float32(Bk), np.float32((256.0 * Bk) % 1.0),
                          np.float32(hd)))
        A, Bk, B256, C = (_f32([p[m] for p in parts])[:, None, None, None]
                          for m in range(4))
        assert k.flatten().tolist() == list(range(plan["cluster"]))
        t0 = A + B256 * (j0 >> 8).float()
        jf = j0.float() + e
        t = t0 + Bk * ((j0 & 255).float() + e)
        t = t + C * (jf * jf)
        cyc = cyc + t
    ang = _f32(6.283185307179586) * cyc
    s, co = torch.sin(ang), torch.cos(ang)
    sr = torch.where(valid, i_ * co + q_ * s, 0.0)   # i_·lor − q_·loi, loi = −s
    si = torch.where(valid, -(i_ * s) + q_ * co, 0.0)
    # float per thread over its slots (p, e) in order
    a = torch.zeros((5, B, plan["cluster"], plan["threads"]))
    for p in range(idx.shape[1]):
        for g in range(idx.shape[3]):
            x, y = sr[:, :, p, :, g], si[:, :, p, :, g]
            for m, v in enumerate((x, y, x * x, y * y, x * y)):
                a[m] = a[m] + v
    # double: the warp's shuffle tree, then warps and ranks in order
    v = a.double().reshape(5, B, plan["cluster"], -1, 32)
    for off in (16, 8, 4, 2, 1):
        v = torch.cat([v[..., :off] + v[..., off:2 * off], v[..., off:]], -1)
    warp = v[..., 0]
    part = torch.zeros((5, B, plan["cluster"]), dtype=torch.float64)
    for w in range(warp.shape[-1]):
        part = part + warp[..., w]
    tot = torch.zeros((5, B), dtype=torch.float64)
    for r in range(plan["cluster"]):
        tot = tot + part[..., r]
    inv = _f32(np.float32(1.0 / n))
    m_r, m_i, m_rr, m_ii, m_ri = (tot[m].float() * inv for m in range(5))
    amp2 = m_r * m_r + m_i * m_i
    amp = torch.sqrt(amp2)
    safe2 = torch.where(amp2 > 0, amp2, 1.0)
    e_rot2 = (m_rr * m_r * m_r + 2.0 * m_ri * m_r * m_i
              + m_ii * m_i * m_i) / safe2
    var = torch.maximum(e_rot2 - amp2, amp2 * 3e-7 + 1e-30)
    cn0 = _f32(10.0 / 2.30258509) * torch.log(samprate * amp2 / (2.0 * var))
    safe_amp = torch.where(amp > 0, amp, 1.0)
    ur = torch.where(amp > 0, m_r / safe_amp, 1.0)[:, None, None, None, None]
    ui = torch.where(amp > 0, -m_i / safe_amp, 0.0)[:, None, None, None, None]
    rot_i = sr * ui + si * ur
    q = torch.trunc(rot_i * _f32(0.70710677)).clamp(-32768.0, 32767.0)
    bb = torch.zeros((B, n), dtype=torch.int16)
    bb[:, sidx[valid]] = q[:, valid].to(torch.int16)
    cycles = torch.zeros((B, n))
    cycles[:, sidx[valid]] = cyc.expand(B, *idx.shape)[:, valid]
    return bb, amp, cn0, cycles


def _spin_signal(B, n, samprate, seed, flip=False, dop=0.0):
    """(B, 2n) raw int16 of PM carriers 2000 + 137 Hz·i chirped at dop
    cycles/sample² (restarted at sample 0, as the de-chirp assumes), and
    the carriers 0.125 Hz off as the spin-down is given them.  With flip
    the recording stores Q, I: its carriers and chirp are mirrored, so the
    flipped reading sees them at +dop and -f."""
    from tests.test_pmdemod import pm_signal

    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, 256) * 2 - 1
    freqs = 2000.0 + 137.0 * np.arange(B)
    t = np.arange(n, dtype=np.float64)
    chirp = np.exp(2j * np.pi * ((-1.0 if flip else 1.0) * dop
                                 * (t * (t + 1.0) / 2.0) % 1.0))
    iq = np.stack([pm_signal(n, samprate, f, 1.1, data, 32.0, amp=12000)
                   * chirp + rng.normal(0, 300, n) + 1j * rng.normal(0, 300, n)
                   for f in freqs])
    ri = np.stack([iq.real, iq.imag], axis=-1).reshape(B, -1)
    raw = np.trunc(np.clip(ri, -32767, 32767)).astype(np.int16)
    f = freqs.astype(np.float32) + np.float32(0.125)
    return raw, (-f if flip else f)


def _spin_mirror_case(n, flip, doppler):
    """A mirror case: (raw, carriers, dop, mirror's (bb, amp, cn0),
    spin_down_plain's), the mirror's phase checked bit for bit against
    the per-sample formula the plain version and spun_sample use."""
    samprate, B = 32768.0, 8
    dop = doppler / samprate**2
    raw, f = _spin_signal(B, n, samprate, n + int(flip), flip, dop)
    packed = carrier.pack_raw(torch.from_numpy(raw))
    bb_m, a_m, c_m, cyc_m = _spin_cluster_mirror(packed, torch.from_numpy(f),
                                                 samprate, flip, dop)
    # the direct phase: c256·(i >> 8) + c·(i & 255) (+ the chirp cycles)
    c = carrier.carrier_cycles(torch.from_numpy(f), samprate)
    i = torch.arange(n)
    direct = (torch.remainder(c * 256.0, 1.0)[:, None] * (i >> 8).float()
              + c[:, None] * (i & 255).float())
    if dop:
        direct = direct + carrier_cuda.chirp_cycles(n, dop, torch.device("cpu"))
    assert torch.equal(cyc_m, direct)
    plain = carrier_cuda.spin_down_plain(packed, torch.from_numpy(f),
                                         samprate, flip, dop)
    return raw, f, dop, (bb_m, a_m, c_m), plain


@pytest.fixture
def jax_compiled_here():
    """The JAX kernel's interpret-mode arithmetic is the float32 code XLA
    generates for the machine: its vector ISA changes the bits (under
    ``--xla_cpu_max_isa=AVX``, no FMA, the baseband and amplitude of the
    n = 8192 case differ from AVX2's and AVX-512's), and tests/conftest.py
    turns on a persistent compilation cache that hands a process programs
    other processes compiled, on whatever machine wrote them (the XLA:CPU
    AOT loader warns of mismatched machine features).  So the JAX side
    of a comparison compiles in the test's own process: the persistent
    cache off and the in-memory executables dropped for the test, the
    cache setting restored after."""
    import jax

    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_compilation_cache", prev)


def _assert_spin_close(got, want):
    (bb_m, a_m, c_m), (bb, amp, cn0) = got, want
    torch.testing.assert_close(a_m, amp, rtol=1e-5, atol=0)
    torch.testing.assert_close(c_m, cn0, atol=1e-2, rtol=0)
    assert int((bb_m.int() - bb.int()).abs().max()) <= 1


@pytest.mark.parametrize("n,flip,doppler", [
    (8192, False, 0.0), (8192, True, 40.0),       # one block
    (16384, False, 0.0), (16384, True, 40.0),     # a cluster of 2
    (32768, True, 0.0), (32768, False, 40.0),     # a cluster of 4
])
def test_spin_cluster_arithmetic_matches_plain_and_jax(n, flip, doppler,
                                                       jax_compiled_here):
    """The torch mirror of the "cluster" design (its group phase, its
    summation order: float per thread, double over warps and ranks)
    against spin_down_plain and the JAX package's spin_down_fused
    (interpret mode), with flip and a rising Doppler rate: amplitude
    within rtol 1e-5, C/N0 within 1e-2 dB, baseband within 1 LSB (the
    tolerances of tests/test_torch_carrier.py); its phase per sample
    bit-equal to the per-sample formula."""
    import jax.numpy as jnp

    from isee3_decoder_tpu.ops import carrier_pallas as jp

    raw, f, dop, mirror, plain = _spin_mirror_case(n, flip, doppler)
    _assert_spin_close(mirror, plain)
    bb_j, a_j, c_j = jp.spin_down_fused(jnp.asarray(raw), jnp.asarray(f),
                                        32768.0, flip=flip, interpret=True,
                                        dop=dop)
    _assert_spin_close(mirror, (torch.from_numpy(np.array(bb_j)),
                                torch.from_numpy(np.array(a_j, np.float32)),
                                torch.from_numpy(np.array(c_j, np.float32))))


@pytest.mark.parametrize("n,flip", [(8192, False), (16384, False),
                                    (32768, True)])
def test_spin_cluster_arithmetic_matches_plain_on_a_falling_chirp(n, flip):
    """The mirror against spin_down_plain on a falling chirp (-30 Hz/s),
    at the same tolerances.  Not against the JAX kernel: there Bk = (dop·
    base + dop/2) mod 1 rounds to 1.0 in float32 and adds up to 255 whole
    cycles to the float32 phase, and the plain version itself differs from
    the JAX kernel in interpret mode by 2 LSB (n = 8192 to 32,768; ROADMAP
    §3)."""
    _, _, _, mirror, plain = _spin_mirror_case(n, flip, -30.0)
    _assert_spin_close(mirror, plain)


@pytest.mark.parametrize("n,doppler,lsb", [(8192, -30.0, 2), (32768, -30.0, 2),
                                           (8192, 40.0, 1), (32768, 40.0, 1)])
def test_spin_down_plain_against_jax_on_chirps(n, doppler, lsb,
                                               jax_compiled_here):
    """Pins the falling-chirp gap of ROADMAP §3: the port's spin_down_plain
    and the JAX package's spin_down_fused (interpret mode) on the same
    chirped carriers, baseband within 2 LSB at -30 Hz/s (the float32 Bk
    just below 1 puts whole cycles into both packages' phase, each its
    own way) and within the 1 LSB contract at +40 Hz/s; amplitude within
    rtol 1e-5 and C/N0 within 1e-2 dB at both rates.  A larger gap fails
    here."""
    import jax.numpy as jnp

    from isee3_decoder_tpu.ops import carrier_pallas as jp

    samprate = 32768.0
    dop = doppler / samprate**2
    raw, f = _spin_signal(8, n, samprate, n + 3, False, dop)
    bb, amp, cn0 = carrier_cuda.spin_down_plain(
        carrier.pack_raw(torch.from_numpy(raw)), torch.from_numpy(f),
        samprate, False, dop)
    bb_j, a_j, c_j = jp.spin_down_fused(jnp.asarray(raw), jnp.asarray(f),
                                        samprate, flip=False, interpret=True,
                                        dop=dop)
    torch.testing.assert_close(amp, torch.from_numpy(np.array(a_j, np.float32)),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(cn0, torch.from_numpy(np.array(c_j, np.float32)),
                               atol=1e-2, rtol=0)
    gap = int((bb.int() - torch.from_numpy(np.array(bb_j)).int()).abs().max())
    assert gap <= lsb


def _spin_kernel_eager(raw, f, samprate, dop):
    """The JAX package's ``_spin_kernel`` body (carrier_pallas.py:214-300)
    replayed op by op in eager jnp over whole rows: the same expressions,
    its own ``_chirp_cycles`` chunk constants, each op rounded to float32
    on its own → the int16 baseband."""
    import jax.numpy as jnp

    from isee3_decoder_tpu.ops import carrier_pallas as jp

    packed = jp.pack_raw(jnp.asarray(raw))
    B, n = packed.shape
    ch = jp._CH
    c = (jnp.asarray(f) / np.float32(samprate)).astype(jnp.float32)[:, None]
    c256 = jnp.mod(c * 256.0, 1.0)
    j = jnp.broadcast_to(jnp.arange(ch, dtype=jnp.int32)[None], (B, ch))
    jf = j.astype(jnp.float32)
    jh = (j // 256).astype(jnp.float32)
    jl = (j % 256).astype(jnp.float32)
    spun, acc = [], [jnp.zeros((B, ch), jnp.float32)] * 5
    for k in range(n // ch):
        x = packed[:, k * ch:(k + 1) * ch]
        i_ = jnp.right_shift(jnp.left_shift(x, 16), 16).astype(jnp.float32)
        q_ = jnp.right_shift(x, 16).astype(jnp.float32)
        idx = j + k * ch
        cyc = (c256 * (idx // 256).astype(jnp.float32)
               + c * (idx % 256).astype(jnp.float32))
        A, Bk, B256, C = jp._chirp_cycles(k, ch, dop)
        cyc = cyc + (np.float32(A) + np.float32(B256) * jh
                     + np.float32(Bk) * jl + np.float32(C) * (jf * jf))
        ang = (2 * np.pi) * cyc
        lor, loi = jnp.cos(ang), -jnp.sin(ang)
        sr, si = i_ * lor - q_ * loi, i_ * loi + q_ * lor
        spun.append((sr, si))
        acc = [acc[0] + sr, acc[1] + si, acc[2] + sr * sr, acc[3] + si * si,
               acc[4] + sr * si]
    inv = np.float32(1.0 / n)
    m_r, m_i = (a.sum(axis=1, keepdims=True) * inv for a in acc[:2])
    amp = jnp.sqrt(m_r * m_r + m_i * m_i)
    safe_amp = jnp.where(amp > 0, amp, 1.0)
    ur = jnp.where(amp > 0, m_r / safe_amp, 1.0)
    ui = jnp.where(amp > 0, -m_i / safe_amp, 0.0)
    scale = np.float32(np.sqrt(0.5))
    return np.concatenate([np.asarray(jnp.trunc((sr * ui + si * ur) * scale)
                                      .astype(jnp.int16)) for sr, si in spun],
                          axis=1)


@pytest.mark.parametrize("n", [8192, 32768])
@pytest.mark.parametrize("doppler", [-30.0, 40.0])
def test_spin_down_plain_against_the_jax_kernels_expressions(n, doppler):
    """spin_down_plain within 1 LSB of the JAX kernel's own expressions
    evaluated op by op (``_spin_kernel_eager``), on rising and falling
    chirps.  The 2-LSB gap pinned above lies in how the JAX kernel's
    interpret mode evaluates them: it runs the body as one XLA program,
    which folds the first chunk's A = 0 and float32(Bk) = 1.0 (a falling
    rate's Bk just below 1) and contracts B256·(j//256) + (j%256) and
    C·j² + t into fused multiply-adds, one rounding where the expressions
    round twice: 1 ulp of the float32 phase (3e-5 cycles at ~290) on
    4096 of the chunk's 8192 samples, 2 LSB of baseband."""
    samprate = 32768.0
    dop = doppler / samprate**2
    raw, f = _spin_signal(8, n, samprate, n + 3, False, dop)
    bb, _, _ = carrier_cuda.spin_down_plain(
        carrier.pack_raw(torch.from_numpy(raw)), torch.from_numpy(f),
        samprate, False, dop)
    want = _spin_kernel_eager(raw, f, samprate, dop)
    assert int(np.abs(bb.numpy().astype(np.int32) - want).max()) <= 1


# ---------------------------------------------------------------- K7 plan

K7_SHAPES = [(m, os_) for m in (32, 64, 128, 256) for os_ in (1, 2)]


@pytest.mark.parametrize("P", [8, 5, 12])
@pytest.mark.parametrize("nchan,oversample", K7_SHAPES)
def test_pfb_plan_fits_shared_memory_and_registers(nchan, oversample, P):
    """K7's plan: its DFT split, tile, ring and tap tasks fit together
    (every tap task one branch of one stream walking whole rings, lanes of
    a warp along r in the tap stage and along j in the DFT stages), two
    stages hold the ring's furthest read and the rounded copy, the block
    fits one block's shared memory, the grid is persistent over the
    tiles, and each thread's registers (ring, taps, accumulators; M1
    complex values in the first DFT stage) stay within what the blocks an
    SM holds leave it."""
    nsamp = 2 * 1000 - 3
    plan = channelizer_cuda.pfb_plan(nchan, P, oversample, nsamp)
    m1, m2 = plan["split"]
    tile, ring, run, T = plan["tile"], plan["ring"], plan["run"], plan["threads"]
    assert m1 * m2 == nchan and {m1, m2} <= {4, 8, 16}
    assert P <= ring in (8, 16) and run % ring == 0
    assert plan["frames"] * oversample == tile and plan["frames"] % run == 0
    assert tile % 32 == 0 and T % nchan == 0 and T % 32 == 0
    tasks = nchan * tile // run
    assert tasks % T == 0  # every thread takes as many tap tasks
    assert (tile * m2) % T == 0 and (tile * m1) % T == 0
    # the furthest stage word the tap stage reads: the last run of the
    # odd stream's upper branches, 3 words of misalignment ahead
    far = 3 + (plan["frames"] - run + 1 + run + ring - 2) * nchan + nchan - 1
    assert far < plan["stage_words"]
    assert 3 + plan["copy_words"] + 3 <= plan["stage_words"]  # rounded copy
    assert plan["stage_words"] % 4 == 0  # stage 1 starts 16-byte aligned
    assert plan["smem"] <= SMEM_MAX and plan["stages"] == 2
    blocks, regs = plan["blocks_per_sm"], plan["regs"]
    assert 1 <= blocks and blocks * (plan["smem"] + 1024) <= 233_472
    assert blocks * T * regs <= 65536
    # ring pairs, taps, two sums and ~16 for addresses and indices; the
    # first DFT stage's M1 values and as many temporaries
    assert 3 * ring + 2 + 16 <= regs and 4 * m1 + 8 <= regs
    assert plan["ntiles"] == -(-nsamp // tile)
    assert plan["grid"] == min(plan["ntiles"], blocks * 132)
    assert plan["pitch"] % 32 == 0 and 0 <= plan["pitch"] - nsamp < 32


@pytest.mark.parametrize("nchan,P,match", [(256, 100, "shared memory"),
                                           (128, 17, "register ring"),
                                           (96, 8, "power of two")])
def test_pfb_plan_refuses_what_k7_does_not_take(nchan, P, match):
    with pytest.raises(ValueError, match=match):
        channelizer_cuda.pfb_plan(nchan, P, 1, 1000)


def _unpack_words(w):
    """int32 packed words → complex128 (I low half, Q high half)."""
    w = np.asarray(w, np.int64) & 0xFFFFFFFF
    i = ((w & 0xFFFF) ^ 0x8000) - 0x8000
    q = ((w >> 16) ^ 0x8000) - 0x8000
    return i.astype(np.float64) + 1j * q.astype(np.float64)


def _pfb_mirror(wide, nchan, P, oversample, taps, mis, rng):
    """A numpy mirror of pfb_kernel's index arithmetic, tile by tile: the
    rounded bulk copy from a capture that starts ``mis`` words past a
    16-byte boundary (the words around it and the stage's stale words
    random), the tap tasks' branch, column, frame offset and register
    ring, the M1 × M2 split with the twiddle table (the odd samples'
    sign at oversample 2 from its second table, odd k1 negated), and the
    store into rows of the plan's pitch.  Returns the
    (M, pitch) int32 rows (unwritten words -1) and the tap-stage reads
    per (tile, task, frame)."""
    M, OS = nchan, oversample
    nwords = wide.shape[0]
    nsamp = channelizer_cuda._nsamp(nwords, M, P, OS)
    plan = channelizer_cuda.pfb_plan(M, P, OS, nsamp)
    tile, frames, ring, run = (plan["tile"], plan["frames"], plan["ring"],
                               plan["run"])
    m1, m2 = plan["split"]
    sw = plan["stage_words"]
    # memory: the capture at word 4 + mis, random words around it
    mem = rng.integers(-2**31, 2**31, nwords + 16).astype(np.int32)
    mem[4 + mis: 4 + mis + nwords] = wide
    end16 = -(-(4 + mis + nwords) // 4) * 4  # the last word's granule end
    h = np.zeros((ring, M))
    h[:P] = np.asarray(taps, np.float64).reshape(P, M)
    tw = channelizer_cuda._twiddles(M, torch.device("cpu")).numpy()
    tw = tw[:, 0].astype(np.float64) + 1j * tw[:, 1]
    w1 = np.exp(-2j * np.pi * np.outer(np.arange(m1), np.arange(m1)) / m1)
    w2 = np.exp(-2j * np.pi * np.outer(np.arange(m2), np.arange(m2)) / m2)
    task = np.arange(M * tile // run)
    r, s, rn = task % M, (task // M) % OS, task // (M * OS)
    col = np.where(s == 1, (r + M // 2) % M, r)
    d = np.where(s == 1, r >= M // 2, 0)
    out = np.full((M, plan["pitch"]), -1, np.int64)
    reads = np.zeros((plan["ntiles"], task.size, run + ring), np.int64)
    for t in range(plan["ntiles"]):
        w0 = t * frames * M
        nw = min(plan["copy_words"], nwords - w0)
        nbytes = -(-4 * (mis + nw) // 16) * 16
        src = 4 + mis + w0 - mis
        assert src % 4 == 0 and nbytes <= 4 * sw
        assert src + nbytes // 4 <= end16  # within the last word's granule
        stage = rng.integers(-2**31, 2**31, sw).astype(np.int32)
        stage[: nbytes // 4] = mem[src: src + nbytes // 4]
        xs = stage[mis:]
        idx0 = (rn * run + d) * M + col
        assert idx0.max() + (run + ring - 2) * M < xs.size
        ringv = np.zeros((ring, task.size), complex)
        for q in range(ring - 1):
            ringv[q] = _unpack_words(xs[idx0 + q * M])
            reads[t, :, q] += 1
        A = np.full((tile, M), np.nan, complex)
        for f in range(run):
            q = f + ring - 1
            ringv[q % ring] = _unpack_words(xs[idx0 + q * M])
            reads[t, :, q] += 1
            a = sum(ringv[(f + p) % ring] * h[p, r] for p in range(ring))
            j = OS * (rn * run + f) + s
            assert np.isnan(A[j, r]).all()  # one writer per (j, r)
            A[j, r] = a
        assert not np.isnan(A).any()
        for r2 in range(m2):  # stage 1, back into slots m2·k1 + r2
            X = A[:, m2 * np.arange(m1) + r2] @ w1
            turn = np.broadcast_to(tw[r2 * m1 + np.arange(m1)], X.shape).copy()
            if OS == 2:  # odd samples: the table with odd k1 negated
                turn[1::2, 1::2] *= -1
            A[:, m2 * np.arange(m1) + r2] = X * turn
        j0 = t * tile
        valid = j0 + np.arange(tile) < nsamp
        for k1 in range(m1):  # stage 2: bins k1 + m1·k2
            Y = A[:, m2 * k1 + np.arange(m2)] @ w2
            q_ = np.trunc(np.clip(np.stack([Y.real, Y.imag]), -32767, 32767))
            q_ = q_.astype(np.int64)
            word = (q_[0] & 0xFFFF) | ((q_[1] & 0xFFFF) << 16)
            for k2 in range(m2):
                out[k1 + m1 * k2, j0 + np.flatnonzero(valid)] = word[valid, k2]
    return out, reads


@pytest.mark.parametrize("nchan,oversample,P,nframes,extra,mis", [
    (32, 1, 8, 300, 5, 1),      # a partial last tile and frame
    (32, 2, 8, 515, 0, 0),
    (64, 1, 8, 277, 0, 2),
    (64, 2, 5, 201, 40, 3),     # 5 taps in a ring of 8
    (128, 1, 8, 200, 3, 1),
    (128, 2, 8, 161, 70, 0),    # over half a frame trails: the odd stream's
    (128, 1, 12, 150, 0, 3),    # a ring of 16
    (256, 1, 8, 120, 5, 0),
    (256, 2, 12, 110, 128, 1),
])
def test_pfb_mirror_matches_plain(nchan, oversample, P, nframes, extra, mis):
    """The mirror of pfb_kernel against channelize_raw_plain: at most 1 LSB
    apart on under 1 % of the values (its DFTs in float64, the plain
    bank's in float32: truncation-boundary flips), nothing written past
    nsamp, and every tap task reading each frame of its ring walk once."""
    rng = np.random.default_rng(nchan + 7 * nframes)
    nwords = nframes * nchan + extra
    iq = rng.integers(-20000, 20000, (2, nwords))
    wide = ((iq[0] & 0xFFFF) | (iq[1] << 16)).astype(np.int64)
    wide = wide.astype(np.uint32).view(np.int32)
    taps = (channelizer_cuda.default_taps(nchan, P, oversample) if P == 8
            else rng.normal(0, 0.05, nchan * P).astype(np.float32))
    got, reads = _pfb_mirror(wide, nchan, P, oversample, taps, mis, rng)
    run, ring = channelizer_cuda.PFB_RUN, channelizer_cuda.pfb_plan(
        nchan, P, oversample, 1)["ring"]
    assert (reads[:, :, : run + ring - 1] == 1).all()
    want = channelizer_cuda.channelize_raw_plain(
        torch.from_numpy(wide), nchan, P, taps, oversample)
    nsamp = want.shape[1] // 2
    assert (got[:, nsamp:] == -1).all()
    got16 = torch.from_numpy(got[:, :nsamp].astype(np.uint32).view(np.int32)
                             .copy()).view(torch.int16)
    diff = (got16.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) < 0.01


# ---------------------------------------------------------------- K3 plan

_M32 = 0xFFFFFFFF


@pytest.mark.parametrize("tail", [0, 1, 3])
@pytest.mark.parametrize("T", [1, 3, 67])
@pytest.mark.parametrize("n", [1000, 1001, 4096, 8195])
def test_k3_plan_fits_shared_memory_and_registers(n, T, tail):
    """K3's plan: a block fits one block's shared memory, the blocks an SM
    holds fit its shared memory, registers and threads, the grid is
    persistent over the tiles, the tiles of a row cover each of its T·n
    columns once (the channel's last tile also its tail columns), the
    workspace holds the counter and a status word a tile, and each row's
    single-word head and tail are what its phase leaves."""
    for B in (1, 5, 130):
        plan = prefix_cuda.prefix_plan(T, B, n, tail)
        L, tile, threads = T * n, plan["tile"], plan["threads"]
        assert plan["items"] * threads == tile and tile % 32 == 0
        assert threads % 32 == 0 and threads // 32 <= plan["lookback"] == 32
        assert plan["smem"] <= SMEM_MAX and plan["stages"] == 2
        blocks = plan["blocks_per_sm"]
        assert 1 <= blocks and blocks * (plan["smem"] + 1024) <= 233_472
        assert blocks * threads * plan["regs"] <= 65536
        assert blocks * threads <= 2048
        # 16 samples, their sum and scan, the loads' addresses
        assert plan["regs"] >= 32
        # loads in flight an SM: the next tile of every block
        assert blocks * 2 * tile >= 32 * 1024
        per_row = plan["tiles_per_row"]
        assert plan["ntiles"] == B * per_row
        assert plan["grid"] == min(plan["ntiles"], blocks * 132)
        assert plan["workspace"] == 8 * (2 + plan["ntiles"])
        assert plan["load"] == ("cp.async" if n % 8 == 0 else "scalar")
        cover = np.zeros(L, np.int64)
        for i in range(per_row):
            cover[i * tile: min(L, (i + 1) * tile)] += 1
        assert (cover == 1).all() and (per_row - 1) * tile < L
        for b in sorted({0, min(1, B - 1), B - 1}):
            h, t = plan["row_heads"][b], plan["row_tails"][b]
            assert 0 <= h < 4 and 0 <= t < 4 and h <= L
            assert (b * (L + tail) + h) % 4 == 0 or h == L
            last = L - (per_row - 1) * tile
            assert (last - min(h, last) - t) % 4 == 0


@pytest.mark.parametrize("T,B,n,tail", [(0, 1, 8, 0), (1, 0, 8, 0),
                                        (1, 1, 0, 0), (1, 1, 8, -1),
                                        (2, 1, 2**30, 0), (1, 1, 2**31 - 1, 1)])
def test_k3_plan_refuses_what_k3_does_not_take(T, B, n, tail):
    with pytest.raises(ValueError, match="unsupported shape"):
        prefix_cuda.prefix_plan(T, B, n, tail)


def _k3_look_back(status, row, i, rounds):
    """Warp 0's look-back of tile i (status words of its row at row +
    0 .. i - 1): its prefix, or None while a lane still spins on a tile
    that has not published.  Counts the rounds in rounds[0]."""
    prefix = 0
    for base in itertools.count(i - 1, -32):
        rounds[0] += 1
        idx = base - np.arange(32)
        s = np.where(idx >= 0, status[row + np.maximum(idx, 0)], 2 << 32)
        flags, v = s >> 32, s & _M32
        incl = flags == 2
        if incl.any():
            nearest = int(np.argmax(incl))
            # every tile before an inclusive prefix has published
            assert (flags[nearest:] > 0).all()
            if (flags[:nearest] == 0).any():
                return None
            return (prefix + int(v[:nearest + 1].sum())) & _M32
        if (flags == 0).any():
            return None
        prefix = (prefix + int(v.sum())) & _M32


def _k3_mirror(blocks, tail, rng, in_flight, out_phase=0, aligned=True,
               newest_first=False):
    """csrc/prefix.cu's prefix_tile_kernel walked in numpy: tickets handed
    out in order to ``in_flight`` tiles at a time, which advance one step
    (read and reduce, then publish; look back; store) at a time in a
    random order (``newest_first``: the newest tile that can, so that
    every tile in flight publishes its aggregate before the oldest looks
    back); the 16-byte groups (``aligned`` and n % 8 == 0: each
    within one pm block, through a stage whose stale words are masked) or
    single samples each thread reads; the thread, warp and tile sums; the
    staging buffer with its pad words; the single and 16-byte stores of an
    output whose first word lies ``out_phase`` words past a 16-byte
    boundary; the tail columns.  → (out (B, T·n + tail) as uint32 in
    int64, writes of each output word, (b, head, tail) of every tile,
    deepest look-back in rounds)."""
    T, B, n = blocks.shape
    plan = prefix_cuda.prefix_plan(T, B, n, tail)
    L, tile, NT, IT = T * n, plan["tile"], plan["threads"], plan["items"]
    per_row, ntiles = plan["tiles_per_row"], plan["ntiles"]
    flat = blocks.reshape(-1).astype(np.int64)
    row_words = L + tail
    out = np.zeros(B * row_words, np.int64)
    writes = np.zeros(B * row_words, np.int64)
    status = np.zeros(ntiles, np.int64)
    vec = plan["load"] == "cp.async" and aligned
    tid = np.arange(NT)
    edges, deepest = [], 0

    def read(b, s0, ln):
        if vec:
            stage = rng.integers(-32768, 32768, tile)  # an earlier tile's
            q = np.arange(tile // 8)
            f = s0 + 8 * q
            q, f = q[f < L], f[f < L]
            t = f // n
            r = f - t * n
            assert (r + 8 <= n).all()  # a group lies in one pm block
            src = ((t * B + b) * n + r)[:, None] + np.arange(8)
            stage[(8 * q)[:, None] + np.arange(8)] = flat[src]
            slots = stage.reshape(-1, 8)
            sw = ((tid >> 2) & 1)[:, None]
            a, c = slots[2 * tid + sw[:, 0]], slots[2 * tid + (sw[:, 0] ^ 1)]
            x = np.concatenate([np.where(sw, c, a), np.where(sw, a, c)], 1)
            j = IT * tid[:, None] + 2 * (np.arange(IT) // 2)
            return np.where(j < ln, x, 0)
        x = np.zeros((NT, IT), np.int64)
        j0 = IT * tid
        t = (s0 + j0) // n
        r = s0 + j0 - t * n
        for m in range(IT):
            ok = j0 + m < ln
            x[ok, m] = flat[(t[ok] * B + b) * n + r[ok]]
            r = np.where(ok, r + 1, r)
            t = np.where(r == n, t + 1, t)
            r = np.where(r == n, 0, r)
        return x

    def step(st):
        nonlocal deepest
        k = st["k"]
        b, i = k % B, k // B
        s0 = i * tile
        ln = min(tile, L - s0)
        me = b * per_row + i
        if st["phase"] == 0:  # read, reduce, publish, stage
            x = read(b, s0, ln) & _M32
            sums = x.sum(1) & _M32
            inc = (np.cumsum(sums.reshape(-1, 32), 1) & _M32).reshape(-1)
            wtot = inc[31::32]
            agg = int(wtot.sum()) & _M32
            status[me] = ((2 if i == 0 else 1) << 32) | agg
            # each warp's sums from the tile's start: the totals of the
            # warps before it, then its own scan, into the padded buffer
            before = (np.cumsum(wtot) - wtot) & _M32
            run = (before[tid // 32] + inc - sums) & _M32
            j = np.arange(tile)
            so = np.full(tile + tile // 32, -1, np.int64)
            so[j + (j >> 5)] = ((run[:, None] + np.cumsum(x, 1) - x)
                                & _M32).reshape(-1)
            st.update(so=so, agg=agg, phase=1)
            if i == 0:
                st.update(prefix=0, phase=2)
            return True
        if st["phase"] == 1:  # look back
            rounds = [0]
            prefix = _k3_look_back(status, b * per_row, i, rounds)
            deepest = max(deepest, rounds[0])
            if prefix is None:
                return False
            status[me] = (2 << 32) | ((prefix + st["agg"]) & _M32)
            st.update(prefix=prefix, phase=2)
            return True
        # store singly and by 16 bytes, adding the tile's prefix
        so = (st["so"] + st["prefix"]) & _M32
        base = b * row_words + s0
        head = min(ln, (-(out_phase + base)) % 4)
        nvec = (ln - head) // 4
        jv = head + 4 * np.arange(nvec)
        assert ((out_phase + base + jv) % 4 == 0).all()
        for c in range(4):
            out[base + jv + c] = so[jv + c + ((jv + c) >> 5)]
            writes[base + jv + c] += 1
        single = np.r_[np.arange(head), np.arange(head + 4 * nvec, ln)]
        out[base + single] = so[single + (single >> 5)]
        writes[base + single] += 1
        edges.append((b, head, ln - head - 4 * nvec))
        if i == per_row - 1:
            out[b * row_words + L:(b + 1) * row_words] = \
                (st["prefix"] + st["agg"]) & _M32
            writes[b * row_words + L:(b + 1) * row_words] += 1
        st["phase"] = 3
        return True

    ticket, active, done = 0, [], 0
    while done < ntiles:
        while len(active) < in_flight and ticket < ntiles:
            active.append({"k": ticket, "phase": 0})
            ticket += 1
        # some tile can always advance: the oldest one waits on nothing
        order = (range(len(active) - 1, -1, -1) if newest_first
                 else rng.permutation(len(active)))
        assert any(step(active[a]) for a in order)
        done += sum(st["phase"] == 3 for st in active)
        active = [st for st in active if st["phase"] != 3]
    return out.reshape(B, row_words), writes.reshape(B, row_words), edges, deepest


@pytest.mark.parametrize("T,B,n,tail,in_flight,out_phase,aligned,newest", [
    (1, 1, 1000, 0, 1, 0, True, False),     # one tile, one pm block
    (3, 5, 1000, 1, 8, 0, True, False),     # groups of 8 in pm blocks of 1000
    (3, 130, 1001, 3, 64, 0, True, False),  # 2-byte loads, every row phase
    (67, 1, 4096, 1, 40, 0, True, True),    # tiles span two pm blocks; the
    (67, 1, 4096, 3, 40, 0, True, False),   # look-back past 32 tiles
    (67, 5, 4096, 0, 100, 2, True, False),  # an output 8 bytes past a boundary
    (3, 1, 8195, 3, 3, 1, True, True),      # pm blocks across tile edges
    (1, 130, 8195, 1, 200, 0, True, False),
    (67, 1, 1001, 0, 20, 3, True, False),
    (3, 5, 4096, 1, 16, 0, False, False),   # a misaligned input: 2-byte loads
])
def test_k3_mirror_matches_plain(T, B, n, tail, in_flight, out_phase,
                                 aligned, newest):
    """The mirror of prefix_tile_kernel against prefix_sum_blocks_plain,
    bit for bit: every output word written exactly once, the 16-byte
    stores aligned, each tile's single words its row's head and tail as
    the plan gives them, and look-backs past 32 predecessors where 40
    tiles of one row are in flight."""
    rng = np.random.default_rng(T * n + B)
    blocks = rng.integers(-32768, 32768, (T, B, n)).astype(np.int16)
    got, writes, edges, deepest = _k3_mirror(blocks, tail, rng, in_flight,
                                             out_phase, aligned, newest)
    want = prefix_cuda.prefix_sum_blocks_plain(torch.from_numpy(blocks), tail)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64) & _M32)
    assert (writes == 1).all()
    plan = prefix_cuda.prefix_plan(T, B, n, tail)
    if out_phase == 0:
        heads = {b: h for b, h, _ in edges}
        assert all(heads[b] == plan["row_heads"][b] for b in heads)
        L, tile = T * n, plan["tile"]
        last = L - (plan["tiles_per_row"] - 1) * tile
        for b, h, t in edges:
            assert t in ((tile - h) % 4, plan["row_tails"][b]) and t < 4
            assert plan["row_tails"][b] == (last - min(h, last)) % 4
    if newest and in_flight > 33:
        assert deepest >= 2  # a look-back read more than one round


def test_k3_mirror_where_int32_wraps():
    # a run of 32767s: the sums pass 2^31 and wrap, as the plain version's
    blocks = np.full((3, 2, 32768), 32767, np.int16)
    blocks[:, 1] = -32768
    rng = np.random.default_rng(5)
    got, writes, _, _ = _k3_mirror(blocks, 1, rng, 6)
    want = prefix_cuda.prefix_sum_blocks_plain(torch.from_numpy(blocks), 1)
    assert int(want[0, -1]) < 0
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64) & _M32)
    assert (writes == 1).all()
