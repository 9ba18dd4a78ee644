// Kernels K5 and K6 of the PyTorch/CUDA port: one trellis cycle of the
// fused in-place Viterbi ACS (rotating layout), in two phases.
//
// Replaces the TPU kernels _kernel_a (K5, isee3_decoder_tpu/ops/
// viterbi_pallas_fused.py:157, call :341) and _kernel_b (K6, :203, call
// :412).  Wrappers and plain versions: ops/viterbi_cuda.py.
//
// The metrics of a frame, (2^W) int16 with W = K-1, are a (2^ROWB, 2^COLB)
// matrix (ROWB = 8, COLB = 15 at K = 24).  Steps 0..ROWB-1 of a cycle pair
// rows of one column (K5), steps ROWB..W-1 pair columns of one row (K6).
// Per pair (lo, hi), branch metric mt, mm = 510 - mt:
//   a0 = lo+mt, a1 = hi+mm, a2 = lo+mm, a3 = hi+mt,
//   d0 = a0 > a1 at lo, d1 = a2 > a3 at hi (strict: ties keep a0 / a2),
//   lo' = d0 ? a1 : a0,  hi' = d1 ? a3 : a2,
// in int32 (K5) or int16 halves (K6), stored back as int16 (the
// per-cycle renormalization keeps the values in range).  The branch bits
// are flip ^ parity(p & mask) of the position p; both kernels split the
// parity by the bits of p (those fixed for a thread's item, those of its
// registers) and read the metric from a small table in shared memory,
// where the TPU kernel B read precomputed planes because its vector unit
// had no popcount.
// Decision words follow the contract of ops/viterbi_inplace.py: bit
// (p>>7)&31 of word (p>>12)*128 + (p&127) of the step's plane.
//
// What bounds them on the H100.  Per frame and whole cycle at K = 24,
// K5 moves 40 MiB (metrics read and written, 8 decision planes) and K6
// 47 MiB: ~27 us of HBM time at 3.35 TB/s.  The ACS itself is ~20
// integer operations per pair (two AND+POPC+AND+XOR parities, metric
// select and add, four adds, two compares, two selects), 2^22 pairs per
// step, 23 steps: ~1.9e9 operations, ~116 us at the 16.7e12 int32
// operations/s of 132 SMs x 64 INT32 lanes x 1.98 GHz.  So integer
// operations, not bytes, bound both kernels; the design keeps every
// intermediate of a phase in shared memory, so each phase reads and
// writes the metrics once.
//   K5: one block per (frame, tile of 256 columns), all 2^ROWB rows in
//     shared memory as int16 pairs; the steps in radix stages of up to
//     three in registers (see a_stage below).
//   K6: one block per (frame, row), the row in shared memory as int16
//     pairs (64 KB at COLB = 15, two blocks an SM); the steps in up to
//     three register stages on int16 pairs, the j steps by warp shuffles,
//     decisions by lane ballots (see b_stage below): ~6 instructions a
//     pair, under the 20 counted above.  Each block also writes its row's
//     minimum for the next cycle's base.
//
// Beside them, the traceback over the tape K5/K6 write
// (viterbi_traceback_kernel, at the end of this file).  It replaces no
// TPU kernel: the JAX package traces back in jnp (viterbi_pallas_fused.py
// :620 chainback_planes), which the port ran as ~25 eager torch ops a
// step, 1024 steps a frame.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// rotr of the w-bit value x by t (unsigned shifts: the bits shifted out
// above w are masked away)
__device__ __forceinline__ unsigned rotr_w(unsigned x, int t, int w) {
  t %= w;
  const unsigned mask = (1u << w) - 1u;
  return t == 0 ? x : (((x >> t) | (x << (w - t))) & mask);
}

// ---- K5: the row-pairing steps of a cycle, in radix stages -------------
// One block per (frame, column tile): the 2^ROWB rows of the 256 columns
// g*4096 + j*128 + l0 + li (j < 32, li < VA_LT = 8), whose decisions fill
// whole words: word g*128 + l0 + li of each row, bit j.  The tile sits in
// shared memory as int16 pairs (li, li+1) -- word q = li/2 of the 16-byte
// chunk (r, j), rotated within the chunk by j/8 so that a warp whose lanes
// are the 32 values of j reads 32 banks.  The steps run in radix stages of
// up to three: a thread takes an item (lane j, word q, a set of 2^S rows
// that differ only in the stage's row bits), holds its 2 x 2^S values in
// registers as int32 and does the stage's S steps on them, so the tile
// crosses shared memory once per stage, not once per step.  The kernel is
// a template on ROWB and each stage on its first step and length, so
// every row index and shared-memory offset is a compile-time constant
// beside one base per item.
// Branch bits: parity(p & m) = parity(r & m_row) ^ parity(c & m_col).  The
// column's and the row base's parts make a 2-bit code once per item,
// step and column, the stage's row bits another once per thread and
// stage; a pair XORs the two and reads its metric from a 4-entry table
// per step in shared memory.  The two decisions of a pair are warp
// ballots (the lanes are j), kept in shared memory and stored after each
// stage as 32-byte runs (8 words li = 0..7 of a row).  The metrics move
// between device memory and the tiles of a cluster in 64-byte runs
// (below).  All index arithmetic is shifts and masks.  Intermediate
// metrics are stored as int16 between stages: exact while they stay in
// the int16 range, which the per-cycle renormalization keeps (the
// contract's int16 storage).
#define VA_LT 8  // columns li of a tile per (row, j): 16 bytes of int16
#define VA_CL 4  // tiles of a cluster: li 32 u .. 32 u + 31 of a word group

// threads of a K5 block (viterbi_cuda.cycle_a_plan gives the same): a
// compile-time count, so that every thread runs the same number of items
// and the warp votes need no divergence handling
__host__ __device__ constexpr int va_threads(int rowb) {
  return (16 << rowb) < 128 ? 128 : ((16 << rowb) > 512 ? 512 : (16 << rowb));
}

struct AParams {
  int colb;
  unsigned q1, q2;
  int g1flip, g2flip;
  int colbase;  // g*4096 + l0
};

template <int ROWB, int T0, int S>
__device__ __forceinline__ void a_stage(uint32_t* __restrict__ words,
                                        uint32_t* __restrict__ dbuf,
                                        const int* __restrict__ smt,
                                        const AParams& P, int32_t bs) {
  constexpr int NX = 1 << S;
  constexpr int NROWS = 1 << ROWB;
  constexpr int LOWBIT = ROWB - T0 - S;  // lowest row bit of the stage
  constexpr int ITEMS = NROWS << (7 - S);  // 32 j x 4 q x row sets
  const int w = ROWB + P.colb;
  const unsigned wmask = (1u << w) - 1u;
  const unsigned colmask = (1u << P.colb) - 1u;
  const int lane = threadIdx.x & 31;
  const unsigned cj = (unsigned)(P.colbase + (lane << 7));
  // per step u: the row and column masks, and the stage bits' code
  unsigned rm1[S], rm2[S], cm1[S], cm2[S];
  int xcode[S][NX / 2];
#pragma unroll
  for (int u = 0; u < S; ++u) {
    const int t = T0 + u;
    const unsigned m1 = t == 0 ? P.q1 : (((P.q1 >> t) | (P.q1 << (w - t))) & wmask);
    const unsigned m2 = t == 0 ? P.q2 : (((P.q2 >> t) | (P.q2 << (w - t))) & wmask);
    rm1[u] = m1 >> P.colb;
    rm2[u] = m2 >> P.colb;
    cm1[u] = m1 & colmask;
    cm2[u] = m2 & colmask;
    const int hb = S - 1 - u;  // the pair's bit among the stage's x
#pragma unroll
    for (int pi = 0; pi < NX / 2; ++pi) {
      const unsigned xlo = (unsigned)(((pi >> hb) << (hb + 1)) |
                                      (pi & ((1 << hb) - 1)))
                           << LOWBIT;
      xcode[u][pi] = (__popc(xlo & rm1[u]) & 1) | ((__popc(xlo & rm2[u]) & 1) << 1);
    }
  }
  constexpr int NT = va_threads(ROWB);
  static_assert(ITEMS % NT == 0, "whole rounds of items");
#pragma unroll 1
  for (int round = 0; round < ITEMS / NT; ++round) {
    const int it = threadIdx.x + round * NT;
    const int q = (it >> 5) & 3;
    const int rho = it >> 7;
    const int rbase = ((rho >> LOWBIT) << (LOWBIT + S)) |
                      (rho & ((1 << LOWBIT) - 1));
    uint32_t* wb = words + (rbase << 7) + ((lane << 2) | ((q + (lane >> 3)) & 3));
    uint32_t* db = dbuf + (rbase << 3) + 2 * q;
    int v[NX][2];
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      const uint32_t wv = wb[(x << LOWBIT) << 7];
      v[x][0] = (int)(int16_t)(wv & 0xFFFFu);
      v[x][1] = (int)wv >> 16;
      if (T0 == 0) {
        v[x][0] -= bs;
        v[x][1] -= bs;
      }
    }
    // every branch metric of the item's steps first: its loads in flight
    // together, off the chain of dependent compares
    int mts[S][NX / 2][2];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int rp = ((__popc((unsigned)rbase & rm1[u]) & 1) ^ P.g1flip) |
                     (((__popc((unsigned)rbase & rm2[u]) & 1) ^ P.g2flip) << 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned c = cj | (unsigned)(2 * q + h);
        // 4 t + the 2-bit code of column and row base
        const int cc = (4 * (T0 + u)) |
                       (rp ^ (__popc(c & cm1[u]) & 1) ^ ((__popc(c & cm2[u]) & 1) << 1));
#pragma unroll
        for (int pi = 0; pi < NX / 2; ++pi) mts[u][pi][h] = smt[cc ^ xcode[u][pi]];
      }
    }
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int hb = S - 1 - u;
#pragma unroll
      for (int pi = 0; pi < NX / 2; ++pi) {
        const int xlo = ((pi >> hb) << (hb + 1)) | (pi & ((1 << hb) - 1));
        const int xhi = xlo | (1 << hb);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int mt = mts[u][pi][h];
          const int mm = 510 - mt;
          const int lo = v[xlo][h], hi = v[xhi][h];
          const int a0 = lo + mt, a1 = hi + mm, a2 = lo + mm, a3 = hi + mt;
          const bool d0 = a0 > a1, d1 = a2 > a3;
          v[xlo][h] = d0 ? a1 : a0;
          v[xhi][h] = d1 ? a3 : a2;
          const unsigned w0 = __ballot_sync(0xffffffffu, d0);
          const unsigned w1 = __ballot_sync(0xffffffffu, d1);
          if (lane == 0) {
            db[((u * NROWS + (xlo << LOWBIT)) << 3) + h] = w0;
            db[((u * NROWS + (xhi << LOWBIT)) << 3) + h] = w1;
          }
        }
      }
    }
#pragma unroll
    for (int x = 0; x < NX; ++x)
      wb[(x << LOWBIT) << 7] =
          ((uint32_t)v[x][0] & 0xFFFFu) | ((uint32_t)v[x][1] << 16);
  }
}

// the stage of S = 1..3 steps that starts at step T0
template <int ROWB, int T0>
__device__ __forceinline__ void a_stage_len(int S, uint32_t* words,
                                            uint32_t* dbuf, const int* smt,
                                            const AParams& P, int32_t bs) {
  if constexpr (T0 + 3 <= ROWB) {
    if (S == 3) {
      a_stage<ROWB, T0, 3>(words, dbuf, smt, P, bs);
      return;
    }
  }
  if constexpr (T0 + 2 <= ROWB) {
    if (S == 2) {
      a_stage<ROWB, T0, 2>(words, dbuf, smt, P, bs);
      return;
    }
  }
  a_stage<ROWB, T0, 1>(words, dbuf, smt, P, bs);
}

// the 4 words of a 16-byte chunk as stored (word q at position q + rot,
// mod 4) back in order
__device__ __forceinline__ uint4 unrotate(uint4 s, int rot) {
  const uint4 t = (rot & 2) ? make_uint4(s.z, s.w, s.x, s.y) : s;
  return (rot & 1) ? make_uint4(t.y, t.z, t.w, t.x) : t;
}

// the decision words of steps t0 .. t0+S-1, 16 bytes a thread: (u, r, half)
template <int ROWB>
__device__ __forceinline__ void a_store_decisions(const uint32_t* dbuf,
                                                  int32_t* db, int t0, int S,
                                                  long long dec_tstride,
                                                  int colb, int wofs) {
  const int runs = (S << ROWB) << 1;
  for (int e = threadIdx.x; e < runs; e += blockDim.x) {
    const int hf = e & 1, r = (e >> 1) & ((1 << ROWB) - 1), u = e >> (ROWB + 1);
    *(uint4*)(db + (t0 + u) * dec_tstride + ((size_t)r << (colb - 5)) + wofs +
              (hf << 2)) = *(const uint4*)(dbuf + (e << 2));
  }
}

// K5: steps 0..nsteps-1 (row pairing) on one column tile of one frame.
// The metrics cross device memory in 64-byte runs: the VA_CL = 4 tiles of
// a cluster hold li 0..31 of a run of every (row, j); each CTA loads and
// stores a quarter of the runs and moves their 16-byte pieces to and from
// the owning tiles' shared memory (distributed shared memory).
template <int ROWB>
__global__ void __cluster_dims__(VA_CL, 1, 1)
    __launch_bounds__(va_threads(ROWB)) viterbi_a_kernel(
    int16_t* __restrict__ metrics, const int32_t* __restrict__ syms,
    const int32_t* __restrict__ base, int32_t* __restrict__ dec,
    long long dec_bstride, long long dec_tstride, int colb, int nsteps,
    unsigned q1, unsigned q2, int g1flip, int g2flip) {
  constexpr int NROWS = 1 << ROWB;
  extern __shared__ __align__(16) uint32_t sa[];
  uint32_t* words = sa;                         // [nrows][32 j][4 q]
  uint32_t* dbuf = sa + (NROWS << 7);           // [3 steps][nrows][8 li]
  int* smt = (int*)(dbuf + 3 * (NROWS << 3));   // [step][b0 + 2 b1] metric
  const int b = blockIdx.y;
  const int g = blockIdx.x >> 4;          // 4096-column word group
  const int l0 = (blockIdx.x & 15) << 3;  // first li of the tile
  const AParams P = {colb, q1, q2, g1flip, g2flip, (g << 12) + l0};
  int16_t* mb = metrics + ((size_t)b << (ROWB + colb));
  constexpr int NT = va_threads(ROWB);
  constexpr int NPIECES = NROWS << 5;  // 16-byte pieces a CTA moves
  cg::cluster_group cl = cg::this_cluster();
  const int me = (int)cl.block_rank();      // == blockIdx.x % VA_CL
  const int ccol = P.colbase - (me << 3);   // the cluster's first column
  // piece e: run (r, j) number (e / VA_CL) * VA_CL + me, its 16 bytes
  // k = e % VA_CL, which belong to the tile of rank k
  auto piece = [&](int e, int& r, int& j, int& k) {
    k = e & (VA_CL - 1);
    const int run = (e & ~(VA_CL - 1)) | me;
    r = run >> 5;
    j = run & 31;
  };
  cl.sync();  // every CTA of the cluster running before remote stores
  for (int e0 = threadIdx.x; e0 < NPIECES; e0 += 4 * NT) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * NT;
      if (e < NPIECES) {
        int r, j, kk;
        piece(e, r, j, kk);
        v[u] = *(const uint4*)(mb + ((size_t)r << colb) + ccol + (j << 7) +
                               (kk << 3));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * NT;
      if (e < NPIECES) {
        int r, j, kk;
        piece(e, r, j, kk);
        // word q of the chunk goes to position q + j/8 (mod 4)
        *(uint4*)(cl.map_shared_rank(words, kk) + (r << 7) + (j << 2)) =
            unrotate(v[u], (4 - (j >> 3)) & 3);
      }
    }
  }
  const int32_t* sb = syms + (size_t)b * 2 * nsteps;
  if (threadIdx.x < 4 * nsteps) {
    const int t = threadIdx.x >> 2, code = threadIdx.x & 3;
    const int s0 = sb[2 * t], s1 = sb[2 * t + 1];
    smt[threadIdx.x] = ((code & 1) ? 255 - s0 : s0) + ((code & 2) ? 255 - s1 : s1);
  }
  cl.sync();  // every tile of the cluster loaded

  const int32_t bs = base[b];
  int32_t* db = dec + b * dec_bstride;
  const int wofs = (g << 7) + l0;  // the tile's first word in a row
  const int s0len = min(3, nsteps);
  a_stage_len<ROWB, 0>(s0len, words, dbuf, smt, P, bs);
  __syncthreads();
  a_store_decisions<ROWB>(dbuf, db, 0, s0len, dec_tstride, colb, wofs);
  if constexpr (ROWB > 3) {
    if (nsteps > 3) {
      __syncthreads();
      const int len = min(3, nsteps - 3);
      a_stage_len<ROWB, 3>(len, words, dbuf, smt, P, 0);
      __syncthreads();
      a_store_decisions<ROWB>(dbuf, db, 3, len, dec_tstride, colb, wofs);
    }
  }
  if constexpr (ROWB > 6) {
    if (nsteps > 6) {
      __syncthreads();
      const int len = nsteps - 6;
      a_stage_len<ROWB, 6>(len, words, dbuf, smt, P, 0);
      __syncthreads();
      a_store_decisions<ROWB>(dbuf, db, 6, len, dec_tstride, colb, wofs);
    }
  }

  cl.sync();  // every tile of the cluster final
  for (int e = threadIdx.x; e < NPIECES; e += NT) {
    int r, j, kk;
    piece(e, r, j, kk);
    const uint4 v = *(const uint4*)(cl.map_shared_rank(words, kk) +
                                    (r << 7) + (j << 2));
    *(uint4*)(mb + ((size_t)r << colb) + ccol + (j << 7) + (kk << 3)) =
        unrotate(v, j >> 3);
  }
  cl.sync();  // no tile leaves while another CTA reads it
}

// ---- K6: the column-pairing steps of a cycle, in register stages -------
// One block per (frame, row), VB_THREADS threads, two blocks an SM.  The
// row (2^COLB int16) lies in shared memory as words of the column pairs
// (c, c+1), at word (c >> 1) ^ j with j = (c >> 7) & 31: the 32 values of
// j of one column offset fall in 32 banks.  The steps s = COLB-1, COLB-2,
// ... (pair offset 2^s) run in up to three register stages
// (viterbi_cuda.cycle_b_plan): A holds the g bits s = COLB-1 .. 12 in
// registers, then pairs the j bits s = 11 .. 7 across lanes; B holds the
// li bits 6, 5, 4; C the li bits 3, 2, 1, 0.  A warp takes an item: lane j
// holds the words (values 2k, 2k+1) at the columns fixed(item) | j << 7 |
// reg(v) for every v (column bit 0 and the stage's register bits) and
// runs the stage's steps on them, so the row crosses shared memory once a
// stage, not once a step.  In a lane step the partner word comes by
// __shfl_xor_sync and each lane decides its own positions (lo' from a0,
// a1 at a low lane, hi' from a2, a3 at a high one), so every (step, item,
// v) decision is one lane ballot: one whole decision word, bit j of word
// g*128 + li.  No atomics.  The words of a stage wait in shared memory and
// go out as 16-byte vectors after it.
// The arithmetic runs on both halves of a word at once: Hopper's
// VIADD.16x2 for the sums and its DPX min (__vibmin_s16x2, VIMNMX.S16x2),
// which also reports a <= b per half -- the decision is its negation,
// so a tie keeps the first operand (a0 at lo, a2 at hi).  int16 sums are
// exact while they stay below 2^15: a cycle starts from metrics within
// the (K-1)*510 spread above the subtracted minimum and adds at most
// 510 a step, under 24,000 at K = 24.
// Branch metrics: the block builds, per step, word k and 2-bit column
// code cb of an item's base, the packed (mt, mm) of values 2k, 2k+1 with
// the row's part of the parities, the flips and the values' offsets
// folded in; a word reads them with one 8-byte load at a compile-time
// offset.
#define VB_THREADS 512
#define VB_WARPS (VB_THREADS / 32)

// stage ST (0 = A, 1 = B, 2 = C) at G = COLB - 12 g bits
template <int G, int ST>
struct BStage {
  // column bit of value bit 1 (value bit 0 is column bit 0)
  static constexpr int RB0 = ST == 0 ? 12 : (ST == 1 ? 4 : 1);
  static constexpr int NV = 2 << (ST == 0 ? G : 3);  // values a lane holds
  static constexpr int JJ0 = ST == 0 ? 0 : (ST == 1 ? G + 5 : G + 8);
  static constexpr int SMAX = ST == 0 ? G + 5 : (ST == 1 ? 3 : 4);
  static constexpr int ITEMS = ST == 0 ? 64 : (8 << G);
  // pair bit of the stage's step u
  __host__ __device__ static constexpr int pairbit(int u) {
    return 11 + G - JJ0 - u;
  }
  // column offset of value v, and its decision word's offset in a plane
  __host__ __device__ static constexpr int xoff(int v) {
    return (v & 1) | ((v >> 1) << RB0);
  }
  __host__ __device__ static constexpr int woff(int v) {
    return ((xoff(v) >> 12) << 7) | (xoff(v) & 127);
  }
  // the value bit a register step on column bit s pairs
  __host__ __device__ static constexpr int vbit(int s) {
    return s == 0 ? 0 : s - RB0 + 1;
  }
  // column of value 0 of item `it` at lane j (its fixed bits: A li 1..6;
  // B li 1..3, then g; C li 4..6, then g)
  __device__ static int col0(int it, int j) {
    if (ST == 0) return (j << 7) | (it << 1);
    if (ST == 1) return ((it >> 3) << 12) | (j << 7) | ((it & 7) << 1);
    return ((it >> 3) << 12) | (j << 7) | ((it & 7) << 4);
  }
};

// Two pairs at once, packed: a0 = lo + mt, a1 = hi + mm, a2 = lo + mm,
// a3 = hi + mt per halfword (int16 with wrap-around, exact while the sums
// stay in range), lo' = min(a0, a1), hi' = min(a2, a3) by the Hopper DPX
// min that also reports a <= b per half: the decision is its negation
// (a0 > a1: a tie keeps a0), one lane ballot per half.
__device__ __forceinline__ void b_pairs(uint32_t& lo, uint32_t& hi, int2 t,
                                        unsigned (&wl)[2], unsigned (&wh)[2]) {
  const uint32_t a0 = __vadd2(lo, (uint32_t)t.x), a1 = __vadd2(hi, (uint32_t)t.y);
  const uint32_t a2 = __vadd2(lo, (uint32_t)t.y), a3 = __vadd2(hi, (uint32_t)t.x);
  bool p0h, p0l, p1h, p1l;
  lo = __vibmin_s16x2(a0, a1, &p0h, &p0l);
  hi = __vibmin_s16x2(a2, a3, &p1h, &p1l);
  wl[0] = __ballot_sync(0xffffffffu, !p0l);
  wl[1] = __ballot_sync(0xffffffffu, !p0h);
  wh[0] = __ballot_sync(0xffffffffu, !p1l);
  wh[1] = __ballot_sync(0xffffffffu, !p1h);
}

// ns steps of stage ST on the whole row: decisions of step u to dbuf[u];
// with `last`, each thread's per-half minimum of the final words into mn2
template <int G, int ST>
__device__ __forceinline__ void b_stage(uint32_t* __restrict__ row,
                                        uint32_t* __restrict__ dbuf,
                                        const int2* __restrict__ tab,
                                        const int2* __restrict__ smask,
                                        int ns, bool last, uint32_t& mn2) {
  using S = BStage<G, ST>;
  constexpr int NP = S::NV / 2;     // words (values 2k, 2k+1) a lane holds
  constexpr int NW = 1 << (7 + G);  // decision words of a row per step
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int it = threadIdx.x >> 5; it < S::ITEMS; it += VB_WARPS) {
    const int c0 = S::col0(it, lane);
    const int wx = (c0 >> 1) ^ lane;
    // the swizzled word of values (2k, 2k+1); stage A's offsets lie above
    // the swizzled bits, B's and C's among them
    int addr[NP];
    uint32_t W[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      addr[k] = ST == 0 ? wx + (S::xoff(2 * k) >> 1) : wx ^ (S::xoff(2 * k) >> 1);
      W[k] = row[addr[k]];
    }
    const int db0 = ((c0 >> 12) << 7) | (c0 & 127);  // value 0's word
#pragma unroll
    for (int u = 0; u < S::SMAX; ++u) {
      if (u < ns) {
        const int s = S::pairbit(u);
        const int2 mk = smask[S::JJ0 + u];
        const bool lanestep = s >= 7 && s <= 11;
        const int cs = lanestep ? (c0 & ~(1 << s)) : c0;
        const int cb = (__popc(cs & mk.x) & 1) | ((__popc(cs & mk.y) & 1) << 1);
        const int2* tb = tab + ((S::JJ0 + u) << 5) + cb;  // word k at tb[4k]
        uint32_t* du = dbuf + u * NW + db0;
        if (lanestep) {
          // lane j pairs with lane j ^ 2^l and decides its own position:
          // k = own + mt, sw = partner + mm, the new value min(k, sw); the
          // decision k > sw at a low lane (min(k, sw) reports k <= sw) and
          // sw > k at a high one (min(sw, k) reports sw <= k)
          const int l = s - 7;
          const bool high = (lane >> l) & 1;
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            const int2 t = tb[k << 2];
            const uint32_t p = __shfl_xor_sync(0xffffffffu, W[k], 1 << l);
            const uint32_t kk = __vadd2(W[k], (uint32_t)t.x);
            const uint32_t sw = __vadd2(p, (uint32_t)t.y);
            bool ph, pl;
            W[k] = __vibmin_s16x2(high ? sw : kk, high ? kk : sw, &ph, &pl);
            const unsigned w0 = __ballot_sync(0xffffffffu, !pl);
            const unsigned w1 = __ballot_sync(0xffffffffu, !ph);
            if (lane == 0) *(uint2*)(du + S::woff(2 * k)) = make_uint2(w0, w1);
          }
        } else if (S::vbit(s) == 0) {
          // column bit 0 pairs the halves of a word: with the table's
          // (mt | mm << 16, mm | mt << 16), min((lo, lo) + (mt, mm),
          // (hi, hi) + (mm, mt)) is (lo', hi') and reports a0 <= a1 in the
          // low half, a2 <= a3 in the high one
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            const int2 t = tb[k << 2];
            const uint32_t lo2 = __byte_perm(W[k], 0, 0x1010);
            const uint32_t hi2 = __byte_perm(W[k], 0, 0x3232);
            bool ph, pl;
            W[k] = __vibmin_s16x2(__vadd2(lo2, (uint32_t)t.x),
                                  __vadd2(hi2, (uint32_t)t.y), &ph, &pl);
            const unsigned w0 = __ballot_sync(0xffffffffu, !pl);
            const unsigned w1 = __ballot_sync(0xffffffffu, !ph);
            if (lane == 0) *(uint2*)(du + S::woff(2 * k)) = make_uint2(w0, w1);
          }
        } else {
          const int hw = S::vbit(s) - 1;  // the word bit the step pairs
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            if (k & (1 << hw)) continue;
            const int k2 = k | (1 << hw);
            unsigned wl[2], wh[2];
            b_pairs(W[k], W[k2], tb[k << 2], wl, wh);
            if (lane == 0) {
              *(uint2*)(du + S::woff(2 * k)) = make_uint2(wl[0], wl[1]);
              *(uint2*)(du + S::woff(2 * k2)) = make_uint2(wh[0], wh[1]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      row[addr[k]] = W[k];
      if (last) mn2 = __vmins2(mn2, W[k]);
    }
  }
}

// the decision words of steps jj0 .. jj0+ns-1 of the row, 16 bytes a thread
template <int NW>
__device__ __forceinline__ void b_flush(const uint32_t* __restrict__ dbuf,
                                        int32_t* __restrict__ db, int jj0,
                                        int ns, long long tstride) {
  for (int e = threadIdx.x; e < ns * (NW / 4); e += VB_THREADS) {
    const int u = e / (NW / 4), q = e % (NW / 4);
    *(uint4*)(db + (jj0 + u) * tstride + 4 * q) =
        *(const uint4*)(dbuf + u * NW + 4 * q);
  }
}

// the 4 words of a 16-byte vector with word k at position k ^ r
__device__ __forceinline__ uint4 xswap(uint4 s, int r) {
  const uint4 t = (r & 2) ? make_uint4(s.z, s.w, s.x, s.y) : s;
  return (r & 1) ? make_uint4(t.y, t.x, t.w, t.z) : t;
}

// K6: steps rowb..rowb+nsteps-1 (column pairing) on one row of one frame,
// COLB = 12 + G.  Shared memory (cycle_b_plan): the row, the decision
// words of dsteps steps, the packed (mt, mm) table [nsteps][8 k][4 cb],
// the column masks of each step.
template <int G>
__global__ void __launch_bounds__(VB_THREADS, 2) viterbi_b_kernel(
    int16_t* __restrict__ metrics, const int32_t* __restrict__ syms,
    int32_t* __restrict__ dec, long long dec_bstride, long long dec_tstride,
    int32_t* __restrict__ mins, int rowb, int nsteps, int dsteps, unsigned q1,
    unsigned q2, int g1flip, int g2flip) {
  constexpr int COLB = 12 + G;
  constexpr int NCOLS = 1 << COLB;
  constexpr int NW = NCOLS >> 5;
  constexpr int NVEC = NCOLS / 8;  // 16-byte vectors of a row
  extern __shared__ __align__(16) uint32_t sbm[];
  uint32_t* row = sbm;                           // [NCOLS / 2], swizzled
  uint32_t* dbuf = row + NCOLS / 2;              // [dsteps][NW]
  int2* tab = (int2*)(dbuf + dsteps * NW);       // [nsteps][8][4]
  int2* smask = tab + nsteps * 32;               // [nsteps]
  __shared__ int wmin[VB_WARPS];
  const int b = blockIdx.y, R = blockIdx.x;
  const int w = rowb + COLB;
  uint4* grow = (uint4*)(metrics + ((((size_t)b << rowb) + R) << COLB));
  uint4* srow = (uint4*)row;

  // the row in: word k of vector e goes to chunk e ^ (j >> 2), position
  // k ^ (j & 3) -- the word cycle_b_word gives it, in one 16-byte store
  {
    uint4 x[NVEC / VB_THREADS];
#pragma unroll
    for (int u = 0; u < NVEC / VB_THREADS; ++u) x[u] = grow[threadIdx.x + u * VB_THREADS];
#pragma unroll
    for (int u = 0; u < NVEC / VB_THREADS; ++u) {
      const int e = threadIdx.x + u * VB_THREADS, j = (e >> 4) & 31;
      srow[e ^ (j >> 2)] = xswap(x[u], j & 3);
    }
  }
  // the block's table: entry (jj, k, cb), the packed (mt, mm) of values
  // 2k and 2k+1 (at column bit 0's step, mt and mm of value 2k in both
  // orders)
  const int32_t* sy = syms + (size_t)b * 2 * nsteps;
  for (int e = threadIdx.x; e < nsteps * 32; e += VB_THREADS) {
    const int jj = e >> 5, k = (e >> 2) & 7, cb = e & 3;
    const unsigned m1 = rotr_w(q1, rowb + jj, w), m2 = rotr_w(q2, rowb + jj, w);
    const int rb0 = jj < BStage<G, 1>::JJ0   ? BStage<G, 0>::RB0
                    : jj < BStage<G, 2>::JJ0 ? BStage<G, 1>::RB0
                                             : BStage<G, 2>::RB0;
    const int s0 = sy[2 * jj], s1 = sy[2 * jj + 1];
    int mt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned p = ((unsigned)R << COLB) |
                         (((unsigned)h | ((unsigned)k << rb0)) & (NCOLS - 1));
      const int code = cb ^ ((__popc(p & m1) & 1) ^ g1flip) ^
                       (((__popc(p & m2) & 1) ^ g2flip) << 1);
      mt[h] = ((code & 1) ? 255 - s0 : s0) + ((code & 2) ? 255 - s1 : s1);
    }
    if (jj == COLB - 1)  // pair bit 0
      tab[e] = make_int2(mt[0] | ((510 - mt[0]) << 16), (510 - mt[0]) | (mt[0] << 16));
    else
      tab[e] = make_int2(mt[0] | (mt[1] << 16), (510 - mt[0]) | ((510 - mt[1]) << 16));
  }
  if (threadIdx.x < nsteps) {
    const int jj = threadIdx.x;
    smask[jj] = make_int2((int)(rotr_w(q1, rowb + jj, w) & (NCOLS - 1)),
                          (int)(rotr_w(q2, rowb + jj, w) & (NCOLS - 1)));
  }
  __syncthreads();

  uint32_t mn2 = 0x7FFF7FFFu;
  int32_t* db = dec + b * dec_bstride + (size_t)R * NW;
  constexpr int JB = BStage<G, 1>::JJ0, JC = BStage<G, 2>::JJ0;
  const int na = min(nsteps, JB);
  b_stage<G, 0>(row, dbuf, tab, smask, na, nsteps == na, mn2);
  __syncthreads();
  b_flush<NW>(dbuf, db, 0, na, dec_tstride);
  if (nsteps > JB) {
    const int nb = min(nsteps, JC) - JB;
    __syncthreads();
    b_stage<G, 1>(row, dbuf, tab, smask, nb, nsteps == JB + nb, mn2);
    __syncthreads();
    b_flush<NW>(dbuf, db, JB, nb, dec_tstride);
    if (nsteps > JC) {
      __syncthreads();
      b_stage<G, 2>(row, dbuf, tab, smask, nsteps - JC, true, mn2);
      __syncthreads();
      b_flush<NW>(dbuf, db, JC, nsteps - JC, dec_tstride);
    }
  }

  // the row out (the inverse permutation), and its minimum
#pragma unroll
  for (int u = 0; u < NVEC / VB_THREADS; ++u) {
    const int e = threadIdx.x + u * VB_THREADS, j = (e >> 4) & 31;
    grow[e] = xswap(srow[e ^ (j >> 2)], j & 3);
  }
  int mn = min((int)(int16_t)(mn2 & 0xFFFFu), (int)mn2 >> 16);
  for (int off = 16; off > 0; off >>= 1)
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = mn;
  __syncthreads();
  if (threadIdx.x < 32) {
    mn = threadIdx.x < VB_WARPS ? wmin[threadIdx.x] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1)
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    if (threadIdx.x == 0) mins[((size_t)b << rowb) + R] = mn;
  }
}

// metrics (B, 2^W) int16, updated in place, 16-byte aligned; syms (B,
// 2*nsteps) int32; base (B,) int32; dec: plane t of frame b starts at
// dec + b*dec_bstride + t*dec_tstride, 2^W/32 int32 words (16-byte
// aligned, strides multiples of 4 words).  Grid, threads and shared
// memory come from the wrapper's plan (viterbi_cuda.cycle_a_plan); the
// shared-memory limit is raised once per device.
template <int ROWB>
static cudaError_t viterbi_a_go(int16_t* metrics, const int32_t* syms,
                                const int32_t* base, int32_t* dec,
                                long long dec_bstride, long long dec_tstride,
                                int B, int colb, int nsteps, int q1, int q2,
                                int g1flip, int g2flip, int tiles, int threads,
                                int smem, cudaStream_t stream) {
  if (threads != va_threads(ROWB)) return cudaErrorInvalidValue;
  static unsigned configured = 0u;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(viterbi_a_kernel<ROWB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);
    if (err != cudaSuccess) return err;
    if (dev < 32) configured |= 1u << dev;
  }
  dim3 grid(tiles, B);
  viterbi_a_kernel<ROWB><<<grid, threads, smem, stream>>>(
      metrics, syms, base, dec, dec_bstride, dec_tstride, colb, nsteps,
      (unsigned)q1, (unsigned)q2, g1flip, g2flip);
  return cudaGetLastError();
}

extern "C" int viterbi_a_launch(int16_t* metrics, const int32_t* syms,
                                const int32_t* base, int32_t* dec,
                                long long dec_bstride, long long dec_tstride,
                                int B, int rowb, int colb, int nsteps,
                                int q1, int q2, int g1flip, int g2flip,
                                int tiles, int threads, int smem,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define VA_GO(R)                                                             \
  case R:                                                                    \
    return (int)viterbi_a_go<R>(metrics, syms, base, dec, dec_bstride,       \
                                dec_tstride, B, colb, nsteps, q1, q2, g1flip, \
                                g2flip, tiles, threads, smem, s);
  switch (rowb) {
    VA_GO(1) VA_GO(2) VA_GO(3) VA_GO(4) VA_GO(5) VA_GO(6) VA_GO(7) VA_GO(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VA_GO
}

// mins (B, 2^ROWB) int32: each row's minimum after the last step.  The
// shared memory comes from the wrapper's plan (viterbi_cuda.cycle_b_plan)
// and is checked here against the layout the kernel uses.
template <int G>
static cudaError_t viterbi_b_go(int16_t* metrics, const int32_t* syms,
                                int32_t* dec, long long dec_bstride,
                                long long dec_tstride, int32_t* mins, int B,
                                int rowb, int nsteps, int q1, int q2,
                                int g1flip, int g2flip, int smem,
                                cudaStream_t stream) {
  constexpr int NCOLS = 1 << (12 + G);
  // decision words of stage A's steps, the longest stage
  const int dsteps = min(nsteps, BStage<G, 0>::SMAX);
  if (smem != 2 * NCOLS + dsteps * (NCOLS / 32) * 4 + nsteps * (32 * 8 + 8))
    return cudaErrorInvalidValue;
  // per device, the dynamic shared memory the kernel was allowed so far
  // (the block's limit less its static minima could not be asked for)
  static int allowed[32] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(viterbi_b_kernel<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    // all of the SM's unified L1 as shared memory: two blocks of ~104 KB
    err = cudaFuncSetAttribute(viterbi_b_kernel<G>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < 32) allowed[dev] = smem;
  }
  dim3 grid(1 << rowb, B);
  viterbi_b_kernel<G><<<grid, VB_THREADS, smem, stream>>>(
      metrics, syms, dec, dec_bstride, dec_tstride, mins, rowb, nsteps, dsteps,
      (unsigned)q1, (unsigned)q2, g1flip, g2flip);
  return cudaGetLastError();
}

extern "C" int viterbi_b_launch(int16_t* metrics, const int32_t* syms,
                                int32_t* dec, long long dec_bstride,
                                long long dec_tstride, int32_t* mins, int B,
                                int rowb, int colb, int nsteps, int q1, int q2,
                                int g1flip, int g2flip, int smem,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define VB_GO(C)                                                             \
  case C:                                                                    \
    return (int)viterbi_b_go<C - 12>(metrics, syms, dec, dec_bstride,        \
                                     dec_tstride, mins, B, rowb, nsteps, q1, \
                                     q2, g1flip, g2flip, smem, s);
  switch (colb) {
    VB_GO(12) VB_GO(13) VB_GO(14) VB_GO(15)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VB_GO
}

// ---- the traceback over the fused decoder's tape -----------------------
// dec (B, nbits, 2^W/32) int32, contiguous, plane t in layout P_{t+1} (the
// contract of ops/viterbi_inplace.py); out (B, nbits) uint8.  From the end
// state s of step t the walk is out[t] = s & 1, then the decision bit of s
// at plane t, position rotr^((t+1) mod W)(s), enters at the top:
// s <- (bit << (W-1)) | (s >> 1).  Each step's read depends on the last, so
// what bounds a frame is the chain of dependent loads (a 1 GiB tape at
// K = 24: every load misses the caches), not bytes or operations.  One
// warp per frame looks TB_LOOK steps ahead: from s at step t, the state at
// step t-d is (s >> d) | (c << (W-d)) for the 2^d values c of the d bits
// still unknown, so lanes 2^d - 1 + c (d < TB_LOOK, 31 lanes) load the
// decision word of every candidate of the next TB_LOOK steps at once, a
// ballot gathers the 31 bits, and every lane picks the true path through
// them: one round trip of memory a TB_LOOK steps, not one a step.  The
// output bits of those steps are bits 0..TB_LOOK-1 of s already (W > 5).
#define TB_LOOK 5
#define TB_THREADS 128

__global__ void __launch_bounds__(TB_THREADS) viterbi_traceback_kernel(
    const uint32_t* __restrict__ dec, const long long* __restrict__ ends,
    unsigned end, uint8_t* __restrict__ out, int B, int w, int nbits) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (TB_THREADS / 32) + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp: the ballots below stay full
  const unsigned smask = (1u << w) - 1u;
  unsigned s = (ends ? (unsigned)ends[b] : end) & smask;
  const long long plane = 1ll << (w - 5);  // words a plane
  const uint32_t* frame = dec + (long long)b * nbits * plane;
  uint8_t* o = out + (long long)b * nbits;
  // this lane's candidate: depth d (lanes 2^d - 1 .. 2^(d+1) - 2), bits c
  const int d = 31 - __clz(lane + 1);
  const unsigned c = (unsigned)(lane + 1 - (1 << d));
  for (int t = nbits - 1; t >= 0; t -= TB_LOOK) {
    const int td = t - d;
    unsigned bit = 0u;
    if (d < TB_LOOK && td >= 0) {
      const unsigned p = rotr_w((s >> d) | (c << (w - d)), (td + 1) % w, w);
      const unsigned row = p >> 7;
      bit = (__ldg(frame + td * plane + (row >> 5) * 128 + (p & 127)) >>
             (row & 31)) & 1u;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, bit);
    if (lane < TB_LOOK && t - lane >= 0) o[t - lane] = (uint8_t)((s >> lane) & 1u);
    unsigned cc = 0u;
#pragma unroll
    for (int k = 0; k < TB_LOOK; ++k)
      cc |= ((bits >> ((1u << k) - 1u + cc)) & 1u) << k;
    s = (s >> TB_LOOK) | (cc << (w - TB_LOOK));
  }
}

// ends: (B,) int64 end states on the device, or null for the one end
// state ``end`` of every frame.  B >= 1, nbits >= 1, 13 <= w <= 23.
extern "C" int viterbi_traceback_launch(const int32_t* dec,
                                        const long long* ends, int end,
                                        uint8_t* out, int B, int w, int nbits,
                                        void* stream) {
  if (B < 1 || nbits < 1 || w < 13 || w > 23) return (int)cudaErrorInvalidValue;
  const int per = TB_THREADS / 32;
  viterbi_traceback_kernel<<<(B + per - 1) / per, TB_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)dec, ends, (unsigned)end, out, B, w, nbits);
  return (int)cudaGetLastError();
}
