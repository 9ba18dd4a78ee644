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
// in int32, stored back as int16 (the per-cycle renormalization keeps
// the values in range).  The branch bits are flip ^ parity(p & mask) of
// the position p, one __popc each; the TPU kernel B read them from
// precomputed planes because its vector unit had no popcount.
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
//   K6: one block per (frame, row): the whole row (2^COLB int32, 128 KB
//     of dynamic shared memory) plus its decision bitmap (4 KB), one
//     thread per pair; decisions land in the bitmap by shared atomicOr
//     and go to device memory as whole words after each step.  Each
//     block also writes its row's minimum for the next cycle's base.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define VB_THREADS 1024

// rotr of the w-bit value x by t (unsigned shifts: the bits shifted out
// above w are masked away)
__device__ __forceinline__ unsigned rotr_w(unsigned x, int t, int w) {
  t %= w;
  const unsigned mask = (1u << w) - 1u;
  return t == 0 ? x : (((x >> t) | (x << (w - t))) & mask);
}

__device__ __forceinline__ int branch_metric(unsigned p, unsigned m1,
                                             unsigned m2, int g1flip,
                                             int g2flip, int s0, int s1) {
  const int b0 = (__popc(p & m1) & 1) ^ g1flip;
  const int b1 = (__popc(p & m2) & 1) ^ g2flip;
  return (b0 ? 255 - s0 : s0) + (b1 ? 255 - s1 : s1);
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

// K6: steps rowb..rowb+nsteps-1 (column pairing) on one row of one frame.
__global__ void __launch_bounds__(VB_THREADS) viterbi_b_kernel(int16_t* __restrict__ metrics,
                                 const int32_t* __restrict__ syms,
                                 int32_t* __restrict__ dec,
                                 long long dec_bstride, long long dec_tstride,
                                 int32_t* __restrict__ mins, int rowb,
                                 int colb, int nsteps, unsigned q1,
                                 unsigned q2, int g1flip, int g2flip) {
  extern __shared__ int32_t sm[];  // [ncols] row values, then [nw] bitmap
  __shared__ int32_t wmin[VB_THREADS / 32];
  const int b = blockIdx.y, R = blockIdx.x;
  const int w = rowb + colb;
  const int ncols = 1 << colb;
  const int nw = ncols >> 5;
  unsigned* bm = (unsigned*)(sm + ncols);
  int16_t* mr = metrics + (((size_t)b << rowb) + R) * ncols;

  for (int i = threadIdx.x; i < ncols; i += blockDim.x) sm[i] = mr[i];
  for (int i = threadIdx.x; i < nw; i += blockDim.x) bm[i] = 0u;
  __syncthreads();

  const int32_t* sb = syms + (size_t)b * 2 * nsteps;
  const unsigned rowp = (unsigned)R << colb;
  for (int j = 0; j < nsteps; ++j) {
    const int t = rowb + j;
    const int s = w - 1 - t;  // pair offset 2^s < ncols
    const int o = 1 << s;
    const unsigned m1 = rotr_w(q1, t, w), m2 = rotr_w(q2, t, w);
    const int s0 = sb[2 * j], s1 = sb[2 * j + 1];
    for (int pi = threadIdx.x; pi < (ncols >> 1); pi += blockDim.x) {
      const int clo = ((pi >> s) << (s + 1)) | (pi & (o - 1));
      const int chi = clo | o;
      const int mt = branch_metric(rowp | clo, m1, m2, g1flip, g2flip, s0, s1);
      const int mm = 510 - mt;
      const int lo = sm[clo], hi = sm[chi];
      const int a0 = lo + mt, a1 = hi + mm, a2 = lo + mm, a3 = hi + mt;
      const bool d0 = a0 > a1, d1 = a2 > a3;
      sm[clo] = d0 ? a1 : a0;
      sm[chi] = d1 ? a3 : a2;
      if (d0) atomicOr(&bm[(clo >> 12) * 128 + (clo & 127)], 1u << ((clo >> 7) & 31));
      if (d1) atomicOr(&bm[(chi >> 12) * 128 + (chi & 127)], 1u << ((chi >> 7) & 31));
    }
    __syncthreads();
    int32_t* db = dec + b * dec_bstride + j * dec_tstride + (size_t)R * nw;
    for (int i = threadIdx.x; i < nw; i += blockDim.x) {
      db[i] = (int32_t)bm[i];
      bm[i] = 0u;
    }
    __syncthreads();
  }

  int mn = INT_MAX;
  for (int i = threadIdx.x; i < ncols; i += blockDim.x) {
    const int v = sm[i];
    mr[i] = (int16_t)v;
    mn = min(mn, v);
  }
  for (int off = 16; off > 0; off >>= 1)
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = mn;
  __syncthreads();
  if (threadIdx.x < 32) {
    mn = threadIdx.x < (int)(blockDim.x >> 5) ? wmin[threadIdx.x] : INT_MAX;
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

// mins (B, 2^ROWB) int32: each row's minimum after the last step.
extern "C" int viterbi_b_launch(int16_t* metrics, const int32_t* syms,
                                int32_t* dec, long long dec_bstride,
                                long long dec_tstride, int32_t* mins, int B,
                                int rowb, int colb, int nsteps, int q1, int q2,
                                int g1flip, int g2flip, void* stream) {
  const int ncols = 1 << colb;
  const size_t smem = (size_t)(ncols + (ncols >> 5)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(1 << rowb, B);
  viterbi_b_kernel<<<grid, VB_THREADS, smem, (cudaStream_t)stream>>>(
      metrics, syms, dec, dec_bstride, dec_tstride, mins, rowb, colb, nsteps,
      (unsigned)q1, (unsigned)q2, g1flip, g2flip);
  return (int)cudaGetLastError();
}
