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
//   K5: one block per (frame, tile of 32*LT columns): the columns
//     g*4096 + j*128 + l0 + li, j = 0..31, li < LT, all 2^ROWB rows, in
//     int32 shared memory (64 KB).  A warp's 32 lanes are the 32 values
//     of j, so __ballot_sync of the lanes' decisions IS the packed word.
//   K6: one block per (frame, row): the whole row (2^COLB int32, 128 KB
//     of dynamic shared memory) plus its decision bitmap (4 KB), one
//     thread per pair; decisions land in the bitmap by shared atomicOr
//     and go to device memory as whole words after each step.  Each
//     block also writes its row's minimum for the next cycle's base.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define VA_THREADS 256
#define VA_SMEM 65536
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

// K5: steps 0..nsteps-1 (row pairing) on one column tile of one frame.
__global__ void __launch_bounds__(VA_THREADS) viterbi_a_kernel(int16_t* __restrict__ metrics,
                                 const int32_t* __restrict__ syms,
                                 const int32_t* __restrict__ base,
                                 int32_t* __restrict__ dec,
                                 long long dec_bstride, long long dec_tstride,
                                 int rowb, int colb, int nsteps, int lt,
                                 unsigned q1, unsigned q2, int g1flip,
                                 int g2flip) {
  extern __shared__ int32_t sm[];  // [nrows][32 * lt], index r*tc + j*lt + li
  const int b = blockIdx.y;
  const int w = rowb + colb;
  const int nrows = 1 << rowb;
  const int tc = 32 * lt;
  const int lblocks = 128 / lt;
  const int g = blockIdx.x / lblocks;  // 4096-column word group
  const int l0 = (blockIdx.x % lblocks) * lt;
  const int colbase = g * 4096 + l0;
  const int words_per_row = 1 << (colb - 5);
  int16_t* mb = metrics + ((size_t)b << w);
  const int32_t bs = base[b];

  for (int i = threadIdx.x; i < nrows * tc; i += blockDim.x) {
    const int r = i / tc, ci = i % tc;
    sm[i] = (int32_t)mb[((size_t)r << colb) + colbase + (ci / lt) * 128 +
                        ci % lt] - bs;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int32_t* sb = syms + (size_t)b * 2 * nsteps;
  for (int t = 0; t < nsteps; ++t) {
    const int half = nrows >> (t + 1);
    const unsigned m1 = rotr_w(q1, t, w), m2 = rotr_w(q2, t, w);
    const int s0 = sb[2 * t], s1 = sb[2 * t + 1];
    int32_t* db = dec + b * dec_bstride + t * dec_tstride;
    const int items = (nrows >> 1) * lt;  // (pair row, li); lanes are j
    for (int it = warp; it < items; it += nwarps) {  // warp-uniform
      const int pi = it / lt, li = it % lt;
      const int rlo = (pi / half) * 2 * half + pi % half;
      const int rhi = rlo + half;
      const unsigned p = ((unsigned)rlo << colb) | (colbase + lane * 128 + li);
      const int mt = branch_metric(p, m1, m2, g1flip, g2flip, s0, s1);
      const int mm = 510 - mt;
      int32_t* plo = sm + rlo * tc + lane * lt + li;
      int32_t* phi = sm + rhi * tc + lane * lt + li;
      const int lo = *plo, hi = *phi;
      const int a0 = lo + mt, a1 = hi + mm, a2 = lo + mm, a3 = hi + mt;
      const bool d0 = a0 > a1, d1 = a2 > a3;
      *plo = d0 ? a1 : a0;
      *phi = d1 ? a3 : a2;
      const unsigned w0 = __ballot_sync(0xffffffffu, d0);
      const unsigned w1 = __ballot_sync(0xffffffffu, d1);
      if (lane == 0) {
        const int wc = g * 128 + l0 + li;
        db[(size_t)rlo * words_per_row + wc] = (int32_t)w0;
        db[(size_t)rhi * words_per_row + wc] = (int32_t)w1;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < nrows * tc; i += blockDim.x) {
    const int r = i / tc, ci = i % tc;
    mb[((size_t)r << colb) + colbase + (ci / lt) * 128 + ci % lt] =
        (int16_t)sm[i];
  }
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

// metrics (B, 2^W) int16, updated in place; syms (B, 2*nsteps) int32;
// base (B,) int32; dec: plane t of frame b starts at
// dec + b*dec_bstride + t*dec_tstride, 2^W/32 int32 words.
extern "C" int viterbi_a_launch(int16_t* metrics, const int32_t* syms,
                                const int32_t* base, int32_t* dec,
                                long long dec_bstride, long long dec_tstride,
                                int B, int rowb, int colb, int nsteps,
                                int q1, int q2, int g1flip, int g2flip,
                                void* stream) {
  const int nrows = 1 << rowb;
  int lt = VA_SMEM / (nrows * 32 * 4);
  lt = lt < 1 ? 1 : (lt > 128 ? 128 : lt);
  const size_t smem = (size_t)nrows * 32 * lt * 4;
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((1 << colb) / (32 * lt), B);
  viterbi_a_kernel<<<grid, VA_THREADS, smem, (cudaStream_t)stream>>>(
      metrics, syms, base, dec, dec_bstride, dec_tstride, rowb, colb, nsteps,
      lt, (unsigned)q1, (unsigned)q2, g1flip, g2flip);
  return (int)cudaGetLastError();
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
