// Kernel K10 of the PyTorch/CUDA port: one trellis step of the classic
// Viterbi decoder (standard state order) for a batch of frames.
//
// Replaces the TPU kernel _acs_kernel (isee3_decoder_tpu/ops/
// viterbi_pallas.py:39, call :165).  Wrapper and plain version:
// ops/viterbi_acs_cuda.py; the per-step loop: ops/viterbi.update_blk.
//
// Per butterfly i < 2^(K-2) of row b, with lo = m[i], hi = m[i + 2^(K-2)]:
//   metric32 = s0 + b0*(255-2*s0) + s1 + b1*(255-2*s1) - adjust
//   mt = (T)metric32,  mm = (T)(510 - metric32 - 2*adjust)
//   m0 = lo+mt, m1 = hi+mm, m2 = lo+mm, m3 = hi+mt   (wrapping in T)
//   new[2i] = min(m0, m1), decision m0 > m1 (ties keep the 0-branch)
//   new[2i+1] = min(m2, m3), decision m2 > m3
// exactly as viterbi_pallas.py:61-73 computes it, with T the stored
// metric type (int16 or int32).  `adjust` is the previous step's global
// minimum: subtracting it while adding the branch metric renormalizes
// the metrics with no extra pass over them.  The branch bits are
// flip ^ parity((2i) & poly), one __popc each, computed here instead of
// read from tables (the TPU kernel's b0/b1 arrays, 8 MB per step at
// K = 24).  Decisions: bit s & 31 of word s >> 5 (viterbi224_sse2.c:20).
// A warp's 32 butterflies are 64 new states, i.e. two words, made from
// two ballots by interleaving their bits.
//
// Global minimum without a host read: each block reduces its survivors
// and atomicMin's them into gmin[b] (integer min: order-free, so
// deterministic).  The caller rotates three (B,) buffers: step t reads
// adjust from buffer t%3, writes its minimum into (t+1)%3 and resets
// (t+2)%3 to INT_MAX (step t-1, which read it, has finished: launches on
// one stream are ordered); the same thread adds adjust into renorm[b].
//
// What bounds it on the H100: bytes.  Per frame and step at K = 24 it
// reads and writes 2^23 metrics and writes 2^23/8 decision bytes: 34.6 MB
// in int16 (10.3 us at 3.35 TB/s), 68.2 MB in int32 (20.4 us), against
// ~16 integer operations per butterfly (~4 us at 16.7e12 int32 op/s).
// The design reads each metric once with neighbouring threads on
// neighbouring addresses, writes the two survivors of a butterfly as one
// 4- or 8-byte store and the two decision words of a warp as one 8-byte
// store; a block takes ACS_ITEMS butterflies per thread so that the
// atomics per step stay at 2^(K-2) / (ACS_THREADS * ACS_ITEMS) per row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define ACS_THREADS 256
#define ACS_ITEMS 8

// bits 0..15 of x to the even bit positions 0, 2, ..., 30
__device__ __forceinline__ unsigned spread16(unsigned x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

template <typename T> struct Pair;
template <> struct Pair<int16_t> { typedef short2 type; };
template <> struct Pair<int32_t> { typedef int2 type; };

// (T) of a 32-bit sum: two's-complement wrap, as jnp's astype and
// torch's .to (unsigned arithmetic: no signed overflow)
template <typename T>
__device__ __forceinline__ T wrap(unsigned v) {
  return (T)v;
}

template <typename T>
__global__ void __launch_bounds__(ACS_THREADS) viterbi_acs_kernel(
    const T* __restrict__ metrics, T* __restrict__ out,
    const int32_t* __restrict__ syms, const int32_t* __restrict__ adjust,
    int32_t* __restrict__ gmin, int32_t* __restrict__ reset,
    int32_t* __restrict__ renorm, uint32_t* __restrict__ dec, int hbits,
    int items, unsigned q1, unsigned q2, int g1flip, int g2flip) {
  __shared__ int wmin[ACS_THREADS / 32];
  const int b = blockIdx.y;
  const size_t half = (size_t)1 << hbits;
  const int adj = adjust[b];
  const int s0 = syms[2 * b], s1 = syms[2 * b + 1];
  const T* mb = metrics + (size_t)b * 2 * half;
  typename Pair<T>::type* ob =
      reinterpret_cast<typename Pair<T>::type*>(out + (size_t)b * 2 * half);
  uint2* db = reinterpret_cast<uint2*>(dec + (size_t)b * (half >> 4));
  const int lane = threadIdx.x & 31;
  int vmin = INT_MAX;

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (reset) reset[b] = INT_MAX;
    if (renorm) renorm[b] += adj;
  }
  const size_t base = (size_t)blockIdx.x * blockDim.x * items;
  for (int j = 0; j < items; ++j) {
    const size_t i = base + (size_t)j * blockDim.x + threadIdx.x;
    const unsigned p = 2u * (unsigned)i;
    const int b0 = (__popc(p & q1) & 1) ^ g1flip;
    const int b1 = (__popc(p & q2) & 1) ^ g2flip;
    const int metric32 = (b0 ? 255 - s0 : s0) + (b1 ? 255 - s1 : s1) - adj;
    const T mt = wrap<T>((unsigned)metric32);
    const T mm = wrap<T>(510u - (unsigned)metric32 - 2u * (unsigned)adj);
    const T lo = mb[i], hi = mb[i + half];
    const T m0 = wrap<T>((unsigned)lo + (unsigned)mt);
    const T m1 = wrap<T>((unsigned)hi + (unsigned)mm);
    const T m2 = wrap<T>((unsigned)lo + (unsigned)mm);
    const T m3 = wrap<T>((unsigned)hi + (unsigned)mt);
    const bool d0 = m0 > m1, d1 = m2 > m3;
    const T v0 = d0 ? m1 : m0, v1 = d1 ? m3 : m2;
    typename Pair<T>::type pr;
    pr.x = v0;
    pr.y = v1;
    ob[i] = pr;
    vmin = min(vmin, min((int)v0, (int)v1));
    const unsigned w0 = __ballot_sync(0xffffffffu, d0);
    const unsigned w1 = __ballot_sync(0xffffffffu, d1);
    if (lane == 0)  // states 2i .. 2i+63: words i/16 and i/16 + 1
      db[i >> 5] = make_uint2(spread16(w0) | (spread16(w1) << 1),
                              spread16(w0 >> 16) | (spread16(w1 >> 16) << 1));
  }

  vmin = __reduce_min_sync(0xffffffffu, vmin);
  if (lane == 0) wmin[threadIdx.x >> 5] = vmin;
  __syncthreads();
  if (threadIdx.x < 32) {
    vmin = threadIdx.x < (blockDim.x >> 5) ? wmin[threadIdx.x] : INT_MAX;
    vmin = __reduce_min_sync(0xffffffffu, vmin);
    if (threadIdx.x == 0) atomicMin(&gmin[b], vmin);
  }
}

// metrics, out: (B, 2^(K-1)) of elem_size 2 (int16) or 4 (int32), distinct
// buffers; syms (B, 2) int32; adjust (B,) int32; gmin (B,) int32 holding
// INT_MAX (receives the minimum of the new metrics); reset, renorm: (B,)
// int32 or null; dec: (B, 2^(K-1)/32) words of this step's tape slot.
// Requires 5 <= hbits = K-2 <= 30.
extern "C" int viterbi_acs_launch(const void* metrics, void* out,
                                  const int32_t* syms, const int32_t* adjust,
                                  int32_t* gmin, int32_t* reset,
                                  int32_t* renorm, int32_t* dec, int B,
                                  int hbits, int elem_size, int q1, int q2,
                                  int g1flip, int g2flip, void* stream) {
  const long long half = 1ll << hbits;
  const int threads = half < ACS_THREADS ? (int)half : ACS_THREADS;
  const long long per = half / threads;
  const int items = per < ACS_ITEMS ? (int)per : ACS_ITEMS;
  dim3 grid((unsigned)(half / ((long long)threads * items)), B);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_size == 2)
    viterbi_acs_kernel<int16_t><<<grid, threads, 0, s>>>(
        (const int16_t*)metrics, (int16_t*)out, syms, adjust, gmin, reset,
        renorm, (uint32_t*)dec, hbits, items, (unsigned)q1, (unsigned)q2,
        g1flip, g2flip);
  else if (elem_size == 4)
    viterbi_acs_kernel<int32_t><<<grid, threads, 0, s>>>(
        (const int32_t*)metrics, (int32_t*)out, syms, adjust, gmin, reset,
        renorm, (uint32_t*)dec, hbits, items, (unsigned)q1, (unsigned)q2,
        g1flip, g2flip);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
