// Kernels K7a and K7b of the PyTorch/CUDA port: the fused polyphase
// channelizer.  One packed-int32 wideband capture (I in the low half of
// each word, Q in the high half) -> per-channel interleaved int16 I,Q.
//
// Replace the TPU kernels kern (critically sampled bank) and kern2 (2x
// oversampled bank) of isee3_decoder_tpu/ops/channelizer_pallas.py:177
// and :213, entry channelize_raw_fused.
//
// What they compute.  With hop = M / oversample, output sample j of every
// channel comes from the P*M capture samples that start at j*hop:
//   a[r]  = sum_p x[j*hop + p*M + r] * h[p*M + r]          (P tap adds)
//   Y[k]  = sum_r a[r] * exp(-2*pi*i*r*k/M)                (M-point DFT)
//   out[k][j] = trunc(clip(Y[k], +-32767)) as an (I, Q) int16 pair;
// in the oversampled bank the odd samples' odd bins are negated (their
// frames start half a channel period late, a phase of (-1)^k).  The odd
// stream's branch r reads word (r + M/2) mod M of the frame, one frame
// later for r >= M/2: an address offset, nothing more.
//
// What bounds them on the H100: bytes.  Each capture word is read once
// and each output pair written once (8 bytes per sample and channel at
// oversample 1, 6 at oversample 2); as an FFT the arithmetic is about
// 4*P + 5*log2(M) float32 operations per sample and channel, under the
// card's 20 flop per byte.  What kept the radix-2 FFT before this design
// far off that bound was shared-memory traffic, ~55 warp-wide accesses per
// complex output; this one spends about ten, and then its instruction
// issue is what it meets first at oversample 2 (twice the outputs of a
// word), so every conversion is one instruction:
//
// - Persistent blocks walk tiles of TS output samples.  A tile's input is
//   one contiguous run of words, (TS/OS + P - 1)*M (+ M/2 at OS = 2); one
//   bulk copy (TMA, completing on an mbarrier) brings it into one of two
//   stages, the next tile's under the current tile's arithmetic.  The copy
//   starts on the 16-byte boundary at or below the tile's first word and
//   ends on the one at or above its last, so the capture needs no
//   alignment (the granules it rounds into hold no other page).
// - Tap sums: a thread owns one branch r of one stream and walks RUN
//   consecutive frames, each word read once from the stage into a ring of
//   PR float pairs in registers, the taps h[p][r] in registers for the
//   whole kernel (zero past P: an exact +0 per unused slot).  The sum runs
//   p ascending with fmaf, as before.  The frame loop is unrolled by PR,
//   so every ring slot is a register.
// - The M-point DFT as M = M1 x M2 with r = M2*r1 + r2, k = k1 + M1*k2:
//   an M1-point DFT in registers for each (j, r2), the twiddle
//   W_M^{r2 k1} (a table made in float64, rounded once), written back in
//   place; then an M2-point DFT in registers for each (j, k1).  The tap
//   sums and the exchange live in one (TS, M+1) float2 workspace; lanes
//   run along j in both DFT stages and along r in the tap stage, and the
//   odd row stride keeps all three free of bank conflicts.  The odd
//   samples' sign at oversample 2 rides in a second twiddle table whose
//   odd k1 are negated (exact: a negated product is the product negated).
// - The store: lanes along j, so each warp writes 32 consecutive (I, Q)
//   words of one channel row, a whole 128-byte line when the row pitch is
//   a multiple of 32 words (the wrapper pads it so); each word from one
//   max, two saturating conversions to int16 and one byte permute.
// All float32, no tensor cores: TF32 or bf16 products would cost tens of
// LSB.

#include <cuda_runtime.h>
#include <stdint.h>

#define PFB_THREADS 256
#define PFB_RUN 16  // frames one tap task walks
#define PFB_SM_SMEM 233472  // shared memory of one SM, bytes

// M = M1 x M2 and the tile of TS output samples
template <int M> struct PfbShape;
template <> struct PfbShape<32> { static constexpr int M1 = 8, M2 = 4, TS = 128; };
template <> struct PfbShape<64> { static constexpr int M1 = 8, M2 = 8, TS = 64; };
template <> struct PfbShape<128> { static constexpr int M1 = 16, M2 = 8, TS = 32; };
template <> struct PfbShape<256> { static constexpr int M1 = 16, M2 = 16, TS = 32; };

// words of one input stage: TS/OS + PR frames (the ring may read PR - P
// frames past the last tap, and the odd stream one frame later), and 4
// for the copy's start below the tile
template <int M, int OS, int PR>
__host__ __device__ constexpr int pfb_stage_words() {
  return (PfbShape<M>::TS / OS + PR) * M + 4;
}

// two stages, a (TS, M+1) float2 workspace, 2M + 2 float2 twiddles (two
// tables), 2 mbarriers
template <int M, int OS, int PR>
__host__ __device__ constexpr int pfb_smem_bytes() {
  return 4 * (2 * pfb_stage_words<M, OS, PR>() +
              2 * PfbShape<M>::TS * (M + 1) + 4 * M + 4) + 16;
}

// blocks an SM holds: by shared memory, and by the registers a thread
// may use (64 with a ring of 8 and 8-point first DFTs, else 80)
template <int M, int OS, int PR>
__host__ __device__ constexpr int pfb_blocks_per_sm() {
  constexpr int regs = PR == 8 && PfbShape<M>::M1 == 8 ? 64 : 80;
  constexpr int by_smem = PFB_SM_SMEM / (pfb_smem_bytes<M, OS, PR>() + 1024);
  constexpr int by_regs = 65536 / (PFB_THREADS * regs);
  return by_smem < by_regs ? by_smem : by_regs;
}

// trunc(clip(v, +-32767)) of I and Q as one packed word: the conversion
// to int16 truncates toward zero and saturates at 32767 (and at -32768,
// which the max before it keeps out)
static __device__ __forceinline__ int32_t pack_iq(float re, float im) {
  short lo, hi;
  asm("cvt.rzi.s16.f32 %0, %1;" : "=h"(lo) : "f"(fmaxf(re, -32767.0f)));
  asm("cvt.rzi.s16.f32 %0, %1;" : "=h"(hi) : "f"(fmaxf(im, -32767.0f)));
  return (int32_t)__byte_perm((int)lo, (int)hi, 0x5410);
}

// the int16 halves of a packed word as floats (exact), one conversion each
static __device__ __forceinline__ void unpack_word(int32_t w, float& i_,
                                                   float& q_) {
  i_ = (float)(int16_t)w;
  q_ = (float)(w >> 16);
}

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// x * W_16^k, k known at compile time after unrolling: the quarter turns
// exactly, the rest by a float of the double value
static __device__ __forceinline__ float2 turn16(float2 x, int k) {
  const float c1 = 0.92387953251128674f, s1 = 0.38268343236508977f;
  const float h = 0.70710678118654752f;
  switch (k & 15) {
    case 0: return x;
    case 1: return cmul(x, make_float2(c1, -s1));
    case 2: return cmul(x, make_float2(h, -h));
    case 3: return cmul(x, make_float2(s1, -c1));
    case 4: return make_float2(x.y, -x.x);
    case 5: return cmul(x, make_float2(-s1, -c1));
    case 6: return cmul(x, make_float2(-h, -h));
    case 7: return cmul(x, make_float2(-c1, -s1));
    case 8: return make_float2(-x.x, -x.y);
    case 9: return cmul(x, make_float2(-c1, s1));
    case 10: return cmul(x, make_float2(-h, h));
    case 11: return cmul(x, make_float2(-s1, c1));
    case 12: return make_float2(-x.y, x.x);
    case 13: return cmul(x, make_float2(s1, c1));
    case 14: return cmul(x, make_float2(h, h));
    default: return cmul(x, make_float2(c1, s1));
  }
}

// the 4-point DFT (W_4 = -i) of a0..a3 in place, natural order
static __device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                            float2& a3) {
  const float2 s02 = make_float2(a0.x + a2.x, a0.y + a2.y);
  const float2 d02 = make_float2(a0.x - a2.x, a0.y - a2.y);
  const float2 s13 = make_float2(a1.x + a3.x, a1.y + a3.y);
  const float2 d13 = make_float2(a1.x - a3.x, a1.y - a3.y);
  a0 = make_float2(s02.x + s13.x, s02.y + s13.y);
  a2 = make_float2(s02.x - s13.x, s02.y - s13.y);
  a1 = make_float2(d02.x + d13.y, d02.y - d13.x);  // d02 - i d13
  a3 = make_float2(d02.x - d13.y, d02.y + d13.x);  // d02 + i d13
}

// x[h], h < N -> x[k] = sum_h x[h] W_N^{h k}, natural order, N = 4, 8 or
// 16: h = (N/4) h1 + h2, k = k1 + 4 k2 (4-point DFTs over h1, the turn
// W_N^{h2 k1}, N/4-point DFTs over h2)
template <int N>
static __device__ __forceinline__ void dft(float2 (&x)[N]) {
  if constexpr (N == 4) {
    dft4(x[0], x[1], x[2], x[3]);
  } else {
    constexpr int Q = N / 4;
    float2 y[N];
#pragma unroll
    for (int h2 = 0; h2 < Q; ++h2) {
      float2 a0 = x[h2], a1 = x[Q + h2], a2 = x[2 * Q + h2], a3 = x[3 * Q + h2];
      dft4(a0, a1, a2, a3);
      y[4 * h2] = a0;
      y[4 * h2 + 1] = turn16(a1, h2 * 1 * (16 / N));
      y[4 * h2 + 2] = turn16(a2, h2 * 2 * (16 / N));
      y[4 * h2 + 3] = turn16(a3, h2 * 3 * (16 / N));
    }
    // y[4 h2 + k1]; the Q-point DFTs over h2
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      if constexpr (Q == 2) {
        const float2 a = y[k1], b = y[4 + k1];
        x[k1] = make_float2(a.x + b.x, a.y + b.y);
        x[k1 + 4] = make_float2(a.x - b.x, a.y - b.y);
      } else {
        float2 a0 = y[k1], a1 = y[4 + k1], a2 = y[8 + k1], a3 = y[12 + k1];
        dft4(a0, a1, a2, a3);
        x[k1] = a0;
        x[k1 + 4] = a1;
        x[k1 + 8] = a2;
        x[k1 + 12] = a3;
      }
    }
  }
}

// two mbarriers at addr, addr + 8, one arrival each
static __device__ __forceinline__ void mbar_init2(unsigned addr) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(addr));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(addr + 8u));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// bytes (a multiple of 16) from src (16-byte aligned) to shared dst by one
// bulk copy that completes on the mbarrier at mb
static __device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                                 unsigned bytes, unsigned mb) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(mb)
      : "memory");
}

// orders this thread's view of earlier generic shared-memory accesses
// before its later bulk copies
static __device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

static __device__ __forceinline__ bool mbar_try_wait(unsigned addr,
                                                     unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

// wide: nwords packed samples.  taps: (P, M).  twid: (M,) float2,
// W_M^{r2 k1} at r2*M1 + k1.  out: (M, pitch) words, I low, Q high, the
// first nsamp of each row written.  Tile t holds output samples
// t*TS .. t*TS + TS - 1; block b takes tiles b, b + gridDim.x, ...
template <int M, int OS, int PR>
__global__ void __launch_bounds__(PFB_THREADS, (pfb_blocks_per_sm<M, OS, PR>()))
pfb_kernel(const int32_t* __restrict__ wide, long long nwords,
           const float* __restrict__ taps, const float2* __restrict__ twid,
           int P, long long nsamp, long long pitch, int ntiles,
           int32_t* __restrict__ out) {
  constexpr int M1 = PfbShape<M>::M1, M2 = PfbShape<M>::M2;
  constexpr int TS = PfbShape<M>::TS, TF = TS / OS, LD = M + 1;
  constexpr int SW = pfb_stage_words<M, OS, PR>();
  constexpr int NT = PFB_THREADS;
  static_assert(M1 * M2 == M && TF % PFB_RUN == 0 && PFB_RUN % PR == 0 &&
                    TS % 32 == 0 && NT % M == 0,
                "pfb_kernel geometry");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int32_t* stage = reinterpret_cast<int32_t*>(smem_raw);
  float2* A = reinterpret_cast<float2*>(stage + 2 * SW);
  float2* tw = A + TS * LD;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(tw + 2 * M + 2);
  const int tid = threadIdx.x;
  const unsigned stage_s = (unsigned)__cvta_generic_to_shared(stage);
  const unsigned mbar_s = (unsigned)__cvta_generic_to_shared(mbar);
  // the capture's offset in words from the 16-byte boundary below it
  const int mis = (int)((reinterpret_cast<uintptr_t>(wide) >> 2) & 3);

  // one thread issues tile t's copy into stage st
  auto issue = [&](int t, int st) {
    const long long w0 = (long long)t * TF * M;
    const long long need = (long long)(TF + P - 1) * M + (OS == 2 ? M / 2 : 0);
    const long long nw = need < nwords - w0 ? need : nwords - w0;
    bulk_load(stage_s + 4u * SW * st, wide + w0 - mis,
              (unsigned)((4 * (mis + nw) + 15) & ~15LL), mbar_s + 8u * st);
  };

  if (tid == 0) mbar_init2(mbar_s);
  // the twiddles, then (from M + 1 on, another bank) the same with the
  // odd k1 negated: the odd samples' odd bins at oversample 2
  for (int i = tid; i < M; i += NT) {
    const float2 w = twid[i];
    tw[i] = w;
    tw[M + 1 + i] = (OS == 2 && (i & 1)) ? make_float2(-w.x, -w.y) : w;
  }
  // this thread's branch for every tap task it takes, and its taps
  const int r = tid % M;
  float h[PR];
#pragma unroll
  for (int p = 0; p < PR; ++p) h[p] = p < P ? taps[p * M + r] : 0.0f;
  __syncthreads();
  if (tid == 0) issue(blockIdx.x, 0);

  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
    const int st = it & 1;
    if (tid == 0 && t + (int)gridDim.x < ntiles) {
      // the other stage was last read by generic loads before the
      // barriers of the previous tile; order them before the bulk copy
      fence_async_shared();
      issue(t + gridDim.x, st ^ 1);
    }
    while (!mbar_try_wait(mbar_s + 8u * st, (it >> 1) & 1)) {
    }
    const int32_t* xs = stage + SW * st + mis;

    // 1. tap sums: task (run, stream s, branch r) walks frames
    //    run*RUN .. run*RUN + RUN - 1 of stream s -> workspace row
    //    j = OS*frame + s, column r
#pragma unroll 1
    for (int task = tid; task < M * TS / PFB_RUN; task += NT) {
      const int s = OS == 1 ? 0 : (task / M) % OS;
      const int run = task / (M * OS);
      int col = r, d = 0;
      if (OS == 2 && s) {
        col = (r + M / 2) & (M - 1);
        d = r >= M / 2;
      }
      const int32_t* x = xs + (run * PFB_RUN + d) * M + col;
      float xr[PR], xi[PR];
#pragma unroll
      for (int q = 0; q < PR - 1; ++q) unpack_word(x[q * M], xr[q], xi[q]);
#pragma unroll
      for (int f = 0; f < PFB_RUN; ++f) {
        unpack_word(x[(f + PR - 1) * M], xr[(f + PR - 1) % PR],
                    xi[(f + PR - 1) % PR]);
        float ar = 0.0f, ai = 0.0f;
#pragma unroll
        for (int p = 0; p < PR; ++p) {
          ar = fmaf(xr[(f + p) % PR], h[p], ar);
          ai = fmaf(xi[(f + p) % PR], h[p], ai);
        }
        const int j = OS * (run * PFB_RUN + f) + s;
        A[j * LD + r] = make_float2(ar, ai);
      }
    }
    __syncthreads();

    // 2. the M1-point DFTs over r1 for each (j, r2), turned by
    //    W_M^{r2 k1}, back into the same slots: slot M2*k1 + r2
#pragma unroll 1
    for (int task = tid; task < TS * M2; task += NT) {
      const int j = task % TS, r2 = task / TS;
      // M1 is even, so k1 + M1*k2 is odd when k1 is: the odd samples at
      // oversample 2 take the table whose odd k1 are negated, which the
      // M2-point DFT of stage 3 carries to every bin k1 + M1*k2
      const float2* twj = tw + (OS == 2 && (j & 1) ? M + 1 : 0) + r2 * M1;
      float2 v[M1];
#pragma unroll
      for (int r1 = 0; r1 < M1; ++r1)
        v[r1] = A[j * LD + M2 * r1 + r2];
      dft<M1>(v);
#pragma unroll
      for (int k1 = 0; k1 < M1; ++k1) {
        const float2 w = k1 == 0 ? v[0] : cmul(v[k1], twj[k1]);
        A[j * LD + M2 * k1 + r2] = w;
      }
    }
    __syncthreads();

    // 3. the M2-point DFTs over r2 for each (j, k1) -> bins k1 + M1*k2,
    //    stored with lanes along j
    const long long j0 = (long long)t * TS;
#pragma unroll 1
    for (int task = tid; task < TS * M1; task += NT) {
      const int j = task % TS, k1 = task / TS;
      float2 v[M2];
#pragma unroll
      for (int r2 = 0; r2 < M2; ++r2)
        v[r2] = A[j * LD + M2 * k1 + r2];
      dft<M2>(v);
      const long long jj = j0 + j;
      if (jj < nsamp) {
#pragma unroll
        for (int k2 = 0; k2 < M2; ++k2)
          out[(size_t)(k1 + M1 * k2) * (size_t)pitch + (size_t)jj] =
              pack_iq(v[k2].x, v[k2].y);
      }
    }
    __syncthreads();
  }
}

template <int M, int OS, int PR>
static int pfb_launch(const int32_t* wide, long long nwords, const float* taps,
                      const float* twid, int P, int TS, int threads,
                      long long nsamp, long long pitch, int grid, int32_t* out,
                      int smem_bytes, void* stream) {
  // the wrapper's plan (channelizer_cuda.pfb_plan) must be this kernel's
  if (TS != PfbShape<M>::TS || threads != PFB_THREADS ||
      smem_bytes != pfb_smem_bytes<M, OS, PR>() || P > PR || P < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (nsamp + TS - 1) / TS;
  if (ntiles > 0x7fffffffLL || grid > ntiles) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pfb_kernel<M, OS, PR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  pfb_kernel<M, OS, PR><<<grid, PFB_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      wide, nwords, taps, reinterpret_cast<const float2*>(twid), P, nsamp, pitch,
      (int)ntiles, out);
  return (int)cudaGetLastError();
}

template <int OS, int PR>
static int pfb_launch_m(const int32_t* wide, long long nwords, const float* taps,
                        const float* twid, int M, int P, int TS, int threads,
                        long long nsamp, long long pitch, int grid,
                        int32_t* out, int smem_bytes, void* stream) {
  switch (M) {
#define PFB_CASE(m)                                                            \
  case m:                                                                      \
    return pfb_launch<m, OS, PR>(wide, nwords, taps, twid, P, TS, threads,    \
                                 nsamp, pitch, grid, out, smem_bytes, stream);
    PFB_CASE(32)
    PFB_CASE(64)
    PFB_CASE(128)
    PFB_CASE(256)
#undef PFB_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K7a (oversample 1, the critically sampled bank) or K7b (oversample 2:
// hop M/2, odd samples' odd bins negated).  M in 32..256 a power of two;
// P <= ring, ring 8 or 16; TS, threads, grid and smem_bytes from the
// wrapper's plan; nsamp output samples per channel into rows of pitch
// words.
extern "C" int channelize_launch(const int32_t* wide, long long nwords,
                                 const float* taps, const float* twid, int M,
                                 int P, int ring, int TS, int threads,
                                 int oversample, long long nsamp,
                                 long long pitch, int grid, int32_t* out,
                                 int smem_bytes, void* stream) {
#define PFB_ARGS wide, nwords, taps, twid, M, P, TS, threads, nsamp, pitch, \
                 grid, out, smem_bytes, stream
  if (oversample == 1 && ring == 8) return pfb_launch_m<1, 8>(PFB_ARGS);
  if (oversample == 1 && ring == 16) return pfb_launch_m<1, 16>(PFB_ARGS);
  if (oversample == 2 && ring == 8) return pfb_launch_m<2, 8>(PFB_ARGS);
  if (oversample == 2 && ring == 16) return pfb_launch_m<2, 16>(PFB_ARGS);
#undef PFB_ARGS
  return (int)cudaErrorInvalidValue;
}
