// Kernels K1 and K2 of the PyTorch/CUDA port: one pm block step over
// packed int16 IQ (I in the low half of each int32 word).
//
// K1 pm_locked_launch replaces the TPU kernel _locked_kernel
//    (isee3_decoder_tpu/ops/carrier_pallas.py:687, entry pm_locked_fused):
//    windowed DFT over the K search-window bins -> masked LAST-max peak +
//    Quinn's second estimator -> five-moment spin-down (amp, C/N0) ->
//    rotate and emit Q*sqrt(1/2) truncated to int16.
// K2 spin_down_launch replaces _spin_kernel (carrier_pallas.py:214,
//    entry spin_down_fused): the spin-down and emission at a given carrier.
//
// K1's search takes one of two designs, picked on shape by the wrapper's
// plan (carrier_cuda.pm_locked_plan); both are followed by the same
// spin-down, which K2 runs alone.
//   "columns", n a multiple of 256 CD_COLS = 8192 (every locked block of
//     the 250 ksps chain, de-chirped or not): locked_search_kernel, one
//     512-thread block per channel, the window bins by K9's split (256-point
//     column DFTs pass by pass, an outer sum over the columns in registers,
//     twiddles from the W_n^j table), the de-chirp inside the column passes,
//     then the masked last-max peak and Quinn in the same block.  The row is
//     read once (4 bytes a sample); ~2·10^6 flop per channel at n = 65536.
//     Bound on the H100 by latency, not bytes: 8 dependent passes of two
//     barriers each on one block per SM (128 registers x 512 threads fill
//     the register file), 0.028-0.032 ms at 128 x 65536, K = 107 against a
//     0.010 ms bytes bound; splitting a channel's passes over 2, 4 or 8
//     blocks only added waves (0.040, 0.053, 0.079 ms).
//   "direct", the other n K1 takes (de-chirped blocks below 8192 samples):
//     dft_kernel, grid (bin tiles, B): thread = column l of i = 256h + l,
//     inner sum over h with a shared twiddle table, outer twiddle per (bin,
//     l), block reduction over l; then peak_kernel, one thread per channel.
//     The direct n·K sum (8 flop per sample and bin, each row read once
//     per 16 bins): bound by operations, and small at these n.
// The spin-down (K2 alone, K1 after its search) takes one of two designs,
// picked on shape by the wrapper's plan (carrier_cuda.spin_plan):
//   "cluster", n up to SPIN_CLUSTER_MAX CHIRP_CHUNKs = 65,536 (every block
//     of the receive chains): spin_cluster_kernel, one launch, one
//     thread-block cluster per channel (8 blocks of 512 threads at n =
//     65,536; one block for n <= 8192).  Each sample is read once (16-byte
//     loads), spun once (one precise sincosf) and kept in registers while
//     the five moments are reduced: float over a thread's 16 samples, double
//     over the warp, the block and the cluster's ranks in rank order through
//     distributed shared memory, so every block finishes them with the same
//     bits; then it emits int16 from the registers (16-byte stores).  The
//     carrier's cycles/sample are divided in the kernel (__fdiv_rn, as
//     carrier.carrier_cycles rounds them).  4 + 2 bytes a sample, one
//     sincosf: at 128 x 65536 it takes 0.040-0.045 ms of device time
//     against a 0.015 ms bytes bound.  Not the loads hold it back: staging
//     the next row by a bulk copy under the current row's sincosf
//     (persistent clusters) gained nothing; one block an SM (80 registers)
//     and one out-of-line sincosf for all samples lost.  So, by elimination,
//     the instruction throughput of the per-sample chain (the precise
//     sincosf's range reduction and polynomials, the exact phase, the
//     rotation, the moments, the emission; 64 registers, two blocks an SM).
//   "two_pass", longer rows: moments_kernel grid (chunks, B), partial sums
//     of the five moments in double across threads, then emit_kernel grid
//     (chunks, B), which finishes the moments (every block the same way, in
//     the same order), spins the samples again and writes int16; the row
//     is read twice, two sincosf a sample.
// Every phase stays exact (integer products reduced mod their period, the
// two-level reduction c256*(i/256) + c*(i%256) of the JAX package's
// _lo_ramp; no fast-math: __sinf/__cosf are wrong at these angles).
// Measured at 128 x 65536, K = 107 on an H100 80GB HBM3 at 700 W
// (utils/kernel_turns.py, device time): K1's search 0.031 ms and its
// spin-down 0.037-0.039 (the two passes took 0.072); K2 0.040-0.042 (0.075
// in two passes).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define SPIN_CHUNK 4096   // samples per moments / emit block
#define SPIN_THREADS 256  // SPIN_CHUNK / 16 samples per thread
#define DFT_THREADS 256   // one thread per column l (i = 256 h + l)
#define DFT_KT 16         // bins per dft block
#define CHIRP_CHUNK 8192  // de-chirp coefficient chunk (a multiple of SPIN_CHUNK)

__device__ __forceinline__ void unpack_iq(int32_t w, int flip, float& i_,
                                          float& q_) {
  float lo = (float)(int16_t)(w & 0xFFFF);
  float hi = (float)(int16_t)(w >> 16);
  if (flip) {
    i_ = hi;
    q_ = lo;
  } else {
    i_ = lo;
    q_ = hi;
  }
}

// jnp.mod(x, 1.0): remainder with the sign of the divisor
__device__ __forceinline__ float mod1(float x) {
  float r = fmodf(x, 1.0f);
  return (r < 0.0f) ? r + 1.0f : r;
}

// Per-8192-sample-chunk de-chirp phase, in cycles, for samples
// i = k*8192 + j: phi(j) = A + B256*(j/256) + Bk*(j%256) + C*j^2 with the
// chunk base reduced mod 1 in double (the JAX package's _chirp_cycles):
// the Doppler de-chirp (pmdemod.c:232-244, restarted every block) folded
// into the mix angle.  All zero when dop == 0.
struct Chirp {
  float A, Bk, B256, C;
};

__device__ __forceinline__ double pymod1(double x) {
  double r = fmod(x, 1.0);
  return (r < 0.0) ? r + 1.0 : r;
}

// (rounded op by op, in the order the host-side Python evaluates them)
__device__ __forceinline__ Chirp chirp_coeffs(double dop, int k) {
  const double base = (double)k * CHIRP_CHUNK;
  const double hd = __dmul_rn(0.5, dop);
  const double Bk = pymod1(__dadd_rn(__dmul_rn(dop, base), hd));
  Chirp ch;
  ch.A = (float)pymod1(__dadd_rn(__dmul_rn(__dmul_rn(hd, base), base),
                                 __dmul_rn(hd, base)));
  ch.Bk = (float)Bk;
  ch.B256 = (float)pymod1(__dmul_rn(256.0, Bk));
  ch.C = (float)hd;
  return ch;
}

// Mix sample idx down by c cycles/sample (plus the de-chirp when dop):
// (i + jq) * exp(-2*pi*j*cyc)
__device__ __forceinline__ void spun_sample(int32_t w, int idx, float c,
                                            float c256, bool dop,
                                            const Chirp& ch, int flip,
                                            float& sr, float& si) {
  float i_, q_;
  unpack_iq(w, flip, i_, q_);
  // no FMA contraction: the plain PyTorch version rounds each product
  float cyc = __fadd_rn(__fmul_rn(c256, (float)(idx >> 8)),
                        __fmul_rn(c, (float)(idx & 255)));
  if (dop) {
    const int j = idx % CHIRP_CHUNK;
    const float jf = (float)j;
    float t = __fadd_rn(ch.A, __fmul_rn(ch.B256, (float)(j >> 8)));
    t = __fadd_rn(t, __fmul_rn(ch.Bk, (float)(j & 255)));
    t = __fadd_rn(t, __fmul_rn(ch.C, __fmul_rn(jf, jf)));
    cyc = __fadd_rn(cyc, t);
  }
  float ang = __fmul_rn(6.283185307179586f, cyc);
  float s, co;
  sincosf(ang, &s, &co);
  float lor = co, loi = -s;
  sr = i_ * lor - q_ * loi;
  si = i_ * loi + q_ * lor;
}

__device__ __forceinline__ float quinn_tau(float x) {
  const float r = 0.8164966f;   // float32(sqrt(2/3))
  const float k = 0.10206208f;  // float32(sqrt(6)/24)
  return 0.25f * logf(3.0f * x * x + 6.0f * x + 1.0f) -
         k * logf((x + 1.0f - r) / (x + 1.0f + r));
}

// ---- K1 pass 1: windowed DFT -----------------------------------------
// spec[b][k] = sum_i x[i] exp(-2 pi j f i / n), f = first1_b + k, by the
// split X[f] = sum_l W_n^{f l} sum_h x[256h+l] W_nhi^{(f mod nhi) h}.
// chirp: NULL, or n de-chirp phasors exp(-2 pi j phi(i)) that rotate the
// DATA first (the chirp phase has an h*l cross term, so it cannot fold
// into the two DFT factors).
//
// One thread's share of the DFT_KT bins f0 .. f0+DFT_KT-1: column l of
// the split, summed over the nhi rows (twiddles tw[j] = W_nhi^j in shared
// memory), turned by the outer twiddle and summed over the warp.  Lane 0
// of each warp returns the warp's sums in v[].
__device__ __forceinline__ void dft_columns(const int32_t* __restrict__ row,
                                            int n, int flip,
                                            const float2* __restrict__ chirp,
                                            const float2* tw, int f0, int l,
                                            float2 v[DFT_KT]) {
  const int nhi = n >> 8;
  int q[DFT_KT], idx[DFT_KT];
  float ar[DFT_KT], ai[DFT_KT];
#pragma unroll
  for (int k = 0; k < DFT_KT; ++k) {
    int fm = (f0 + k) % nhi;
    q[k] = fm < 0 ? fm + nhi : fm;
    idx[k] = 0;
    ar[k] = 0.0f;
    ai[k] = 0.0f;
  }
  for (int h = 0; h < nhi; ++h) {
    float xr, xi;
    unpack_iq(row[h * 256 + l], flip, xr, xi);
    if (chirp != nullptr) {
      const float2 d = chirp[h * 256 + l];
      const float r = __fsub_rn(__fmul_rn(xr, d.x), __fmul_rn(xi, d.y));
      xi = __fadd_rn(__fmul_rn(xr, d.y), __fmul_rn(xi, d.x));
      xr = r;
    }
#pragma unroll
    for (int k = 0; k < DFT_KT; ++k) {
      float2 w = tw[idx[k]];
      ar[k] += xr * w.x - xi * w.y;
      ai[k] += xr * w.y + xi * w.x;
      idx[k] += q[k];
      if (idx[k] >= nhi) idx[k] -= nhi;
    }
  }
  // outer twiddle W_n^{(f mod n) l}, exact: (f mod n) * l < 256 n < 2^31
#pragma unroll
  for (int k = 0; k < DFT_KT; ++k) {
    int fm = (f0 + k) % n;
    fm = fm < 0 ? fm + n : fm;
    int ph = (int)(((long long)fm * l) % n);
    double s, c;
    sincospi(2.0 * (double)ph / (double)n, &s, &c);
    float wr = (float)c, wi = (float)-s;
    float vr = ar[k] * wr - ai[k] * wi;
    float vi = ar[k] * wi + ai[k] * wr;
    for (int off = 16; off > 0; off >>= 1) {
      vr += __shfl_down_sync(0xffffffffu, vr, off);
      vi += __shfl_down_sync(0xffffffffu, vi, off);
    }
    v[k] = make_float2(vr, vi);
  }
}

// tw[j] = W_nhi^j, j < nhi, filled by the block
__device__ __forceinline__ void dft_twiddles(float2* tw, int nhi) {
  for (int j = threadIdx.x; j < nhi; j += blockDim.x) {
    double s, c;
    sincospi(2.0 * (double)j / (double)nhi, &s, &c);
    tw[j] = make_float2((float)c, (float)-s);
  }
}

// grid (bin tiles, B), DFT_THREADS threads; first1_b = iw[iw_stride * b]
__global__ void dft_kernel(const int32_t* __restrict__ packed, int row_stride,
                           const int32_t* __restrict__ iw, int iw_stride, int n,
                           int K, int flip, const float2* __restrict__ chirp,
                           float2* __restrict__ spec) {
  extern __shared__ float2 smem[];
  const int nhi = n >> 8;
  float2* tw = smem;                    // nhi twiddles W_nhi^j
  float2* red = smem + nhi;             // (DFT_THREADS/32) x DFT_KT partials
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * DFT_KT;
  const int l = threadIdx.x;
  dft_twiddles(tw, nhi);
  __syncthreads();
  float2 v[DFT_KT];
  dft_columns(packed + (size_t)b * row_stride, n, flip, chirp, tw,
              iw[(size_t)iw_stride * b] + k0, l, v);
  const int warp = l >> 5, lane = l & 31;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < DFT_KT; ++k) red[warp * DFT_KT + k] = v[k];
  }
  __syncthreads();
  if (l < DFT_KT && k0 + l < K) {
    float sr = 0.0f, si = 0.0f;
    for (int wdx = 0; wdx < DFT_THREADS / 32; ++wdx) {
      sr += red[wdx * DFT_KT + l].x;
      si += red[wdx * DFT_KT + l].y;
    }
    spec[(size_t)b * K + k0 + l] = make_float2(sr, si);
  }
}

// ---- K1 pass 2: masked last-max peak + Quinn ---------------------------
// Quinn's second estimator over the peak bin and its neighbours -> Hz
__device__ __forceinline__ float quinn_freq(float2 sp, float2 sn, float2 sm,
                                            int peak_bin, float samprate,
                                            float binsize) {
  float maxenergy = sp.x * sp.x + sp.y * sp.y;
  float safe = maxenergy > 0.0f ? maxenergy : 1.0f;
  float ap = (sn.x * sp.x + sn.y * sp.y) / safe;
  float dp = -ap / (1.0f - ap);
  float am = (sm.x * sp.x + sm.y * sp.y) / safe;
  float dm = am / (1.0f - am);
  float d = (dp + dm) * 0.5f + quinn_tau(dp * dp) - quinn_tau(dm * dm);
  if (!(maxenergy > 0.0f)) d = 0.0f;
  float freq = binsize * ((float)peak_bin + d);
  if (freq > samprate / 2.0f) freq -= samprate;
  return freq;
}

__global__ void peak_kernel(const float2* __restrict__ spec,
                            const int32_t* __restrict__ iw, int B, int K,
                            float samprate, float binsize,
                            float* __restrict__ stat, float* __restrict__ cyc) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float2* S = spec + (size_t)b * K;
  const int first1 = iw[2 * b];
  const int wlen = iw[2 * b + 1];
  float best = -INFINITY;
  int pk = 0;
  for (int k = 0; k < K; ++k) {
    float e = S[k].x * S[k].x + S[k].y * S[k].y;
    float m = (k >= 1 && k < wlen + 1) ? e : -1.0f;
    if (m >= best) {  // ">=": the reference keeps the LAST maximal bin
      best = m;
      pk = k;
    }
  }
  float freq = quinn_freq(S[pk], S[min(pk + 1, K - 1)], S[max(pk - 1, 0)],
                          first1 + pk, samprate, binsize);
  stat[4 * b + 2] = freq;
  stat[4 * b + 3] = (float)(first1 + pk);
  cyc[b] = __fdiv_rn(freq, samprate);
}

// Five-moment spin-down finish (the JAX package's _moments_cn0) from the
// sums s[] of sr, si, sr^2, si^2, sr*si over n samples -> amp, C/N0 and the
// unit phasor conj(dc)/amp = (ur, ui)
__device__ __forceinline__ void finish_moments(const double s[5], int n,
                                               float samprate, float& amp,
                                               float& cn0, float& ur,
                                               float& ui) {
  const float inv = (float)(1.0 / (double)n);
  float m_r = (float)s[0] * inv, m_i = (float)s[1] * inv;
  float m_rr = (float)s[2] * inv, m_ii = (float)s[3] * inv;
  float m_ri = (float)s[4] * inv;
  float amp2 = m_r * m_r + m_i * m_i;
  amp = sqrtf(amp2);
  float safe2 = amp2 > 0.0f ? amp2 : 1.0f;
  float e_rot2 =
      (m_rr * m_r * m_r + 2.0f * m_ri * m_r * m_i + m_ii * m_i * m_i) / safe2;
  float var = fmaxf(e_rot2 - amp2, amp2 * 3e-7f + 1e-30f);
  cn0 = (10.0f / 2.30258509f) * logf(samprate * amp2 / (2.0f * var));
  float safe_amp = amp > 0.0f ? amp : 1.0f;
  ur = amp > 0.0f ? m_r / safe_amp : 1.0f;
  ui = amp > 0.0f ? -m_i / safe_amp : 0.0f;
}

// Q axis of the rotated sample, -3 dB, truncated toward zero, saturated
__device__ __forceinline__ int emit_sample(float sr, float si, float ur,
                                           float ui) {
  float rot_i = sr * ui + si * ur;  // imag(spun * unit)
  float v = truncf(rot_i * 0.70710677f);
  return (int)fminf(fmaxf(v, -32768.0f), 32767.0f);
}

// ---- spin-down pass 1: per-chunk partial moments ------------------------
__global__ void moments_kernel(const int32_t* __restrict__ packed,
                               int row_stride, const float* __restrict__ cyc,
                               int n, int flip, double dop,
                               double* __restrict__ mom) {
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const float c = cyc[b];
  const float c256 = mod1(c * 256.0f);
  const Chirp ch = chirp_coeffs(dop, chunk * SPIN_CHUNK / CHIRP_CHUNK);
  const int32_t* row = packed + (size_t)b * row_stride;
  float a[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < SPIN_CHUNK / SPIN_THREADS; ++j) {
    int idx = chunk * SPIN_CHUNK + j * SPIN_THREADS + threadIdx.x;
    if (idx < n) {
      float sr, si;
      spun_sample(row[idx], idx, c, c256, dop != 0.0, ch, flip, sr, si);
      a[0] += sr;
      a[1] += si;
      a[2] += sr * sr;
      a[3] += si * si;
      a[4] += sr * si;
    }
  }
  __shared__ double red[SPIN_THREADS / 32][5];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    double v = (double)a[m];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][m] = v;
  }
  __syncthreads();
  if (threadIdx.x < 5) {
    double v = 0.0;
    for (int w = 0; w < SPIN_THREADS / 32; ++w) v += red[w][threadIdx.x];
    mom[((size_t)b * gridDim.x + chunk) * 5 + threadIdx.x] = v;
  }
}

// ---- spin-down pass 2: finish moments, rotate, emit int16 --------------
__global__ void emit_kernel(const int32_t* __restrict__ packed, int row_stride,
                            const float* __restrict__ cyc,
                            const double* __restrict__ mom, int n, int flip,
                            double dop, float samprate, int stat_stride,
                            int16_t* __restrict__ bb, float* __restrict__ stat) {
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int nchunk = gridDim.x;
  __shared__ float unit[2];
  if (threadIdx.x == 0) {
    double s[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
    for (int k = 0; k < nchunk; ++k)
      for (int m = 0; m < 5; ++m) s[m] += mom[((size_t)b * nchunk + k) * 5 + m];
    float amp, cn0;
    finish_moments(s, n, samprate, amp, cn0, unit[0], unit[1]);
    if (chunk == 0) {
      stat[(size_t)stat_stride * b + 0] = amp;
      stat[(size_t)stat_stride * b + 1] = cn0;
    }
  }
  __syncthreads();
  const float ur = unit[0], ui = unit[1];
  const float c = cyc[b];
  const float c256 = mod1(c * 256.0f);
  const Chirp ch = chirp_coeffs(dop, chunk * SPIN_CHUNK / CHIRP_CHUNK);
  const int32_t* row = packed + (size_t)b * row_stride;
  int16_t* out = bb + (size_t)b * n;
  for (int j = 0; j < SPIN_CHUNK / SPIN_THREADS; ++j) {
    int idx = chunk * SPIN_CHUNK + j * SPIN_THREADS + threadIdx.x;
    if (idx < n) {
      float sr, si;
      spun_sample(row[idx], idx, c, c256, dop != 0.0, ch, flip, sr, si);
      out[idx] = (int16_t)emit_sample(sr, si, ur, ui);
    }
  }
}

// ---- the spin-down in one launch: a thread-block cluster per channel ----
// Grid (C, B), cluster (C, 1, 1): the C blocks of cluster b own row b, block
// rank r the samples r*chunk .. r*chunk + chunk - 1 (chunk = blockDim.x *
// SPIN_SPT, the plan's; a block of a cluster of C > 1 owns one whole
// CHIRP_CHUNK, a lone block all n <= CHIRP_CHUNK samples, so every sample of
// a block takes the same Chirp).  Thread t of a block holds the groups
// g = p*blockDim.x + t, p < SPIN_SPT/SPIN_GROUP, of SPIN_GROUP consecutive
// samples (sample r*chunk + SPIN_GROUP*g + e, e < SPIN_GROUP): it reads each
// group's 8 words in two 16-byte loads (4-byte loads when a row is not
// 16-byte aligned), keeps the spun samples in registers, and writes each
// group's 8 int16 in one 16-byte store.  The moments: float over the
// thread's samples in slot order (p, e), then double over the warp
// (shuffles), over the warps in order and over the cluster's ranks in rank
// order (distributed shared memory), so every block of a cluster finishes
// them with the same bits and takes the same unit phasor.
#define SPIN_SPT 16           // samples a thread holds
#define SPIN_GROUP 8          // consecutive samples of one load pair / store
#define SPIN_CLUSTER_MAX 8    // the portable cluster size
#define SPIN_WARPS_MAX 16     // 512 threads
#define SPIN_MIN_BLOCKS 2     // blocks an SM at 512 threads: <= 64 registers

// the second cluster barrier in two halves: a block arrives once it has
// read its siblings' partials, and waits before it exits, so no block's
// shared memory goes while another reads it and the emission runs between
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// spun_sample for the SPIN_GROUP samples idx0 .. idx0 + 7 of a group
// (idx0 % SPIN_GROUP == 0), with the same bits: the group shares idx >> 8
// (so c256 * (idx >> 8)) and, de-chirped, j >> 8, and (float)(idx & 255)
// = (float)(idx0 & 255) + e, (float)j = (float)j0 + e exactly
__device__ __forceinline__ void spun_group(const int32_t w[SPIN_GROUP],
                                           int idx0, float c, float c256,
                                           bool dop, const Chirp& ch,
                                           int flip, float sr[SPIN_GROUP],
                                           float si[SPIN_GROUP]) {
  const float hi = __fmul_rn(c256, (float)(idx0 >> 8));
  const float lo0 = (float)(idx0 & 255);
  float t0 = 0.0f, jl0 = 0.0f, jf0 = 0.0f;
  if (dop) {
    const int j0 = idx0 & (CHIRP_CHUNK - 1);
    t0 = __fadd_rn(ch.A, __fmul_rn(ch.B256, (float)(j0 >> 8)));
    jl0 = (float)(j0 & 255);
    jf0 = (float)j0;
  }
#pragma unroll
  for (int e = 0; e < SPIN_GROUP; ++e) {
    float i_, q_;
    unpack_iq(w[e], flip, i_, q_);
    float cyc = __fadd_rn(hi, __fmul_rn(c, lo0 + (float)e));
    if (dop) {
      const float jf = jf0 + (float)e;
      float t = __fadd_rn(t0, __fmul_rn(ch.Bk, jl0 + (float)e));
      t = __fadd_rn(t, __fmul_rn(ch.C, __fmul_rn(jf, jf)));
      cyc = __fadd_rn(cyc, t);
    }
    const float ang = __fmul_rn(6.283185307179586f, cyc);
    float s, co;
    sincosf(ang, &s, &co);
    const float lor = co, loi = -s;
    sr[e] = i_ * lor - q_ * loi;
    si[e] = i_ * loi + q_ * lor;
  }
}

// cin: (B,) Hz when divide (cycles = __fdiv_rn(Hz, samprate), as
// carrier.carrier_cycles rounds it), else (B,) cycles/sample
template <bool VEC>
__global__ void __launch_bounds__(512, SPIN_MIN_BLOCKS)
    spin_cluster_kernel(const int32_t* __restrict__ packed, int row_stride,
                        const float* __restrict__ cin, int divide, int n,
                        float samprate, int flip, double dop, int stat_stride,
                        int16_t* __restrict__ bb, float* __restrict__ stat) {
  constexpr int NG = SPIN_SPT / SPIN_GROUP;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nrank = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int T = blockDim.x, t = threadIdx.x;
  const int base = rank * T * SPIN_SPT;  // the block's first sample
  const float x = cin[b];
  const float c = divide ? __fdiv_rn(x, samprate) : x;
  const float c256 = mod1(c * 256.0f);
  const bool dp = dop != 0.0;
  Chirp ch = {0.0f, 0.0f, 0.0f, 0.0f};
  if (dp) ch = chirp_coeffs(dop, base / CHIRP_CHUNK);
  const int32_t* row = packed + (size_t)b * row_stride;

  // ---- one read of the row: every load in flight before the first sincosf
  int32_t w[NG][SPIN_GROUP];
#pragma unroll
  for (int p = 0; p < NG; ++p) {
    const int i0 = base + SPIN_GROUP * (p * T + t);
#pragma unroll
    for (int e = 0; e < SPIN_GROUP; ++e) w[p][e] = 0;
    if (i0 < n) {
      if (VEC) {
        const int4 u = *reinterpret_cast<const int4*>(row + i0);
        const int4 v = *reinterpret_cast<const int4*>(row + i0 + 4);
        w[p][0] = u.x; w[p][1] = u.y; w[p][2] = u.z; w[p][3] = u.w;
        w[p][4] = v.x; w[p][5] = v.y; w[p][6] = v.z; w[p][7] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < SPIN_GROUP; ++e) w[p][e] = row[i0 + e];
      }
    }
  }
  // ---- one sincosf a sample; the spun samples stay in registers
  float sr[NG][SPIN_GROUP], si[NG][SPIN_GROUP];
  float a[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int p = 0; p < NG; ++p) {
    const int i0 = base + SPIN_GROUP * (p * T + t);
#pragma unroll
    for (int e = 0; e < SPIN_GROUP; ++e) {
      sr[p][e] = 0.0f;
      si[p][e] = 0.0f;
    }
    if (i0 < n) {
      spun_group(w[p], i0, c, c256, dp, ch, flip, sr[p], si[p]);
#pragma unroll
      for (int e = 0; e < SPIN_GROUP; ++e) {
        a[0] += sr[p][e];
        a[1] += si[p][e];
        a[2] += sr[p][e] * sr[p][e];
        a[3] += si[p][e] * si[p][e];
        a[4] += sr[p][e] * si[p][e];
      }
    }
  }
  // ---- the moments in double: warp, block, then the cluster in rank
  //      order; warp 0 finishes them once for the block
  __shared__ double wsum[SPIN_WARPS_MAX][5];
  __shared__ double part[5];
  __shared__ float unit[2];
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    double v = (double)a[m];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) wsum[warp][m] = v;
  }
  __syncthreads();
  if (t < 5) {
    double v = 0.0;
    for (int k = 0; k < (T >> 5); ++k) v += wsum[k][t];
    part[t] = v;
  }
  cluster.sync();  // every block's partials written (and every block running)
  if (warp == 0) {
    double v = 0.0;
    if (lane < 5)
      for (int r = 0; r < nrank; ++r)
        v += *cluster.map_shared_rank(&part[lane], r);
    double s[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) s[m] = __shfl_sync(0xffffffffu, v, m);
    if (lane == 0) {
      float amp, cn0;
      finish_moments(s, n, samprate, amp, cn0, unit[0], unit[1]);
      if (rank == 0) {
        stat[(size_t)stat_stride * b + 0] = amp;
        stat[(size_t)stat_stride * b + 1] = cn0;
      }
    }
  }
  cluster_arrive();
  __syncthreads();
  const float ur = unit[0], ui = unit[1];
  // ---- emit from the registers, 8 int16 a store
  int16_t* out = bb + (size_t)b * n;
#pragma unroll
  for (int p = 0; p < NG; ++p) {
    const int i0 = base + SPIN_GROUP * (p * T + t);
    if (i0 < n) {
      int q[SPIN_GROUP];
#pragma unroll
      for (int e = 0; e < SPIN_GROUP; ++e)
        q[e] = emit_sample(sr[p][e], si[p][e], ur, ui);
      if (VEC) {
        int4 o;
        o.x = (int)(((unsigned)q[0] & 0xFFFFu) | ((unsigned)q[1] << 16));
        o.y = (int)(((unsigned)q[2] & 0xFFFFu) | ((unsigned)q[3] << 16));
        o.z = (int)(((unsigned)q[4] & 0xFFFFu) | ((unsigned)q[5] << 16));
        o.w = (int)(((unsigned)q[6] & 0xFFFFu) | ((unsigned)q[7] << 16));
        *reinterpret_cast<int4*>(out + i0) = o;
      } else {
#pragma unroll
        for (int e = 0; e < SPIN_GROUP; ++e) out[i0 + e] = (int16_t)q[e];
      }
    }
  }
  cluster_wait();
}

template <bool VEC>
static cudaError_t spin_cluster_launch(const int32_t* packed, int row_stride,
                                       const float* cin, int divide, int B,
                                       int n, float samprate, int flip,
                                       double dop, int cluster, int threads,
                                       int16_t* bb, float* stat,
                                       int stat_stride, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // once per device and cluster size: that such a cluster can be resident
  static unsigned checked[32];  // bit `cluster` per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (cluster < 1 || cluster > SPIN_CLUSTER_MAX || threads < 32 ||
      threads > 512 || (threads & 31) != 0)
    return cudaErrorInvalidValue;
  if (dev >= 32 || !(checked[dev] & (1u << cluster))) {
    int fits = 0;
    err = cudaOccupancyMaxActiveClusters(&fits, spin_cluster_kernel<VEC>,
                                         &cfg);
    if (err != cudaSuccess) return err;
    if (fits < 1) return cudaErrorInvalidClusterSize;
    if (dev < 32) checked[dev] |= 1u << cluster;
  }
  return cudaLaunchKernelEx(&cfg, spin_cluster_kernel<VEC>, packed, row_stride,
                            cin, divide, n, samprate, flip, dop, stat_stride,
                            bb, stat);
}

// The spin-down in the design of the wrapper's plan (carrier_cuda.spin_plan):
//   cluster > 0 ("cluster"): spin_cluster_kernel, clusters of `cluster`
//     blocks of `threads` threads; cin is Hz (divide 1) or cycles/sample;
//   cluster 0 ("two_pass", rows of more than SPIN_CLUSTER_MAX CHIRP_CHUNKs):
//     moments_kernel + emit_kernel with the scratch mom (B, ceil(n /
//     SPIN_CHUNK), 5) f64; cin must be cycles/sample (divide 0).
static cudaError_t spin_launch(const int32_t* packed, int row_stride,
                               const float* cin, int divide, int B, int n,
                               float samprate, int flip, double dop,
                               int cluster, int threads, int16_t* bb,
                               float* stat, int stat_stride, double* mom,
                               cudaStream_t stream) {
  if (cluster > 0) {
    const bool vec = ((uintptr_t)packed & 15) == 0 && (row_stride & 3) == 0 &&
                     ((uintptr_t)bb & 15) == 0;
    return vec ? spin_cluster_launch<true>(packed, row_stride, cin, divide, B,
                                           n, samprate, flip, dop, cluster,
                                           threads, bb, stat, stat_stride,
                                           stream)
               : spin_cluster_launch<false>(packed, row_stride, cin, divide,
                                            B, n, samprate, flip, dop, cluster,
                                            threads, bb, stat, stat_stride,
                                            stream);
  }
  if (divide || mom == nullptr) return cudaErrorInvalidValue;
  dim3 grid((n + SPIN_CHUNK - 1) / SPIN_CHUNK, B);
  moments_kernel<<<grid, SPIN_THREADS, 0, stream>>>(packed, row_stride, cin, n,
                                                    flip, dop, mom);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  emit_kernel<<<grid, SPIN_THREADS, 0, stream>>>(packed, row_stride, cin, mom, n,
                                                 flip, dop, samprate,
                                                 stat_stride, bb, stat);
  return cudaGetLastError();
}

// K2.  freq (B,) f32: Hz when divide, else cycles/sample (the "two_pass"
// design takes cycles only); dop as for K1; cluster and threads from
// carrier_cuda.spin_plan (cluster 0: "two_pass"); outputs bb (B, n) int16
// and stat (B, 2) f32 [amp, cn0]; scratch mom as for spin_launch (NULL on
// "cluster").
extern "C" int spin_down_launch(const int32_t* packed, int row_stride,
                                const float* freq, int divide, int B, int n,
                                float samprate, int flip, double dop,
                                int cluster, int threads, int16_t* bb,
                                float* stat, double* mom, void* stream) {
  return (int)spin_launch(packed, row_stride, freq, divide, B, n, samprate,
                          flip, dop, cluster, threads, bb, stat, 2, mom,
                          (cudaStream_t)stream);
}

// ---- K8: the windowed DFT search and its peak pass in one launch --------
// Replaces the TPU kernel _kernel (isee3_decoder_tpu/ops/carrier_pallas.py:63,
// call :149), with K1's peak pass (masked last-max + Quinn) in the same
// block.  One block per channel; the split n = 16 C (C columns of 16 rows,
// i = C h + c):
//   X[f] = sum_c W_n^{f c} A[f mod 16][c],  A[r][c] = sum_h x[C h + c] W_16^{r h}
// 1. the row (4n bytes) is staged in shared memory by one TMA bulk copy
//    that completes on an mbarrier (4-byte cp.async copies when the row is
//    not 16-byte aligned), the twiddle tables by cp.async beside it;
// 2. one thread per column: the 16-point DFT of the column in registers
//    (radix 4 x 4, constant twiddles), all 16 residues into A;
// 3. the bins by residue class: bins k = rho + 16 t read the same row of
//    A; warp w takes the classes w and w + 8, four bins of each at a time.
//    c = 32 m + lane, so W_n^{f c} = W_{n/32}^{f m} W_n^{f lane}: the first
//    factor is the same for the whole warp (a broadcast from a shared
//    table), the second W_n^{32 (p >> 5)} W_n^{p & 31} from two shared
//    tables, once per lane and bin; the eight bins' chains run side by
//    side, and their 16 sums are reduced over the lanes in halves (16
//    shuffles for all of them);
// 4. the masked last-max peak (equal energies keep the larger bin, k in
//    1..wlen; energies rounded as the plain version rounds them): each
//    warp keeps its candidate while it sums its bins, warp 0 reduces the
//    warps' candidates and runs Quinn's estimator while the other warps
//    store the bins.
// Twiddles come from the table tab[j] = W_n^j (twiddle_table_kernel: the
// double sincospi rounded to float, built once per n); every phase is an
// exact 32-bit integer kept below its period by a compare and subtract (a
// mask when the period is a power of two).  For n = 512 MC, MC = 1, 2, 4
// or 8 (every n the narrowband path gives K8), the column loop has a
// compile-time count and the four bins of a class share one table load:
// W_{n/32}^{(f + 16 t) m} = W_{n/32}^{f m} W_MC^{t m}, an eighth root of
// unity.
// What bounds it on the H100: at 128 x 4096, K = 53 the bytes (2 MB, 0.6 us
// at 3.35 TB/s) and the operations (~0.02 GFLOP) are far below the time of
// a launch, so the design is about latency: one wave of 128 blocks, one per
// channel (splitting a channel over more blocks would repeat its staging
// and column DFTs and shorten no phase of its chain), the row in one bulk
// copy, four phases between barriers.
#define WD_THREADS 256
#define WD_WARPS (WD_THREADS / 32)
#define WD_ROWS 16
#define WD_NB 4  // bins of each of its residue classes a warp sums at once
#define WD_NCLS (16 / WD_WARPS)  // residue classes a warp takes

__global__ void twiddle_table_kernel(int n, float2* __restrict__ tab) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  double s, c;
  sincospi(2.0 * (double)j / (double)n, &s, &c);
  tab[j] = make_float2((float)c, (float)-s);
}

// tab (n,) float2: W_n^j = exp(-2 pi i j / n), float of the double value
extern "C" int twiddle_table_launch(int n, float* tab, void* stream) {
  twiddle_table_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      n, (float2*)tab);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// the 4-point DFT (W_4 = -i) of a[0..3] in place
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
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

// x[h], h < 16 -> x[r] = sum_h x[h] W_16^{r h}: h = 4 h1 + h2, r = r1 + 4 r2
__device__ __forceinline__ void dft16(float2 x[WD_ROWS]) {
  // W_16^k, k = r1 * h2 in 0..9 (float of the double values)
  const float2 w16[10] = {
      {1.0f, 0.0f},
      {0.92387953251128674f, -0.38268343236508977f},
      {0.70710678118654752f, -0.70710678118654752f},
      {0.38268343236508977f, -0.92387953251128674f},
      {0.0f, -1.0f},
      {-0.38268343236508977f, -0.92387953251128674f},
      {-0.70710678118654752f, -0.70710678118654752f},
      {-0.92387953251128674f, -0.38268343236508977f},
      {-1.0f, 0.0f},
      {-0.92387953251128674f, 0.38268343236508977f}};
#pragma unroll
  for (int h2 = 0; h2 < 4; ++h2) dft4(x[h2], x[4 + h2], x[8 + h2], x[12 + h2]);
  // now x[4 r1 + h2] = Y[h2][r1]; turn by W_16^{r1 h2}
#pragma unroll
  for (int r1 = 1; r1 < 4; ++r1)
#pragma unroll
    for (int h2 = 1; h2 < 4; ++h2)
      x[4 * r1 + h2] = cmul(x[4 * r1 + h2], w16[r1 * h2]);
#pragma unroll
  for (int r1 = 0; r1 < 4; ++r1)
    dft4(x[4 * r1], x[4 * r1 + 1], x[4 * r1 + 2], x[4 * r1 + 3]);
  // x[4 r1 + r2] = A[r1 + 4 r2]
}

// acc += u W_8^o, o = 0..7 known at compile time after unrolling: the
// quarter turns exactly, the odd eighths with one rounded sqrt(1/2)
__device__ __forceinline__ void acc_root8(float2& acc, float2 u, int o) {
  const float h = 0.70710678118654752f;
  switch (o & 7) {
    case 0: acc.x += u.x; acc.y += u.y; break;
    case 1: acc.x = fmaf(h, u.x + u.y, acc.x); acc.y = fmaf(h, u.y - u.x, acc.y); break;
    case 2: acc.x += u.y; acc.y -= u.x; break;
    case 3: acc.x = fmaf(h, u.y - u.x, acc.x); acc.y = fmaf(-h, u.x + u.y, acc.y); break;
    case 4: acc.x -= u.x; acc.y -= u.y; break;
    case 5: acc.x = fmaf(-h, u.x + u.y, acc.x); acc.y = fmaf(h, u.x - u.y, acc.y); break;
    case 6: acc.x -= u.y; acc.y += u.x; break;
    default: acc.x = fmaf(h, u.x - u.y, acc.x); acc.y = fmaf(h, u.x + u.y, acc.y); break;
  }
}

// the masked last-max over the lanes xor-reachable from off down to 1:
// the larger energy, and of equal ones the larger bin (the reference keeps
// the LAST maximal bin); every lane ends with the result
__device__ __forceinline__ void last_max(float& best, int& pk, int off) {
  for (; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int opk = __shfl_xor_sync(0xffffffffu, pk, off);
    if (ob > best || (ob == best && opk > pk)) {
      best = ob;
      pk = opk;
    }
  }
}

// one level of the lane reduction of v[0 .. 2H-1]: the lanes with bit OFF
// set keep the upper half, the others the lower, each adding its partner's
template <int H, int OFF, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float lo = v[j], hi = v[j + H];
    v[j] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, OFF);
  }
}

// MC > 0: the kernel for n = 512 MC (the narrowband path's n), whose
// column loop has a compile-time count; MC = 0: any n the plan takes
template <int MC>
__global__ void __launch_bounds__(WD_THREADS, 1)
    windowed_search_kernel(const int32_t* __restrict__ packed,
                           long long row_stride,
                           const int32_t* __restrict__ first1v,
                           const int32_t* __restrict__ wlenv, int n, int K,
                           int flip, float samprate, float binsize,
                           const float2* __restrict__ tab,
                           float2* __restrict__ spec, float* __restrict__ freq,
                           float* __restrict__ cyc,
                           long long* __restrict__ peak) {
  extern __shared__ __align__(16) unsigned char wd_smem[];
  const int C = n >> 4;       // columns
  const int N32 = n >> 5;     // entries of the broadcast table
  float2* A = (float2*)wd_smem;             // [16][C]
  int32_t* xs = (int32_t*)(A + n);          // [n] the staged row
  float2* tw32 = (float2*)(xs + n);         // [N32] W_n^{32 j}
  float2* tlo = tw32 + N32;                 // [32] W_n^j, j < 32
  float2* X = tlo + 32;                     // [K] bins, then the mbarrier
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int32_t* row = packed + (size_t)b * row_stride;
  const int first1 = first1v[b];  // loads in flight beside the row's
  const int wlen = wlenv == nullptr ? 0 : wlenv[b];

  // 1. stage the row: one bulk copy (TMA) completing on an mbarrier when
  //    the row is 16-byte aligned, else 4-byte cp.async copies; the
  //    twiddles W_n^{32 j} and W_n^j, j < 32, by cp.async beside it
  const unsigned xs_s = (unsigned)__cvta_generic_to_shared(xs);
  const unsigned mb_s = (unsigned)__cvta_generic_to_shared(X + K);
  const bool bulk = (((size_t)row) & 15) == 0;
  if (bulk && tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mb_s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb_s),
        "r"(4 * n)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(xs_s),
        "l"(row), "r"(4 * n), "r"(mb_s)
        : "memory");
  }
  if (!bulk) {
    for (int i = tid; i < n; i += WD_THREADS)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       xs_s + 4u * i),
                   "l"(row + i));
  }
  const unsigned tw_s = (unsigned)__cvta_generic_to_shared(tw32);
  for (int j = tid; j < N32 + 32; j += WD_THREADS)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     tw_s + 8u * j),
                 "l"(tab + (j < N32 ? 32 * j : j - N32)));
  asm volatile("cp.async.commit_group;\n" ::);
  if (bulk) {
    __syncthreads();  // the mbarrier is initialized; its copy in flight
    // each thread waits for the row's bytes (the twiddles are waited for
    // before the next barrier)
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "WD_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
        "@P1 bra WD_DONE;\n"
        "bra WD_WAIT;\n"
        "WD_DONE:\n"
        "}\n" ::"r"(mb_s)
        : "memory");
  } else {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  // 2. the column DFTs
  for (int c = tid; c < C; c += WD_THREADS) {
    float2 x[WD_ROWS];
#pragma unroll
    for (int h = 0; h < WD_ROWS; ++h) {
      float xr, xi;
      unpack_iq(xs[h * C + c], flip, xr, xi);
      x[h] = make_float2(xr, xi);
    }
    dft16(x);
#pragma unroll
    for (int r1 = 0; r1 < 4; ++r1)
#pragma unroll
      for (int r2 = 0; r2 < 4; ++r2) A[(r1 + 4 * r2) * C + c] = x[4 * r1 + r2];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // the twiddles
  __syncthreads();

  // 3. the K bins by residue class: the bins k = rho + 16 t share the row
  //    A[(first1 + rho) mod 16]; warp w takes the classes rho = w + 8 c,
  //    c < WD_NCLS, WD_NB bins of each at a time.  Phases are exact
  //    integers below their period, advanced by a compare and subtract.
  const int M = C >> 5, tail = C & 31;
  const int dq16 = 16 % N32, dph16 = (16 * lane) % n;
  constexpr int STEP = 16 * WD_NB;  // bins from one batch of a class to the next
  const int dqs = STEP % N32, dphs = (STEP * lane) % n;
  int rowc[WD_NCLS], qc[WD_NCLS], phc[WD_NCLS];  // per class: A row, f, f lane
#pragma unroll
  for (int c = 0; c < WD_NCLS; ++c) {
    int fm = first1 % n;
    if (fm < 0) fm += n;
    fm += warp + WD_WARPS * c;  // < n + 16 <= 2n
    if (fm >= n) fm -= n;
    rowc[c] = (fm & (WD_ROWS - 1)) * C + lane;
    qc[c] = fm % N32;
    phc[c] = (int)(((unsigned)fm * (unsigned)lane) % (unsigned)n);
  }
  float* Xf = (float*)X;
  float wbest = -INFINITY;  // the warp's masked last-max so far
  int wpk = 0;
  constexpr int NB = WD_NCLS * WD_NB;  // bins of a batch: i = WD_NB c + t
  for (int t0 = 0; 16 * t0 + warp < K; t0 += WD_NB) {
    int q[NB], qm[NB];  // bin i: k = warp + 8 c + 16 (t0 + t)
    float2 acc[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int t = i % WD_NB;
      q[i] = t == 0 ? qc[i / WD_NB] : q[i - 1] + dq16;
      if (q[i] >= N32) q[i] -= N32;
      acc[i] = make_float2(0.0f, 0.0f);
    }
    if constexpr (MC > 0) {
      // n = 512 MC: W_{n/32}^{(f + 16 t) m} = W_{n/32}^{f m} W_MC^{t m}, the
      // second factor an eighth root of unity fixed at compile time, so a
      // column step costs one table load and one complex product for a
      // class's four bins
      int qm0[WD_NCLS];  // (f m) mod N32
#pragma unroll
      for (int c = 0; c < WD_NCLS; ++c) qm0[c] = 0;
#pragma unroll
      for (int m = 0; m < MC; ++m) {
#pragma unroll
        for (int c = 0; c < WD_NCLS; ++c) {
          const float2 u = cmul(A[rowc[c] + 32 * m], tw32[qm0[c]]);
          qm0[c] = (qm0[c] + q[WD_NB * c]) & (16 * MC - 1);
#pragma unroll
          for (int t = 0; t < WD_NB; ++t)
            acc_root8(acc[WD_NB * c + t], u, ((t * m) % MC) * (8 / MC));
        }
      }
    } else {
      // software-pipelined: step m + 1's loads go out before step m's sums
      float2 a[WD_NCLS], w[NB];
#pragma unroll
      for (int c = 0; c < WD_NCLS; ++c) a[c] = A[rowc[c]];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        w[i] = tw32[0];
        qm[i] = q[i];  // (f (m + 1)) mod N32
      }
#pragma unroll 1
      for (int m = 0; m < M; ++m) {
        const int mn = m + 1 < M ? m + 1 : m;
        float2 an[WD_NCLS], wn[NB];
#pragma unroll
        for (int c = 0; c < WD_NCLS; ++c) an[c] = A[rowc[c] + 32 * mn];
#pragma unroll
        for (int i = 0; i < NB; ++i) wn[i] = tw32[qm[i]];
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const float2 ai = a[i / WD_NB];
          acc[i].x = fmaf(ai.x, w[i].x, fmaf(-ai.y, w[i].y, acc[i].x));
          acc[i].y = fmaf(ai.x, w[i].y, fmaf(ai.y, w[i].x, acc[i].y));
          const int nq = qm[i] + q[i];
          qm[i] = nq >= N32 ? nq - N32 : nq;
          w[i] = wn[i];
        }
#pragma unroll
        for (int c = 0; c < WD_NCLS; ++c) a[c] = an[c];
      }
      if (lane < tail) {  // the ragged last columns (32 does not divide C)
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const float2 at = A[rowc[i / WD_NB] + 32 * M];
          int qt = qm[i] - q[i];  // (f M) mod N32: one step back
          if (qt < 0) qt += N32;
          const float2 wt = tw32[qt];
          acc[i].x += at.x * wt.x - at.y * wt.y;
          acc[i].y += at.x * wt.y + at.y * wt.x;
        }
      }
    }
    // turn by W_n^{f lane} = W_n^{32 (p >> 5)} W_n^{p & 31}, p = f lane mod n
    float v[2 * NB];
#pragma unroll
    for (int c = 0; c < WD_NCLS; ++c) {
      int p = phc[c];
#pragma unroll
      for (int t = 0; t < WD_NB; ++t) {
        const float2 r =
            cmul(acc[WD_NB * c + t], cmul(tw32[p >> 5], tlo[p & 31]));
        v[2 * (WD_NB * c + t)] = r.x;
        v[2 * (WD_NB * c + t) + 1] = r.y;
        p += dph16;
        if (p >= n) p -= n;
      }
    }
    // reduce the 2 NB sums over the lanes in halves (2 NB shuffles), after
    // which lane SPAN j holds sum j (bin j/2, real or imaginary part)
    constexpr int SPAN = 32 / (2 * NB);
    halve<NB, 16>(v, lane);
    halve<NB / 2, 8>(v, lane);
    halve<NB / 4, 4>(v, lane);
    if constexpr (NB >= 8) halve<NB / 8, 2>(v, lane);
    for (int off = SPAN / 2; off > 0; off >>= 1)
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    const int i = lane / (2 * SPAN);
    const int k = warp + WD_WARPS * (i / WD_NB) + 16 * (t0 + i % WD_NB);
    if (lane % SPAN == 0 && k < K) Xf[2 * k + (lane / SPAN) % 2] = v[0];
    // the peak pass's masked energies (lane 2 SPAN i: bin i's real part,
    // SPAN lanes up its imaginary part), rounded as the plain version
    // rounds them
    const float im = __shfl_down_sync(0xffffffffu, v[0], SPAN);
    if (lane % (2 * SPAN) == 0 && k < K) {
      const float e = __fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(im, im));
      const float mk = (k >= 1 && k < wlen + 1) ? e : -1.0f;
      if (mk >= wbest) {  // ">=": the LAST maximal bin
        wbest = mk;
        wpk = k;
      }
    }
#pragma unroll
    for (int c = 0; c < WD_NCLS; ++c) {
      qc[c] += dqs;
      if (qc[c] >= N32) qc[c] -= N32;
      phc[c] += dphs;
      if (phc[c] >= n) phc[c] -= n;
    }
  }
  // each warp's candidate for the peak: the last maximal of its bins
  float* cand = (float*)(X + K + 1);  // [WD_WARPS] energies, then bins
  last_max(wbest, wpk, 16);
  if (lane == 0) {
    cand[warp] = wbest;
    ((int*)cand)[WD_WARPS + warp] = wpk;
  }
  __syncthreads();
  if (warp > 0)  // warp 0 goes straight on to the peak
    for (int k = tid - 32; k < K; k += WD_THREADS - 32)
      spec[(size_t)b * K + k] = X[k];
  if (wlenv == nullptr || warp != 0) return;

  // 4. masked last-max peak over the warps' candidates + Quinn (warp 0)
  float best = lane < WD_WARPS ? cand[lane] : -INFINITY;
  int pk = lane < WD_WARPS ? ((int*)cand)[WD_WARPS + lane] : 0;
  last_max(best, pk, WD_WARPS / 2);
  if (lane == 0) {
    const float fr = quinn_freq(X[pk], X[min(pk + 1, K - 1)], X[max(pk - 1, 0)],
                                first1 + pk, samprate, binsize);
    freq[b] = fr;
    cyc[b] = __fdiv_rn(fr, samprate);
    peak[b] = (long long)first1 + pk;
  }
}

// K8.  packed (B rows of n words, row stride row_stride), first1 (B,) int32
// window start bins, tab (n,) float2 from twiddle_table_launch -> spec
// (B, K) float2, bins first1 .. first1+K-1.  With wlen (B,) int32 non-NULL
// the peak pass follows in the same launch: freq (B,) f32 Hz, cyc (B,) f32
// cycles/sample and peak (B,) int64 bins.  smem: the bytes the wrapper's
// plan gives (carrier_cuda.windowed_search_plan); the shared-memory limit
// is raised once per device.
template <int MC>
static cudaError_t windowed_search_go(const int32_t* packed,
                                      long long row_stride,
                                      const int32_t* first1,
                                      const int32_t* wlen, int B, int n, int K,
                                      int flip, float samprate, float binsize,
                                      const float* tab, int smem, float* spec,
                                      float* freq, float* cyc,
                                      long long* peak, cudaStream_t stream) {
  static unsigned configured = 0u;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(windowed_search_kernel<MC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);
    if (err != cudaSuccess) return err;
    if (dev < 32) configured |= 1u << dev;
  }
  windowed_search_kernel<MC><<<B, WD_THREADS, smem, stream>>>(
      packed, row_stride, first1, wlen, n, K, flip, samprate, binsize,
      (const float2*)tab, (float2*)spec, freq, cyc, peak);
  return cudaGetLastError();
}

extern "C" int windowed_dft_launch(const int32_t* packed, long long row_stride,
                                   const int32_t* first1, const int32_t* wlen,
                                   int B, int n, int K, int flip,
                                   float samprate, float binsize,
                                   const float* tab, int smem, float* spec,
                                   float* freq, float* cyc, long long* peak,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define WD_GO(MC)                                                          \
  return (int)windowed_search_go<MC>(packed, row_stride, first1, wlen, B, n, \
                                     K, flip, samprate, binsize, tab, smem,  \
                                     spec, freq, cyc, peak, s);
  switch (n) {
    case 512: WD_GO(1)
    case 1024: WD_GO(2)
    case 2048: WD_GO(4)
    case 4096: WD_GO(8)
    default: WD_GO(0)
  }
#undef WD_GO
}

// ---- K9: the whole pm block loop in one launch --------------------------
// Replaces the TPU kernel _scan_kernel (isee3_decoder_tpu/ops/
// carrier_pallas.py:363, entry pm_scan_locked_fused): for t = 1 .. T-1 the
// locked block step of K1 -- window from the carried centre and C/N0, the
// K window bins, masked last-max peak + Quinn, five-moment spin-down,
// rotation and int16 emission -- with the exclusive int32 prefix sum of
// the baseband written in place of the baseband.  Block 0 (the cold start,
// computed before the launch) only enters the prefix sum and the carry.
//
// The TPU walks a (B/8, T) grid in order and carries the centre, C/N0 and
// running sum in VMEM scratch from one grid step to the next.  Here the
// loop over t runs inside one block per channel (grid B), with the carry in
// shared memory and registers; the host reads one flag per call instead of
// one per block.  Per t:
//   window    thread 0, in float32 as the TPU kernel does it (true
//             division, so the ok lanes and windows equal the plain
//             version's); a channel whose window fails gets ok 0 and safe
//             phases, and the caller discards the whole call for the block
//             scan.
//   DFT       the split i = C h + m (h < 256 rows, m < C = n/256 columns):
//             X[f] = sum_m W_n^{f m} Y_m[f mod 256], Y_m the 256-point DFT
//             of column m by two 16-point stages (column_dft256_pass),
//             CD_COLS columns per pass; the outer sum over the passes in
//             registers, a warp's lanes the pass's columns, its bins
//             k = warp + 16 j (outer_sum_pass), the pass's twiddles staged
//             in shared memory one pass ahead and its columns prefetched
//             into the L2 one pass ahead; bins in shared memory.
//   peak      warp 0: masked last-max by a shuffle reduction (equal
//             energies keep the larger bin), then Quinn in lane 0.
//   moments   every thread, float partials over 16 samples summed in
//             double, a fixed-order block reduction.
//   emission  SCAN_ITEMS consecutive samples per thread, a block-wide scan
//             of the int16 values in uint32 (the int32 wraparound of K3),
//             the running sum in a register of every thread.
// What bounds it on the H100: the bytes (packed in, int32 out: 2.15 GB at
// 128 x 32 x 65536, 0.64 ms) stream from HBM once; the DFT is ~2·10^6 flop
// per block and channel (two radix-16 stages per column, 8 flop per column
// and bin in the outer sum), the spin passes one precise sincosf per
// sample each, read from the L2.  One block per SM: B = 128 is one wave on
// 132 SMs, so nothing else hides the block's latency.  Clocked per phase
// on an H100 (utils/k9_phases.py): the emission takes about half of each
// block t, the moments a third, the DFT a fifth; most of the emission's
// extra time over the moments goes to its int32 stores (8 consecutive
// words per thread: each warp store touches 32 sectors).
#define SCAN_THREADS 512
#define SCAN_WARPS (SCAN_THREADS / 32)
#define SCAN_ITEMS 8
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)
#define CD_COLS 32                    // columns of a pass: a warp's lanes
#define CD_NBW 8                      // bins of a warp in one round
#define CD_BINS (SCAN_WARPS * CD_NBW)  // bins of a round

// One pass of the 256-point column DFTs, for SCAN_THREADS threads: columns
// m0 .. m0 + CD_COLS - 1 of the row (C columns, sample i = C h + m) ->
// Ys[r * CD_COLS + mc] = Y_{m0 + mc}[r] = sum_h x[C h + m0 + mc] W_256^{r h}.
// h = 16 h1 + h0, r = r0 + 16 r1:
//   Y[r0 + 16 r1] = sum_h0 W_16^{r1 h0} W_256^{r0 h0} sum_h1 x[16 h1 + h0] W_16^{r0 h1}
// Thread (lane mc, warp w): stage 1 over h1 for h0 = w (each load a warp's
// 32 consecutive words), turned by W_256^{r0 w} (tw256[j] = W_256^j), into
// T[(r0 * 16 + h0) * CD_COLS + mc] (16 x 16 x CD_COLS float2); a barrier;
// stage 2 over h0 for r0 = w into Ys; a barrier.  The caller must be done
// reading Ys when it calls (the first barrier keeps the writes behind it).
// chirp: NULL (K9), or K1's n de-chirp phasors, indexed like the row, that
// rotate each sample before its DFT (dft_columns' rounding, op by op).
__device__ __forceinline__ void column_dft256_pass(const int32_t* __restrict__ row,
                                                   int C, int m0, int flip,
                                                   const float2* tw256,
                                                   float2* T, float2* Ys,
                                                   const float2* __restrict__ chirp =
                                                       nullptr) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // the next pass's columns on their way into the L2: row h = threadIdx.x
  if (m0 + CD_COLS < C && threadIdx.x < 256)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(row + (size_t)C * threadIdx.x +
                                                   m0 + CD_COLS));
  float2 x[16];
#pragma unroll
  for (int h1 = 0; h1 < 16; ++h1) {
    const size_t i = (size_t)C * (16 * h1 + w) + m0 + lane;
    float xr, xi;
    unpack_iq(row[i], flip, xr, xi);
    if (chirp != nullptr) {
      const float2 d = chirp[i];
      const float r = __fsub_rn(__fmul_rn(xr, d.x), __fmul_rn(xi, d.y));
      xi = __fadd_rn(__fmul_rn(xr, d.y), __fmul_rn(xi, d.x));
      xr = r;
    }
    x[h1] = make_float2(xr, xi);
  }
  dft16(x);  // x[4 a + b] = Z[a + 4 b]
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r0 = a + 4 * b;
      T[(r0 * 16 + w) * CD_COLS + lane] = cmul(x[4 * a + b], tw256[r0 * w]);
    }
  __syncthreads();
#pragma unroll
  for (int h0 = 0; h0 < 16; ++h0) x[h0] = T[(w * 16 + h0) * CD_COLS + lane];
  dft16(x);  // x[4 a + b] = Y[w + 16 (a + 4 b)]
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      Ys[(w + 16 * (a + 4 * b)) * CD_COLS + lane] = x[4 * a + b];
  __syncthreads();
}

// The twiddle W_n^{32 p u_j} of pass p for bin slot (warp sw, slot j) of a
// round, u_j = (u0 + 16 j) mod n with u0 = (first1 + k0 + sw) mod n:
// 32 p u_j = 32 p u0 + 512 p j (mod n), and 512 p j < n/2 (p < n/8192,
// j < 8), so one subtract keeps the phase exact.  base = (32 p u0) mod n.
__device__ __forceinline__ float2 pass_twiddle(const float2* __restrict__ tab,
                                               int n, int p, int j, int base) {
  int ph = base + 512 * p * j;
  if (ph >= n) ph -= n;
  return __ldg(tab + ph);
}

// The outer sum's share of a pass for the warp's bins j < CD_NBW: lane mc
// adds W_n^{32 p u_j} Y_{32 p + mc}[u_j mod 256] to acc[j] (pw[j]: the
// pass's twiddles, staged in shared memory); the lane's own factor
// W_n^{u_j mc} is applied once, after the last pass (outer_sum_finish).
__device__ __forceinline__ void outer_sum_pass(const float2* Ys,
                                               const float2* pw, int u0,
                                               float2 acc[CD_NBW]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < CD_NBW; ++j) {
    const float2 y = Ys[((u0 + 16 * j) & 255) * CD_COLS + lane];
    const float2 wv = pw[j];
    acc[j].x = fmaf(y.x, wv.x, fmaf(-y.y, wv.y, acc[j].x));
    acc[j].y = fmaf(y.x, wv.y, fmaf(y.y, wv.x, acc[j].y));
  }
}

// Bin j's lane factor W_n^{u_j lane} (u_j lane < 32 n: exact in int32),
// then the sum over the warp's lanes; lane 0 stores bin k0 + 16 j when it
// is below K.
__device__ __forceinline__ void outer_sum_finish(const float2* __restrict__ tab,
                                                 int n, int u0, int k0, int K,
                                                 float2 acc[CD_NBW],
                                                 float2* spec) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < CD_NBW; ++j) {
    int u = u0 + 16 * j;
    if (u >= n) u -= n;
    float2 v = cmul(acc[j], __ldg(tab + (int)(((unsigned)u * (unsigned)lane) %
                                              (unsigned)n)));
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
    }
    if (lane == 0 && k0 + 16 * j < K) spec[k0 + 16 * j] = v;
  }
}

struct ScanParams {
  float samprate, binsize, width, thr, top;  // top = fs/2 - binsize, float32
  int wmax;                                  // K, the window bins evaluated
};

// Exclusive scan of the per-thread sums `run` over the block (uint32,
// wrapping).  Returns this thread's offset; `tile` gets the block total.
// scratch: SCAN_WARPS + 1 words.  Ends with a barrier, so scratch may be
// reused right away.
__device__ __forceinline__ uint32_t block_scan(uint32_t run, uint32_t* scratch,
                                               uint32_t& tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    uint32_t up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < SCAN_WARPS ? scratch[lane] : 0u;
    uint32_t wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      uint32_t up = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += up;
    }
    if (lane < SCAN_WARPS) scratch[lane] = wi - w;  // exclusive warp offsets
    if (lane == 31) scratch[SCAN_WARPS] = wi;
  }
  __syncthreads();
  const uint32_t off = scratch[warp] + (incl - run);
  tile = scratch[SCAN_WARPS];
  __syncthreads();
  return off;
}

__global__ void __launch_bounds__(SCAN_THREADS, 1)
    pm_scan_kernel(const int32_t* __restrict__ packed, long long row_stride,
                   const int16_t* __restrict__ bb0,
                   const float* __restrict__ init, int T, int n, int flip,
                   ScanParams P, int tail, const float2* __restrict__ tab,
                   int32_t* __restrict__ csum, float* __restrict__ stat,
                   int32_t* __restrict__ tot) {
  extern __shared__ float2 smem[];
  const int C = n >> 8;  // columns of the split, a multiple of CD_COLS
  const int K = P.wmax;
  float2* Tx = smem;                       // 16 x 16 x CD_COLS stage-1 tile
  float2* Ys = Tx + 256 * CD_COLS;         // 256 x CD_COLS column DFTs
  float2* tw256 = Ys + 256 * CD_COLS;      // W_256^j
  float2* pw = tw256 + 256;                // 2 x CD_BINS pass twiddles
  float2* spec = pw + 2 * CD_BINS;         // K window bins
  __shared__ double mred[SCAN_WARPS][5];
  __shared__ uint32_t scratch[SCAN_WARPS + 1];
  __shared__ float s_center, s_cn0, s_freq, s_cyc, s_amp, s_cn0new, s_ur, s_ui;
  __shared__ int s_first1, s_wlen, s_ok;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long ldc = (long long)T * n + tail;
  int32_t* crow = csum + (size_t)b * ldc;
  float* srow = stat + (size_t)b * T * 6;

  dft_twiddles(tw256, 256);
  if (tid == 0) {
    const float* in = init + 4 * b;  // amp, cn0, freq, centre after block 0
    s_center = in[3];
    s_cn0 = in[1];
    srow[0] = in[0];
    srow[1] = in[1];
    srow[2] = in[2];
    srow[3] = 1.0f;  // block 0 is the cold start: ok by definition
    srow[4] = 0.0f;
    srow[5] = in[3];
  }
  // block 0: the prefix sum of the cold-start baseband
  uint32_t carry = 0;
  for (int base = 0; base < n; base += SCAN_TILE) {
    int v[SCAN_ITEMS];
    uint32_t run = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const int idx = base + tid * SCAN_ITEMS + k;
      v[k] = idx < n ? (int)bb0[(size_t)b * n + idx] : 0;
      run += (uint32_t)v[k];
    }
    uint32_t tile;
    uint32_t acc = carry + block_scan(run, scratch, tile);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const int idx = base + tid * SCAN_ITEMS + k;
      if (idx < n) crow[idx] = (int32_t)acc;
      acc += (uint32_t)v[k];
    }
    carry += tile;
  }

  const Chirp none = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 1; t < T; ++t) {
    const int32_t* row = packed + (size_t)b * row_stride + (size_t)t * n;
    // ---- window: the per-channel _fast_search_ok, in float32
    if (tid == 0) {
      const float lo = __fsub_rn(s_center, P.width);
      const float hi = __fadd_rn(s_center, P.width);
      const int first = (int)truncf(__fdiv_rn(lo, P.binsize));
      const int last = (int)truncf(__fdiv_rn(hi, P.binsize));
      const bool ok = s_cn0 > P.thr && lo >= P.binsize && hi < P.top &&
                      first >= 1 && last > first && last - first <= K - 2;
      s_first1 = (ok ? first : 1) - 1;
      s_wlen = ok ? last - first : 1;
      s_ok = ok;
    }
    __syncthreads();
    const int first1 = s_first1;

    // ---- the K window bins, CD_BINS a round: column DFTs pass by pass,
    //      the outer sum in registers
    for (int k0 = 0; k0 < K; k0 += CD_BINS) {
      if (k0 > 0) __syncthreads();  // the last round's readers of pw are done
      const int u0 = (int)(((long long)first1 + k0 + warp) % n + n) % n;
      float2 acc[CD_NBW];
#pragma unroll
      for (int j = 0; j < CD_NBW; ++j) acc[j] = make_float2(0.0f, 0.0f);
      // the pass twiddles, one slot (warp sw, slot sj) per thread below
      // CD_BINS, double-buffered in pw: pass p + 1's load is in flight
      // during pass p's column DFTs, its store lands behind pass p + 1's
      // first barrier
      const int sw = tid / CD_NBW, sj = tid % CD_NBW;
      const int su0 = (int)(((long long)first1 + k0 + sw) % n + n) % n;
      const int sd = (int)((32LL * su0) % n);  // sbase's step per pass
      int sbase = 0;
      if (tid < CD_BINS) pw[tid] = pass_twiddle(tab, n, 0, sj, 0);
      for (int p = 0; p < C / CD_COLS; ++p) {
        float2 nxt = make_float2(0.0f, 0.0f);
        const bool more = tid < CD_BINS && p + 1 < C / CD_COLS;
        if (more) {
          sbase += sd;
          if (sbase >= n) sbase -= n;
          nxt = pass_twiddle(tab, n, p + 1, sj, sbase);
        }
        column_dft256_pass(row, C, CD_COLS * p, flip, tw256, Tx, Ys);
        outer_sum_pass(Ys, pw + (p & 1) * CD_BINS + warp * CD_NBW, u0, acc);
        if (more) pw[((p + 1) & 1) * CD_BINS + tid] = nxt;
      }
      outer_sum_finish(tab, n, u0, k0 + warp, K, acc, spec);
    }
    __syncthreads();

    // ---- masked last-max peak + Quinn (warp 0)
    if (warp == 0) {
      const int wlen = s_wlen;
      float best = -INFINITY;
      int pk = 0;
      for (int k = lane; k < K; k += 32) {
        const float e = spec[k].x * spec[k].x + spec[k].y * spec[k].y;
        const float m = (k >= 1 && k < wlen + 1) ? e : -1.0f;
        if (m >= best) {
          best = m;
          pk = k;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int opk = __shfl_xor_sync(0xffffffffu, pk, off);
        if (ob > best || (ob == best && opk > pk)) {  // the LAST maximal bin
          best = ob;
          pk = opk;
        }
      }
      if (lane == 0) {
        const float freq = quinn_freq(spec[pk], spec[min(pk + 1, K - 1)],
                                      spec[max(pk - 1, 0)], first1 + pk,
                                      P.samprate, P.binsize);
        s_freq = freq;
        s_cyc = __fdiv_rn(freq, P.samprate);
      }
    }
    __syncthreads();
    const float c = s_cyc;
    const float c256 = mod1(c * 256.0f);

    // ---- spin-down moments
    double acc[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
    for (int base = 0; base < n; base += SCAN_THREADS * 16) {
      float a[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const int idx = base + j * SCAN_THREADS + tid;
        if (idx < n) {
          float sr, si;
          spun_sample(row[idx], idx, c, c256, false, none, flip, sr, si);
          a[0] += sr;
          a[1] += si;
          a[2] += sr * sr;
          a[3] += si * si;
          a[4] += sr * si;
        }
      }
#pragma unroll
      for (int m = 0; m < 5; ++m) acc[m] += (double)a[m];
    }
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      double v = acc[m];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) mred[warp][m] = v;
    }
    __syncthreads();
    if (tid == 0) {
      double s[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
      for (int w = 0; w < SCAN_WARPS; ++w)
        for (int m = 0; m < 5; ++m) s[m] += mred[w][m];
      finish_moments(s, n, P.samprate, s_amp, s_cn0new, s_ur, s_ui);
    }
    __syncthreads();
    const float ur = s_ur, ui = s_ui;

    // ---- rotate, emit, prefix sum
    int32_t* dst = crow + (size_t)t * n;
    for (int base = 0; base < n; base += SCAN_TILE) {
      int v[SCAN_ITEMS];
      uint32_t run = 0;
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int idx = base + tid * SCAN_ITEMS + k;
        v[k] = 0;
        if (idx < n) {
          float sr, si;
          spun_sample(row[idx], idx, c, c256, false, none, flip, sr, si);
          v[k] = emit_sample(sr, si, ur, ui);
        }
        run += (uint32_t)v[k];
      }
      uint32_t tile;
      uint32_t acc2 = carry + block_scan(run, scratch, tile);
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int idx = base + tid * SCAN_ITEMS + k;
        if (idx < n) dst[idx] = (int32_t)acc2;
        acc2 += (uint32_t)v[k];
      }
      carry += tile;
    }

    // ---- stats and the carry into block t+1
    if (tid == 0) {
      const float cn0 = s_cn0new;
      const float centre = cn0 > P.thr ? s_freq : s_center;
      float* st = srow + (size_t)t * 6;
      st[0] = s_amp;
      st[1] = cn0;
      st[2] = s_freq;
      st[3] = s_ok ? 1.0f : 0.0f;
      st[4] = centre;
      st[5] = centre;
      s_center = centre;
      s_cn0 = cn0;
    }
    __syncthreads();
  }
  for (int j = tid; j < tail; j += SCAN_THREADS)
    crow[(size_t)T * n + j] = (int32_t)carry;
  if (tid == 0) tot[b] = (int32_t)carry;
}

// K9.  packed (B, T, n) int32 words, channel stride row_stride, block
// stride n; bb0 (B, n) int16 block-0 baseband; init (B, 4) f32 [amp, cn0,
// freq, centre after block 0]; outputs csum (B, T*n + tail) int32 (columns
// past T*n hold the total), stat (B, T, 6) f32 [amp, cn0, freq, ok, centre,
// centre] (block 0: [init..., 1, 0, centre]), tot (B,) int32.  n must be a
// multiple of 256 CD_COLS; tab (n,) float2 from twiddle_table_launch; smem:
// the bytes of the wrapper's plan (carrier_cuda.pm_scan_plan).
extern "C" int pm_scan_launch(const int32_t* packed, long long row_stride,
                              const int16_t* bb0, const float* init, int B,
                              int T, int n, int K, float samprate,
                              float binsize, float width, float thr, float top,
                              int flip, int tail, const float* tab, int smem,
                              int32_t* csum, float* stat, int32_t* tot,
                              void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ScanParams P = {samprate, binsize, width, thr, top, K};
  pm_scan_kernel<<<B, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
      packed, row_stride, bb0, init, T, n, flip, P, tail, (const float2*)tab,
      csum, stat, tot);
  return (int)cudaGetLastError();
}

// ---- K1's search for n a multiple of 256 CD_COLS: one launch -----------
// The K window bins by K9's split i = C h + m (column_dft256_pass,
// outer_sum_pass with the pass twiddles staged a pass ahead,
// outer_sum_finish), the de-chirp (chirp non-NULL) rotating the samples
// inside the column passes, then in the same block the masked last-max
// peak (a warp shuffle; equal energies keep the larger bin) and Quinn's
// estimator.  One block of SCAN_THREADS threads per channel (grid B).  The
// window starts at first1 = iw[2 b] (negative, or within K of n: bins are
// taken mod n) and is K bins long, CD_BINS a round; wlen = iw[2 b + 1].
// Writes stat[4 b + 2 .. 3] (freq, peak bin) and cyc[b] as peak_kernel
// does.
__global__ void __launch_bounds__(SCAN_THREADS, 1)
    locked_search_kernel(const int32_t* __restrict__ packed, int row_stride,
                         const int32_t* __restrict__ iw, int n, int K,
                         int flip, const float2* __restrict__ chirp,
                         float samprate, float binsize,
                         const float2* __restrict__ tab,
                         float* __restrict__ stat, float* __restrict__ cyc) {
  extern __shared__ float2 smem[];
  const int C = n >> 8;  // columns of the split, a multiple of CD_COLS
  float2* Tx = smem;                    // 16 x 16 x CD_COLS stage-1 tile
  float2* Ys = Tx + 256 * CD_COLS;      // 256 x CD_COLS column DFTs
  float2* tw256 = Ys + 256 * CD_COLS;   // W_256^j
  float2* pw = tw256 + 256;             // 2 x CD_BINS pass twiddles
  float2* spec = pw + 2 * CD_BINS;      // K window bins
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int32_t* row = packed + (size_t)b * row_stride;
  const int first1 = iw[2 * b];

  // W_256^j = W_n^{C j}: the table holds the same double value rounded
  if (tid < 256) tw256[tid] = __ldg(tab + C * tid);
  for (int k0 = 0; k0 < K; k0 += CD_BINS) {
    __syncthreads();  // tw256 is in place; the last round's readers of pw are done
    const int u0 = (int)(((long long)first1 + k0 + warp) % n + n) % n;
    float2 acc[CD_NBW];
#pragma unroll
    for (int j = 0; j < CD_NBW; ++j) acc[j] = make_float2(0.0f, 0.0f);
    // the pass twiddles, double-buffered in pw as in pm_scan_kernel
    const int sw = tid / CD_NBW, sj = tid % CD_NBW;
    const int su0 = (int)(((long long)first1 + k0 + sw) % n + n) % n;
    const int sd = (int)((32LL * su0) % n);  // sbase's step per pass
    int sbase = 0;
    if (tid < CD_BINS) pw[tid] = pass_twiddle(tab, n, 0, sj, 0);
    for (int p = 0; p < C / CD_COLS; ++p) {
      float2 nxt = make_float2(0.0f, 0.0f);
      const bool more = tid < CD_BINS && p + 1 < C / CD_COLS;
      if (more) {
        sbase += sd;
        if (sbase >= n) sbase -= n;
        nxt = pass_twiddle(tab, n, p + 1, sj, sbase);
      }
      column_dft256_pass(row, C, CD_COLS * p, flip, tw256, Tx, Ys, chirp);
      outer_sum_pass(Ys, pw + (p & 1) * CD_BINS + warp * CD_NBW, u0, acc);
      if (more) pw[((p + 1) & 1) * CD_BINS + tid] = nxt;
    }
    outer_sum_finish(tab, n, u0, k0 + warp, K, acc, spec);
  }
  __syncthreads();
  if (warp != 0) return;

  // ---- masked last-max peak + Quinn (warp 0); energies rounded as the
  //      plain version rounds them
  const int wlen = iw[2 * b + 1];
  float best = -INFINITY;
  int pk = 0;
  for (int k = lane; k < K; k += 32) {
    const float2 v = spec[k];
    const float e = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
    const float m = (k >= 1 && k < wlen + 1) ? e : -1.0f;
    if (m >= best) {  // ">=": the LAST maximal bin
      best = m;
      pk = k;
    }
  }
  last_max(best, pk, 16);
  if (lane == 0) {
    const float freq = quinn_freq(spec[pk], spec[min(pk + 1, K - 1)],
                                  spec[max(pk - 1, 0)], first1 + pk, samprate,
                                  binsize);
    stat[4 * b + 2] = freq;
    stat[4 * b + 3] = (float)(first1 + pk);
    cyc[b] = __fdiv_rn(freq, samprate);
  }
}

// K1.  packed (B rows of n words, row stride row_stride), iw (B, 2) int32
// [first1, wlen]; dop: de-chirp rate in cycles/sample^2 (0: none) with
// chirp its n phasors (NULL when dop == 0); outputs bb (B, n) int16,
// stat (B, 4) f32 [amp, cn0, freq, peak]; scratch cyc (B,) f32 and, on
// the "two_pass" spin design only, mom (B, ceil(n/SPIN_CHUNK), 5) f64.
// The search takes one of two designs, chosen by the wrapper's plan
// (carrier_cuda.pm_locked_plan):
//   tab non-NULL ("columns", n a multiple of 256 CD_COLS):
//     locked_search_kernel with tab (n,) float2 from twiddle_table_launch
//     and smem the plan's bytes;
//   tab NULL ("direct"): dft_kernel + peak_kernel with the scratch spec
//     (B, K) float2 and smem the plan's bytes ((n/256 + 128) float2: the
//     rows' twiddles and the warps' partial bins).
// Then the spin-down at the cycles the search wrote, in the design of
// carrier_cuda.spin_plan: spin_cluster_kernel (spin_cluster clusters of
// spin_threads threads) or, spin_cluster 0, moments_kernel + emit_kernel.
extern "C" int pm_locked_launch(const int32_t* packed, int row_stride,
                                const int32_t* iw, int B, int n, int K,
                                float samprate, float binsize, int flip,
                                double dop, const float* chirp,
                                const float* tab, int smem, int spin_cluster,
                                int spin_threads, int16_t* bb, float* stat,
                                float* spec, float* cyc, double* mom,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (tab != nullptr) {
    // the block's limit less the 1 KB the plan keeps for static shared
    // memory (carrier_cuda._SCAN_STATIC_SMEM), once per device
    static unsigned configured = 0u;  // one bit per device
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 32 || !(configured & (1u << dev))) {
      err = cudaFuncSetAttribute(locked_search_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 232448 - 1024);
      if (err != cudaSuccess) return (int)err;
      if (dev < 32) configured |= 1u << dev;
    }
    locked_search_kernel<<<B, SCAN_THREADS, smem, s>>>(
        packed, row_stride, iw, n, K, flip, (const float2*)chirp, samprate,
        binsize, (const float2*)tab, stat, cyc);
  } else {
    err = cudaFuncSetAttribute(
        dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((K + DFT_KT - 1) / DFT_KT, B);
    dft_kernel<<<grid, DFT_THREADS, smem, s>>>(packed, row_stride, iw, 2, n, K,
                                               flip, (const float2*)chirp,
                                               (float2*)spec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    peak_kernel<<<(B + 127) / 128, 128, 0, s>>>((const float2*)spec, iw, B, K,
                                                samprate, binsize, stat, cyc);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)spin_launch(packed, row_stride, cyc, 0, B, n, samprate, flip,
                          dop, spin_cluster, spin_threads, bb, stat, 4, mom,
                          s);
}
