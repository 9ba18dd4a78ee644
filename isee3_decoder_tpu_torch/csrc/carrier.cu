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
// What bounds it on the H100: the DFT pass is ~n*K complex MACs per
// channel (7.3e6 at n = 65536, K = 107: ~1 GFLOP for 128 channels), the
// spin passes one full-precision sincosf per sample per pass; the bytes
// are 4 per sample per pass (~34 MB for 128 x 65536).  Neither comes
// near the card's roofline at these sizes, so launch count and the
// number of in-flight blocks set the time.  The design keeps every
// phase exact (integer products reduced mod their period, the two-level
// reduction c256*(i/256) + c*(i%256) of the JAX package's _lo_ramp),
// uses the precise sincosf (no fast-math: __sinf/__cosf are wrong at
// these angles), and splits the cross-sample reductions into a
// per-chunk partial pass plus a tiny finishing step instead of holding
// a whole channel in one block:
//   dft_kernel     grid (bin tiles, B): thread = column l of i = 256h + l,
//                  inner sum over h with a shared twiddle table, outer
//                  twiddle per (bin, l), block reduction over l.
//   peak_kernel    one thread per channel: peak, Quinn, carrier phase step.
//   moments_kernel grid (chunks, B): partial sums of the five moments
//                  of the spun samples, in double across threads.
//   emit_kernel    grid (chunks, B): finishes the moments (every block
//                  the same way, in the same order), recomputes the spun
//                  samples and writes int16.  The spun samples are
//                  recomputed rather than stored: 8 bytes/sample of HBM
//                  round trip cost more than one more sincosf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---- K1 pass 1: windowed DFT -------------------------------------------
// spec[b][k] = sum_i x[i] exp(-2 pi j f i / n), f = first1_b + k, by the
// split X[f] = sum_l W_n^{f l} sum_h x[256h+l] W_nhi^{(f mod nhi) h}.
// chirp: NULL, or n de-chirp phasors exp(-2 pi j phi(i)) that rotate the
// DATA first (the chirp phase has an h*l cross term, so it cannot fold
// into the two DFT factors).
__global__ void dft_kernel(const int32_t* __restrict__ packed, int row_stride,
                           const int32_t* __restrict__ iw, int n, int K,
                           int flip, const float2* __restrict__ chirp,
                           float2* __restrict__ spec) {
  extern __shared__ float2 smem[];
  const int nhi = n >> 8;
  float2* tw = smem;                    // nhi twiddles W_nhi^j
  float2* red = smem + nhi;             // (DFT_THREADS/32) x DFT_KT partials
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * DFT_KT;
  const int l = threadIdx.x;
  const int first1 = iw[2 * b];

  for (int j = threadIdx.x; j < nhi; j += blockDim.x) {
    double s, c;
    sincospi(2.0 * (double)j / (double)nhi, &s, &c);
    tw[j] = make_float2((float)c, (float)-s);
  }
  __syncthreads();

  int q[DFT_KT], idx[DFT_KT];
  float ar[DFT_KT], ai[DFT_KT];
#pragma unroll
  for (int k = 0; k < DFT_KT; ++k) {
    int f = first1 + k0 + k;
    int fm = f % nhi;
    q[k] = fm < 0 ? fm + nhi : fm;
    idx[k] = 0;
    ar[k] = 0.0f;
    ai[k] = 0.0f;
  }
  const int32_t* row = packed + (size_t)b * row_stride;
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
  const int warp = l >> 5, lane = l & 31;
#pragma unroll
  for (int k = 0; k < DFT_KT; ++k) {
    int f = first1 + k0 + k;
    int fm = f % n;
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
    if (lane == 0) red[warp * DFT_KT + k] = make_float2(vr, vi);
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
  float2 sp = S[pk];
  float2 sn = S[min(pk + 1, K - 1)];
  float2 sm = S[max(pk - 1, 0)];
  float maxenergy = sp.x * sp.x + sp.y * sp.y;
  float safe = maxenergy > 0.0f ? maxenergy : 1.0f;
  float ap = (sn.x * sp.x + sn.y * sp.y) / safe;
  float dp = -ap / (1.0f - ap);
  float am = (sm.x * sp.x + sm.y * sp.y) / safe;
  float dm = am / (1.0f - am);
  float d = (dp + dm) * 0.5f + quinn_tau(dp * dp) - quinn_tau(dm * dm);
  if (!(maxenergy > 0.0f)) d = 0.0f;
  float peak = (float)(first1 + pk);
  float freq = binsize * (peak + d);
  if (freq > samprate / 2.0f) freq -= samprate;
  stat[4 * b + 2] = freq;
  stat[4 * b + 3] = peak;
  cyc[b] = __fdiv_rn(freq, samprate);
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
    const float inv = (float)(1.0 / (double)n);
    float m_r = (float)s[0] * inv, m_i = (float)s[1] * inv;
    float m_rr = (float)s[2] * inv, m_ii = (float)s[3] * inv;
    float m_ri = (float)s[4] * inv;
    float amp2 = m_r * m_r + m_i * m_i;
    float amp = sqrtf(amp2);
    float safe2 = amp2 > 0.0f ? amp2 : 1.0f;
    float e_rot2 =
        (m_rr * m_r * m_r + 2.0f * m_ri * m_r * m_i + m_ii * m_i * m_i) / safe2;
    float var = fmaxf(e_rot2 - amp2, amp2 * 3e-7f + 1e-30f);
    float cn0 = (10.0f / 2.30258509f) * logf(samprate * amp2 / (2.0f * var));
    float safe_amp = amp > 0.0f ? amp : 1.0f;
    unit[0] = amp > 0.0f ? m_r / safe_amp : 1.0f;   // ur: unit = conj(dc)/amp
    unit[1] = amp > 0.0f ? -m_i / safe_amp : 0.0f;  // ui
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
      float rot_i = sr * ui + si * ur;  // imag(spun * unit)
      float v = truncf(rot_i * 0.70710677f);
      v = fminf(fmaxf(v, -32768.0f), 32767.0f);
      out[idx] = (int16_t)v;
    }
  }
}

static cudaError_t spin_launch(const int32_t* packed, int row_stride,
                               const float* cyc, int B, int n, float samprate,
                               int flip, double dop, int16_t* bb, float* stat,
                               int stat_stride, double* mom,
                               cudaStream_t stream) {
  dim3 grid((n + SPIN_CHUNK - 1) / SPIN_CHUNK, B);
  moments_kernel<<<grid, SPIN_THREADS, 0, stream>>>(packed, row_stride, cyc, n,
                                                    flip, dop, mom);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  emit_kernel<<<grid, SPIN_THREADS, 0, stream>>>(packed, row_stride, cyc, mom, n,
                                                 flip, dop, samprate,
                                                 stat_stride, bb, stat);
  return cudaGetLastError();
}

// K1.  packed (B rows of n words, row stride row_stride), iw (B, 2) int32
// [first1, wlen]; dop: de-chirp rate in cycles/sample^2 (0: none) with
// chirp its n phasors (NULL when dop == 0); outputs bb (B, n) int16,
// stat (B, 4) f32 [amp, cn0, freq, peak]; scratch spec (B, K) float2,
// cyc (B,) f32, mom (B, ceil(n/SPIN_CHUNK), 5) f64.
extern "C" int pm_locked_launch(const int32_t* packed, int row_stride,
                                const int32_t* iw, int B, int n, int K,
                                float samprate, float binsize, int flip,
                                double dop, const float* chirp, int16_t* bb,
                                float* stat, float* spec, float* cyc,
                                double* mom, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nhi = n >> 8;
  size_t smem = (size_t)(nhi + (DFT_THREADS / 32) * DFT_KT) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((K + DFT_KT - 1) / DFT_KT, B);
  dft_kernel<<<grid, DFT_THREADS, smem, s>>>(packed, row_stride, iw, n, K, flip,
                                             (const float2*)chirp,
                                             (float2*)spec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  peak_kernel<<<(B + 127) / 128, 128, 0, s>>>((const float2*)spec, iw, B, K,
                                              samprate, binsize, stat, cyc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)spin_launch(packed, row_stride, cyc, B, n, samprate, flip, dop,
                          bb, stat, 4, mom, s);
}

// K2.  cyc (B,) f32 carrier cycles/sample, dop as for K1; outputs bb
// (B, n) int16 and stat (B, 2) f32 [amp, cn0]; scratch mom as for K1.
extern "C" int spin_down_launch(const int32_t* packed, int row_stride,
                                const float* cyc, int B, int n, float samprate,
                                int flip, double dop, int16_t* bb, float* stat,
                                double* mom, void* stream) {
  return (int)spin_launch(packed, row_stride, cyc, B, n, samprate, flip, dop,
                          bb, stat, 2, mom, (cudaStream_t)stream);
}
