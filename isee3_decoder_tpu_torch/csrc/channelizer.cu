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
// frames start half a channel period late, a phase of (-1)^k).  The
// critically sampled bank is hop = M, the oversampled one hop = M/2: the
// odd stream is an address offset of M/2 words, nothing more.
//
// What bounds them on the H100: bytes.  Each capture word is read once
// and each output pair written once (8 bytes per sample and channel at
// oversample 1, 6 at oversample 2); as an FFT the arithmetic is about
// 4*P + 5*log2(M) float32 operations per sample and channel (67 at P = 8,
// M = 128), under the card's 20 flop per byte.  A direct M-point DFT sum
// would need 8*M operations per sample and channel and be bound by them
// instead, so the
// channel transform is a radix-2 decimation-in-frequency FFT in shared
// memory: a block takes a tile of TS output samples, keeps them as TS
// columns of an (M, TS+1) float workspace (the odd row stride keeps both
// the tap stage, whose lanes run along r, and the butterflies and stores,
// whose lanes run along j, free of bank conflicts), runs log2(M) stages
// with the twiddle uniform across a warp, and leaves bin k in row
// bitreverse(k).  The channel-major store then gives each channel row TS
// consecutive pairs as 32-bit words: 4*TS contiguous bytes per row.
// The P-1 frames a tile shares with the next one are read again (from L2
// mostly); the last, partial tile is masked.  All float32, no tensor
// cores: TF32 or bf16 products would cost tens of LSB.

#include <cuda_runtime.h>
#include <stdint.h>

#define PFB_THREADS 512

static __device__ __forceinline__ int quantize(float v) {
  // saturate at +-32767, then the conversion truncates toward zero
  return (int)fminf(fmaxf(v, -32767.0f), 32767.0f);
}

// wide: nwords packed samples.  taps: (P, M).  twid: cos(2*pi*t/M) for
// t < M/2, then -sin(2*pi*t/M).  out: (M, nsamp) words, I low, Q high.
// Dynamic shared memory: 2*M*(TS+1) + M + P*M floats, then
// (TS-1)*hop + P*M words of the capture.
template <int OS>
__global__ void __launch_bounds__(PFB_THREADS)
pfb_kernel(const int32_t* __restrict__ wide, long long nwords,
           const float* __restrict__ taps, const float* __restrict__ twid,
           int M, int logM, int P, int TS, int logTS, long long nsamp,
           int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  const int hop = M / OS;
  const int ld = TS + 1;
  float* re = smem;
  float* im = re + M * ld;
  float* tw = im + M * ld;
  float* hb = tw + M;
  int32_t* xin = reinterpret_cast<int32_t*>(hb + P * M);
  const int tid = threadIdx.x;
  const long long j0 = (long long)blockIdx.x * TS;
  const long long w0 = j0 * hop;
  const int nin = (TS - 1) * hop + P * M;

  for (int i = tid; i < nin; i += PFB_THREADS) {
    const long long g = w0 + i;
    xin[i] = g < nwords ? wide[g] : 0;
  }
  for (int i = tid; i < M; i += PFB_THREADS) tw[i] = twid[i];
  for (int i = tid; i < P * M; i += PFB_THREADS) hb[i] = taps[i];
  __syncthreads();

  // tap sums, p ascending: sample j, branch r -> workspace row r, column j
  for (int idx = tid; idx < TS * M; idx += PFB_THREADS) {
    const int r = idx & (M - 1), j = idx >> logM;
    const int32_t* x = xin + j * hop + r;
    float ar = 0.0f, ai = 0.0f;
    for (int p = 0; p < P; ++p) {
      const int32_t w = x[p * M];
      const float h = hb[p * M + r];
      ar = fmaf((float)(int16_t)(w & 0xffff), h, ar);
      ai = fmaf((float)(w >> 16), h, ai);
    }
    re[r * ld + j] = ar;
    im[r * ld + j] = ai;
  }
  __syncthreads();

  // radix-2 decimation in frequency across the rows, in place; bin k ends
  // in row bitreverse(k)
  for (int sh = logM - 1; sh >= 0; --sh) {
    const int half = 1 << sh;
    for (int idx = tid; idx < (M >> 1) * TS; idx += PFB_THREADS) {
      const int j = idx & (TS - 1), b = idx >> logTS;
      const int pos = b & (half - 1);
      const int i0 = ((b - pos) << 1) + pos, i1 = i0 + half;
      const int t = pos << (logM - 1 - sh);
      const float wr = tw[t], wi = tw[(M >> 1) + t];
      const float ar = re[i0 * ld + j], ai = im[i0 * ld + j];
      const float br = re[i1 * ld + j], bi = im[i1 * ld + j];
      const float dr = ar - br, di = ai - bi;
      re[i0 * ld + j] = ar + br;
      im[i0 * ld + j] = ai + bi;
      re[i1 * ld + j] = dr * wr - di * wi;
      im[i1 * ld + j] = dr * wi + di * wr;
    }
    __syncthreads();
  }

  // channel-major store: lanes along j write consecutive (I, Q) words
  for (int idx = tid; idx < M * TS; idx += PFB_THREADS) {
    const int j = idx & (TS - 1), k = idx >> logTS;
    const long long jj = j0 + j;
    if (jj >= nsamp) continue;
    const int row = (int)(__brev((unsigned)k) >> (32 - logM));
    float yr = re[row * ld + j], yi = im[row * ld + j];
    if (OS == 2 && (k & 1) && (j & 1)) {  // TS is even, so j0 is
      yr = -yr;
      yi = -yi;
    }
    out[(size_t)k * (size_t)nsamp + (size_t)jj] =
        (quantize(yr) & 0xffff) | (quantize(yi) << 16);
  }
}

static int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <int OS>
static int pfb_launch(const int32_t* wide, long long nwords, const float* taps,
                      const float* twid, int M, int P, int TS, long long nsamp,
                      int32_t* out, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pfb_kernel<OS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((nsamp + TS - 1) / TS);
  pfb_kernel<OS><<<grid, PFB_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      wide, nwords, taps, twid, M, ilog2(M), P, TS, ilog2(TS), nsamp, out);
  return (int)cudaGetLastError();
}

// K7a (oversample 1, the critically sampled bank) or K7b (oversample 2:
// hop M/2, odd samples' odd bins negated).  M and TS are powers of two,
// TS even; nsamp output samples per channel; the wrapper sizes smem_bytes.
extern "C" int channelize_launch(const int32_t* wide, long long nwords,
                                 const float* taps, const float* twid, int M,
                                 int P, int TS, int oversample,
                                 long long nsamp, int32_t* out, int smem_bytes,
                                 void* stream) {
  switch (oversample) {
    case 1:
      return pfb_launch<1>(wide, nwords, taps, twid, M, P, TS, nsamp, out,
                           smem_bytes, stream);
    case 2:
      return pfb_launch<2>(wide, nwords, taps, twid, M, P, TS, nsamp, out,
                           smem_bytes, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
