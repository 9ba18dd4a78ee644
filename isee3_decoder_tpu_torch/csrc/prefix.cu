// Kernel K3 of the PyTorch/CUDA port: exclusive int32 prefix sum of the
// pm scan's int16 baseband, with the (T, B, n) -> (B, T*n) transpose
// fused in.
//
// Replaces the TPU kernel _kernel of isee3_decoder_tpu/ops/prefix_pallas.py:65
// (entry prefix_sum_blocks, :80), which walks (8-channel, n) tiles in grid
// order and carries each channel's running total in VMEM scratch.
//
// What bounds it on the H100: bytes.  Each sample is read once as int16
// and written once as int32 (6 bytes/sample, 1.6 GB at T = 32, B = 128,
// n = 65536: ~0.5 ms at 3.35 TB/s).  The running total is a serial
// dependency along each channel, so the simple design gives each channel
// one block that walks its T*n samples in tiles of 4096 with a block-wide
// scan (warp shuffles, then a scan of the 32 warp totals) and carries the
// total in a register; with B >= 128 every SM has a channel.  Sums run in
// uint32, so the int32 wraparound the consumer relies on (segment sums
// are differences) is well defined.  Columns T*n .. T*n+tail-1 repeat
// the channel's grand total: an edge extension of the prefix sum, which
// the symbol demodulator's timing search may read past the last sample.

#include <cuda_runtime.h>
#include <stdint.h>

#define PREFIX_THREADS 1024
#define PREFIX_ITEMS 4
#define PREFIX_TILE (PREFIX_THREADS * PREFIX_ITEMS)

__global__ void prefix_kernel(const int16_t* __restrict__ blocks, int T, int B,
                              int n, int tail, int32_t* __restrict__ out) {
  __shared__ uint32_t warp_tot[PREFIX_THREADS / 32];
  __shared__ uint32_t tile_tot;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long L = (long long)T * n;
  int32_t* row = out + (size_t)b * (size_t)(L + tail);
  uint32_t carry = 0;
  for (int t = 0; t < T; ++t) {
    const int16_t* src = blocks + ((size_t)t * B + b) * (size_t)n;
    int32_t* dst = row + (size_t)t * n;
    for (int base = 0; base < n; base += PREFIX_TILE) {
      uint32_t v[PREFIX_ITEMS];
      uint32_t run = 0;
#pragma unroll
      for (int k = 0; k < PREFIX_ITEMS; ++k) {
        int idx = base + tid * PREFIX_ITEMS + k;
        v[k] = idx < n ? (uint32_t)(int32_t)src[idx] : 0u;
        run += v[k];
      }
      // inclusive scan of the thread totals within the warp
      uint32_t incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        uint32_t up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      if (lane == 31) warp_tot[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        uint32_t w = warp_tot[lane];
        uint32_t wi = w;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          uint32_t up = __shfl_up_sync(0xffffffffu, wi, off);
          if (lane >= off) wi += up;
        }
        warp_tot[lane] = wi - w;  // exclusive warp offsets
        if (lane == 31) tile_tot = wi;
      }
      __syncthreads();
      uint32_t acc = carry + warp_tot[warp] + (incl - run);
#pragma unroll
      for (int k = 0; k < PREFIX_ITEMS; ++k) {
        int idx = base + tid * PREFIX_ITEMS + k;
        if (idx < n) dst[idx] = (int32_t)acc;
        acc += v[k];
      }
      carry += tile_tot;
      __syncthreads();  // warp_tot / tile_tot are rewritten next tile
    }
  }
  for (int j = tid; j < tail; j += PREFIX_THREADS) row[L + j] = (int32_t)carry;
}

// blocks (T, B, n) int16 contiguous -> out (B, T*n + tail) int32.
extern "C" int prefix_sum_launch(const int16_t* blocks, int T, int B, int n,
                                 int tail, int32_t* out, void* stream) {
  prefix_kernel<<<B, PREFIX_THREADS, 0, (cudaStream_t)stream>>>(blocks, T, B, n,
                                                                tail, out);
  return (int)cudaGetLastError();
}
