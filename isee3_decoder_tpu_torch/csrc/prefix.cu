// Kernel K3 of the PyTorch/CUDA port: exclusive int32 prefix sum of the
// pm scan's int16 baseband, with the (T, B, n) -> (B, T*n) transpose
// fused in.
//
// Replaces the TPU kernel _kernel of isee3_decoder_tpu/ops/prefix_pallas.py:65
// (entries prefix_sum_blocks, :80, and prefix_sum_flat, :110), which walks
// (8-channel, n) tiles in grid order and carries each channel's running
// total in VMEM scratch.
//
// What it computes.  Channel b's samples in order are x[t][b][0 .. n-1] for
// t = 0 .. T-1, L = T*n of them; out[b][j] = x_0 + ... + x_{j-1} wrapping
// mod 2^32 for j < L, and columns L .. L+tail-1 repeat the channel's grand
// total: an edge extension, which the symbol demodulator's timing search
// may read past the last sample.  Sums run in uint32, so the int32
// wraparound the consumer relies on (segment sums are differences) is well
// defined.
//
// What bounds it on the H100: bytes.  Each sample is read once as int16 and
// written once as int32 (6 bytes a sample; 1.61 GB at T = 32, B = 128,
// n = 65536: 0.481 ms at 3.35 TB/s).  The running total is a serial
// dependency along each channel, and one block walking a whole channel (the
// design before this one) keeps too few bytes in flight to reach that.  So:
//
// - Tiles along each channel.  Channel b's L samples are cut into tiles of
//   PREFIX_TILE; tile (b, i) holds samples i*TILE .. i*TILE + TILE - 1 of
//   the channel and takes them from every pm block t (input row (t, b))
//   they fall in, two when n = 4096.
// - One pass with a decoupled look-back (Merrill and Garland, 2016).  Tiles
//   are handed out by a ticket, an atomicAdd on a counter, in launch order:
//   ticket k is tile (b, i) = (k % B, k / B), so a tile waits only on tiles
//   of smaller tickets, which running blocks already hold, and no schedule
//   deadlocks.  A tile reduces its samples and publishes that aggregate in
//   its status word; then warp 0 reads the status words of its 32 nearest
//   predecessors at once, waits until each is published, and adds them up
//   to the nearest one that holds an inclusive prefix (32 further back
//   while none does); then the tile publishes its own inclusive prefix.  A
//   status word is one 64-bit value, the flag in its high half and the
//   32-bit sum in its low half, so one store publishes both and one load
//   reads both: relaxed loads and stores at GPU scope (single-copy atomic,
//   never served from a stale L1 line) suffice, since no other memory
//   passes from one tile to another.  Release stores cost 0.10 ms at the
//   bench shape: each waited for the SM's writes in flight.  The words and
//   the counter live in a workspace that the launch clears on the caller's
//   stream before every call.
// - Persistent blocks with two input stages: while a tile is scanned, the
//   next ticket's samples come into the other stage by 16-byte cp.async
//   (n % 8 == 0 and a 16-byte aligned input, so that every 8-sample group
//   of a tile lies in one pm block; otherwise by 2-byte loads straight into
//   registers).  Three blocks an SM keep 48 KB of loads in flight.
// - The tile's scan in registers: 16 samples a thread from two 16-byte
//   shared loads (the pair swapped on every other group of four lanes, so a
//   quarter warp hits 8 distinct 16-byte bank groups), a thread sum, a warp
//   scan by shuffles; each warp adds the totals of the warps before it, and
//   warp 0 all 16 for the tile's aggregate.
// - Three barriers a tile.  After the second, warp 0 publishes the
//   aggregate and looks back while every warp writes its sums from the
//   tile's start into a staging buffer in shared memory (a pad word after
//   every 32: no bank conflicts writing or reading).  After the third,
//   warps 1.. write whole 16-byte words of the output row, adding the
//   tile's prefix.  Warp 0 issues no copies and no stores, so its look-back
//   is all the tile waits on.  An output row starts at word b*(L + tail),
//   which is 16-byte aligned for one row in four when tail = 1, so each
//   tile writes the words before its first 16-byte boundary and after its
//   last as single words.
// - The channel's last tile writes the tail columns once it holds the
//   grand total.

#include <cuda_runtime.h>
#include <stdint.h>

#define PREFIX_TILE 8192  // samples a tile
#define PREFIX_THREADS 512
#define PREFIX_ITEMS 16  // samples a thread
#define PREFIX_WARPS (PREFIX_THREADS / 32)
#define PREFIX_BLOCKS_PER_SM 3
// the output staging buffer: a pad word after every 32
#define PREFIX_OUT_WORDS (PREFIX_TILE + PREFIX_TILE / 32)

// the flags in the high half of a status word (0: nothing published yet)
#define PREFIX_AGGREGATE 1ull
#define PREFIX_INCLUSIVE 2ull

static_assert(PREFIX_TILE == PREFIX_THREADS * PREFIX_ITEMS && PREFIX_ITEMS == 16 &&
                  PREFIX_WARPS <= 32,
              "prefix_tile_kernel geometry");

// two int16 input stages, the output staging buffer, the warp totals,
// the tile's prefix and total, two tickets
__host__ __device__ constexpr int prefix_smem_bytes() {
  return 2 * 2 * PREFIX_TILE + 4 * PREFIX_OUT_WORDS + 4 * (PREFIX_WARPS + 4);
}

// a status word, stored and loaded in one piece at GPU scope
static __device__ __forceinline__ void store_status(unsigned long long* p,
                                                    unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

static __device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

static __device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for this thread's copies of every group but the newest
static __device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// sign-extended int16 halves of a word, as uint32 terms of the sum
static __device__ __forceinline__ uint32_t lo16(uint32_t w) {
  return (uint32_t)((int32_t)(w << 16) >> 16);
}
static __device__ __forceinline__ uint32_t hi16(uint32_t w) {
  return (uint32_t)((int32_t)w >> 16);
}

// Warp 0 of tile i, whose status word is at my: the sum of every earlier
// tile of the channel.  Lane l reads tile base - l, spinning until that
// tile has published; tiles before the channel's first count as an
// inclusive 0.  Once a tile holds an inclusive prefix, every earlier tile
// has published (its look-back saw them), so only lanes nearer than the
// nearest inclusive prefix can be left waiting.
static __device__ __forceinline__ uint32_t look_back(const unsigned long long* my,
                                                     int i, int lane) {
  uint32_t prefix = 0;
  for (int base = i - 1;; base -= 32) {
    const int idx = base - lane;
    unsigned long long s = PREFIX_INCLUSIVE << 32;
    if (idx >= 0) {
      const unsigned long long* p = my - (i - idx);
      do {
        s = load_status(p);
      } while ((s >> 32) == 0);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (s >> 32) == PREFIX_INCLUSIVE);
    const uint32_t v = (uint32_t)s;
    if (incl) {
      const int nearest = __ffs(incl) - 1;
      return prefix + __reduce_add_sync(0xffffffffu, lane <= nearest ? v : 0u);
    }
    prefix += __reduce_add_sync(0xffffffffu, v);
  }
}

// blocks (T, B, n) int16, L = T*n, out (B, L + tail) int32; ws: the ticket
// counter in word 0, tile (b, i)'s status word at 2 + b*tiles_per_row + i.
// VEC: 16-byte cp.async into the stages (n % 8 == 0, blocks 16-byte
// aligned); else 2-byte loads.
template <bool VEC>
__global__ void __launch_bounds__(PREFIX_THREADS, PREFIX_BLOCKS_PER_SM)
prefix_tile_kernel(const int16_t* __restrict__ blocks, int B, int n, int L,
                   int tail, int tiles_per_row, int ntiles,
                   int32_t* __restrict__ out, unsigned long long* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint4* stage = reinterpret_cast<const uint4*>(smem_raw);
  uint32_t* so = reinterpret_cast<uint32_t*>(smem_raw + 4 * PREFIX_TILE);
  uint32_t* wtot = so + PREFIX_OUT_WORDS;
  uint32_t* pfx = wtot + PREFIX_WARPS;  // the tile's prefix, then the total
  int* tk = reinterpret_cast<int*>(pfx + 2);
  unsigned int* counter = reinterpret_cast<unsigned int*>(ws);
  unsigned long long* status = ws + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row_words = (size_t)L + (size_t)tail;
  const unsigned stage_s = (unsigned)__cvta_generic_to_shared(smem_raw);

  // threads 32.. issue the 16-byte groups of ticket k into stage st
  // (group q: samples 8q .. 8q + 7 of the tile, all in one pm block)
  auto issue = [&](int k, int st) {
    if (k < ntiles && warp > 0) {
      const int b = k % B, s0 = (k / B) * PREFIX_TILE;
      for (int q = tid - 32; q < PREFIX_TILE / 8; q += PREFIX_THREADS - 32) {
        const int f = s0 + 8 * q;
        if (f >= L) break;
        const int t = f / n;
        cp_async16(stage_s + 2u * (st * PREFIX_TILE + 8 * q),
                   blocks + ((size_t)t * B + b) * (size_t)n + (f - t * n));
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
    tk[0] = (int)atomicAdd(counter, 1u);
    tk[1] = (int)atomicAdd(counter, 1u);
  }
  __syncthreads();
  int k = tk[0];
  if (VEC) issue(k, 0);

  for (int it = 0; k < ntiles; ++it) {
    const int st = it & 1;
    const int kn = tk[st ^ 1];
    if (VEC) {
      // stage st ^ 1 was last read before barrier 1 of the previous tile
      issue(kn, st ^ 1);
      cp_async_wait_older();
    }
    __syncthreads();  // 0: tile k's stage is in; every thread has read kn
    if (tid == 0) tk[st] = (int)atomicAdd(counter, 1u);  // two tiles ahead

    const int b = k % B, i = k / B;
    const int s0 = i * PREFIX_TILE;
    const int len = min(PREFIX_TILE, L - s0);
    const int j0 = PREFIX_ITEMS * tid;  // this thread's first sample
    uint32_t x[PREFIX_ITEMS];
    if (VEC) {
      const int sw = (tid >> 2) & 1;
      const uint4 a = stage[st * (PREFIX_TILE / 8) + 2 * tid + sw];
      const uint4 c = stage[st * (PREFIX_TILE / 8) + 2 * tid + (sw ^ 1)];
      const uint4 w0 = sw ? c : a, w1 = sw ? a : c;
      const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const bool ok = j0 + 2 * m < len;  // len % 8 == 0
        x[2 * m] = ok ? lo16(w[m]) : 0u;
        x[2 * m + 1] = ok ? hi16(w[m]) : 0u;
      }
    } else {
      int f = s0 + j0, t = f / n, r = f - t * n;
#pragma unroll
      for (int m = 0; m < PREFIX_ITEMS; ++m) {
        x[m] = 0u;
        if (j0 + m < len) {
          x[m] = (uint32_t)(int32_t)blocks[((size_t)t * B + b) * (size_t)n + r];
          if (++r == n) {
            r = 0;
            ++t;
          }
        }
      }
    }
    uint32_t sum = 0;
#pragma unroll
    for (int m = 0; m < PREFIX_ITEMS; ++m) sum += x[m];
    uint32_t inc = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += up;
    }
    if (lane == 31) wtot[warp] = inc;
    __syncthreads();  // 1

    // warp 0 publishes the tile's aggregate first; every warp then stages
    // its sums from the tile's start, while warp 0 looks back
    const uint32_t wt = lane < PREFIX_WARPS ? wtot[lane] : 0u;
    uint32_t agg = 0;
    unsigned long long* my = status + (size_t)b * tiles_per_row + i;
    if (warp == 0) {
      agg = __reduce_add_sync(0xffffffffu, wt);
      if (lane == 0)
        store_status(my, ((i == 0 ? PREFIX_INCLUSIVE : PREFIX_AGGREGATE) << 32) | agg);
    }
    uint32_t run = __reduce_add_sync(0xffffffffu, lane < warp ? wt : 0u) + inc - sum;
#pragma unroll
    for (int m = 0; m < PREFIX_ITEMS; ++m) {
      const int j = j0 + m;
      so[j + (j >> 5)] = run;
      run += x[m];
    }
    if (warp == 0) {
      uint32_t prefix = 0;
      if (i > 0) {
        prefix = look_back(my, i, lane);
        if (lane == 0) store_status(my, (PREFIX_INCLUSIVE << 32) | (uint32_t)(prefix + agg));
      }
      if (lane == 0) {
        pfx[0] = prefix;
        pfx[1] = prefix + agg;
      }
    }
    __syncthreads();  // 2

    // warps 1.. store, adding the tile's prefix
    const uint32_t prefix = pfx[0];
    int32_t* row = out + (size_t)b * row_words;
    if (i == tiles_per_row - 1) {
      const int32_t g = (int32_t)pfx[1];
      for (int j = tid - 32; j >= 0 && j < tail; j += PREFIX_THREADS - 32)
        row[(size_t)L + j] = g;
    }
    int32_t* dst = row + s0;
    const int head =
        min(len, (int)((4u - (unsigned)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3u)) & 3u));
    const int nvec = (len - head) >> 2;
    for (int q = tid - 32; q >= 0 && q < nvec; q += PREFIX_THREADS - 32) {
      const int j = head + 4 * q;
      int4 v;
      v.x = (int32_t)(so[j + (j >> 5)] + prefix);
      v.y = (int32_t)(so[j + 1 + ((j + 1) >> 5)] + prefix);
      v.z = (int32_t)(so[j + 2 + ((j + 2) >> 5)] + prefix);
      v.w = (int32_t)(so[j + 3 + ((j + 3) >> 5)] + prefix);
      *reinterpret_cast<int4*>(dst + j) = v;
    }
    // the single words: threads 32 .. 32 + head - 1 before the first
    // 16-byte boundary, threads 36.. after the last
    const int rest = head + 4 * nvec;
    if (tid >= 32 && tid - 32 < head) {
      dst[tid - 32] = (int32_t)(so[tid - 32] + prefix);
    } else if (tid >= 36 && tid - 36 < len - rest) {
      const int j = rest + tid - 36;
      dst[j] = (int32_t)(so[j + (j >> 5)] + prefix);
    }
    k = kn;
  }
}

// blocks (T, B, n) int16 contiguous -> out (B, T*n + tail) int32.  ws:
// 2 + B*ceil(T*n / tile) zeroed 8-byte words (cleared here, on stream).
// tile, threads, grid and smem_bytes from the wrapper's plan
// (prefix_cuda.prefix_plan), which must be this kernel's.
extern "C" int prefix_sum_launch(const int16_t* blocks, int T, int B, int n,
                                 int tail, int32_t* out, unsigned long long* ws,
                                 int tile, int threads, int grid, int smem_bytes,
                                 void* stream) {
  if (tile != PREFIX_TILE || threads != PREFIX_THREADS ||
      smem_bytes != prefix_smem_bytes() || T < 1 || B < 1 || n < 1 || tail < 0 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const long long L = (long long)T * n;
  const long long per_row = (L + PREFIX_TILE - 1) / PREFIX_TILE;
  const long long ntiles = per_row * B;
  // tickets run to ntiles + 2 * grid
  if (L + tail > 0x7fffffffLL || ntiles + 2LL * grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(ws, 0, (size_t)(2 + ntiles) * 8, s);
  if (err != cudaSuccess) return (int)err;
  const bool vec = n % 8 == 0 && (reinterpret_cast<uintptr_t>(blocks) & 15) == 0;
  void (*kern)(const int16_t*, int, int, int, int, int, int, int32_t*,
               unsigned long long*) =
      vec ? prefix_tile_kernel<true> : prefix_tile_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, PREFIX_THREADS, smem_bytes, s>>>(blocks, B, n, (int)L, tail,
                                                 (int)per_row, (int)ntiles, out, ws);
  return (int)cudaGetLastError();
}
