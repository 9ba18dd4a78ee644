// Kernel K4 of the PyTorch/CUDA port: the whole collapsed-backtrack Fano
// walk (fano.c:110-189) for a batch of independent lanes.
//
// Replaces the TPU kernel `kernel` inside _fano_walk_pallas
// (isee3_decoder_tpu/ops/fano_pallas.py:106, entry fano_decode_pallas :308).
// On the TPU every lane steps in lockstep and each per-lane tape access is
// a masked one-hot reduction over the whole VMEM tape (fano_pallas.py:
// 146-176), because the vector unit has no per-lane gather.
//
// What bounds it on the H100: a lane's walk is serial and data-dependent.
// Every micro-step (one forward look, or one whole backtrack run) needs
// what the one before it chose, so a launch lasts as long as its slowest
// lane's micro-steps (12,288 at the tier-1 cap of 12 cycles/bit, 102,400
// at the full budget of 100) times the latency of one micro-step: not
// bytes, and not the operation rate of the card.  One warp runs one walk
// and issues at most one instruction a cycle, so that latency is the
// dependent chain of a step plus the instructions the step issues.  Two
// designs, chosen on shape by ops/fano_cuda.py fano_walk_plan:
//
// "warp" (fano_warp_kernel, every lane whose metrics and tape fit in
// shared memory: (2N + 1) x 16 bytes, N <= 7263):
//   - one warp walks one lane; its 32 threads carry the same walk
//     registers, so control flow is uniform within the warp (no lane
//     waits on another's branch) and no shuffle sits on the chain;
//   - the lane's branch metrics m4 are staged in shared memory by
//     coalesced 16-byte loads at entry, and its push-down tape of int4
//     records {gamma, tm0, tm1, (ibr << kb) | enc} lives there too; every
//     thread stores every push, so each reads back its own stores;
//   - the next node's metrics are loaded a micro-step ahead; the symbol
//     pair of the next advance is carried from the last one (its parity
//     changes by the new bit alone), and so is the branch metric the
//     forward look tries;
//   - the record below the current node (the top of the tape) is kept in
//     registers: most backtrack runs end there, relaxing where the walk
//     stands or toggling that record, and read nothing;
//   - other runs are resolved by ballots over the records below it:
//     thread i reads record np - 2 - i, one ballot marks the records
//     with gamma < t (relax at j + 1) and one the untried branches below
//     the tail (toggle at j); the lowest set lane of either is the serial
//     scan's first hit from the top, and a record that is both relaxes,
//     as the relax test comes first (the JAX walk's jt > jr,
//     fano_pallas.py:146-158); the next 32 records are read only when
//     neither ballot has a bit;
//   - the threshold tightening floors by delta with a mask when delta is
//     a power of two (the default 32), by the exact division else;
//   - MCQLI-24 on frames of 1024 bits (the main path) runs an instance
//     with the code's constants folded in;
//   - at the end the warp writes the lane's N bits coalesced.
// "thread" (fano_kernel, lanes too long for shared memory): one thread
// walks one lane, 32 lanes a block, the tape in global memory, the
// backtrack run by a serial backward scan to its first hit.
//
// Both count cycles as the JAX walk does: one per forward look, the run
// a violation resolves costs one, and the timeout test follows the same
// order (fano.c:110).  Metric precompute (_metrics4) and the root-node
// setup stay in PyTorch, as they stay in jnp outside the Pallas call.

#include <cuda_runtime.h>
#include <stdint.h>

#define FANO_THREADS 32

__device__ __forceinline__ int parity32(int x) { return __popc((unsigned)x) & 1; }

__device__ __forceinline__ int sel4(int4 m, int s) {
  return s == 0 ? m.x : (s == 1 ? m.y : (s == 2 ? m.z : m.w));
}

// floor division for d > 0 (C's '/' truncates toward zero)
__device__ __forceinline__ int floordiv(int a, int d) {
  int q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}

// ---------------------------------------------------------------- "thread"

__global__ void fano_kernel(const int4* __restrict__ metrics4,
                            const int32_t* __restrict__ regs, int B, int N,
                            int tail_start, int kb, int delta, int max_total,
                            int poly1, int poly2, int g1flip, int g2flip,
                            int4* __restrict__ tape, uint8_t* __restrict__ bits,
                            int32_t* __restrict__ stats) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int4* m4 = metrics4 + (size_t)b * N;
  int4* T = tape + (size_t)b * (N + 1);
  const int encmask = (int)((1u << kb) - 1u);
  int tm0 = regs[5 * b + 0];
  int tm1 = regs[5 * b + 1];
  int enc = regs[5 * b + 2];
  int done = regs[5 * b + 3];
  const int tailbits = regs[5 * b + 4];
  int np = 0, t = 0, cycles = 0, g = 0, ibr = 0;

  while (!done) {
    // ---------- forward look (fano.c:117-166) ----------
    const int ngamma = g + (ibr == 0 ? tm0 : tm1);
    const bool ok = ngamma >= t;
    if (ok) {
      const int t_fwd =
          (g < t + delta) ? t + delta * floordiv(ngamma - t, delta) : t;
      if (np == N - 1) {
        done = 1;  // decoded the last node
      } else {
        // push the current node, advance to the next one
        T[np] = make_int4(g, tm0, tm1, (ibr << kb) | enc);
        const int new_np = np + 1;
        const int adv_enc = (enc << 1) & encmask;
        const int lsym = ((parity32(adv_enc & poly1) << 1) ^ g1flip) |
                         (parity32(adv_enc & poly2) ^ g2flip);
        const int4 m = m4[new_np];
        if (new_np >= tail_start) {  // known tail bits (fano.c:141-147)
          int sh = N - new_np - 1;
          sh = sh < 0 ? 0 : (sh > 31 ? 31 : sh);
          const int tbit = (tailbits >> sh) & 1;
          tm0 = sel4(m, (tbit * 3) ^ lsym);
          tm1 = tm0;
          enc = adv_enc | tbit;
        } else {
          const int a0 = sel4(m, lsym), a1 = sel4(m, 3 ^ lsym);
          const bool better1 = a1 >= a0;  // fano.c:95-104
          tm0 = better1 ? a1 : a0;
          tm1 = better1 ? a0 : a1;
          enc = adv_enc | (better1 ? 1 : 0);
        }
        g = ngamma;
        ibr = 0;
        np = new_np;
      }
      t = t_fwd;
    } else {
      // ---------- the whole backtrack run (fano.c:169-188) ----------
      int target = 0;
      bool toggle = false;
      for (int j = np - 1; j >= 0; --j) {
        const int4 rec = T[j];
        if (rec.x < t) {  // cannot step back past j: relax at j + 1
          target = j + 1;
          break;
        }
        if (j < tail_start && (rec.w >> kb) == 0) {  // untried branch
          target = j;
          toggle = true;
          break;
        }
      }
      int bg, b0, b1, benc, bibr;
      if (!toggle && target == np) {  // relax where we stand
        bg = g;
        b0 = tm0;
        b1 = tm1;
        benc = enc;
        bibr = ibr;
      } else {
        const int4 rec = T[target];
        bg = rec.x;
        b0 = rec.y;
        b1 = rec.z;
        benc = rec.w & encmask;
        bibr = rec.w >> kb;
      }
      g = bg;
      tm0 = b0;
      tm1 = b1;
      np = target;
      if (toggle) {
        enc = benc ^ 1;
        ibr = bibr + 1;
      } else {
        enc = benc ^ (bibr != 0 ? 1 : 0);
        ibr = 0;
        t -= delta;
      }
    }
    ++cycles;
    if (!done && cycles >= max_total) done = 1;  // fano.c:110 timeout
  }

  uint8_t* out = bits + (size_t)b * N;
  for (int j = 0; j < N; ++j) {
    int bit = 0;
    if (j < np) bit = T[j].w & 1;
    else if (j == np) bit = enc & 1;
    out[j] = (uint8_t)bit;
  }
  stats[4 * b + 0] = np;
  stats[4 * b + 1] = g;
  stats[4 * b + 2] = cycles;
  stats[4 * b + 3] = t;
}

// ------------------------------------------------------------------ "warp"

#define FULL_MASK 0xffffffffu

// delta * floor(d / delta)
template <bool POW2>
__device__ __forceinline__ int floor_to(int d, int delta) {
  if (POW2) return d & -delta;
  return delta * floordiv(d, delta);
}

// node metric for the symbol pair s, by selects on the bits of s
__device__ __forceinline__ int pick4(int4 m, int s) {
  const int lo = (s & 1) ? m.y : m.x;
  const int hi = (s & 1) ? m.w : m.z;
  return (s & 2) ? hi : lo;
}

// a 16-byte shared-memory load the compiler issues where it stands (it
// would otherwise sink a load into the branch that uses it); only for
// memory no thread writes meanwhile
__device__ __forceinline__ int4 lds128_here(unsigned addr) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// The main path's walk, specialized: MCQLI-24 (code.h's default) on
// frames of 1024 bits, its constants folded into the instructions
#define MCQLI24_POLY1 0073665667
#define MCQLI24_POLY2 0073665665

template <bool POW2, bool MCQLI24_1024>
__global__ void fano_warp_kernel(const int4* __restrict__ metrics4,
                                 const int32_t* __restrict__ regs, int B,
                                 int N_, int tail_start_, int kb_, int delta,
                                 int max_total, int poly1_, int poly2_,
                                 int g1flip_, int g2flip_,
                                 uint8_t* __restrict__ bits,
                                 int32_t* __restrict__ stats) {
  const bool S = MCQLI24_1024;
  const int N = S ? 1024 : N_;
  const int tail_start = S ? 1024 - 23 : tail_start_;
  const int kb = S ? 24 : kb_;
  const int poly1 = S ? MCQLI24_POLY1 : poly1_;
  const int poly2 = S ? MCQLI24_POLY2 : poly2_;
  const int g1flip = S ? 0 : g1flip_;
  const int g2flip = S ? 1 : g2flip_;
  extern __shared__ int4 fano_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: the block has no barrier
  int4* M = fano_smem + (size_t)warp * (2 * N + 1);  // metrics, N records
  int4* T = M + N;                                    // tape, N + 1 records
  const unsigned m_addr = (unsigned)__cvta_generic_to_shared(M);
  const int encmask = (int)((1u << kb) - 1u);
  // the symbol pair of an advance from enc: parity((enc << 1) & poly) =
  // parity(enc & p); and from (enc << 1) | bit: parity(...) ^ (bit & q)
  const int p1 = (poly1 >> 1) & (encmask >> 1), q1 = p1 & 1;
  const int p2 = (poly2 >> 1) & (encmask >> 1), q2 = p2 & 1;
  int tm0 = regs[5 * b + 0];
  int tm1 = regs[5 * b + 1];
  int enc = regs[5 * b + 2];
  const bool skip = regs[5 * b + 3] != 0;
  const int tailbits = regs[5 * b + 4];
  int np = 0, t = 0, cycles = 0, g = 0, ibr = 0;

  if (!skip) {  // a lane that starts done (skip) reads no metrics
    const int4* m4 = metrics4 + (size_t)b * N;
    for (int j = lane; j < N; j += 32) M[j] = __ldg(m4 + j);
    __syncwarp();
    // the next node's metrics, loaded a micro-step ahead
    int4 mn = lds128_here(m_addr + 16u);
    // the top record (node np - 1, for np >= 1) in registers: most
    // backtrack runs end there (every thread stores every push, so each
    // reads back its own stores)
    int4 top = make_int4(0, 0, 0, 0);
    int ls = ((parity32(enc & p1) << 1) ^ g1flip) |
             (parity32(enc & p2) ^ g2flip);
    int tmc = tm0;  // the branch metric the forward look tries
    for (;;) {
      // the encoder step of an advance, from enc alone, and the symbol
      // pair of the advance after it for either new bit
      const int adv_enc = (enc << 1) & encmask;
      const int pa1 = parity32(adv_enc & p1), pa2 = parity32(adv_enc & p2);
      const int ls0 = ((pa1 << 1) ^ g1flip) | (pa2 ^ g2flip);
      const int ls1 = (((pa1 ^ q1) << 1) ^ g1flip) | (pa2 ^ q2 ^ g2flip);
      // ---------- forward look (fano.c:117-166) ----------
      const int ngamma = g + tmc;
      if (ngamma >= t) {
        const int t_fwd =
            (g < t + delta) ? t + floor_to<POW2>(ngamma - t, delta) : t;
        if (np == N - 1) {  // decoded the last node
          t = t_fwd;
          ++cycles;
          break;
        }
        // push the current node, advance to the next one
        top = make_int4(g, tm0, tm1, (ibr << kb) | enc);
        T[np] = top;
        const int new_np = np + 1;
        int sh = N - new_np - 1;
        sh = sh < 0 ? 0 : (sh > 31 ? 31 : sh);
        const int tbit = (tailbits >> sh) & 1;
        const bool in_tail = new_np >= tail_start;  // fano.c:141-147
        const int a0 = pick4(mn, in_tail ? (tbit * 3) ^ ls : ls);
        const int a1 = in_tail ? a0 : pick4(mn, 3 ^ ls);
        // fano.c:95-104: the better branch first (in the tail a1 == a0)
        const int bit = in_tail ? tbit : (a1 >= a0 ? 1 : 0);
        tm0 = max(a0, a1);
        tm1 = min(a0, a1);
        tmc = tm0;
        enc = adv_enc | bit;
        ls = bit ? ls1 : ls0;
        g = ngamma;
        ibr = 0;
        np = new_np;
        t = t_fwd;
      } else {
        // ---------- the whole backtrack run (fano.c:169-188) ----------
        if (np == 0 || top.x < t) {
          // relax where we stand: no step back past the top record
          enc ^= ibr != 0 ? 1 : 0;
          ibr = 0;
          tmc = tm0;
          t -= delta;
        } else if (np - 1 < tail_start && (top.w >> kb) == 0) {
          // toggle the top record: try its other branch
          np -= 1;
          g = top.x;
          tm0 = top.y;
          tm1 = top.z;
          enc = (top.w & encmask) ^ 1;
          ibr = 1;
          tmc = tm1;
          top = T[np >= 1 ? np - 1 : 0];
        } else {
          // below the top record, 32 records a ballot: thread i reads
          // record hi - i; the lowest lane with a hit is the highest
          // node, and a node that is both relaxes; no hit relaxes at 0
          int hi = np - 2;
          unsigned relax_bits, hits;
          for (;;) {
            const int j = hi - lane;
            const int4 rec = T[j < 0 ? 0 : j];
            relax_bits = __ballot_sync(FULL_MASK, j >= 0 && rec.x < t);
            hits = relax_bits |
                   __ballot_sync(FULL_MASK, j >= 0 && j < tail_start &&
                                                (rec.w >> kb) == 0);
            if (hits != 0 || hi < 32) break;
            hi -= 32;
          }
          const int i = __ffs(hits) - 1;
          const bool toggle = hits != 0 && ((relax_bits >> i) & 1u) == 0;
          np = hits == 0 ? 0 : (toggle ? hi - i : hi - i + 1);
          const int4 rec = T[np];
          const int bibr = rec.w >> kb;
          g = rec.x;
          tm0 = rec.y;
          tm1 = rec.z;
          enc = (rec.w & encmask) ^ (toggle || bibr != 0 ? 1 : 0);
          ibr = toggle ? bibr + 1 : 0;  // a toggled node had ibr 0
          tmc = toggle ? tm1 : tm0;
          t = toggle ? t : t - delta;
          top = T[np >= 1 ? np - 1 : 0];
        }
        ls = ((parity32(enc & p1) << 1) ^ g1flip) |
             (parity32(enc & p2) ^ g2flip);
      }
      mn = lds128_here(m_addr +
                       16u * (unsigned)(np + 1 < N ? np + 1 : N - 1));
      if (++cycles >= max_total) break;  // fano.c:110 timeout
    }
  }

  // the lane's bits, coalesced: node j's bit is bit 0 of its record's
  // encoder state below np, of the registers' at np, 0 above
  __syncwarp();
  const int* Tw = reinterpret_cast<const int*>(T);
  uint8_t* out = bits + (size_t)b * N;
  for (int j = lane; j < N; j += 32) {
    int bit = 0;
    if (j < np) bit = Tw[4 * j + 3] & 1;
    else if (j == np) bit = enc & 1;
    out[j] = (uint8_t)bit;
  }
  if (lane == 0) {
    stats[4 * b + 0] = np;
    stats[4 * b + 1] = g;
    stats[4 * b + 2] = cycles;
    stats[4 * b + 3] = t;
  }
}

// metrics4 (B, N, 4) int32; regs (B, 5) int32 [tm0, tm1, enc, done,
// tailbits]; outputs bits (B, N) uint8 (nodes above the final np are 0)
// and stats (B, 4) int32 [np, gamma, cycles, t].  warp_lanes > 0 takes
// the "warp" design, warp_lanes lanes a block and smem bytes of dynamic
// shared memory ((2N + 1) x 16 a lane); warp_lanes == 0 the "thread"
// design, with the scratch tape (B, N+1, 4) int32 in global memory.
extern "C" int fano_walk_launch(const int32_t* metrics4, const int32_t* regs,
                                int B, int N, int tail_start, int kb, int delta,
                                int max_total, int poly1, int poly2, int g1flip,
                                int g2flip, int warp_lanes, int smem,
                                int32_t* tape, uint8_t* bits, int32_t* stats,
                                void* stream) {
  if (warp_lanes == 0) {
    int grid = (B + FANO_THREADS - 1) / FANO_THREADS;
    fano_kernel<<<grid, FANO_THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)metrics4, regs, B, N, tail_start, kb, delta, max_total,
        poly1, poly2, g1flip, g2flip, (int4*)tape, bits, stats);
    return (int)cudaGetLastError();
  }
  const bool pow2 = (delta & (delta - 1)) == 0;
  const bool mcqli24_1024 = N == 1024 && tail_start == 1024 - 23 &&
                            kb == 24 && poly1 == MCQLI24_POLY1 &&
                            poly2 == MCQLI24_POLY2 && g1flip == 0 &&
                            g2flip == 1;
  void (*kern)(const int4*, const int32_t*, int, int, int, int, int, int,
               int, int, int, int, uint8_t*, int32_t*) =
      pow2 ? (mcqli24_1024 ? fano_warp_kernel<true, true>
                           : fano_warp_kernel<true, false>)
           : (mcqli24_1024 ? fano_warp_kernel<false, true>
                           : fano_warp_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + warp_lanes - 1) / warp_lanes;
  kern<<<grid, 32 * warp_lanes, smem, (cudaStream_t)stream>>>(
      (const int4*)metrics4, regs, B, N, tail_start, kb, delta, max_total,
      poly1, poly2, g1flip, g2flip, bits, stats);
  return (int)cudaGetLastError();
}
