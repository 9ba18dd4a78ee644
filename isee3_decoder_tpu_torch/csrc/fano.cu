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
//
// The wide variant (fano_walk_wide_launch: MCQLI32, MJ, LL, BLLF47,
// JSODP47, MCQLI48, JQLIODP48, J50, J60, 30 to 60 state bits) is the same
// two kernels instantiated on a 64-bit state word (the traits struct
// Wide): it replaces the JAX package's XLA wide walk _fano_decode_wide
// (isee3_decoder_tpu/ops/fano.py:528), which splits the state into two
// int32 words; here it is one unsigned long long, shifted logically, its
// parity one __popcll.  A tape record grows to 24 bytes {gamma, tm0,
// tm1, pad, (ibr << kb) | enc}: kb <= 60 and ibr <= 1 fit the word.  A
// lane of the "warp" design takes 16N + 24(N + 1) bytes rounded up to
// 16 (N <= 5810), and "thread" takes longer lanes.  The MCQLI-24
// specialization does not apply.  Its bound is the packed walk's: the
// slowest lane's chain of micro-steps.

#include <cuda_runtime.h>
#include <stdint.h>

#define FANO_THREADS 32

// The walk's word types.  W: the encoder state and the tape record's
// (ibr << kb) | enc word; Reg: a root register of the (B, 5) input; Rec:
// a tape record {gamma, tm0, tm1, word}.
struct Packed {  // < 30 state bits: int words, 16-byte int4 records
  typedef int W;
  typedef int32_t Reg;
  typedef int4 Rec;
  static constexpr int TAIL_MAX = 31;  // the highest tail bit a shift reads
  static constexpr bool MCQLI24 = true;  // the main path's specialization
  __device__ static __forceinline__ Rec make(int g, int tm0, int tm1, W w) {
    return make_int4(g, tm0, tm1, w);
  }
  __device__ static __forceinline__ int g(const Rec& r) { return r.x; }
  __device__ static __forceinline__ int tm0(const Rec& r) { return r.y; }
  __device__ static __forceinline__ int tm1(const Rec& r) { return r.z; }
  __device__ static __forceinline__ W word(const Rec& r) { return r.w; }
  __device__ static __forceinline__ W mask(int kb) {
    return (int)((1u << kb) - 1u);
  }
  __device__ static __forceinline__ int parity(W x) {
    return __popc((unsigned)x) & 1;
  }
};

struct WideRec {  // 24 bytes, 8-byte aligned
  int g, tm0, tm1, pad;
  unsigned long long w;
};

struct Wide {  // 30 to 60 state bits: unsigned 64-bit words (logical shifts)
  typedef unsigned long long W;
  typedef int64_t Reg;
  typedef WideRec Rec;
  static constexpr int TAIL_MAX = 63;
  static constexpr bool MCQLI24 = false;
  __device__ static __forceinline__ Rec make(int g, int tm0, int tm1, W w) {
    Rec r;
    r.g = g;
    r.tm0 = tm0;
    r.tm1 = tm1;
    r.pad = 0;
    r.w = w;
    return r;
  }
  __device__ static __forceinline__ int g(const Rec& r) { return r.g; }
  __device__ static __forceinline__ int tm0(const Rec& r) { return r.tm0; }
  __device__ static __forceinline__ int tm1(const Rec& r) { return r.tm1; }
  __device__ static __forceinline__ W word(const Rec& r) { return r.w; }
  __device__ static __forceinline__ W mask(int kb) {
    return (1ull << kb) - 1ull;
  }
  __device__ static __forceinline__ int parity(W x) { return __popcll(x) & 1; }
};

__device__ __forceinline__ int sel4(int4 m, int s) {
  return s == 0 ? m.x : (s == 1 ? m.y : (s == 2 ? m.z : m.w));
}

// floor division for d > 0 (C's '/' truncates toward zero)
__device__ __forceinline__ int floordiv(int a, int d) {
  int q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}

// ---------------------------------------------------------------- "thread"

template <class R>
__global__ void fano_kernel(const int4* __restrict__ metrics4,
                            const typename R::Reg* __restrict__ regs, int B,
                            int N, int tail_start, int kb, int delta,
                            int max_total, typename R::W poly1,
                            typename R::W poly2, int g1flip, int g2flip,
                            typename R::Rec* __restrict__ tape,
                            uint8_t* __restrict__ bits,
                            int32_t* __restrict__ stats) {
  typedef typename R::W W;
  typedef typename R::Rec Rec;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int4* m4 = metrics4 + (size_t)b * N;
  Rec* T = tape + (size_t)b * (N + 1);
  const W encmask = R::mask(kb);
  int tm0 = (int)regs[5 * b + 0];
  int tm1 = (int)regs[5 * b + 1];
  W enc = (W)regs[5 * b + 2];
  int done = regs[5 * b + 3] != 0;
  const W tailbits = (W)regs[5 * b + 4];
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
        T[np] = R::make(g, tm0, tm1, ((W)ibr << kb) | enc);
        const int new_np = np + 1;
        const W adv_enc = (enc << 1) & encmask;
        const int lsym = ((R::parity(adv_enc & poly1) << 1) ^ g1flip) |
                         (R::parity(adv_enc & poly2) ^ g2flip);
        const int4 m = m4[new_np];
        if (new_np >= tail_start) {  // known tail bits (fano.c:141-147)
          int sh = N - new_np - 1;
          sh = sh < 0 ? 0 : (sh > R::TAIL_MAX ? R::TAIL_MAX : sh);
          const int tbit = (int)((tailbits >> sh) & 1);
          tm0 = sel4(m, (tbit * 3) ^ lsym);
          tm1 = tm0;
          enc = adv_enc | (W)tbit;
        } else {
          const int a0 = sel4(m, lsym), a1 = sel4(m, 3 ^ lsym);
          const bool better1 = a1 >= a0;  // fano.c:95-104
          tm0 = better1 ? a1 : a0;
          tm1 = better1 ? a0 : a1;
          enc = adv_enc | (W)(better1 ? 1 : 0);
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
        const Rec rec = T[j];
        if (R::g(rec) < t) {  // cannot step back past j: relax at j + 1
          target = j + 1;
          break;
        }
        if (j < tail_start && (R::word(rec) >> kb) == 0) {  // untried branch
          target = j;
          toggle = true;
          break;
        }
      }
      int bg, b0, b1, bibr;
      W benc;
      if (!toggle && target == np) {  // relax where we stand
        bg = g;
        b0 = tm0;
        b1 = tm1;
        benc = enc;
        bibr = ibr;
      } else {
        const Rec rec = T[target];
        bg = R::g(rec);
        b0 = R::tm0(rec);
        b1 = R::tm1(rec);
        benc = R::word(rec) & encmask;
        bibr = (int)(R::word(rec) >> kb);
      }
      g = bg;
      tm0 = b0;
      tm1 = b1;
      np = target;
      if (toggle) {
        enc = benc ^ (W)1;
        ibr = bibr + 1;
      } else {
        enc = benc ^ (W)(bibr != 0 ? 1 : 0);
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
    if (j < np) bit = (int)(R::word(T[j]) & 1);
    else if (j == np) bit = (int)(enc & 1);
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

template <class R, bool POW2, bool MCQLI24_1024>
__global__ void fano_warp_kernel(const int4* __restrict__ metrics4,
                                 const typename R::Reg* __restrict__ regs,
                                 int B, int N_, int tail_start_, int kb_,
                                 int delta, int max_total,
                                 typename R::W poly1_, typename R::W poly2_,
                                 int g1flip_, int g2flip_,
                                 uint8_t* __restrict__ bits,
                                 int32_t* __restrict__ stats) {
  typedef typename R::W W;
  typedef typename R::Rec Rec;
  const bool S = MCQLI24_1024;
  const int N = S ? 1024 : N_;
  const int tail_start = S ? 1024 - 23 : tail_start_;
  const int kb = S ? 24 : kb_;
  const W poly1 = S ? (W)MCQLI24_POLY1 : poly1_;
  const W poly2 = S ? (W)MCQLI24_POLY2 : poly2_;
  const int g1flip = S ? 0 : g1flip_;
  const int g2flip = S ? 1 : g2flip_;
  extern __shared__ __align__(16) unsigned char fano_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: the block has no barrier
  // a lane's metrics (N records) then its tape (N + 1), rounded up to 16
  // bytes: (2N + 1) x 16 on the packed walk
  const int lane_bytes = (16 * N + (int)sizeof(Rec) * (N + 1) + 15) & ~15;
  int4* M = reinterpret_cast<int4*>(fano_smem + (size_t)warp * lane_bytes);
  Rec* T = reinterpret_cast<Rec*>(M + N);
  const unsigned m_addr = (unsigned)__cvta_generic_to_shared(M);
  const W encmask = R::mask(kb);
  // the symbol pair of an advance from enc: parity((enc << 1) & poly) =
  // parity(enc & p); and from (enc << 1) | bit: parity(...) ^ (bit & q)
  const W p1 = (poly1 >> 1) & (encmask >> 1);
  const W p2 = (poly2 >> 1) & (encmask >> 1);
  const int q1 = (int)(p1 & 1), q2 = (int)(p2 & 1);
  int tm0 = (int)regs[5 * b + 0];
  int tm1 = (int)regs[5 * b + 1];
  W enc = (W)regs[5 * b + 2];
  const bool skip = regs[5 * b + 3] != 0;
  const W tailbits = (W)regs[5 * b + 4];
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
    Rec top = R::make(0, 0, 0, 0);
    int ls = ((R::parity(enc & p1) << 1) ^ g1flip) |
             (R::parity(enc & p2) ^ g2flip);
    int tmc = tm0;  // the branch metric the forward look tries
    for (;;) {
      // the encoder step of an advance, from enc alone, and the symbol
      // pair of the advance after it for either new bit
      const W adv_enc = (enc << 1) & encmask;
      const int pa1 = R::parity(adv_enc & p1), pa2 = R::parity(adv_enc & p2);
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
        top = R::make(g, tm0, tm1, ((W)ibr << kb) | enc);
        T[np] = top;
        const int new_np = np + 1;
        int sh = N - new_np - 1;
        sh = sh < 0 ? 0 : (sh > R::TAIL_MAX ? R::TAIL_MAX : sh);
        const int tbit = (int)((tailbits >> sh) & 1);
        const bool in_tail = new_np >= tail_start;  // fano.c:141-147
        const int a0 = pick4(mn, in_tail ? (tbit * 3) ^ ls : ls);
        const int a1 = in_tail ? a0 : pick4(mn, 3 ^ ls);
        // fano.c:95-104: the better branch first (in the tail a1 == a0)
        const int bit = in_tail ? tbit : (a1 >= a0 ? 1 : 0);
        tm0 = max(a0, a1);
        tm1 = min(a0, a1);
        tmc = tm0;
        enc = adv_enc | (W)bit;
        ls = bit ? ls1 : ls0;
        g = ngamma;
        ibr = 0;
        np = new_np;
        t = t_fwd;
      } else {
        // ---------- the whole backtrack run (fano.c:169-188) ----------
        if (np == 0 || R::g(top) < t) {
          // relax where we stand: no step back past the top record
          enc ^= (W)(ibr != 0 ? 1 : 0);
          ibr = 0;
          tmc = tm0;
          t -= delta;
        } else if (np - 1 < tail_start && (R::word(top) >> kb) == 0) {
          // toggle the top record: try its other branch
          np -= 1;
          g = R::g(top);
          tm0 = R::tm0(top);
          tm1 = R::tm1(top);
          enc = (R::word(top) & encmask) ^ (W)1;
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
            const Rec rec = T[j < 0 ? 0 : j];
            relax_bits = __ballot_sync(FULL_MASK, j >= 0 && R::g(rec) < t);
            hits = relax_bits |
                   __ballot_sync(FULL_MASK, j >= 0 && j < tail_start &&
                                                (R::word(rec) >> kb) == 0);
            if (hits != 0 || hi < 32) break;
            hi -= 32;
          }
          const int i = __ffs(hits) - 1;
          const bool toggle = hits != 0 && ((relax_bits >> i) & 1u) == 0;
          np = hits == 0 ? 0 : (toggle ? hi - i : hi - i + 1);
          const Rec rec = T[np];
          const int bibr = (int)(R::word(rec) >> kb);
          g = R::g(rec);
          tm0 = R::tm0(rec);
          tm1 = R::tm1(rec);
          enc = (R::word(rec) & encmask) ^ (W)(toggle || bibr != 0 ? 1 : 0);
          ibr = toggle ? bibr + 1 : 0;  // a toggled node had ibr 0
          tmc = toggle ? tm1 : tm0;
          t = toggle ? t : t - delta;
          top = T[np >= 1 ? np - 1 : 0];
        }
        ls = ((R::parity(enc & p1) << 1) ^ g1flip) |
             (R::parity(enc & p2) ^ g2flip);
      }
      mn = lds128_here(m_addr +
                       16u * (unsigned)(np + 1 < N ? np + 1 : N - 1));
      if (++cycles >= max_total) break;  // fano.c:110 timeout
    }
  }

  // the lane's bits, coalesced: node j's bit is bit 0 of its record's
  // encoder state below np, of the registers' at np, 0 above
  __syncwarp();
  uint8_t* out = bits + (size_t)b * N;
  for (int j = lane; j < N; j += 32) {
    int bit = 0;
    if (j < np) bit = (int)(R::word(T[j]) & 1);
    else if (j == np) bit = (int)(enc & 1);
    out[j] = (uint8_t)bit;
  }
  if (lane == 0) {
    stats[4 * b + 0] = np;
    stats[4 * b + 1] = g;
    stats[4 * b + 2] = cycles;
    stats[4 * b + 3] = t;
  }
}

// One launch of either design for the words of R.  warp_lanes > 0 takes
// the "warp" design, warp_lanes lanes a block and smem bytes of dynamic
// shared memory; warp_lanes == 0 the "thread" design, with the scratch
// tape of (N + 1) records a lane in global memory.
template <class R>
static int fano_launch(const int32_t* metrics4, const typename R::Reg* regs,
                       int B, int N, int tail_start, int kb, int delta,
                       int max_total, typename R::W poly1, typename R::W poly2,
                       int g1flip, int g2flip, int warp_lanes, int smem,
                       void* tape, uint8_t* bits, int32_t* stats,
                       cudaStream_t stream, bool mcqli24_1024) {
  if (warp_lanes == 0) {
    int grid = (B + FANO_THREADS - 1) / FANO_THREADS;
    fano_kernel<R><<<grid, FANO_THREADS, 0, stream>>>(
        (const int4*)metrics4, regs, B, N, tail_start, kb, delta, max_total,
        poly1, poly2, g1flip, g2flip, (typename R::Rec*)tape, bits, stats);
    return (int)cudaGetLastError();
  }
  const bool pow2 = (delta & (delta - 1)) == 0;
  void (*kern)(const int4*, const typename R::Reg*, int, int, int, int, int,
               int, typename R::W, typename R::W, int, int, uint8_t*,
               int32_t*) = pow2 ? fano_warp_kernel<R, true, false>
                                : fano_warp_kernel<R, false, false>;
  if constexpr (R::MCQLI24) {
    if (mcqli24_1024)
      kern = pow2 ? fano_warp_kernel<R, true, true>
                  : fano_warp_kernel<R, false, true>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + warp_lanes - 1) / warp_lanes;
  kern<<<grid, 32 * warp_lanes, smem, stream>>>(
      (const int4*)metrics4, regs, B, N, tail_start, kb, delta, max_total,
      poly1, poly2, g1flip, g2flip, bits, stats);
  return (int)cudaGetLastError();
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
  const bool mcqli24_1024 = N == 1024 && tail_start == 1024 - 23 &&
                            kb == 24 && poly1 == MCQLI24_POLY1 &&
                            poly2 == MCQLI24_POLY2 && g1flip == 0 &&
                            g2flip == 1;
  return fano_launch<Packed>(metrics4, regs, B, N, tail_start, kb, delta,
                             max_total, poly1, poly2, g1flip, g2flip,
                             warp_lanes, smem, tape, bits, stats,
                             (cudaStream_t)stream, mcqli24_1024);
}

// The wide variant: regs (B, 5) int64 [tm0, tm1, enc, done, tailbits],
// 64-bit polynomials, kb <= 60; warp_lanes > 0: (16N + 24(N + 1)) bytes
// rounded up to 16 a lane; warp_lanes == 0: the scratch tape (B, N+1)
// records of 24 bytes.  Other arguments and outputs as fano_walk_launch.
extern "C" int fano_walk_wide_launch(const int32_t* metrics4,
                                     const int64_t* regs, int B, int N,
                                     int tail_start, int kb, int delta,
                                     int max_total, unsigned long long poly1,
                                     unsigned long long poly2, int g1flip,
                                     int g2flip, int warp_lanes, int smem,
                                     void* tape, uint8_t* bits,
                                     int32_t* stats, void* stream) {
  if (kb > 60) return (int)cudaErrorInvalidValue;
  return fano_launch<Wide>(metrics4, regs, B, N, tail_start, kb, delta,
                           max_total, poly1, poly2, g1flip, g2flip,
                           warp_lanes, smem, tape, bits, stats,
                           (cudaStream_t)stream, false);
}
