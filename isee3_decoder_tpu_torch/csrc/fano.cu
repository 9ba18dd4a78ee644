// Kernel K4 of the PyTorch/CUDA port: the whole collapsed-backtrack Fano
// walk (fano.c:110-189) for a batch of independent lanes.
//
// Replaces the TPU kernel `kernel` inside _fano_walk_pallas
// (isee3_decoder_tpu/ops/fano_pallas.py:106, entry fano_decode_pallas :308).
// On the TPU every lane steps in lockstep and each per-lane tape access is
// a masked one-hot reduction over the whole VMEM tape (fano_pallas.py:
// 146-176), because the vector unit has no per-lane gather.  Here one
// thread owns one lane and runs the serial walk directly:
//   - the push-down tape is a per-lane array of int4 records
//     {gamma, tm0, tm1, (ibr << kb) | enc} in global memory, so a push or
//     a resume is one 16-byte store or load that stays in L1/L2;
//   - the two "last index below np where ..." maxima that resolve a
//     whole backtrack run (fano_pallas.py:146-158) become one backward
//     scan that stops at its first hit: the first node from the top with
//     gamma < t means relax at that node + 1, the first with an untried
//     second branch (ibr == 0, below the tail) means toggle there;
//   - cycles count collapsed micro-steps exactly as the JAX walk does
//     (one per forward look; the run a violation resolves costs none),
//     and the timeout test follows the same order.
// What bounds it on the H100: latency of a serial, data-dependent walk —
// one dependent L1/L2 access per micro-step per lane, and at most a few
// hundred lanes, so only a few warps are resident.  A lane that times
// out walks maxcycles * nbits micro-steps (12,288 at the tier-1 cap,
// 102,400 at full budget); lanes finish independently, so a block's
// time is that of its slowest lane, not of the whole batch.
// Metric precompute (_metrics4) and the root-node setup stay in PyTorch,
// as they stay in jnp outside the Pallas call.

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

// metrics4 (B, N, 4) int32; regs (B, 5) int32 [tm0, tm1, enc, done,
// tailbits]; scratch tape (B, N+1, 4) int32; outputs bits (B, N) uint8
// (nodes above the final np are 0) and stats (B, 4) int32 [np, gamma,
// cycles, t].
extern "C" int fano_walk_launch(const int32_t* metrics4, const int32_t* regs,
                                int B, int N, int tail_start, int kb, int delta,
                                int max_total, int poly1, int poly2, int g1flip,
                                int g2flip, int32_t* tape, uint8_t* bits,
                                int32_t* stats, void* stream) {
  int grid = (B + FANO_THREADS - 1) / FANO_THREADS;
  fano_kernel<<<grid, FANO_THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)metrics4, regs, B, N, tail_start, kb, delta, max_total,
      poly1, poly2, g1flip, g2flip, (int4*)tape, bits, stats);
  return (int)cudaGetLastError();
}
