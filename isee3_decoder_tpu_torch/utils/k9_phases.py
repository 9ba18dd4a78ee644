"""Where K9's time goes: the pm scan kernel's phases in clock cycles.

    python isee3_decoder_tpu_torch/utils/k9_phases.py [--variant NAME ...]

writes a copy of csrc/carrier.cu in which thread 0 of every block adds
clock64() deltas per phase of each pm block t (window, column-DFT passes,
outer sum, bin finish, peak, moments, emission, stats), appends a main()
that launches ``pm_scan_launch`` at the bench shape (128 x 32 x 65,536,
K = 107, packed words from a fixed LCG, carriers 20 kHz + 137 Hz·i),
builds it with nvcc for sm_90a under build/k9_phases/ (no torch) and
prints one JSON line per variant: CUDA-event ms per launch over 5
launches and the mean cycles per block t of each phase.  Variants:

- ``kernel``: the kernel as it is;
- ``emit-coalesced``: the emission pass stages each 4096-sample tile's
  prefix sums in shared memory and writes them with coalesced stores (the
  same values): a probe of what the kernel's strided int32 stores cost.

Needs nvcc and a CUDA card; imports nothing of the package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
SRC = ROOT / "isee3_decoder_tpu_torch" / "csrc" / "carrier.cu"
OUT = ROOT / "build" / "k9_phases"
NVCC = "/usr/local/cuda/bin/nvcc"
PHASES = ("window", "column_passes", "outer_sum", "finish", "peak",
          "moments", "emission", "stats")

# (text in the kernel, phase index whose clock stops right after it)
STAMPS = (
    ("    const int first1 = s_first1;\n", 0),
    ("        column_dft256_pass(row, C, CD_COLS * p, flip, tw256, Tx, Ys);\n", 1),
    ("        outer_sum_pass(Ys, pw + (p & 1) * CD_BINS + warp * CD_NBW, u0, acc);\n", 2),
    ("      outer_sum_finish(tab, n, u0, k0 + warp, K, acc, spec);\n    }\n"
     "    __syncthreads();\n", 3),
    ("    const float c = s_cyc;\n", 4),
    ("    const float ur = s_ur, ui = s_ui;\n", 5),
    ("    // ---- stats and the carry into block t+1\n", 6),
    ("  for (int t = 1; t < T; ++t) {\n", 7),
)

STORE = """#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int idx = base + tid * SCAN_ITEMS + k;
        if (idx < n) dst[idx] = (int32_t)acc2;
        acc2 += (uint32_t)v[k];
      }
"""
STORE_COALESCED = """      uint32_t* stg = (uint32_t*)Ys;  // free during the emission
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int wd = tid * SCAN_ITEMS + k;
        stg[wd + (wd >> 5)] = acc2;
        acc2 += (uint32_t)v[k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int wd = k * SCAN_THREADS + tid;
        if (base + wd < n) dst[base + wd] = (int32_t)stg[wd + (wd >> 5)];
      }
"""

MAIN = r"""
#include <cstdio>
#include <vector>
int main() {
  const int B = 128, T = 32, n = 65536, K = 107;
  const size_t words = (size_t)B * T * n;
  std::vector<int32_t> h(words);
  uint32_t x = 12345u;
  for (size_t i = 0; i < words; ++i) {
    x = x * 1664525u + 1013904223u;
    h[i] = (int32_t)x;
  }
  int32_t *packed, *csum, *tot;
  int16_t* bb0;
  float *init, *stat, *tab;
  cudaMalloc(&packed, words * 4);
  cudaMemcpy(packed, h.data(), words * 4, cudaMemcpyHostToDevice);
  cudaMalloc(&bb0, (size_t)B * n * 2);
  cudaMemset(bb0, 0, (size_t)B * n * 2);
  std::vector<float> hi(B * 4);
  for (int b = 0; b < B; ++b) {
    hi[4 * b] = 1.0f;
    hi[4 * b + 1] = 60.0f;
    hi[4 * b + 2] = hi[4 * b + 3] = 20000.0f + 137.0f * b;
  }
  cudaMalloc(&init, B * 16);
  cudaMemcpy(init, hi.data(), B * 16, cudaMemcpyHostToDevice);
  cudaMalloc(&csum, (size_t)B * ((size_t)T * n + 1) * 4);
  cudaMalloc(&stat, (size_t)B * T * 24);
  cudaMalloc(&tot, B * 4);
  cudaMalloc(&tab, (size_t)n * 8);
  twiddle_table_launch(n, tab, 0);
  const float fs = 250000.0f, bsz = fs / n;
  const int smem = (16 * 16 * 32 + 256 * 32 + 256 + 256 + K) * 8;
  auto go = [&]() {
    return pm_scan_launch(packed, (long long)T * n, bb0, init, B, T, n, K, fs,
                          bsz, 200.0f, -100.0f, fs / 2 - bsz, 0, 1, tab, smem,
                          csum, stat, tot, 0);
  };
  int err = go();
  cudaDeviceSynchronize();
  if (err || cudaGetLastError() != cudaSuccess) {
    fprintf(stderr, "launch error %d\n", err);
    return 1;
  }
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  for (int r = 0; r < 5; ++r) go();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  long long hc[128 * 8];
  cudaMemcpyFromSymbol(hc, g_clk, sizeof(hc));
  printf("%.6f", ms / 5);
  for (int i = 0; i < 8; ++i) {
    double m = 0.0;
    for (int b = 0; b < B; ++b) m += hc[b * 8 + i] / (double)B / (T - 1);
    printf(" %.1f", m);
  }
  printf("\n");
  return 0;
}
"""


def instrumented(src: str, variant: str) -> str:
    """carrier.cu with the phase clocks (and the variant's change)."""
    for text, i in STAMPS:
        if src.count(text) != 1:
            raise SystemExit(f"k9_phases: kernel text not found once: {text!r}")
        src = src.replace(text, text + (
            f"    if (tid == 0) {{ const long long now_ = clock64(); "
            f"clk_[{i}] += now_ - last_; last_ = now_; }}\n"))
    edits = [
        ("  const Chirp none = {0.0f, 0.0f, 0.0f, 0.0f};\n",
         "  long long clk_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
         "  long long last_ = clock64();\n"),
        ("  if (tid == 0) tot[b] = (int32_t)carry;\n",
         "  if (tid == 0)\n    for (int i_ = 0; i_ < 8; ++i_) "
         "g_clk[b * 8 + i_] = clk_[i_];\n"),
    ]
    for text, add in edits:
        if src.count(text) != 1:
            raise SystemExit(f"k9_phases: kernel text not found once: {text!r}")
        src = src.replace(text, text + add)
    src = src.replace("#define SCAN_THREADS 512\n",
                      "__device__ long long g_clk[128 * 8];  // per block\n"
                      "#define SCAN_THREADS 512\n")
    if variant == "emit-coalesced":
        if src.count(STORE) != 1:
            raise SystemExit("k9_phases: the emission's store loop not found")
        src = src.replace(STORE, STORE_COALESCED)
    return src + MAIN


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", nargs="+", default=["kernel"],
                    choices=["kernel", "emit-coalesced"])
    args = ap.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    src = SRC.read_text()
    builds = {}
    for v in args.variant:
        cu = OUT / f"k9_{v}.cu"
        cu.write_text(instrumented(src, v))
        builds[v] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             "-o", str(OUT / f"k9_{v}"), str(cu)])
    rc = 0
    for v, proc in builds.items():
        if proc.wait() != 0:
            print(f"k9_phases: nvcc failed for {v}", file=sys.stderr)
            return 1
    for v in args.variant:
        run = subprocess.run([str(OUT / f"k9_{v}")], capture_output=True,
                             text=True, timeout=300)
        if run.returncode != 0:
            print(run.stderr, file=sys.stderr)
            rc = 1
            continue
        ms, *cyc = (float(f) for f in run.stdout.split())
        print(json.dumps({"variant": v, "card": card,
                          "shape": "128 x 32 x 65536, K = 107",
                          "ms_per_launch": ms,
                          "cycles_per_block": dict(zip(PHASES, cyc)),
                          "cycles_total": sum(cyc)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
