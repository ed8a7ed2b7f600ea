// The tensor-core ceiling of mma.sync on the card: the throughput of
// mma.sync m16n8k8 tf32 and m16n8k16 bf16 (f32 accumulation) and of
// m16n8k32 s8 (s32 accumulation) with no memory traffic, 8 independent
// accumulators a warp, 1, 2 and 4 CTAs of 8 warps per SM. The kernels of
// evdr_tpu_torch/csrc are built on these instructions (s8 in the int8full,
// int4full and pqfull modes); their shares of this ceiling, not of the
// data-sheet rates (wgmma's), say how much a kernel's own structure costs.
// Each line ends with the card's name and power limit, as
// `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
// them.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_sync_peak \
//       scripts/mma_sync_peak.cu && build/mma_sync_peak
#include <cstdio>
#include <cstring>
#include <cuda_runtime.h>
#include <stdint.h>

// KIND 0: tf32 m16n8k8, 1: bf16 m16n8k16, 2: s8 m16n8k32
template <int KIND>
__global__ void __launch_bounds__(256) k(float* out, int iters) {
  float c[8][4] = {};
  int ci[8][4] = {};
  uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b0 = 5u + blockIdx.x, b1 = 7u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[p][0]), "+f"(c[p][1]), "+f"(c[p][2]), "+f"(c[p][3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else if (KIND == 1)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[p][0]), "+f"(c[p][1]), "+f"(c[p][2]), "+f"(c[p][3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(ci[p][0]), "+r"(ci[p][1]), "+r"(ci[p][2]), "+r"(ci[p][3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0;
  for (int p = 0; p < 8; ++p)
    for (int e = 0; e < 4; ++e) s += c[p][e] + (float)ci[p][e];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

int main() {
  char card[256] = "nvidia-smi not available";
  if (FILE* f = popen("nvidia-smi --query-gpu=name,power.limit "
                      "--format=csv,noheader", "r")) {
    if (fgets(card, sizeof card, f)) card[strcspn(card, "\n")] = 0;
    pclose(f);
  }
  float* out;
  cudaMalloc(&out, 132 * 8 * 256 * 4);
  const char* names[3] = {"tf32 m16n8k8", "bf16 m16n8k16", "s8 m16n8k32"};
  const int kdim[3] = {8, 16, 32};
  for (int kind = 0; kind < 3; ++kind)
    for (int per_sm = 1; per_sm <= 4; per_sm *= 2) {
      int blocks = 132 * per_sm, iters = 20000;
      cudaEvent_t e0, e1;
      cudaEventCreate(&e0);
      cudaEventCreate(&e1);
      auto f = kind == 0 ? k<0> : kind == 1 ? k<1> : k<2>;
      f<<<blocks, 256>>>(out, 100);
      cudaEventRecord(e0);
      f<<<blocks, 256>>>(out, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      double ops = 2.0 * blocks * 8.0 * iters * 8 * (16 * 8 * kdim[kind]);
      printf("%s %d CTAs/SM of 8 warps: %.1f T%s/s (%.3f ms); %s\n",
             names[kind], per_sm, ops / ms / 1e9, kind == 2 ? "OP" : "FLOP",
             ms, card);
    }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
