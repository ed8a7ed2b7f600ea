// The tensor-core ceiling of mma.sync on the card: the throughput of
// mma.sync m16n8k8 tf32 and m16n8k16 bf16 (f32 accumulation) with no
// memory traffic, 8 independent accumulators a warp, 1, 2 and 4 CTAs of 8
// warps per SM. The kernels of evdr_tpu_torch/csrc are built on these
// instructions; their shares of this ceiling, not of the data-sheet rates
// (wgmma's), say how much a kernel's own structure costs.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_sync_peak \
//       scripts/mma_sync_peak.cu && build/mma_sync_peak
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
template <int KIND>
__global__ void __launch_bounds__(256) k(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b0 = 5u + blockIdx.x, b1 = 7u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[p][0]), "+f"(c[p][1]), "+f"(c[p][2]), "+f"(c[p][3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[p][0]), "+f"(c[p][1]), "+f"(c[p][2]), "+f"(c[p][3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0; for (int p = 0; p < 8; ++p) for (int e = 0; e < 4; ++e) s += c[p][e];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
int main() {
  float* out; cudaMalloc(&out, 132 * 8 * 256 * 4);
  for (int kind = 0; kind < 2; ++kind)
    for (int per_sm = 1; per_sm <= 4; per_sm *= 2) {
      int blocks = 132 * per_sm, iters = 20000;
      cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
      auto f = kind == 0 ? k<0> : k<1>;
      f<<<blocks, 256>>>(out, 100);
      cudaEventRecord(e0); f<<<blocks, 256>>>(out, iters); cudaEventRecord(e1); cudaEventSynchronize(e1);
      float ms; cudaEventElapsedTime(&ms, e0, e1);
      double flop = 2.0 * blocks * 8.0 * iters * 8 * (kind == 0 ? 16 * 8 * 8 : 16 * 8 * 16);
      printf("%s %d CTAs/SM of 8 warps: %.1f TFLOP/s (%.3f ms)\n", kind == 0 ? "tf32 m16n8k8" : "bf16 m16n8k16", per_sm, flop / ms / 1e9, ms);
    }
  return 0;
}
