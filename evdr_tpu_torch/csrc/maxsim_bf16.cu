// K1: fused masked MaxSim over a bf16 page index, for Hopper (sm_90a), on
// wgmma and TMA.
//
// Replaces: evdr_tpu/ops/pallas_maxsim.py:_kernel (driver
// _maxsim_pallas_fwd, public entry maxsim_pallas).
//
// What bounds it on the H100: operations. At the serving shape (256
// queries x 32 tokens against pages of 768 tokens, D = 128) every page
// element meets all 8192 query-token rows: 8192 operations per byte, far
// above the ~295 per byte where bf16 tensor cores stop waiting on memory.
// mma.sync, which the shared tile loop (maxsim_tile.cuh) issues, reaches
// ~634 of the data sheet's 989 TFLOP/s on an NVIDIA H100 80GB HBM3 at a
// 700.00 W power limit (scripts/mma_sync_peak.cu, PERF.md section 3);
// wgmma is the only way to the rest. So K1 is a kernel of its own:
// - A CTA of three warpgroups: two consumer warpgroups of 128 query-token
//   rows each (256 rows a CTA: the floor(256 / Lq) whole queries starting
//   at blockIdx.x * qb) and one producer warpgroup, of which one warp
//   works. setmaxnreg moves the producer's registers to the consumers.
// - TMA brings both operands into shared memory in the 128-byte swizzled
//   layout wgmma reads: the pages as a 2-D (nd * Lp, D) tensor, the queries
//   as (nq * Lq, D), in boxes of 64 elements (128 bytes) by the tile's rows,
//   one box per 64 columns (D = 80 takes two, TMA fills columns 80-127 with
//   zeros). The tensor maps are encoded on the host for every call (they
//   hold the pointers) by cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint: the build links no -lcuda. The query block is
//   one load a 64-column chunk, once per CTA.
// - A ring of page-tile stages, each with a full and an empty mbarrier.
//   The producer warp waits for a free stage, sets the bytes to expect and
//   issues the tile's loads, and its 32 lanes write the tile's column
//   scales from pmask (1 for a valid token, -1 for an invalid one, for a
//   token of the next doc and for rows past the tensor's end, which TMA
//   fills with zeros) before they arrive. Each doc's tokens start a tile of
//   their own; the ragged tail is masked.
// - Each consumer warpgroup issues wgmma.mma_async m64nNk16 (bf16 inputs,
//   f32 accumulators, A and B from shared memory through 128B-swizzle
//   descriptors), two m64 products per k-step, D / 16 k-steps per tile, in
//   k order. The accumulators hold rows 16w + g and 16w + g + 8 of each
//   64-row block and columns 8j + 2t, 8j + 2t + 1: mma.sync's layout, so
//   the masked running max is taken from them as the tile loop does (a
//   valid token's similarity, -1e30 for an invalid one; the select equals
//   maxsim_tile.cuh's masked() for scales of +-1) and kept in registers
//   across the doc's tiles. Each warp then releases the stage.
// - At a doc's end the quad's maxima combine by shuffles (a warpgroup
//   spans every column of the tile, so no other warp holds the row), the
//   no-valid-token rule and the query-token weight apply, and after a
//   named barrier of the 256 consumer threads (bar.sync 1, 256: the
//   producer never waits on an epilogue) one thread per query sums its Lq
//   rows in order into out[q, d]. The row buffer alternates by doc parity.
// - blockIdx.x (the query block) varies fastest, so the CTAs in flight
//   together share a few docs and read their pages from L2.
// - The rule by D (bf16_plan): page tiles of kTileN = 128 tokens while
//   two stages of them fit beside the query block, else 64; then as many
//   stages as fit in 232,448 bytes, at most kMaxStages = 4. D <= 128: 128
//   tokens, 4 stages (201,800 bytes at D = 128); D 144-192: 128 tokens, 2
//   stages (200,744 at 192); D 208-256: 64 tokens, 2 stages (200,232 at
//   256).
//
// - Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
//   (scripts/torch_kernel_ab.py at 20,000 pages, PERF.md section 6): 2.5x faster than the mma.sync loop it replaced (133.8 ->
//   51.9 ms), which on K2's wide tiles (CfgWide) reached 107.3. The two
//   64-row halves' products alternate k-step by k-step; issuing one half's
//   k-steps and then the other's cost 8% (two calls, against the same
//   parent), 64-token tiles 31%, the two warpgroups issuing in turns
//   (named barriers) 52% (1% with the unrolled loop), and issuing each
//   half's next tile right after its max 13-31%. 2, 3 and 4 stages and 8
//   or 16 docs a CTA measured alike; the loop unrolled for D = 128 gained
//   4.6%.
//
// Numerics: bf16 products with f32 accumulation in k order. wgmma need not
// round inside a k-step as mma.sync does, so the scores may differ from the
// mma.sync loop's in the last bits (at the A/B's shapes they were
// bit-equal); they are held to the plain version.
//
// C interface (loaded with ctypes; every pointer and the stream is a
// void*): q (nq, lq, d) bf16, qw (nq, lq) f32 query-token weights (the
// mask as 0/1), p (nd, lp, d) bf16, pmask (nd, lp) bool as bytes,
// out (nq, nd) f32; q and p 16-byte aligned. Returns cudaGetLastError()
// after the launch, or minus the CUresult of a refused tensor-map encode.
// evdr_bf16_config reports the configuration a call at width d runs.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include "maxsim_tile.cuh"

namespace evdr {
namespace {

constexpr int kBfConsumers = 2;              // consumer warpgroups
constexpr int kBfRows = 128 * kBfConsumers;  // query-token rows a CTA
constexpr int kBfThreads = 128 * (kBfConsumers + 1);
constexpr int kBfDocs = 8;      // docs per CTA
constexpr int kBoxK = 64;       // bf16 elements in a 128-byte swizzled row
constexpr int kTileN = 128;     // page tokens a tile, where two stages fit
constexpr int kMaxStages = 4;
// The k-loop is unrolled at compile time for this many k-steps (D = 128,
// the serving width: 4.6% faster on the card of the header's measurements,
// PERF.md section 6), beside the loop over any D.
constexpr int kUnrolledKSteps = 8;
constexpr int kSmemCap = 232448;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared-memory carve-up, in bytes from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes): the query block, one
// 128-byte column chunk after another ([chunk][kBfRows][64]); the stages,
// each [chunk][n][64]; each stage's n column scales; two row buffers; the
// barriers. `total` adds the slack that aligns the base.
struct BfLayout {
  int n, stages, chunks;
  uint32_t b, stage_bytes, colscale, red, bars, total;
};

__host__ __device__ inline BfLayout bf16_layout(int d, int n, int stages) {
  BfLayout L;
  L.n = n;
  L.stages = stages;
  L.chunks = (d + kBoxK - 1) / kBoxK;
  L.b = (uint32_t)L.chunks * kBfRows * 128;
  L.stage_bytes = (uint32_t)L.chunks * n * 128;
  L.colscale = L.b + stages * L.stage_bytes;
  L.red = L.colscale + stages * n * 4;
  L.bars = L.red + 2 * kBfRows * 4;
  L.total = L.bars + (2 * stages + 1) * 8 + 1024;
  return L;
}

// ---------------------------------------------------------------- PTX

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ inline void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D box of the tensor `map` at (column c0, row c1) into shared memory,
// completing `bytes` of the barrier's expected transactions.
__device__ inline void tma_load(void* dst, const CUtensorMap* map, int c0,
                                int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address / 16, leading offset 1 (unused by this layout),
// stride 1024 bytes (8 rows of 128 bytes) / 16, layout 1 (128B swizzle).
// A k-step of 16 elements further into the chunk adds 32 bytes (2) to the
// start address.
__device__ inline uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int M> __device__ inline void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B^T over one k-step of 16: A 64 rows x 16 (desc da), B N rows
// x 16 (desc db), both K-major; `accumulate` 0 overwrites d.
__device__ inline void wgmma(float (&d)[32], uint64_t da, uint64_t db,
                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ inline void wgmma(float (&d)[64], uint64_t da, uint64_t db,
                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ------------------------------------------------------------- kernel

template <int N, int KSTEPS>
__global__ void __launch_bounds__(kBfThreads, 1)
maxsim_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_p,
                   const float* __restrict__ qw,
                   const uint8_t* __restrict__ pmask, float* __restrict__ out,
                   int nq, int lq, int nd, int lp, int d, int qb, int db,
                   int stages) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const BfLayout L = bf16_layout(d, N, stages);
  unsigned char* As = smem;
  unsigned char* Bs = smem + L.b;
  float* colscale = reinterpret_cast<float*>(smem + L.colscale);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  uint64_t* qbar = empty + stages;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;
  const int q0 = blockIdx.x * qb;
  const int nq_here = min(qb, nq - q0);
  const int nrows = nq_here * lq;
  const int row0 = q0 * lq;
  const int d_begin = blockIdx.y * db;
  const int n_tiles = (lp + N - 1) / N;
  const int total = (min(nd, d_begin + db) - d_begin) * n_tiles;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 32);                 // the producer warp's lanes
      mbar_init(empty + s, 4 * kBfConsumers);  // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kBfConsumers) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp != 4 * kBfConsumers) return;
    if (lane == 0) {
      mbar_arrive_tx(qbar, (uint32_t)L.chunks * kBfRows * 128);
      for (int c = 0; c < L.chunks; ++c)
        tma_load(As + c * kBfRows * 128, &tm_q, c * kBoxK, row0, qbar);
    }
    for (int it = 0; it < total; ++it) {
      const int s = it % stages;
      mbar_wait(empty + s, ((it / stages) & 1) ^ 1);
      const int dd = d_begin + it / n_tiles;
      const int l0 = (it % n_tiles) * N;
      const int ntok = min(N, lp - l0);
      const int tok0 = dd * lp + l0;  // < nd * lp < 2^31 (the launcher)
      for (int c = lane; c < N; c += 32)
        colscale[s * N + c] = (c < ntok && pmask[tok0 + c]) ? 1.f : -1.f;
      if (lane == 0) {
        mbar_arrive_tx(full + s, L.stage_bytes);
        unsigned char* dst = Bs + s * L.stage_bytes;
        for (int c = 0; c < L.chunks; ++c)
          tma_load(dst + c * N * 128, &tm_p, c * kBoxK, tok0, full + s);
      } else {
        mbar_arrive(full + s);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int w = warp % 4;
    const int g = lane / 4, t = lane % 4;
    // this thread's rows: wg * 128 + i * 64 + w * 16 + h * 8 + g
    float qwr[2][2], mx[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 128 + i * 64 + w * 16 + h * 8 + g;
        qwr[i][h] = r < nrows ? qw[row0 + r] : 0.f;
        mx[i][h] = kNegInit;
      }
    float acc[2][N / 2];
    const uint64_t a_desc = sw128_desc(smem_addr(As) + wg * 128 * 128);
    const uint64_t b_desc = sw128_desc(smem_addr(Bs));
    const int ksteps = KSTEPS > 0 ? KSTEPS : d / 16;
    mbar_wait(qbar, 0);

    for (int it = 0; it < total; ++it) {
      const int s = it % stages;
      mbar_wait(full + s, (it / stages) & 1);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
#pragma unroll(KSTEPS > 0 ? KSTEPS : 1)
      for (int k = 0; k < ksteps; ++k) {
        // chunk k / 4, 32 bytes a k-step within it (descriptor units of 16
        // bytes); the two 64-row halves take turns, so that consecutive
        // products never wait on each other's accumulators
        const uint32_t kb = (k % 4) * 2;
        const uint64_t db_ =
            b_desc + ((s * L.stage_bytes + (k / 4) * N * 128) >> 4) + kb;
        const uint64_t da = a_desc + (((k / 4) * kBfRows * 128) >> 4) + kb;
        wgmma(acc[0], da, db_, k);
        wgmma(acc[1], da + ((64 * 128) >> 4), db_, k);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc[0]);
      fence_regs(acc[1]);

      // masked running max of this tile's columns 8j + 2t, 8j + 2t + 1
      const float* cs = colscale + s * N + 2 * t;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 c = *reinterpret_cast<const float2*>(cs + 8 * j);
        const bool v0 = c.x >= 0.f, v1 = c.y >= 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i][0] = fmaxf(mx[i][0],
                           fmaxf(v0 ? acc[i][4 * j] : kNegInit,
                                 v1 ? acc[i][4 * j + 1] : kNegInit));
          mx[i][1] = fmaxf(mx[i][1],
                           fmaxf(v0 ? acc[i][4 * j + 2] : kNegInit,
                                 v1 ? acc[i][4 * j + 3] : kNegInit));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);  // the stage is free

      if (it % n_tiles == n_tiles - 1) {
        // doc epilogue: the quad's maxima, the no-valid-token rule and the
        // weight per row; then each query's Lq rows, in order
        const int doc = it / n_tiles;
        float* rr = red + (doc & 1) * kBfRows;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float m = mx[i][h];
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            if (t == 0)
              rr[wg * 128 + i * 64 + w * 16 + h * 8 + g] =
                  (m > kNegThresh ? m : 0.f) * qwr[i][h];
            mx[i][h] = kNegInit;
          }
        asm volatile("bar.sync 1, %0;\n" ::"n"(kBfRows) : "memory");
        if (tid < nq_here) {
          float sum = 0.f;
          for (int r = 0; r < lq; ++r) sum += rr[tid * lq + r];
          out[(size_t)(q0 + tid) * nd + d_begin + doc] = sum;
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (null where the
// installed CUDA library does not export it).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A (rows, d) row-major bf16 tensor in boxes of 64 columns x box_rows rows,
// 128-byte swizzled, zeros outside the tensor. Returns 0 or minus the
// CUresult.
int encode_rows(CUtensorMap* map, const void* base, int rows, int d,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

using BfKernel = void (*)(const CUtensorMap, const CUtensorMap, const float*,
                          const uint8_t*, float*, int, int, int, int, int,
                          int, int, int);

// The configuration a call at width d runs: the rule by D (see the
// header), the kernel it selects, and that kernel's shared-memory size.
int bf16_plan(int d, BfLayout* L, BfKernel* kern) {
  int n = kTileN;
  if (bf16_layout(d, n, 2).total > kSmemCap) n = 64;
  int s = kMaxStages;
  while (s > 2 && bf16_layout(d, n, s).total > kSmemCap) --s;
  *L = bf16_layout(d, n, s);
  if (L->total > kSmemCap) return (int)cudaErrorInvalidValue;
  if (kUnrolledKSteps > 0 && n == kTileN && d == 16 * kUnrolledKSteps)
    *kern = maxsim_bf16_kernel<kTileN, kUnrolledKSteps>;
  else
    *kern = n == kTileN ? maxsim_bf16_kernel<kTileN, 0>
                        : maxsim_bf16_kernel<64, 0>;
  return (int)cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L->total);
}

}  // namespace
}  // namespace evdr

extern "C" int evdr_maxsim_bf16(const void* q, const void* qw, const void* p,
                                const void* pmask, void* out, int nq, int lq,
                                int nd, int lp, int d, void* stream) {
  using namespace evdr;
  if (nq < 1 || nd < 1 || lp < 1 || lq < 1 || lq > kBfRows || d < 16 ||
      d % 16 != 0 || (long long)nd * lp >= (1LL << 31) ||
      (long long)nq * lq >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  BfLayout L;
  BfKernel kern;
  int e = bf16_plan(d, &L, &kern);
  if (e != 0) return e;
  alignas(64) CUtensorMap tm_q, tm_p;
  if ((e = encode_rows(&tm_q, q, nq * lq, d, kBfRows)) != 0) return e;
  if ((e = encode_rows(&tm_p, p, nd * lp, d, L.n)) != 0) return e;
  const int qb = kBfRows / lq;
  int db = kBfDocs;
  if ((nd + db - 1) / db > kMaxGridY) db = (nd + kMaxGridY - 1) / kMaxGridY;
  dim3 grid((nq + qb - 1) / qb, (nd + db - 1) / db);
  kern<<<grid, kBfThreads, L.total, (cudaStream_t)stream>>>(
      tm_q, tm_p, static_cast<const float*>(qw),
      static_cast<const uint8_t*>(pmask), static_cast<float*>(out), nq, lq,
      nd, lp, d, qb, db, L.stages);
  return (int)cudaGetLastError();
}

// The configuration a call at width d runs, on the current GPU: out[0]
// CTAs per SM, out[1] query-token rows a CTA, out[2] page tokens a tile,
// out[3] stages, out[4] consumer warpgroups, out[5] shared-memory bytes.
extern "C" int evdr_bf16_config(int d, void* out) {
  using namespace evdr;
  int* o = static_cast<int*>(out);
  BfLayout L;
  BfKernel kern;
  const int e = bf16_plan(d, &L, &kern);
  if (e != 0) return e;
  o[1] = kBfRows;
  o[2] = L.n;
  o[3] = L.stages;
  o[4] = kBfConsumers;
  o[5] = (int)L.total;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[0], kern, kBfThreads, L.total);
}
