// K2 int8full on wgmma and TMA, for Hopper (sm_90a): the masked MaxSim of
// int8 queries against an int8 page index with per-token f32 scales, at
// pages of at least one whole page tile (the wrapper's rule, cuda_maxsim.
// int8full_func; shorter pages keep maxsim_int8.cu's mma.sync loop, D
// above 256 its wide function).
//
// Replaces: evdr_tpu/ops/pallas_maxsim.py:_kernel_int8 with _int8_simT
// (driver _maxsim_int8_impl, public entry maxsim_pallas_int8full), which
// maxsim_int8.cu's evdr_maxsim_int8full ported to mma.sync. This kernel
// computes exactly what that one computes (maxsim_tile.cuh's
// maxsim_kernel<kInt8Int8, false, CfgWide>), bit for bit.
//
// What bounds it on the H100: the epilogue, then the operations. At the
// serving shape (256 queries x 32 tokens against pages of 768 tokens, D =
// 128) every code byte meets all 8192 query-token rows; the int8 tensor
// cores' 1,979 TOP/s are reached only through wgmma, and at that rate the
// products of every (padded) pair take ~31 ms a call over 41,005 pages.
// Each similarity then needs a conversion, a scale, a mask and a max: the
// mma.sync loop's I2FP.F32.S32 conversions and the products were issued by
// the same warps and added up. The design:
// - K1 bf16's structure (maxsim_bf16.cu): a CTA of two consumer
//   warpgroups of 128 query-token rows each (256 rows: the floor(256 / Lq)
//   whole queries starting at blockIdx.x * qb), four producer warps, and
//   setmaxnreg moving the producers' registers to the consumers.
// - TMA brings both operands in the 128-byte swizzle: the index as a 2-D
//   (nd * Lp, D) int8 tensor, whose 128-byte rows at D = 128 fill the
//   swizzle exactly (D 144-256 take two column chunks; TMA fills the
//   columns past D with zeros), the int8 query block once per CTA.
// - A ring of kWgStages page-tile stages of 128 tokens on full and empty
//   mbarriers. Producer warp w fills the stages s with s % 4 == w, so each
//   stage's uses are filled in order by one warp and the warps' reads of
//   the scales and the mask overlap. Each doc's tokens start a tile of
//   their own. A tile column's weight is its token's scale, or NaN for an
//   invalid token, a token of the next doc or a row past the tensor's end:
//   fmaxf drops a NaN operand, so an invalid column never wins a max, and a
//   row whose doc has no valid token keeps -1e30, as maxsim_tile.cuh's
//   masked() gives it (every valid similarity is far above -1e30). One
//   float a column halves the shared-memory reads of a (scale, bias) pair.
// - Each consumer warpgroup issues wgmma.mma_async m64n128k32 s32.s8.s8
//   from swizzled shared-memory descriptors (8-bit wgmma takes both
//   operands K-major, which both layouts are), D / 32 k-steps a tile in k
//   order, the first one overwriting the accumulators.
// - The two 64-row halves of a warpgroup take turns: half 1's masked max
//   of a tile runs while half 0's products of the next tile are in flight,
//   and half 0's max while half 1's products are. No commit group stays
//   open across a branch or the loop's back edge, so ptxas can follow the
//   groups and keeps the products asynchronous (an open group across them
//   made ptxas serialize every wgmma: C7514/C7515).
// - At a doc's end: the quad's maxima combine by shuffles, the
//   no-valid-token rule and the weight qw apply, and after a named barrier
//   of the 256 consumer threads one thread per query sums its Lq rows in
//   order into out[q, d], as K1 and the mma.sync loop do.
//
// Numerics: the int32 sums are exact in any k order, I2FP converts them
// exactly (|sum| <= D * 128^2 <= 2^22 < 2^24), the scale rounds once
// (x * s, as masked()), the max is exact and the Lq-sum runs in the
// mma.sync loop's order: the scores equal evdr_maxsim_int8full's bit for
// bit (a product of zero may differ in the sign of its zero, which no
// score can show: a query's sum starts at +0).
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (scripts/torch_kernel_ab.py, PERF.md section 6), 256 x 32 queries: 71.6
// ms against the mma.sync loop's 172.5 over 41,005 x 768 pages, 35.1
// against 84.0 over 20,000, the scores bit-equal; 168 registers before
// setmaxnreg, 103,496 bytes of shared memory at D = 128. Variants, each
// timed against the mma.sync loop in one call (76.2-76.5 ms for this
// design there): the int32 -> f32 conversion folded into the accumulator
// (each accumulator set to 0x4B400000, the bits of 1.5 * 2^23, before the
// products, then one FP32 subtract) 80.1-80.7 ms, its 64 moves a half on
// the path to each issue; the moves right after the max instead made ptxas
// serialize the products (81.4); the same constant added in the epilogue
// (an integer add and a subtract) 81.1; the epilogue alone (products left
// out) reads 53.9-55.7 ms with I2FP, 41.1 with the folded conversion and
// 58.0 with the added constant; a (scale, bias) pair and an FMA a column
// 83.1; both halves' products and then both maxima 86.4-87.6; the
// warpgroups issuing in turns (named barriers) 78.8; two partial maxima a
// row, 8 stages, 16 or 32 docs a CTA, one producer warp: within 2%. At
// Lp 64 over 100,000 pages, where half of each tile is the next doc's
// tokens, this kernel takes 43.8-44.2 ms and the mma.sync loop 45.3-45.7.
//
// C interface: as evdr_maxsim_int8full (maxsim_int8.cu): q (nq, lq, d)
// int8, qw (nq, lq) f32, p (nd, lp, d) int8, scales (nd, lp) f32, pmask
// (nd, lp) bool as bytes, out (nq, nd) f32; q and p 16-byte aligned;
// 16 <= d <= 256, d a multiple of 16, nd * lp < 2^31. Returns
// cudaGetLastError() after the launch, or minus the CUresult of a refused
// tensor-map encode. evdr_int8full_wg_config reports the configuration a
// call at width d runs.
#include "hopper.cuh"

namespace evdr {
namespace {

constexpr int kWgConsumers = 2;              // consumer warpgroups
constexpr int kWgRows = 128 * kWgConsumers;  // query-token rows a CTA
constexpr int kWgProducers = 4;              // producer warps
constexpr int kWgThreads = 128 * (kWgConsumers + 1);
constexpr int kWgDocs = 8;      // docs per CTA
constexpr int kWgTileN = 128;   // page tokens a tile
constexpr int kWgStages = 4;    // a multiple of kWgProducers
constexpr int kS8BoxK = 128;    // int8 elements in a 128-byte swizzled row
// The k-loop is unrolled at compile time for this many k-steps (D = 128,
// the serving width), beside the loop over any D.
constexpr int kWgUnrolledKSteps = 4;
constexpr int kWgSmemCap = 232448;
constexpr int kWgProducerRegs = 40, kWgConsumerRegs = 232;

// Shared-memory carve-up, in bytes from a 1024-byte aligned base: the
// query block ([chunk][kWgRows][128]), the stages ([chunk][n][128] each),
// each stage's n column weights, two row buffers, the barriers. `total`
// adds the slack that aligns the base.
struct WgLayout {
  int n, stages, chunks;
  uint32_t b, stage_bytes, colw, red, bars, total;
};

__host__ __device__ inline WgLayout wg_layout(int d, int n, int stages) {
  WgLayout L;
  L.n = n;
  L.stages = stages;
  L.chunks = (d + kS8BoxK - 1) / kS8BoxK;
  L.b = (uint32_t)L.chunks * kWgRows * 128;
  L.stage_bytes = (uint32_t)L.chunks * n * 128;
  L.colw = L.b + stages * L.stage_bytes;
  L.red = L.colw + stages * n * 4;
  L.bars = L.red + 2 * kWgRows * 4;
  L.total = L.bars + (2 * stages + 1) * 8 + 1024;
  return L;
}

// d (+)= A . B^T over one k-step of 32: A 64 rows x 32 (desc da), B 128
// rows x 32 (desc db), both K-major int8, s32 accumulators; `accumulate`
// 0 overwrites d.
__device__ inline void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db,
                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ inline void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Issue one 64-row half's products of a page tile as one commit group:
// KSTEPS (or ksteps) k-steps of 32 in k order, each in chunk k / 4, 32
// bytes further in it (descriptor units of 16 bytes). da: the half's rows
// in the query block's first chunk; db: the stage's first chunk.
template <int KSTEPS>
__device__ inline void issue_half(int (&acc)[64], uint64_t da, uint64_t db,
                                  int ksteps) {
  wgmma_fence();
#pragma unroll(KSTEPS > 0 ? KSTEPS : 1)
  for (int k = 0; k < (KSTEPS > 0 ? KSTEPS : ksteps); ++k) {
    const uint32_t kb = (k % 4) * 2;
    wgmma_s8(acc, da + (((k / 4) * kWgRows * 128) >> 4) + kb,
             db + (((k / 4) * kWgTileN * 128) >> 4) + kb, k);
  }
  wgmma_commit();
}

// One half's masked, scaled running max over a tile: rows 16w + g (mx[0])
// and 16w + g + 8 (mx[1]), columns 8j + 2t and 8j + 2t + 1, whose weights
// are cw[8j] and cw[8j + 1].
__device__ inline void half_max(int (&acc)[64], float (&mx)[2],
                                const float* cw) {
  fence_acc(acc);
#pragma unroll
  for (int j = 0; j < kWgTileN / 8; ++j) {
    const float2 w = *reinterpret_cast<const float2*>(cw + 8 * j);
    mx[0] = fmaxf(mx[0], fmaxf((float)acc[4 * j] * w.x,
                               (float)acc[4 * j + 1] * w.y));
    mx[1] = fmaxf(mx[1], fmaxf((float)acc[4 * j + 2] * w.x,
                               (float)acc[4 * j + 3] * w.y));
  }
}

// ------------------------------------------------------------- kernel

template <int KSTEPS>
__global__ void __launch_bounds__(kWgThreads, 1)
maxsim_int8full_wg_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_p,
                          const float* __restrict__ qw,
                          const float* __restrict__ scales,
                          const uint8_t* __restrict__ pmask,
                          float* __restrict__ out, int nq, int lq, int nd,
                          int lp, int d, int qb, int db) {
  constexpr int N = kWgTileN, S = kWgStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const WgLayout L = wg_layout(d, N, S);
  unsigned char* As = smem;
  unsigned char* Bs = smem + L.b;
  float* colw = reinterpret_cast<float*>(smem + L.colw);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;
  const int q0 = blockIdx.x * qb;
  const int nq_here = min(qb, nq - q0);
  const int nrows = nq_here * lq;
  const int row0 = q0 * lq;
  const int d_begin = blockIdx.y * db;
  const int n_tiles = (lp + N - 1) / N;
  const int n_docs = min(nd, d_begin + db) - d_begin;
  const int total = n_docs * n_tiles;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 32);                 // one producer warp's lanes
      mbar_init(empty + s, 4 * kWgConsumers);  // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWgConsumers) {
    // ------------------------------------------------------ producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kWgProducerRegs));
    const int pw = warp - 4 * kWgConsumers;
    if (pw == 0 && lane == 0) {
      mbar_arrive_tx(qbar, (uint32_t)L.chunks * kWgRows * 128);
      for (int c = 0; c < L.chunks; ++c)
        tma_load(As + c * kWgRows * 128, &tm_q, c * kS8BoxK, row0, qbar);
    }
    for (int it = pw; it < total; it += kWgProducers) {
      const int s = it % S;
      mbar_wait(empty + s, ((it / S) & 1) ^ 1);
      const int dd = d_begin + it / n_tiles;
      const int l0 = (it % n_tiles) * N;
      const int ntok = min(N, lp - l0);
      const int tok0 = dd * lp + l0;  // < nd * lp < 2^31 (the launcher)
      // every read first, then every store: a valid token's scale if it is
      // >= 0 (maxsim_tile.cuh's rule), else NaN
      float sc[N / 32];
      bool ok[N / 32];
#pragma unroll
      for (int k = 0; k < N / 32; ++k) {
        const int c = lane + 32 * k;
        sc[k] = c < ntok ? scales[tok0 + c] : -1.f;
        ok[k] = c < ntok && pmask[tok0 + c];
      }
#pragma unroll
      for (int k = 0; k < N / 32; ++k)
        colw[s * N + lane + 32 * k] = ok[k] && sc[k] >= 0.f
                                          ? sc[k]
                                          : __int_as_float(0x7fffffff);
      if (lane == 0) {
        mbar_arrive_tx(full + s, L.stage_bytes);
        unsigned char* dst = Bs + s * L.stage_bytes;
        for (int c = 0; c < L.chunks; ++c)
          tma_load(dst + c * N * 128, &tm_p, c * kS8BoxK, tok0, full + s);
      } else {
        mbar_arrive(full + s);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kWgConsumerRegs));
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
    int acc0[64], acc1[64];
    const uint64_t a_desc0 = sw128_desc(smem_addr(As) + wg * 128 * 128);
    const uint64_t a_desc1 = a_desc0 + ((64 * 128) >> 4);
    const uint64_t b_desc = sw128_desc(smem_addr(Bs));
    const int ksteps = (d + 31) / 32;
    auto wait_full = [&](int it) {
      mbar_wait(full + it % S, (it / S) & 1);
    };
    auto issue = [&](int (&acc)[64], uint64_t da, int it) {
      issue_half<KSTEPS>(acc, da,
                         b_desc + (((it % S) * L.stage_bytes) >> 4), ksteps);
    };
    auto weights = [&](int it) { return colw + (it % S) * N + 2 * t; };
    // tile `it` is done with: its stage goes back to the producers, and at
    // a doc's end the doc's scores go out
    auto tile_done = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + it % S);
      if (it % n_tiles != n_tiles - 1) return;
      // doc epilogue: the quad's maxima, the no-valid-token rule and the
      // weight per row; then each query's Lq rows, in order
      const int doc = it / n_tiles;
      float* rr = red + (doc & 1) * kWgRows;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = mx[i][h];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          const int r = wg * 128 + i * 64 + w * 16 + h * 8 + g;
          if (t == 0) rr[r] = (m > kNegThresh ? m : 0.f) * qwr[i][h];
          mx[i][h] = kNegInit;
        }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kWgRows) : "memory");
      if (tid < nq_here) {
        float sum = 0.f;
#pragma unroll 8
        for (int r = 0; r < lq; ++r) sum += rr[tid * lq + r];
        out[(size_t)(q0 + tid) * nd + d_begin + doc] = sum;
      }
    };
    mbar_wait(qbar, 0);

    // The halves take turns; every wait_group 0 closes the only open group.
    if (total > 0) {
      wait_full(0);
      issue(acc0, a_desc0, 0);
      wgmma_wait0();
      issue(acc1, a_desc1, 0);
      half_max(acc0, mx[0], weights(0));
      wgmma_wait0();
      for (int it = 1; it < total; ++it) {
        wait_full(it);
        issue(acc0, a_desc0, it);
        half_max(acc1, mx[1], weights(it - 1));
        wgmma_wait0();
        tile_done(it - 1);
        issue(acc1, a_desc1, it);
        half_max(acc0, mx[0], weights(it));
        wgmma_wait0();
      }
      half_max(acc1, mx[1], weights(total - 1));
      tile_done(total - 1);
    }
  }
}

// ---------------------------------------------------------------- host

using WgKernel = void (*)(const CUtensorMap, const CUtensorMap, const float*,
                          const float*, const uint8_t*, float*, int, int,
                          int, int, int, int, int);

// The configuration a call at width d runs: the kernel (the loop unrolled
// at d = 32 * kWgUnrolledKSteps) and its shared-memory size.
int wg_plan(int d, WgLayout* L, WgKernel* kern) {
  *L = wg_layout(d, kWgTileN, kWgStages);
  if (L->total > kWgSmemCap) return (int)cudaErrorInvalidValue;
  *kern = d == 32 * kWgUnrolledKSteps
              ? maxsim_int8full_wg_kernel<kWgUnrolledKSteps>
              : maxsim_int8full_wg_kernel<0>;
  return (int)cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L->total);
}

}  // namespace
}  // namespace evdr

extern "C" int evdr_maxsim_int8full_wg(const void* q, const void* qw,
                                       const void* p, const void* scales,
                                       const void* pmask, void* out, int nq,
                                       int lq, int nd, int lp, int d,
                                       void* stream) {
  using namespace evdr;
  if (nq < 1 || nd < 1 || lp < 1 || lq < 1 || lq > kWgRows || d < 16 ||
      d % 16 != 0 || d > 2 * kS8BoxK || (long long)nd * lp >= (1LL << 31) ||
      (long long)nq * lq >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  WgLayout L;
  WgKernel kern;
  int e = wg_plan(d, &L, &kern);
  if (e != 0) return e;
  alignas(64) CUtensorMap tm_q, tm_p;
  if ((e = encode_rows(&tm_q, q, nq * lq, d, kWgRows, 1)) != 0) return e;
  if ((e = encode_rows(&tm_p, p, nd * lp, d, L.n, 1)) != 0) return e;
  const int qb = kWgRows / lq;
  int db = kWgDocs;
  if ((nd + db - 1) / db > kMaxGridY) db = (nd + kMaxGridY - 1) / kMaxGridY;
  dim3 grid((nq + qb - 1) / qb, (nd + db - 1) / db);
  kern<<<grid, kWgThreads, L.total, (cudaStream_t)stream>>>(
      tm_q, tm_p, static_cast<const float*>(qw),
      static_cast<const float*>(scales), static_cast<const uint8_t*>(pmask),
      static_cast<float*>(out), nq, lq, nd, lp, d, qb, db);
  return (int)cudaGetLastError();
}

// The configuration a call at width d runs, on the current GPU: out[0]
// CTAs per SM, out[1] query-token rows a CTA, out[2] page tokens a tile,
// out[3] stages, out[4] consumer warpgroups, out[5] shared-memory bytes.
extern "C" int evdr_int8full_wg_config(int d, void* out) {
  using namespace evdr;
  int* o = static_cast<int*>(out);
  WgLayout L;
  WgKernel kern;
  const int e = wg_plan(d, &L, &kern);
  if (e != 0) return e;
  o[1] = kWgRows;
  o[2] = L.n;
  o[3] = L.stages;
  o[4] = kWgConsumers;
  o[5] = (int)L.total;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[0], kern, kWgThreads, L.total);
}
