// K1 in float32 mode: fused masked MaxSim at (near) float32 precision, for
// Hopper (sm_90a); and K5 in float32 mode, the same kernel with an M store.
//
// Replaces: evdr_tpu/ops/pallas_maxsim.py:_kernel run with
// compute_dtype=float32 (Precision.HIGHEST, pallas_maxsim.py:552-553), the
// scorer of the trainer's teacher precompute and of every evaluation; with
// STORE_M, evdr_tpu/ops/pallas_maxsim_bwd.py:_fwd_train_kernel at
// compute_dtype=float32 (pallas_maxsim_bwd.py:116-117): K1's scores bit for
// bit plus M[(q, t), d], each query-token row's max over each doc before
// the no-valid-token rule, (nq * lq, nd) f32, stored as each doc ends.
//
// Hopper's tensor cores have no exact-f32 product, so each product is
// split into TF32 halves (3xTF32): per k-step of 8, three mma.sync m16n8k8
// tf32 products into one f32 accumulator, lo x hi, then hi x lo, then
// hi x hi; only the lo x lo term (~2^-22 relative) is dropped. The masked
// running max stays in registers, the -1e30 fill and the -1e29
// no-valid-token rule are K1's.
//
// What bounds it on the H100: operations. mma.sync tf32 peaks at ~316
// TFLOP/s on the card (a microbenchmark with no memory traffic; the
// data-sheet 495 is wgmma's), and three products per element cut that to
// ~105 TFLOP/s of the function's own work. K1's bf16 layout (a 128 x 64
// tile, 32 x 32 outputs a warp, one CTA of 8 warps per SM at 137 KB) ran
// the 3xTF32 products at ~42% of that ceiling. Measured in one call
// (scripts/torch_kernel_ab.py, PERF.md): hoisting the split out of the
// products changed nothing (ptxas had already shared it), two CTAs per SM
// on 32-token tiles (32 x 16 a warp) lost 15% at Lp 768, and 64 x 32
// outputs a warp, which load fewer operand bytes per product, gained
// 15-20%. The design:
// - 64 x 32 outputs a warp: kI = 4 row and kJ = 4 column fragments, split
//   into their TF32 hi/lo pairs once per k-step and shared by the 16
//   positions; the three products of a position keep their order, so each
//   element's arithmetic is maxsim_tile.cuh's mma(..., float), which K6's
//   float32 recompute (tile_mma<kF32>) issues: its similarities equal the
//   ones K5 took the max of, bit for bit, whatever the tile.
// - Two tile configurations, chosen by D alone (f32_config below): 256
//   query rows x 64-token page tiles (8 warps 4 x 2) wherever they fit, D
//   <= 144 (203 KB at D = 128, one CTA per SM): every call of the trainer
//   and its evals; 128 x 32 with 32 x 16 a warp above, D up to 192 (150 KB
//   at D = 192, one CTA per SM). A launch takes up to the tile's rows of
//   query tokens (the wrappers' row_cap). A 128 x 128 tile (64 x 32 a warp, 2 x 4
//   warps) ran 3.6% behind 256 x 64 at Lp 768 and is not kept.
// - The query block arrives by cp.async with the first page tile, and a CTA
//   walks 8 docs (kF32Docs), so its staging is spread over more tiles.
//
// C interface (ctypes; every pointer and the stream is a void*): q
// (nq, lq, d) f32, qw (nq, lq) f32 query-token weights, p (nd, lp, d) f32,
// pmask (nd, lp) bool as bytes, out (nq, nd) f32; evdr_maxsim_fwd_train_f32
// adds m (nq * lq, nd) f32 after out. Returns cudaGetLastError() after the
// launch. evdr_f32_occupancy reports the tile configuration a call at width
// d runs (K1, or K5 where `train`) and its CTAs per SM.
#include "maxsim_tile.cuh"
#include "maxsim_wide.cuh"

namespace evdr {
namespace {

constexpr int kF32Docs = 8;  // docs per CTA

// A tile configuration: ROWS query-token rows x COLS doc tokens per tile,
// the 8 warps standing WM x (8 / WM) over it, MINB CTAs per SM asked of
// the launch bound. A warp's share: kI blocks of 16 rows x kJ blocks of 8
// columns, loaded kI and kJ / 2 ldmatrix.x4 at a time.
template <int ROWS, int COLS, int WM, int MINB> struct F32Cfg {
  static constexpr int kR = ROWS, kC = COLS, kWM = WM, kMinB = MINB;
  static constexpr int kWN = 8 / WM;
  static constexpr int kWarpRows = ROWS / WM, kWarpCols = COLS / kWN;
  static constexpr int kI = kWarpRows / 16, kJ = kWarpCols / 8;
};
// 64 x 32 warp tiles over 256 x 64 (D <= 128: 203 KB at 128), 32 x 16
// over 128 x 32 (D above 128, up to 192: 150 KB there)
using CfgTall = F32Cfg<256, 64, 4, 1>;
using CfgNarrow = F32Cfg<128, 32, 4, 2>;

// Shared-memory carve-up, in bytes from the dynamic base; rows of d / 4
// 16-byte units with a stride of (units + 1) * 16 bytes.
template <class CFG> struct F32Smem {
  int units;
  size_t a, b, colscale, qw, part, red, total;
  __host__ __device__ explicit F32Smem(int d) {
    units = d / 4;
    const size_t row = (size_t)(units + 1) * 16;
    a = 0;
    b = align128(row * CFG::kR);
    colscale = align128(b + row * CFG::kC * 2);
    qw = align128(colscale + sizeof(float) * CFG::kC * 2);
    part = align128(qw + sizeof(float) * CFG::kR);
    red = align128(part + sizeof(float) * CFG::kWN * CFG::kR);
    total = align128(red + sizeof(float) * CFG::kR);
  }
};

// STORE_M: K5 in float32 mode, which also writes each query-token row's
// max over each doc (before the no-valid-token rule) to m_out[(q, t), d],
// (nq * lq, nd) f32. A template flag, and m_out the last parameter, so the
// serving kernels compile as they did without it.
template <class CFG, bool STORE_M = false>
__global__ void __launch_bounds__(kThreads, CFG::kMinB)
maxsim_f32_kernel(const float* __restrict__ q, const float* __restrict__ qw,
                  const float* __restrict__ p,
                  const uint8_t* __restrict__ pmask, float* __restrict__ out,
                  int nq, int lq, int nd, int lp, int d, int qb, int db,
                  float* __restrict__ m_out) {
  constexpr int R = CFG::kR, C = CFG::kC, kI = CFG::kI, kJ = CFG::kJ;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Smem<CFG> lay(d);
  const int units = lay.units;
  const size_t stride = (size_t)(units + 1) * 16;
  unsigned char* As = smem + lay.a;
  unsigned char* Bs = smem + lay.b;
  float* colscale = reinterpret_cast<float*>(smem + lay.colscale);
  float* qw_s = reinterpret_cast<float*>(smem + lay.qw);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* red = reinterpret_cast<float*>(smem + lay.red);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % CFG::kWM;  // rows wm*kWarpRows .. +kWarpRows
  const int wn = warp / CFG::kWM;  // cols wn*kWarpCols .. +kWarpCols
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * qb;
  const int nq_here = min(qb, nq - q0);
  const int nrows = nq_here * lq;
  const size_t row0 = (size_t)q0 * lq;

  // the query block: one cp.async group with the first page tile
  stage_async<R>(As, reinterpret_cast<const unsigned char*>(q + row0 * d),
                 nrows, units, units, tid);
  for (int r = tid; r < R; r += kThreads)
    qw_s[r] = r < nrows ? qw[row0 + r] : 0.f;

  const int d_begin = blockIdx.y * db;
  const int n_tiles = (lp + C - 1) / C;
  const int total = (min(nd, d_begin + db) - d_begin) * n_tiles;

  // issue the loads of tile `it` (doc d_begin + it / n_tiles) into `buf`
  auto issue = [&](int it, int buf) {
    const int dd = d_begin + it / n_tiles;
    const int l0 = (it % n_tiles) * C;
    const int ntok = min(C, lp - l0);
    const size_t tok0 = (size_t)dd * lp + l0;
    stage_async<C>(Bs + buf * stride * C,
                   reinterpret_cast<const unsigned char*>(p + tok0 * d), ntok,
                   units, units, tid);
    if (tid < C)  // -1: the invalid-token sentinel (and past Lp)
      colscale[buf * C + tid] = tid < ntok && pmask[tok0 + tid] ? 1.f : -1.f;
  };

  float mx[kI][2];  // running max of rows wm*kWarpRows + i*16 + h*8 + g
#pragma unroll
  for (int i = 0; i < kI; ++i) mx[i][0] = mx[i][1] = kNegInit;

  issue(0, 0);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) issue(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();  // tile `it` has landed (only `it + 1` may be in flight)
    __syncthreads();
    const unsigned char* B = Bs + buf * stride * C;

    // acc[i][j]: rows wm*kWarpRows + i*16 + {g, g+8}, columns
    // wn*kWarpCols + j*8 + 2t + {0, 1}. The ldmatrix b16 fragments of a
    // row of f32 values are the tf32 m16n8k8 fragments (thread (g, t)
    // holds row g, element t of each 16-byte unit), so one k-step of 8 is
    // two units, as in tile_mma<kF32>; B block jj holds columns 16 jj ..
    // 16 jj + 16 of the warp's.
    float acc[kI][kJ][4];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    const unsigned char* a_row =
        As + (wm * CFG::kWarpRows + lane % 16) * stride;
    const unsigned char* b_row =
        B + (wn * CFG::kWarpCols + lane % 8 + (lane / 16) * 8) * stride;
    for (int k = 0; k < units; k += 2) {
      uint32_t a[kI][4], b[kJ / 2][4];
#pragma unroll
      for (int i = 0; i < kI; ++i)
        ldsm_x4(a[i], a_row + i * 16 * stride + (k + lane / 16) * 16);
#pragma unroll
      for (int jj = 0; jj < kJ / 2; ++jj)
        ldsm_x4(b[jj], b_row + jj * 16 * stride + (k + (lane / 8) % 2) * 16);
      // each fragment register split once into its TF32 hi/lo pair
      uint32_t ah[kI][4], al[kI][4], bh[kJ / 2][4], bl[kJ / 2][4];
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[i][e], ah[i][e], al[i][e]);
#pragma unroll
      for (int jj = 0; jj < kJ / 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(b[jj][e], bh[jj][e], bl[jj][e]);
      // per position: lo x hi, hi x lo, hi x hi (the order of mma(float))
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          mma_tf32(acc[i][j], al[i], bh[j / 2][(j % 2) * 2],
                   bh[j / 2][(j % 2) * 2 + 1]);
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          mma_tf32(acc[i][j], ah[i], bl[j / 2][(j % 2) * 2],
                   bl[j / 2][(j % 2) * 2 + 1]);
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          mma_tf32(acc[i][j], ah[i], bh[j / 2][(j % 2) * 2],
                   bh[j / 2][(j % 2) * 2 + 1]);
    }

    // masked max of this tile's columns of this thread
    const float* cs = colscale + buf * C + wn * CFG::kWarpCols + 2 * t;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float c0 = cs[j * 8], c1 = cs[j * 8 + 1];
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        mx[i][0] = fmaxf(mx[i][0], fmaxf(masked(acc[i][j][0], c0),
                                         masked(acc[i][j][1], c1)));
        mx[i][1] = fmaxf(mx[i][1], fmaxf(masked(acc[i][j][2], c0),
                                         masked(acc[i][j][3], c1)));
      }
    }

    if (it % n_tiles == n_tiles - 1) {
      // doc epilogue (K1's): combine the quad and the column warps, apply
      // the no-valid-token rule and the weight, sum each query's Lq rows
      // in order
      const int dd = d_begin + it / n_tiles;
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = mx[i][h];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if (t == 0)
            part[wn * R + wm * CFG::kWarpRows + i * 16 + h * 8 + g] = m;
          mx[i][h] = kNegInit;
        }
      __syncthreads();
      for (int r = tid; r < R; r += kThreads) {
        float m = part[r];
#pragma unroll
        for (int w = 1; w < CFG::kWN; ++w) m = fmaxf(m, part[w * R + r]);
        if constexpr (STORE_M) {
          if (r < nrows) m_out[(row0 + r) * nd + dd] = m;
        }
        red[r] = (m > kNegThresh ? m : 0.f) * qw_s[r];
      }
      __syncthreads();
      if (tid < nq_here) {
        float s = 0.f;
        for (int r = 0; r < lq; ++r) s += red[tid * lq + r];
        out[(size_t)(q0 + tid) * nd + dd] = s;
      }
    }
    __syncthreads();  // buffer `buf` is free for tile it + 2
  }
}

using Kern = void (*)(const float*, const float*, const float*,
                      const uint8_t*, float*, int, int, int, int, int, int,
                      int, float*);

// The configuration a call runs: 256 x 64 where its shared memory fits at
// width d (D <= 144: every call of the trainer and its evals), else 128 x
// 32 (D up to 192); a launch takes as many query tokens as the tile has
// rows. K5 (`train`) runs the same tile with the M store.
struct F32Launch {
  Kern kern;
  size_t smem;
  int rows, cols;
};
template <class CFG> F32Launch f32_launch(int d, bool train) {
  return {train ? maxsim_f32_kernel<CFG, true> : maxsim_f32_kernel<CFG>,
          F32Smem<CFG>(d).total, CFG::kR, CFG::kC};
}
int f32_config(int d, bool train, F32Launch* out) {
  if (d < 16 || d % 16 != 0) return (int)cudaErrorInvalidValue;
  F32Launch cfg = f32_launch<CfgTall>(d, train);
  if (cfg.smem > 232448) cfg = f32_launch<CfgNarrow>(d, train);
  if (cfg.smem > 232448) return (int)cudaErrorInvalidValue;
  *out = cfg;
  return (int)cudaFuncSetAttribute(
      cfg.kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg.smem);
}

// One launch of K1 float32 (m == nullptr) or K5 float32 (m: its M).
int f32_launch_call(const void* q, const void* qw, const void* p,
                    const void* pmask, void* out, void* m, int nq, int lq,
                    int nd, int lp, int d, void* stream) {
  F32Launch cfg;
  const int e = f32_config(d, m != nullptr, &cfg);
  if (e != 0) return e;
  if (nq < 1 || nd < 1 || lp < 1 || lq < 1 || lq > cfg.rows)
    return (int)cudaErrorInvalidValue;
  const int qb = cfg.rows / lq;
  int db = kF32Docs;
  if ((nd + db - 1) / db > kMaxGridY) db = (nd + kMaxGridY - 1) / kMaxGridY;
  dim3 grid((nq + qb - 1) / qb, (nd + db - 1) / db);
  cfg.kern<<<grid, kThreads, cfg.smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(qw),
      static_cast<const float*>(p), static_cast<const uint8_t*>(pmask),
      static_cast<float*>(out), nq, lq, nd, lp, d, qb, db,
      static_cast<float*>(m));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace evdr

extern "C" int evdr_maxsim_f32(const void* q, const void* qw, const void* p,
                               const void* pmask, void* out, int nq, int lq,
                               int nd, int lp, int d, void* stream) {
  return evdr::f32_launch_call(q, qw, p, pmask, out, nullptr, nq, lq, nd, lp,
                               d, stream);
}

// K5 in float32 mode: K1 float32's scores in out and each row's max in m
// (nq * lq, nd) f32.
extern "C" int evdr_maxsim_fwd_train_f32(const void* q, const void* qw,
                                         const void* p, const void* pmask,
                                         void* out, void* m, int nq, int lq,
                                         int nd, int lp, int d, void* stream) {
  if (m == nullptr) return (int)cudaErrorInvalidValue;
  return evdr::f32_launch_call(q, qw, p, pmask, out, m, nq, lq, nd, lp, d,
                               stream);
}

// The configuration evdr_maxsim_f32 (or, where `train`, K5 float32) runs at
// width d: out[0] its CTAs per SM, out[1] its query-token rows (the most
// query tokens a launch takes), out[2] its page-tile tokens.
extern "C" int evdr_f32_occupancy(int d, int train, void* out) {
  using namespace evdr;
  int* o = static_cast<int*>(out);
  F32Launch cfg;
  const int e = f32_config(d, train != 0, &cfg);
  if (e != 0) return e;
  o[1] = cfg.rows;
  o[2] = cfg.cols;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[0], cfg.kern, kThreads, cfg.smem);
}

// The wide K1 and K5 in float32 mode (D above 192): maxsim_wide.cuh's
// D-chunked loop, 3xTF32 products (maxsim_tile.cuh's mma(..., float)) in
// 64-column chunks; the wide K5's scores are the wide K1's bit for bit.
// C interfaces as evdr_maxsim_f32 / evdr_maxsim_fwd_train_f32.
extern "C" int evdr_maxsim_f32_wide(const void* q, const void* qw,
                                    const void* p, const void* pmask,
                                    void* out, int nq, int lq, int nd, int lp,
                                    int d, void* stream) {
  return evdr::launch_wide<evdr::kF32, false, false, evdr::kNoBooks>(
      q, qw, p, nullptr, pmask, out, nullptr, nullptr, nq, lq, nd, lp, d, 0,
      stream);
}

extern "C" int evdr_maxsim_fwd_train_f32_wide(const void* q, const void* qw,
                                              const void* p,
                                              const void* pmask, void* out,
                                              void* m, int nq, int lq, int nd,
                                              int lp, int d, void* stream) {
  return evdr::launch_wide<evdr::kF32, false, true, evdr::kNoBooks>(
      q, qw, p, nullptr, pmask, out, m, nullptr, nq, lq, nd, lp, d, 0,
      stream);
}
