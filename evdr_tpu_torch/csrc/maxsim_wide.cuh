// The D-chunked MaxSim tile loop for Hopper (sm_90a): every token width
// above what the fast kernels hold in shared memory. One template serves
// the wide paths of K1 (bf16 and float32), K5 (the same loop with an M
// store), K2 (int8 and int8full), K2b (DEFER), K4 (int4 and int4full) and
// K3 (PQ codes decoded chunk by chunk, from compact or full-width books);
// maxsim_train.cu's wide K6 recomputes its similarities with tile_mma_acc
// below, the same products in the same order.
//
// The fast kernels hold a CTA's whole query block and two page tiles in
// shared memory, which bounds D (256; 192 in float32). A max over tokens
// does not split over D, but a dot product does, so here each page tile's
// similarity block is summed over D in chunks of kWideUnits 16-byte
// operand units (128 bf16 / 256 int8 / 64 float32 columns), into
// accumulators kept in registers across the chunks, in ascending D order;
// the masked, scaled max and the -1e29 rule come only after the last
// chunk. Each output's arithmetic is the fast tile loop's (maxsim_tile.cuh:
// the same mma.sync fragments and k-steps in the same order), so chunking
// changes no bit of a similarity; the wide K5's scores equal the wide K1's
// bit for bit and the wide K6's recompute meets the wide K5's M exactly.
//
// Design (exact and simple; no configuration users run is this wide):
// - CfgWide's tile: 256 query-token rows (whole queries, as maxsim_kernel)
//   x 64 page tokens a CTA, 8 warps of 64 x 32 outputs, 8 docs a CTA.
// - A pipeline step is one (page tile, D chunk): its query chunk (re-read
//   from L2 for every page tile: bandwidth, no shared memory) and its page
//   chunk arrive by cp.async into one of two buffers while the previous
//   step multiplies. Staged modes widen (int8 mode) or unpack (int4) the
//   page chunk in shared memory as the fast loop does; K3 decodes it from
//   the tile's codes, brought with its first chunk (compact books: each
//   column from the subspace it falls in; full-width books: the int32 sum
//   over M, rounded to bf16, as maxsim_pq.cu's decode).
// - Each mode keeps its arithmetic: int8full/int4full accumulate in int32
//   and apply the query scale after the max, float32 runs 3xTF32, the PQ
//   tile types are maxsim_pq.cu's.
// - Shared memory does not grow with D: 2 x 256 query rows and the page
//   chunks at (kWideUnits + 1) * 16 bytes a row, ~175 KB, one CTA per SM.
#pragma once

#include "maxsim_tile.cuh"

namespace evdr {

constexpr int kWideUnits = 16;     // operand units of a D chunk
constexpr int kPqBookRows = 256;   // PQ books padded to 256 rows (uint8)

// K3's page source in the wide loop: no books (the page tile is read), or
// PQ codes decoded from compact (M, 256, w) or full-width (M, 256, D) int8
// books.
enum WideBooks { kNoBooks = 0, kCompactBooks = 1, kFullBooks = 2 };

// raw (stored) 16-byte units of a staged mode's page chunk: int8 codes
// widen 8 -> 16 bf16 units, packed int4 bytes unpack 8 -> 16 bf16 or
// 16 -> 16 int8 units
template <int MODE> constexpr int kWideRaw =
    MODE == kInt4Int8 ? kWideUnits : kWideUnits / 2;

// Shared-memory carve-up of the wide loop, in bytes from the dynamic base:
// two query chunks, the page chunk operand (two where it is read directly,
// one where it is converted or decoded), two raw page chunks (or two code
// buffers of a tile), two column-scale buffers, the weights and the doc
// epilogue's reductions (K2b: two of each, as Smem).
template <int MODE, int BOOKS> struct WideSmem {
  size_t a, b, raw, raw_bytes, colscale, qw, part, red, total;
  __host__ __device__ WideSmem(int m_sub, bool defer) {
    constexpr int R = CfgWide::kR;
    const size_t row = (size_t)(kWideUnits + 1) * 16;
    a = 0;
    b = align128(row * R * 2);
    const bool one = is_staged<MODE> || BOOKS != kNoBooks;
    raw = align128(b + row * kCols * (one ? 1 : 2));
    raw_bytes = BOOKS != kNoBooks
                    ? align128((size_t)kCols * m_sub + 4)
                    : align128(raw_tile_bytes<MODE>(kWideRaw<MODE>));
    colscale = align128(raw + raw_bytes * 2);
    qw = align128(colscale + sizeof(float) * kCols * 2);
    part = align128(qw + sizeof(float) * R);
    red = align128(part + sizeof(float) * (defer ? 4 : 2) * R);
    total = align128(red + sizeof(float) * (defer ? 2 : 1) * R);
  }
};

// Units [u0, u0 + n) of rows [0, ROWS) of a row-major global operand of
// `gunits` units a row into `dst` (row stride (dunits + 1) * 16), through
// cp.async; rows at or past `valid` and units at or past `gunits` zero.
template <int ROWS>
__device__ inline void stage_chunk(unsigned char* dst, int dunits,
                                   const unsigned char* src, int valid,
                                   int gunits, int u0, int n, int tid) {
  const size_t stride = (size_t)(dunits + 1) * 16;
  for (int i = tid; i < ROWS * n; i += kThreads) {
    const int r = i / n, u = i % n;
    const bool ok = r < valid && u0 + u < gunits;
    cp_async16(dst + r * stride + u * 16,
               ok ? src + ((size_t)r * gunits + u0 + u) * 16 : src, ok);
  }
}

__device__ inline void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// K3's wide decode: dims [c0, c0 + ndims) of the kCols tokens whose codes
// are at `codes` (m_sub a token) into the operand chunk `dst` (row stride
// ds), in groups of 4 dims: compact books (w a multiple of 4, so a group
// lies in one subspace) copy the group from its subspace's row, full-width
// books sum it over the M rows in int32. bf16 operands take the sum
// rounded to nearest even (maxsim_pq.cu's decode), int8 ones the compact
// value as is. Dims at or past d are zero.
template <typename TS, int BOOKS>
__device__ inline void decode_chunk(unsigned char* dst, size_t ds,
                                    const unsigned char* codes,
                                    const signed char* __restrict__ books,
                                    int m_sub, int w, int d, int c0,
                                    int ndims, int tid) {
  const int ng = ndims / 4;
  for (int i = tid; i < kCols * ng; i += kThreads) {
    const int t = i / ng, gg = i % ng;
    const int dim = c0 + 4 * gg;
    int acc[4] = {0, 0, 0, 0};
    if (dim < d) {
      if constexpr (BOOKS == kCompactBooks) {
        const int m = dim / w;
        const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(
            books + ((size_t)m * kPqBookRows + codes[t * m_sub + m]) * w +
            (dim - m * w)));
        const signed char* b = reinterpret_cast<const signed char*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = b[e];
      } else {
        for (int m = 0; m < m_sub; ++m) {
          const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(
              books + ((size_t)m * kPqBookRows + codes[t * m_sub + m]) * d +
              dim));
          const signed char* b = reinterpret_cast<const signed char*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] += b[e];
        }
      }
    }
    if constexpr (sizeof(TS) == 1) {
      *reinterpret_cast<uint32_t*>(dst + t * ds + gg * 4) =
          (uint32_t)(uint8_t)acc[0] | (uint32_t)(uint8_t)acc[1] << 8 |
          (uint32_t)(uint8_t)acc[2] << 16 | (uint32_t)(uint8_t)acc[3] << 24;
    } else {
      __nv_bfloat162 h0 = __floats2bfloat162_rn((float)acc[0], (float)acc[1]);
      __nv_bfloat162 h1 = __floats2bfloat162_rn((float)acc[2], (float)acc[3]);
      *reinterpret_cast<uint2*>(dst + t * ds + gg * 8) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&h0),
                     *reinterpret_cast<const uint32_t*>(&h1));
    }
  }
}

// tile_mma's 128 x 64 tile over operand units [0, units) of As and B,
// ADDED to acc (no zeroing): a D chunk of the wide K6's recompute. The
// loop and fragments are tile_mma's, so summing the chunks in ascending
// order gives each similarity the wide loop's bits.
template <int MODE>
__device__ inline void tile_mma_acc(typename Traits<MODE>::TAcc (&acc)[2][4][4],
                                    const unsigned char* As,
                                    const unsigned char* B, int units,
                                    size_t stride, int lane, int wm, int wn) {
  using TS = typename Traits<MODE>::TQ;
  const unsigned char* a_row = As + (wm * 32 + lane % 16) * stride;
  const unsigned char* b_row =
      B + (wn * 32 + lane % 8 + (lane / 16) * 8) * stride;
  for (int k = 0; k < units; k += 2) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm_x4(a[i], a_row + i * 16 * stride + (k + lane / 16) * 16);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      ldsm_x4(b[jj], b_row + jj * 16 * stride + (k + (lane / 8) % 2) * 16);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1],
            TS());
  }
}

// The wide loop. MODE: the tile loop's mode (K3: kBf16, or kInt8Int8 for
// compact books and int8 queries); DEFER: K2b's deferred doc epilogue;
// STORE_M: K5, which also writes each query-token row's raw max over each
// doc to m (nq * lq, nd); BOOKS: K3's decode (p then holds uint8 codes,
// m_sub a token).
template <int MODE, bool DEFER, bool STORE_M, int BOOKS>
__global__ void __launch_bounds__(kThreads)
maxsim_wide_kernel(const unsigned char* __restrict__ q,
                   const float* __restrict__ qw,
                   const unsigned char* __restrict__ p,
                   const float* __restrict__ scales,
                   const uint8_t* __restrict__ pmask, float* __restrict__ out,
                   float* __restrict__ m_out,
                   const signed char* __restrict__ books, int nq, int lq,
                   int nd, int lp, int d, int m_sub, int qb, int db) {
  using TQ = typename Traits<MODE>::TQ;
  using TP = typename Traits<MODE>::TP;
  using TAcc = typename Traits<MODE>::TAcc;
  using TS = typename Traits<MODE>::TQ;
  using CFG = CfgWide;
  constexpr int R = CFG::kR, kI = CFG::kI, kJ = CFG::kJ;
  static_assert(!(DEFER && STORE_M), "K2b has no M");
  static_assert(BOOKS == kNoBooks || MODE == kBf16 || MODE == kInt8Int8,
                "K3 scores bf16 or int8 x int8 tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  const WideSmem<MODE, BOOKS> lay(m_sub, DEFER);
  constexpr size_t stride = (size_t)(kWideUnits + 1) * 16;
  unsigned char* As = smem + lay.a;
  unsigned char* Bs = smem + lay.b;
  unsigned char* Braw = smem + lay.raw;
  float* colscale = reinterpret_cast<float*>(smem + lay.colscale);
  float* qw_s = reinterpret_cast<float*>(smem + lay.qw);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* red = reinterpret_cast<float*>(smem + lay.red);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % CFG::kWM;
  const int wn = warp / CFG::kWM;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * qb;
  const int nq_here = min(qb, nq - q0);
  const int nrows = nq_here * lq;
  const size_t row0 = (size_t)q0 * lq;
  // operand units of a whole row (even), chunks, stored units a row
  const int units = mma_units<MODE>(d);
  const int nch = (units + kWideUnits - 1) / kWideUnits;
  const int q_units = d * (int)sizeof(TQ) / 16;
  const int p_units = BOOKS != kNoBooks ? 0 : d * (int)sizeof(TP) / 16;
  const int w = BOOKS == kCompactBooks ? d / m_sub : 0;
  constexpr int kColsChunk = kWideUnits * 16 / (int)sizeof(TS);

  for (int r = tid; r < R; r += kThreads)
    qw_s[r] = r < nrows ? qw[row0 + r] : 0.f;

  const int d_begin = blockIdx.y * db;
  const int n_tiles = (lp + kCols - 1) / kCols;
  const int total = (min(nd, d_begin + db) - d_begin) * n_tiles * nch;

  // issue step s (tile s / nch, chunk s % nch) into buffer `buf`
  auto issue = [&](int s, int buf) {
    const int it = s / nch, c = s % nch;
    const int dd = d_begin + it / n_tiles;
    const int l0 = (it % n_tiles) * kCols;
    const int ntok = min(kCols, lp - l0);
    const size_t tok0 = (size_t)dd * lp + l0;
    const int u0 = c * kWideUnits;
    const int cu = min(kWideUnits, units - u0);
    stage_chunk<R>(As + buf * stride * R, kWideUnits,
                   q + row0 * q_units * 16, nrows, q_units, u0, cu, tid);
    if constexpr (BOOKS != kNoBooks) {
      if (c == 0)
        stage_codes(Braw + (it & 1) * lay.raw_bytes, p, tok0 * m_sub,
                    ntok * m_sub, tid);
    } else if constexpr (is_int4<MODE>) {
      // packed rows l0 / 2 .. of doc dd, d bytes each
      const int rraw = d / 16;
      const int ru0 = c * kWideRaw<MODE>;
      stage_chunk<kCols / 2>(
          Braw + buf * lay.raw_bytes, min(kWideRaw<MODE>, rraw - ru0),
          p + ((size_t)dd * ((lp + 1) / 2) + l0 / 2) * d, (ntok + 1) / 2,
          rraw, ru0, min(kWideRaw<MODE>, rraw - ru0), tid);
    } else if constexpr (MODE == kInt8Bf16) {
      const int ru0 = c * kWideRaw<MODE>;
      stage_chunk<kCols>(Braw + buf * lay.raw_bytes,
                         min(kWideRaw<MODE>, p_units - ru0),
                         p + tok0 * p_units * 16, ntok, p_units, ru0,
                         min(kWideRaw<MODE>, p_units - ru0), tid);
    } else {
      stage_chunk<kCols>(Bs + buf * stride * kCols, kWideUnits,
                         p + tok0 * p_units * 16, ntok, p_units, u0, cu, tid);
    }
    if (c == 0 && tid < kCols) {
      float cs = -1.f;  // the invalid-token sentinel (also an odd Lp's pad)
      if (tid < ntok && pmask[tok0 + tid])
        cs = scales != nullptr ? scales[tok0 + tid] : 1.f;
      colscale[(it & 1) * kCols + tid] = cs;
    }
  };

  TAcc acc[kI][kJ][4];
  float mx[kI][2];
#pragma unroll
  for (int i = 0; i < kI; ++i) mx[i][0] = mx[i][1] = kNegInit;
  [[maybe_unused]] int pend1 = -1, pend2 = -1;

  if (total > 0) issue(0, 0);
  cp_async_commit();
  for (int s = 0; s < total; ++s) {
    const int buf = s & 1;
    const int it = s / nch, c = s % nch;
    const int u0 = c * kWideUnits;
    const int cu = min(kWideUnits, units - u0);
    if (s + 1 < total) issue(s + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();  // step s has landed (only s + 1 may be in flight)
    __syncthreads();
    const unsigned char* B = Bs + buf * stride * kCols;
    if constexpr (BOOKS != kNoBooks) {
      const int dd = d_begin + it / n_tiles;
      const size_t tok0 = (size_t)dd * lp + (it % n_tiles) * kCols;
      decode_chunk<TS, BOOKS>(
          Bs, stride,
          Braw + (it & 1) * lay.raw_bytes + ((tok0 * m_sub) & 3), books,
          m_sub, w, d, c * kColsChunk, cu * 16 / (int)sizeof(TS), tid);
      __syncthreads();
      B = Bs;
    } else if constexpr (is_staged<MODE>) {
      const int rraw = d / 16;
      const int rcu = min(kWideRaw<MODE>, rraw - c * kWideRaw<MODE>);
      if constexpr (MODE == kInt8Bf16) {
        widen_tile(Bs, Braw + buf * lay.raw_bytes, rcu, kWideUnits, tid);
      } else {
        unpack_int4_tile<TS>(Bs, Braw + buf * lay.raw_bytes, rcu, kWideUnits,
                             tid);
        if (MODE == kInt4Int8 && cu > rcu)  // an odd unit count's pad unit
          for (int r = tid; r < kCols; r += kThreads)
            *reinterpret_cast<uint4*>(Bs + r * stride + rcu * 16) =
                make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
      B = Bs;
    }

    if (c == 0) {
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
    // this chunk's products, added to the tile's accumulators: the fast
    // loop's k-steps, continued from the last chunk's
    const unsigned char* Ab = As + buf * stride * R;
    const unsigned char* a_row = Ab + (wm * CFG::kWarpRows + lane % 16) * stride;
    const unsigned char* b_row =
        B + (wn * 32 + lane % 8 + (lane / 16) * 8) * stride;
    for (int k = 0; k < cu; k += 2) {
      uint32_t a[kI][4], b[2][4];
#pragma unroll
      for (int i = 0; i < kI; ++i)
        ldsm_x4(a[i], a_row + i * 16 * stride + (k + lane / 16) * 16);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldsm_x4(b[jj], b_row + jj * 16 * stride + (k + (lane / 8) % 2) * 16);
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          mma(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1],
              TS());
    }

    if (c == nch - 1) {
      // the tile is summed over D: its masked, scaled max
      const float* cs = colscale + (it & 1) * kCols + wn * 32 + 2 * t;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float c0 = cs[j * 8], c1 = cs[j * 8 + 1];
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          mx[i][0] = fmaxf(mx[i][0], fmaxf(masked((float)acc[i][j][0], c0),
                                           masked((float)acc[i][j][1], c1)));
          mx[i][1] = fmaxf(mx[i][1], fmaxf(masked((float)acc[i][j][2], c0),
                                           masked((float)acc[i][j][3], c1)));
        }
      }
      if constexpr (DEFER) {
        // K2b's stages, as maxsim_kernel runs them after a tile's products
        if (pend2 >= 0)
          defer_sum(red + (pend2 & 1) * R, out, q0, nq_here, lq, nd, pend2,
                    tid);
        if (pend1 >= 0)
          defer_combine<R>(part + (pend1 & 1) * 2 * R, red + (pend1 & 1) * R,
                           qw_s, tid);
        pend2 = pend1;
        pend1 = -1;
      }
      if (it % n_tiles == n_tiles - 1) {
        // doc epilogue (maxsim_kernel's): the quad and the two column
        // warps, the no-valid-token rule and the weight, each query's Lq
        // rows summed in order; K5 also stores each row's raw max
        const int dd = d_begin + it / n_tiles;
        float* pp = DEFER ? part + (dd & 1) * 2 * R : part;
#pragma unroll
        for (int i = 0; i < kI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float m = mx[i][h];
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            if (t == 0)
              pp[wn * R + wm * CFG::kWarpRows + i * 16 + h * 8 + g] = m;
            mx[i][h] = kNegInit;
          }
        if constexpr (DEFER) {
          pend1 = dd;
        } else {
          __syncthreads();
          if (tid < R) {
            const float m = fmaxf(part[tid], part[R + tid]);
            if constexpr (STORE_M)
              if (tid < nrows) m_out[(row0 + tid) * nd + dd] = m;
            red[tid] = (m > kNegThresh ? m : 0.f) * qw_s[tid];
          }
          __syncthreads();
          if (tid < nq_here) {
            float sum = 0.f;
            for (int r = 0; r < lq; ++r) sum += red[tid * lq + r];
            out[(size_t)(q0 + tid) * nd + dd] = sum;
          }
        }
      }
    }
    __syncthreads();  // buffer `buf` (and the decoded chunk) are free
  }
  if constexpr (DEFER) {
    if (pend2 >= 0)
      defer_sum(red + (pend2 & 1) * R, out, q0, nq_here, lq, nd, pend2, tid);
    if (pend1 >= 0) {
      defer_combine<R>(part + (pend1 & 1) * 2 * R, red + (pend1 & 1) * R,
                       qw_s, tid);
      __syncthreads();
      defer_sum(red + (pend1 & 1) * R, out, q0, nq_here, lq, nd, pend1, tid);
    }
  }
}

// Host launcher of the wide loop: checks what it cannot take (more query
// tokens than CfgWide's rows, D off the 16 granule, a compact book width
// off 4 bytes), sizes shared memory, launches on `stream` and returns
// cudaGetLastError(). Any D >= 16: shared memory does not depend on it.
template <int MODE, bool DEFER, bool STORE_M, int BOOKS>
int launch_wide(const void* q, const void* qw, const void* p,
                const void* scales, const void* pmask, void* out, void* m,
                const void* books, int nq, int lq, int nd, int lp, int d,
                int m_sub, void* stream) {
  if (nq < 1 || nd < 1 || lp < 1 || lq < 1 || lq > CfgWide::kR || d < 16 ||
      d % 16 != 0 || (STORE_M && m == nullptr))
    return (int)cudaErrorInvalidValue;
  if (BOOKS != kNoBooks && (books == nullptr || m_sub < 1 || m_sub > 256))
    return (int)cudaErrorInvalidValue;
  if (BOOKS == kCompactBooks && (d % m_sub != 0 || (d / m_sub) % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const WideSmem<MODE, BOOKS> lay(m_sub, DEFER);
  if (lay.total > 232448) return (int)cudaErrorInvalidValue;
  auto* kern = maxsim_wide_kernel<MODE, DEFER, STORE_M, BOOKS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  const int qb = CfgWide::kR / lq;
  int db = CfgWide::kDocs;
  if ((nd + db - 1) / db > kMaxGridY) db = (nd + kMaxGridY - 1) / kMaxGridY;
  dim3 grid((nq + qb - 1) / qb, (nd + db - 1) / db);
  kern<<<grid, kThreads, lay.total, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(q), static_cast<const float*>(qw),
      static_cast<const unsigned char*>(p), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(pmask), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<const signed char*>(books), nq, lq,
      nd, lp, d, m_sub, qb, db);
  return (int)cudaGetLastError();
}

}  // namespace evdr
