// K3: fused masked MaxSim over a product-quantized page index, for Hopper
// (sm_90a).
//
// Replaces: evdr_tpu/ops/pallas_maxsim.py:_kernel_pq with _pq_decode_tile
// (host side _maxsim_pq_impl, public entries maxsim_pallas_pq and
// maxsim_pallas_pqfull).
//
// The index holds M uint8 codes per token, (nd, lp, M), and M codebooks.
// The wrapper (ops/cuda_maxsim._launch_pq) quantizes the books to int8
// with one global scale (folded into qw, after the max) and pads each to
// 256 rows, so every code byte names a row. A decoded token is the exact
// int32 sum of its M book rows, then cast to the MMA type; masked tokens
// score -1e30 after the product, as in K1.
// - evdr_maxsim_pq / evdr_maxsim_pqfull: compact (M, K, D/M) books, D/M a
//   multiple of 4: each token concatenates its M rows of D/M bytes, an
//   exact int8 tile for K1's bf16 loop (pq, bf16 queries) or K2's int8 x
//   int8 loop (pqfull, int8 queries).
// - evdr_maxsim_pq_sum: full-width (M, K, D) books (expanded OPQ books, or
//   compact ones embedded block-diagonally by the wrapper), M * 256 * D
//   bytes (512 KB at M = 16, D = 128), read through L2. Each token sums M
//   rows of D bytes in int32 and rounds the sum to bf16 (sums above 256
//   round, as on the TPU). bf16 queries, or int8 queries cast up to bf16 by
//   the wrapper (exact).
// The TPU decodes by a one-hot matmul because it has no fast gather, once
// per call (its query block holds the whole batch); here the decode is a
// gather of book rows.
//
// What bounds it on the H100: operations, as K1/K2 (each decoded token
// meets every query-token row; mma.sync peaks at ~634 TFLOP/s bf16 on the
// card, scripts/mma_sync_peak.cu), plus the decode. A CTA owns 128
// query-token rows, so a batch of 256 x 32 queries has 64 query blocks; in
// K1/K2's shared tile loop every CTA decoded the page tiles it read, 64
// times a tile a call (and copied the 32 KB of compact books), which cost
// ~42% of pq's time and ~70% of the expanded-books path's (a variant with
// the decode removed, timed in the same call: PERF.md). The design:
// - A thread-block cluster of C CTAs along the query-block axis walks the
//   same doc tiles in step. Each CTA decodes 1/C of every tile and stores
//   its share into the decoded-tile buffer of every CTA of the cluster
//   (distributed shared memory, st.shared::cluster, 16 bytes a store where
//   the subvector allows), so a tile is decoded 64 / C times a call.
//   Compact books split by subspace: CTA r holds only the books of
//   subspaces [r M / C, (r + 1) M / C) and fills those dims of all 64
//   tokens; full-width books split by token: CTA r sums whole rows for
//   tokens [64 r / C, 64 (r + 1) / C).
// - The decoded tile is double-buffered, so one cluster barrier per tile
//   (arrive.release after the stores, wait.acquire before the products)
//   is enough.
// - C (ops/cuda_maxsim.pq_cluster) is the largest power of two that does
//   not exceed the number of query blocks, and at most 8 for full-width
//   books (their L2 decode is costly: C = 8 is fastest) or 2 for compact
//   ones. Measured: the per-tile barrier keeps a cluster's CTAs in step,
//   which added ~50% to the decode-free time at C = 8, and storing the
//   shares into every CTA cost more than the whole local decode had;
//   compact pq ran 45% slower at C = 8 than at C = 2. Grid x is padded up
//   to a multiple of C; a padding CTA has no query rows: it decodes its
//   share, takes every cluster barrier and skips the products. Every CTA
//   takes a last cluster barrier before it exits.
// - The similarity tile is tile_mma<kBf16> / tile_mma<kInt8Int8>
//   (maxsim_tile.cuh), the k-loop of K1/K2; the decoded values are those of
//   the single-CTA decode, so the scores do not depend on C and equal the
//   parent kernel's bit for bit.
// Footprint at D = 128, M = 16: pq (C = 2) 34.8 KB query block + 2 x 17.4
// KB decoded tiles + 2.3 KB codes + 16 KB books + 3.3 KB scales and
// epilogue (89 KB: two CTAs per SM); pqfull (C = 2) 57 KB and pq_sum (C =
// 8, no books in shared memory) 73 KB, three CTAs per SM each.
//
// C interface: q (nq, lq, d) bf16 or int8, qw (nq, lq) f32, codes (nd, lp,
// m) uint8, books int8 (m, 256, d / m) or (m, 256, d), pmask (nd, lp) bool
// as bytes, out (nq, nd) f32, cluster C in {1, 2, 4, 8}. Returns the
// launch's error (a refused cluster launch included), else
// cudaGetLastError(). evdr_pq_occupancy reports a mode's CTAs per SM and
// the clusters of C CTAs the card can hold at once.
#include "maxsim_tile.cuh"
#include "maxsim_wide.cuh"

namespace evdr {
namespace {

constexpr int kPqRows = 256;   // books padded to 256 rows (uint8 codes)
constexpr int kPqDocs = 8;     // docs per CTA
constexpr int kMaxCluster = 8;  // the portable cluster size

// kPqBf16: compact books, bf16 queries; kPqInt8: compact books, int8
// queries; kPqSum: full-width books summed through L2, bf16 queries.
enum PqMode { kPqBf16 = 0, kPqInt8 = 1, kPqSum = 2 };
// the tile loop that scores the decoded tile
template <int PM> constexpr int kLoop = PM == kPqInt8 ? kInt8Int8 : kBf16;
// CTAs per SM asked of the launch bound: what shared memory allows at D =
// 128 (pq 2; pqfull and pq_sum 3, which without the ask took 93 registers
// and ran two)
template <int PM> constexpr int kMinBlocks = PM == kPqBf16 ? 2 : 3;

__device__ inline uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ inline uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ inline void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// The shared::cluster address of shared::cta address `a` in CTA `rank`.
// The stores below carry no "memory" clobber: they write only the decoded
// tiles, which are read after a barrier that has one, so the loads of the
// next items may run ahead of them.
__device__ inline uint32_t peer(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ inline void st_cluster(uint32_t a, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(a), "r"(v));
}
__device__ inline void st_cluster(uint32_t a, uint2 v) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(a),
               "r"(v.x), "r"(v.y));
}
__device__ inline void st_cluster(uint32_t a, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}
__device__ inline void st_local(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v));
}
__device__ inline void st_local(uint32_t a, uint2 v) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(a), "r"(v.x),
               "r"(v.y));
}
__device__ inline void st_local(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

// The decoded buffer at shared::cta address `dst` in every CTA of the
// cluster: a CTA's shared window is contiguous, so one address per peer
// serves every offset in the buffer.
struct Peers {
  uint32_t base[kMaxCluster];
  uint32_t c;
  __device__ Peers(uint32_t dst, uint32_t c_) : c(c_) {
#pragma unroll
    for (uint32_t p = 0; p < kMaxCluster; ++p)
      base[p] = p < c ? peer(dst, p) : 0u;
  }
  // the same word(s) at offset `off` of every copy (a plain shared store
  // in a cluster of one, where base[0] is the local buffer itself)
  template <typename V>
  __device__ void store(uint32_t local, uint32_t off, V v) const {
    if (c == 1) {
      st_local(local + off, v);
      return;
    }
#pragma unroll
    for (uint32_t p = 0; p < kMaxCluster; ++p)
      if (p < c) st_cluster(base[p] + off, v);
  }
};

// i / n and i % n for a small n, by shift and mask where n is a power of two
struct DivMod {
  int n, shift;
  bool pow2;
  __device__ explicit DivMod(int n_) : n(n_) {
    pow2 = (n & (n - 1)) == 0;
    shift = __ffs(n) - 1;
  }
  __device__ void operator()(int i, int& q, int& r) const {
    if (pow2) {
      q = i >> shift;
      r = i & (n - 1);
    } else {
      q = i / n;
      r = i - q * n;
    }
  }
};

constexpr int kTiles = 2;   // decoded-tile buffers
constexpr int kScales = 3;  // column-scale buffers

// Shared-memory carve-up, in bytes from the dynamic base: the query block,
// kTiles decoded tiles, two code buffers (kCols * m bytes plus 4 for the
// word alignment of stage_codes), kScales column-scale buffers, the
// weights, the epilogue's two reductions and (compact books) the CTA's
// book share.
template <int PM> struct PqSmem {
  int units;
  size_t a, b, raw, raw_bytes, colscale, qw, part, red, books, total;
  __host__ __device__ PqSmem(int d, int m_sub, int c) {
    units = mma_units<kLoop<PM>>(d);
    const size_t row = (size_t)(units + 1) * 16;
    a = 0;
    b = align128(row * kRows);
    raw = align128(b + row * kCols * kTiles);
    raw_bytes = align128((size_t)kCols * m_sub + 4);
    colscale = align128(raw + raw_bytes * 2);
    qw = align128(colscale + sizeof(float) * kCols * kScales);
    part = align128(qw + sizeof(float) * kRows);
    red = align128(part + sizeof(float) * 2 * kRows);
    books = align128(red + sizeof(float) * kRows);
    total = books + (PM == kPqSum ? 0
                                  : align128((size_t)((m_sub + c - 1) / c) *
                                             kPqRows * (d / m_sub)));
  }
};

// Compact books: this CTA's subspaces [m0, m1) of all kCols tokens, from
// its book share `bs` (rows of w int8 bytes), into the decoded tile at
// shared::cta address `dst` (row stride ds) of every CTA of the cluster.
// One item is 8 bytes of one token's subvector (w a multiple of 8: one
// 16-byte bf16 or 8-byte int8 store a peer) or else 4 bytes.
template <typename TS, int IW>
__device__ inline void decode_compact_items(uint32_t dst,
                                            const unsigned char* codes,
                                            const signed char* bs, int m_sub,
                                            int w, int m0, int m1,
                                            uint32_t ds, uint32_t c,
                                            int tid) {
  const int nm = m1 - m0, wq = w / IW;
  const Peers to(dst, c);
  const DivMod by_wq(wq), by_nm(nm);
  for (int i = tid; i < kCols * nm * wq; i += kThreads) {
    int tm, s, t, mm;
    by_wq(i, tm, s);
    by_nm(tm, t, mm);
    const signed char* src =
        bs + ((size_t)mm * kPqRows + codes[t * m_sub + m0 + mm]) * w + s * IW;
    // dims [o, o + IW) of token t
    const uint32_t off =
        t * ds + (uint32_t)((m0 + mm) * w + s * IW) * (uint32_t)sizeof(TS);
    if constexpr (IW == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      if constexpr (sizeof(TS) == 1) {
        to.store(dst, off, v);
      } else {
        const uint2 lo = bf16x4(v.x), hi = bf16x4(v.y);
        to.store(dst, off, make_uint4(lo.x, lo.y, hi.x, hi.y));
      }
    } else {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(src);
      if constexpr (sizeof(TS) == 1)
        to.store(dst, off, v);
      else
        to.store(dst, off, bf16x4(v));
    }
  }
}
template <typename TS>
__device__ inline void decode_compact_share(uint32_t dst,
                                            const unsigned char* codes,
                                            const signed char* bs, int m_sub,
                                            int w, int m0, int m1,
                                            uint32_t ds, uint32_t c,
                                            int tid) {
  if (w % 8 == 0)
    decode_compact_items<TS, 8>(dst, codes, bs, m_sub, w, m0, m1, ds, c, tid);
  else
    decode_compact_items<TS, 4>(dst, codes, bs, m_sub, w, m0, m1, ds, c, tid);
}

// Full-width books read through L2: tokens [t0, t1), each 4-dim group the
// exact int32 sum over m of its words of rows codes[t][m], rounded to bf16
// (nearest even), into every CTA's decoded tile.
__device__ inline void decode_sum_share(uint32_t dst,
                                        const unsigned char* codes,
                                        const signed char* __restrict__ books,
                                        int m_sub, int d, int t0, int t1,
                                        uint32_t ds, uint32_t c, int tid) {
  const int dq = d / 4;
  const Peers to(dst, c);
  const DivMod by_dq(dq);
  for (int i = tid; i < (t1 - t0) * dq; i += kThreads) {
    int t, g;
    by_dq(i, t, g);
    t += t0;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (int m = 0; m < m_sub; ++m) {
      const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(
          books + ((size_t)m * kPqRows + codes[t * m_sub + m]) * d + g * 4));
      const signed char* b = reinterpret_cast<const signed char*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += b[e];
    }
    __nv_bfloat162 h0 = __floats2bfloat162_rn((float)acc[0], (float)acc[1]);
    __nv_bfloat162 h1 = __floats2bfloat162_rn((float)acc[2], (float)acc[3]);
    to.store(dst, t * ds + g * 8,
             make_uint2(*reinterpret_cast<const uint32_t*>(&h0),
                        *reinterpret_cast<const uint32_t*>(&h1)));
  }
}

template <int PM>
__global__ void __launch_bounds__(kThreads, kMinBlocks<PM>)
maxsim_pq_kernel(const unsigned char* __restrict__ q,
                 const float* __restrict__ qw,
                 const unsigned char* __restrict__ codes,
                 const signed char* __restrict__ books,
                 const uint8_t* __restrict__ pmask, float* __restrict__ out,
                 int nq, int lq, int nd, int lp, int d, int m_sub, int qb,
                 int db) {
  using TS = typename Traits<kLoop<PM>>::TQ;
  using TAcc = typename Traits<kLoop<PM>>::TAcc;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t c = cluster_size(), rank = cluster_rank();
  const PqSmem<PM> lay(d, m_sub, (int)c);
  const int units = lay.units;
  const size_t stride = (size_t)(units + 1) * 16;
  unsigned char* As = smem + lay.a;
  unsigned char* Bs = smem + lay.b;
  unsigned char* Braw = smem + lay.raw;
  float* colscale = reinterpret_cast<float*>(smem + lay.colscale);
  float* qw_s = reinterpret_cast<float*>(smem + lay.qw);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  signed char* bs = reinterpret_cast<signed char*>(smem + lay.books);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % 4;  // rows wm*32 .. +32
  const int wn = warp / 4;  // cols wn*32 .. +32
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * qb;
  const int nq_here = max(0, min(qb, nq - q0));  // 0: a padding CTA
  const int nrows = nq_here * lq;
  const size_t row0 = (size_t)q0 * lq;
  const int q_bytes = d * (int)sizeof(TS);

  // the query block, the book share and the first tile's codes arrive in
  // one cp.async group; an int8 row's pad unit (D / 16 odd) starts at zero
  // and stays so, the decode writes only data units
  if (nrows > 0)
    stage_async<kRows>(As, q + row0 * q_bytes, nrows, q_bytes / 16, units,
                       tid);
  for (int r = tid; r < kRows; r += kThreads)
    qw_s[r] = r < nrows ? qw[row0 + r] : 0.f;
  if (units > q_bytes / 16)
    for (int i = tid; i < kTiles * kCols; i += kThreads)
      *reinterpret_cast<uint4*>(Bs + i * stride + q_bytes) =
          make_uint4(0, 0, 0, 0);
  int m0 = 0, m1 = 0;
  if constexpr (PM != kPqSum) {
    m0 = (int)rank * m_sub / (int)c;
    m1 = ((int)rank + 1) * m_sub / (int)c;
    const size_t sub = (size_t)kPqRows * (d / m_sub);  // bytes a subspace
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(books) + m0 * sub;
    for (int i = tid; i < (int)((m1 - m0) * sub / 16); i += kThreads)
      cp_async16(bs + i * 16, src + i * 16, true);
  }
  const int t0 = (int)rank * kCols / (int)c;
  const int t1 = ((int)rank + 1) * kCols / (int)c;

  const int d_begin = blockIdx.y * db;
  const int n_tiles = (lp + kCols - 1) / kCols;
  const int total = (min(nd, d_begin + db) - d_begin) * n_tiles;

  // issue the codes of tile `it` (doc d_begin + it / n_tiles) into code
  // buffer it % 2, its column scales into buffer it % kScales
  auto issue = [&](int it) {
    const int dd = d_begin + it / n_tiles;
    const int l0 = (it % n_tiles) * kCols;
    const int ntok = min(kCols, lp - l0);
    const size_t tok0 = (size_t)dd * lp + l0;
    stage_codes(Braw + (it & 1) * lay.raw_bytes, codes, tok0 * m_sub,
                ntok * m_sub, tid);
    if (tid < kCols)  // -1: the invalid-token sentinel (also an odd Lp's pad)
      colscale[(it % kScales) * kCols + tid] =
          tid < ntok && pmask[tok0 + tid] ? 1.f : -1.f;
  };
  // this CTA's share of tile `it` (its codes landed) into decoded buffer
  // it % kTiles of every CTA of the cluster; the tile's first code sits at
  // the word offset of its first byte
  auto decode = [&](int it) {
    const size_t tok0 =
        (size_t)(d_begin + it / n_tiles) * lp + (it % n_tiles) * kCols;
    const unsigned char* cd =
        Braw + (it & 1) * lay.raw_bytes + ((tok0 * m_sub) & 3);
    const uint32_t dst = smem_addr(Bs + (it % kTiles) * stride * kCols);
    if constexpr (PM == kPqSum)
      decode_sum_share(dst, cd, books, m_sub, d, t0, t1, (uint32_t)stride, c,
                       tid);
    else
      decode_compact_share<TS>(dst, cd, bs, m_sub, d / m_sub, m0, m1,
                               (uint32_t)stride, c, tid);
  };

  float mx[2][2];  // running max of rows wm*32 + i*16 + h*8 + g
#pragma unroll
  for (int i = 0; i < 2; ++i) mx[i][0] = mx[i][1] = kNegInit;

  issue(0);
  cp_async_commit();
  // every CTA of the cluster runs (its shared memory may be written only
  // then) and has zeroed its pad units
  cluster_sync();
  // One cluster barrier a tile publishes its shares (arrive.release after
  // the stores, wait.acquire before the products). Buffer hazards: a CTA
  // writes tile it into decoded buffer it % 2 after passing tile it - 1's
  // barrier, which every peer reached after its products on tile it - 2,
  // the buffer's last user; after the same barrier it refills code buffer
  // (it + 1) % 2 and scale buffer (it + 1) % 3, last read by tile it - 1's
  // decode and tile it - 2's max.
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) issue(it + 1);
    cp_async_commit();
    cp_async_wait1();  // tile it's codes have landed
    __syncthreads();
    decode(it);
    cluster_sync();  // every share of tile it has landed in every CTA
    if (nrows == 0) continue;  // a padding CTA: its share of the decode only

    TAcc acc[2][4][4];
    tile_mma<kLoop<PM>>(acc, As, Bs + (it % kTiles) * stride * kCols, units,
                        stride, lane, wm, wn);
    // masked max of this tile's 8 columns per thread
    const float* cs = colscale + (it % kScales) * kCols + wn * 32 + 2 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float c0 = cs[j * 8], c1 = cs[j * 8 + 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i][0] = fmaxf(mx[i][0], fmaxf(masked((float)acc[i][j][0], c0),
                                         masked((float)acc[i][j][1], c1)));
        mx[i][1] = fmaxf(mx[i][1], fmaxf(masked((float)acc[i][j][2], c0),
                                         masked((float)acc[i][j][3], c1)));
      }
    }
    if (it % n_tiles == n_tiles - 1) {
      // doc epilogue (K1/K2's): combine the quad and the two column warps,
      // apply the no-valid-token rule and the weight, sum each query's Lq
      // rows in order
      const int dd = d_begin + it / n_tiles;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = mx[i][h];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if (t == 0) part[wn * kRows + wm * 32 + i * 16 + h * 8 + g] = m;
          mx[i][h] = kNegInit;
        }
      __syncthreads();
      if (tid < kRows) {
        const float m = fmaxf(part[tid], part[kRows + tid]);
        red[tid] = (m > kNegThresh ? m : 0.f) * qw_s[tid];
      }
      __syncthreads();
      if (tid < nq_here) {
        float s = 0.f;
        for (int r = 0; r < lq; ++r) s += red[tid * lq + r];
        out[(size_t)(q0 + tid) * nd + dd] = s;
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still address it
}

using PqKern = void (*)(const unsigned char*, const float*,
                        const unsigned char*, const signed char*,
                        const uint8_t*, float*, int, int, int, int, int, int,
                        int, int);

// The kernel and its shared memory for these shapes.
template <int PM>
int pq_config(int d, int m_sub, int cluster, PqKern* kern, size_t* smem) {
  if (m_sub < 1 || d < 16 || d % 16 != 0) return (int)cudaErrorInvalidValue;
  if (PM != kPqSum && (d % m_sub != 0 || (d / m_sub) % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const PqSmem<PM> lay(d, m_sub, cluster);
  if (lay.total > 232448) return (int)cudaErrorInvalidValue;
  *kern = maxsim_pq_kernel<PM>;
  *smem = lay.total;
  return (int)cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
}

// Validates what the kernel cannot take, sizes shared memory, launches a
// grid of clusters of `cluster` CTAs on `stream`.
template <int PM>
int launch_pq(const void* q, const void* qw, const void* codes,
              const void* books, const void* pmask, void* out, int nq, int lq,
              int nd, int lp, int d, int m_sub, int cluster, void* stream) {
  if (nq < 1 || nd < 1 || lp < 1 || lq < 1 || lq > kRows || books == nullptr)
    return (int)cudaErrorInvalidValue;
  PqKern kern;
  size_t smem;
  int e = pq_config<PM>(d, m_sub, cluster, &kern, &smem);
  if (e != 0) return e;
  const int qb = kRows / lq;
  const int nqb = (nq + qb - 1) / qb;
  int db = kPqDocs;
  if ((nd + db - 1) / db > kMaxGridY) db = (nd + kMaxGridY - 1) / kMaxGridY;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nqb + cluster - 1) / cluster * cluster,
                     (nd + db - 1) / db);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const unsigned char*>(q),
      static_cast<const float*>(qw), static_cast<const unsigned char*>(codes),
      static_cast<const signed char*>(books),
      static_cast<const uint8_t*>(pmask), static_cast<float*>(out), nq, lq, nd,
      lp, d, m_sub, qb, db);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace evdr

extern "C" int evdr_maxsim_pq(const void* q, const void* qw,
                              const void* codes, const void* books,
                              const void* pmask, void* out, int nq, int lq,
                              int nd, int lp, int d, int m, int cluster,
                              void* stream) {
  return evdr::launch_pq<evdr::kPqBf16>(q, qw, codes, books, pmask, out, nq,
                                        lq, nd, lp, d, m, cluster, stream);
}

extern "C" int evdr_maxsim_pqfull(const void* q, const void* qw,
                                  const void* codes, const void* books,
                                  const void* pmask, void* out, int nq,
                                  int lq, int nd, int lp, int d, int m,
                                  int cluster, void* stream) {
  return evdr::launch_pq<evdr::kPqInt8>(q, qw, codes, books, pmask, out, nq,
                                        lq, nd, lp, d, m, cluster, stream);
}

extern "C" int evdr_maxsim_pq_sum(const void* q, const void* qw,
                                  const void* codes, const void* books,
                                  const void* pmask, void* out, int nq,
                                  int lq, int nd, int lp, int d, int m,
                                  int cluster, void* stream) {
  return evdr::launch_pq<evdr::kPqSum>(q, qw, codes, books, pmask, out, nq,
                                       lq, nd, lp, d, m, cluster, stream);
}

// mode 0 pq, 1 pqfull, 2 pq_sum: out[0] = CTAs per SM, out[1] = clusters
// of `cluster` CTAs the card holds at once.
extern "C" int evdr_pq_occupancy(int mode, int d, int m, int cluster,
                                 void* out) {
  using namespace evdr;
  int* o = static_cast<int*>(out);
  PqKern kern;
  size_t smem;
  int e = mode == 0   ? pq_config<kPqBf16>(d, m, cluster, &kern, &smem)
          : mode == 1 ? pq_config<kPqInt8>(d, m, cluster, &kern, &smem)
                      : pq_config<kPqSum>(d, m, cluster, &kern, &smem);
  if (e != 0) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[0], kern,
                                                         kThreads, smem);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(&o[1], kern, &cfg);
}

// K3's wide path (D above 256): maxsim_wide.cuh's D-chunked loop, each
// chunk of a page tile decoded from the tile's codes by every CTA (no
// cluster: `cluster` must be 1): compact books (w a multiple of 4) copy
// each 4-column group from the subspace it falls in, into a bf16 tile (pq)
// or an exact int8 tile (pqfull); full-width books (pq_sum) sum the group
// over M in int32 and round it to bf16. C interfaces as above.
template <int MODE, int BOOKS>
int launch_pq_wide(const void* q, const void* qw, const void* codes,
                   const void* books, const void* pmask, void* out, int nq,
                   int lq, int nd, int lp, int d, int m, int cluster,
                   void* stream) {
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  return evdr::launch_wide<MODE, false, false, BOOKS>(
      q, qw, codes, nullptr, pmask, out, nullptr, books, nq, lq, nd, lp, d,
      m, stream);
}

extern "C" int evdr_maxsim_pq_wide(const void* q, const void* qw,
                                   const void* codes, const void* books,
                                   const void* pmask, void* out, int nq,
                                   int lq, int nd, int lp, int d, int m,
                                   int cluster, void* stream) {
  return launch_pq_wide<evdr::kBf16, evdr::kCompactBooks>(
      q, qw, codes, books, pmask, out, nq, lq, nd, lp, d, m, cluster, stream);
}

extern "C" int evdr_maxsim_pqfull_wide(const void* q, const void* qw,
                                       const void* codes, const void* books,
                                       const void* pmask, void* out, int nq,
                                       int lq, int nd, int lp, int d, int m,
                                       int cluster, void* stream) {
  return launch_pq_wide<evdr::kInt8Int8, evdr::kCompactBooks>(
      q, qw, codes, books, pmask, out, nq, lq, nd, lp, d, m, cluster, stream);
}

extern "C" int evdr_maxsim_pq_sum_wide(const void* q, const void* qw,
                                       const void* codes, const void* books,
                                       const void* pmask, void* out, int nq,
                                       int lq, int nd, int lp, int d, int m,
                                       int cluster, void* stream) {
  return launch_pq_wide<evdr::kBf16, evdr::kFullBooks>(
      q, qw, codes, books, pmask, out, nq, lq, nd, lp, d, m, cluster, stream);
}
