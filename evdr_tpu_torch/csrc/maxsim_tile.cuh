// Fused masked MaxSim for Hopper (sm_90a): the tile loop shared by
// maxsim_int8.cu (K2), maxsim_int8_defer.cu (K2b, K2 with its doc epilogue
// deferred one tile) and maxsim_int4.cu (K4). maxsim_pq.cu (K3, a kernel of
// its own: thread-block clusters share the PQ decode), maxsim_f32.cu (K1's
// float32 mode and K5's, a kernel of its own: 64 x 32 outputs a warp on
// 256 x 64 tiles, one CTA per SM at D = 128) and maxsim_train.cu (K6, whose
// float32 mode recomputes K5's similarities through tile_mma below) reuse
// the helpers and tile_mma; maxsim_bf16.cu (K1 and K5 in bf16, a kernel of
// its own on wgmma and TMA) the constants and smem_addr.
//
// score[q, d] = sum_t qw[q, t] * f(max_m sim[q, t, d, m]), with
//   sim = <Q[q, t], P[d, m]> * s[d, m] for a valid doc token (s = 1 for a
//   float index, the per-token scale for an int8 index) and -1e30 for an
//   invalid one; f(x) = x, except a doc whose max stayed below -1e29 (no
//   valid token) contributes 0. qw is the query-token mask, times the query
//   token's scale when the queries were quantized.
//
// Design:
// - One CTA of 256 threads owns CFG::kR query-token rows (a tile
//   configuration, TileCfg below): the floor(kR / Lq) whole queries
//   starting at blockIdx.x * qb, staged once in shared memory. It walks db
//   docs (blockIdx.y), and each doc's Lp tokens in tiles of kCols = 64.
//   The configuration K2, K2b and K4 run is CfgWide: 256 rows and 8 docs a
//   CTA, 64 x 32 outputs a warp, the query block brought by cp.async with
//   the first page tile (measured on an H100 18-20% faster than 128 rows
//   and 32 x 32 a warp, tile_mma's layout, at the serving shape, with the
//   same scores bit for bit, PERF.md).
// - Each tile's similarity block comes from mma.sync tensor-core
//   instructions (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32, or three
//   m16n8k8 tf32 products per k-step for float32, see mma() below): 8 warps
//   in a 4 x 2 grid, fed by ldmatrix. Operand rows sit in shared memory as
//   16-byte units with an odd row stride (units + 1), so the 8 rows an
//   ldmatrix phase reads hit 32 distinct banks. Each output's k order is
//   the same in both configurations.
// - The masked, scaled running max is taken straight from the accumulator
//   registers (each thread holds 2 rows per 16-row block x 8 columns of a
//   tile) and kept in registers across the doc's Lp loop: the (nq, nd, Lq,
//   Lp) similarity tensor never leaves the registers.
// - Page tiles arrive by cp.async into two buffers: the next tile (which
//   may belong to the next doc) loads while this one multiplies.
// - At each doc's end the four threads of a quad and the two column warps
//   combine their maxima, the no-valid-token rule and the qw weight apply,
//   and one thread per query sums its Lq rows (in order) into out[q, d].
// - blockIdx.x (the query block) varies fastest, so the CTAs that are in
//   flight together share a few docs and read their pages from L2: device
//   memory streams the index about once per call.
// - Staged modes (K2's int8 mode, K4) bring their stored tile (int8 codes,
//   packed int4 bytes) into a raw buffer by cp.async and turn it into the
//   MMA operand tile in shared memory once it has landed (widen, unpack
//   nibbles). Each such stage sits behind `if constexpr` on the mode, so
//   the other modes compile as before. Converting in registers instead
//   (ldmatrix of the raw tile, each warp widening its own fragments) was
//   measured and lost, or tied for int4full (PERF.md).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace evdr {

constexpr int kRows = 128;         // query-token rows of tile_mma's tile
constexpr int kCols = 64;          // doc tokens per tile
constexpr int kThreads = 256;      // 8 warps: 4 (rows) x 2 (cols)
constexpr int kMaxGridY = 65535;

// A tile configuration of maxsim_kernel: ROWS query-token rows per CTA
// against 64-token page tiles, the 8 warps standing 4 x 2, so a warp holds
// kI blocks of 16 rows x kJ blocks of 8 columns (kI ldmatrix.x4 of A and
// two of B per k-step); DOCS docs per CTA (blockIdx.y). CfgWide is the one
// K2, K2b and K4 run (64 x 32 a warp on 256 x 64 tiles, as K1 float32 in
// maxsim_f32.cu: half the A and B ldmatrix bytes per product, and each
// page tile converted once per 256 query rows).
template <int ROWS, int DOCS> struct TileCfg {
  static constexpr int kR = ROWS, kDocs = DOCS;
  static constexpr int kWM = 4, kWN = 2;
  static constexpr int kWarpRows = ROWS / kWM, kWarpCols = kCols / kWN;
  static constexpr int kI = kWarpRows / 16, kJ = kWarpCols / 8;
};
using CfgWide = TileCfg<2 * kRows, 8>;
constexpr float kNegInit = -1e30f;    // pallas_maxsim.py NEG_INIT
constexpr float kNegThresh = -1e29f;  // pallas_maxsim.py NEG_THRESH

// kBf16: bf16 Q x bf16 P (K3's loop). kInt8Bf16: bf16 Q x int8 codes
// widened to bf16 in shared memory (K2, int8 mode). kInt8Int8: int8 Q x
// int8 codes, int32 accumulation (K2, int8full mode). kF32: f32 Q x f32 P
// by split TF32 products (K1 and K5 at compute_dtype float32, K6's
// recompute). kInt4Bf16 / kInt4Int8: the same two K2 modes over token-pair
// packed int4 codes unpacked in shared memory (K4).
enum Mode {
  kBf16 = 0, kInt8Bf16 = 1, kInt8Int8 = 2, kF32 = 3,
  kInt4Bf16 = 4, kInt4Int8 = 5
};

template <int MODE> constexpr bool is_int4 = MODE == kInt4Bf16 ||
                                             MODE == kInt4Int8;
// the page tile lands in a raw buffer and is converted into the operand
template <int MODE> constexpr bool is_staged = MODE == kInt8Bf16 ||
                                               is_int4<MODE>;
// int8 x int8 tensor-core products
template <int MODE> constexpr bool is_int8_mma = MODE == kInt8Int8 ||
                                                 MODE == kInt4Int8;

// The tile kernel's launch bound is the bare __launch_bounds__(kThreads): a
// minimum of 1 CTA per SM is NOT the same, it let ptxas raise the 128-row
// kernels from 73-77 to 90-101 registers (the -Xptxas=-v report) and the
// 256-row ones from 124-128 to 135-151, and they ran slower; a minimum of 2
// gave K2b the same registers and no gain (PERF.md).

template <int MODE> struct Traits;
template <> struct Traits<kBf16> {
  using TQ = __nv_bfloat16; using TP = __nv_bfloat16; using TAcc = float;
};
template <> struct Traits<kInt8Bf16> {
  using TQ = __nv_bfloat16; using TP = signed char; using TAcc = float;
};
template <> struct Traits<kInt8Int8> {
  using TQ = signed char; using TP = signed char; using TAcc = int;
};
template <> struct Traits<kF32> {
  using TQ = float; using TP = float; using TAcc = float;
};
// K4 stores bytes: packed nibble pairs
template <> struct Traits<kInt4Bf16> {
  using TQ = __nv_bfloat16; using TP = uint8_t; using TAcc = float;
};
template <> struct Traits<kInt4Int8> {
  using TQ = signed char; using TP = uint8_t; using TAcc = int;
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

// 16-byte units per operand row as the MMA reads it: one k-step takes two
// units (bf16 k16, s8 k32, tf32 k8), so an int8 row pads to an even count
// with zeros.
template <int MODE> __host__ __device__ inline int mma_units(int d) {
  if (is_int8_mma<MODE>) return (d / 16 + 1) / 2 * 2;
  return MODE == kF32 ? d / 4 : d / 8;
}

// Bytes of one raw page-tile buffer of a staged mode (two are kept): the
// int8 codes of K2's int8 mode (kCols rows), K4's packed bytes (kCols / 2
// rows, each holding two tokens).
template <int MODE> __host__ __device__ inline size_t raw_tile_bytes(
    int raw_units) {
  if (MODE == kInt8Bf16) return (size_t)(raw_units + 1) * 16 * kCols;
  if (is_int4<MODE>) return (size_t)(raw_units + 1) * 16 * (kCols / 2);
  return 0;
}

// Shared-memory carve-up, in bytes from the dynamic base. Row strides are
// (units + 1) * 16 bytes. K2b (`defer`) keeps two `part` and two `red`
// buffers, one of each per doc parity.
template <int MODE, class CFG> struct Smem {
  int units, raw_units;
  size_t a, b, raw, colscale, qw, part, red, total;
  __host__ __device__ explicit Smem(int d, bool defer = false) {
    units = mma_units<MODE>(d);
    raw_units = d / 16;  // int8 page units staged before widening
    const size_t row = (size_t)(units + 1) * 16;
    a = 0;
    b = align128(a + row * CFG::kR);
    raw = align128(b + row * kCols * (is_staged<MODE> ? 1 : 2));
    colscale = align128(raw + raw_tile_bytes<MODE>(raw_units) * 2);
    qw = align128(colscale + sizeof(float) * kCols * 2);
    part = align128(qw + sizeof(float) * CFG::kR);
    red = align128(part + sizeof(float) * (defer ? 4 : 2) * CFG::kR);
    total = align128(red + sizeof(float) * (defer ? 2 : 1) * CFG::kR);
  }
};

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ inline void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ inline void mma(float (&c)[4], const uint32_t (&a)[4],
                           uint32_t b0, uint32_t b1, __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ inline void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                           uint32_t b1, signed char) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi): 21 of float32's 24
// significand bits survive the pair.
__device__ inline void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(x);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(f));
  const float r = f - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// float32 (3xTF32): a.b ~ ahi.bhi + ahi.blo + alo.bhi, the small terms
// first, all accumulated in f32; only the alo.blo term (~2^-22 relative)
// is dropped. ldmatrix's b16 fragments of a row of f32 values are exactly
// the tf32 m16n8k8 fragments (thread (g, t) holds row g, element t of
// each 16-byte unit), so the operand staging is K1's.
__device__ inline void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                           uint32_t b1, float) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// Copy `rows` rows of `gunits` 16-byte units from a row-major global
// operand to shared memory (row stride (units + 1) * 16); rows at or past
// `valid` and units at or past `gunits` are zero.
__device__ inline void stage_sync(unsigned char* dst, const unsigned char* src,
                                  int rows, int valid, int gunits, int units,
                                  int tid) {
  const size_t stride = (size_t)(units + 1) * 16;
  for (int i = tid; i < rows * units; i += kThreads) {
    const int r = i / units, u = i % units;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid && u < gunits)
      v = *reinterpret_cast<const uint4*>(src + ((size_t)r * gunits + u) * 16);
    *reinterpret_cast<uint4*>(dst + r * stride + u * 16) = v;
  }
}

// The same for a page tile of ROWS rows, through cp.async (pad units
// stored directly).
template <int ROWS = kCols>
__device__ inline void stage_async(unsigned char* dst,
                                   const unsigned char* src, int valid,
                                   int gunits, int units, int tid) {
  const size_t stride = (size_t)(units + 1) * 16;
  for (int i = tid; i < ROWS * units; i += kThreads) {
    const int r = i / units, u = i % units;
    unsigned char* to = dst + r * stride + u * 16;
    if (u < gunits) {
      const bool ok = r < valid;
      cp_async16(to, ok ? src + ((size_t)r * gunits + u) * 16 : src, ok);
    } else {
      *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
    }
  }
}

// int8 codes (raw layout) -> bf16 operand (exact: |code| <= 127).
__device__ inline void widen_tile(unsigned char* dst, const unsigned char* raw,
                                  int raw_units, int units, int tid) {
  const size_t rs = (size_t)(raw_units + 1) * 16, ds = (size_t)(units + 1) * 16;
  for (int i = tid; i < kCols * raw_units; i += kThreads) {
    const int r = i / raw_units, u = i % raw_units;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * rs + u * 16);
    const signed char* b = reinterpret_cast<const signed char*>(&v);
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      __nv_bfloat162 h =
          __floats2bfloat162_rn((float)b[2 * j], (float)b[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    uint4* o = reinterpret_cast<uint4*>(dst + r * ds + u * 32);
    o[0] = make_uint4(w[0], w[1], w[2], w[3]);
    o[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// 4 bytes global -> shared, asynchronously; only the first `n` (1-4) are
// read, the rest of the word is zero.
__device__ inline void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

// The `n` PQ code bytes of a tile (K3), which start at byte `start` of the
// code array, into `dst` by 4-byte words. The copy starts at the word that
// holds byte `start`, so the tile's first code sits at dst[start & 3]; the
// last word reads only up to the tile's end.
__device__ inline void stage_codes(unsigned char* dst,
                                   const unsigned char* base, size_t start,
                                   int n, int tid) {
  const size_t a0 = start & ~size_t(3);
  const int span = (int)(start - a0) + n;
  for (int w = tid; w * 4 < span; w += kThreads)
    cp_async4(dst + w * 4, base + a0 + w * 4, min(4, span - w * 4));
}

// Four int8 values to four bf16 (exact for |v| <= 256), as two words.
__device__ inline uint2 bf16x4(uint32_t v) {
  const signed char* b = reinterpret_cast<const signed char*>(&v);
  __nv_bfloat162 h0 = __floats2bfloat162_rn((float)b[0], (float)b[1]);
  __nv_bfloat162 h1 = __floats2bfloat162_rn((float)b[2], (float)b[3]);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&h0),
                    *reinterpret_cast<const uint32_t*>(&h1));
}

// Store 16 int8 values as row unit(s) of the operand tile: one 16-byte
// unit of int8, or two of bf16.
template <typename TS>
__device__ inline void store16(unsigned char* row, int u, uint4 v) {
  if constexpr (sizeof(TS) == 1) {
    *reinterpret_cast<uint4*>(row + u * 16) = v;
  } else {
    const uint2 a = bf16x4(v.x), b = bf16x4(v.y), c = bf16x4(v.z),
                d = bf16x4(v.w);
    uint4* o = reinterpret_cast<uint4*>(row + u * 32);
    o[0] = make_uint4(a.x, a.y, b.x, b.y);
    o[1] = make_uint4(c.x, c.y, d.x, d.y);
  }
}

// K4: packed int4 bytes (kCols / 2 rows of raw_units 16-byte units) ->
// the operand tile, token 2r (low nibbles of row r) at row 2r and token
// 2r + 1 (high nibbles) at row 2r + 1, sign-extended from 4 bits:
// (n ^ 8) - 8 per byte.
template <typename TS>
__device__ inline void unpack_int4_tile(unsigned char* dst,
                                        const unsigned char* raw,
                                        int raw_units, int units, int tid) {
  const size_t rs = (size_t)(raw_units + 1) * 16, ds = (size_t)(units + 1) * 16;
  for (int i = tid; i < (kCols / 2) * raw_units; i += kThreads) {
    const int r = i / raw_units, u = i % raw_units;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * rs + u * 16);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = __vsub4((w[j] & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
      hi[j] = __vsub4(((w[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                      0x08080808u);
    }
    store16<TS>(dst + (2 * r) * ds, u, make_uint4(lo[0], lo[1], lo[2], lo[3]));
    store16<TS>(dst + (2 * r + 1) * ds, u,
                make_uint4(hi[0], hi[1], hi[2], hi[3]));
  }
}

__device__ inline float masked(float s, float cs) {
  return cs >= 0.f ? s * cs : kNegInit;
}

// One 128 x 64 similarity tile for K6's float32 recompute and for K3:
// acc[i][j] receives rows wm*32 + i*16 + {g, g+8} and columns wn*32 + j*8 +
// 2t + {0, 1} of As (kRows query-token rows, 32 x 32 outputs a warp)
// against B (kCols doc-token rows), summed over D in k-steps of two units,
// in order. Each output's arithmetic is maxsim_kernel's k-loop below and, in
// float32 mode, K5's (maxsim_f32.cu: the same fragments, MMA shape, three
// products a k-step in the same order, k order), so each similarity K6
// recomputes is bit-identical to the one K5 took the max of, which K6's
// (sim == M) indicator needs. Keep the loops' arithmetic identical.
// maxsim_kernel does not call this function: doing so cost K2's int8 mode
// 4% on the H100 (more registers, another schedule;
// scripts/torch_kernel_ab.py, PERF.md).
template <int MODE>
__device__ inline void tile_mma(typename Traits<MODE>::TAcc (&acc)[2][4][4],
                                const unsigned char* As,
                                const unsigned char* B, int units,
                                size_t stride, int lane, int wm, int wn) {
  using TS = typename Traits<MODE>::TQ;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
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

// K2b's deferred doc epilogue, in two stages that each run inside a
// barrier interval the tile loop already has, for a CTA of R query-token
// rows (R <= kThreads: one row a thread). Stage 1 (one tile after the
// doc's end, threads tid < R): the row's max over the two column warps
// (`pp`, 2 * R floats), the no-valid-token rule and the weight, into `rr`.
// Stage 2 (one tile later, threads tid < nq_here): the sum of query tid's
// lq rows of `rr`, in order, into out[q, dd]. The same operations in the
// same order as the in-step epilogue, so the scores equal K2's bit for
// bit.
template <int R>
__device__ inline void defer_combine(const float* pp, float* rr,
                                     const float* qw_s, int tid) {
  if (tid < R) {
    const float m = fmaxf(pp[tid], pp[R + tid]);
    rr[tid] = (m > kNegThresh ? m : 0.f) * qw_s[tid];
  }
}
__device__ inline void defer_sum(const float* rr, float* out, int q0,
                                 int nq_here, int lq, int nd, int dd,
                                 int tid) {
  if (tid < nq_here) {
    float s = 0.f;
    for (int r = 0; r < lq; ++r) s += rr[tid * lq + r];
    out[(size_t)(q0 + tid) * nd + dd] = s;
  }
}

// DEFER: K2b, the doc epilogue of K2 moved one tile later (see the doc-end
// block below); a template flag. CFG: the tile configuration (TileCfg).
// The unnamed pointer keeps the parameters' offsets, and so the machine
// code, of the kernels measured in PERF.md.
template <int MODE, bool DEFER, class CFG>
__global__ void __launch_bounds__(kThreads)
maxsim_kernel(const typename Traits<MODE>::TQ* __restrict__ q,
              const float* __restrict__ qw,
              const typename Traits<MODE>::TP* __restrict__ p,
              const float* __restrict__ scales,
              const uint8_t* __restrict__ pmask, float* __restrict__ out,
              float*, int nq, int lq, int nd, int lp, int d, int qb,
              int db) {
  using TQ = typename Traits<MODE>::TQ;
  using TP = typename Traits<MODE>::TP;
  using TAcc = typename Traits<MODE>::TAcc;
  // the MMA operand type: bf16 unless both sides are int8 (f32 for kF32)
  using TS = typename Traits<MODE>::TQ;
  constexpr int R = CFG::kR, kI = CFG::kI, kJ = CFG::kJ;
  static_assert(R <= kThreads, "one row a thread in the doc epilogue");
  static_assert(kJ == 4, "two B ldmatrix.x4 a k-step");
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<MODE, CFG> lay(d, DEFER);
  const int units = lay.units;
  const size_t stride = (size_t)(units + 1) * 16;
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
  const int wm = warp % CFG::kWM;  // rows wm*kWarpRows .. +kWarpRows
  const int wn = warp / CFG::kWM;  // cols wn*32 .. +32
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * qb;
  const int nq_here = min(qb, nq - q0);
  const int nrows = nq_here * lq;
  const size_t row0 = (size_t)q0 * lq;
  const int p_units = d * (int)sizeof(TP) / 16;

  // the query block, reused for every doc token: one cp.async group with
  // the first page tile
  stage_async<R>(As, reinterpret_cast<const unsigned char*>(q + row0 * d),
                 nrows, d * (int)sizeof(TQ) / 16, units, tid);
  for (int r = tid; r < R; r += kThreads)
    qw_s[r] = r < nrows ? qw[row0 + r] : 0.f;
  if constexpr (is_staged<MODE> && MODE != kInt8Bf16) {
    // the operand tile's pad units (int8 rows pad to an even unit count)
    // stay zero; the conversions write only the data units
    for (int i = tid; i < kCols * (int)stride / 16; i += kThreads)
      reinterpret_cast<uint4*>(Bs)[i] = make_uint4(0, 0, 0, 0);
  }
  const size_t raw_bytes = raw_tile_bytes<MODE>(lay.raw_units);

  const int d_begin = blockIdx.y * db;
  const int n_tiles = (lp + kCols - 1) / kCols;
  const int total = (min(nd, d_begin + db) - d_begin) * n_tiles;

  // issue the loads of tile `it` (doc d_begin + it / n_tiles) into `buf`
  auto issue = [&](int it, int buf) {
    const int dd = d_begin + it / n_tiles;
    const int l0 = (it % n_tiles) * kCols;
    const int ntok = min(kCols, lp - l0);
    const size_t tok0 = (size_t)dd * lp + l0;
    if constexpr (is_int4<MODE>) {
      // packed rows l0 / 2 .. of doc dd: (lp + 1) / 2 rows of d bytes
      const unsigned char* src =
          p + ((size_t)dd * ((lp + 1) / 2) + l0 / 2) * d;
      stage_async<kCols / 2>(Braw + buf * raw_bytes, src, (ntok + 1) / 2,
                             p_units, lay.raw_units, tid);
    } else {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(p + tok0 * d);
      if constexpr (MODE == kInt8Bf16)
        stage_async(Braw + buf * (size_t)(lay.raw_units + 1) * 16 * kCols,
                    src, ntok, p_units, lay.raw_units, tid);
      else
        stage_async(Bs + buf * stride * kCols, src, ntok, p_units, units,
                    tid);
    }
    if (tid < kCols) {
      float cs = -1.f;  // the invalid-token sentinel (also an odd Lp's pad)
      if (tid < ntok && pmask[tok0 + tid]) cs = scales[tok0 + tid];
      colscale[buf * kCols + tid] = cs;
    }
  };

  float mx[kI][2];  // running max of rows wm*kWarpRows + i*16 + h*8 + g
#pragma unroll
  for (int i = 0; i < kI; ++i) mx[i][0] = mx[i][1] = kNegInit;
  // K2b: the docs due for stage 1 and for stage 2 of their epilogue
  [[maybe_unused]] int pend1 = -1, pend2 = -1;

  if (total > 0) issue(0, 0);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) issue(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();  // tile `it` has landed (only `it + 1` may be in flight)
    __syncthreads();
    const unsigned char* B = Bs + buf * stride * kCols;
    if constexpr (MODE == kInt8Bf16) {
      widen_tile(Bs, Braw + buf * (size_t)(lay.raw_units + 1) * 16 * kCols,
                 lay.raw_units, units, tid);
      __syncthreads();
      B = Bs;
    } else if constexpr (is_int4<MODE>) {
      unpack_int4_tile<TS>(Bs, Braw + buf * raw_bytes, lay.raw_units, units,
                           tid);
      __syncthreads();
      B = Bs;
    }

    // the tile's similarities; tile_mma above repeats this loop's
    // arithmetic for K3 and K6
    TAcc acc[kI][kJ][4];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    const unsigned char* a_row =
        As + (wm * CFG::kWarpRows + lane % 16) * stride;
    const unsigned char* b_row =
        B + (wn * 32 + lane % 8 + (lane / 16) * 8) * stride;
    for (int k = 0; k < units; k += 2) {
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

    // masked, scaled max of this tile's 8 columns per thread
    const float* cs = colscale + buf * kCols + wn * 32 + 2 * t;
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
      // K2b, after this tile's MMAs: stage 2 of the doc combined one tile
      // ago, stage 1 of the doc that ended in the last tile (their inputs
      // landed before the last barrier; the parity buffers keep each doc's
      // apart from the next doc's, which may end within this very tile)
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
      // doc epilogue: combine the quad and the two column warps, apply the
      // no-valid-token rule and the weight, sum each query's Lq rows. K2b
      // combines the quad here and leaves the rest to the next two tiles
      // (or the end of the loop), so it costs no barrier pair of its own.
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
        if (tid < R) {  // R <= kThreads: one row a thread
          const float m = fmaxf(part[tid], part[R + tid]);
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
    __syncthreads();  // buffer `buf` is free for tile it + 2
  }
  if constexpr (DEFER) {
    // the last docs' stages (the loop's last barrier published their inputs)
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

// Host launcher: validates what the kernel cannot take, sizes shared
// memory, launches on `stream` and returns cudaGetLastError(). DEFER: K2b
// (K2's modes only). CFG: the tile configuration; a call takes Lq <=
// CFG::kR query tokens and D a multiple of 16 (the wrappers slice longer
// queries and zero-pad D).
template <int MODE, bool DEFER, class CFG>
int launch(const void* q, const void* qw, const void* p, const void* scales,
           const void* pmask, void* out, int nq, int lq, int nd, int lp,
           int d, void* stream) {
  if (nq < 1 || nd < 1 || lp < 1 || lq < 1 || lq > CFG::kR || d < 16 ||
      d % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Smem<MODE, CFG> lay(d, DEFER);
  if (lay.total > 232448) return (int)cudaErrorInvalidValue;
  auto* kern = maxsim_kernel<MODE, DEFER, CFG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  const int qb = CFG::kR / lq;
  int db = CFG::kDocs;
  if ((nd + db - 1) / db > kMaxGridY) db = (nd + kMaxGridY - 1) / kMaxGridY;
  dim3 grid((nq + qb - 1) / qb, (nd + db - 1) / db);
  kern<<<grid, kThreads, lay.total, (cudaStream_t)stream>>>(
      static_cast<const typename Traits<MODE>::TQ*>(q),
      static_cast<const float*>(qw),
      static_cast<const typename Traits<MODE>::TP*>(p),
      static_cast<const float*>(scales), static_cast<const uint8_t*>(pmask),
      static_cast<float*>(out), nullptr, nq, lq, nd, lp, d, qb, db);
  return (int)cudaGetLastError();
}

}  // namespace evdr
