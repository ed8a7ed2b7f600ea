// Stage 2 of pruned search over an int8 index: the exact f32 rerank of each
// query's candidate pages, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's stage 2 is an XLA gather plus an
// f32 einsum (evdr_tpu/ops/pruned.py:81-147), and the port's plain version,
// ops/pruned.py:_rerank_scores, stays as what this kernel is held to. That
// plain version built four f32 (nq, C, Lp, D) copies of the candidates per
// query block (the gather, the widening, the scale product, the einsum's
// operand) and ran at ~2% of what the card allows.
//
// score[q, c] = sum_t qw[q, t] * max_m sim[q, t, m], over the page at row
//   cand[q, c] of the index, with sim = <Q[q, t], codes[m]> * scale[m] for a
//   valid page token and NEG_FILL (-1e4, ops/maxsim.py) for an invalid one;
//   a page with no valid token scores -inf (it ranks last), a row outside
//   [0, n_rows) NaN. The scale multiplies the token's dot product after the
//   sum over D.
//
// The products keep f32: no TF32, no int8 or fp8 products. The int8 codes
// are exact in f16. Each f32 query value v of row r is written as three f16
// terms, v = (hi + mid / 256 + lo / 65536) * 2**-s_r + e, with hi, mid and
// lo integers of at most 8 bits and 2**s_r the power of two that brings the
// row's largest |value| into [128, 256), so |e| <= 2**-24 of that largest
// value. Every product of a code and a term is exact, and so is every
// partial sum of one term's products (on one grid, below 2**23 of it): the
// f16 tensor cores (mma.sync m16n8k16, f32 sums) give each term's dot
// product exactly, whatever their accumulation rounds, and the three are
// added in f32 (lo + mid first). The row's 2**-s_r applies to its maximum
// (a power of two: exact). Against an f64 product at the pruned cell's
// shape (PERF.md, PR 17): RMS relative error 7.5e-8 (the plain f32 path
// 5.1e-8, an FFMA kernel 8.2e-8), mean signed error 0.7% of the mean
// absolute one. Terms split value by value (hi = bf16(v), ...) left the
// tensor cores' sums of the large hi products rounding toward zero: mean
// signed error -44% of the mean absolute.
//
// What bounds it on the H100: the bytes. At the pruned cell's shape (256
// queries x 32 tokens, 416 candidates of 768 x 128) a call reads ~10.9 GB
// of candidate pages (3.25 ms at 3.35 TB/s) and does 3 x 2 * D operations
// per valid token pair, 1.5e12 (1.55 ms at 989 TFLOP/s, 2.4 ms at the ~634
// mma.sync reaches). It runs at ~7.4 ms; against the FFMA design (the
// query's f32 rows against widened codes, 8 x 8 sums a thread), ~20 ms:
// 8 x 8 a thread reads 64 bytes of shared memory per 64 FFMA, an SM serves
// 128 bytes a clock to 128 FFMA lanes, and the loop reached 57% of the
// card's FFMA rate. What is left is instruction issue: each stage's
// widening, scaling and maxima beside 96 products a warp.
//
// The design, query-major (blockIdx.x: a query and kCands of its
// candidates; the candidates' pages overlap little across queries: 37,868
// distinct pages of 106,496 picks in the cell):
// - the query's terms stay in registers for the CTA's life: 4 warps stand
//   as 2 halves of the 32 query rows x 2 halves of each 64-token stage, and
//   a warp holds its 16 rows' three terms over 128 dims as mma A fragments;
// - each candidate page streams in stages of 64 tokens x 128 dims, read
//   straight from the index by the candidate's row (no gather copy) into
//   registers one stage ahead, widened to f16 (two bytes a PRMT, one HSUB2)
//   and stored in one of two shared buffers (rows of 17 16-byte units:
//   conflict-free ldmatrix);
// - a warp's 12 products a k-step (3 terms x 4 blocks of 8 tokens) feed
//   from 2 ldmatrix.x4, loaded one k-step ahead; after a stage the terms'
//   sums are added, each token's (scale, fill) pair applies in one FFMA
//   (valid: (s, 0), masked or past the page: (0, -inf)) and each row's
//   running max stays in registers; at the page's end warp shuffles and
//   two barriers combine the maxima (with NEG_FILL where the page has a
//   masked token) and one thread sums the rows in order;
// - D above 128 runs in chunks of 128 (the query's fragments reloaded per
//   chunk, the sums carried); queries above 32 tokens in passes of 32.
// Selection stays outside (parallel/topk._select_topk over the (nq, C)
// scores).
//
// C interface: q (nq, lq, d) f32, qw (nq, lq) f32, p (n_rows, lp, d) int8,
// scales (n_rows, lp) f32, pmask (n_rows, lp) bool as bytes, cand (nq,
// n_cand) int64 rows of p (repeats allowed), out (nq, n_cand) f32; d a
// multiple of 16. Returns cudaGetLastError() after the launch.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace evdr_rerank {

constexpr int kThreads = 128;    // 4 warps: 2 row halves x 2 token halves
constexpr int kRowsQ = 32;       // query-token rows a pass
constexpr int kBlk = 64;         // page tokens a stage
constexpr int kDC = 128;         // token dims a stage (the query fragments')
constexpr int kStride = kDC + 8; // f16 a staged row: 17 units of 16 bytes
constexpr int kCands = 8;        // candidates a CTA
constexpr float kNegFill = -1e4f;

struct Smem {
  size_t p, tok, part, row, qw, pw, total;
  __host__ __device__ Smem() {
    p = 0;                                        // [2][kBlk][kStride] f16
    tok = p + 2 * 2 * kBlk * kStride;             // [2][kBlk] float2
    part = tok + sizeof(float2) * 2 * kBlk;       // [2][kRowsQ] f32
    row = part + sizeof(float) * 2 * kRowsQ;      // [kRowsQ]
    qw = row + sizeof(float) * kRowsQ;            // [kRowsQ]
    pw = qw + sizeof(float) * kRowsQ;             // [kRowsQ] float2
    total = pw + sizeof(float2) * kRowsQ;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a . b (f16 x f16 -> f32)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c = a . b (f16 x f16 -> f32), c's old values ignored
__device__ __forceinline__ void mma0(float (&c)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}
// One of a query value's three terms: x rounded to an integer r (|r| <=
// 256) times `unit` (1, 2**-8 or 2**-16: exact in f16, as a subnormal for
// the smallest), as f16 bits; x becomes what is left, times 256.
__device__ __forceinline__ uint32_t term(float& x, float unit) {
  const float r = rintf(x);
  x = (x - r) * 256.f;
  return (uint32_t)__half_as_ushort(__float2half_rn(r * unit));
}
// 4 int8 codes -> 4 f16 (exact) as two words: each byte code + 128 becomes
// the low mantissa byte of 1024 (0x6400), and 1152 is subtracted.
__device__ __forceinline__ uint2 codes_f16(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  const __half2 bias = __float2half2_rn(1152.f);
  uint32_t lo = __byte_perm(x, 0x64646464u, 0x4140);
  uint32_t hi = __byte_perm(x, 0x64646464u, 0x4342);
  __half2 a = __hsub2(*reinterpret_cast<__half2*>(&lo), bias);
  __half2 b = __hsub2(*reinterpret_cast<__half2*>(&hi), bias);
  return make_uint2(*reinterpret_cast<uint32_t*>(&a),
                    *reinterpret_cast<uint32_t*>(&b));
}

// The products of one stage: NKS k-steps (0: `nks` of them, guarded);
// FIRST: the stage starts the sums (the first k-step's products replace
// them).
template <int NKS, bool FIRST>
__device__ __forceinline__ void tile_mma(float (&acc)[3][4][4],
                                         const uint32_t (&afr)[3][kDC / 16][4],
                                         const uint16_t* base, int nks) {
  // the next k-step's page fragments load while this one's products run
  uint32_t bfr[2][2][4];
  ldsm_x4(bfr[0][0], base);
  ldsm_x4(bfr[0][1], base + 16 * kStride);
#pragma unroll
  for (int ks = 0; ks < kDC / 16; ++ks) {
    if (NKS ? ks < NKS : ks < nks) {
      if (NKS ? ks + 1 < NKS : ks + 1 < nks) {
        ldsm_x4(bfr[(ks + 1) & 1][0], base + 16 * (ks + 1));
        ldsm_x4(bfr[(ks + 1) & 1][1], base + 16 * kStride + 16 * (ks + 1));
      }
      const uint32_t(&bf)[2][4] = bfr[ks & 1];
#pragma unroll
      for (int e = 0; e < 3; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (FIRST && ks == 0)
            mma0(acc[e][j], afr[e][ks], bf[j >> 1][(j & 1) * 2],
                 bf[j >> 1][(j & 1) * 2 + 1]);
          else
            mma(acc[e][j], afr[e][ks], bf[j >> 1][(j & 1) * 2],
                bf[j >> 1][(j & 1) * 2 + 1]);
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rerank_int8_kernel(const float* __restrict__ q, const float* __restrict__ qw,
                   const int8_t* __restrict__ p,
                   const float* __restrict__ scales,
                   const uint8_t* __restrict__ pmask,
                   const int64_t* __restrict__ cand, float* __restrict__ out,
                   int lq, int n_cand, int n_rows, int lp, int d,
                   int n_cblocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem lay;
  uint16_t* sp = reinterpret_cast<uint16_t*>(smem_raw + lay.p);
  float2* stok = reinterpret_cast<float2*>(smem_raw + lay.tok);
  float* spart = reinterpret_cast<float*>(smem_raw + lay.part);
  float* srow = reinterpret_cast<float*>(smem_raw + lay.row);
  float* sqw = reinterpret_cast<float*>(smem_raw + lay.qw);
  float2* spw = reinterpret_cast<float2*>(smem_raw + lay.pw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = warp & 1, sh = warp >> 1;   // row half, token half
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / n_cblocks;
  const int c0 = (blockIdx.x - b * n_cblocks) * kCands;
  const int n_here = min(kCands, n_cand - c0);
  const int n_blocks = (lp + kBlk - 1) / kBlk;
  const int n_dc = (d + kDC - 1) / kDC;
  const int n_items = n_here * n_blocks * n_dc;
  const int64_t* my_cand = cand + (size_t)b * n_cand + c0;

  uint32_t afr[3][kDC / 16][4];   // the query's three f16 terms
  float ps[2] = {1.f, 1.f};       // 2**-s of this thread's two rows
  float acc[3][4][4];
  float mx[2] = {-INFINITY, -INFINITY};
  bool any = false, masked = false;   // the page has a valid / masked token
  uint4 nx[4];
  float nsc = 0.f;       // the next stage's scale, mask byte, and
  uint8_t npm = 0;       // whether the token lies in the page (used only
  bool nlive = false;    // where the stage is stored: no wait on them)

  for (int q0 = 0; q0 < lq; q0 += kRowsQ) {
    const int rq = min(kRowsQ, lq - q0);
    const float* qb = q + ((size_t)b * lq + q0) * d;
    {
      // each row's power of two 2**s: the row's largest |value| times 2**s
      // lies in [128, 256), so its three terms are integers of at most 8
      // bits (4 threads a row; s kept within +-100, where 2**s and 2**-s
      // are normal floats)
      const int r = tid >> 2;
      float m = 0.f;
      if (r < rq) {
        const float* qr = qb + (size_t)r * d;
#pragma unroll 8
        for (int k = tid & 3; k < d; k += 4) m = fmaxf(m, fabsf(qr[k]));
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      int e = 0;
      frexpf(m, &e);
      const int se = m > 0.f ? min(100, max(-100, 8 - e)) : 0;
      if ((tid & 3) == 0) spw[r] = make_float2(ldexpf(1.f, se),
                                                ldexpf(1.f, -se));
      if (tid < kRowsQ)
        sqw[tid] = tid < rq ? qw[(size_t)b * lq + q0 + tid] : 0.f;
    }
    int a_dc = -1;   // the dims afr holds
    // the stage in registers (it + 1: candidate, token block, first dim)
    // and the stage being multiplied (it)
    int s_ci = 0, s_tb = 0, s_dc = 0, k_ci = 0, k_tb = 0, k_dc = 0;

    for (int it = -1; it < n_items; ++it) {
      if (it + 1 < n_items) {
        const int ci = s_ci, tb = s_tb, dc = s_dc;
        const int upr = min(kDC, d - dc) / 16;   // 16-byte units a row
        const long long row = my_cand[ci];
        const bool in_index = row >= 0 && row < n_rows;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = tid + i * kThreads;
          const int tok = upr == kDC / 16 ? u >> 3 : u / upr;
          const int part = u - tok * upr;
          const int t = tb * kBlk + tok;
          const bool live = in_index && tok < kBlk && t < lp;
          nx[i] = live
                      ? __ldg(reinterpret_cast<const uint4*>(
                                  p + ((size_t)row * lp + t) * d + dc) +
                              part)
                      : make_uint4(0u, 0u, 0u, 0u);
        }
        if (dc == 0 && tid < kBlk) {
          // a token's (scale, fill): valid (s, 0), masked or past the
          // page (0, -inf); sim * scale + fill in one FFMA
          const int t = tb * kBlk + tid;
          const size_t at = (size_t)row * lp + t;
          const bool live = in_index && t < lp;
          nsc = live ? __ldg(scales + at) : 0.f;
          npm = live ? __ldg(pmask + at) : (uint8_t)0;
          nlive = live;
        }
      }

      if (it >= 0) {
        const int ci = k_ci, tb = k_tb, dc = k_dc;
        const int nks = min(kDC, d - dc) / 16;
        if (dc != a_dc) {
          // the query's fragments for these dims: each value v of row r
          // is v * 2**s = hi + mid / 256 + lo / 65536 + e with integer
          // terms and |e| <= 2**-17; the terms go in as hi, mid / 256 and
          // lo / 65536, exact in f16, and 2**-s waits for the row's max.
#pragma unroll
          for (int ks = 0; ks < kDC / 16; ++ks)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int rr = 16 * h + g + (r & 1) * 8;
              const int k = dc + 16 * ks + 2 * t4 + (r >> 1) * 8;
              const float up = spw[rr].x;
              float x0 = 0.f, x1 = 0.f;
              if (rr < rq && ks < nks) {
                x0 = qb[(size_t)rr * d + k] * up;
                x1 = qb[(size_t)rr * d + k + 1] * up;
              }
              float unit = 1.f;
#pragma unroll
              for (int e = 0; e < 3; ++e) {
                const uint32_t lo = term(x0, unit), hi = term(x1, unit);
                afr[e][ks][r] = lo | (hi << 16);
                unit *= 1.f / 256.f;
              }
            }
          ps[0] = spw[16 * h + g].y;
          ps[1] = spw[16 * h + g + 8].y;
          a_dc = dc;
        }
        const uint16_t* base = sp + (it & 1) * kBlk * kStride +
                               (32 * sh + 8 * (lane >> 4) + (lane & 7)) *
                                   kStride + ((lane >> 3) & 1) * 8;
        if (nks == kDC / 16 && dc == 0) {
          tile_mma<kDC / 16, true>(acc, afr, base, nks);
        } else if (dc == 0) {
          tile_mma<0, true>(acc, afr, base, nks);
        } else {
          tile_mma<0, false>(acc, afr, base, nks);
        }

        if (dc + kDC >= d) {
          // the token block's end: the terms' sums added (lo + mid + hi),
          // scale and fill, running max per row
          const float2* tk = stok + ((ci * n_blocks + tb) & 1) * kBlk +
                             32 * sh + 2 * t4;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float2 sf = tk[8 * j + c];
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = 2 * r + c;
                const float v = (acc[2][j][i] + acc[1][j][i]) + acc[0][j][i];
                mx[r] = fmaxf(mx[r], fmaf(v, sf.x, sf.y));
              }
            }

          if (tb == n_blocks - 1) {
            // the page's end: each row's maximum over its 4 lanes and the
            // 2 token warps, then one thread sums the rows in order
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float m = mx[r];
              m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
              m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
              if (t4 == 0)
                spart[sh * kRowsQ + 16 * h + 8 * r + g] = m * ps[r];
              mx[r] = -INFINITY;
            }
            const int any_valid = __syncthreads_or(any);
            const int any_masked = __syncthreads_or(masked);
            any = masked = false;
            if (warp == 0) {
              srow[lane] = fmaxf(fmaxf(spart[lane], spart[kRowsQ + lane]),
                                 any_masked ? kNegFill : -INFINITY);
              __syncwarp();
            }
            if (tid == 0) {
              const long long row = my_cand[ci];
              float* o = out + (size_t)b * n_cand + c0 + ci;
              float sum = 0.f;
              for (int r = 0; r < rq; ++r) sum += srow[r] * sqw[r];
              if (row < 0 || row >= n_rows)
                *o = __int_as_float(0x7fc00000);
              else if (!any_valid)
                *o = -INFINITY;
              else
                *o = q0 == 0 ? sum : *o + sum;
            }
          }
        }
      }

      if (it + 1 < n_items) {
        // stage it + 1 -> the other buffer (after the page end above, so
        // `any` starts the next candidate's)
        const int ci = s_ci, tb = s_tb, dc = s_dc;
        const int upr = min(kDC, d - dc) / 16;
        uint16_t* dst = sp + ((it + 1) & 1) * kBlk * kStride;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = tid + i * kThreads;
          const int tok = upr == kDC / 16 ? u >> 3 : u / upr;
          const int part = u - tok * upr;
          if (tok < kBlk) {
            const uint2 a = codes_f16(nx[i].x), c = codes_f16(nx[i].y),
                        e = codes_f16(nx[i].z), f = codes_f16(nx[i].w);
            uint4* o = reinterpret_cast<uint4*>(dst + tok * kStride +
                                                part * 16);
            o[0] = make_uint4(a.x, a.y, c.x, c.y);
            o[1] = make_uint4(e.x, e.y, f.x, f.y);
          }
        }
        if (dc == 0 && tid < kBlk) {
          const bool ok = npm != 0;
          stok[((ci * n_blocks + tb) & 1) * kBlk + tid] =
              make_float2(ok ? nsc : 0.f, ok ? 0.f : -INFINITY);
          any |= ok;
          masked |= nlive && !ok;
        }
      }
      __syncthreads();
      k_ci = s_ci;
      k_tb = s_tb;
      k_dc = s_dc;
      if ((s_dc += kDC) >= d) {
        s_dc = 0;
        if (++s_tb == n_blocks) {
          s_tb = 0;
          ++s_ci;
        }
      }
    }
  }
}

}  // namespace evdr_rerank

extern "C" int evdr_rerank_int8(const void* q, const void* qw, const void* p,
                                const void* scales, const void* pmask,
                                const void* cand, void* out, int nq, int lq,
                                int n_cand, int n_rows, int lp, int d,
                                void* stream) {
  using namespace evdr_rerank;
  if (nq < 1 || lq < 1 || n_cand < 1 || n_rows < 1 || lp < 1 || d < 16 ||
      d % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Smem lay;
  const int n_cblocks = (n_cand + kCands - 1) / kCands;
  if ((long long)nq * n_cblocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      rerank_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  rerank_int8_kernel<<<nq * n_cblocks, kThreads, lay.total,
                       (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(qw),
      static_cast<const int8_t*>(p), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(pmask), static_cast<const int64_t*>(cand),
      static_cast<float*>(out), lq, n_cand, n_rows, lp, d, n_cblocks);
  return (int)cudaGetLastError();
}
