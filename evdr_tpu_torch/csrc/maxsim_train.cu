// K5 and K6: the differentiable MaxSim op's forward-for-training and
// backward, for Hopper (sm_90a), in bf16 and in float32.
//
// K5 replaces evdr_tpu/ops/pallas_maxsim_bwd.py:_fwd_train_kernel (entry
// maxsim_pallas_fwd_train, reached from pallas_maxsim.py:_fwd). It is K1's
// tile loop (maxsim_tile.cuh; bf16, or K1's float32 mode for
// compute_dtype=float32) plus one store: at each doc's end, each
// query-token row's max over the doc's tokens (before the no-valid-token
// rule) goes to M[(q, t), d], an (nq * lq, nd) f32 array, the backward's
// residual. Bound like K1, by operations; M adds nq * lq * nd * 4 bytes.
//
// K6 replaces pallas_maxsim_bwd.py:_dqdp_kernel + _indicator (entries
// maxsim_pallas_bwd / _maxsim_pallas_bwd_impl, reached from
// pallas_maxsim.py:_bwd). With W[(q, t), d] = g[q, d] * qmask[q, t] *
// doc_has_token[d]:
//   E  = (sim == M) * W in the compute dtype (the TPU casts E to it: bf16
//        rounds W, float32 keeps it); the gradient is summed over tied
//        argmax tokens;
//   dQ[(q, t)] = sum_{d, m} E * P[d, m]      dP[d, m] = sum_{q, t} E * Q[q, t]
// Design:
// - sim is recomputed by tile_mma, a copy of K5's k-loop: the same operand
//   roles (query rows as A, doc tokens as B), MMA shape (m16n8k16 bf16, or
//   three m16n8k8 tf32 products per k-step for float32) and order of k-steps
//   over D, so every recomputed similarity is bit-identical to the one K5
//   took the max of and (sim == M) holds exactly where it did.
// - One CTA owns 128 whole-query rows (blockIdx.x) and a slice of db docs
//   (blockIdx.y), and walks the slice's page tiles (cp.async, two buffers).
//   Per tile, E goes to shared memory and feeds both gradient products on
//   the tensor cores: dQ += E . P_tile (A = E) into registers held across
//   the slice, and dP_tile = E^T . Q_block.
// - bf16: the transposed operands (the page tile as B of dQ; E and the
//   query block for dP) load through ldmatrix.trans.
// - float32 (the TPU's Precision.HIGHEST): both products in 3xTF32, each
//   operand split into TF32 hi + lo as K1's float32 mode does (mma() in
//   maxsim_tile.cuh), so they match a float32 product to ~2^-22. ldmatrix
//   has no 32-bit .trans form, so the transposed operands load with 32-bit
//   shared loads in the m16n8k8 fragment layout. A product's k order is
//   free, so each fragment's k slots t and t + 4 take the even and the odd
//   of two neighbouring rows (tokens for dQ, query rows for dP): with row
//   strides of 4 mod 32 words (odd 16-byte units, which ldmatrix needs too)
//   those loads hit 32 distinct banks. E is stored with each 8-token group
//   in the order 0 2 4 6 1 3 5 7 (the recompute's fragment holds tokens 2t
//   and 2t + 1), which is the order dQ's A fragment reads by ldmatrix.
// - Accumulation across CTAs is deterministic, without atomics: each CTA
//   writes its dQ as a partial for its doc slice, (n_slices, nq * lq, D),
//   and each page tile's dP as a partial for its query block,
//   (n_qblocks, nd, lp, D); the wrapper sums the partials, as the TPU sums
//   its per-query-block dP partials outside the kernel
//   (pallas_maxsim_bwd.py:172-180). Every partial element is written once.
// What bounds it on the H100: operations, three products of the forward's
// size (recompute, dQ, dP) at the bf16 tensor-core rate (float32: the TF32
// rate, three MMAs per product), plus the partials' bytes (written once,
// read once by the sum). Shared memory at D = 128: 55 KB in bf16, 168 KB
// in float32 (one CTA per SM).
// K6 takes D a multiple of 32 up to 128 (a warp holds a 32 x D/2 dQ block
// in registers).
//
// C interfaces (ctypes; every pointer and the stream is a void*):
// evdr_maxsim_fwd_train[_f32](q (nq, lq, d) bf16 [f32], qw f32 (nq, lq),
//   p (nd, lp, d) bf16 [f32], pmask bool (nd, lp), out f32 (nq, nd),
//   m f32 (nq*lq, nd), nq, lq, nd, lp, d, stream);
// evdr_maxsim_bwd[_f32](q, qw, p, pmask, m, g f32 (nq, nd) already
//   multiplied by doc_has_token, dq_part f32 (ceil(nd / db), nq*lq, d),
//   dp_part f32 (n_qblocks, nd, lp, d) with n_qblocks = ceil(nq / (128 /
//   lq)), nq, lq, nd, lp, d, db, stream).
// Each returns cudaGetLastError() after its launch.
#include "maxsim_tile.cuh"

namespace evdr {

__device__ inline void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

constexpr int kMaxD = 128;
// bytes per row of the E tile (kRows rows of kCols values): an odd number
// of 16-byte units
template <int MODE> constexpr int kEStride =
    MODE == kF32 ? (kCols / 4 + 1) * 16 : (kCols / 8 + 1) * 16;

template <int MODE> struct BwdSmem {
  size_t a, b, e, colscale, mrow, wrow, total;
  __host__ __device__ explicit BwdSmem(int d) {
    const size_t row = (size_t)(mma_units<MODE>(d) + 1) * 16;
    a = 0;
    b = align128(a + row * kRows);
    e = align128(b + row * kCols * 2);
    colscale = align128(e + (size_t)kEStride<MODE> * kRows);
    mrow = align128(colscale + sizeof(float) * kCols * 2);
    wrow = align128(mrow + sizeof(float) * kRows);
    total = align128(wrow + sizeof(float) * kRows);
  }
};

// float32 E tile: the position of token c (0 .. kCols) in its row; each
// 8-token group is stored as 0 2 4 6 1 3 5 7
__device__ inline int e_pos_f32(int c) {
  return (c & ~7) + ((c & 1) << 2) + ((c & 7) >> 1);
}
// ... and the token at position p
__device__ inline int e_tok_f32(int p) {
  return (p & ~7) + (((p & 7) < 4) ? 2 * (p & 7) : 2 * (p & 7) - 7);
}

// K6 float32: dQ (rows wm*32 .. +32, columns dcol0 .. + D/2) += E (128 x
// kCols) . P tile (kCols x D), 3xTF32. Es is the E tile, Bf the page tile
// (row stride sb words).
__device__ inline void dq_tile_f32(float (&dq)[2][kMaxD / 16][4],
                                   const unsigned char* Es, const float* Bf,
                                   int sb, int nt, int dcol0, int lane,
                                   int wm) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kCols / 8; ++kk) {
    // A: positions kk*8 + t and kk*8 + 4 + t hold tokens kk*8 + 2t and
    // kk*8 + 2t + 1, the tokens B's k slots t and t + 4 read below
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm_x4(a[i], Es + (wm * 32 + i * 16 + lane % 16) * kEStride<kF32> +
                        (kk * 2 + lane / 16) * 16);
    const float* prow = Bf + (size_t)(kk * 8 + 2 * t) * sb + dcol0 + g;
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) {
      if (j < nt) {
        const uint32_t b0 = __float_as_uint(prow[j * 8]);
        const uint32_t b1 = __float_as_uint(prow[sb + j * 8]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma(dq[i][j], a[i], b0, b1, float());
      }
    }
  }
}

// K6 float32: dP (E positions wm*16 .. +16, columns dcol0 .. + D/2) =
// E^T (kCols x 128) . Q block (128 x D), 3xTF32; k slots t and t + 4 take
// query rows 2t and 2t + 1 of each group of 8. Output row h*8 + g is E
// position wm*16 + h*8 + g (see e_tok_f32).
__device__ inline void dp_tile_f32(float (&dp)[kMaxD / 16][4],
                                   const float* Ef, int se, const float* Af,
                                   int sa, int nt, int dcol0, int lane,
                                   int wm) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kMaxD / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll 4
  for (int kq = 0; kq < kRows / 8; ++kq) {
    const float* er = Ef + (size_t)(kq * 8 + 2 * t) * se + wm * 16 + g;
    const uint32_t a[4] = {__float_as_uint(er[0]), __float_as_uint(er[8]),
                           __float_as_uint(er[se]),
                           __float_as_uint(er[se + 8])};
    const float* qr = Af + (size_t)(kq * 8 + 2 * t) * sa + dcol0 + g;
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) {
      if (j < nt)
        mma(dp[j], a, __float_as_uint(qr[j * 8]),
            __float_as_uint(qr[sa + j * 8]), float());
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
maxsim_bwd_kernel(const typename Traits<MODE>::TQ* __restrict__ q,
                  const float* __restrict__ qw,
                  const typename Traits<MODE>::TQ* __restrict__ p,
                  const uint8_t* __restrict__ pmask,
                  const float* __restrict__ m, const float* __restrict__ g,
                  float* __restrict__ dq_part, float* __restrict__ dp_part,
                  int nq, int lq, int nd, int lp, int d, int qb, int db) {
  constexpr bool kFp32 = MODE == kF32;
  constexpr int ES = kEStride<MODE>;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<MODE> lay(d);
  const int units = mma_units<MODE>(d);
  const size_t stride = (size_t)(units + 1) * 16;
  unsigned char* As = smem + lay.a;
  unsigned char* Bs = smem + lay.b;
  unsigned char* Es = smem + lay.e;
  float* colscale = reinterpret_cast<float*>(smem + lay.colscale);
  float* mrow = reinterpret_cast<float*>(smem + lay.mrow);
  float* wrow = reinterpret_cast<float*>(smem + lay.wrow);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % 4;
  const int wn = warp / 4;
  const int gq = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * qb;
  const int nq_here = min(qb, nq - q0);
  const int nrows = nq_here * lq;
  const size_t row0 = (size_t)q0 * lq;
  const int nt = d / 16;         // n-tiles of 8 columns in a warp's D / 2
  const int dunit0 = wn * d / 16;  // bf16: first 16-byte unit of the half
  const int dcol0 = wn * d / 2;    // float32: first column of the half

  stage_sync(As, reinterpret_cast<const unsigned char*>(q + row0 * d), kRows,
             nrows, units, units, tid);

  const int d_begin = blockIdx.y * db;
  const int n_tiles = (lp + kCols - 1) / kCols;
  const int total = (min(nd, d_begin + db) - d_begin) * n_tiles;

  auto issue = [&](int it, int buf) {
    const int dd = d_begin + it / n_tiles;
    const int l0 = (it % n_tiles) * kCols;
    const int ntok = min(kCols, lp - l0);
    const size_t tok0 = (size_t)dd * lp + l0;
    stage_async(Bs + buf * stride * kCols,
                reinterpret_cast<const unsigned char*>(p + tok0 * d), ntok,
                units, units, tid);
    if (tid < kCols)
      colscale[buf * kCols + tid] =
          (tid < ntok && pmask[tok0 + tid]) ? 1.f : -1.f;
  };

  float dq[2][kMaxD / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][j][e] = 0.f;

  if (total > 0) issue(0, 0);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) issue(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();
    const int dd = d_begin + it / n_tiles;
    const int l0 = (it % n_tiles) * kCols;
    if (it % n_tiles == 0 && tid < kRows) {
      // this doc's per-row max and weight W = qmask * g * doc_has_token
      const bool ok = tid < nrows;
      mrow[tid] = ok ? m[(row0 + tid) * nd + dd] : 0.f;
      wrow[tid] = ok ? qw[row0 + tid] * g[(size_t)(q0 + tid / lq) * nd + dd]
                     : 0.f;
    }
    __syncthreads();
    const unsigned char* B = Bs + buf * stride * kCols;

    // recompute the similarity tile exactly as K5 did; E = (sim == M) * W
    {
      float acc[2][4][4];
      tile_mma<MODE>(acc, As, B, units, stride, lane, wm, wn);
      const float* cs = colscale + buf * kCols + wn * 32 + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c0 = cs[j * 8], c1 = cs[j * 8 + 1];
        const int col = wn * 32 + j * 8 + 2 * t;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + i * 16 + h * 8 + gq;
            const float mr = mrow[r], wr = wrow[r];
            const float e0 = masked(acc[i][j][2 * h], c0) == mr ? wr : 0.f;
            const float e1 = masked(acc[i][j][2 * h + 1], c1) == mr ? wr : 0.f;
            if constexpr (kFp32) {
              float* er = reinterpret_cast<float*>(Es + r * ES);
              er[e_pos_f32(col)] = e0;
              er[e_pos_f32(col + 1)] = e1;
            } else {
              *reinterpret_cast<__nv_bfloat162*>(Es + r * ES + col * 2) =
                  __floats2bfloat162_rn(e0, e1);
            }
          }
      }
    }
    __syncthreads();

    // dQ (rows wm*32.., columns of half wn) += E (128 x 64) . P tile (64 x D)
    if constexpr (kFp32) {
      dq_tile_f32(dq, Es, reinterpret_cast<const float*>(B), (int)stride / 4,
                  nt, dcol0, lane, wm);
    } else {
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(a[i], Es + (wm * 32 + i * 16 + lane % 16) * ES +
                            (kk * 2 + lane / 16) * 16);
#pragma unroll
        for (int jj = 0; jj < kMaxD / 32; ++jj) {
          if (2 * jj < nt) {
            uint32_t b[4];
            ldsm_x4_t(b, B + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                 stride +
                             (dunit0 + jj * 2 + lane / 16) * 16);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma(dq[i][2 * jj], a[i], b[0], b[1], __nv_bfloat16());
              mma(dq[i][2 * jj + 1], a[i], b[2], b[3], __nv_bfloat16());
            }
          }
        }
      }
    }

    // dP tile (tokens wm*16.., columns of half wn) = E^T (64 x 128) . Q (128 x D)
    {
      float dp[kMaxD / 16][4];
      if constexpr (kFp32) {
        dp_tile_f32(dp, reinterpret_cast<const float*>(Es), ES / 4,
                    reinterpret_cast<const float*>(As), (int)stride / 4, nt,
                    dcol0, lane, wm);
      } else {
#pragma unroll
        for (int j = 0; j < kMaxD / 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
        for (int kq = 0; kq < kRows / 16; ++kq) {
          uint32_t a[4];
          ldsm_x4_t(a, Es + (kq * 16 + lane % 8 + (lane / 16) * 8) * ES +
                           (wm * 2 + (lane / 8) % 2) * 16);
#pragma unroll
          for (int jj = 0; jj < kMaxD / 32; ++jj) {
            if (2 * jj < nt) {
              uint32_t b[4];
              ldsm_x4_t(b, As + (kq * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                    stride +
                               (dunit0 + jj * 2 + lane / 16) * 16);
              mma(dp[2 * jj], a, b[0], b[1], __nv_bfloat16());
              mma(dp[2 * jj + 1], a, b[2], b[3], __nv_bfloat16());
            }
          }
        }
      }
      const int ntok = min(kCols, lp - l0);
      float* dst = dp_part + ((size_t)blockIdx.x * nd + dd) * lp * d;
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j) {
        const int col = wn * (d / 2) + j * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = wm * 16 + h * 8 + gq;
          const int c = kFp32 ? e_tok_f32(pos) : pos;
          if (j < nt && c < ntok)
            *reinterpret_cast<float2*>(dst + (size_t)(l0 + c) * d + col) =
                make_float2(dp[j][2 * h], dp[j][2 * h + 1]);
        }
      }
    }
    __syncthreads();  // E and buffer `buf` are free
  }

  // this doc slice's dQ partial
  float* dst = dq_part + ((size_t)blockIdx.y * nq * lq + row0) * d;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) {
      const int col = wn * (d / 2) + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + h * 8 + gq;
        if (j < nt && r < nrows)
          *reinterpret_cast<float2*>(dst + (size_t)r * d + col) =
              make_float2(dq[i][j][2 * h], dq[i][j][2 * h + 1]);
      }
    }
}

template <int MODE>
int launch_bwd(const void* q, const void* qw, const void* p,
               const void* pmask, const void* m, const void* g,
               void* dq_part, void* dp_part, int nq, int lq, int nd, int lp,
               int d, int db, void* stream) {
  if (nq < 1 || nd < 1 || lp < 1 || lq < 1 || lq > kRows || d < 32 ||
      d > kMaxD || d % 32 != 0 || db < 1 || (nd + db - 1) / db > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  const BwdSmem<MODE> lay(d);
  auto* kern = maxsim_bwd_kernel<MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  using T = typename Traits<MODE>::TQ;
  const int qb = kRows / lq;
  dim3 grid((nq + qb - 1) / qb, (nd + db - 1) / db);
  kern<<<grid, kThreads, lay.total, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(qw),
      static_cast<const T*>(p), static_cast<const uint8_t*>(pmask),
      static_cast<const float*>(m), static_cast<const float*>(g),
      static_cast<float*>(dq_part), static_cast<float*>(dp_part), nq, lq, nd,
      lp, d, qb, db);
  return (int)cudaGetLastError();
}

}  // namespace evdr

extern "C" int evdr_maxsim_fwd_train(const void* q, const void* qw,
                                     const void* p, const void* pmask,
                                     void* out, void* m, int nq, int lq,
                                     int nd, int lp, int d, void* stream) {
  return evdr::launch<evdr::kBf16, true>(q, qw, p, nullptr, pmask, out, m,
                                         nq, lq, nd, lp, d, stream);
}

extern "C" int evdr_maxsim_fwd_train_f32(const void* q, const void* qw,
                                         const void* p, const void* pmask,
                                         void* out, void* m, int nq, int lq,
                                         int nd, int lp, int d, void* stream) {
  return evdr::launch<evdr::kF32, true>(q, qw, p, nullptr, pmask, out, m,
                                        nq, lq, nd, lp, d, stream);
}

extern "C" int evdr_maxsim_bwd(const void* q, const void* qw, const void* p,
                               const void* pmask, const void* m,
                               const void* g, void* dq_part, void* dp_part,
                               int nq, int lq, int nd, int lp, int d, int db,
                               void* stream) {
  return evdr::launch_bwd<evdr::kBf16>(q, qw, p, pmask, m, g, dq_part,
                                       dp_part, nq, lq, nd, lp, d, db, stream);
}

extern "C" int evdr_maxsim_bwd_f32(const void* q, const void* qw,
                                   const void* p, const void* pmask,
                                   const void* m, const void* g,
                                   void* dq_part, void* dp_part, int nq,
                                   int lq, int nd, int lp, int d, int db,
                                   void* stream) {
  return evdr::launch_bwd<evdr::kF32>(q, qw, p, pmask, m, g, dq_part,
                                      dp_part, nq, lq, nd, lp, d, db, stream);
}
