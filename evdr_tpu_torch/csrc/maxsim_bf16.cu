// K1: fused masked MaxSim over a bf16 page index, for Hopper (sm_90a), on
// wgmma and TMA; and K5 in bf16, the same kernel with an M store.
//
// Replaces: evdr_tpu/ops/pallas_maxsim.py:_kernel (driver
// _maxsim_pallas_fwd, public entry maxsim_pallas); with STORE_M,
// evdr_tpu/ops/pallas_maxsim_bwd.py:_fwd_train_kernel (entry
// maxsim_pallas_fwd_train), the differentiable op's forward.
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
// K5 (STORE_M, evdr_maxsim_fwd_train): the same loop and epilogue, so its
// scores are K1's bit for bit, plus each query-token row's max over each
// doc (the quad's shuffled max, before the no-valid-token rule) into
// M[(q, t), d], (nq * lq, nd) f32, the residual K6 (maxsim_train.cu)
// compares its recomputed similarities against. M is docs-contiguous, so
// a CTA buffers its rows' maxima for its kBfDocs docs in shared memory and
// writes one run of up to 8 floats a row (2-6% faster at the train step
// than one 4-byte store a row and doc). K5 runs 64-token tiles
// at every D (kTrainTileN): each doc starts a tile of its own, so the
// student's pages (Lp 137-154 at mf5, shorter beyond) fill 192 columns
// where 128-token tiles fill 256, and K6 recomputes each 128 x 64 tile with
// the same m64n64k16 products in the same k order (sim == M exactly).
// 128-token tiles ran 20% slower at Lp 154 (PERF.md section 6).
//
// C interface (loaded with ctypes; every pointer and the stream is a
// void*): q (nq, lq, d) bf16, qw (nq, lq) f32 query-token weights (the
// mask as 0/1), p (nd, lp, d) bf16, pmask (nd, lp) bool as bytes,
// out (nq, nd) f32; q and p 16-byte aligned; evdr_maxsim_fwd_train adds
// m (nq * lq, nd) f32 after out. Returns cudaGetLastError() after the
// launch, or minus the CUresult of a refused tensor-map encode.
// evdr_bf16_config reports the configuration a call at width d runs (K1,
// or K5 where `train`).
#include "hopper.cuh"
#include "maxsim_wide.cuh"

namespace evdr {
namespace {

constexpr int kBfConsumers = 2;              // consumer warpgroups
constexpr int kBfRows = 128 * kBfConsumers;  // query-token rows a CTA
constexpr int kBfThreads = 128 * (kBfConsumers + 1);
constexpr int kBfDocs = 8;      // docs per CTA
constexpr int kTileN = 128;     // page tokens a tile, where two stages fit
constexpr int kMaxStages = 4;
// The k-loop is unrolled at compile time for this many k-steps (D = 128,
// the serving width: 4.6% faster on the card of the header's measurements,
// PERF.md section 6), beside the loop over any D.
constexpr int kUnrolledKSteps = 8;
constexpr int kSmemCap = 232448;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// K5 (STORE_M): page tokens a tile at every D, which K6's recompute
// (maxsim_train.cu) issues the same wgmma shape for.
constexpr int kTrainTileN = 64;

// Shared-memory carve-up, in bytes from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes): the query block, one
// 128-byte column chunk after another ([chunk][kBfRows][64]); the stages,
// each [chunk][n][64]; each stage's n column scales; two row buffers; K5's
// M runs where `mruns` ([2][kBfDocs][kBfRows], by the parity of the run);
// the barriers. `total` adds the slack that aligns the base.
struct BfLayout {
  int n, stages, chunks;
  uint32_t b, stage_bytes, colscale, red, mrun, bars, total;
};

__host__ __device__ inline BfLayout bf16_layout(int d, int n, int stages,
                                                bool mruns = false) {
  BfLayout L;
  L.n = n;
  L.stages = stages;
  L.chunks = (d + kBoxK - 1) / kBoxK;
  L.b = (uint32_t)L.chunks * kBfRows * 128;
  L.stage_bytes = (uint32_t)L.chunks * n * 128;
  L.colscale = L.b + stages * L.stage_bytes;
  L.red = L.colscale + stages * n * 4;
  L.mrun = L.red + 2 * kBfRows * 4;
  L.bars = L.mrun + (mruns ? 2 * kBfDocs * kBfRows * 4 : 0);
  L.total = L.bars + (2 * stages + 1) * 8 + 1024;
  return L;
}

// ------------------------------------------------------------- kernel

// STORE_M: K5, which also writes each query-token row's max over each doc
// (before the no-valid-token rule) to m_out[(q, t), d], (nq * lq, nd) f32,
// the residual K6 compares its recomputed similarities against. A template
// flag, and m_out the last parameter, so the serving kernels compile as
// they did without it.
template <int N, int KSTEPS, bool STORE_M = false>
__global__ void __launch_bounds__(kBfThreads, 1)
maxsim_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_p,
                   const float* __restrict__ qw,
                   const uint8_t* __restrict__ pmask, float* __restrict__ out,
                   int nq, int lq, int nd, int lp, int d, int qb, int db,
                   int stages, float* __restrict__ m_out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const BfLayout L = bf16_layout(d, N, stages, STORE_M);
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
  const int n_docs = min(nd, d_begin + db) - d_begin;
  const int total = n_docs * n_tiles;

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
        // K5's run of up to kBfDocs docs: its buffer, its first doc, its
        // length (the parity of the run picks the buffer)
        float* mr = reinterpret_cast<float*>(smem + L.mrun) +
                    ((doc / kBfDocs) & 1) * kBfDocs * kBfRows;
        const int run0 = doc - doc % kBfDocs;
        const int run_n = min(kBfDocs, n_docs - run0);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float m = mx[i][h];
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            const int r = wg * 128 + i * 64 + w * 16 + h * 8 + g;
            if (t == 0) {
              rr[r] = (m > kNegThresh ? m : 0.f) * qwr[i][h];
              if constexpr (STORE_M) mr[(doc - run0) * kBfRows + r] = m;
            }
            mx[i][h] = kNegInit;
          }
        asm volatile("bar.sync 1, %0;\n" ::"n"(kBfRows) : "memory");
        if (tid < nq_here) {
          float sum = 0.f;
          for (int r = 0; r < lq; ++r) sum += rr[tid * lq + r];
          out[(size_t)(q0 + tid) * nd + d_begin + doc] = sum;
        }
        if constexpr (STORE_M) {
          // the run's last doc: each row's maxima, docs contiguous in M; a
          // warp writes 32 consecutive (row, doc) pairs. The buffer is next
          // written two runs on, past a barrier every thread reaches after
          // this loop.
          if (doc - run0 == run_n - 1)
            for (int x = tid; x < nrows * run_n; x += kBfRows) {
              const int r = x / run_n, k = x - r * run_n;
              m_out[(size_t)(row0 + r) * nd + d_begin + run0 + k] =
                  mr[k * kBfRows + r];
            }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host

using BfKernel = void (*)(const CUtensorMap, const CUtensorMap, const float*,
                          const uint8_t*, float*, int, int, int, int, int,
                          int, int, int, float*);

// The kernel of tile width N (K1: kTileN or 64; K5: kTrainTileN) at width
// d: the loop unrolled at d = 16 * kUnrolledKSteps, else the loop over any D.
template <int N, bool STORE_M> BfKernel bf16_kernel(int d) {
  if constexpr (kUnrolledKSteps > 0 && (STORE_M || N == kTileN))
    if (d == 16 * kUnrolledKSteps)
      return maxsim_bf16_kernel<N, kUnrolledKSteps, STORE_M>;
  return maxsim_bf16_kernel<N, 0, STORE_M>;
}

// The configuration a call at width d runs: the rule by D (see the
// header; K5, `train`: kTrainTileN tokens a tile at every D), the kernel it
// selects, and that kernel's shared-memory size.
int bf16_plan(int d, bool train, BfLayout* L, BfKernel* kern) {
  int n = train ? kTrainTileN : kTileN;
  if (!train && bf16_layout(d, n, 2).total > kSmemCap) n = 64;
  int s = kMaxStages;
  while (s > 2 && bf16_layout(d, n, s, train).total > kSmemCap) --s;
  *L = bf16_layout(d, n, s, train);
  if (L->total > kSmemCap) return (int)cudaErrorInvalidValue;
  if (train)
    *kern = bf16_kernel<kTrainTileN, true>(d);
  else
    *kern = n == kTileN ? bf16_kernel<kTileN, false>(d)
                        : bf16_kernel<64, false>(d);
  return (int)cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L->total);
}

// One launch of K1 (m == nullptr) or K5 (m: its M).
int bf16_launch(const void* q, const void* qw, const void* p,
                const void* pmask, void* out, void* m, int nq, int lq, int nd,
                int lp, int d, void* stream) {
  if (nq < 1 || nd < 1 || lp < 1 || lq < 1 || lq > kBfRows || d < 16 ||
      d % 16 != 0 || (long long)nd * lp >= (1LL << 31) ||
      (long long)nq * lq >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  BfLayout L;
  BfKernel kern;
  int e = bf16_plan(d, m != nullptr, &L, &kern);
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
      nd, lp, d, qb, db, L.stages, static_cast<float*>(m));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace evdr

extern "C" int evdr_maxsim_bf16(const void* q, const void* qw, const void* p,
                                const void* pmask, void* out, int nq, int lq,
                                int nd, int lp, int d, void* stream) {
  return evdr::bf16_launch(q, qw, p, pmask, out, nullptr, nq, lq, nd, lp, d,
                           stream);
}

// K5: K1's scores in out and each row's max in m (nq * lq, nd) f32.
extern "C" int evdr_maxsim_fwd_train(const void* q, const void* qw,
                                     const void* p, const void* pmask,
                                     void* out, void* m, int nq, int lq,
                                     int nd, int lp, int d, void* stream) {
  if (m == nullptr) return (int)cudaErrorInvalidValue;
  return evdr::bf16_launch(q, qw, p, pmask, out, m, nq, lq, nd, lp, d,
                           stream);
}

// The configuration a call at width d runs (K1, or K5 where `train`), on
// the current GPU: out[0] CTAs per SM, out[1] query-token rows a CTA,
// out[2] page tokens a tile, out[3] stages, out[4] consumer warpgroups,
// out[5] shared-memory bytes.
extern "C" int evdr_bf16_config(int d, int train, void* out) {
  using namespace evdr;
  int* o = static_cast<int*>(out);
  BfLayout L;
  BfKernel kern;
  const int e = bf16_plan(d, train != 0, &L, &kern);
  if (e != 0) return e;
  o[1] = kBfRows;
  o[2] = L.n;
  o[3] = L.stages;
  o[4] = kBfConsumers;
  o[5] = (int)L.total;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[0], kern, kBfThreads, L.total);
}

// The wide K1 and K5 (D above 256, where the operand tiles leave shared
// memory): maxsim_wide.cuh's D-chunked loop on mma.sync (m16n8k16 bf16,
// f32 sums), so the wide K5's scores are the wide K1's bit for bit and the
// wide K6 (maxsim_train.cu) recomputes its similarities exactly. C
// interfaces as evdr_maxsim_bf16 / evdr_maxsim_fwd_train.
extern "C" int evdr_maxsim_bf16_wide(const void* q, const void* qw,
                                     const void* p, const void* pmask,
                                     void* out, int nq, int lq, int nd,
                                     int lp, int d, void* stream) {
  return evdr::launch_wide<evdr::kBf16, false, false, evdr::kNoBooks>(
      q, qw, p, nullptr, pmask, out, nullptr, nullptr, nq, lq, nd, lp, d, 0,
      stream);
}

extern "C" int evdr_maxsim_fwd_train_wide(const void* q, const void* qw,
                                          const void* p, const void* pmask,
                                          void* out, void* m, int nq, int lq,
                                          int nd, int lp, int d,
                                          void* stream) {
  return evdr::launch_wide<evdr::kBf16, false, true, evdr::kNoBooks>(
      q, qw, p, nullptr, pmask, out, m, nullptr, nq, lq, nd, lp, d, 0,
      stream);
}
