// K6: the differentiable MaxSim op's backward, for Hopper (sm_90a), in
// bf16 and in float32. Its forward, K5 (K1's kernels with an M store:
// evdr_maxsim_fwd_train in maxsim_bf16.cu, evdr_maxsim_fwd_train_f32 in
// maxsim_f32.cu), leaves M[(q, t), d], each query-token row's max over
// each doc's tokens, the residual K6 compares against.
//
// K6 replaces pallas_maxsim_bwd.py:_dqdp_kernel + _indicator (entries
// maxsim_pallas_bwd / _maxsim_pallas_bwd_impl, reached from
// pallas_maxsim.py:_bwd). With W[(q, t), d] = g[q, d] * qmask[q, t] *
// doc_has_token[d], a hit is a (row, doc token) where the recomputed
// similarity equals M and W != 0; with e = W rounded to the compute dtype
// (bf16 mode rounds it, as the TPU casts E; float32 keeps it),
//   dQ[(q, t)] = sum over its hits of e * P[d, m]
//   dP[d, m]   = sum over its hits of e * Q[q, t]
// summed over tied tokens, as on the TPU (pallas_maxsim_bwd.py:18-20).
// What bounds it on the H100: the recompute, one product of the forward's
// size (bf16 tensor rate; float32: TF32, three MMAs a k-step); the
// gradient is ~one page row and one query row a (row, doc).
// Design:
// - sim is recomputed with K5's products, so every recomputed similarity
//   is bit-identical to the one K5 took the max of and (sim == M) holds
//   exactly where it did. bf16 (wg_hits): K5's wgmma m64n64k16 over its
//   64-token tiles, each warpgroup 64 of the tile's 128 rows, the query
//   block and page tiles in K5's 128B-swizzled layout, D / 16 k-steps in
//   order. float32: tile_mma<kF32>, whose three TF32 products a k-step are
//   K5 float32's (maxsim_f32.cu) element for element.
// - Sparse gradients. E is one-hot but for ties (one nonzero a row and
//   doc: 1 in 154 at the train step's shape), so each 128 x 64 tile's hits
//   become bit masks in shared memory instead of two dense products on a
//   0/1 tile: a row's 64 bits as two words and a token's 128 bits as four
//   (bf16: eight halfwords, one per warp of 16 rows; float32: one word per
//   column warp and per row warp), whole words, no atomics.
//   dQ: thread (row r, half of D) adds e * P_tile[c, its half] for each of
//   r's hits, in ascending c, into registers kept across the doc slice
//   (D / 2 floats a thread). dP: below. Products of the stored operands
//   (bf16 values multiplied in f32, or f32 FMAs), summed in f32. A zero
//   query row with qmask 1 ties with every valid token: right, and slower.
// - A chunk's query blocks (at most 8, the wrapper's chunk) form one
//   thread-block cluster along x (padding CTAs, without rows, up to a power
//   of two), walking the same doc slice (y) in step. Each page tile
//   reaches the cluster once: each CTA brings 1/C of its rows multicast to
//   every CTA's ring stage (bf16: TMA boxes of the 128B-swizzled layout,
//   kCols / C rows, at offsets that are multiples of 1024 bytes; float32:
//   row-by-row bulk copies; .multicast::cluster, completing on each CTA's
//   full mbarrier).
// - kStep = 4 page tiles a cluster barrier (fewer where the ring holds
//   fewer: float32 above D = 128): the tiles' recomputes and dQ walks, then
//   one arrive/wait, then the pull of the tiles' dP. The barrier also
//   frees their ring stages everywhere, which are refilled at once (a ring
//   of as many stages as fit, up to 8), and the other half of the masks'
//   double buffer.
// - dP is summed across the cluster through distributed shared memory:
//   CTA k owns tokens [k 64/C, (k + 1) 64/C) of each tile, a warp one
//   token a tile where C = 8 (its "items"). Lane (item, j) loads CTA j's
//   mask of the item; for each pair of items a warp scan of the lanes' hit
//   counts lists the hits in (item, CTA, row) order in shared memory, and
//   each hit's e and query row are loaded from CTA j and summed in that
//   order (more hits than the list holds, from ties, go in the same order
//   one at a time); each token's dP is written once. No per-query-block
//   partials, no float atomics: two calls give the same bits.
// - The next tile's M, W and column scales load during this tile's
//   recompute; the tiles are walked by cursors, without divisions.
// - The dQ accumulators of a doc slice are written once as its partial,
//   (n_slices, nq * lq, D), summed by the wrapper, which sizes the slices
//   so the clusters fill the card in one wave (evdr_bwd_config:
//   cudaOccupancyMaxActiveClusters).
// The measured choices (two tiles or one a barrier, hits loaded 4 or 16 at
// a time, rings of 4 stages, no cluster, and earlier designs) are in
// PERF.md. Shared memory: bf16 D = 128 181,888 bytes (8 stages), D = 256
// 214,656 (4); float32 D = 128 219,776 (4), D = 192 217,728 (2): one CTA
// of 256 threads per SM. This K6 takes D a multiple of 16 up to 256
// (float32: 192), as the fast K5; a wider D runs the wide K6 (below) on the
// wide K5's M.
//
// C interfaces (ctypes; every pointer and the stream is a void*):
// evdr_maxsim_bwd[_f32](q, qw, p, pmask, m, g f32 (nq, nd) already
//   multiplied by doc_has_token, dq_part f32 (ceil(nd / db), nq*lq, d),
//   dp f32 (ceil(n_qblocks / cluster), nd, lp, d) with n_qblocks =
//   ceil(nq / (128 / lq)), nq, lq, nd, lp, d, db, cluster in {1, 2, 4, 8},
//   stream);
// evdr_bwd_config(f32, d, cluster, out int[5]): CTAs per SM, clusters of
//   `cluster` CTAs the card holds at once, ring stages, shared bytes, page
//   tiles a cluster barrier.
// Each launch returns its error (a refused cluster launch included), minus
// the CUresult of a refused tensor-map encode, else cudaGetLastError().
#include "hopper.cuh"
#include "maxsim_wide.cuh"

namespace evdr {
namespace {

// bf16 mode recomputes on wgmma (K5's products), float32 by tile_mma
template <int MODE> constexpr bool kWg = MODE == kBf16;
template <int MODE> constexpr int kBwdMaxD = MODE == kF32 ? 192 : 256;
constexpr int kBwdStages = 8;       // ring stages, as many as fit
constexpr int kBwdCluster = 8;      // the portable cluster size
constexpr int kStep = 4;            // page tiles a cluster barrier (<= 4)
constexpr int kList = 64;           // a warp's list of a dP pull's hits
constexpr size_t kSmemCap = 232448;

// ------------------------------------------------------------------ PTX

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
// The shared::cluster address of shared::cta address `a` in CTA `rank`.
__device__ inline uint32_t peer(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// Loads from a CTA's shared memory by shared::cluster address; volatile, so
// they stay between the cluster barriers that publish what they read.
__device__ inline uint4 ld_peer_v4(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}
__device__ inline float ld_peer_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
// Two consecutive operand values of a peer's row, as floats.
template <int MODE> __device__ inline float2 peer_pair(uint32_t a) {
  if constexpr (MODE == kF32) {
    float2 v;
    asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v.x), "=f"(v.y)
                 : "r"(a));
    return v;
  } else {
    uint32_t u;
    asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(u) : "r"(a));
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
}

// `bytes` from global to the shared buffer `dst` (16-byte aligned, a
// multiple of 16 bytes), completing on `bar`; with `mask` != 1, into the
// same offset of every CTA of the cluster in the mask, each completing on
// its own barrier at `bar`'s offset.
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar, uint16_t mask) {
  if (mask == 1)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
            smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
        : "memory");
}

// ------------------------------------------------------------ layout

// Shared-memory carve-up of K6, in bytes from the dynamic base (bf16: from
// a 1024-byte aligned base, `total` adding the slack): the query block and
// the page-tile ring (bf16: K5's 128B-swizzled chunks of 64 columns, a
// stage `tile` bytes; float32: rows of stride (units + 1) * 16, tile_mma's),
// then two parity buffers (tile i uses i & 1) of the column scales, each
// row's M (NaN where W = 0: no hit), each row's e, the row masks (kRows x 2
// words) and the token masks (kCols x 4 words), then the ring's full
// barriers.
template <int MODE> struct BwdSmem {
  size_t a, b, tile, colscale, mrow, erow, rowbits, colbits, hits, bars,
      total;
  __host__ __device__ BwdSmem(int d, int stages) {
    a = 0;
    if constexpr (kWg<MODE>) {
      const size_t chunk = (size_t)((d + kBoxK - 1) / kBoxK) * 128;
      b = chunk * kRows;
      tile = chunk * kCols;
    } else {
      const size_t row = (size_t)(mma_units<MODE>(d) + 1) * 16;
      b = align128(row * kRows);
      tile = row * kCols;
    }
    colscale = align128(b + tile * stages);
    mrow = colscale + 2 * kCols * sizeof(float);
    erow = mrow + 2 * kRows * sizeof(float);
    rowbits = erow + 2 * kStep * kRows * sizeof(float);
    colbits = rowbits + 2 * kRows * 2 * sizeof(uint32_t);
    hits = colbits + 2 * kStep * kCols * 4 * sizeof(uint32_t);
    bars = align128(hits + (kThreads / 32) * kList * sizeof(uint16_t));
    total = align128(bars + stages * sizeof(uint64_t)) +
            (kWg<MODE> ? 1024 : 0);
  }
};

// The query block in K5's layout (128B-swizzled chunks of 64 columns,
// kRows rows each), rows at or past `valid` and columns at or past d zero;
// then made visible to wgmma (the async proxy).
__device__ inline void stage_q_sw128(unsigned char* dst,
                                     const __nv_bfloat16* src, int valid,
                                     int d, int tid) {
  const int units = (d + kBoxK - 1) / kBoxK * 8;  // 16-byte units a row
  for (int i = tid; i < kRows * units; i += kThreads) {
    const int r = i / units, u = i % units;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid && u * 8 < d)
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * d + u * 8);
    *reinterpret_cast<uint4*>(dst + sw128_offset(r, u * 8, kRows)) = v;
  }
  fence_proxy_async();
}

// a[u] for a runtime u, by selects (no local memory)
template <int N> __device__ inline int pick(const int (&a)[N], int u) {
  int v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = u == k ? a[k] : v;
  return v;
}

// A cursor over a doc slice's page tiles, in order, without divisions:
// tile t of doc dd (first token t * kCols), in ring stage s, whose full
// barrier completes phases of parity ph.
struct TilePos {
  int dd, t, s;
  uint32_t ph;
  __device__ void next(int n_tiles, int stages) {
    if (++t == n_tiles) {
      t = 0;
      ++dd;
    }
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
};

template <int MODE> int bwd_stages(int d) {
  int s = kBwdStages;
  while (s > 2 && BwdSmem<MODE>(d, s).total > kSmemCap) --s;
  return s;
}

// ------------------------------------------------------------ kernel

// NCH: 64-column chunks of D (a dP lane holds two columns of each; a dQ
// thread half of D).
// bf16 mode's recompute of a 128 x 64 tile and its hits. Each warpgroup
// (wg = warp / 4) takes rows wg * 64 .. + 64 and issues K5's products:
// wgmma m64n64k16 (kTrainTileN = 64 columns, maxsim_bf16.cu), A and B
// through 128B-swizzle descriptors, the first k-step overwriting the
// accumulators, D / 16 k-steps in ascending order, so each similarity is
// the one K5 took the max of. A thread holds rows 16 (warp % 4) + 8h + g
// of its warpgroup's 64 and columns 8j + 2t + {0, 1} (mma.sync's layout),
// so a row's 64 bits gather in its quad and a token's 16 bits of a warp's
// rows in the 8 lanes of equal t: rowbits gets a row's two words (columns
// 0-31, 32-63; those at or past ntok cleared), colbits16 a token's 8
// halfwords, halfword w the 16 rows of warp w (the same bits as the four
// words of 32 rows the pull reads). Whole words, no atomics. `active`:
// the CTA has rows (else every mask is 0).
__device__ inline void wg_hits(const unsigned char* As,
                               const unsigned char* B, const float* cs,
                               const float* mr, uint2* rowbits,
                               uint16_t* colbits16, int d, int ntok,
                               bool active, int warp, int lane) {
  const int g = lane / 4, t = lane % 4, wg = warp / 4;
  uint32_t rw[2][2] = {{0u, 0u}, {0u, 0u}};  // row 8h + g: [h][columns / 32]
  uint32_t cw[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};  // [j]: b = 0 | b = 1
  if (active) {
    float acc[32];
    const uint64_t a_desc = sw128_desc(smem_addr(As) + wg * 64 * 128);
    const uint64_t b_desc = sw128_desc(smem_addr(B));
    fence_regs(acc);
    wgmma_fence();
    for (int k = 0; k < d / 16; ++k) {
      // chunk k / 4, 32 bytes a k-step within it (descriptor units of 16)
      const uint32_t kb = (k % 4) * 2;
      wgmma(acc, a_desc + (((k / 4) * kRows * 128) >> 4) + kb,
            b_desc + (((k / 4) * kCols * 128) >> 4) + kb, k);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mv = mr[wg * 64 + (warp % 4) * 16 + h * 8 + g];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const uint32_t hit =
              masked(acc[4 * j + 2 * h + b], cs[8 * j + 2 * t + b]) == mv;
          rw[h][j / 4] |= hit << ((j % 4) * 8 + 2 * t + b);
          cw[j] |= hit << (b * 16 + h * 8 + g);
        }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      rw[h][x] |= __shfl_xor_sync(0xffffffffu, rw[h][x], 1);
      rw[h][x] |= __shfl_xor_sync(0xffffffffu, rw[h][x], 2);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cw[j] |= __shfl_xor_sync(0xffffffffu, cw[j], 4);
    cw[j] |= __shfl_xor_sync(0xffffffffu, cw[j], 8);
    cw[j] |= __shfl_xor_sync(0xffffffffu, cw[j], 16);
  }
  if (t == 0) {
    const uint32_t v0 = ntok >= 32 ? 0xffffffffu : (1u << ntok) - 1;
    const uint32_t v1 = ntok >= 64   ? 0xffffffffu
                        : ntok > 32 ? (1u << (ntok - 32)) - 1
                                    : 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rowbits[wg * 64 + (warp % 4) * 16 + h * 8 + g] =
          make_uint2(rw[h][0] & v0, rw[h][1] & v1);
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        colbits16[(8 * j + 2 * t + b) * 8 + warp] =
            (uint16_t)(cw[j] >> (16 * b));
  }
}

// tm_p: bf16 mode's pages, a (nd * lp, d) tensor in boxes of 64 columns x
// kCols / cluster rows, 128B-swizzled (float32 mode: unused). The last
// parameter, so the float32 kernels' parameters keep their offsets.
template <int MODE, int NCH>
__global__ void __launch_bounds__(kThreads)
maxsim_bwd_kernel(const typename Traits<MODE>::TQ* __restrict__ q,
                  const float* __restrict__ qw,
                  const typename Traits<MODE>::TQ* __restrict__ p,
                  const uint8_t* __restrict__ pmask,
                  const float* __restrict__ m, const float* __restrict__ g,
                  float* __restrict__ dq_part, float* __restrict__ dp_out,
                  int nq, int lq, int nd, int lp, int d, int qb, int db,
                  int stages, const __grid_constant__ CUtensorMap tm_p) {
  using T = typename Traits<MODE>::TQ;
  using TAcc = typename Traits<MODE>::TAcc;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (kWg<MODE>) {
    const uint32_t raw = smem_addr(smem_raw);
    smem += ((raw + 1023) & ~1023u) - raw;
  }
  const BwdSmem<MODE> lay(d, stages);
  const int units = mma_units<MODE>(d);
  const size_t stride = (size_t)(units + 1) * 16;
  const uint32_t rowbytes = (uint32_t)d * sizeof(T);
  unsigned char* As = smem + lay.a;
  unsigned char* Bs = smem + lay.b;
  float* colscale = reinterpret_cast<float*>(smem + lay.colscale);
  float* mrow = reinterpret_cast<float*>(smem + lay.mrow);
  float* erow = reinterpret_cast<float*>(smem + lay.erow);
  uint32_t* rowbits = reinterpret_cast<uint32_t*>(smem + lay.rowbits);
  uint32_t* colbits = reinterpret_cast<uint32_t*>(smem + lay.colbits);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % 4;
  const int wn = warp / 4;
  const int gq = lane / 4, t = lane % 4;
  const int ncta = (int)cluster_size();
  const int rank = (int)cluster_rank();
  const uint16_t cta_mask = (uint16_t)((1u << ncta) - 1);
  const uint32_t base = smem_addr(smem);
  const int q0 = blockIdx.x * qb;
  const int nrows = max(0, min(qb, nq - q0)) * lq;  // 0: a padding CTA
  const size_t row0 = (size_t)q0 * lq;
  const int d_begin = blockIdx.y * db;
  const int n_tiles = (lp + kCols - 1) / kCols;
  const int total = (min(nd, d_begin + db) - d_begin) * n_tiles;
  const int per = kCols / ncta;   // the tile's tokens this CTA owns in dP
  const int per_warp = per / 8;   // ... and each of its warps

  // Tile `it`'s metadata: M and W of row tid (tid < kRows; loaded at a
  // doc's first tile, kept for its others) and the mask of column tid,
  // loaded raw one tile ahead...
  float cur_m = 0.f, cur_w = 0.f, nxt_m = 0.f, nxt_qw = 0.f, nxt_g = 0.f;
  uint8_t nxt_pm = 0;
  auto load_meta = [&](const TilePos& x) {
    const int l0 = x.t * kCols;
    if (tid < nrows && tid < kRows && x.t == 0) {
      nxt_m = m[(row0 + tid) * nd + x.dd];
      nxt_qw = qw[row0 + tid];
      nxt_g = g[(size_t)(q0 + tid / lq) * nd + x.dd];
    }
    if (tid < kCols)
      nxt_pm = tid < min(kCols, lp - l0) ? pmask[(size_t)x.dd * lp + l0 + tid]
                                         : 0;
  };
  // ... used only here, after the recompute has hidden the loads' latency
  auto store_meta = [&](int it, const TilePos& x) {
    const int pb = it & 1;
    if (tid < kRows) {
      if (x.t == 0) {
        cur_m = nxt_m;
        cur_w = nxt_qw * nxt_g;
      }
      mrow[pb * kRows + tid] =
          cur_w != 0.f ? cur_m : __int_as_float(0x7fffffff);
    }
    if (tid < kCols) colscale[pb * kCols + tid] = nxt_pm ? 1.f : -1.f;
  };
  // tile x into its ring stage: this CTA's 1/C of its rows, to every CTA
  // of the cluster; each CTA's barrier expects the whole tile
  auto issue = [&](const TilePos& x) {
    const int l0 = x.t * kCols;
    if constexpr (kWg<MODE>) {
      // K5's boxes: kCols rows from the tile's first token (the next doc's
      // tokens or zeros past the doc, which the column scales mask), each
      // CTA kCols / C of them, every 64-column chunk; TMA counts the whole
      // box, zeros included. Lane 0 of warp (stage % 8) issues them, so a
      // step's refills spread over the warps that then start the pull.
      if (tid == 32 * (x.s % (kThreads / 32))) {
        const int rows = kCols / ncta;
        mbar_arrive_tx(full + x.s, (uint32_t)lay.tile);
        unsigned char* dst = Bs + x.s * lay.tile + rank * rows * 128;
        const int r0 = x.dd * lp + l0 + rank * rows;
        for (int c = 0; c * kBoxK < d; ++c) {
          if (ncta == 1)
            tma_load(dst + c * kCols * 128, &tm_p, c * kBoxK, r0, full + x.s);
          else
            tma_load_multicast(dst + c * kCols * 128, &tm_p, c * kBoxK, r0,
                               full + x.s, cta_mask);
        }
      }
    } else {
      const int ntok = min(kCols, lp - l0);
      if (tid == 0) mbar_arrive_tx(full + x.s, (uint32_t)ntok * rowbytes);
      // row rank + C i, i = warp + 8 lane: one copy a warp where C = 8
      const int r = rank + ncta * (warp + 8 * lane);
      if (r < ntok)
        bulk_load(Bs + ((size_t)x.s * kCols + r) * stride,
                  p + ((size_t)x.dd * lp + l0 + r) * d, rowbytes, full + x.s,
                  cta_mask);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kWg<MODE>)
    stage_q_sw128(As, q + row0 * d, nrows, d, tid);
  else
    stage_sync(As, reinterpret_cast<const unsigned char*>(q + row0 * d),
               kRows, nrows, units, units, tid);
  // the tile being processed, the next one's metadata, the next to issue
  TilePos cur = {d_begin, 0, 0, 0};
  TilePos nxt = cur, iss = cur;
  if (total > 0) {
    load_meta(cur);
    store_meta(0, cur);
    nxt.next(n_tiles, stages);
  }
  // every barrier initialised, every query block staged and tile 0's
  // metadata written, cluster-wide
  cluster_arrive();
  cluster_wait();
  // the ring starts full; after each step's barrier the consumed stages
  // are refilled, `issued` tiles so far
  int issued = 0;
  for (; issued < stages && issued < total; ++issued) {
    issue(iss);
    iss.next(n_tiles, stages);
  }

  // dQ of row tid / 2, columns (tid % 2) * D / 2 + [0, D / 2)
  constexpr int kVals = 16 / sizeof(T);     // operand values a 16-byte unit
  constexpr int kHalf = NCH * 32;           // the most columns a thread owns
  float dq[kHalf];
#pragma unroll
  for (int k = 0; k < kHalf; ++k) dq[k] = 0.f;
  const int half_d = d / 2;
  constexpr int kPull = 1;  // a dP pull's hits in flight
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + lay.hits) + warp * kList;

  // a step's tiles must all be in the ring at once
  const int step = min(kStep, stages);
  int sb = 0;  // the step's half of the buffers
  for (int it0 = 0; it0 < total; it0 += step, sb ^= 1) {
    const int nt = min(step, total - it0);
    int step_dd[kStep], step_l0[kStep];  // the step's tiles, for the pull
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      if (u >= nt) break;
      const int it = it0 + u;
      const int pb = it & 1;
      const int buf = sb * kStep + u;
      const int l0 = cur.t * kCols;
      const int ntok = min(kCols, lp - l0);
      const bool more = it + 1 < total;
      const unsigned char* B =
          Bs + (kWg<MODE> ? cur.s * lay.tile : (size_t)cur.s * stride * kCols);
      step_dd[u] = cur.dd;
      step_l0[u] = l0;
      if (more) load_meta(nxt);
      mbar_wait(full + cur.s, cur.ph);

      // recompute the similarity tile exactly as K5 did; hits into masks
      if constexpr (kWg<MODE>) {
        wg_hits(As, B, colscale + pb * kCols, mrow + pb * kRows,
                reinterpret_cast<uint2*>(rowbits) + pb * kRows,
                reinterpret_cast<uint16_t*>(colbits) + buf * kCols * 8, d,
                ntok, nrows > 0, warp, lane);
      } else {
        uint32_t rw[2][2] = {{0u, 0u}, {0u, 0u}};  // rows i*16 + h*8 + gq
        uint32_t cw[4][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}, {0u, 0u}};
        if (nrows > 0) {
          TAcc acc[2][4][4];
          tile_mma<MODE>(acc, As, B, units, stride, lane, wm, wn);
          const float* cs = colscale + pb * kCols + wn * 32 + 2 * t;
          const float* mr = mrow + pb * kRows + wm * 32 + gq;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float mv = mr[i * 16 + h * 8];
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                  const uint32_t hit =
                      masked((float)acc[i][j][2 * h + b], cs[j * 8 + b]) == mv;
                  rw[i][h] |= hit << (j * 8 + 2 * t + b);
                  cw[j][b] |= hit << (i * 16 + h * 8 + gq);
                }
            }
        }
        // a row's word: the quad's columns; a token's word: the warp's rows
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rw[i][h] |= __shfl_xor_sync(0xffffffffu, rw[i][h], 1);
            rw[i][h] |= __shfl_xor_sync(0xffffffffu, rw[i][h], 2);
          }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            cw[j][b] |= __shfl_xor_sync(0xffffffffu, cw[j][b], 4);
            cw[j][b] |= __shfl_xor_sync(0xffffffffu, cw[j][b], 8);
            cw[j][b] |= __shfl_xor_sync(0xffffffffu, cw[j][b], 16);
          }
        const int nv = min(max(ntok - wn * 32, 0), 32);
        const uint32_t vm = nv == 32 ? 0xffffffffu : (1u << nv) - 1;
        if (t == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              rowbits[(pb * kRows + wm * 32 + i * 16 + h * 8 + gq) * 2 + wn] =
                  rw[i][h] & vm;
        }
        if (gq == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int b = 0; b < 2; ++b)
              colbits[(buf * kCols + wn * 32 + j * 8 + 2 * t + b) * 4 + wm] =
                  cw[j][b];
        }
      }
      // this tile's e (W rounded to the compute dtype); the next tile's M
      // and column scales
      if (tid < kRows) {
        float e = cur_w;
        if constexpr (MODE != kF32)
          e = __bfloat162float(__float2bfloat16_rn(e));
        erow[buf * kRows + tid] = e;
      }
      if (more) {
        store_meta(it + 1, nxt);
        nxt.next(n_tiles, stages);
      }
      cur.next(n_tiles, stages);
      __syncthreads();  // this tile's masks and e; the next tile's metadata

      // dQ: each thread adds e * P_tile[c, its half of D] for its row's hits
      const int r = tid >> 1;
      const uint2 w2 = reinterpret_cast<const uint2*>(rowbits)[pb * kRows + r];
      uint64_t bits = ((uint64_t)w2.y << 32) | w2.x;
      if (bits != 0) {
        const float e = erow[buf * kRows + r];
        const unsigned char* cols = B + (tid & 1) * half_d * sizeof(T);
        do {
          const int c = __ffsll((long long)bits) - 1;
          bits &= bits - 1;
          const uint4* src = reinterpret_cast<const uint4*>(cols + c * stride);
#pragma unroll
          for (int v = 0; v < kHalf / kVals; ++v) {
            if (v * kVals < half_d) {
              uint4 x;
              if constexpr (kWg<MODE>)  // K5's swizzled row c
                x = *reinterpret_cast<const uint4*>(
                    B + sw128_offset(c, (tid & 1) * half_d + v * kVals,
                                     kCols));
              else
                x = src[v];
              const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                if constexpr (MODE == kF32) {
                  dq[v * 4 + k] = fmaf(e, __uint_as_float(w[k]), dq[v * 4 + k]);
                } else {
                  const float2 f = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(&w[k]));
                  dq[v * 8 + 2 * k] = fmaf(e, f.x, dq[v * 8 + 2 * k]);
                  dq[v * 8 + 2 * k + 1] = fmaf(e, f.y, dq[v * 8 + 2 * k + 1]);
                }
              }
            }
          }
        } while (bits);
      }
    }

    // every CTA's masks and e of the step are in; every CTA is done with
    // the step's tiles (their ring stages) and with the last step's pull
    // (the other half of the buffers)
    cluster_arrive();
    cluster_wait();
    // lane L < items * C brings CTA L % C's mask of the warp's item L / C:
    // item i is token rank * per + warp * per_warp + i % per_warp of the
    // step's tile i / per_warp
    const int n_items = nt * per_warp;
    uint4 w4 = make_uint4(0u, 0u, 0u, 0u);
    {
      const int i = lane / ncta;
      const int u = i / per_warp;
      const int c = rank * per + warp * per_warp + i % per_warp;
      if (i < n_items && c < min(kCols, lp - pick(step_l0, u)))
        w4 = ld_peer_v4(peer(base, lane % ncta) + (uint32_t)lay.colbits +
                        ((sb * kStep + u) * kCols + c) * 16);
    }
    for (; issued < total && issued < it0 + nt + stages; ++issued) {
      issue(iss);
      iss.next(n_tiles, stages);
    }

    // dP: each item's hits summed over the cluster's CTAs in rank order,
    // each CTA's in row order, written once. Items go in pairs: the pair's
    // hits are listed in that order (a scan of the lanes' counts), then
    // their rows load kPull at a time.
    const uint64_t lo = ((uint64_t)w4.y << 32) | w4.x;
    const uint64_t hi = ((uint64_t)w4.w << 32) | w4.z;
    for (int i0 = 0; i0 < n_items; i0 += 2) {
      const bool mine = lane >= i0 * ncta && lane < min(i0 + 2, n_items) * ncta;
      const int cnt = mine ? __popcll(lo) + __popcll(hi) : 0;
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int n_hit = __shfl_sync(0xffffffffu, incl, 31);
      // the row, CTA and item (of the pair) of each hit, or where the list
      // is too short (many ties), each hit in turn
      auto hit_at = [&](int h, int& rel, int& jj, int& rr) {
        const int x = list[h];
        rel = x >> 10;
        jj = (x >> 7) & 7;
        rr = x & 127;
      };
      if (n_hit <= kList && mine) {
        const int code = ((lane / ncta - i0) << 10) | ((lane % ncta) << 7);
        int at = incl - cnt;
        for (uint64_t x = lo; x; x &= x - 1)
          list[at++] = (uint16_t)(code | (__ffsll((long long)x) - 1));
        for (uint64_t x = hi; x; x &= x - 1)
          list[at++] = (uint16_t)(code | (64 + __ffsll((long long)x) - 1));
      }
      __syncwarp();
      float acc[2][NCH][2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) acc[a][ch][0] = acc[a][ch][1] = 0.f;
      // one hit: e and the query row, loaded (peer j, row r, item rel)
      auto fetch = [&](int rel, int jj, int rr, float& e, float2 (&v)[NCH]) {
        const int u = (i0 + rel) / per_warp;
        const uint32_t pj = peer(base, jj);
        e = ld_peer_f32(pj + (uint32_t)lay.erow +
                        (((sb * kStep + u) * kRows + rr) << 2));
        const uint32_t qrow = pj + (uint32_t)(lay.a + rr * stride);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int col = ch * 64 + 2 * lane;
          if constexpr (kWg<MODE>)  // K5's swizzled row rr
            v[ch] = col < d ? peer_pair<MODE>(pj + (uint32_t)lay.a +
                                              sw128_offset(rr, col, kRows))
                            : make_float2(0.f, 0.f);
          else
            v[ch] = col < d ? peer_pair<MODE>(qrow + col * sizeof(T))
                            : make_float2(0.f, 0.f);
        }
      };
      auto add = [&](int rel, float e, const float2 (&v)[NCH]) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (rel == a) {
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch) {
              acc[a][ch][0] = fmaf(e, v[ch].x, acc[a][ch][0]);
              acc[a][ch][1] = fmaf(e, v[ch].y, acc[a][ch][1]);
            }
          }
        }
      };
      if (n_hit <= kList) {
        for (int h0 = 0; h0 < n_hit; h0 += kPull) {
          float e[kPull];
          float2 v[kPull][NCH];
          int tg[kPull];
#pragma unroll
          for (int x = 0; x < kPull; ++x) {
            if (h0 + x < n_hit) {
              int jj, rr;
              hit_at(h0 + x, tg[x], jj, rr);
              fetch(tg[x], jj, rr, e[x], v[x]);
            }
          }
#pragma unroll
          for (int x = 0; x < kPull; ++x)
            if (h0 + x < n_hit) add(tg[x], e[x], v[x]);
        }
      } else {
        for (int a = 0; a < 2 && i0 + a < n_items; ++a)
          for (int jj = 0; jj < ncta; ++jj) {
            const int src = (i0 + a) * ncta + jj;
            const uint64_t x_lo = __shfl_sync(0xffffffffu, lo, src);
            const uint64_t x_hi = __shfl_sync(0xffffffffu, hi, src);
            for (int up = 0; up < 2; ++up)
              for (uint64_t x = up ? x_hi : x_lo; x; x &= x - 1) {
                float e;
                float2 v[NCH];
                fetch(a, jj, up * 64 + __ffsll((long long)x) - 1, e, v);
                add(a, e, v);
              }
          }
      }
      __syncwarp();  // the list is free for the next pair
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = i0 + a;
        const int u = i / per_warp;
        const int l0 = pick(step_l0, u);
        const int c = rank * per + warp * per_warp + i % per_warp;
        if (i < n_items && c < min(kCols, lp - l0)) {
          const int dd = pick(step_dd, u);
          float* dst = dp_out +
                       (((size_t)(blockIdx.x / ncta) * nd + dd) * lp + l0 + c) *
                           d;
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            const int col = ch * 64 + 2 * lane;
            if (col < d)
              *reinterpret_cast<float2*>(dst + col) =
                  make_float2(acc[a][ch][0], acc[a][ch][1]);
          }
        }
      }
    }
  }

  // this doc slice's dQ partial
  if ((tid >> 1) < nrows) {
    float* dst = dq_part + ((size_t)blockIdx.y * nq * lq + row0 + (tid >> 1)) *
                               d + (tid & 1) * half_d;
#pragma unroll
    for (int k = 0; k < kHalf; k += 4)
      if (k < half_d)
        *reinterpret_cast<float4*>(dst + k) =
            make_float4(dq[k], dq[k + 1], dq[k + 2], dq[k + 3]);
  }
  // no CTA leaves while a peer may still read its shared memory
  cluster_arrive();
  cluster_wait();
}

template <int MODE>
using BwdKern = void (*)(const typename Traits<MODE>::TQ*, const float*,
                         const typename Traits<MODE>::TQ*, const uint8_t*,
                         const float*, const float*, float*, float*, int, int,
                         int, int, int, int, int, int, const CUtensorMap);

// The instantiation for `nch` 64-column chunks of D.
template <int MODE, int N = 1> BwdKern<MODE> bwd_kernel(int nch) {
  if constexpr (N * 64 >= kBwdMaxD<MODE>)
    return maxsim_bwd_kernel<MODE, N>;
  else
    return nch <= N ? maxsim_bwd_kernel<MODE, N> : bwd_kernel<MODE, N + 1>(nch);
}

// Checks D and the cluster size; the kernel for D, its ring stages and
// shared bytes (and the attribute that allows them).
template <int MODE>
int bwd_plan(int d, int cluster, BwdKern<MODE>* kern, int* stages,
             size_t* smem) {
  if (d < 16 || d % 16 != 0 || d > kBwdMaxD<MODE>)
    return (int)cudaErrorInvalidValue;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != kBwdCluster)
    return (int)cudaErrorInvalidValue;
  *stages = bwd_stages<MODE>(d);
  *smem = BwdSmem<MODE>(d, *stages).total;
  if (*smem > kSmemCap) return (int)cudaErrorInvalidValue;
  *kern = bwd_kernel<MODE>((d + 63) / 64);
  return (int)cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem, int cluster,
                                  cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int MODE>
int launch_bwd(const void* q, const void* qw, const void* p,
               const void* pmask, const void* m, const void* g,
               void* dq_part, void* dp_out, int nq, int lq, int nd, int lp,
               int d, int db, int cluster, void* stream) {
  if (nq < 1 || nd < 1 || lp < 1 || lq < 1 || lq > kRows || db < 1 ||
      (nd + db - 1) / db > kMaxGridY || (long long)nd * lp >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  BwdKern<MODE> kern;
  int stages;
  size_t smem;
  int e = bwd_plan<MODE>(d, cluster, &kern, &stages, &smem);
  if (e != 0) return e;
  // bf16: the pages in K5's boxes, each CTA of a cluster loading kCols / C
  // rows of a tile (a refused encode returns minus its CUresult)
  alignas(64) CUtensorMap tm_p = {};
  if (kWg<MODE> &&
      (e = encode_rows(&tm_p, p, nd * lp, d, kCols / cluster)) != 0)
    return e;
  using T = typename Traits<MODE>::TQ;
  const int qb = kRows / lq;
  const int nqb = (nq + qb - 1) / qb;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      dim3((nqb + cluster - 1) / cluster * cluster, (nd + db - 1) / db), smem,
      cluster, &attr, stream);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const float*>(qw),
      static_cast<const T*>(p), static_cast<const uint8_t*>(pmask),
      static_cast<const float*>(m), static_cast<const float*>(g),
      static_cast<float*>(dq_part), static_cast<float*>(dp_out), nq, lq, nd,
      lp, d, qb, db, stages, tm_p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE> int bwd_config(int d, int cluster, int* out) {
  BwdKern<MODE> kern;
  size_t smem;
  int e = bwd_plan<MODE>(d, cluster, &kern, &out[2], &smem);
  if (e != 0) return e;
  out[3] = (int)smem;
  out[4] = min(kStep, out[2]);
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern,
                                                         kThreads, smem);
  if (e != 0) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(dim3(cluster), smem, cluster, &attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(&out[1], kern, &cfg);
}

// ------------------------------------------------------------ wide K6

// Above kBwdMaxD the wide K5 (maxsim_wide.cuh: the D-chunked mma.sync loop,
// in both modes) leaves M, and the wide K6 meets it in three passes, each
// walking D in chunks:
// 1. hits: a CTA recomputes a 128-row x 64-token tile of one doc with
//    tile_mma_acc over kWideUnits-unit chunks of D (the wide K5's products
//    and k order, so sim == M holds exactly where it held), and writes the
//    tile's hits as whole words: a row's 32 columns of a column warp
//    (rowbits, (nq * lq, nd, tiles, 2)) and a token's 32 rows of a row
//    warp (colbits, (nd * lp, words of 32 rows)). No atomics.
// 2. dQ: a warp a row and chunk of 256 columns of D (8 a lane) sums
//    e * P[token] over the row's hits, docs and tiles ascending, tokens
//    ascending within a tile; the row's mask words are read 32 at a time
//    and handed round the warp.
// 3. dP: a warp a token and chunk of D sums e * Q[row] over the token's
//    hits, rows ascending.
// e is W rounded to the compute dtype, as in the fast kernel. Every output
// element has one thread and a fixed order: two calls give the same bits.
// The masks take 8 bytes a (row, doc, 64 tokens) and a bit a (row, token).

struct WideHitSmem {
  size_t a, b, colscale, mrow, total;
  __host__ __device__ WideHitSmem() {
    const size_t row = (size_t)(kWideUnits + 1) * 16;
    a = 0;
    b = align128(row * kRows);
    colscale = align128(b + row * kCols);
    mrow = colscale + kCols * sizeof(float);
    total = align128(mrow + kRows * sizeof(float));
  }
};

template <int MODE>
__global__ void __launch_bounds__(kThreads)
bwd_wide_hits(const unsigned char* __restrict__ q,
              const float* __restrict__ qw,
              const unsigned char* __restrict__ p,
              const uint8_t* __restrict__ pmask, const float* __restrict__ m,
              const float* __restrict__ g, uint32_t* __restrict__ rowbits,
              uint32_t* __restrict__ colbits, int nrows, int lq, int nd,
              int lp, int d) {
  using T = typename Traits<MODE>::TQ;
  extern __shared__ __align__(128) unsigned char smem[];
  const WideHitSmem lay;
  constexpr size_t stride = (size_t)(kWideUnits + 1) * 16;
  unsigned char* As = smem + lay.a;
  unsigned char* Bs = smem + lay.b;
  float* colscale = reinterpret_cast<float*>(smem + lay.colscale);
  float* mrow = reinterpret_cast<float*>(smem + lay.mrow);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const int gq = lane / 4, t = lane % 4;
  const int dd = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int nr = min(kRows, nrows - r0);
  const int units = mma_units<MODE>(d);
  const int nch = (units + kWideUnits - 1) / kWideUnits;
  const int g_units = d * (int)sizeof(T) / 16;
  const int n_tiles = (lp + kCols - 1) / kCols;
  const int n_rw = (nrows + 31) / 32;
  // a row's M where W != 0, else NaN (no hit)
  for (int r = tid; r < kRows; r += kThreads) {
    float mv = __int_as_float(0x7fffffff);
    if (r < nr &&
        qw[r0 + r] * g[(size_t)((r0 + r) / lq) * nd + dd] != 0.f)
      mv = m[(size_t)(r0 + r) * nd + dd];
    mrow[r] = mv;
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int l0 = tile * kCols;
    const int ntok = min(kCols, lp - l0);
    const size_t tok0 = (size_t)dd * lp + l0;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int u0 = c * kWideUnits;
      const int cu = min(kWideUnits, units - u0);
      __syncthreads();  // the last chunk's products (and hits) are done
      if (c == 0 && tid < kCols)
        colscale[tid] = tid < ntok && pmask[tok0 + tid] ? 1.f : -1.f;
      stage_chunk<kRows>(As, kWideUnits, q + (size_t)r0 * g_units * 16, nr,
                         g_units, u0, cu, tid);
      stage_chunk<kCols>(Bs, kWideUnits, p + tok0 * g_units * 16, ntok,
                         g_units, u0, cu, tid);
      cp_async_commit();
      cp_async_wait0();
      __syncthreads();
      tile_mma_acc<MODE>(acc, As, Bs, cu, stride, lane, wm, wn);
    }
    // hits into whole words, as the fast float32 kernel gathers them
    uint32_t rw[2][2] = {{0u, 0u}, {0u, 0u}};
    uint32_t cw[4][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}, {0u, 0u}};
    const float* cs = colscale + wn * 32 + 2 * t;
    const float* mr = mrow + wm * 32 + gq;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mv = mr[i * 16 + h * 8];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const uint32_t hit =
                masked(acc[i][j][2 * h + b], cs[j * 8 + b]) == mv;
            rw[i][h] |= hit << (j * 8 + 2 * t + b);
            cw[j][b] |= hit << (i * 16 + h * 8 + gq);
          }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rw[i][h] |= __shfl_xor_sync(0xffffffffu, rw[i][h], 1);
        rw[i][h] |= __shfl_xor_sync(0xffffffffu, rw[i][h], 2);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        cw[j][b] |= __shfl_xor_sync(0xffffffffu, cw[j][b], 4);
        cw[j][b] |= __shfl_xor_sync(0xffffffffu, cw[j][b], 8);
        cw[j][b] |= __shfl_xor_sync(0xffffffffu, cw[j][b], 16);
      }
    const int nv = min(max(ntok - wn * 32, 0), 32);
    const uint32_t vm = nv == 32 ? 0xffffffffu : (1u << nv) - 1;
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + i * 16 + h * 8 + gq;
          if (r < nr)
            rowbits[(((size_t)(r0 + r) * nd + dd) * n_tiles + tile) * 2 +
                    wn] = rw[i][h] & vm;
        }
    }
    const int word = r0 / 32 + wm;
    if (gq == 0 && word < n_rw) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int col = wn * 32 + j * 8 + 2 * t + b;
          if (col < ntok)
            colbits[(tok0 + col) * n_rw + word] = cw[j][b];
        }
    }
  }
}

// e: W rounded to the compute dtype (bf16 mode), as the fast kernel's erow
template <int MODE> __device__ inline float wide_e(float w) {
  if constexpr (MODE != kF32) w = __bfloat162float(__float2bfloat16_rn(w));
  return w;
}

constexpr int kWidePer = 8;  // columns a lane holds in the dQ / dP walks

// dQ: a warp a row and chunk of 32 * kWidePer columns of D (4 rows a
// CTA, the chunk blockIdx.y; lane: columns c0 + 32 k + lane); the row's
// mask words, 32 at a time (one a lane), in order: docs, tiles and halves
// ascending, tokens ascending within a word, e * P[token] added for each
// hit.
template <int MODE>
__global__ void __launch_bounds__(kRows)
bwd_wide_dq(const typename Traits<MODE>::TQ* __restrict__ p,
            const float* __restrict__ qw, const float* __restrict__ g,
            const uint32_t* __restrict__ rowbits, float* __restrict__ dq,
            int nrows, int lq, int nd, int lp, int d) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kRows / 32) + threadIdx.x / 32;
  if (row >= nrows) return;
  const int n_w = ((lp + kCols - 1) / kCols) * 2;  // words a doc
  const size_t n_row = (size_t)nd * n_w;
  const uint32_t* rb = rowbits + (size_t)row * n_row;
  const float wq = qw[row];
  const float* gr = g + (size_t)(row / lq) * nd;
  const int c0 = blockIdx.y * 32 * kWidePer;
  {
    float acc[kWidePer];
#pragma unroll
    for (int k = 0; k < kWidePer; ++k) acc[k] = 0.f;
    for (size_t x0 = 0; x0 < n_row; x0 += 32) {
      const uint32_t mine = x0 + lane < n_row ? rb[x0 + lane] : 0u;
      for (uint32_t any = __ballot_sync(0xffffffffu, mine != 0u); any;
           any &= any - 1) {
        const int l = __ffs(any) - 1;
        const size_t x = x0 + l;
        const int dd = (int)(x / n_w);
        const float e = wide_e<MODE>(wq * gr[dd]);
        for (uint32_t bits = __shfl_sync(0xffffffffu, mine, l); bits;
             bits &= bits - 1) {
          const int tok = (int)(x % n_w) * 32 + __ffs(bits) - 1;
          const auto* src = p + ((size_t)dd * lp + tok) * d + c0 + lane;
#pragma unroll
          for (int k = 0; k < kWidePer; ++k)
            if (c0 + 32 * k + lane < d)
              acc[k] = fmaf(e, (float)src[32 * k], acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWidePer; ++k)
      if (c0 + 32 * k + lane < d)
        dq[(size_t)row * d + c0 + 32 * k + lane] = acc[k];
  }
}

// dP: a warp a token and chunk of D (4 tokens a CTA), as dQ; the token's
// mask words, 32 at a time, rows ascending, e * Q[row] added for each
// hit.
template <int MODE>
__global__ void __launch_bounds__(kRows)
bwd_wide_dp(const typename Traits<MODE>::TQ* __restrict__ q,
            const float* __restrict__ qw, const float* __restrict__ g,
            const uint32_t* __restrict__ colbits, float* __restrict__ dp,
            int nrows, int lq, int nd, int lp, int d) {
  const int lane = threadIdx.x % 32;
  const size_t tok = (size_t)blockIdx.x * (kRows / 32) + threadIdx.x / 32;
  if (tok >= (size_t)nd * lp) return;
  const int dd = (int)(tok / lp);
  const int n_rw = (nrows + 31) / 32;
  const uint32_t* cb = colbits + tok * n_rw;
  const int c0 = blockIdx.y * 32 * kWidePer;
  {
    float acc[kWidePer];
#pragma unroll
    for (int k = 0; k < kWidePer; ++k) acc[k] = 0.f;
    for (int x0 = 0; x0 < n_rw; x0 += 32) {
      const uint32_t mine = x0 + lane < n_rw ? cb[x0 + lane] : 0u;
      for (uint32_t any = __ballot_sync(0xffffffffu, mine != 0u); any;
           any &= any - 1) {
        const int l = __ffs(any) - 1;
        for (uint32_t bits = __shfl_sync(0xffffffffu, mine, l); bits;
             bits &= bits - 1) {
          const int r = (x0 + l) * 32 + __ffs(bits) - 1;
          const float e =
              wide_e<MODE>(qw[r] * g[(size_t)(r / lq) * nd + dd]);
          const auto* src = q + (size_t)r * d + c0 + lane;
#pragma unroll
          for (int k = 0; k < kWidePer; ++k)
            if (c0 + 32 * k + lane < d)
              acc[k] = fmaf(e, (float)src[32 * k], acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWidePer; ++k)
      if (c0 + 32 * k + lane < d)
        dp[tok * d + c0 + 32 * k + lane] = acc[k];
  }
}

template <int MODE>
int launch_bwd_wide(const void* q, const void* qw, const void* p,
                    const void* pmask, const void* m, const void* g,
                    void* rowbits, void* colbits, void* dq, void* dp, int nq,
                    int lq, int nd, int lp, int d, void* stream) {
  const long long nrows = (long long)nq * lq;
  if (nq < 1 || nd < 1 || lp < 1 || lq < 1 || d < 16 || d % 16 != 0 ||
      (nrows + kRows - 1) / kRows > kMaxGridY ||
      (long long)nd * lp >= (1LL << 31) || nrows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  using T = typename Traits<MODE>::TQ;
  const WideHitSmem lay;
  auto* hits = bwd_wide_hits<MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      hits, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  hits<<<dim3(nd, (unsigned)((nrows + kRows - 1) / kRows)), kThreads,
         lay.total, st>>>(
      static_cast<const unsigned char*>(q), static_cast<const float*>(qw),
      static_cast<const unsigned char*>(p),
      static_cast<const uint8_t*>(pmask), static_cast<const float*>(m),
      static_cast<const float*>(g), static_cast<uint32_t*>(rowbits),
      static_cast<uint32_t*>(colbits), (int)nrows, lq, nd, lp, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  constexpr int kWarps = kRows / 32;  // rows (dQ) or tokens (dP) a CTA
  const unsigned nch = (unsigned)((d + 32 * kWidePer - 1) / (32 * kWidePer));
  bwd_wide_dq<MODE><<<dim3((unsigned)((nrows + kWarps - 1) / kWarps), nch),
                      kRows, 0, st>>>(
      static_cast<const T*>(p), static_cast<const float*>(qw),
      static_cast<const float*>(g), static_cast<const uint32_t*>(rowbits),
      static_cast<float*>(dq), (int)nrows, lq, nd, lp, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long ntok = (long long)nd * lp;
  bwd_wide_dp<MODE><<<dim3((unsigned)((ntok + kWarps - 1) / kWarps), nch),
                      kRows, 0, st>>>(
      static_cast<const T*>(q), static_cast<const float*>(qw),
      static_cast<const float*>(g), static_cast<const uint32_t*>(colbits),
      static_cast<float*>(dp), (int)nrows, lq, nd, lp, d);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace evdr

extern "C" int evdr_maxsim_bwd(const void* q, const void* qw, const void* p,
                               const void* pmask, const void* m,
                               const void* g, void* dq_part, void* dp,
                               int nq, int lq, int nd, int lp, int d, int db,
                               int cluster, void* stream) {
  return evdr::launch_bwd<evdr::kBf16>(q, qw, p, pmask, m, g, dq_part, dp, nq,
                                       lq, nd, lp, d, db, cluster, stream);
}

extern "C" int evdr_maxsim_bwd_f32(const void* q, const void* qw,
                                   const void* p, const void* pmask,
                                   const void* m, const void* g,
                                   void* dq_part, void* dp, int nq, int lq,
                                   int nd, int lp, int d, int db, int cluster,
                                   void* stream) {
  return evdr::launch_bwd<evdr::kF32>(q, qw, p, pmask, m, g, dq_part, dp, nq,
                                      lq, nd, lp, d, db, cluster, stream);
}

extern "C" int evdr_bwd_config(int f32, int d, int cluster, void* out) {
  int* o = static_cast<int*>(out);
  return f32 ? evdr::bwd_config<evdr::kF32>(d, cluster, o)
             : evdr::bwd_config<evdr::kBf16>(d, cluster, o);
}

// The wide K6 (D above 256, float32 above 192): q (nq, lq, d), p (nd, lp,
// d) in the mode's type, qw, pmask, m and g as evdr_maxsim_bwd, rowbits
// uint32 (nq * lq, nd, ceil(lp / 64), 2), colbits uint32 (nd * lp,
// ceil(nq * lq / 32)), dq f32 (nq * lq, d), dp f32 (nd, lp, d).
extern "C" int evdr_maxsim_bwd_wide(const void* q, const void* qw,
                                    const void* p, const void* pmask,
                                    const void* m, const void* g,
                                    void* rowbits, void* colbits, void* dq,
                                    void* dp, int nq, int lq, int nd, int lp,
                                    int d, void* stream) {
  return evdr::launch_bwd_wide<evdr::kBf16>(q, qw, p, pmask, m, g, rowbits,
                                            colbits, dq, dp, nq, lq, nd, lp,
                                            d, stream);
}

extern "C" int evdr_maxsim_bwd_f32_wide(const void* q, const void* qw,
                                        const void* p, const void* pmask,
                                        const void* m, const void* g,
                                        void* rowbits, void* colbits,
                                        void* dq, void* dp, int nq, int lq,
                                        int nd, int lp, int d, void* stream) {
  return evdr::launch_bwd_wide<evdr::kF32>(q, qw, p, pmask, m, g, rowbits,
                                           colbits, dq, dp, nq, lq, nd, lp,
                                           d, stream);
}
