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
// carry code 0 and score -1e30 after the product, as in K1.
// - evdr_maxsim_pq / evdr_maxsim_pqfull: compact (M, K, D/M) books, D/M a
//   multiple of 4. The books (256 * D bytes: 32 KB at D = 128) are copied
//   once per CTA into shared memory; each token concatenates its M rows of
//   D/M bytes, an exact int8 tile that feeds K1's bf16 loop (pq, bf16
//   queries) or K2's int8 x int8 loop (pqfull, int8 queries).
// - evdr_maxsim_pq_sum: full-width (M, K, D) books (expanded OPQ books, or
//   compact ones embedded block-diagonally by the wrapper), M * 256 * D
//   bytes (512 KB at M = 16, D = 128: over a block's 227 KB), read through
//   L2 where they stay resident. Each token sums M rows of D bytes in int32
//   and rounds the sum to bf16 (sums above 256 round, as on the TPU). bf16
//   queries, or int8 queries cast up to bf16 by the wrapper (exact).
// The TPU decodes by a one-hot matmul because it has no fast gather; here
// the decode is a gather of book rows.
//
// What bounds it on the H100: at the serving shape, operations (as K1/K2:
// each decoded token meets all 8192 query-token rows), with the decode as
// extra work: a page tile is decoded once per CTA that reads it, i.e. once
// per 128-row query block (64 times for 256 x 32 queries). Codes arrive by
// 4-byte cp.async into a double-buffered raw area while the previous tile
// multiplies; the decode runs once the codes have landed.
//
// C interface: q (nq, lq, d) bf16 or int8, qw (nq, lq) f32, codes (nd, lp,
// m) uint8, books int8 (m, 256, d / m) or (m, 256, d), pmask (nd, lp) bool
// as bytes, out (nq, nd) f32. Returns cudaGetLastError() after the launch.
#include "maxsim_tile.cuh"

extern "C" int evdr_maxsim_pq(const void* q, const void* qw,
                              const void* codes, const void* books,
                              const void* pmask, void* out, int nq, int lq,
                              int nd, int lp, int d, int m, void* stream) {
  return evdr::launch<evdr::kPqBf16>(q, qw, codes, nullptr, pmask, out,
                                     nullptr, nq, lq, nd, lp, d, stream,
                                     books, m);
}

extern "C" int evdr_maxsim_pqfull(const void* q, const void* qw,
                                  const void* codes, const void* books,
                                  const void* pmask, void* out, int nq,
                                  int lq, int nd, int lp, int d, int m,
                                  void* stream) {
  return evdr::launch<evdr::kPqInt8>(q, qw, codes, nullptr, pmask, out,
                                     nullptr, nq, lq, nd, lp, d, stream,
                                     books, m);
}

extern "C" int evdr_maxsim_pq_sum(const void* q, const void* qw,
                                  const void* codes, const void* books,
                                  const void* pmask, void* out, int nq,
                                  int lq, int nd, int lp, int d, int m,
                                  void* stream) {
  return evdr::launch<evdr::kPqSumBf16>(q, qw, codes, nullptr, pmask, out,
                                        nullptr, nq, lq, nd, lp, d, stream,
                                        books, m);
}
