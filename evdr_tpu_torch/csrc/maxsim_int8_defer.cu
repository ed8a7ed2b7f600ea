// K2b: K2 with its doc epilogue deferred, for Hopper (sm_90a).
//
// evdr_maxsim_int8full_defer and evdr_maxsim_int8_defer replace
// pallas_maxsim.py:_kernel_int8_defer (reached from _maxsim_int8_impl with
// deferred=True), which emits each doc block's Lq-sum epilogue one grid step
// late so that it no longer waits on that step's matmul. Here the same
// scores come from K2's loop on K2's wide tiles (maxsim_tile.cuh CfgWide:
// 256 query rows x 64 page tokens a CTA, 64 x 32 outputs a warp, 8 docs a
// CTA) with the DEFER flag: at a doc's end each warp's quad combines its
// row maxima into one of two shared-memory buffers (by doc parity); the
// cross-warp max and the weight (256 threads, one row each) run after the
// NEXT tile's MMAs, and the weighted Lq-sum and the store after the one
// after that, each inside the barrier interval the loop already has,
// instead of behind a barrier pair of their own. The sum keeps K2's order
// (r = 0 .. lq - 1), and both configurations give each output the same k
// order, so the scores equal K2's bit for bit. It matters where docs are
// short: at Lp <= 64 a doc ends every tile. What bounds it: the same
// operations as K2. Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W
// power limit (scripts/torch_kernel_ab.py, PERF.md section 6): on the
// wide tiles K2b runs with K2 at Lp 64 (int8 1-2% faster, int8full 1-2%
// slower) and 0-5% behind it at Lp 768, where the 128-row layout it left
// ran 26-28% behind; the bare launch bound (128 registers, 2 CTAs per SM)
// measured as a minimum of 2 CTAs per SM did.
//
// C interface: as evdr_maxsim_int8full / evdr_maxsim_int8 (maxsim_int8.cu).
// Returns cudaGetLastError() after the launch.
#include "maxsim_tile.cuh"
#include "maxsim_wide.cuh"

extern "C" int evdr_maxsim_int8full_defer(const void* q, const void* qw,
                                          const void* p, const void* scales,
                                          const void* pmask, void* out, int nq,
                                          int lq, int nd, int lp, int d,
                                          void* stream) {
  return evdr::launch<evdr::kInt8Int8, true, evdr::CfgWide>(
      q, qw, p, scales, pmask, out, nq, lq, nd, lp, d, stream);
}

extern "C" int evdr_maxsim_int8_defer(const void* q, const void* qw,
                                      const void* p, const void* scales,
                                      const void* pmask, void* out, int nq,
                                      int lq, int nd, int lp, int d,
                                      void* stream) {
  return evdr::launch<evdr::kInt8Bf16, true, evdr::CfgWide>(
      q, qw, p, scales, pmask, out, nq, lq, nd, lp, d, stream);
}

// K2b's wide path (D above 256): the wide loop with the deferred doc
// epilogue, K2's wide scores bit for bit. C interfaces as above.
extern "C" int evdr_maxsim_int8full_defer_wide(const void* q, const void* qw,
                                               const void* p,
                                               const void* scales,
                                               const void* pmask, void* out,
                                               int nq, int lq, int nd, int lp,
                                               int d, void* stream) {
  return evdr::launch_wide<evdr::kInt8Int8, true, false, evdr::kNoBooks>(
      q, qw, p, scales, pmask, out, nullptr, nullptr, nq, lq, nd, lp, d, 0,
      stream);
}

extern "C" int evdr_maxsim_int8_defer_wide(const void* q, const void* qw,
                                           const void* p, const void* scales,
                                           const void* pmask, void* out, int nq,
                                           int lq, int nd, int lp, int d,
                                           void* stream) {
  return evdr::launch_wide<evdr::kInt8Bf16, true, false, evdr::kNoBooks>(
      q, qw, p, scales, pmask, out, nullptr, nullptr, nq, lq, nd, lp, d, 0,
      stream);
}
