// K2b: K2 with its doc epilogue deferred, for Hopper (sm_90a).
//
// evdr_maxsim_int8full_defer and evdr_maxsim_int8_defer replace
// pallas_maxsim.py:_kernel_int8_defer (reached from _maxsim_int8_impl with
// deferred=True), which emits each doc block's Lq-sum epilogue one grid step
// late so that it no longer waits on that step's matmul. Here the same
// scores come from K2's loop with the DEFER flag (maxsim_tile.cuh): at a
// doc's end each warp's quad combines its row maxima into one of two
// shared-memory buffers (by doc parity); the cross-warp max and the weight
// (128 threads, one row each) run after the NEXT tile's MMAs, and the
// weighted Lq-sum and the store after the one after that, each inside the
// barrier interval the loop already has, instead of behind a barrier pair
// of their own. The sum keeps K2's order (r = 0 .. lq - 1), so the scores
// equal K2's bit for bit. It matters where docs are short: at Lp <= 64 a
// doc ends every tile. What bounds it: the same operations as K2.
// Its own source, so that its launch bound can ask for three CTAs per SM
// (EVDR_MIN_CTAS, at most 80 registers): without it the int8full mode took
// 96 registers, two CTAs per SM, and ran well behind K2.
//
// C interface: as evdr_maxsim_int8full / evdr_maxsim_int8 (maxsim_int8.cu).
// Returns cudaGetLastError() after the launch.
#define EVDR_MIN_CTAS 3
#include "maxsim_tile.cuh"

extern "C" int evdr_maxsim_int8full_defer(const void* q, const void* qw,
                                          const void* p, const void* scales,
                                          const void* pmask, void* out, int nq,
                                          int lq, int nd, int lp, int d,
                                          void* stream) {
  return evdr::launch<evdr::kInt8Int8, false, true>(
      q, qw, p, scales, pmask, out, nullptr, nq, lq, nd, lp, d, stream);
}

extern "C" int evdr_maxsim_int8_defer(const void* q, const void* qw,
                                      const void* p, const void* scales,
                                      const void* pmask, void* out, int nq,
                                      int lq, int nd, int lp, int d,
                                      void* stream) {
  return evdr::launch<evdr::kInt8Bf16, false, true>(
      q, qw, p, scales, pmask, out, nullptr, nq, lq, nd, lp, d, stream);
}
