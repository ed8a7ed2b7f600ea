// K1: fused masked MaxSim over a bf16 page index, for Hopper (sm_90a).
//
// Replaces: evdr_tpu/ops/pallas_maxsim.py:_kernel (driver
// _maxsim_pallas_fwd, public entry maxsim_pallas).
//
// What bounds it on the H100: operations. At the serving shape (256
// queries x 32 tokens against pages of 768 tokens, D = 128) every page
// element meets all 8192 query-token rows: 8192 operations per byte, far
// above the ~295 per byte where bf16 tensor cores stop waiting on memory.
// The design keeps the similarity tensor out of device memory entirely (the
// masked running max stays in the accumulator registers, see
// maxsim_tile.cuh) and feeds the tensor cores with mma.sync m16n8k16 bf16
// instructions (f32 accumulation) from ldmatrix, while cp.async brings the
// next page tile. It does not yet use wgmma or TMA, the only way to the
// card's full bf16 rate.
//
// C interface (loaded with ctypes; every pointer and the stream is a
// void*): q (nq, lq, d) bf16, qw (nq, lq) f32 query-token weights (the
// mask as 0/1), p (nd, lp, d) bf16, pmask (nd, lp) bool as bytes,
// out (nq, nd) f32. Returns cudaGetLastError() after the launch.
#include "maxsim_tile.cuh"

extern "C" int evdr_maxsim_bf16(const void* q, const void* qw, const void* p,
                                const void* pmask, void* out, int nq, int lq,
                                int nd, int lp, int d, void* stream) {
  return evdr::launch<evdr::kBf16>(q, qw, p, nullptr, pmask, out, nullptr,
                                   nq, lq, nd, lp, d, stream);
}
